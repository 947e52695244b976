// K2 — one hop of the packed HNSW layer-0 beam search, fused.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_hop.py:_tail_kernel
// together with the XLA program that fed it on the packed path
// (pgvector_tpu/index/hnsw_kernels.py:464-485: the slab gather and
// dense_point_scores, which XLA fused on the TPU).  Per query row, given the
// E expanded element ids `sel` (-1 for none):
//   1. the candidates are nbr0[s] for each selected s, selection-major then
//      adjacency order (-1 where s is -1 or the list slot is empty);
//   2. each candidate is scored against the query from nbr_vals[s], a
//      contiguous (2m, D) slab of f32 or bf16 neighbor values, in f32: L2,
//      inner product (cosine stores normalized values and orders by -ip
//      too) or L1; a -1 candidate scores +inf;
//   3. the hop tail (hop_merge.cuh) merges them into the ef pool.
//
// What bounds it on an H100: the slab bytes, Q x E x 2m x D x 2 B in bf16
// (524 MB at Q = 8,000, E = 8, m = 16, D = 128: 0.16 ms at 3.35 TB/s).  The
// unfused path gathered the slabs into a (Q, W, D) tensor, converted and
// subtracted it in f32 passes and wrote the (Q, W) scores back for the tail
// to read: several times those bytes, in a dozen launches.  Design: one
// block per query row; the query sits in shared memory in f32; a group of L
// adjacent lanes reads one candidate's row with 16-byte loads (L = 16 at
// D = 128 in bf16, so a warp reads two 256-byte rows per load), four
// candidates per group in flight, and a shuffle tree sums the group's
// partial sums.  Only the row's ids and distances reach shared memory, so
// any D works.  The tail then runs on the same block.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hop_merge.cuh"

namespace {

enum { L2 = 0, IP = 1, L1 = 2 };
constexpr int UNROLL = 4;  // candidates a lane group has in flight

// N consecutive slab values from p, as f32
template <typename T, int N>
struct Load;

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void get(const float* p, float* v) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void get(const __nv_bfloat16* p,
                                             float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
struct Load<T, 1> {
  static __device__ __forceinline__ void get(const T* p, float* v) {
    if constexpr (sizeof(T) == 4) {
      v[0] = __ldg(p);
    } else {
      v[0] = __bfloat162float(*p);
    }
  }
};

// T: slab type; N: values per load (16 bytes, or 1 where rows are not
// 16-byte aligned); R: tail lanes per thread
template <typename T, int N, int R>
__global__ void packed_hop_kernel(
    const float* __restrict__ pool_d, const int* __restrict__ pool_p,
    const int* __restrict__ sel, const int* __restrict__ nbr0,
    const T* __restrict__ nbr_vals, const float* __restrict__ qs, int ef,
    int e_sel, int m2, int d, int width, int group, int metric,
    float* __restrict__ out_d, int* __restrict__ out_p) {
  extern __shared__ int sm[];
  float* s_d = reinterpret_cast<float*>(sm);  // [width]
  int* s_pk = sm + width;                     // [width]
  int* xbuf = sm + 2 * width;                 // merge_xbuf_bytes(width)
  float* s_q = reinterpret_cast<float*>(xbuf + 4 * width);  // [d]
  const size_t row = blockIdx.x;
  const int w = e_sel * m2;
  const int* row_sel = sel + row * e_sel;

  for (int e = threadIdx.x; e < d; e += blockDim.x) s_q[e] = qs[row * d + e];
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float dv = pgvt::BIG;
    int pk = -2;
    if (e < ef) {
      pk = pool_p[row * ef + e];
      dv = pool_d[row * ef + e];
    } else if (e < ef + w) {
      const int c = e - ef, s = row_sel[c / m2];
      pk = (s >= 0 ? nbr0[(size_t)s * m2 + c % m2] : -1) * 2;
      dv = CUDART_INF_F;  // scored below
    }
    s_d[e] = dv;
    s_pk[e] = pk;
  }
  __syncthreads();

  // score: lane group `grp` of `group` lanes takes candidates grp,
  // grp + groups, ...; every lane runs the same trip counts (shuffles)
  const int groups = blockDim.x / group;
  const int grp = threadIdx.x / group, gl = threadIdx.x % group;
  for (int c0 = 0; c0 < w; c0 += groups * UNROLL) {
    float acc[UNROLL];
    const T* slab[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * groups + grp;
      live[u] = c < w && s_pk[ef + (c < w ? c : 0)] >= 0;
      const int s = live[u] ? row_sel[c / m2] : 0;
      slab[u] = nbr_vals + ((size_t)s * m2 + (live[u] ? c % m2 : 0)) * d;
      acc[u] = 0.f;
    }
    for (int e0 = gl * N; e0 < d; e0 += group * N) {
      float v[UNROLL][N];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (live[u]) {
          Load<T, N>::get(slab[u] + e0, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float q = s_q[e0 + i];
          if (metric == L2) {
            const float t = q - v[u][i];
            acc[u] = fmaf(t, t, acc[u]);
          } else if (metric == IP) {
            acc[u] = fmaf(q, v[u][i], acc[u]);
          } else {
            acc[u] += fabsf(q - v[u][i]);
          }
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int off = group / 2; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      const int c = c0 + u * groups + grp;
      if (gl == 0 && live[u]) s_d[ef + c] = metric == IP ? -acc[u] : acc[u];
    }
  }
  __syncthreads();
  pgvt::hop_merge<R>(s_d, s_pk, xbuf, width, ef, out_d + row * ef,
                     out_p + row * ef);
}

template <typename T, int N, int R>
cudaError_t launch(const float* pool_d, const int* pool_p, const int* sel,
                   const int* nbr0, const void* nbr_vals, const float* qs,
                   int q, int ef, int e_sel, int m2, int d, int width,
                   int group, int metric, float* out_d, int* out_p,
                   cudaStream_t st) {
  const size_t smem = sizeof(int) * 2 * (size_t)width +
                      pgvt::merge_xbuf_bytes(width) + sizeof(float) * d;
  cudaError_t err = cudaFuncSetAttribute(
      packed_hop_kernel<T, N, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  packed_hop_kernel<T, N, R><<<q, width / R, smem, st>>>(
      pool_d, pool_p, sel, nbr0, static_cast<const T*>(nbr_vals), qs, ef,
      e_sel, m2, d, width, group, metric, out_d, out_p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_lanes(const float* pool_d, const int* pool_p,
                         const int* sel, const int* nbr0, const void* vals,
                         const float* qs, int q, int ef, int e_sel, int m2,
                         int d, int width, int group, int metric,
                         float* out_d, int* out_p, cudaStream_t st) {
#define PGVT_LAUNCH(R)                                                      \
  return launch<T, N, R>(pool_d, pool_p, sel, nbr0, vals, qs, q, ef, e_sel, \
                         m2, d, width, group, metric, out_d, out_p, st)
  switch (pgvt::merge_lanes(width)) {
    case 2: PGVT_LAUNCH(2);
    case 4: PGVT_LAUNCH(4);
    case 8: PGVT_LAUNCH(8);
    case 16: PGVT_LAUNCH(16);
    case 32: PGVT_LAUNCH(32);
  }
#undef PGVT_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16: nonzero for bf16 slabs, zero for f32.  metric: 0 L2, 1 inner
// product (and cosine), 2 L1.
extern "C" int pgvt_packed_hop(const float* pool_d, const int* pool_p,
                               const int* sel, const int* nbr0,
                               const void* nbr_vals, const float* qs, int q,
                               int ef, int e_sel, int m2, int d, int bf16,
                               int metric, float* out_d, int* out_p,
                               void* stream) {
  const int width = pgvt::merge_width(ef, e_sel * m2);
  if (ef < 1 || e_sel < 1 || m2 < 1 || d < 1 || width == 0 || metric < 0 ||
      metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = bf16 ? 2 : 4, n = 16 / esize;
  // 16-byte loads need 16-byte aligned slab rows
  const bool vec = (d * esize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(nbr_vals) % 16 == 0;
  // lanes per candidate: enough 16-byte loads to cover a row, up to a warp
  int group = 32;
  if (vec)
    while (group > 2 && (group / 2) * n >= d) group /= 2;
  if (bf16)
    return vec ? (int)launch_lanes<__nv_bfloat16, 8>(
                     pool_d, pool_p, sel, nbr0, nbr_vals, qs, q, ef, e_sel,
                     m2, d, width, group, metric, out_d, out_p, st)
               : (int)launch_lanes<__nv_bfloat16, 1>(
                     pool_d, pool_p, sel, nbr0, nbr_vals, qs, q, ef, e_sel,
                     m2, d, width, group, metric, out_d, out_p, st);
  return vec ? (int)launch_lanes<float, 4>(pool_d, pool_p, sel, nbr0,
                                           nbr_vals, qs, q, ef, e_sel, m2, d,
                                           width, group, metric, out_d, out_p,
                                           st)
             : (int)launch_lanes<float, 1>(pool_d, pool_p, sel, nbr0,
                                           nbr_vals, qs, q, ef, e_sel, m2, d,
                                           width, group, metric, out_d, out_p,
                                           st);
}
