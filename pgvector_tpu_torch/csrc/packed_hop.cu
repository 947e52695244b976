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
//
// The int8 slab (packed_hop_int8_kernel) is the scorer of the reference's
// int8 tier, pgvector_tpu/index/hnsw_kernels.py:202-231
// (_int8_point_scores), in front of the same tail: a per-dim scaled slab
// scored against the scale-folded query re-quantized to int8 (qc, with its
// step sq, and q2 = |q|^2, made once a search by the caller).  A lane group
// reads 16-byte chunks of a candidate's int8 row (D = 960 is 60 chunks) and
// accumulates __dp4a(qc, x) in int32; the shuffle tree sums the group's
// partial sums, so the cross term is exact in any order.  The f32 close
// follows the reference's order with explicitly rounded operations (nvcc
// contracts nothing): L2 t = float(cross) * sq, d = (q2 - 2t) + pnorm2[id];
// inner product and cosine d = -(float(cross) * sq); so distances equal the
// plain version's bit for bit.  L1 dequantizes: sum |q - float(x) * scale|
// with the query and scale in shared memory, summed in another order than
// the plain version's.  Bound: the slab bytes, Q x E x 2m x D x 1 B (1.97 GB
// at Q = 8,000, E = 8, m = 16, D = 960: 0.587 ms at 3.35 TB/s).  Simple
// first: one warp a candidate row at D = 960, no cp.async.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hop_score.cuh"

namespace {

using pgvt::IP;
using pgvt::L1;
using pgvt::L2;
using pgvt::lane_group;
using pgvt::UNROLL;
using pgvt::with_lanes;

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
    }
    pgvt::score_rows<T, N>(slab, live, s_q, d, group, gl, metric, acc);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * groups + grp;
      if (gl == 0 && live[u]) s_d[ef + c] = acc[u];
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
  return with_lanes(width, [&](auto r) {
    return launch<T, N, decltype(r)::value>(
        pool_d, pool_p, sel, nbr0, vals, qs, q, ef, e_sel, m2, d, width,
        group, metric, out_d, out_p, st);
  });
}

// the value of byte b (0-3) of w as a signed int8
__device__ __forceinline__ int sbyte(int w, int b) {
  return (w << (24 - 8 * b)) >> 24;
}

// N: slab bytes per load (16, or 1 where rows are not 16-byte aligned);
// R: tail lanes per thread
template <int N, int R>
__global__ void packed_hop_int8_kernel(
    const float* __restrict__ pool_d, const int* __restrict__ pool_p,
    const int* __restrict__ sel, const int* __restrict__ nbr0,
    const int8_t* __restrict__ nbr_vals, const int8_t* __restrict__ qc,
    const float* __restrict__ sq, const float* __restrict__ q2,
    const float* __restrict__ pnorm2, const float* __restrict__ scale,
    const float* __restrict__ qs, int ef, int e_sel, int m2, int d,
    int width, int group, int metric, float* __restrict__ out_d,
    int* __restrict__ out_p) {
  extern __shared__ int sm[];
  float* s_d = reinterpret_cast<float*>(sm);  // [width]
  int* s_pk = sm + width;                     // [width]
  int* xbuf = sm + 2 * width;                 // merge_xbuf_bytes(width)
  const int dpad = (d + 15) / 16 * 16;
  int8_t* s_qc = reinterpret_cast<int8_t*>(xbuf + 4 * width);  // [dpad]
  float* s_q = reinterpret_cast<float*>(s_qc + dpad);  // L1: [d] query
  float* s_s = s_q + d;                                // L1: [d] scale
  const size_t row = blockIdx.x;
  const int w = e_sel * m2;
  const int* row_sel = sel + row * e_sel;

  for (int e = threadIdx.x; e < dpad; e += blockDim.x)
    s_qc[e] = e < d ? qc[row * d + e] : 0;
  if (metric == L1)
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      s_q[e] = qs[row * d + e];
      s_s[e] = scale[e];
    }
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

  const int groups = blockDim.x / group;
  const int grp = threadIdx.x / group, gl = threadIdx.x % group;
  const float row_sq = sq[row], row_q2 = q2[row];
  for (int c0 = 0; c0 < w; c0 += groups * UNROLL) {
    int acc[UNROLL];
    float l1[UNROLL];
    const int8_t* slab[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * groups + grp;
      live[u] = c < w && s_pk[ef + (c < w ? c : 0)] >= 0;
      const int s = live[u] ? row_sel[c / m2] : 0;
      slab[u] = nbr_vals + ((size_t)s * m2 + (live[u] ? c % m2 : 0)) * d;
      acc[u] = 0;
      l1[u] = 0.f;
    }
    for (int e0 = gl * N; e0 < d; e0 += group * N) {
      int x[UNROLL][N / 4 > 0 ? N / 4 : 1];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if constexpr (N == 16) {
          const int4 v = live[u] ? __ldg(reinterpret_cast<const int4*>(
                                       slab[u] + e0))
                                 : make_int4(0, 0, 0, 0);
          x[u][0] = v.x; x[u][1] = v.y; x[u][2] = v.z; x[u][3] = v.w;
        } else {
          x[u][0] = live[u] ? (int)slab[u][e0] : 0;
        }
      }
      if (metric != L1) {
        if constexpr (N == 16) {
          const int4 qv = *reinterpret_cast<const int4*>(s_qc + e0);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            acc[u] = __dp4a(x[u][0], qv.x, acc[u]);
            acc[u] = __dp4a(x[u][1], qv.y, acc[u]);
            acc[u] = __dp4a(x[u][2], qv.z, acc[u]);
            acc[u] = __dp4a(x[u][3], qv.w, acc[u]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) acc[u] += x[u][0] * (int)s_qc[e0];
        }
      } else {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const int xi = N == 16 ? sbyte(x[u][i / 4], i % 4) : x[u][0];
            const float dq = __fmul_rn((float)xi, s_s[e0 + i]);
            l1[u] = __fadd_rn(l1[u], fabsf(__fsub_rn(s_q[e0 + i], dq)));
          }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int off = group / 2; off > 0; off >>= 1) {
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
        l1[u] = __fadd_rn(l1[u], __shfl_xor_sync(0xffffffffu, l1[u], off));
      }
      const int c = c0 + u * groups + grp;
      if (gl == 0 && live[u]) {
        const float t = __fmul_rn(__int2float_rn(acc[u]), row_sq);
        float dv;
        if (metric == L2)
          dv = __fadd_rn(__fsub_rn(row_q2, __fmul_rn(2.f, t)),
                         pnorm2[s_pk[ef + c] >> 1]);
        else if (metric == IP)
          dv = -t;
        else
          dv = l1[u];
        s_d[ef + c] = dv;
      }
    }
  }
  __syncthreads();
  pgvt::hop_merge<R>(s_d, s_pk, xbuf, width, ef, out_d + row * ef,
                     out_p + row * ef);
}

template <int N>
cudaError_t launch_int8(const float* pool_d, const int* pool_p,
                        const int* sel, const int* nbr0, const void* vals,
                        const void* qc, const float* sq, const float* q2,
                        const float* pnorm2, const float* scale,
                        const float* qs, int q, int ef, int e_sel, int m2,
                        int d, int width, int group, int metric,
                        float* out_d, int* out_p, cudaStream_t st) {
  const size_t smem = sizeof(int) * 2 * (size_t)width +
                      pgvt::merge_xbuf_bytes(width) + (d + 15) / 16 * 16 +
                      (metric == L1 ? 2 * sizeof(float) * (size_t)d : 0);
  return with_lanes(width, [&](auto r) {
    constexpr int R = decltype(r)::value;
    cudaError_t err = cudaFuncSetAttribute(
        packed_hop_int8_kernel<N, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    packed_hop_int8_kernel<N, R><<<q, width / R, smem, st>>>(
        pool_d, pool_p, sel, nbr0, static_cast<const int8_t*>(vals),
        static_cast<const int8_t*>(qc), sq, q2, pnorm2, scale, qs, ef, e_sel,
        m2, d, width, group, metric, out_d, out_p);
    return cudaGetLastError();
  });
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
  const int group = lane_group(vec, n, d);
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

// The int8 slab: nbr_vals (cap, m2, d) int8, qc (q, d) int8, sq / q2 (q,)
// f32, pnorm2 (rows,) f32 by element id, scale (d,) f32 and qs (q, d) f32
// (both read for L1 only).  metric: 0 L2, 1 inner product (and cosine),
// 2 L1.
extern "C" int pgvt_packed_hop_int8(const float* pool_d, const int* pool_p,
                                    const int* sel, const int* nbr0,
                                    const void* nbr_vals, const void* qc,
                                    const float* sq, const float* q2,
                                    const float* pnorm2, const float* scale,
                                    const float* qs, int q, int ef,
                                    int e_sel, int m2, int d, int metric,
                                    float* out_d, int* out_p, void* stream) {
  const int width = pgvt::merge_width(ef, e_sel * m2);
  if (ef < 1 || e_sel < 1 || m2 < 1 || d < 1 || width == 0 || metric < 0 ||
      metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(nbr_vals) % 16 == 0;
  const int group = lane_group(vec, 16, d);
  return vec ? (int)launch_int8<16>(pool_d, pool_p, sel, nbr0, nbr_vals, qc,
                                    sq, q2, pnorm2, scale, qs, q, ef, e_sel,
                                    m2, d, width, group, metric, out_d,
                                    out_p, st)
             : (int)launch_int8<1>(pool_d, pool_p, sel, nbr0, nbr_vals, qc,
                                   sq, q2, pnorm2, scale, qs, q, ef, e_sel,
                                   m2, d, width, group, metric, out_d, out_p,
                                   st);
}
