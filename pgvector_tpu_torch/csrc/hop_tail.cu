// K2 — fused hop tail of the packed HNSW beam search.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_hop.py:_tail_kernel
// (driven by hop_tail, sorting with _bitonic_sort).  Per query row:
//   1. lay out [pool (id*2 | expanded) | W scored candidates | padding] to
//      width = the next power of two >= ef + W;
//   2. sort by (id, position) and mask every later copy of an id, so the
//      pool's copy and its expanded flag survive;
//   3. sort by (distance, position);
//   4. emit the first ef lanes, with +inf / -2 in empty lanes.
// The kernel only moves values, so its output is bit-identical to the plain
// version (hop_tail_plain, two stable sorts).
//
// What bounds it on an H100: latency, not bytes or flops — width*log^2
// (width) compare-exchanges per row with no arithmetic, and a few KB of
// input per row.  Design: one block per query row; the four lanes (key,
// position, distance, packed id) live in shared memory; each bitonic stage
// is one pass of compare-exchanges by up to 512 threads followed by one
// barrier.  Keys are made distinct by the position, so any correct sorting
// network gives the stable order.  Widths up to 4096 are taken (64 KB of
// shared memory).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;               // masked lanes sort last
constexpr int ID_INF = 2147483647 - 1048575;  // 2^31 - 2^20, after every id
constexpr int MAX_WIDTH = 4096;
constexpr int MAX_THREADS = 512;

template <typename Key>
__device__ __forceinline__ bool before(Key a, int pa, Key b, int pb) {
  return a < b || (a == b && pa < pb);
}

// Ascending bitonic sort of (key, pos) pairs with one payload lane.
template <typename Key, typename Payload>
__device__ void bitonic(Key* key, int* pos, Payload* pay, int width) {
  for (int size = 2; size <= width; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (width >> 1); p += blockDim.x) {
        const int lo = 2 * j * (p / j) + (p % j);
        const int hi = lo + j;
        const bool ascending = (lo & size) == 0;
        const bool hi_first = before(key[hi], pos[hi], key[lo], pos[lo]);
        if (ascending == hi_first) {
          const Key k = key[lo]; key[lo] = key[hi]; key[hi] = k;
          const int q = pos[lo]; pos[lo] = pos[hi]; pos[hi] = q;
          const Payload v = pay[lo]; pay[lo] = pay[hi]; pay[hi] = v;
        }
      }
      __syncthreads();
    }
  }
}

struct DistPacked {
  float d;
  int packed;
};

__global__ void hop_tail_kernel(const float* __restrict__ pool_d,
                                const int* __restrict__ pool_p,
                                const float* __restrict__ cand_d,
                                const int* __restrict__ cand_i, int ef, int w,
                                int width, float* __restrict__ out_d,
                                int* __restrict__ out_p) {
  extern __shared__ int sm[];
  int* s_id = sm;                                               // [width]
  int* s_pos = sm + width;                                      // [width]
  DistPacked* s_val = reinterpret_cast<DistPacked*>(sm + 2 * width);
  float* s_d = reinterpret_cast<float*>(sm + 2 * width);        // pass 2 key
  int* s_pk = sm + 4 * width;                                   // pass 2 pay
  const size_t row = blockIdx.x;

  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    int id, pk;
    float dv;
    if (e < ef) {
      pk = pool_p[row * ef + e];
      id = pk >> 1;  // arithmetic: -2 unpacks to -1
      dv = pool_d[row * ef + e];
    } else if (e < ef + w) {
      id = cand_i[row * w + (e - ef)];
      pk = id * 2;
      dv = cand_d[row * w + (e - ef)];
    } else {
      id = ID_INF;
      pk = -2;
      dv = BIG;
    }
    if (id < 0) id = ID_INF;
    if (isinf(dv) || id == ID_INF) dv = BIG;
    s_id[e] = id;
    s_pos[e] = e;
    s_val[e] = DistPacked{dv, pk};
  }
  __syncthreads();

  // pass 1: (id, position) order; later copies of an id are masked
  bitonic(s_id, s_pos, s_val, width);
  // unpack to planar lanes for pass 2 (s_d / s_pk overlay s_val: read all
  // first, then write)
  float dv[MAX_WIDTH / MAX_THREADS];
  int pk[MAX_WIDTH / MAX_THREADS];
  int pos[MAX_WIDTH / MAX_THREADS];
  int t = 0;
  for (int e = threadIdx.x; e < width; e += blockDim.x, ++t) {
    const bool dup = e > 0 && s_id[e] == s_id[e - 1] && s_id[e] != ID_INF;
    dv[t] = dup ? BIG : s_val[e].d;
    pk[t] = s_val[e].packed;
    pos[t] = dup ? s_pos[e] + width : s_pos[e];
  }
  __syncthreads();
  t = 0;
  for (int e = threadIdx.x; e < width; e += blockDim.x, ++t) {
    s_d[e] = dv[t];
    s_pk[e] = pk[t];
    s_pos[e] = pos[t];
  }
  __syncthreads();

  // pass 2: (distance, position) order — the stable distance order
  bitonic(s_d, s_pos, s_pk, width);

  for (int e = threadIdx.x; e < ef; e += blockDim.x) {
    const float v = s_d[e];
    out_d[row * ef + e] = v >= BIG ? CUDART_INF_F : v;
    out_p[row * ef + e] = v >= BIG ? -2 : s_pk[e];
  }
}

}  // namespace

extern "C" int pgvt_hop_tail(const float* pool_d, const int* pool_p,
                             const float* cand_d, const int* cand_i, int q,
                             int ef, int w, float* out_d, int* out_p,
                             void* stream) {
  int width = 1;
  while (width < ef + w) width <<= 1;
  if (ef < 1 || w < 0 || width > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (width < 2) width = 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // s_id, s_pos, then s_val (d, packed) pairs; s_pk sits after s_val's
  // first half so the planar pass-2 lanes fit in the same allocation
  const size_t smem = sizeof(int) * 5 * (size_t)width;
  cudaError_t err = cudaFuncSetAttribute(
      hop_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = width / 2 < MAX_THREADS ? (width / 2 < 32 ? 32 : width / 2)
                                              : MAX_THREADS;
  hop_tail_kernel<<<q, threads, smem, st>>>(pool_d, pool_p, cand_d, cand_i,
                                            ef, w, width, out_d, out_p);
  return (int)cudaGetLastError();
}
