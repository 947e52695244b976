// K3 — SelectNeighbors (Algorithm 4, hnswutils.c:1062-1163) over a batch of
// candidate pools, one warp a pool.
//
// Replaces the XLA program of pgvector_tpu/index/hnsw_kernels.py:804
// (select_neighbors, its keep/prune fori_loop at :844) under
// select_neighbors_batch (:855), which the JAX package runs inside one
// jitted connect.  The port's plain version (ops/select_neighbors.py) is a
// Python loop over the C columns, about nine launches a column over a
// gathered (T, C, C) block.  Per row, given base distances base_d (C,), the
// pairwise block pair_d (C, C), valid and forced flags and the cap lm:
//   1. big_d = valid ? base_d : +inf; a forced candidate must be valid and
//      finite;
//   2. the candidates in the stable order of big_d (a rank count: the
//      position of i is the number of (key, index) pairs before its own);
//   3. the keep loop, closest first: candidate t is kept when it is forced
//      or closer to the base than to every kept candidate, while fewer
//      than lm are kept.  The minimum over the kept ones is pulled from
//      row order[t] of the pair block at the kept columns: the same set of
//      values the plain version's running column minimum folds, and a
//      minimum is exact in any order (a NaN anywhere in it makes the
//      minimum NaN there too), so the decisions are the plain version's
//      bit for bit;
//   4. rank = kept ? big_d : (finite ? big_d + BIG : +inf), one rounded
//      f32 add as in the plain version, and the first lm positions by
//      (rank, index), -1 / false where the rank is +inf or past C.
//
// What bounds it on an H100: the pair block, T x C x C x 4 bytes, read
// once (16,384 x 64 x 64 x 4 = 268 MB for a backlink chunk of the 1M
// build: 0.080 ms at 3.35 TB/s).  Design: one warp a row, so the keep
// loop's decision is one warp-wide minimum and needs no barrier; where the
// row's block fits (C x C x 4 <= STAGE_MAX bytes, C <= 110) it is copied
// to shared memory with coalesced loads first, otherwise each step reads
// the kept columns of one row of the block from global memory (one
// contiguous row, so any C works).  The sorts are rank counts over keys in
// shared memory: O(C^2 / 32) compares a lane, nothing beside the keep loop
// at the build's C.  A row's result depends on its own inputs alone, so
// any split of the rows over launches or devices gives the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;  // pruned candidates rank after kept ones
constexpr int WARPS = 4;        // rows (warps) a block, at most
constexpr int STAGE_MAX = 48 * 1024;  // bytes of a row's staged pair block
constexpr int COPY = 8;               // loads a lane has in flight staging it
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// shared-memory bytes of one row: [pair block | keys | order | kept ids |
// flags], each 16-byte aligned
__host__ __device__ inline size_t row_bytes(int c, int lm, bool stage) {
  return (stage ? align16(sizeof(float) * (size_t)c * c) : 0) +
         2 * align16(sizeof(int) * (size_t)c) +
         align16(sizeof(int) * (size_t)lm) + align16((size_t)c);
}

template <bool STAGE>
__global__ void select_neighbors_kernel(
    const float* __restrict__ base_d, const float* __restrict__ pair_d,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ forced,
    int t_rows, int c, int lm, int* __restrict__ out_pos,
    uint8_t* __restrict__ out_kept) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= (size_t)t_rows) return;  // whole warps only: no block barrier
  unsigned char* p = smem + warp * row_bytes(c, lm, STAGE);
  float* s_pair = reinterpret_cast<float*>(p);
  if (STAGE) p += align16(sizeof(float) * (size_t)c * c);
  float* s_key = reinterpret_cast<float*>(p);  // sort key, then rank
  p += align16(sizeof(int) * (size_t)c);
  int* s_ord = reinterpret_cast<int*>(p);  // sorted position -> index
  p += align16(sizeof(int) * (size_t)c);
  int* s_kid = reinterpret_cast<int*>(p);  // kept indices, in keep order
  p += align16(sizeof(int) * (size_t)lm);
  uint8_t* s_flag = p;  // bit 0: forced (sanitized); bit 1: kept

  const float* brow = base_d + row * c;
  const uint8_t* vrow = valid + row * c;
  const float* prow = pair_d + row * (size_t)c * c;

  // 1. keys and forced flags; the non-finite keys all sort last as +inf
  // (they are never kept, so their order among themselves changes nothing)
  for (int i = lane; i < c; i += 32) {
    const float bd = vrow[i] ? brow[i] : CUDART_INF_F;
    const bool fin = isfinite(bd);
    s_key[i] = fin ? bd : CUDART_INF_F;
    s_flag[i] = (forced != nullptr && forced[row * c + i] && fin) ? 1 : 0;
  }
  if (STAGE) {  // COPY loads a lane in flight: the copy is latency-bound
    const int cc = c * c;
    if (cc % 4 == 0 && reinterpret_cast<uintptr_t>(prow) % 16 == 0) {
      const float4* src = reinterpret_cast<const float4*>(prow);
      float4* dst = reinterpret_cast<float4*>(s_pair);
      for (int e = lane; e < cc / 4; e += 32 * COPY) {
        float4 v[COPY];
#pragma unroll
        for (int u = 0; u < COPY; ++u)
          if (e + 32 * u < cc / 4) v[u] = __ldg(src + e + 32 * u);
#pragma unroll
        for (int u = 0; u < COPY; ++u)
          if (e + 32 * u < cc / 4) dst[e + 32 * u] = v[u];
      }
    } else {
      for (int e = lane; e < cc; e += 32 * COPY) {
        float v[COPY];
#pragma unroll
        for (int u = 0; u < COPY; ++u)
          if (e + 32 * u < cc) v[u] = __ldg(prow + e + 32 * u);
#pragma unroll
        for (int u = 0; u < COPY; ++u)
          if (e + 32 * u < cc) s_pair[e + 32 * u] = v[u];
      }
    }
  }
  __syncwarp();

  // 2. the stable order of the keys
  for (int i = lane; i < c; i += 32) {
    const float k = s_key[i];
    int r = 0;
    for (int j = 0; j < c; ++j) {
      const float kj = s_key[j];
      r += (kj < k) || (kj == k && j < i);
    }
    s_ord[r] = i;
  }
  __syncwarp();

  // 3. the keep loop
  const float* pb = STAGE ? s_pair : prow;
  int count = 0;
  for (int t = 0; t < c && count < lm; ++t) {
    const int i = s_ord[t];
    const float d = s_key[i];
    if (!(d < CUDART_INF_F)) break;  // the rest are not finite
    bool ok = s_flag[i] & 1;
    if (!ok) {
      const float* pr = pb + (size_t)i * c;
      float mn = CUDART_INF_F;
      bool nan = false;
      for (int j = lane; j < count; j += 32) {
        const float v = pr[s_kid[j]];
        nan |= isnan(v);
        mn = fminf(mn, v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
      nan = __any_sync(FULL, nan);
      ok = !nan && d < mn;
    }
    if (ok) {
      if (lane == 0) {
        s_kid[count] = i;
        s_flag[i] |= 2;
      }
      ++count;
      __syncwarp();
    }
  }
  __syncwarp();

  // 4. ranks (over the keys, now free), then the first lm by (rank, index)
  for (int i = lane; i < c; i += 32) {
    const float bd = vrow[i] ? brow[i] : CUDART_INF_F;
    s_key[i] = (s_flag[i] & 2) ? bd
               : isfinite(bd)  ? __fadd_rn(bd, BIG)
                               : CUDART_INF_F;
  }
  __syncwarp();
  int* pos = out_pos + row * lm;
  uint8_t* kept = out_kept + row * lm;
  for (int i = lane; i < c; i += 32) {
    const float k = s_key[i];
    int r = 0;
    for (int j = 0; j < c; ++j) {
      const float kj = s_key[j];
      r += (kj < k) || (kj == k && j < i);
    }
    if (r < lm) {
      const bool inf = isinf(k);
      pos[r] = inf ? -1 : i;
      kept[r] = !inf && (s_flag[i] & 2);
    }
  }
  for (int r = c + lane; r < lm; r += 32) {
    pos[r] = -1;
    kept[r] = 0;
  }
}

template <bool STAGE>
cudaError_t launch(const float* base_d, const float* pair_d,
                   const uint8_t* valid, const uint8_t* forced, int t_rows,
                   int c, int lm, int* out_pos, uint8_t* out_kept,
                   cudaStream_t st) {
  const size_t per_row = row_bytes(c, lm, STAGE);
  int warps = WARPS;
  while (warps > 1 && per_row * warps > (size_t)SMEM_MAX) --warps;
  if (per_row * warps > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  const size_t smem = per_row * warps;
  cudaError_t err = cudaFuncSetAttribute(
      select_neighbors_kernel<STAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (t_rows + warps - 1) / warps;
  select_neighbors_kernel<STAGE><<<blocks, 32 * warps, smem, st>>>(
      base_d, pair_d, valid, forced, t_rows, c, lm, out_pos, out_kept);
  return cudaGetLastError();
}

}  // namespace

// base_d (t_rows, c) f32, pair_d (t_rows, c, c) f32, valid (t_rows, c)
// bool, forced (t_rows, c) bool or null; out_pos (t_rows, lm) int32,
// out_kept (t_rows, lm) bool.  Returns the launch's cudaError_t.
extern "C" int pgvt_select_neighbors(const float* base_d, const float* pair_d,
                                     const void* valid, const void* forced,
                                     int t_rows, int c, int lm, int* out_pos,
                                     void* out_kept, void* stream) {
  if (t_rows < 1 || c < 0 || lm < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool stage = sizeof(float) * (size_t)c * c <= (size_t)STAGE_MAX;
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* f = static_cast<const uint8_t*>(forced);
  auto* k = static_cast<uint8_t*>(out_kept);
  return stage ? (int)launch<true>(base_d, pair_d, v, f, t_rows, c, lm,
                                   out_pos, k, st)
               : (int)launch<false>(base_d, pair_d, v, f, t_rows, c, lm,
                                    out_pos, k, st);
}

// 1 where a row of c candidates stages its pair block in shared memory
extern "C" int pgvt_select_neighbors_staged(int c) {
  return sizeof(float) * (size_t)c * c <= (size_t)STAGE_MAX;
}
