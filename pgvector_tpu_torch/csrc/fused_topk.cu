// K1 — fused exact top-k scan (L2 / inner product), f32.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_topk.py:_kernel
// (driven by _pallas_scan / exact_topk).  For every query q and live row x
// it forms the ordering score  dbsq[x] - 2 q.x  (dbsq = |x|^2 for L2, 0 for
// inner product, +inf for dead rows) and keeps the k smallest per query,
// ties to the lower row id.  The caller adds |q|^2 (L2) or halves the score
// (IP), as pallas_topk.exact_topk does.
//
// What bounds it on an H100: f32 FMA on the CUDA cores.  The result must be
// f32-exact, so neither TF32 nor bf16 tensor cores are used; the product is
// Q*N*D*2 flops (about 2 TFLOP at 8,000 queries x 1M x 128).  Device memory
// is read once per 64-query tile.
//
// Design:
//   pass 1 (topk_pass1): grid = (query tiles of 64) x (DB splits).  A block
//     of 256 threads walks its split in 64-row tiles.  Query and row chunks
//     of 32 dims sit transposed in shared memory (padded against bank
//     conflicts); each thread accumulates a 4x4 block of dot products in
//     registers.  The 64x64 score tile goes to shared memory, and each warp
//     folds 8 queries' scores into their sorted k-lists (shared memory): a
//     ballot against the list's k-th value rejects most rows at once, and
//     each survivor is inserted by one warp-wide rank + shift.  Rows arrive
//     in ascending id order, so an insert goes after every equal distance:
//     (distance, id) order without comparing ids.
//   pass 2 (topk_merge): one thread per query merges the splits' sorted
//     lists by (distance, id) into the final k; ids are -1 where the
//     distance is +inf.
// The split count is chosen by the caller so that pass 1 fills the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // queries per block
constexpr int RT = 64;        // DB rows per tile
constexpr int DC = 32;        // dims per shared-memory chunk
constexpr int PAD = 65;       // padded row of a transposed chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_K = 64;
constexpr int MAX_SPLITS = 64;

__global__ void __launch_bounds__(THREADS)
topk_pass1(const float* __restrict__ qs, const float* __restrict__ db,
           const float* __restrict__ dbsq, int nq, int n, int d, int k,
           int tiles_per_split, float* __restrict__ part_d,
           int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* s_q = smem;                    // [DC][PAD] transposed query chunk
  float* s_x = s_q + DC * PAD;          // [DC][PAD] transposed row chunk
  float* s_sc = s_x + DC * PAD;         // [QT][RT + 1] scores
  float* s_bd = s_sc + QT * (RT + 1);   // [QT][k] sorted best distances
  int* s_bi = reinterpret_cast<int*>(s_bd + QT * k);  // [QT][k] their ids

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int row_begin = split * tiles_per_split * RT;
  const int row_end = min(n, row_begin + tiles_per_split * RT);

  for (int e = tid; e < QT * k; e += THREADS) {
    s_bd[e] = CUDART_INF_F;
    s_bi[e] = -1;
  }
  __syncthreads();

  for (int r0 = row_begin; r0 < row_end; r0 += RT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < QT * DC; e += THREADS) {
        const int r = e / DC, c = e % DC;
        const int gq = q0 + r, gc = d0 + c;
        s_q[c * PAD + r] =
            (gq < nq && gc < d) ? qs[(size_t)gq * d + gc] : 0.f;
      }
      for (int e = tid; e < RT * DC; e += THREADS) {
        const int r = e / DC, c = e % DC;
        const int gr = r0 + r, gc = d0 + c;
        s_x[c * PAD + r] =
            (gr < row_end && gc < d) ? db[(size_t)gr * d + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_q[c * PAD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = s_x[c * PAD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, gr = r0 + r;
        s_sc[(ty + 16 * i) * (RT + 1) + r] =
            gr < row_end ? dbsq[gr] - 2.f * acc[i][j] : CUDART_INF_F;
      }
    __syncthreads();

    // fold the tile into each query's sorted k-list: warp w owns queries
    // w*8 .. w*8+7 of the block
    for (int u = 0; u < QT / 8; ++u) {
      const int qq = warp * (QT / 8) + u;
      if (q0 + qq >= nq) break;  // uniform across the warp
      float* bd = s_bd + qq * k;
      int* bi = s_bi + qq * k;
      float thr = bd[k - 1];
      for (int half = 0; half < RT; half += 32) {
        const float s = s_sc[qq * (RT + 1) + half + lane];
        unsigned mask = __ballot_sync(0xffffffffu, s < thr);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cd = __shfl_sync(0xffffffffu, s, src);
          if (!(cd < thr)) continue;  // the list tightened meanwhile
          const int cid = r0 + half + src;
          // rank: entries at or below cd stay ahead (their ids are lower)
          int rank = 0;
          for (int e0 = 0; e0 < k; e0 += 32) {
            const int e = e0 + lane;
            rank += __popc(__ballot_sync(0xffffffffu, e < k && bd[e] <= cd));
          }
          // shift (rank, k-1] right by one and write the new entry
          const int ea = lane, eb = lane + 32;
          float va = 0.f, vb = 0.f;
          int ia = 0, ib = 0;
          if (ea < k) {
            va = ea > rank ? bd[ea - 1] : (ea == rank ? cd : bd[ea]);
            ia = ea > rank ? bi[ea - 1] : (ea == rank ? cid : bi[ea]);
          }
          if (eb < k) {
            vb = eb > rank ? bd[eb - 1] : (eb == rank ? cd : bd[eb]);
            ib = eb > rank ? bi[eb - 1] : (eb == rank ? cid : bi[eb]);
          }
          __syncwarp();
          if (ea < k) { bd[ea] = va; bi[ea] = ia; }
          if (eb < k) { bd[eb] = vb; bi[eb] = ib; }
          __syncwarp();
          thr = bd[k - 1];
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < QT * k; e += THREADS) {
    const int qq = e / k, j = e % k, gq = q0 + qq;
    if (gq < nq) {
      const size_t o = ((size_t)split * nq + gq) * k + j;
      part_d[o] = s_bd[e];
      part_i[o] = s_bi[e];
    }
  }
}

__global__ void topk_merge(const float* __restrict__ part_d,
                           const int* __restrict__ part_i, int nq, int k,
                           int splits, float* __restrict__ out_d,
                           int* __restrict__ out_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  int head[MAX_SPLITS];
  for (int s = 0; s < splits; ++s) head[s] = 0;
  for (int o = 0; o < k; ++o) {
    int best = 0;
    float bd = CUDART_INF_F;
    int bid = 0x7fffffff;
    for (int s = 0; s < splits; ++s) {
      if (head[s] >= k) continue;
      const size_t at = ((size_t)s * nq + q) * k + head[s];
      const float dv = part_d[at];
      const int iv = part_i[at];
      if (dv < bd || (dv == bd && iv < bid)) {
        bd = dv;
        bid = iv;
        best = s;
      }
    }
    head[best] += 1;
    out_d[(size_t)q * k + o] = bd;
    out_i[(size_t)q * k + o] = isinf(bd) ? -1 : bid;
  }
}

}  // namespace

extern "C" int pgvt_fused_topk(const float* qs, const float* db,
                               const float* dbsq, int nq, int n, int d, int k,
                               int splits, int tiles_per_split, float* part_d,
                               int* part_i, float* out_d, int* out_i,
                               void* stream) {
  if (k < 1 || k > MAX_K || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (2 * DC * PAD + QT * (RT + 1)) +
                      (sizeof(float) + sizeof(int)) * QT * k;
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((nq + QT - 1) / QT, splits);
  topk_pass1<<<grid1, THREADS, smem, st>>>(qs, db, dbsq, nq, n, d, k,
                                           tiles_per_split, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<(nq + 127) / 128, 128, 0, st>>>(part_d, part_i, nq, k, splits,
                                               out_d, out_i);
  return (int)cudaGetLastError();
}
