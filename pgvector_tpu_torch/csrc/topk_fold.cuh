// The top-k fold and the split merge shared by the exact scans: K1
// (fused_topk.cu, L2 / inner product) and K4 (bit_scan.cu, Hamming /
// Jaccard).  Both scans split the rows over blocks (pass 1) and fold each
// tile of scores into every query's sorted k-list in shared memory; pass 2
// merges the splits' lists.  Internal linkage: each source that includes
// this gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TOPK_MAX_K = 64;
constexpr int TOPK_MAX_SPLITS = 64;

// Fold one query's row of 32*H tile scores (row j, at row[j * STRIDE], has
// id id0 + j; ids ascend) into its sorted k-list (bd, bi) in shared memory,
// by one warp.
// The list is held in registers (entry e in lane e % 32), a ballot against
// the k-th value rejects most rows at once, and each survivor is inserted
// by a rank ballot and a shuffle up.  Rows arrive in ascending id order, so
// an insert goes after every equal distance: (distance, id) order without
// comparing ids.
template <int H, int STRIDE = 1>
__device__ __forceinline__ void fold_row(const float* __restrict__ row,
                                         int id0, float* bd, int* bi, int k,
                                         int lane) {
  const bool la = lane < k, lb = lane + 32 < k;
  float va = la ? bd[lane] : CUDART_INF_F;
  float vb = lb ? bd[lane + 32] : CUDART_INF_F;
  int ia = la ? bi[lane] : -1, ib = lb ? bi[lane + 32] : -1;
  float thr = __shfl_sync(0xffffffffu, k > 32 ? vb : va, (k - 1) & 31);
  float sv[H];
#pragma unroll
  for (int h = 0; h < H; ++h) sv[h] = row[(32 * h + lane) * STRIDE];
  bool changed = false;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    unsigned mask = __ballot_sync(0xffffffffu, sv[h] < thr);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float cd = __shfl_sync(0xffffffffu, sv[h], src);
      if (!(cd < thr)) continue;  // the list tightened meanwhile
      const int cid = id0 + 32 * h + src;
      // rank: entries at or below cd stay ahead (their ids are lower)
      const int rank = __popc(__ballot_sync(0xffffffffu, la && va <= cd)) +
                       __popc(__ballot_sync(0xffffffffu, lb && vb <= cd));
      // entries from rank on move up by one
      const float pa = __shfl_up_sync(0xffffffffu, va, 1);
      const int pia = __shfl_up_sync(0xffffffffu, ia, 1);
      float pb = __shfl_up_sync(0xffffffffu, vb, 1);
      int pib = __shfl_up_sync(0xffffffffu, ib, 1);
      const float a31 = __shfl_sync(0xffffffffu, va, 31);
      const int i31 = __shfl_sync(0xffffffffu, ia, 31);
      if (lane == 0) {
        pb = a31;
        pib = i31;
      }
      if (lane >= rank) {
        va = lane == rank ? cd : pa;
        ia = lane == rank ? cid : pia;
      }
      if (lane + 32 >= rank) {
        vb = lane + 32 == rank ? cd : pb;
        ib = lane + 32 == rank ? cid : pib;
      }
      thr = __shfl_sync(0xffffffffu, k > 32 ? vb : va, (k - 1) & 31);
      changed = true;
    }
  }
  if (changed) {
    if (la) {
      bd[lane] = va;
      bi[lane] = ia;
    }
    if (lb) {
      bd[lane + 32] = vb;
      bi[lane + 32] = ib;
    }
  }
}

// Pass 2: one thread per query merges the splits' sorted (split, query, k)
// lists by (distance, id) into the final k; ids are -1 where the distance
// is +inf.
__global__ void topk_merge(const float* __restrict__ part_d,
                           const int* __restrict__ part_i, int nq, int k,
                           int splits, float* __restrict__ out_d,
                           int* __restrict__ out_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  int head[TOPK_MAX_SPLITS];
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

inline cudaError_t launch_topk_merge(const float* part_d, const int* part_i,
                                     int nq, int k, int splits, float* out_d,
                                     int* out_i, cudaStream_t st) {
  topk_merge<<<(nq + 127) / 128, 128, 0, st>>>(part_d, part_i, nq, k, splits,
                                               out_d, out_i);
  return cudaGetLastError();
}

}  // namespace
