// K4 bit_topk and K5 bit_point_scores — Hamming and Jaccard distances over
// packed 32-bit words (bit i in word i/32, bit 31 - i%32; int32 words that
// hold the reference's uint32 bit patterns).
//
// Neither replaces a Pallas kernel: the JAX package runs both as XLA
// programs with lax.population_count.  K4 replaces ops/distance.bit_scores
// under ops/topk.tiled_topk (FlatIndex's bit scan); K5 the bit branches of
// index/hnsw_kernels.make_scorer (the hop and the wave search) and of
// _pairwise_dists (the select block), and the popcount branch of the IVF
// block scan.  Built without --use_fast_math: Jaccard's f32 division
// rounds as in the plain versions, so results are bitwise equal.
//
// K4 (bit_topk_pass1 + topk_merge): the exact top-k of every query over
//   the table.  Distance d(q, x) = popc(q ^ x) (Hamming) or, with
//   ab = popc(q & x), 1 - ab / (|q| + |x| - ab), 1 where ab == 0
//   (Jaccard, src/bitutils.c:98-131); dead or filtered rows are +inf.
//   What bounds it on an H100: the popcounts, Q*N*W of them.  At 8,000
//   queries x 1M rows x 4 words that is 32 G; at the __popc issue rate of
//   16 a clock per SM (132 SMs, 1.755 GHz) about 8 ms.  The same Hamming
//   work as an int8 tensor-core product on unpacked bits, |a| + |b| - 2 a.b,
//   is 2.05 TOP, about 1.0 ms at 1,979 TOP/s: that is the bound, and the
//   design of a later kernel.  Device memory: N*W*4 bytes per 128-query
//   tile, from L2 after the first.
//   Design: grid = (query tiles of 128) x (row splits), as K1 (the splits
//   from ops/fused_topk._splits).  A block of 256 threads walks its split
//   in 128-row tiles; each thread owns 8 queries x 8 rows of the tile and
//   sums their popcounts in registers.  Words come through shared memory
//   in chunks of 16 (one query chunk, one row chunk), so any width up to
//   MAX_DIM_BIT bits (2,000 words) fits.  The finished tile's scores go to
//   shared memory, and each warp folds the queries it owns with fold_row
//   (topk_fold.cuh), as K1 does; rows arrive in ascending order, so the
//   lists keep (distance, id) order.  Pass 2 is K1's topk_merge.
//
// K5 (bit_point_scores): d(qs[b], table[rows[b, j]]) into out[b, j], +inf
//   where rows[b, j] < 0: one launch does the gather, the XOR / AND and the
//   popcounts.  One thread per (b, j) pair, 16-byte loads where rows are
//   16-byte aligned.  Bound: the rows' words read once (B*R*W*4 bytes of
//   scattered 16-byte reads) against B*R*W popcounts.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_fold.cuh"

namespace {

constexpr int BQ = 128;        // queries per block (ops/fused_topk._QT)
constexpr int BR = 128;        // rows per tile (ops/fused_topk._RT)
constexpr int WK = 16;         // words per chunk
constexpr int SW = WK + 1;     // padded word rows: conflict-free reads
constexpr int SC = BR + 16;    // score tile row: two query rows per warp
constexpr int THREADS = 256;

__device__ __forceinline__ float jaccard(int ab, int aa, int bb) {
  const float fab = (float)ab;
  const float denom = (float)aa + (float)bb - fab;
  return ab == 0 ? 1.0f : 1.0f - fab / (denom > 0.f ? denom : 1.0f);
}

template <bool JAC>
__global__ void __launch_bounds__(THREADS, 1)
bit_topk_pass1(const int* __restrict__ qs, const int* __restrict__ db,
               const int* __restrict__ pop,
               const unsigned char* __restrict__ valid, int nq, int n, int w,
               int k, int tiles_per_split, float* __restrict__ part_d,
               int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  int* s_q = reinterpret_cast<int*>(smem);  // [BQ][SW] a chunk of words
  int* s_r = s_q + BQ * SW;                 // [BR][SW]
  float* s_sc = reinterpret_cast<float*>(s_r + BR * SW);  // [BQ][SC]
  float* s_bd = s_sc + BQ * SC;                           // [BQ][k]
  int* s_bi = reinterpret_cast<int*>(s_bd + BQ * k);      // [BQ][k]
  int* s_hit = s_bi + BQ * k;                             // [BQ]
  int* s_aa = s_hit + BQ;                                 // [BQ] |q|

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tq = tid / 16, tr = tid % 16;  // queries tq + 16 i, rows tr + 16 j
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int row_begin = split * tiles_per_split * BR;
  const int row_end = min(n, row_begin + tiles_per_split * BR);

  for (int e = tid; e < BQ * k; e += THREADS) {
    s_bd[e] = CUDART_INF_F;
    s_bi[e] = -1;
  }
  for (int e = tid; e < BQ; e += THREADS) {
    s_hit[e] = 0;
    int a = 0;
    if (JAC && q0 + e < nq)
      for (int c = 0; c < w; ++c) a += __popc(qs[(size_t)(q0 + e) * w + c]);
    s_aa[e] = a;
  }

  for (int r0 = row_begin; r0 < row_end; r0 += BR) {
    int acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    for (int w0 = 0; w0 < w; w0 += WK) {
      const int wk = min(WK, w - w0);
      // every thread is done with the last chunk, and with the last fold
      __syncthreads();
      for (int e = tid; e < BQ * wk; e += THREADS) {
        const int r = e / wk, c = e % wk;
        s_q[r * SW + c] =
            q0 + r < nq ? qs[(size_t)(q0 + r) * w + w0 + c] : 0;
        s_r[r * SW + c] =
            r0 + r < row_end ? db[(size_t)(r0 + r) * w + w0 + c] : 0;
      }
      __syncthreads();
      for (int c = 0; c < wk; ++c) {
        int a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = s_q[(tq + 16 * i) * SW + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = s_r[(tr + 16 * j) * SW + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] += __popc(JAC ? (a[i] & b[j]) : (a[i] ^ b[j]));
      }
    }

    // the tile's scores to shared memory in row order, and a flag on each
    // query with a score below its k-th best
    bool rok[8];
    int rb[8];  // the rows' popcounts (Jaccard)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gr = r0 + tr + 16 * j;
      rok[j] = gr < row_end && valid[gr];
      rb[j] = JAC && rok[j] ? pop[gr] : 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qq = tq + 16 * i;
      const float thr = s_bd[qq * k + k - 1];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = !rok[j] ? CUDART_INF_F
                        : JAC   ? jaccard(acc[i][j], s_aa[qq], rb[j])
                                : (float)acc[i][j];
        s_sc[qq * SC + tr + 16 * j] = v;
        hit |= v < thr;
      }
      if (hit) s_hit[qq] = 1;
    }
    __syncthreads();

    // fold: warp w owns queries w*16 .. w*16+15 of the block
    const int qb = warp * (BQ / 8);
    unsigned todo = __ballot_sync(0xffffffffu,
                                  lane < BQ / 8 && s_hit[qb + lane] != 0);
    if (lane < BQ / 8) s_hit[qb + lane] = 0;
    while (todo) {
      const int qq = qb + __ffs(todo) - 1;
      todo &= todo - 1;
      if (q0 + qq >= nq) break;  // uniform across the warp
      fold_row<BR / 32>(s_sc + qq * SC, r0, s_bd + qq * k, s_bi + qq * k,
                        k, lane);
    }
    // the next chunk's first barrier orders this fold before the next
    // tile's scores overwrite s_sc
  }
  __syncthreads();

  for (int e = tid; e < BQ * k; e += THREADS) {
    const int qq = e / k, j = e % k, gq = q0 + qq;
    if (gq < nq) {
      const size_t o = ((size_t)split * nq + gq) * k + j;
      part_d[o] = s_bd[e];
      part_i[o] = s_bi[e];
    }
  }
}

template <bool JAC>
__global__ void bit_point_scores(const int* __restrict__ qs,
                                 const int* __restrict__ table,
                                 const int* __restrict__ rows, int nb, int r,
                                 int w, int vec, float* __restrict__ out) {
  const size_t at = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= (size_t)nb * r) return;
  const int row = rows[at];
  if (row < 0) {
    out[at] = CUDART_INF_F;
    return;
  }
  const int* q = qs + (at / r) * w;
  const int* x = table + (size_t)row * w;
  int acc = 0, aa = 0, bb = 0;
  if (vec) {
    const int4* q4 = reinterpret_cast<const int4*>(q);
    const int4* x4 = reinterpret_cast<const int4*>(x);
    for (int c = 0; c < w / 4; ++c) {
      const int4 a = __ldg(q4 + c), b = __ldg(x4 + c);
      if (JAC) {
        acc += __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
               __popc(a.w & b.w);
        aa += __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
        bb += __popc(b.x) + __popc(b.y) + __popc(b.z) + __popc(b.w);
      } else {
        acc += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
               __popc(a.w ^ b.w);
      }
    }
  } else {
    for (int c = 0; c < w; ++c) {
      const int a = __ldg(q + c), b = __ldg(x + c);
      if (JAC) {
        acc += __popc(a & b);
        aa += __popc(a);
        bb += __popc(b);
      } else {
        acc += __popc(a ^ b);
      }
    }
  }
  out[at] = JAC ? jaccard(acc, aa, bb) : (float)acc;
}

}  // namespace

extern "C" int pgvt_bit_topk(const int* qs, const int* db, const int* pop,
                             const unsigned char* valid, int nq, int n,
                             int w, int k, int jaccard_metric, int splits,
                             int tiles_per_split, float* part_d, int* part_i,
                             float* out_d, int* out_i, void* stream) {
  if (k < 1 || k > TOPK_MAX_K || splits < 1 || splits > TOPK_MAX_SPLITS ||
      w < 1 || (jaccard_metric && pop == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int) * (BQ + BR) * SW + sizeof(float) * BQ * SC +
                      (sizeof(float) + sizeof(int)) * BQ * k +
                      2 * sizeof(int) * BQ;
  auto kern = jaccard_metric ? bit_topk_pass1<true> : bit_topk_pass1<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((nq + BQ - 1) / BQ, splits);
  kern<<<grid1, THREADS, smem, st>>>(qs, db, pop, valid, nq, n, w, k,
                                     tiles_per_split, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(part_d, part_i, nq, k, splits, out_d, out_i,
                                st);
}

extern "C" int pgvt_bit_point_scores(const int* qs, const int* table,
                                     const int* rows, int nb, int r, int w,
                                     int jaccard_metric, float* out,
                                     void* stream) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)nb * r;
  if (total == 0) return (int)cudaSuccess;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(qs) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (jaccard_metric)
    bit_point_scores<true><<<blocks, threads, 0, st>>>(qs, table, rows, nb, r,
                                                       w, vec, out);
  else
    bit_point_scores<false><<<blocks, threads, 0, st>>>(qs, table, rows, nb,
                                                        r, w, vec, out);
  return (int)cudaGetLastError();
}
