// K1 — fused exact top-k scan (L2 / inner product), f32 accuracy on the
// tensor cores.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_topk.py:_kernel
// (driven by _pallas_scan / exact_topk).  For every query q and live row x
// it forms the ordering score  dbsq[x] - 2 q.x  (dbsq = |x|^2 for L2, 0 for
// inner product, +inf for dead rows) and keeps the k smallest per query,
// ties to the lower row id.  The caller adds |q|^2 (L2) or halves the score
// (IP), as pallas_topk.exact_topk does.
//
// What bounds it on an H100: the product, Q*N*D*2 flops (about 2 TFLOP at
// 8,000 queries x 1M x 128).  On the CUDA cores in f32 that is 30.6 ms at
// 67 TFLOP/s.  Plain TF32 loses recall, so the tensor cores run the 3xTF32
// split: a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and q.x is taken
// as hi.hi + hi.lo + lo.hi (the dropped lo.lo is about 2^-22 relative):
// three TF32 products, 6.1 TFLOP at 495 TFLOP/s = 12.4 ms.  mma.sync does
// not reach that peak (only wgmma does); on the card each added product
// cost about 10 ms at the main path's launch, so the three products alone
// take about 30 ms.  Device memory is read once per 128-query tile.
//
// Design:
//   pass 1 (topk_pass1): grid = (query tiles of 128) x (DB splits).  A
//     block of 256 threads walks its split in 128-row tiles, each in chunks
//     of 32 dims.  A two-stage cp.async ring (16-byte copies where rows are
//     16-byte aligned) brings the next chunk of queries and rows while the
//     current one is fed to mma.sync.m16n8k8 TF32: 8 warps as 2 x 4, each
//     warp a 64 x 32 tile of 4 x 4 fragments.  Each value is split into hi
//     and lo in registers as its fragment is loaded from shared memory (a
//     split pass through shared memory cost one more barrier and three
//     times the shared-memory bytes a chunk, and measured slower).  Each
//     32-dim chunk is summed into fresh accumulators and then added to the
//     tile's running f32 sums, so no accumulator chain is longer than 12
//     tensor-core adds.
//   The fold: the finished 128 x 128 score tile goes to shared memory in row
//     order, and each thread flags the queries for which it holds a score
//     below the query's current k-th best.  Each warp then folds its
//     flagged queries (16 per warp; most are not flagged once the lists
//     have filled): the query's sorted k-list is held in registers (entry
//     e in lane e % 32), a ballot against the k-th value rejects most rows
//     at once, and each survivor is inserted by a rank ballot and a shuffle
//     up.  Rows arrive in ascending id order, so an insert goes after every
//     equal distance: (distance, id) order without comparing ids.
//   pass 2 (topk_merge): one thread per query merges the splits' sorted
//     lists by (distance, id) into the final k; ids are -1 where the
//     distance is +inf.
// The split count is chosen by the caller so that pass 1 fills whole waves
// of the card's SMs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_fold.cuh"

namespace {

constexpr int BQ = 128;        // queries per block
constexpr int BR = 128;        // DB rows per tile
constexpr int DK = 32;         // dims per chunk
constexpr int SK = DK + 4;     // padded smem row: fragment loads hit 32 banks
constexpr int SC = BR + 8;     // score tile row: float2 stores conflict-free
constexpr int TILE = BQ * SK;  // floats in one chunk buffer (BQ == BR)
constexpr int THREADS = 256;
constexpr int MAX_K = TOPK_MAX_K;
constexpr int MAX_SPLITS = TOPK_MAX_SPLITS;
static_assert(BQ == BR, "one chunk buffer size serves queries and rows");

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// a = hi + lo: hi = tf32(a), lo = tf32(a - hi), as mma operands
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(a - h));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// c += a.b for one 16x8x8 TF32 fragment
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy one chunk (dims d0 .. d0+DK) of `rows` rows starting at g0 into a
// [BQ][SK] buffer; rows at or past `end` and dims past d read as zero.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int g0, int end, int d0, int d,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < BQ * (DK / 4); e += THREADS) {
      const int r = e / (DK / 4), c = (e % (DK / 4)) * 4;
      const bool ok = g0 + r < end && d0 + c < d;
      cp_async16(dst + r * SK + c,
                 ok ? src + (size_t)(g0 + r) * d + d0 + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BQ * DK; e += THREADS) {
      const int r = e / DK, c = e % DK;
      const bool ok = g0 + r < end && d0 + c < d;
      cp_async4(dst + r * SK + c,
                ok ? src + (size_t)(g0 + r) * d + d0 + c : src, ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
topk_pass1(const float* __restrict__ qs, const float* __restrict__ db,
           const float* __restrict__ dbsq, int nq, int n, int d, int k,
           int tiles_per_split, int vec, float* __restrict__ part_d,
           int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                 // 2 stages x {queries, rows} [BQ][SK]
  float* s_sc = smem + 4 * TILE;      // [BQ][SC] the finished tile's scores
  float* s_bd = s_sc + BQ * SC;       // [BQ][k] sorted best distances
  int* s_bi = reinterpret_cast<int*>(s_bd + BQ * k);  // [BQ][k] their ids
  int* s_hit = s_bi + BQ * k;  // [BQ] the tile has a score below the k-th

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;        // fragment group / thread
  const int wq = (warp / 4) * 64, wr = (warp % 4) * 32;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int row_begin = split * tiles_per_split * BR;
  const int row_end = min(n, row_begin + tiles_per_split * BR);
  const int nchunks = (d + DK - 1) / DK;
  const int ntiles = row_end > row_begin ? (row_end - row_begin + BR - 1) / BR
                                         : 0;
  const int steps = ntiles * nchunks;

  for (int e = tid; e < BQ * k; e += THREADS) {
    s_bd[e] = CUDART_INF_F;
    s_bi[e] = -1;
  }
  for (int e = tid; e < BQ; e += THREADS) s_hit[e] = 0;

  float acc[4][4][4] = {};  // the tile's running sums
  if (steps > 0) {
    load_chunk(ring, qs, q0, nq, 0, d, vec);
    load_chunk(ring + TILE, db, row_begin, row_end, 0, d, vec);
  }
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    const int ch = s % nchunks;
    const int r0 = row_begin + (s / nchunks) * BR;
    // this step's chunk has landed, and every thread is done with the
    // other stage (read in the step before)
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps) {  // prefetch the next chunk into the other stage
      const int nch = (s + 1) % nchunks;
      const int nr0 = row_begin + ((s + 1) / nchunks) * BR;
      float* st = ring + ((s + 1) & 1) * 2 * TILE;
      load_chunk(st, qs, q0, nq, nch * DK, d, vec);
      load_chunk(st + TILE, db, nr0, row_end, nch * DK, d, vec);
    }
    cp_async_commit();

    const float* s_q = ring + (s & 1) * 2 * TILE;
    const float* s_x = s_q + TILE;
    float part[4][4][4];  // this chunk's sums
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

#pragma unroll
    for (int k0 = 0; k0 < DK; k0 += 8) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (wq + 16 * i + g) * SK + k0 + t;
        split_tf32(s_q[r], ah[i][0], al[i][0]);
        split_tf32(s_q[r + 8 * SK], ah[i][1], al[i][1]);
        split_tf32(s_q[r + 4], ah[i][2], al[i][2]);
        split_tf32(s_q[r + 8 * SK + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (wr + 8 * j + g) * SK + k0 + t;
        uint32_t bh[2], bl[2];
        split_tf32(s_x[c], bh[0], bl[0]);
        split_tf32(s_x[c + 4], bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // small terms first
          mma(part[i][j], al[i], bh);
          mma(part[i][j], ah[i], bl);
          mma(part[i][j], ah[i], bh);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] =
              ch == 0 ? part[i][j][e] : acc[i][j][e] + part[i][j][e];

    if (ch != nchunks - 1) continue;

    // the tile is done: scores to shared memory in row order (the last
    // fold's reads of s_sc finished before this step's first barrier), and
    // a flag on each query with a score below its k-th best
    {
      float thr[4][2];
      bool hit[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          thr[i][h] = s_bd[(wq + 16 * i + 8 * h + g) * k + k - 1];
          hit[i][h] = false;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wr + 8 * j + 2 * t, gr = r0 + c;
        const float n0 = gr < row_end ? dbsq[gr] : CUDART_INF_F;
        const float n1 = gr + 1 < row_end ? dbsq[gr + 1] : CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = make_float2(n0 - 2.f * acc[i][j][2 * h],
                                         n1 - 2.f * acc[i][j][2 * h + 1]);
            *reinterpret_cast<float2*>(
                s_sc + (wq + 16 * i + 8 * h + g) * SC + c) = v;
            hit[i][h] |= v.x < thr[i][h] || v.y < thr[i][h];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (hit[i][h]) s_hit[wq + 16 * i + 8 * h + g] = 1;
    }
    __syncthreads();

    // fold the tile into the flagged queries' sorted k-lists: warp w owns
    // queries w*16 .. w*16+15 of the block
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
    // the next step's barrier orders this fold before the next tile's
    // scores overwrite s_sc
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

}  // namespace

extern "C" int pgvt_fused_topk(const float* qs, const float* db,
                               const float* dbsq, int nq, int n, int d, int k,
                               int splits, int tiles_per_split, float* part_d,
                               int* part_i, float* out_d, int* out_i,
                               void* stream) {
  if (k < 1 || k > MAX_K || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need 16-byte aligned rows
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(qs) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(db) % 16 == 0;
  const size_t smem = sizeof(float) * (4 * TILE + BQ * SC) +
                      (sizeof(float) + sizeof(int)) * BQ * k +
                      sizeof(int) * BQ;
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((nq + BQ - 1) / BQ, splits);
  topk_pass1<<<grid1, THREADS, smem, st>>>(qs, db, dbsq, nq, n, d, k,
                                           tiles_per_split, vec, part_d,
                                           part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(part_d, part_i, nq, k, splits, out_d, out_i,
                                st);
}
