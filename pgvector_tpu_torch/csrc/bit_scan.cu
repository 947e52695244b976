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
//   the table.  With ab = |q & x| (the dot product of the bits as 0/1
//   values), the distance is |q| + |x| - 2 ab = popc(q ^ x) (Hamming) or
//   1 - ab / (|q| + |x| - ab), 1 where ab == 0 (Jaccard,
//   src/bitutils.c:98-131); dead or filtered rows are +inf.  Every term is
//   an exact integer, so distances equal the plain versions' bitwise.
//   What bounds it on an H100: ab as an int8 tensor-core product,
//   2*Q*N*bits operations: at 8,000 queries x 1M rows x 128 bits 2.05 TOP,
//   1.03 ms at 1,979 TOP/s.  Device memory: the packed table, N*W*4 bytes
//   per 128-query tile, from L2 after the first.
//
//   The product.  Grid = (query tiles of 128) x (row splits), as K1 (the
//   splits from ops/fused_topk._splits).  A block walks its split in
//   128-row tiles with 16 consumer warps and one producer warp.  The
//   producer fills a ring of up to 8 shared-memory stages with cp.async
//   (packed words in chunks of 16, and the tile's validity bytes; the
//   queries load once when one chunk holds the whole width), each stage
//   with a "full" mbarrier its copies complete and an "empty" one the
//   consumers release.  So any width up to MAX_DIM_BIT bits fits and the
//   table stays packed, 32x smaller than its bits as bytes.  A consumer
//   warp owns 16 queries on one half of every tile: 8 mma.sync.m16n8k32
//   s8 fragments a k-step, one packed word a k-step of 32 bits.  Bits
//   become the fragments' bytes in registers as each word leaves shared
//   memory: lane t of a fragment's four takes bit 2t + 8i (i = 0..3) as a
//   0/1 byte and bit 2t + 1 + 8i as a 0/2 byte, a shift and two masks for
//   the row fragment, and the query fragment weighs its bytes 2 and 1 the
//   other way round, so every product counts twice and the same bit sits
//   at the same k in A and B (the dot product does not care which k holds
//   which bit; tail bits past the type's width are zero in the rows).
//   Hamming gives the query bytes a sign (a set bit +, a clear one -), so
//   acc = 2 (2 ab - |x|) and d = |q| - acc / 2 needs no row popcount;
//   Jaccard multiplies unsigned bytes (acc = 2 ab) and counts |x| with one
//   __popc a word a row.  |q| takes one __popc a word a query at the
//   start.
//
//   The selection.  Each warp keeps its own k-list a query for its half
//   (the two halves' lists merge by (distance, id) at the end) and folds
//   with fold_row (topk_fold.cuh, K1's): rows arrive in ascending order,
//   so a list keeps (distance, id) order.  After a half tile the warp
//   flags each of its queries with a valid score that may beat both its
//   list's k-th and the bound its splits share (an integer test for
//   Hamming, a multiply that errs toward flagging for Jaccard); only a
//   flagged query forms its row's f32 distances, exactly as the plain
//   version does, and folds it.  The bound: a block sees only its split
//   (22.8k rows at 8,000 x 1M), so on its own each list keeps finding
//   rows that beat it.  The splits of a query therefore share the least
//   of two bounds in out_d[q, 0] (atomicMin; pass 2 overwrites it): a
//   full list's k-th, and the largest of k slots in out_i[q, :] (also
//   overwritten), each holding the least distance of the candidate rows
//   that hash to it, so k distinct rows lie at or below it.  A row above
//   the bound is not in the top-k, so results do not depend on timing.
//   Blocks of one query tile run in different waves (the query tile is
//   the grid's fast index), so most start with a tight bound.  No block
//   barrier ties the consumers together: one warp's fold overlaps the
//   others' products.  Pass 2 is K1's topk_merge.
//
// K5 (bit_point_scores): d(qs[b], table[rows[b, j]]) into out[b, j], +inf
//   where rows[b, j] < 0: one launch does the gather, the XOR / AND and the
//   popcounts.  One thread per (b, j) pair, 16-byte loads where rows are
//   16-byte aligned.  Bound: the rows' words read once (B*R*W*4 bytes of
//   scattered 16-byte reads) against B*R*W popcounts.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "topk_fold.cuh"

namespace {

constexpr int BQ = 128;        // queries per block (ops/fused_topk._QT)
constexpr int BR = 128;        // rows per tile (ops/fused_topk._RT)
constexpr int HALF = BR / 2;   // rows of a tile one consumer warp takes
constexpr int WK = 16;         // words per chunk: 16 k-steps of 32 bits
constexpr int MAX_NS = 8;      // ring stages at most
constexpr int CONSUMERS = 16;  // warps: 16 queries x half a tile each
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int NF = HALF / 8;   // n8 fragments across half a tile
constexpr unsigned BYTE_LSB = 0x01010101u;
// the shared k-th best before any split has a full list: the float of four
// 0x7F bytes (about 3.396e38), above every distance; only compared with
// distances, which are >= 0, so their bits order as ints for atomicMin
constexpr float NO_KTH = 3.3961514e38f;
static_assert(BQ == BR && BQ == 16 * CONSUMERS / 2, "tile shape");

// Shared-memory row stride in words for chunks of `wk4` words: an odd
// multiple of 4, so 16-byte loads of 8 consecutive rows hit 32 banks.
__host__ __device__ constexpr int word_stride(int wk4) {
  return (wk4 / 4) % 2 ? wk4 : wk4 + 4;
}

__device__ __forceinline__ float jaccard(int ab, int aa, int bb) {
  const float fab = (float)ab;
  const float denom = (float)aa + (float)bb - fab;
  return ab == 0 ? 1.0f : 1.0f - fab / (denom > 0.f ? denom : 1.0f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival on `bar` once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// word u (0..3, known at compile time) of a 16-byte load
__device__ __forceinline__ unsigned word_of(const int4& v, int u) {
  return (unsigned)(u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w);
}

// Row id -> one of k slots, a multiplicative hash (no division).
__device__ __forceinline__ int slot_of(int id, int k) {
  return (int)__umulhi((unsigned)id * 2654435761u, (unsigned)k);
}

// An exact float of an integer below 2^23 without the quarter-rate I2F.
__device__ __forceinline__ float small_float(int x) {
  return __int_as_float(0x4B000000 | x) - 8388608.f;
}

// c += a.b for one 16x8x32 fragment of bytes, exact in int32.  Volatile:
// the products keep their source order (a k-step's 16 independent ones in
// a row), which the compiler otherwise regroups into chains of dependent
// products on one accumulator.
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy words w0 .. w0+wk4 of 128 rows starting at g0 into a [128][sw]
// buffer, by the `nt` threads numbered `id`; rows at or past `end` and
// words past w read as zero.
__device__ __forceinline__ void load_words(int* dst, const int* src, int g0,
                                           int end, int w0, int wk4, int w,
                                           int sw, bool vec, int id, int nt) {
  if (vec) {  // w % 4 == 0: a 16-byte piece is all in or all out
    for (int c = 0; c < wk4; c += 4)
      for (int r = id; r < BR; r += nt) {
        const bool ok = g0 + r < end && w0 + c < w;
        cp_async16(dst + r * sw + c,
                   ok ? src + (size_t)(g0 + r) * w + w0 + c : src,
                   ok ? 16 : 0);
      }
  } else {
    for (int c = 0; c < wk4; ++c)
      for (int r = id; r < BR; r += nt) {
        const bool ok = g0 + r < end && w0 + c < w;
        cp_async4(dst + r * sw + c,
                  ok ? src + (size_t)(g0 + r) * w + w0 + c : src, ok ? 4 : 0);
      }
  }
}

// Fold a warp's score row of half a tile into one query's k-list, then
// share two bounds on the query's final k-th best with its other splits:
// the list's k-th once full, and the largest of the query's k slots once
// each holds a row (k distinct rows, one a slot, lie at or below it).  Out
// of line, so that the products' loop gets its registers without the
// fold's.
__device__ __noinline__ void fold_and_share(const float* row, int id0,
                                            float* bd, int* bi, int k,
                                            int lane, const int* qslots,
                                            float* kth_out) {
  fold_row<HALF / 32>(row, id0, bd, bi, k, lane);
  __syncwarp();
  int bound = lane < k ? __ldcg(qslots + lane) : 0;
  if (lane + 32 < k) bound = max(bound, __ldcg(qslots + lane + 32));
  bound = __reduce_max_sync(0xffffffffu, bound);
  bound = min(bound, __float_as_int(fminf(bd[k - 1], NO_KTH)));
  if (lane == 0 && __int_as_float(bound) < NO_KTH)
    atomicMin(reinterpret_cast<int*>(kth_out), bound);
  __syncwarp();
}

// Where a step of the ring stands, advanced without divisions: stage `at`
// (of ns) in its `round`, chunk `ch` (of nchunks) of the tile at row r0.
struct StepCursor {
  int at = 0, round = 0, ch = 0, r0;
  __device__ explicit StepCursor(int row0) : r0(row0) {}
  __device__ void next(int ns, int nchunks) {
    if (++at == ns) {
      at = 0;
      ++round;
    }
    if (++ch == nchunks) {
      ch = 0;
      r0 += BR;
    }
  }
};

template <bool JAC>
__global__ void __launch_bounds__(THREADS, 1)
bit_topk_pass1(const int* __restrict__ qs, const int* __restrict__ db,
               const unsigned char* __restrict__ valid, int nq, int n, int w,
               int k, int tiles_per_split, int vec, int ns,
               float* __restrict__ part_d, int* __restrict__ part_i,
               float* __restrict__ shared_kth, int* __restrict__ slots) {
  extern __shared__ __align__(16) int smem[];
  const int nchunks = (w + WK - 1) / WK;
  const int sw = word_stride((min(WK, w) + 3) & ~3);
  // one chunk holds every word: the queries load once, outside the ring
  const bool q_once = nchunks == 1;
  const int qwords = BQ * sw;  // one chunk of query words
  // a stage: [query words,] row words [BR][sw], validity bytes [BR]
  const int stage = (q_once ? 0 : qwords) + BR * sw + BR / 4;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + MAX_NS;
  int* s_q1 = smem + 4 * MAX_NS;         // the queries when q_once
  int* ring = s_q1 + (q_once ? qwords : 0);
  // a consumer warp's score row: [CONSUMERS][HALF]
  float* s_sc = reinterpret_cast<float*>(ring + ns * stage);
  // each half's sorted k-lists: [2][BQ][k] distances and ids
  float* s_bd = s_sc + CONSUMERS * HALF;
  int* s_bi = reinterpret_cast<int*>(s_bd + 2 * BQ * k);
  int* s_aa = s_bi + 2 * BQ * k;  // [BQ] |q|

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int row_begin = split * tiles_per_split * BR;
  const int row_end = min(n, row_begin + tiles_per_split * BR);
  const int ntiles = row_end > row_begin ? (row_end - row_begin + BR - 1) / BR
                                         : 0;
  const int steps = ntiles * nchunks;

  for (int e = tid; e < 2 * BQ * k; e += THREADS) {
    s_bd[e] = CUDART_INF_F;
    s_bi[e] = -1;
  }
  for (int e = tid; e < BQ; e += THREADS) {
    int a = 0;
    if (q0 + e < nq)
      for (int c = 0; c < w; ++c) a += __popc(qs[(size_t)(q0 + e) * w + c]);
    s_aa[e] = a;
  }
  if (tid < ns) {
    mbar_init(full + tid, 32);          // the producer's lanes, as copies land
    mbar_init(empty + tid, CONSUMERS);  // one arrival a consumer warp
  }
  if (q_once)
    load_words(s_q1, qs, q0, nq, 0, (w + 3) & ~3, w, sw, vec, tid, THREADS);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp == CONSUMERS) {
    // The producer: step s (chunk s % nchunks of row tile s / nchunks) into
    // stage s % ns, once every consumer has left what that stage held.
    StepCursor cur(row_begin);
    for (int s = 0; s < steps; ++s, cur.next(ns, nchunks)) {
      const int at = cur.at, ch = cur.ch, r0 = cur.r0;
      if (cur.round > 0) mbar_wait(empty + at, (cur.round + 1) & 1);
      const int w0 = ch * WK, wk4 = (min(WK, w - w0) + 3) & ~3;
      int* st = ring + at * stage;
      int* rows = st + (q_once ? 0 : qwords);
      if (!q_once) load_words(st, qs, q0, nq, w0, wk4, w, sw, vec, lane, 32);
      load_words(rows, db, r0, row_end, w0, wk4, w, sw, vec, lane, 32);
      if (lane < BR / 16) {  // validity bytes past row_end read as 0
        const int b = min(max(row_end - (r0 + 16 * lane), 0), 16);
        cp_async16(reinterpret_cast<unsigned char*>(rows + BR * sw) +
                       16 * lane,
                   b > 0 ? valid + r0 + 16 * lane : valid, b);
      }
      cp_async_arrive(full + at);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // A consumer warp: queries wq .. wq + 15 on rows half * 64 .. + 63 of
  // every tile, with its own k-lists (merged with the other half's at the
  // end).  The producer skips the loop (it has no steps of its own).
  const int g = lane / 4, t = lane % 4;  // fragment group / thread
  const int wq = (warp % (CONSUMERS / 2)) * 16, half = warp / (CONSUMERS / 2);
  const int qr0 = wq + g, qr1 = wq + g + 8;
  const int aa0 = s_aa[qr0], aa1 = s_aa[qr1];
  float* bd = s_bd + half * BQ * k;
  int* bi = s_bi + half * BQ * k;
  float* row_buf = s_sc + warp * HALF;
  int acc[NF][4];  // the products: rows g and g + 8, columns 2t, 2t + 1
  int rp[NF];      // Jaccard: |x| of column 8j + g
  // the splits' shared bound on the k-th best of the warp's two rows, read
  // a tile ahead so that its latency hides behind a tile's work
  const float* kth_at0 = shared_kth + (size_t)(q0 + qr0) * k;
  const float* kth_at1 = shared_kth + (size_t)(q0 + qr1) * k;
  const bool live0 = q0 + qr0 < nq, live1 = q0 + qr1 < nq;
  float next0 = live0 ? __ldcg(kth_at0) : NO_KTH;
  float next1 = live1 ? __ldcg(kth_at1) : NO_KTH;
  StepCursor cur(row_begin + half * HALF);
  for (int s = 0; s < (warp < CONSUMERS ? steps : 0);
       ++s, cur.next(ns, nchunks)) {
    const int at = cur.at, ch = cur.ch, r0 = cur.r0;
    float kth0 = NO_KTH, kth1 = NO_KTH;
    if (ch == nchunks - 1) {
      kth0 = next0;
      kth1 = next1;
      if (live0) next0 = __ldcg(kth_at0);
      if (live1) next1 = __ldcg(kth_at1);
    }
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
        rp[j] = 0;
      }
    }
    mbar_wait(full + at, cur.round & 1);
    const int* st = ring + at * stage;
    const int* s_q = q_once ? s_q1 : st;
    const int* s_x = st + (q_once ? 0 : qwords);
    const int wk4 = (min(WK, w - ch * WK) + 3) & ~3;
    for (int c = 0; c < wk4; c += 4) {
      // the query fragments of words c .. c + 3: lane t of a fragment's
      // four takes bits 2t + 8i and 2t + 1 + 8i (i = 0..3) as bytes, and
      // so does every row fragment below, so the same bit lands on the
      // same k in A and B
      const int4 qa0 =
          *reinterpret_cast<const int4*>(s_q + (wq + g) * sw + c);
      const int4 qa1 =
          *reinterpret_cast<const int4*>(s_q + (wq + g + 8) * sw + c);
      int4 xb[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j)
        xb[j] = *reinterpret_cast<const int4*>(
            s_x + (half * HALF + 8 * j + g) * sw + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // A row fragment's bytes are bit 2t + 8i as 0/1 and bit 2t + 1 + 8i
        // as 0/2 (a shift and two masks); the query's bytes for the first
        // weigh twice the second's, so every product counts twice: acc is
        // twice the dot product.
        const unsigned x0 = word_of(qa0, u), x1 = word_of(qa1, u);
        unsigned a[4] = {(x0 >> (2 * t)) & BYTE_LSB,
                         (x1 >> (2 * t)) & BYTE_LSB,
                         (x0 >> (2 * t + 1)) & BYTE_LSB,
                         (x1 >> (2 * t + 1)) & BYTE_LSB};
        if (!JAC) {  // bytes +2 / +1 for a set bit, -2 / -1 for a clear one
          a[0] = (a[0] ^ BYTE_LSB) * 0xFCu + 2 * BYTE_LSB;
          a[1] = (a[1] ^ BYTE_LSB) * 0xFCu + 2 * BYTE_LSB;
          a[2] = (a[2] ^ BYTE_LSB) * 0xFEu + BYTE_LSB;
          a[3] = (a[3] ^ BYTE_LSB) * 0xFEu + BYTE_LSB;
        } else {  // 2 / 1 for a set bit
          a[0] *= 2;
          a[1] *= 2;
        }
        // a k-step: 8 independent products
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const unsigned x = word_of(xb[j], u);
          const unsigned y = x >> (2 * t);
          mma_s8(acc[j], a, y & BYTE_LSB, y & (2 * BYTE_LSB));
          if (JAC) rp[j] += __popc(x);
        }
      }
    }
    if (ch != nchunks - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + at);
      continue;
    }

    // The half tile is done.  Hamming: acc = 2 sum (2q - 1) x = 2 (2 ab -
    // |x|), so d = |q| - acc / 2.  Jaccard: acc = 2 ab.  Flag each of the
    // warp's rows with a valid score that may beat both its own k-th best
    // and the splits' shared bound: an integer test (Hamming) or a
    // multiply that errs toward flagging (Jaccard); only flagged rows form
    // their f32 distances and reach the fold.
    const unsigned char* s_v =
        reinterpret_cast<const unsigned char*>(s_x + BR * sw) + half * HALF;
    // bit 2j + e: column 8j + 2t + e is valid (torch bools are 0 or 1)
    unsigned okm = 0xFFFFu;
    {
      uint4 v = make_uint4(BYTE_LSB, BYTE_LSB, BYTE_LSB, BYTE_LSB);
      if (lane < HALF / 16) v = reinterpret_cast<const uint4*>(s_v)[lane];
      if (!__all_sync(0xffffffffu,
                      (v.x & v.y & v.z & v.w & BYTE_LSB) == BYTE_LSB)) {
        okm = 0;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const unsigned short b =
              *reinterpret_cast<const unsigned short*>(s_v + 8 * j + 2 * t);
          okm |= ((b & 0xFFu) ? 1u : 0u) << (2 * j);
          okm |= ((b >> 8) ? 1u : 0u) << (2 * j + 1);
        }
      }
    }
    __syncwarp();  // the warp is done with the stage
    if (lane == 0) mbar_arrive(empty + at);
    const float thr0 = bd[qr0 * k + k - 1], thr1 = bd[qr1 * k + k - 1];
    int bb[NF][2];  // Jaccard: |x| of columns 8j + 2t, 8j + 2t + 1
    if (JAC) {
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        bb[j][0] = __shfl_sync(0xffffffffu, rp[j], 8 * t);
        bb[j][1] = __shfl_sync(0xffffffffu, rp[j], 8 * t + 4);
      }
    }
    bool hit0 = false, hit1 = false;
    if (!JAC) {
      // d < thr and d <= kth  <=>  acc / 2 > |q| - min(thr, kth + 1), all
      // integers (or +inf)
      const int m0 =
          2 * (aa0 - (int)fminf(fminf(thr0, kth0 + 1.f), 536870912.f));
      const int m1 =
          2 * (aa1 - (int)fminf(fminf(thr1, kth1 + 1.f), 536870912.f));
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (okm >> (2 * j + e)) & 1u;
          hit0 |= ok && acc[j][e] > m0;
          hit1 |= ok && acc[j][2 + e] > m1;
        }
    } else {
      // f32 d <= thr implies the exact d < thr + 2^-23, i.e. ab > c (|q| +
      // |x|) with tau = 1 - thr - 2^-23 and c = tau / (1 + tau); a margin of
      // 1e-5 on tau covers the rounding of c and of the product
      // (>= below, so a list not yet full, c = -1, takes every valid row)
      auto cut = [](float thr) {
        const float tau = 1.f - thr - 1e-5f;
        return thr > 2.f ? -1.f : tau / (1.f + tau);
      };
      const float c0 = cut(fminf(thr0, kth0)), c1 = cut(fminf(thr1, kth1));
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (okm >> (2 * j + e)) & 1u;
          hit0 |= ok && small_float(acc[j][e]) >=
                            c0 * small_float(2 * (aa0 + bb[j][e]));
          hit1 |= ok && small_float(acc[j][2 + e]) >=
                            c1 * small_float(2 * (aa1 + bb[j][e]));
        }
    }
    // rows of the warp flagged by any of their four lanes; ragged queries
    // never are
    const unsigned b0 = __ballot_sync(0xffffffffu, hit0 && q0 + qr0 < nq);
    const unsigned b1 = __ballot_sync(0xffffffffu, hit1 && q0 + qr1 < nq);
    unsigned rows = 0;  // bit r: row wq + r flagged
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rows |= ((b0 >> (4 * r)) & 0xFu ? 1u : 0u) << r;
      rows |= ((b1 >> (4 * r)) & 0xFu ? 1u : 0u) << (r + 8);
    }
    if (rows == 0) continue;  // uniform across the warp
    while (rows) {  // each flagged row: its f32 distances, then the fold
      const int r = __ffs(rows) - 1;
      rows &= rows - 1;
      const int h = r >> 3, qq = wq + r;
      int* qslots = slots + (size_t)(q0 + qq) * k;
      if (g == (r & 7)) {  // the four lanes that hold the row
        const int aa = h ? aa1 : aa0;
        const float kth = h ? kth1 : kth0;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = (h ? acc[j][2 + e] : acc[j][e]) >> 1;
            const float d = JAC ? jaccard(x, aa, bb[j][e]) : (float)(aa - x);
            v[e] = ((okm >> (2 * j + e)) & 1u) && d <= kth ? d
                                                           : CUDART_INF_F;
            // every row is a candidate once: slot hash(id) keeps the
            // least distance of its rows
            if (v[e] < NO_KTH)
              atomicMin(qslots + slot_of(r0 + 8 * j + 2 * t + e, k),
                        __float_as_int(v[e]));
          }
          *reinterpret_cast<float2*>(row_buf + 8 * j + 2 * t) =
              make_float2(v[0], v[1]);
        }
      }
      __syncwarp();
      fold_and_share(row_buf, r0, bd + qq * k, bi + qq * k, k, lane, qslots,
                     shared_kth + (size_t)(q0 + qq) * k);
    }
  }

  // both halves are done: merge each query's two lists by (distance, id)
  __syncthreads();
  for (int qq = tid; qq < BQ; qq += THREADS) {
    const int gq = q0 + qq;
    if (gq >= nq) continue;
    const float* d0 = s_bd + qq * k;
    const float* d1 = s_bd + (BQ + qq) * k;
    const int* i0 = s_bi + qq * k;
    const int* i1 = s_bi + (BQ + qq) * k;
    int a = 0, b = 0;
    for (int o = 0; o < k; ++o) {
      const bool take0 = d0[a] < d1[b] || (d0[a] == d1[b] && i0[a] <= i1[b]);
      const size_t at = ((size_t)split * nq + gq) * k + o;
      part_d[at] = take0 ? d0[a] : d1[b];
      part_i[at] = take0 ? i0[a] : i1[b];
      if (take0) ++a; else ++b;
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

// `pop` (the rows' popcounts) is not read: Hamming needs none and Jaccard
// counts |x| as it unpacks each tile.  It stays in the signature for
// callers that hold it.
extern "C" int pgvt_bit_topk(const int* qs, const int* db, const int* pop,
                             const unsigned char* valid, int nq, int n,
                             int w, int k, int jaccard_metric, int splits,
                             int tiles_per_split, float* part_d, int* part_i,
                             float* out_d, int* out_i, void* stream) {
  (void)pop;
  if (k < 1 || k > TOPK_MAX_K || splits < 1 || splits > TOPK_MAX_SPLITS ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the validity bytes come in 16-byte copies; words too where rows are
  // 16-byte aligned
  if (reinterpret_cast<uintptr_t>(valid) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(qs) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(db) % 16 == 0;
  // as many ring stages as shared memory holds, up to MAX_NS
  const bool q_once = w <= WK;
  const int sw = word_stride((min(WK, w) + 3) & ~3);
  const size_t stage = sizeof(int) * ((q_once ? 0 : BQ * sw) + BR * sw +
                                      BR / 4);
  const size_t fixed = sizeof(int) * (4 * MAX_NS + (q_once ? BQ * sw : 0)) +
                       sizeof(float) * CONSUMERS * HALF +
                       (sizeof(float) + sizeof(int)) * 2 * BQ * k +
                       sizeof(int) * BQ;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if ((size_t)optin < fixed + 2 * stage) return (int)cudaErrorInvalidValue;
  const int ns = (int)std::min((size_t)MAX_NS, ((size_t)optin - fixed) / stage);
  const size_t smem = fixed + ns * stage;
  auto kern = jaccard_metric ? bit_topk_pass1<true> : bit_topk_pass1<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // pass 1 shares a bound on each query's k-th best across its splits in
  // out_d[q, 0], and keeps k slots of candidates in out_i[q, :]; pass 2
  // overwrites both
  err = cudaMemsetAsync(out_d, 0x7F, sizeof(float) * nq * k, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(out_i, 0x7F, sizeof(int) * nq * k, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((nq + BQ - 1) / BQ, splits);
  kern<<<grid1, THREADS, smem, st>>>(qs, db, valid, nq, n, w, k,
                                     tiles_per_split, vec, ns, part_d, part_i,
                                     out_d, out_i);
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
