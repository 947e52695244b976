// K1 — fused exact top-k scan (L2 / inner product) on Hopper's wgmma, f32
// accuracy by the 3xTF32 split.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_topk.py:_kernel
// (driven by _pallas_scan / exact_topk).  For every query q and live row x
// it forms the ordering score  dbsq[x] - 2 q.x  (dbsq = |x|^2 for L2, 0 for
// inner product, +inf for dead rows) and keeps the k smallest per query,
// ties to the lower row id.  The caller adds |q|^2 (L2) or halves the score
// (IP), as pallas_topk.exact_topk does.
//
// What bounds it on an H100.  Operations: plain TF32 loses recall, so the
// tensor cores run the 3xTF32 split a = hi + lo, hi = tf32(a), lo =
// tf32(a - hi), and q.x is taken as lo.hi + hi.lo + hi.hi (the dropped lo.lo
// is about 2^-22 relative): three TF32 products, 6 Q N D flops, 6.1 TFLOP at
// 8,000 queries x 1M x 128, 12.4 ms at the 495 TFLOP/s that only wgmma
// reaches.  Bytes: a block holds 128 queries and walks its rows once, so
// the rows cross from L2 to the SMs once a 128-query tile (ceil(Q/128) N D
// 4 bytes: 32 GB at 8,000 x 1M x 128, about 6 ms at L2's rate); the blocks
// of one split run side by side over the same rows, so device memory
// serves each row about once a split wave and L2 the rest.  The queries
// are read once a block, split, and stay in shared memory where they fit
// beside 3 stages (D <= 128 at k <= 39); else they stream with the rows,
// chunk by chunk, and cross from L2 once a 64-row tile.  Shared memory's
// own rate binds too: a wgmma reads its B operand from it, 64 bytes a
// cycle at the tensor cores' rate; an A operand from shared memory as well
// would take all 128 (a design with both there, m64n64, measured 5.5 ms
// slower for the shared memory the split took), so A comes from registers.
//
// Design:
//   split_queries: the queries are split once a call into hi and lo, each
//     already rounded to TF32 (wgmma reads a tf32 operand by truncating an
//     f32, so it must be given rounded values), in the layout of wgmma's
//     shared-memory descriptor: K-major 8 x 4 core matrices, no swizzle;
//     dims past D and queries past Q are zero.  It also sets each query's
//     shared bound (below) to +inf.
//   pass 1 (topk_pass1): grid = (query tiles of 128) x (row splits); 384
//     threads in three roles, joined by mbarriers alone:
//     - the producer (warp 8's first thread; setmaxnreg gives warpgroup 2
//       40 registers a thread, the rest of its warps idle) fills a ring of
//       3-6 stages, each one 2-D TMA load of a 64-row x 32-dim chunk of the
//       table (a tensor map with the 128-byte swizzle, so that the fragment
//       loads below hit 32 banks; rows and dims past the table read 0) and,
//       where the queries stream, one bulk copy of their 32-dim chunk, on
//       full / empty mbarriers.  (One bulk copy a row chunk, 128 bytes, ran
//       at 0.47 TB/s: their count, not the bytes, bound it.)
//     - the math warpgroup (warps 0-3; setmaxnreg 232) runs every 64-row
//       tile against the block's 128 queries: per 32-dim chunk it splits
//       its rows' fragments into hi and lo in registers (the A operand),
//       runs 12 wgmma.m64n128k8 TF32 ops (per k8 slice row lo x query hi,
//       row hi x query lo, hi x hi, small terms first; B the split queries
//       through a descriptor) into fresh accumulators, splits the next
//       chunk's fragments while they run, and adds them to the tile's
//       running f32 sums: no accumulator chain is longer than 12 ops
//       (ops/fused_topk.k1_error_bound).  A finished tile's 64 x 128 scores
//       go to a buffer in shared memory for the epilogue warpgroup.  The
//       adds after each chunk's ops leave the tensor cores idle; two
//       64-query halves that alternated, one's sums added while the other's
//       ops ran, made ptxas serialize the wgmma ops (C7514) and ran slower.
//     - the epilogue warpgroup (warps 4-7) folds each tile while the math
//       warpgroup runs the next: each warp owns 32 queries, each lane checks
//       its query's 64 scores (a column of the buffer, conflict-free), and
//       the warp folds the tile into each flagged query's sorted k-list
//       (fold_row, topk_fold.cuh) where a score beats its k-th best and is
//       not above the bound the splits share.  (Checked a query at a time
//       by the whole warp, the fold held the math warpgroup: 15 ms.)  Rows
//       arrive in ascending id order: (distance, id) order without
//       comparing ids.  The shared bound: after a fold, a query's new k-th
//       best is lowered into kth[q] by atomicMin (an order-keeping int key),
//       and the warp reads its queries' bounds a tile ahead: a row scoring
//       above a bound has k rows of some split ahead of it, so it is skipped
//       (without it every split filled its own k-lists from +inf, and the
//       fold cost 9 ms).
//   pass 2 (topk_merge, topk_fold.cuh): one thread per query merges the
//     splits' sorted lists by (distance, id); ids are -1 where the
//     distance is +inf.
// Rows must be 16-byte aligned with D % 4 == 0 (the tensor map); the
// wrapper pads other tables once.  The split count is chosen by the caller
// so that pass 1 fills whole waves of the card's SMs.

#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_fold.cuh"

namespace {

constexpr int BQ = 128;            // queries a block (wgmma's N)
constexpr int BR = 64;             // rows a tile (wgmma's M)
constexpr int DK = 32;             // dims a chunk: four k8 slices, 128 bytes
constexpr int SR = BQ + 8;         // floats a row of the score buffer
constexpr int QCH = 2 * BQ * DK;   // floats of one split query chunk
constexpr int QPART = QCH / 2;     // hi, then lo
constexpr int ROWS_BYTES = BR * DK * 4;
constexpr int MAX_STAGES = 6;
constexpr int THREADS = 384;       // math, epilogue, producer warpgroups
constexpr int MAX_K = TOPK_MAX_K;
constexpr int MAX_SPLITS = TOPK_MAX_SPLITS;
// the queries' descriptor strides: the second k-half of a slice (16 core
// matrices on) and the next 8 queries (one core matrix on), in bytes
constexpr uint32_t LBO = 16 * 128, SBO = 128;

// A step of the ring: its stage, the parity of that stage's current
// phase, its chunk and its tile's first row; next() moves to the next
// step without a division.
struct Cursor {
  int st, ch, r0;
  uint32_t ph;
  __device__ __forceinline__ void next(int nch, int stages) {
    if (++ch == nch) {
      ch = 0;
      r0 += BR;
    }
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

struct Smem {
  size_t stage, q, sc, bd, bi, bar, total;
};

// The block's shared memory from a 1,024-byte aligned base (the swizzle's
// period): the ring, [the resident queries], the score buffer, the k-lists
// and the barriers.
__host__ __device__ inline Smem smem_layout(int nch, int k, int resident,
                                            int stages) {
  Smem s;
  s.stage = ROWS_BYTES + (resident ? 0 : 4 * (size_t)QCH);
  s.q = s.stage * stages;
  s.sc = s.q + (resident ? 4 * (size_t)QCH * nch : 0);
  s.bd = s.sc + 4 * (size_t)BR * SR;
  s.bi = s.bd + 4 * (size_t)BQ * k;
  // full[MAX_STAGES], empty[MAX_STAGES], qfull, sc_full, sc_empty
  s.bar = s.bi + 4 * (size_t)BQ * k;
  s.total = s.bar + 8 * (2 * MAX_STAGES + 3) + 1024;  // and the alignment
  return s;
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// a = hi + lo: hi = tf32(a), lo = tf32(a - hi)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(a - h));
}

// a float's order as a signed int (for atomicMin), and back
constexpr int KEY_INF = 0x7f800000;  // +inf
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// ---- mbarriers, bulk and tensor copies ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// the producer's one arrival of a phase, announcing the bytes it brings
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
}

// bytes from global src to shared dst, completing on mbarrier bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the 64-row x 32-dim box of the tensor map at (dim x, row y) to dst
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(bar) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// a K-major no-swizzle descriptor of the split queries at shared address a
__device__ __forceinline__ uint64_t qdesc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator accesses across the async ops
__device__ __forceinline__ void pin(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A.B: A a 64 x 8 TF32 fragment in registers (a0 (g, t), a1 (g+8,
// t), a2 (g, t+4), a3 (g+8, t+4) of the warp's 16 rows), B 8 x 128 through
// the descriptor; d[4j + e]: row g (+8 for e >= 2), query 8j + 2t + e % 2.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// ---- the kernels -----------------------------------------------------------

// Query q, dim j of the (tiles x 128, nch x 32) padded block -> its hi and
// lo in chunk j / 32 of tile q / 128: [part][slice][k-half][8-query
// group][8 queries][4 dims].  Sets every query's shared bound to +inf.
__global__ void split_queries(const float* __restrict__ qs, int nq, int d,
                              int nch, int qtiles, float* __restrict__ out,
                              int* __restrict__ kth) {
  const size_t width = (size_t)nch * DK;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (size_t)nq) kth[e] = KEY_INF;  // no bound yet
  if (e >= (size_t)qtiles * BQ * width) return;
  const int q = (int)(e / width), j = (int)(e % width);
  const float a = q < nq && j < d ? qs[(size_t)q * d + j] : 0.f;
  const float hi = tf32(a);
  const int ql = q % BQ, jj = j % DK;
  const int o = ((((jj / 8) * 2 + (jj % 8) / 4) * (BQ / 8) + ql / 8) * 8 +
                 ql % 8) * 4 + jj % 4;
  float* chunk = out + ((size_t)(q / BQ) * nch + j / DK) * QCH;
  chunk[o] = hi;
  chunk[QPART + o] = tf32(a - hi);
}

__global__ void __launch_bounds__(THREADS, 1)
topk_pass1(const __grid_constant__ CUtensorMap rows_map,
           const float* __restrict__ qsplit, const float* __restrict__ dbsq,
           int nq, int n, int d, int k, int tiles_per_split, int resident,
           int stages, int* __restrict__ kth, float* __restrict__ part_d,
           int* __restrict__ part_i) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int nch = (d + DK - 1) / DK;
  const Smem L = smem_layout(nch, k, resident, stages);
  const uint32_t ring = smem_addr(smem);  // stage st at ring + st * L.stage
  const uint32_t full = smem_addr(smem + L.bar);  // + 8 a stage
  const uint32_t empty = full + 8 * MAX_STAGES;
  const uint32_t qfull = empty + 8 * MAX_STAGES;
  const uint32_t sc_full = qfull + 8, sc_empty = qfull + 16;
  const uint32_t s_q = smem_addr(smem + L.q);
  float* s_sc = reinterpret_cast<float*>(smem + L.sc);
  float* s_bd = reinterpret_cast<float*>(smem + L.bd);
  int* s_bi = reinterpret_cast<int*>(smem + L.bi);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int row_begin = split * tiles_per_split * BR;
  const int row_end = min(n, row_begin + tiles_per_split * BR);
  const int ntiles = (row_end - row_begin + BR - 1) / BR;
  const int steps = ntiles * nch;
  const float* qtile = qsplit + (size_t)blockIdx.x * nch * QCH;

  for (int e = tid; e < BQ * k; e += THREADS) {
    s_bd[e] = CUDART_INF_F;
    s_bi[e] = -1;
  }
  if (tid < stages) {
    mbar_init(full + 8 * tid, 1);   // the producer's arrival
    mbar_init(empty + 8 * tid, 4);  // one a math warp
  }
  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(sc_full, 4);   // the math warps, a tile's scores written
    mbar_init(sc_empty, 4);  // the epilogue warps, a tile folded
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer: step s (chunk s % nch of row tile s / nch) into
    // stage s % stages, once the math warps have left what it held ----
    // (setmaxnreg moves registers within the block: warpgroup 2 gives the
    // math warpgroup what it takes)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid != 8 * 32) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"(
        reinterpret_cast<uint64_t>(&rows_map)) : "memory");
    if (resident) {
      mbar_arrive_tx(qfull, 4 * QCH * nch);
      for (int c = 0; c < nch; ++c)
        bulk_copy(s_q + 4 * QCH * c, qtile + (size_t)c * QCH, 4 * QCH, qfull);
    }
    Cursor cur{0, 0, row_begin, 0};  // ph: the parity of empty's last phase
    for (int s = 0; s < steps; ++s) {
      const int st = cur.st, ch = cur.ch, r0 = cur.r0;
      if (s >= stages) mbar_wait(empty + 8 * st, cur.ph ^ 1);
      const uint32_t slot = ring + L.stage * st, bar = full + 8 * st;
      mbar_arrive_tx(bar, ROWS_BYTES + (resident ? 0 : 4 * QCH));
      tma_rows(slot, &rows_map, ch * DK, r0, bar);
      if (!resident)
        bulk_copy(slot + ROWS_BYTES, qtile + (size_t)ch * QCH, 4 * QCH, bar);
      cur.next(nch, stages);
    }
  } else if (warp >= 4) {
    // ---- the epilogue warpgroup: warp ew folds queries 32 ew .. + 31 ----
    const int ew = warp - 4;
    const bool live = q0 + 32 * ew + lane < nq;  // lane's query
    int* kth_at = kth + q0 + 32 * ew + lane;
    int nx_bound = live ? __ldcg(kth_at) : KEY_INF;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = row_begin + tile * BR;
      mbar_wait(sc_full, tile & 1);
      // lane's query's shared bound, read a tile ago
      const float gb_lane = key_value(nx_bound);
      if (live) nx_bound = __ldcg(kth_at);
      // each lane checks its query's 64 scores (a column of the buffer)
      // against its k-th best and the shared bound
      const float* col = s_sc + 32 * ew + lane;
      const float thr = s_bd[(32 * ew + lane) * k + k - 1];
      bool hit = false;
#pragma unroll 16
      for (int r = 0; r < BR; ++r) {
        const float v = col[r * SR];
        hit |= v < thr && v <= gb_lane;
      }
      unsigned todo = __ballot_sync(0xffffffffu, hit && live);
      while (todo) {
        // the fold: rows above the shared bound first set to +inf, then
        // the query's new k-th best lowers the bound
        const int qi = __ffs(todo) - 1, q = 32 * ew + qi;
        todo &= todo - 1;
        float* row = s_sc + q;
        const float gb = __shfl_sync(0xffffffffu, gb_lane, qi);
#pragma unroll
        for (int h = 0; h < BR / 32; ++h)
          if (row[(32 * h + lane) * SR] > gb)
            row[(32 * h + lane) * SR] = CUDART_INF_F;
        fold_row<BR / 32, SR>(row, r0, s_bd + q * k, s_bi + q * k, k, lane);
        __syncwarp();
        const float kv = s_bd[q * k + k - 1];
        if (lane == 0 && kv < CUDART_INF_F)
          atomicMin(kth + q0 + q, order_key(kv));
      }
      // the end of the fold: the next tile's scores may overwrite the buffer
      __syncwarp();
      if (lane == 0) mbar_arrive(sc_empty);
    }
    for (int e = lane; e < 32 * k; e += 32) {
      const int qq = 32 * ew + e / k, gq = q0 + qq;
      if (gq < nq) {
        const size_t o = ((size_t)split * nq + gq) * k + e % k;
        part_d[o] = s_bd[32 * ew * k + e];
        part_i[o] = s_bi[32 * ew * k + e];
      }
    }
  } else {
    // ---- the math warpgroup: every tile against the block's queries ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = lane / 4, t = lane % 4;
    const int rl = 16 * warp + g;  // this thread's tile rows: rl, rl + 8
    float acc[64], p[64];
    uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = p[i] = 0.f;
    // dbsq of rows rl and rl + 8: read at a tile's first chunk, taken at
    // its last
    float na = CUDART_INF_F, nb = CUDART_INF_F;
    float nxa = CUDART_INF_F, nxb = CUDART_INF_F;
    int tiles_done = 0;
    if (resident) mbar_wait(qfull, 0);

    // cur: the step whose ops start next; nxt: the step loaded next
    Cursor cur{0, 0, row_begin, 0}, nxt = cur;

    // step nxt's stage: wait for it and split its fragments
    auto load = [&](uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
      const int st = nxt.st;
      if (nxt.ch == 0) {
        const int r0 = nxt.r0;
        nxa = r0 + rl < row_end ? dbsq[r0 + rl] : CUDART_INF_F;
        nxb = r0 + rl + 8 < row_end ? dbsq[r0 + rl + 8] : CUDART_INF_F;
      }
      mbar_wait(full + 8 * st, nxt.ph);
      nxt.next(nch, stages);
      // row r, dim c of the swizzled stage: float r * 32 + ((c / 4) ^
      // (r % 8)) * 4 + c % 4; rows rl and rl + 8 are both g mod 8
      const float* x = reinterpret_cast<const float*>(smem + L.stage * st) +
                       rl * DK + t;
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        const int c0 = ((2 * sl) ^ g) * 4, c1 = ((2 * sl + 1) ^ g) * 4;
        split_tf32(x[c0], ah[sl][0], al[sl][0]);
        split_tf32(x[8 * DK + c0], ah[sl][1], al[sl][1]);
        split_tf32(x[c1], ah[sl][2], al[sl][2]);
        split_tf32(x[8 * DK + c1], ah[sl][3], al[sl][3]);
      }
    };

    // step cur: start its 12 ops on fragments (ah, al), load the next
    // step's into (nh, nl) while they run (if there is one), add the
    // chunk's sums, and after a tile's last chunk hand its scores over
    auto step = [&](bool more, uint32_t(&ah)[4][4], uint32_t(&al)[4][4],
                    uint32_t(&nh)[4][4], uint32_t(&nl)[4][4]) {
      const int st = cur.st, ch = cur.ch;
      cur.next(nch, stages);
      if (ch == nch - 1) {  // the reads have had the tile's other chunks
        na = nxa;
        nb = nxb;
      }
      const uint32_t qc = resident ? s_q + 4 * QCH * ch
                                   : ring + L.stage * st + ROWS_BYTES;
      pin(p);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        const uint64_t bh = qdesc(qc + 4096 * sl);
        const uint64_t bl = qdesc(qc + 4096 * sl + 4 * QPART);
        // small terms first; the first op of a chunk overwrites p
        wgmma_n128(p, al[sl], bh, sl);
        wgmma_n128(p, ah[sl], bl, 1);
        wgmma_n128(p, ah[sl], bh, 1);
      }
      wgmma_commit();
      if (more) load(nh, nl);
      wgmma_wait_all();
      pin(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is read
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = ch == 0 ? p[i] : acc[i] + p[i];
      if (ch != nch - 1) return;

      // the tile's scores to the buffer, a row of 128 queries a tile row,
      // once the epilogue warpgroup has folded the last tile's
      if (tiles_done > 0) mbar_wait(sc_empty, (tiles_done - 1) & 1);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float* at = s_sc + rl * SR + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(at) = make_float2(
            na - 2.f * acc[4 * j], na - 2.f * acc[4 * j + 1]);
        *reinterpret_cast<float2*>(at + 8 * SR) = make_float2(
            nb - 2.f * acc[4 * j + 2], nb - 2.f * acc[4 * j + 3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sc_full);
      ++tiles_done;
    };

    load(h0, l0);
    for (int s = 0; s < steps; s += 2) {
      step(s + 1 < steps, h0, l0, h1, l1);
      if (s + 1 < steps) step(s + 2 < steps, h1, l1, h0, l0);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

extern "C" int pgvt_fused_topk(const float* qs, const float* db,
                               const float* dbsq, int nq, int n, int d, int k,
                               int splits, int tiles_per_split, float* qsplit,
                               int* kth, float* part_d, int* part_i,
                               float* out_d, int* out_i, void* stream) {
  if (k < 1 || k > MAX_K || splits < 1 || splits > MAX_SPLITS || d < 4 ||
      d % 4 || reinterpret_cast<uintptr_t>(db) % 16 ||
      reinterpret_cast<uintptr_t>(qsplit) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int nch = (d + DK - 1) / DK;
  const int qtiles = (nq + BQ - 1) / BQ;
  // the queries stay in shared memory where they fit beside 3 stages
  int resident = 1, stages = 0;
  for (int s = MAX_STAGES; s >= 3 && !stages; --s)
    if (smem_layout(nch, k, 1, s).total <= (size_t)optin) stages = s;
  if (!stages) {
    resident = 0;
    for (int s = 4; s >= 2 && !stages; --s)
      if (smem_layout(nch, k, 0, s).total <= (size_t)optin) stages = s;
  }
  if (!stages) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_layout(nch, k, resident, stages).total;

  // the table as a (n, d) tensor of f32, read in 64-row x 32-dim boxes
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t pitch[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {DK, BR}, unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(db), dims, pitch, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const size_t total = (size_t)qtiles * BQ * nch * DK;
  split_queries<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      qs, nq, d, nch, qtiles, qsplit, kth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      topk_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_pass1<<<dim3(qtiles, splits), THREADS, smem, st>>>(
      map, qsplit, dbsq, nq, n, d, k, tiles_per_split, resident, stages, kth,
      part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(part_d, part_i, nq, k, splits, out_d, out_i,
                                st);
}
