// K3 — SelectNeighbors (Algorithm 4, hnswutils.c:1062-1163) over a batch of
// candidate pools, one warp a pool.
//
// Replaces the XLA program of pgvector_tpu/index/hnsw_kernels.py:804
// (select_neighbors, its keep/prune fori_loop at :844) under
// select_neighbors_batch (:855), which the JAX package runs inside one
// jitted connect, and the distance block in front of it for dense L2,
// inner product and cosine (_pairwise_dists :931).  The port's plain
// version (ops/select_neighbors.py) is a Python loop over the C columns,
// about nine launches a column over a gathered (T, C, C) block.  Per row,
// given base distances base_d (C,), valid and forced flags, the cap lm and
// either the pairwise block pair_d (C, C) (MODE BLOCK: L1, bit, sparse) or
// the Gram block ip (C, C) with the norms sq (C,) (MODE L2: pair(i, k) =
// (sq_i - 2 ip_ik) + sq_k, each operation rounded, no FMA, clamped at 0
// with NaN kept; MODE NEG_IP: -ip_ik; +inf where either candidate is
// invalid — ops/select_neighbors.form_pairs, the ops of _pairwise_dists):
//   1. big_d = valid ? base_d : +inf; a forced candidate must be valid and
//      finite;
//   2. the candidates in the stable order of big_d (the non-finite ones
//      last, all as +inf: they are never kept);
//   3. the keep loop, closest first: candidate t is kept when it is forced
//      or closer to the base than to every kept candidate, while fewer
//      than lm are kept.  The entries of row order[t] of the block at the
//      kept columns are the set of values the plain version's running
//      column minimum folds; d < their minimum (a NaN anywhere making the
//      minimum NaN, so the test false) holds exactly when no entry is NaN
//      or at most d, one warp vote, so the decisions are the plain
//      version's bit for bit;
//   4. rank = kept ? big_d : (finite ? big_d + BIG : +inf), one rounded
//      f32 add as in the plain version, and the first lm positions by
//      (rank, index), -1 / false where the rank is +inf or past C.
//
// What bounds it on an H100: the block's rows the loop reaches (C x 4
// bytes each, the loop stops at lm kept or at the first non-finite key)
// and the row's flags and outputs; read whole, the block of a backlink
// chunk of the 1M build is 16,384 x 64 x 64 x 4 = 268 MB, 0.080 ms at
// 3.35 TB/s.  Design: one warp a row and up to eight rows a block, each
// warp with a ring of PREFETCH rows of the block in shared memory, filled
// by cp.async in the sorted order ahead of the loop (the order is known
// before the loop starts), so the copies overlap the loop's steps and
// only the rows the loop can reach are read; a few KB a warp at C = 64
// instead of the whole C x C block.  The two sorts are the warp bitonic
// network of warp_sort.cuh.  A row's result depends on its own inputs
// alone, so any split of the rows over launches or devices gives the same
// bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "warp_sort.cuh"

namespace {

using pgvt::order_key;
using pgvt::sort_lanes;

constexpr float BIG = 3.0e38f;  // pruned candidates rank after kept ones
constexpr int WARPS = 8;        // rows (warps) a block, at most
constexpr int PREFETCH = 8;     // rows of the block a warp has in flight
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
enum { BLOCK = 0, L2 = 1, NEG_IP = 2 };  // what pair_d holds

struct SelArgs {
  const float* base_d;
  const float* pair;  // the (C, C) block of each row: distances or ip
  const float* sq;    // L2: the (C,) norms of each row
  const uint8_t* valid;
  const uint8_t* forced;  // may be null
  int* out_pos;
  uint8_t* out_kept;
  int t_rows, c, lm, width, warps;
  bool vec;  // rows of the block 16-byte aligned
};

__host__ __device__ inline size_t a16(size_t n) { return (n + 15) / 16 * 16; }

// shared-memory bytes of one warp: [ring | keys | order | norms | sorted
// keys | sorted norms | kept ids | flags | sort keys and positions (wide
// rows only)], 16-byte aligned
__host__ __device__ inline size_t warp_bytes(int c, int lm, int width) {
  return PREFETCH * a16(4 * (size_t)c) + 5 * a16(4 * (size_t)c) +
         a16(4 * (size_t)lm) + a16((size_t)c) +
         (width > 512 ? 2 * a16(4 * (size_t)width) : 0);
}

constexpr int FORCED = 0x40000000;  // beside an index in the sorted order

// the entry of the block at (i, k) from what the ring holds: MODE BLOCK the
// distance; L2 (sq_i - 2 ip) + sq_k, each operation rounded, clamped at 0
// with NaN kept; NEG_IP -ip
template <int MODE>
__device__ __forceinline__ float entry(float v, float sq_i, float sq_k) {
  if (MODE == L2) {
    v = __fadd_rn(__fsub_rn(sq_i, __fmul_rn(2.f, v)), sq_k);
    return v < 0.f ? 0.f : v;
  }
  return MODE == NEG_IP ? -v : v;
}

// cp.async: 16 bytes (both addresses 16-byte aligned, cached in L2 only)
// or 4; a copy holds no register while in flight
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// close this thread's current group of copies
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one row of the block (c floats) into the ring, each lane its share
__device__ __forceinline__ void fetch_row(float* dst, const float* src,
                                          int c, bool vec, int lane) {
  if (vec) {
    for (int k = lane; k < c / 4; k += 32) cp16(dst + 4 * k, src + 4 * k);
  } else {
    for (int k = lane; k < c; k += 32) cp4(dst + k, src + k);
  }
}

// R: sort lanes a thread (0: wide rows, shared memory); MODE: BLOCK, L2 or
// NEG_IP
template <int R, int MODE>
__global__ void __launch_bounds__(32 * WARPS, 4)
    select_neighbors_kernel(const SelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * a.warps + warp;
  if (row >= (size_t)a.t_rows) return;  // whole warps only: no block barrier
  const int c = a.c, lm = a.lm;
  const size_t rs = a16(4 * (size_t)c) / 4;  // ring stride, floats
  unsigned char* p = smem + warp * warp_bytes(c, lm, a.width);
  float* ring = reinterpret_cast<float*>(p);
  p += PREFETCH * rs * 4;
  float* s_key = reinterpret_cast<float*>(p);  // sort key, then rank
  p += a16(4 * (size_t)c);
  int* s_ord = reinterpret_cast<int*>(p);  // sorted position -> index
  p += a16(4 * (size_t)c);
  float* s_sq = reinterpret_cast<float*>(p);
  p += a16(4 * (size_t)c);
  float* s_sd = reinterpret_cast<float*>(p);  // keys in the sorted order
  p += a16(4 * (size_t)c);
  float* s_ssq = reinterpret_cast<float*>(p);  // norms in the sorted order
  p += a16(4 * (size_t)c);
  int* s_kid = reinterpret_cast<int*>(p);  // kept indices, in keep order
  p += a16(4 * (size_t)lm);
  uint8_t* s_flag = p;  // bit 0: forced (sanitized); 1: kept
  p += a16((size_t)c);
  unsigned* w_key = reinterpret_cast<unsigned*>(p);
  int* w_pos = reinterpret_cast<int*>(p + a16(4 * (size_t)a.width));

  const float* brow = a.base_d + row * c;
  const uint8_t* vrow = a.valid + row * c;
  const float* prow = a.pair + row * (size_t)c * c;

  // 1. keys, flags and norms; the non-finite keys all sort last as +inf
  int fin_n = 0;
  for (int i = lane; i < c; i += 32) {
    const float bd = vrow[i] ? brow[i] : CUDART_INF_F;
    const bool fin = isfinite(bd);
    s_key[i] = fin ? bd : CUDART_INF_F;
    s_flag[i] = (a.forced != nullptr && a.forced[row * c + i] && fin) ? 1 : 0;
    if (MODE == L2) s_sq[i] = a.sq[row * c + i];
    fin_n += fin;
  }
  const int nf = __reduce_add_sync(FULL, fin_n);  // rows the loop may read
  __syncwarp();

  // 2. the stable order of the keys, with each position's key, norm and
  // forced flag beside it
  sort_lanes<R>(
      a.width, lane, w_key, w_pos,
      [&](int i) { return i < c ? order_key(s_key[i]) : 0xffffffffu; },
      [&](int t, unsigned, unsigned, int i) {
        if (t < c) {
          s_ord[t] = i | ((s_flag[i] & 1) ? FORCED : 0);
          s_sd[t] = s_key[i];
          if (MODE == L2) s_ssq[t] = s_sq[i];
        }
      });

  // 3. the keep loop, rows order[t + 1 .. t + PREFETCH] in flight.  Lane j
  // holds the j-th kept index and its norm (the 33rd on in s_kid).  Only
  // valid candidates reach the loop (their keys are finite), so form_pairs'
  // +inf for an invalid pair never applies here.
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nf)
      fetch_row(ring + s * rs, prow + (size_t)(s_ord[s] & ~FORCED) * c, c,
                a.vec, lane);
    cp_commit();
  }
  int count = 0, my_k = 0;
  float my_sq = 0.f;
  for (int t = 0; t < nf && count < lm; ++t) {
    const int o = s_ord[t], i = o & ~FORCED;
    const float d = s_sd[t], sq_i = MODE == L2 ? s_ssq[t] : 0.f;
    cp_wait<PREFETCH - 1>();
    __syncwarp();
    const float* pr = ring + (t % PREFETCH) * rs;
    bool ok = o & FORCED;
    if (!ok) {
      // d < min over the kept entries, a NaN among them failing it: no
      // lane may hold an entry that is NaN or not above d (one vote)
      bool bad = lane < count && !(d < entry<MODE>(pr[my_k], sq_i, my_sq));
      for (int j = lane + 32; j < count; j += 32) {
        const int k = s_kid[j];
        bad |= !(d < entry<MODE>(pr[k], sq_i, MODE == L2 ? s_sq[k] : 0.f));
      }
      ok = !__any_sync(FULL, bad);
    }
    __syncwarp();  // every lane is done with this ring slot
    if (t + PREFETCH < nf)
      fetch_row(ring + (t % PREFETCH) * rs,
                prow + (size_t)(s_ord[t + PREFETCH] & ~FORCED) * c, c,
                a.vec, lane);
    cp_commit();
    if (ok) {
      if (lane == count) {
        my_k = i;
        my_sq = sq_i;
      }
      if (lane == 0) {
        s_kid[count] = i;
        s_flag[i] |= 2;
      }
      ++count;
    }
  }
  cp_wait<0>();  // no copy may land after the warp is gone
  __syncwarp();

  // 4. ranks (over the keys, now free), then the first lm by (rank, index)
  for (int i = lane; i < c; i += 32) {
    const float bd = vrow[i] ? brow[i] : CUDART_INF_F;
    s_key[i] = (s_flag[i] & 2) ? bd
               : isfinite(bd)  ? __fadd_rn(bd, BIG)
                               : CUDART_INF_F;
  }
  __syncwarp();
  int* pos = a.out_pos + row * lm;
  uint8_t* kept = a.out_kept + row * lm;
  sort_lanes<R>(
      a.width, lane, w_key, w_pos,
      [&](int i) { return i < c ? order_key(s_key[i]) : 0xffffffffu; },
      [&](int r, unsigned, unsigned, int i) {
        if (r < lm && r < c) {
          const bool inf = isinf(s_key[i]);
          pos[r] = inf ? -1 : i;
          kept[r] = !inf && (s_flag[i] & 2);
        }
      });
  for (int r = c + lane; r < lm; r += 32) {
    pos[r] = -1;
    kept[r] = 0;
  }
}

template <int R, int MODE>
cudaError_t launch(const SelArgs& a, cudaStream_t st) {
  auto kernel = select_neighbors_kernel<R, MODE>;
  // the dynamic shared-memory cap, set once for each device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t per_warp = warp_bytes(a.c, a.lm, a.width);
  int warps = WARPS;
  while (warps > 1 && per_warp * warps > (size_t)SMEM_MAX) --warps;
  if (per_warp * warps > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  SelArgs b = a;
  b.warps = warps;
  kernel<<<(a.t_rows + warps - 1) / warps, 32 * warps, per_warp * warps,
           st>>>(b);
  return cudaGetLastError();
}

}  // namespace

// base_d (t_rows, c) f32; pair (t_rows, c, c) f32: the pairwise distances
// (mode 0) or the Gram block ip (mode 1: L2, with sq (t_rows, c) f32 the
// norms; mode 2: -ip, inner product and cosine); valid (t_rows, c) bool,
// forced (t_rows, c) bool or null; out_pos (t_rows, lm) int32, out_kept
// (t_rows, lm) bool.  Returns the launch's cudaError_t.
extern "C" int pgvt_select_neighbors(const float* base_d, const float* pair,
                                     const float* sq, int mode,
                                     const void* valid, const void* forced,
                                     int t_rows, int c, int lm, int* out_pos,
                                     void* out_kept, void* stream) {
  if (t_rows < 1 || c < 0 || lm < 1 || mode < BLOCK || mode > NEG_IP ||
      (mode == L2 && sq == nullptr))
    return (int)cudaErrorInvalidValue;
  const int width = pgvt::sort_width(c);
  if (width > 4096) return (int)cudaErrorInvalidValue;
  SelArgs a{base_d, pair, sq, static_cast<const uint8_t*>(valid),
            static_cast<const uint8_t*>(forced), out_pos,
            static_cast<uint8_t*>(out_kept), t_rows, c, lm, width, WARPS,
            c % 4 == 0 && reinterpret_cast<uintptr_t>(pair) % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)pgvt::with_sort_lanes(width, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (mode == L2) return launch<R, L2>(a, st);
    if (mode == NEG_IP) return launch<R, NEG_IP>(a, st);
    return launch<R, BLOCK>(a, st);
  });
}
