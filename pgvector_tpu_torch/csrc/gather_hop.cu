// K6 — one whole hop of the HNSW beam search over rows gathered by id.
//
// Replaces the XLA program of the row-gather branch of
// pgvector_tpu/index/hnsw_kernels.py:_hop_step (:588; _hop_body :401 with
// the visited set off and no discarded pool: the E-selection :433-456, the
// neighbor lists, the Knuth-keyed dedupe :518-533, the pool membership
// mask, the row scores and _hop_merge :554) for dense rows, which the JAX
// package runs inside its jitted beam loop (the while_loop at :652).  The
// port's plain version (ops/gather_hop.py: gather_hop_plain) is some thirty
// eager ops.  Per query, from the (ef) sorted pool of distances and packed
// ids (id*2 | expanded) and the level's list tables:
//   1. the E-selection: among the unexpanded lanes with an id (the others
//      at +inf), the first E in the order of torch.argmin (E = 1: the first
//      minimum, a NaN first) or of a stable ascending sort (E > 1: NaN
//      last), as E rounds of a warp-wide minimum over (key, position) past
//      the last one taken; done when the first is infinite or worse than
//      the pool's worst lane; a selected lane is expanded and marked when
//      finite, not past the worst and its query not done;
//   2. the expanded elements' lists, read from nbr0 (cap, 2m) at level 0
//      and from nbr_up[up_slot[el], level - 1] (m wide) above it; -1 where
//      there is no list, and for an id at or past the table's rows;
//   3. with E > 1 the candidates in the order of the Knuth key id *
//      2654435761 mod 2^32 (the key of -1 last), a repeated key masked;
//      with E = 1 in adjacency order;
//   4. a candidate already in the pool is masked (+inf, -2), every other
//      one's row of the (N, D) f32, bf16 or f16 value table is read and
//      scored against the query in f32 with dense_point_scores' formulas
//      (hop_score.cuh: L2, inner product and cosine as -ip, L1);
//   5. the pool and the candidates in (distance, position) order, the
//      distance ordered as torch.sort orders it (-0 == +0, NaN after
//      +inf), the first ef written: the pool comes sorted, so only the
//      candidates are sorted and each lane's place in the merged order is
//      counted by binary search (a pool out of order or with a NaN takes
//      the whole sort).
// Then the query's done flag, its hop count (one more, up to and including
// the hop that found it done), and the count of queries not done: each
// block adds its own to a two-int scratch, and the last block to finish
// writes the total and resets the scratch for the next launch.  A query
// already done on entry (done_in) is copied through and counts no hop.
// No (Q, W) list, score or membership block reaches device memory.  The
// distances are summed in another order than torch.sum's, so they agree
// with the plain version's within f32 tolerance, and the ids apart from
// ties; the selection, the lists and the masks are the plain version's
// exactly, and given the same distances so is the merge.
//
// What bounds it on an H100: the bytes it must move, the pool read and
// written, the E lists of each query (and the slots above level 0), the
// query, and one row for each distinct candidate not in the pool (D x 4
// or 2 bytes) — at the 1M build's level-0 hop (Q = 1,024, E = 4, m = 16,
// 128-d f32) about 56 MB, 0.017 ms at 3.35 TB/s.  Design: one warp a
// query and four queries a block, so one query's sorts run while the
// rows of another are in flight, with no block barrier before the last
// count.  The two sorts (the Knuth keys, the scored candidates) are
// bitonic networks over the warp's lanes: up to 512 candidates (16 a
// thread) in registers and shuffles, more through the warp's own shared
// memory.  The membership mask is a scan of the pool's ids (no sort); the
// rows are gathered with 16-byte loads, 64 values a lane in flight (16
// rows of 128-d f32 a warp).  Where a query expands nothing (it is done)
// neither sort runs.  A query's result depends on its own inputs alone.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hop_score.cuh"
#include "warp_sort.cuh"

namespace {

using pgvt::KEY_NAN;
using pgvt::order_key;
using pgvt::sort_lanes;

constexpr unsigned PERM = 2654435761u;     // Knuth's multiplicative hash
constexpr unsigned PERM_INV = 244002641u;  // its inverse mod 2^32
constexpr unsigned KEY_NONE = 0xffffffffu;  // no id below 2^30 maps here
constexpr unsigned KEY_PAD = 0xffffffffu;   // padding lanes, after all
enum { F32 = 0, BF16 = 1, F16 = 2 };        // the wrapper's dtype codes
constexpr int WARPS = 4;     // queries (warps) a block, at most
constexpr int LANE_VALUES = 64;  // row values a lane has in flight
constexpr int CHUNK = 4;     // candidates a lane checks against the pool at once
constexpr int SMEM_MAX = 227 * 1024 - 16;  // beside the static count
constexpr unsigned FULL = 0xffffffffu;

struct HopArgs {
  const float* pool_d;
  const int* pool_p;
  const int* nbr0;
  const int* nbr_up;
  const int* up_slot;
  const void* rows;
  const void* qs;
  float* out_d;
  int* out_p;
  uint8_t* out_done;
  const uint8_t* done_in;  // null: no query done yet
  const int* hops_in;      // null: no hops yet
  int* out_hops;           // null: not kept
  int* work;      // [count, ticket], zero between launches
  int* out_left;  // the queries not done
  int cap, m2, slots, levels, m, level, n_rows, q_type;
  int q, ef, e_sel, lw, w, d, width, group, metric, warps;
  int cw;  // the candidates' sort lanes: sort_width(w)
};

__host__ __device__ inline size_t a16(size_t n) { return (n + 15) / 16 * 16; }

// shared-memory bytes of one warp: [query | distances | packed ids |
// candidate ids | selections (ids, then positions) | sort keys |
// positions], each 16-byte aligned
__host__ __device__ inline size_t warp_bytes(int d, int width, int e_sel) {
  return a16(4 * (size_t)d) + 5 * a16(4 * (size_t)width) +
         a16(8 * (size_t)e_sel);
}

// entries of the sorted keys a[0..n) below k
__device__ __forceinline__ int count_below(const unsigned* a, int n,
                                           unsigned k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// lanes of the (sorted, NaN-free) pool s_d[0..ef) whose key is at most k
__device__ __forceinline__ int count_pool_upto(const float* s_d, int ef,
                                               unsigned k) {
  int lo = 0, hi = ef;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (order_key(s_d[mid]) <= k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// T: value type; N: values per load (16 bytes, or 1 where rows are not
// 16-byte aligned); R: the candidates' sort lanes a thread (0: over 512
// candidates, shared memory)
template <typename T, int N, int R>
__global__ void __launch_bounds__(32 * WARPS)
    gather_hop_kernel(const HopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int blk_left;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * a.warps + warp;
  if (threadIdx.x == 0) blk_left = 0;
  __syncthreads();

  const bool was_done = row < a.q && a.done_in && a.done_in[row];
  if (was_done) {  // copied through
    for (int e = lane; e < a.ef; e += 32) {
      a.out_d[(size_t)row * a.ef + e] = a.pool_d[(size_t)row * a.ef + e];
      a.out_p[(size_t)row * a.ef + e] = a.pool_p[(size_t)row * a.ef + e];
    }
    if (lane == 0) {
      a.out_done[row] = 1;
      if (a.out_hops) a.out_hops[row] = a.hops_in ? a.hops_in[row] : 0;
    }
  } else if (row < a.q) {  // whole warps: no barrier until the count below
    const int ef = a.ef, width = a.width, w = a.w, e_sel = a.e_sel;
    const int cw = a.cw;
    unsigned char* p = smem + warp * warp_bytes(a.d, width, e_sel);
    float* s_q = reinterpret_cast<float*>(p);
    p += a16(4 * (size_t)a.d);
    float* s_d = reinterpret_cast<float*>(p);
    p += a16(4 * (size_t)width);
    int* s_pk = reinterpret_cast<int*>(p);
    p += a16(4 * (size_t)width);
    int* s_c = reinterpret_cast<int*>(p);  // candidate ids, then the list
    p += a16(4 * (size_t)width);          // of lanes to score
    int* s_sel = reinterpret_cast<int*>(p);  // [e_sel] ids, [e_sel] lanes
    p += a16(8 * (size_t)e_sel);
    unsigned* s_key = reinterpret_cast<unsigned*>(p);
    int* s_pos = reinterpret_cast<int*>(p + a16(4 * (size_t)width));

    // the query and the pool: loads issued four at a time
    if (a.q_type == BF16) {
      const auto* q = static_cast<const __nv_bfloat16*>(a.qs) + (size_t)row * a.d;
#pragma unroll 4
      for (int e = lane; e < a.d; e += 32) s_q[e] = __bfloat162float(q[e]);
    } else if (a.q_type == F16) {
      const auto* q = static_cast<const __half*>(a.qs) + (size_t)row * a.d;
#pragma unroll 4
      for (int e = lane; e < a.d; e += 32) s_q[e] = __half2float(q[e]);
    } else {
      const auto* q = static_cast<const float*>(a.qs) + (size_t)row * a.d;
#pragma unroll 4
      for (int e = lane; e < a.d; e += 32) s_q[e] = q[e];
    }
#pragma unroll 4
    for (int e = lane; e < ef; e += 32) {
      s_d[e] = a.pool_d[(size_t)row * ef + e];
      s_pk[e] = a.pool_p[(size_t)row * ef + e];
    }
    __syncwarp();

    // 1. the E-selection: round r takes the least (key, position) past the
    // one round r - 1 took; keys from the pool as it came in
    const float worst = s_d[ef - 1];
    const unsigned nan_key = e_sel == 1 ? 0u : KEY_NAN;
    unsigned long long last = 0;
    bool done = false;
    for (int r = 0; r < e_sel; ++r) {
      unsigned long long best = ~0ull;
      for (int e = lane; e < ef; e += 32) {
        const int pk = s_pk[e];
        const float cd = (pk >= 0 && !(pk & 1)) ? s_d[e] : CUDART_INF_F;
        const unsigned k = isnan(cd) ? nan_key : order_key(cd);
        const unsigned long long kk =
            ((unsigned long long)k << 32) | (unsigned)e;
        if ((r == 0 || kk > last) && kk < best) best = kk;
      }
      last = warp_min(best);
      const int e = (int)(last & 0xffffffffu);
      const int pk = s_pk[e];
      const float cd = (pk >= 0 && !(pk & 1)) ? s_d[e] : CUDART_INF_F;
      if (r == 0) done = isinf(cd) || cd > worst;
      const bool ok = isfinite(cd) && cd <= worst && !done;
      if (lane == 0) {
        s_sel[r] = ok ? pk >> 1 : -1;
        s_sel[e_sel + r] = e;
      }
    }
    __syncwarp();
    for (int r = lane; r < e_sel; r += 32)
      if (s_sel[r] >= 0) s_pk[s_sel[e_sel + r]] |= 1;

    // 2. the candidate ids, list after list
#pragma unroll 4
    for (int c = lane; c < w; c += 32) {
      const int e = c / a.lw, j = c - e * a.lw, el = s_sel[e];
      int id = -1;
      if (el >= 0 && el < a.cap) {
        if (a.level == 0) {
          id = a.nbr0[(size_t)el * a.m2 + j];
        } else {
          const int slot = a.up_slot[el];
          if (slot >= 0 && slot < a.slots)
            id = a.nbr_up[((size_t)slot * a.levels + a.level - 1) * a.m + j];
        }
      }
      s_c[c] = (id >= 0 && id < a.n_rows) ? id : -1;
    }
    __syncwarp();

    // 3. E > 1: the Knuth-keyed order, a repeated key masked (nothing to
    // order where every list is empty)
    bool any = false;
    for (int c = lane; c < w; c += 32) any |= s_c[c] >= 0;
    any = __any_sync(FULL, any);
    if (e_sel > 1 && any)
      sort_lanes<R>(
          cw, lane, s_key, s_pos,
          [&](int e) {
            const int id = e < w ? s_c[e] : -1;
            return id >= 0 ? (unsigned)id * PERM : KEY_NONE;
          },
          [&](int i, unsigned k, unsigned prev, int) {
            if (i < w)
              s_c[i] = ((i > 0 && k == prev) || k == KEY_NONE)
                           ? -1 : (int)(k * PERM_INV);
          });

    // 4. the candidate lanes, masked where empty or already in the pool
    // (CHUNK a lane against one pass over the pool's ids); the padding
    // lanes sort after every other
    for (int c0 = 0; c0 < width - ef; c0 += 32 * CHUNK) {
      int id[CHUNK];
      bool live = false;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int c = c0 + 32 * k + lane;
        id[k] = c < w ? s_c[c] : -1;
        live |= id[k] >= 0;
      }
      if (__any_sync(FULL, live)) {
#pragma unroll 8
        for (int e = 0; e < ef; ++e) {
          const int pid = s_pk[e] >> 1;
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            if (pid == id[k]) id[k] = -1;
        }
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int c = c0 + 32 * k + lane;
        if (c < width - ef) {
          s_pk[ef + c] = id[k] < 0 ? -2 : id[k] * 2;
          s_d[ef + c] = id[k] >= 0 ? 0.f : CUDART_INF_F;  // scored below
        }
      }
    }
    __syncwarp();
    int n = 0;  // the lanes to score, compacted into s_c
    for (int c0 = 0; c0 < w; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < w && s_pk[ef + c] >= 0;
      const unsigned b = __ballot_sync(FULL, live);
      if (live) s_c[n + __popc(b & ((1u << lane) - 1))] = ef + c;
      n += __popc(b);
    }
    __syncwarp();

    // scores: lane group `grp` of `group` lanes takes list entries grp,
    // grp + groups, ...; every lane runs the same trip counts
    const T* rows = static_cast<const T*>(a.rows);
    const int groups = 32 / a.group;
    const int grp = lane / a.group, gl = lane % a.group;
    constexpr int ROWS = LANE_VALUES / (N >= 4 ? N : 4);  // rows in flight
    for (int c0 = 0; c0 < n; c0 += groups * ROWS) {
      float acc[ROWS];
      const T* vrow[ROWS];
      bool live[ROWS];
      int ln[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int c = c0 + u * groups + grp;
        live[u] = c < n;
        ln[u] = live[u] ? s_c[c] : 0;
        const int id = live[u] ? s_pk[ln[u]] >> 1 : 0;
        vrow[u] = rows + (size_t)id * a.d;
      }
      pgvt::score_rows<T, N, ROWS>(vrow, live, s_q, a.d, a.group, gl,
                                   a.metric, acc);
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (gl == 0 && live[u]) s_d[ln[u]] = acc[u];
    }
    __syncwarp();

    // 5. the merge: (distance, position), the first ef written.  The pool
    // comes sorted: then the candidates alone are sorted and each lane's
    // place in the merged order counted (the pool's lanes first among
    // equal keys), or, where nothing was scored, the pool is its own
    // merge.  A pool out of order or with a NaN takes the whole sort.
    float* od = a.out_d + (size_t)row * ef;
    int* op = a.out_p + (size_t)row * ef;
    bool unsorted = false;
    for (int e = lane; e < ef; e += 32) {
      const unsigned k = order_key(s_d[e]);
      unsorted |= k == KEY_NAN || (e + 1 < ef && order_key(s_d[e + 1]) < k);
    }
    if (__any_sync(FULL, unsorted)) {
      sort_lanes<0>(
          width, lane, s_key, s_pos,
          [&](int e) { return e < ef + w ? order_key(s_d[e]) : KEY_PAD; },
          [&](int i, unsigned, unsigned, int pos) {
            if (i < ef) {
              od[i] = s_d[pos];
              op[i] = s_pk[pos];
            }
          });
    } else if (n == 0) {
      for (int e = lane; e < ef; e += 32) {
        od[e] = s_d[e];
        op[e] = s_pk[e];
      }
    } else {
      sort_lanes<R>(
          cw, lane, s_key, s_pos,
          [&](int e) { return e < w ? order_key(s_d[ef + e]) : KEY_PAD; },
          [&](int i, unsigned k, unsigned, int pos) {
            s_key[i] = k;
            s_pos[i] = pos;
          });
      for (int e = lane; e < ef; e += 32) {
        const int r = e + count_below(s_key, cw, order_key(s_d[e]));
        if (r < ef) {
          od[r] = s_d[e];
          op[r] = s_pk[e];
        }
      }
      for (int j = lane; j < min(w, ef); j += 32) {
        const int r = j + count_pool_upto(s_d, ef, s_key[j]);
        if (r < ef) {
          od[r] = s_d[ef + s_pos[j]];
          op[r] = s_pk[ef + s_pos[j]];
        }
      }
    }
    if (lane == 0) {
      a.out_done[row] = done;
      if (a.out_hops) a.out_hops[row] = (a.hops_in ? a.hops_in[row] : 0) + 1;
      if (!done) atomicAdd(&blk_left, 1);
    }
  }

  // the count of queries not done: the last block to add its own writes
  // the total and leaves the scratch at zero for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    if (blk_left) atomicAdd(a.work, blk_left);
    __threadfence();
    const unsigned t = atomicAdd(reinterpret_cast<unsigned*>(a.work + 1), 1u);
    if (t == gridDim.x - 1) {
      __threadfence();
      *a.out_left = atomicExch(a.work, 0);
      atomicExch(a.work + 1, 0);
    }
  }
}

template <typename T, int N, int R>
cudaError_t launch(const HopArgs& a, cudaStream_t st) {
  auto kernel = gather_hop_kernel<T, N, R>;
  // the dynamic shared-memory cap, set once for each device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t per_warp = warp_bytes(a.d, a.width, a.e_sel);
  int warps = WARPS;
  while (warps > 1 && per_warp * warps > (size_t)SMEM_MAX) --warps;
  if (per_warp * warps > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  HopArgs b = a;
  b.warps = warps;
  kernel<<<(a.q + warps - 1) / warps, 32 * warps, per_warp * warps, st>>>(b);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t with_width(const HopArgs& a, cudaStream_t st) {
  return pgvt::with_sort_lanes(a.cw, [&](auto r) {
    return launch<T, N, decltype(r)::value>(a, st);
  });
}

}  // namespace

// pool_d (q, ef) f32, pool_p (q, ef) int32 packed ids (id*2 | expanded);
// nbr0 (cap, m2), nbr_up (slots, levels, m) and up_slot (cap,) int32;
// rows (n_rows, d) and qs (q, d) of the dtypes coded 0 f32, 1 bf16, 2 f16
// (dtype, q_type); e_sel <= ef the lanes expanded; metric: 0 L2, 1 inner
// product (and cosine), 2 L1.  done_in (q,) uint8 and hops_in (q,) int32:
// the previous hop's (null: none done, no hops).  Writes the new (q, ef)
// pool, done (q,) uint8, out_hops (q,) int32 (null: not kept; they may be
// done_in / hops_in themselves) and the count of queries not done
// (out_left, one int); work is two ints, zero before the first launch on
// a stream, and left at zero.
extern "C" int pgvt_gather_hop(const float* pool_d, const int* pool_p,
                               const int* nbr0, int cap, int m2,
                               const int* nbr_up, const int* up_slot,
                               int slots, int levels, int m, int level,
                               const void* rows, int n_rows, const void* qs,
                               int q, int ef, int e_sel, int d, int dtype,
                               int q_type, int metric, float* out_d,
                               int* out_p, void* out_done,
                               const void* done_in, const int* hops_in,
                               int* out_hops, int* work, int* out_left,
                               void* stream) {
  const int lw = level == 0 ? m2 : m;
  if (q < 1 || n_rows < 1 || ef < 1 || e_sel < 1 || e_sel > ef ||
      cap < 1 || m2 < 1 || d < 1 || level < 0 || level > levels ||
      (level > 0 && m < 1) || metric < 0 || metric > 2 || dtype < F32 ||
      dtype > F16 || q_type < F32 || q_type > F16)
    return (int)cudaErrorInvalidValue;
  const int w = e_sel * lw;
  const int width = pgvt::merge_width(ef, w);
  if (width == 0) return (int)cudaErrorInvalidValue;
  const int esize = dtype == F32 ? 4 : 2, n = 16 / esize;
  // 16-byte loads need 16-byte aligned rows
  const bool vec = (d * esize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  HopArgs a{pool_d, pool_p, nbr0, nbr_up, up_slot, rows, qs, out_d, out_p,
            static_cast<uint8_t*>(out_done),
            static_cast<const uint8_t*>(done_in), hops_in, out_hops, work,
            out_left,
            cap, m2, slots, levels, m, level, n_rows, q_type,
            q, ef, e_sel, lw, w, d, width, pgvt::lane_group(vec, n, d),
            metric, WARPS, pgvt::sort_width(w)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return vec ? (int)with_width<__nv_bfloat16, 8>(a, st)
               : (int)with_width<__nv_bfloat16, 1>(a, st);
  if (dtype == F16)
    return vec ? (int)with_width<__half, 8>(a, st)
               : (int)with_width<__half, 1>(a, st);
  return vec ? (int)with_width<float, 4>(a, st)
             : (int)with_width<float, 1>(a, st);
}
