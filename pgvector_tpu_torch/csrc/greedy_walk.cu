// K7 — the greedy ef = 1 descent of the HNSW search over the upper levels,
// every level of it in one launch.
//
// Replaces no Pallas kernel: the JAX package's greedy_descent and
// _greedy_body (pgvector_tpu/index/hnsw_kernels.py:703-740), an XLA
// lax.while_loop over the batch that steps until no query moves.  The
// port's plain version (ops/greedy_walk.py: greedy_walk_plain) is that
// loop in eager torch ops with one host read a step.  Per query, from its
// starting element cur and distance cur_d, for each level from level_hi
// down to level_lo (hnswutils.c:1293-1306, the ef = 1 search):
//   1. the element's m-wide list nbr_up[up_slot[cur], level - 1]; an
//      element with no slot (-1, or past the tables) has no list, and a
//      listed id that is -1 or at or past the value table's rows is empty;
//   2. each listed id's row of the (N, D) f32, bf16 or f16 value table
//      scored against the query in f32 with dense_point_scores' formulas
//      (hop_score.cuh: L2, inner product and cosine as -ip, L1), the empty
//      ones at +inf;
//   3. the first minimum in list order, as torch.argmin takes it (a NaN
//      first, -0 == +0);
//   4. a move to it only if its distance is below cur_d; the level ends at
//      the first step that does not move, or after max_steps steps.
// Only the final cur and cur_d are written.  Each query's walk depends on
// that query alone, so the batched loop's fixpoint (step cap included) is
// each query's own, and a query that stops early simply stops: nothing is
// read back by the host.  The distances are summed in another order than
// torch.sum's, so they agree with the plain version's within f32
// tolerance and the walk's ids apart from ties; the lists, the scored
// ids and the move test are the plain version's exactly.
//
// What bounds it on an H100: latency, not bytes.  A step reads one list
// (m ints) and m rows (D x 4 or 2 bytes); the next step's list waits on
// this step's minimum.  At SIFT-1M's upper levels (8,000 queries, about
// 20 steps each, m = 16, 128-d f32) the bytes come to about 1.3 GB, 0.4
// ms at 3.35 TB/s, much of it from the 50 MB L2, since level 1 holds
// about 62,500 rows.  Design: one warp a query and four queries a block,
// with no block barrier, so many independent walks are in flight on each
// SM; the lane groups of hop_score.cuh's score_rows (K2's and K6's) take
// the live ids, up to 64 row values a lane in flight (all 16 rows of a
// 128-d f32 step at once), and the up_slot of each scored id is read
// beside its row, so after the minimum the next list's address is known:
// two dependent reads a step (the list, then the rows), not three.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hop_score.cuh"
#include "warp_sort.cuh"

namespace {

enum { F32 = 0, BF16 = 1, F16 = 2 };  // the wrapper's dtype codes
constexpr int WARPS = 4;              // queries (warps) a block, at most
constexpr int LANE_VALUES = 64;       // row values a lane has in flight
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

struct WalkArgs {
  const void* rows;
  const int* nbr_up;
  const int* up_slot;
  const void* qs;
  const int* cur_in;
  const float* cur_d_in;
  int* out_cur;
  float* out_d;
  int n_rows, cap, slots, levels, m, q, d, q_type;
  int level_hi, level_lo, max_steps, group, metric, warps;
};

__host__ __device__ inline size_t a16(size_t n) { return (n + 15) / 16 * 16; }

// shared-memory bytes of one warp: [query (f32) | listed ids | their
// slots | distances | the list positions to score], each 16-byte aligned
__host__ __device__ inline size_t warp_bytes(int d, int m) {
  return a16(4 * (size_t)d) + 4 * a16(4 * (size_t)m);
}

// torch.argmin's order as unsigned keys: a NaN first, then ascending with
// -0 == +0 (order_key never gives 0)
__device__ __forceinline__ unsigned min_key(float f) {
  return isnan(f) ? 0u : pgvt::order_key(f);
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
// 16-byte aligned)
template <typename T, int N>
__global__ void __launch_bounds__(32 * WARPS)
    greedy_walk_kernel(const WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * a.warps + warp;
  if (row >= a.q) return;  // whole warps: no block barrier
  const int m = a.m;
  unsigned char* p = smem + warp * warp_bytes(a.d, m);
  float* s_q = reinterpret_cast<float*>(p);
  p += a16(4 * (size_t)a.d);
  int* s_id = reinterpret_cast<int*>(p);
  p += a16(4 * (size_t)m);
  int* s_slot = reinterpret_cast<int*>(p);
  p += a16(4 * (size_t)m);
  float* s_dist = reinterpret_cast<float*>(p);
  int* s_pos = reinterpret_cast<int*>(p + a16(4 * (size_t)m));

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
  int cur = a.cur_in[row];
  float cur_d = a.cur_d_in[row];
  int slot = (cur >= 0 && cur < a.cap) ? __ldg(a.up_slot + cur) : -1;
  __syncwarp();

  const T* rows = static_cast<const T*>(a.rows);
  const int groups = 32 / a.group;
  const int grp = lane / a.group, gl = lane % a.group;
  constexpr int ROWS = LANE_VALUES / (N >= 4 ? N : 4);  // rows in flight
  for (int level = a.level_hi; level >= a.level_lo; --level) {
    for (int step = 0; step < a.max_steps; ++step) {
      // 1. the list, its live ids' positions compacted into s_pos
      const bool has = slot >= 0 && slot < a.slots;
      const int* list =
          a.nbr_up + ((size_t)(has ? slot : 0) * a.levels + level - 1) * m;
      int n = 0;
      for (int c0 = 0; c0 < m; c0 += 32) {
        const int c = c0 + lane;
        const int id = (has && c < m) ? __ldg(list + c) : -1;
        const bool live = id >= 0 && id < a.n_rows;
        if (c < m) {
          s_id[c] = live ? id : -1;
          s_dist[c] = CUDART_INF_F;
        }
        const unsigned b = __ballot_sync(FULL, live);
        if (live) s_pos[n + __popc(b & ((1u << lane) - 1))] = c;
        n += __popc(b);
      }
      __syncwarp();

      // 2. the scores: lane group `grp` takes live ids grp, grp + groups,
      // ...; its first lane reads each one's slot beside the row
      for (int c0 = 0; c0 < n; c0 += groups * ROWS) {
        float acc[ROWS];
        const T* vrow[ROWS];
        bool live[ROWS];
        int pos[ROWS], sl[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int c = c0 + u * groups + grp;
          live[u] = c < n;
          pos[u] = live[u] ? s_pos[c] : 0;
          const int id = live[u] ? s_id[pos[u]] : 0;
          vrow[u] = rows + (size_t)id * a.d;
          sl[u] = (live[u] && gl == 0 && id < a.cap) ? __ldg(a.up_slot + id)
                                                     : -1;
        }
        pgvt::score_rows<T, N, ROWS>(vrow, live, s_q, a.d, a.group, gl,
                                     a.metric, acc);
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
          if (gl == 0 && live[u]) {
            s_dist[pos[u]] = acc[u];
            s_slot[pos[u]] = sl[u];
          }
      }
      __syncwarp();

      // 3. the first minimum, 4. the move test
      unsigned long long best = ~0ull;
      for (int c = lane; c < m; c += 32) {
        const unsigned long long k =
            ((unsigned long long)min_key(s_dist[c]) << 32) | (unsigned)c;
        best = k < best ? k : best;
      }
      const int c = (int)(warp_min(best) & 0xffffffffu);
      const float bd = s_dist[c];
      const bool move = bd < cur_d;
      if (move) {
        cur = s_id[c];
        cur_d = bd;
        slot = s_slot[c];
      }
      __syncwarp();  // every lane has read before the next step writes
      if (!move) break;
    }
  }
  if (lane == 0) {
    a.out_cur[row] = cur;
    a.out_d[row] = cur_d;
  }
}

template <typename T, int N>
cudaError_t launch(const WalkArgs& a, cudaStream_t st) {
  auto kernel = greedy_walk_kernel<T, N>;
  const size_t per_warp = warp_bytes(a.d, a.m);
  int warps = WARPS;
  while (warps > 1 && per_warp * warps > (size_t)SMEM_MAX) --warps;
  if (per_warp * warps > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  if (per_warp * warps > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
  }
  WalkArgs b = a;
  b.warps = warps;
  kernel<<<(a.q + warps - 1) / warps, 32 * warps, per_warp * warps, st>>>(b);
  return cudaGetLastError();
}

}  // namespace

// rows (n_rows, d) of the dtype coded 0 f32, 1 bf16, 2 f16 (dtype); nbr_up
// (slots, levels, m) and up_slot (cap,) int32; qs (q, d) of q_type;
// cur_in (q,) int32 and cur_d_in (q,) f32 the starting elements and their
// distances; levels level_hi down to level_lo (1 <= level_lo <= level_hi
// <= levels), each walked for at most max_steps steps; metric: 0 L2, 1
// inner product (and cosine), 2 L1.  Writes out_cur (q,) int32 and out_d
// (q,) f32, which may be cur_in and cur_d_in themselves.
extern "C" int pgvt_greedy_walk(const void* rows, int n_rows, int dtype,
                                const int* nbr_up, int slots, int levels,
                                int m, const int* up_slot, int cap,
                                const void* qs, int q_type, int q, int d,
                                const int* cur_in, const float* cur_d_in,
                                int level_hi, int level_lo, int max_steps,
                                int metric, int* out_cur, float* out_d,
                                void* stream) {
  if (q < 1 || n_rows < 1 || d < 1 || m < 1 || slots < 1 || cap < 1 ||
      level_lo < 1 || level_hi < level_lo || level_hi > levels ||
      max_steps < 0 || metric < 0 || metric > 2 || dtype < F32 ||
      dtype > F16 || q_type < F32 || q_type > F16)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == F32 ? 4 : 2, n = 16 / esize;
  // 16-byte loads need 16-byte aligned rows
  const bool vec = (d * esize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  WalkArgs a{rows, nbr_up, up_slot, qs, cur_in, cur_d_in, out_cur, out_d,
             n_rows, cap, slots, levels, m, q, d, q_type,
             level_hi, level_lo, max_steps, pgvt::lane_group(vec, n, d),
             metric, WARPS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return vec ? (int)launch<__nv_bfloat16, 8>(a, st)
               : (int)launch<__nv_bfloat16, 1>(a, st);
  if (dtype == F16)
    return vec ? (int)launch<__half, 8>(a, st)
               : (int)launch<__half, 1>(a, st);
  return vec ? (int)launch<float, 4>(a, st) : (int)launch<float, 1>(a, st);
}
