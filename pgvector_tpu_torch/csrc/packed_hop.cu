// K2 — one whole hop of the packed HNSW layer-0 beam search.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_hop.py:98-164
// (_tail_kernel and hop_tail) together with the XLA program around it on
// the packed path, pgvector_tpu/index/hnsw_kernels.py:401-501 (_hop_body:
// the E-selection :433-456, the neighbor lists, the slab gather and
// dense_point_scores or _int8_point_scores :464-485, which XLA fused on
// the TPU), which the JAX package runs inside its jitted beam loop.  Per
// query, from the (ef) sorted pool of distances and packed ids (id*2 |
// expanded):
//   1. the E-selection: among the unexpanded lanes with an id (the others
//      at +inf), the first E in the order of torch.argmin (E = 1: the first
//      minimum, a NaN first) or of a stable ascending sort (E > 1: NaN
//      last), as E rounds of a warp-wide minimum over (key, position) past
//      the last one taken (gather_hop.cu's rounds); done when the first is
//      infinite or worse than the pool's worst lane; a selected lane is
//      expanded and marked when finite, not past the worst and its query
//      not done;
//   2. the candidates nbr0[s] of each expanded element s, selection-major
//      in adjacency order (-1 where s is -1 or a list slot is empty);
//   3. the reference tail's dedupe: a candidate already in the pool is
//      masked, so the pool's copy and its expanded flag survive, and so is
//      one whose id came at an earlier position of the hop: a hash set of
//      ids in shared memory takes the pool's ids, then the candidates 32
//      at a time in order, equal ids within the 32 settled by
//      __match_any_sync (no sort by id, no scan of the pool);
//   4. every other candidate scored against the query in f32 from the slab
//      nbr_vals[s], a contiguous (2m, D) block of f32, bf16 or int8 values:
//      dense_point_scores' L2, inner product (cosine stores normalized
//      values and orders by -ip too) and L1 (hop_score.cuh), or the int8
//      tier's exact int32 dot and f32 close;
//   5. the merge in the reference tail's order: lanes that are empty, at
//      +-inf or at 3e38 and beyond (its BIG) sort as empty, NaN after them,
//      the rest by (distance, position), -0 == +0; the first ef written,
//      +inf / -2 in the empty ones.  The pool comes sorted, so only the
//      candidates that can reach the first ef (with the pool full, those
//      before its worst lane: mostly a few) are sorted, in registers, and
//      each lane's place in the merged order is counted by binary search
//      (warp_sort.cuh, as K6); a pool out of order or a NaN anywhere takes
//      the whole sort;
//   6. the query's done flag, its hop count (one more, up to and including
//      the hop that found it done) and the count of queries not done: each
//      block adds its own to a two-int scratch, and the last block to
//      finish writes the total and resets the scratch for the next launch.
// A query already done on entry (done_in) is copied through: no
// selection, no loads, no sort, no hop counted.  Its result depends on its
// own inputs alone.
//
// What bounds it on an H100: the bytes it must move — the pool read and
// written, the E lists and the query, and above all the slabs, Q x E x 2m
// x D x 2 B in bf16 (524 MB at Q = 8,000, E = 8, m = 16, D = 128: 0.16 ms
// at 3.35 TB/s).  Each slab is one contiguous block (8 KB there, 61 KB at
// 960-d bf16), the shape a TMA bulk copy moves best.  Design: one warp a
// query, so one query's sorts run while the slabs of others are in
// flight.  As soon as the selection is known, one lane issues
// cp.async.bulk copies of the slabs, in pieces of whole rows (2 KB, or 4
// rows where rows are wider), into a ring of two pieces in the warp's
// shared memory, each completing on its own mbarrier; the warp dedupes
// while the first two are in flight, then scores the piece that has
// landed (lane groups, 16-byte shared-memory loads) while the next is in
// flight, and refills the slot it has read.  What holds the kernel back
// is latency: each warp's work is a chain (selection, lists, dedupe, each
// piece's wait and scores, merge), so the design keeps a warp's shared
// memory small (about 10 KB at ef 40, 128-d: the merge's buffers reuse
// the idle ring) and picks the warps a block that leave the most warps on
// an SM, some 20.  A slab of more than 16 KB (960-d: 491 KB a query) is
// one warp's chain too long: there a block of WIDE_QW warps takes one
// query, the first warp selecting, deduping and merging, all of them
// copying and scoring its pieces (piece p by warp p % WIDE_QW, one slot
// each), their registers capped so that as many blocks fit an SM as its
// shared memory admits.  Measured on an H100 (PERF.md): at 128-d
// deeper rings and larger pieces cost more in warps than they gave in
// bytes in flight; at 960-d (chip_smoke.py's phase 9 hop) the wide
// layout takes a bf16 hop from 2.19 to 1.43 ms, still above the
// block-a-query kernel it replaced (1.38 ms with 8 warps a query and no
// ring), because the kernel's registers (its sorts keep lanes in
// registers) and the ring leave some 20 warps an SM.
// Slabs that are not 16-byte aligned are read as single values from
// device memory (counted apart: the entry point reports the path).

#include <cuda_bf16.h>
#include <stdint.h>

#include "hop_score.cuh"
#include "warp_sort.cuh"

namespace {

using pgvt::KEY_NAN;
using pgvt::order_key;
using pgvt::sort_lanes;
using pgvt::L1;
using pgvt::L2;
using pgvt::IP;
using pgvt::UNROLL;

enum { F32 = 0, BF16 = 1, INT8 = 2 };  // the wrapper's slab codes
// the scoring paths: the bulk-copy ring, single values from device memory
// (rows not 16-byte aligned)
enum { RING_PATH = 0, SCALAR_PATH = 1 };
constexpr int WARPS = 4;        // queries a block, at most, a warp each
constexpr int RING = 2;         // slab pieces in flight a warp, a warp a query
constexpr int SLOT_MAX = 2048;  // bytes of a ring slot, at 4 rows or more
// A slab of more bytes than WIDE_SLAB is read by WIDE_QW warps of its query,
// a block, each with WIDE_RING slots.  Their registers are capped so that
// as many blocks fit an SM as its shared memory holds at 960 dims (5 for
// f32 / bf16 slabs, 8 and more for int8)
constexpr int WIDE_SLAB = 16384;
constexpr int WIDE_QW = 4;
constexpr int WIDE_RING = 1;
constexpr int WIDE_BLOCKS = 5;
constexpr int WIDE_BLOCKS_INT8 = 8;

// ring slots a warp, for qw warps a query
__host__ __device__ constexpr int ring_of(int qw) {
  return qw > 1 ? WIDE_RING : RING;
}
constexpr unsigned PERM = 2654435761u;  // Knuth's multiplicative hash
constexpr int SMEM_MAX = 227 * 1024 - 128;  // beside the static count,
                                            // aligned as the ring
constexpr unsigned FULL = 0xffffffffu;
// a lane the tail emits empty: no id, +-inf or at BIG and past; after
// every distance below BIG, before NaN
constexpr unsigned KEY_EMPTY = 0xfffffffdu;
constexpr unsigned KEY_PAD = 0xffffffffu;  // padding lanes, after all
constexpr unsigned SLOT_FREE = 0xffffffffu;  // an empty hash slot
constexpr int SMALL_SORT = 64;  // the merge's sort in 2 lanes a thread

struct HopArgs {
  const float* pool_d;
  const int* pool_p;
  const int* nbr0;
  const void* vals;
  const float* qs;
  const int8_t* qc;  // the int8 slab's query side (int8_query)
  const float* sq;
  const float* q2;
  const float* pnorm2;
  const float* scale;
  const uint8_t* done_in;  // null: no query done yet
  const int* hops_in;      // null: no hops yet
  float* out_d;
  int* out_p;
  uint8_t* out_done;
  int* out_hops;
  int* work;      // [count, ticket], zero between launches
  int* out_left;  // the queries not done
  int cap, q, ef, e_sel, m2, d, metric;
  int qw;     // warps a query
  int qpb;    // queries a block
  int w;      // e_sel * m2 candidates
  int width;  // merge_width(ef, w): the whole sort's lanes
  int cw;     // sort_width(w): the candidates' sort lanes
  int group;  // lanes a candidate row
  int ts;     // the dedupe's hash slots: a power of two >= 1.5 (ef + w)
  int row_bytes, rpp, pieces, slot_bytes;  // the ring: rows a piece,
                                           // pieces a slab, slot bytes
};

__host__ __device__ inline size_t a16(size_t n) { return (n + 15) / 16 * 16; }

// One query's shared memory: [ring slots (ring_of(qw) a warp) | mbarriers
// | query | distances | packed ids | candidate ids | selections and counts
// | hash table], each 16-byte aligned (the ring first, 128-byte aligned
// with the query's base).  The merge's sort keys and positions take the
// ring, idle by then, where it holds them, else a region of their own
// after the table.
struct Layout {
  size_t ring, mbar, q, dist, pk, cand, sel, tab, sort, total;
};

__host__ __device__ inline Layout layout(const HopArgs& a, int slab,
                                         bool ring) {
  Layout l;
  size_t o = 0;
  l.ring = o;
  const size_t slots = (size_t)ring_of(a.qw) * a.qw;
  o += ring ? slots * a.slot_bytes : 0;
  l.mbar = o;
  o += ring ? a16(8 * slots) : 0;
  l.q = o;
  if (slab == INT8)  // qc, then for L1 the query and the scale in f32
    o += a16(a.d) + (a.metric == L1 ? 2 * a16(4 * (size_t)a.d) : 0);
  else
    o += a16(4 * (size_t)a.d);
  l.dist = o;
  o += a16(4 * (size_t)(a.ef + a.w));
  l.pk = o;
  o += a16(4 * (size_t)(a.ef + a.w));
  l.cand = o;
  o += a16(4 * (size_t)a.w);
  l.sel = o;
  o += a16(12 * (size_t)a.e_sel + 8);  // ids, lanes, live rounds; 2 counts
  l.tab = o;
  o += 4 * (size_t)a.ts;
  const size_t sort = 8 * (size_t)a.width;  // keys, then positions
  l.sort = ring && sort <= slots * a.slot_bytes ? l.ring : o;
  o += l.sort == o ? sort : 0;
  l.total = (o + 127) / 128 * 128;
  return l;
}

// ---- the bulk copies and their mbarriers --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// generic-proxy reads of a slot before the async proxy writes it again
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// bytes from global src to shared dst, completing on mbarrier bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
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

// ---- keys and counts -----------------------------------------------------

// a lane's key in the reference tail's order (-0 == +0)
__device__ __forceinline__ unsigned lane_key(float d, int pk) {
  if (isnan(d)) return KEY_NAN;
  if (pk < 0 || isinf(d) || d >= pgvt::BIG) return KEY_EMPTY;
  return order_key(d);
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

// lanes of the (sorted, NaN-free) pool [0..n) whose key is at most k
__device__ __forceinline__ int count_pool_upto(const float* s_d,
                                               const int* s_pk, int n,
                                               unsigned k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lane_key(s_d[mid], s_pk[mid]) <= k) lo = mid + 1; else hi = mid;
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

// the value of byte b (0-3) of w as a signed int8
__device__ __forceinline__ int sbyte(int w, int b) {
  return (w << (24 - 8 * b)) >> 24;
}

// The int8 tier's scores of UNROLL rows: the exact int32 dot of each row
// with the quantized query s_qc (16-byte loads, N = 16, or single bytes),
// or for L1 sum |q - float(x) * scale| with the query and scale in f32;
// on return every lane of the group holds the sums.
template <int N>
__device__ __forceinline__ void score_int8(const int8_t* (&row)[UNROLL],
                                           bool (&live)[UNROLL],
                                           const int8_t* s_qc,
                                           const float* s_q,
                                           const float* s_s, int d,
                                           int group, int gl, int metric,
                                           int (&acc)[UNROLL],
                                           float (&l1)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    acc[u] = 0;
    l1[u] = 0.f;
  }
  for (int e0 = gl * N; e0 < d; e0 += group * N) {
    int x[UNROLL][N / 4 > 0 ? N / 4 : 1];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if constexpr (N == 16) {
        const int4 v = live[u] ? *reinterpret_cast<const int4*>(row[u] + e0)
                               : make_int4(0, 0, 0, 0);
        x[u][0] = v.x; x[u][1] = v.y; x[u][2] = v.z; x[u][3] = v.w;
      } else {
        x[u][0] = live[u] ? (int)row[u][e0] : 0;
      }
    }
    if (metric != L1) {
      if constexpr (N == 16) {
        const int4 qv = *reinterpret_cast<const int4*>(s_qc + e0);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          acc[u] = __dp4a(x[u][0], qv.x, acc[u]);
          acc[u] = __dp4a(x[u][1], qv.y, acc[u]);
          acc[u] = __dp4a(x[u][2], qv.z, acc[u]);
          acc[u] = __dp4a(x[u][3], qv.w, acc[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[u] += x[u][0] * (int)s_qc[e0];
      }
    } else {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int xi = N == 16 ? sbyte(x[u][i / 4], i % 4) : x[u][0];
          const float dq = __fmul_rn((float)xi, s_s[e0 + i]);
          l1[u] = __fadd_rn(l1[u], fabsf(__fsub_rn(s_q[e0 + i], dq)));
        }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    for (int off = group / 2; off > 0; off >>= 1) {
      acc[u] += __shfl_xor_sync(FULL, acc[u], off);
      l1[u] = __fadd_rn(l1[u], __shfl_xor_sync(FULL, l1[u], off));
    }
}

// The query's shared-memory side: f32 (s_q) for f32 / bf16 slabs; for
// int8 the quantized query (s_qc) and, for L1, the query and scale.
struct Query {
  const float* q;
  const int8_t* qc;
  const float* s;
  float sq, q2;
};

// Score U candidate rows (row[u] where live[u]; U = UNROLL for int8) and
// store each distance at lane ln[u] of s_d.  T: the slab type; PATH: rows
// in shared memory (16-byte loads), or in device memory (16-byte loads or
// single values).
template <typename T, int PATH, int U>
__device__ __forceinline__ void score_lanes(const HopArgs& a,
                                            const T* (&row)[U],
                                            bool (&live)[U],
                                            const int (&ln)[U],
                                            const Query& qy, float* s_d,
                                            const int* s_pk, int gl) {
  if constexpr (std::is_same_v<T, int8_t>) {
    int acc[UNROLL];
    float l1[UNROLL];
    score_int8<PATH == SCALAR_PATH ? 1 : 16>(row, live, qy.qc, qy.q, qy.s,
                                             a.d, a.group, gl, a.metric,
                                             acc, l1);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (gl == 0 && live[u]) {
        // the reference's order, each operation rounded explicitly
        const float t = __fmul_rn(__int2float_rn(acc[u]), qy.sq);
        float dv;
        if (a.metric == L2)
          dv = __fadd_rn(__fsub_rn(qy.q2, __fmul_rn(2.f, t)),
                         a.pnorm2[s_pk[ln[u]] >> 1]);
        else if (a.metric == IP)
          dv = -t;
        else
          dv = l1[u];
        s_d[ln[u]] = dv;
      }
  } else {
    constexpr int N = PATH == SCALAR_PATH ? 1 : 16 / (int)sizeof(T);
    float acc[U];
    pgvt::score_rows<T, N, U, PATH == RING_PATH>(row, live, qy.q, a.d,
                                                 a.group, gl, a.metric, acc);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (gl == 0 && live[u]) s_d[ln[u]] = acc[u];
  }
}

// T: slab type; PATH: how the slabs are read (the bulk-copy ring or
// single values from device memory); QW: warps a query (1, or WIDE_QW, a
// block).  The first warp of a query (sub 0) selects, dedupes and merges;
// all of them copy and score the slab pieces, piece p by warp p % QW into
// its own R slots.
template <typename T, int PATH, int QW>
__global__ void __launch_bounds__(
    32 * (QW > 1 ? QW : WARPS),
    QW > 1 ? (std::is_same_v<T, int8_t> ? WIDE_BLOCKS_INT8 : WIDE_BLOCKS) : 1)
    packed_hop_kernel(const HopArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int blk_left;
  constexpr int SLAB = std::is_same_v<T, int8_t> ? INT8 : F32;
  constexpr int R = ring_of(QW), qw = QW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = warp % qw, qb = warp / qw;
  const int row = blockIdx.x * a.qpb + qb;
  if (threadIdx.x == 0) blk_left = 0;
  __syncthreads();

  if (row < a.q) {  // whole queries: the whole block where qw > 1
    const int ef = a.ef, w = a.w, e_sel = a.e_sel, m2 = a.m2, cw = a.cw;
    constexpr bool RINGED = PATH == RING_PATH;
    // the query's warps meet: a warp, or a block of one query (a barrier
    // id chosen at run time would hold every named barrier of the block
    // and fewer blocks would fit on an SM)
    auto group_sync = [&]() {
      if constexpr (QW == 1)
        __syncwarp();
      else
        __syncthreads();
    };
    const Layout L = layout(a, SLAB, RINGED);
    unsigned char* base = smem + qb * L.total;
    unsigned char* ring = base + L.ring;
    uint64_t* mbar = reinterpret_cast<uint64_t*>(base + L.mbar);
    float* s_d = reinterpret_cast<float*>(base + L.dist);
    int* s_pk = reinterpret_cast<int*>(base + L.pk);
    int* s_c = reinterpret_cast<int*>(base + L.cand);  // candidate ids, then
                                                       // the lanes to score
    int* s_sel = reinterpret_cast<int*>(base + L.sel);  // [e_sel] ids,
    int* s_lane = s_sel + e_sel;                        // their lanes,
    int* s_live = s_sel + 2 * e_sel;                    // live rounds,
    int* s_count = s_sel + 3 * e_sel;  // [live rounds, lanes to score]
    unsigned* s_tab = reinterpret_cast<unsigned*>(base + L.tab);
    unsigned* s_key = reinterpret_cast<unsigned*>(base + L.sort);
    int* s_pos = reinterpret_cast<int*>(base + L.sort + 4 * (size_t)a.width);
    float* od = a.out_d + (size_t)row * ef;
    int* op = a.out_p + (size_t)row * ef;
    const int hops0 = a.hops_in ? a.hops_in[row] : 0;

    if (a.done_in && a.done_in[row]) {  // done: copied through
      for (int e = lane; e < ef && sub == 0; e += 32) {
        od[e] = a.pool_d[(size_t)row * ef + e];
        op[e] = a.pool_p[(size_t)row * ef + e];
      }
      if (sub == 0 && lane == 0) {
        a.out_done[row] = 1;
        if (a.out_hops) a.out_hops[row] = hops0;
      }
    } else {
      if (RINGED && lane == 0) {  // each warp's own slots
        for (int i = 0; i < R; ++i) mbar_init(smem_addr(mbar + sub * R + i));
        fence_mbar_init();
      }
      bool done = false;
      if (sub == 0) {
#pragma unroll 4
        for (int e = lane; e < ef; e += 32) {
          s_d[e] = a.pool_d[(size_t)row * ef + e];
          s_pk[e] = a.pool_p[(size_t)row * ef + e];
        }
        __syncwarp();

        // 1. the E-selection: round r takes the least (key, position) past
        // the one round r - 1 took; keys from the pool as it came in
        const float worst = s_d[ef - 1];
        const unsigned nan_key = e_sel == 1 ? 0u : KEY_NAN;
        unsigned long long last = 0;
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
            s_lane[r] = e;
          }
        }
        __syncwarp();
        int live_n = 0;  // the rounds that expand a listed element, in order
        for (int r0 = 0; r0 < e_sel; r0 += 32) {
          const int r = r0 + lane;
          const int el = r < e_sel ? s_sel[r] : -1;
          if (el >= 0) s_pk[s_lane[r]] |= 1;
          const bool live = el >= 0 && el < a.cap;
          const unsigned b = __ballot_sync(FULL, live);
          if (live) s_live[live_n + __popc(b & ((1u << lane) - 1))] = r;
          live_n += __popc(b);
        }
        if (lane == 0) s_count[0] = live_n;
      }
      group_sync();
      const int n_live = s_count[0];

      // the slabs' first pieces leave now, while the first warp dedupes:
      // piece p goes to warp p % qw, slot (p / qw) % R of its own
      const int np = n_live * a.pieces;
      auto issue = [&](int p) {
        const int k = p / a.pieces, j = p - k * a.pieces;
        const int r0 = j * a.rpp, nr = min(m2 - r0, a.rpp);
        const size_t s = (size_t)s_sel[s_live[k]];
        const unsigned char* src = static_cast<const unsigned char*>(a.vals) +
                                   (s * m2 + r0) * (size_t)a.row_bytes;
        const int slot = (p % qw) * R + (p / qw) % R;
        bulk_copy(smem_addr(ring + (size_t)slot * a.slot_bytes), src,
                  (uint32_t)(nr * a.row_bytes), smem_addr(mbar + slot));
      };
      if (RINGED && lane == 0)
        for (int p = sub; p < min(np, R * qw); p += qw) issue(p);

      // the query, its values shared out over the query's warps
      const int qt = 32 * qw, qi = 32 * sub + lane;
      Query qy{};
      if constexpr (SLAB == INT8) {
        int8_t* s_qc = reinterpret_cast<int8_t*>(base + L.q);
        const int dpad = (int)a16(a.d);
        for (int e = qi; e < dpad; e += qt)
          s_qc[e] = e < a.d ? a.qc[(size_t)row * a.d + e] : 0;
        float* s_q = reinterpret_cast<float*>(base + L.q + dpad);
        float* s_s = s_q + a16(4 * (size_t)a.d) / 4;
        if (a.metric == L1)
          for (int e = qi; e < a.d; e += qt) {
            s_q[e] = a.qs[(size_t)row * a.d + e];
            s_s[e] = a.scale[e];
          }
        qy = Query{s_q, s_qc, s_s, a.sq[row], a.q2[row]};
      } else {
        float* s_q = reinterpret_cast<float*>(base + L.q);
#pragma unroll 4
        for (int e = qi; e < a.d; e += qt)
          s_q[e] = a.qs[(size_t)row * a.d + e];
        qy.q = s_q;
      }

      if (sub == 0) {
        // 2. the candidate ids, list after list
#pragma unroll 4
        for (int c = lane; c < w; c += 32) {
          const int el = s_sel[c / m2];
          const int id =
              el >= 0 && el < a.cap ? a.nbr0[(size_t)el * m2 + c % m2] : -1;
          s_c[c] = id >= 0 ? id : -1;
        }
        __syncwarp();

        // 3. the dedupe: the pool's ids go into a hash set of ids, then the
        // candidates, 32 at a time in order; a candidate whose id the set
        // already holds is in the pool or came earlier in the hop, and of
        // equal ids in one round the lowest lane is first
        if (n_live > 0) {
          const int mask = a.ts - 1, shift = 33 - __ffs(a.ts);
          auto insert = [&](int id) {  // whether the set held id
            for (int h = ((unsigned)id * PERM) >> shift;;
                 h = (h + 1) & mask) {
              const unsigned old = atomicCAS(&s_tab[h], SLOT_FREE,
                                             (unsigned)id);
              if (old == SLOT_FREE) return false;
              if (old == (unsigned)id) return true;
            }
          };
          for (int t = lane; t < a.ts; t += 32) s_tab[t] = SLOT_FREE;
          __syncwarp();
          for (int e = lane; e < ef; e += 32)
            if (s_pk[e] >= 0) insert(s_pk[e] >> 1);
          __syncwarp();
          for (int c0 = 0; c0 < w; c0 += 32) {
            const int c = c0 + lane;
            const int id = c < w ? s_c[c] : -1;
            const unsigned same = __match_any_sync(FULL, id);
            if (id >= 0 && ((same & ((1u << lane) - 1)) || insert(id)))
              s_c[c] = -1;
            __syncwarp();
          }
        }
        for (int c = lane; c < w; c += 32) {
          const int id = s_c[c];
          s_pk[ef + c] = id < 0 ? -2 : id * 2;
          s_d[ef + c] = CUDART_INF_F;  // scored below
        }
        __syncwarp();
        int n_score = 0;  // the lanes to score, compacted into s_c in order
        for (int c0 = 0; c0 < w; c0 += 32) {
          const int c = c0 + lane;
          const bool live = c < w && s_pk[ef + c] >= 0;
          const unsigned b = __ballot_sync(FULL, live);
          if (live) s_c[n_score + __popc(b & ((1u << lane) - 1))] = ef + c;
          n_score += __popc(b);
        }
        if (lane == 0) s_count[1] = n_score;
      }
      group_sync();
      const int n = s_count[1];

      // 4. the scores: lane group `grp` of `group` lanes takes list
      // entries grp, grp + groups, ...; every lane runs the same trip
      // counts (shuffles)
      const int groups = 32 / a.group;
      const int grp = lane / a.group, gl = lane % a.group;
      if constexpr (RINGED) {
        int li = 0;  // the warp's next entry of the list
        for (int k = 0, p = sub; p < np; ++k, p += qw) {
          const int slot = sub * R + k % R;
          mbar_wait(smem_addr(mbar + slot), (unsigned)(k / R) & 1u);
          const int kk = p / a.pieces, j = p - kk * a.pieces;
          const int c0 = s_live[kk] * m2 + j * a.rpp;  // the piece's first
          const int c1 = c0 + min(m2 - j * a.rpp, a.rpp);  // and past
          while (li < n && s_c[li] - ef < c0) ++li;
          int hi = li;
          while (hi < n && s_c[hi] - ef < c1) ++hi;
          const unsigned char* sl = ring + (size_t)slot * a.slot_bytes;
          for (int i0 = li; i0 < hi; i0 += groups * UNROLL) {
            const T* rows[UNROLL];
            bool live[UNROLL];
            int ln[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int i = i0 + u * groups + grp;
              live[u] = i < hi;
              ln[u] = live[u] ? s_c[i] : ef + c0;
              rows[u] = reinterpret_cast<const T*>(
                  sl + (size_t)(ln[u] - ef - c0) * a.row_bytes);
            }
            score_lanes<T, PATH, UNROLL>(a, rows, live, ln, qy, s_d, s_pk,
                                         gl);
          }
          li = hi;
          __syncwarp();  // the slot is read: the copy after next may land
          if (lane == 0 && p + R * qw < np) {
            fence_proxy_async();
            issue(p + R * qw);
          }
        }
      } else {  // rows in flight: 8 a lane group, 4 for int8
        constexpr int U = std::is_same_v<T, int8_t> ? UNROLL : 2 * UNROLL;
        for (int i0 = sub * groups * U; i0 < n; i0 += qw * groups * U) {
          const T* rows[U];
          bool live[U];
          int ln[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * groups + grp;
            live[u] = i < n;
            ln[u] = live[u] ? s_c[i] : ef;
            const int c = ln[u] - ef;
            const int s = live[u] ? s_sel[c / m2] : 0;
            rows[u] = static_cast<const T*>(a.vals) +
                      ((size_t)s * m2 + (live[u] ? c % m2 : 0)) * a.d;
          }
          score_lanes<T, PATH, U>(a, rows, live, ln, qy, s_d, s_pk, gl);
        }
      }
      group_sync();

      if (sub == 0) {
        // 5. the merge in the tail's order, the first ef written
        bool whole = false;
        int npv = 0;  // the pool's lanes before its first empty one
        for (int e = lane; e < ef; e += 32) {
          const unsigned k = lane_key(s_d[e], s_pk[e]);
          whole |= k == KEY_NAN ||
                   (e + 1 < ef && lane_key(s_d[e + 1], s_pk[e + 1]) < k);
          if (k < KEY_EMPTY) npv = e + 1;
        }
        for (int i = lane; i < n; i += 32) whole |= isnan(s_d[s_c[i]]);
        whole = __any_sync(FULL, whole);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          npv = max(npv, __shfl_xor_sync(FULL, npv, off));
        if (whole) {
          sort_lanes<0>(
              a.width, lane, s_key, s_pos,
              [&](int e) {
                return e < ef + w ? lane_key(s_d[e], s_pk[e]) : KEY_PAD;
              },
              [&](int i, unsigned k, unsigned, int pos) {
                if (i < ef) {
                  const bool empty = k == KEY_EMPTY || k == KEY_PAD;
                  od[i] = empty ? CUDART_INF_F : s_d[pos];
                  op[i] = empty ? -2 : s_pk[pos];
                }
              });
        } else {
          // only the candidates that can reach the first ef are sorted:
          // with the pool full, those before its worst lane
          const unsigned thr =
              npv == ef ? lane_key(s_d[ef - 1], s_pk[ef - 1]) : KEY_EMPTY;
          int ns = 0;  // those candidates, compacted into s_c in order
          for (int c0 = 0; c0 < w && n > 0; c0 += 32) {
            const int c = c0 + lane;
            const bool keep =
                c < w && lane_key(s_d[ef + c], s_pk[ef + c]) < thr;
            const unsigned b = __ballot_sync(FULL, keep);
            if (keep) s_c[ns + __popc(b & ((1u << lane) - 1))] = c;
            ns += __popc(b);
          }
          __syncwarp();
          auto key_of = [&](int e) {
            return e < ns ? lane_key(s_d[ef + s_c[e]], s_pk[ef + s_c[e]])
                          : KEY_PAD;
          };
          auto keep_sorted = [&](int i, unsigned k, unsigned, int pos) {
            s_key[i] = k;
            s_pos[i] = i < ns ? s_c[pos] : 0;
          };
          if (ns > SMALL_SORT && cw == 256)  // early hops: the pool not full
            sort_lanes<8>(cw, lane, s_key, s_pos, key_of, keep_sorted);
          else if (ns > SMALL_SORT)
            sort_lanes<0>(cw, lane, s_key, s_pos, key_of, keep_sorted);
          else if (ns > 0)
            sort_lanes<SMALL_SORT / 32>(SMALL_SORT, lane, s_key, s_pos,
                                        key_of, keep_sorted);
          for (int e = lane; e < npv; e += 32) {
            const int r = e + count_below(s_key, ns,
                                          lane_key(s_d[e], s_pk[e]));
            if (r < ef) {
              od[r] = s_d[e];
              op[r] = s_pk[e];
            }
          }
          for (int j = lane; j < min(ns, ef); j += 32) {
            const int r = j + count_pool_upto(s_d, s_pk, npv, s_key[j]);
            if (r < ef) {
              od[r] = s_d[ef + s_pos[j]];
              op[r] = s_pk[ef + s_pos[j]];
            }
          }
          for (int r = npv + ns + lane; r < ef; r += 32) {
            od[r] = CUDART_INF_F;
            op[r] = -2;
          }
        }

        // 6. done, the hop count and the count of queries not done
        if (lane == 0) {
          a.out_done[row] = done;
          if (a.out_hops) a.out_hops[row] = hops0 + 1;
          if (!done) atomicAdd(&blk_left, 1);
        }
      }
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

template <typename T, int PATH, int QW>
cudaError_t launch(const HopArgs& a, int slab, cudaStream_t st) {
  auto kernel = packed_hop_kernel<T, PATH, QW>;
  // the dynamic shared-memory cap, set once for each device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t per_query = layout(a, slab, PATH == RING_PATH).total;
  // the queries a block that leave the most of them on an SM (its 233,472
  // bytes of shared memory, 1,024 reserved a block); one where a query
  // has several warps
  int qpb = 0;
  size_t most = 0;
  for (int w = QW > 1 ? 1 : WARPS; w >= 1; w /= 2) {
    const size_t bytes = per_query * w;
    const size_t resident = bytes > (size_t)SMEM_MAX
                                ? 0 : 233472 / (bytes + 1024 + 128) * w;
    if (resident > most) {
      most = resident;
      qpb = w;
    }
  }
  if (qpb == 0) return cudaErrorInvalidValue;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  HopArgs b = a;
  b.qpb = qpb;
  kernel<<<(a.q + qpb - 1) / qpb, 32 * QW * qpb, per_query * qpb, st>>>(b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t with_path(const HopArgs& a, int slab, int path, cudaStream_t st) {
  if (path == RING_PATH)
    return a.qw > 1 ? launch<T, RING_PATH, WIDE_QW>(a, slab, st)
                    : launch<T, RING_PATH, 1>(a, slab, st);
  return a.qw > 1 ? launch<T, SCALAR_PATH, WIDE_QW>(a, slab, st)
                  : launch<T, SCALAR_PATH, 1>(a, slab, st);
}

}  // namespace

// pool_d (q, ef) f32, pool_p (q, ef) int32 packed ids (id*2 | expanded);
// nbr0 (cap, m2) int32; nbr_vals (cap, m2, d) of the slab coded 0 f32,
// 1 bf16, 2 int8; qs (q, d) f32; for int8 also qc (q, d) int8, sq and q2
// (q,) f32, pnorm2 f32 by element id and scale (d,) f32 (qs and scale read
// for L1 only), else null.  e_sel <= ef the lanes expanded; metric: 0 L2,
// 1 inner product (and cosine), 2 L1.  done_in (q,) uint8 and hops_in (q,)
// int32: the previous hop's (null: none done, no hops).  Writes the new
// (q, ef) pool, out_done (q,) uint8, out_hops (q,) int32 (null: not kept;
// they may be done_in / hops_in themselves) and the count of queries not
// done (out_left, one int); work is two ints, zero before the first
// launch on a stream, and left at zero.  *path: 0 the bulk-copy ring,
// 1 single values.
extern "C" int pgvt_packed_hop(
    const float* pool_d, const int* pool_p, const int* nbr0, int cap,
    int m2, const void* nbr_vals, int slab, const float* qs, const void* qc,
    const float* sq, const float* q2, const float* pnorm2,
    const float* scale, const void* done_in, const int* hops_in, int q,
    int ef, int e_sel, int d, int metric, float* out_d, int* out_p,
    void* out_done, int* out_hops, int* work, int* out_left, int* path_out,
    void* stream) {
  if (q < 1 || ef < 1 || e_sel < 1 || e_sel > ef || cap < 1 || m2 < 1 ||
      d < 1 || metric < 0 || metric > 2 || slab < F32 || slab > INT8 ||
      (slab == INT8 && (!qc || !sq || !q2 || !pnorm2 || !scale)))
    return (int)cudaErrorInvalidValue;
  const int w = e_sel * m2;
  const int width = pgvt::merge_width(ef, w);
  if (width == 0) return (int)cudaErrorInvalidValue;
  const int esize = slab == F32 ? 4 : slab == BF16 ? 2 : 1;
  const int row_bytes = d * esize;
  // 16-byte multiples at 16-byte aligned addresses: the ring
  const bool aligned = row_bytes % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(nbr_vals) % 16 == 0;
  int path = aligned ? RING_PATH : SCALAR_PATH;
  // the ring: pieces of whole rows, SLOT_MAX bytes of them, or 4 rows
  const int rpp = min(m2, max(4, SLOT_MAX / row_bytes));
  int ts = 64;  // the dedupe's hash slots, at most two thirds full
  while (2 * ts < 3 * (ef + w)) ts <<= 1;
  HopArgs a{pool_d, pool_p, nbr0, nbr_vals, qs,
            static_cast<const int8_t*>(qc), sq, q2, pnorm2, scale,
            static_cast<const uint8_t*>(done_in), hops_in, out_d, out_p,
            static_cast<uint8_t*>(out_done), out_hops, work, out_left,
            cap, q, ef, e_sel, m2, d, metric, 1, 1, w, width,
            pgvt::sort_width(w), 32, ts, row_bytes, rpp, (m2 + rpp - 1) / rpp,
            rpp * row_bytes};
  // warps a query: one where a slab is small, so that one query's sorts
  // run beside others' copies; WIDE_QW where it is large, so that its
  // pieces are not one warp's chain
  a.qw = m2 * row_bytes > WIDE_SLAB ? WIDE_QW : 1;
  if (a.qw > 1 && layout(a, slab, path == RING_PATH).total > (size_t)SMEM_MAX)
    a.qw = 1;
  if (layout(a, slab, path == RING_PATH).total > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // lanes a candidate row: 16-byte loads, else single values
  if (path == RING_PATH) a.group = pgvt::lane_group(true, 16 / esize, d);
  *path_out = path;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab == BF16) return (int)with_path<__nv_bfloat16>(a, slab, path, st);
  if (slab == INT8) return (int)with_path<int8_t>(a, slab, path, st);
  return (int)with_path<float>(a, slab, path, st);
}
