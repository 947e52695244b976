// K6 — one hop of the HNSW beam search over rows gathered by id, fused.
//
// Replaces the XLA program of the row-gather branch of
// pgvector_tpu/index/hnsw_kernels.py:_hop_body (:518-554: the Knuth-keyed
// dedupe, the pool membership mask, the row scores and _hop_merge) for
// dense rows with no visited table and no discarded pool, which the JAX
// package fuses into its jitted beam loop (_hop_step :588, the while_loop
// at :652).  The port's plain version (ops/gather_hop.py) is a dozen eager
// ops over a (Q, W, ef) membership block and a (Q, W, D) row block.  It is
// K2 (packed_hop.cu) with rows gathered by id in place of slabs.  Per query
// row, given the E expanded element ids `sel` (-1 for none) and their
// neighbor lists nb (E, 2m) (-1 padded; the upper levels' m-wide lists
// come padded to 2m):
//   1. the W = E x 2m candidates in the plain version's order: with E > 1
//      sorted by the Knuth key id * 2654435761 mod 2^32 (the key of -1
//      last), a repeated key masked, the ids recovered by the inverse;
//      with E = 1 in adjacency order;
//   2. pass 1 of the hop tail (hop_merge.cuh) masks every repeated id, so
//      a candidate already in the pool and the empty lanes go;
//   3. each remaining candidate's row of the (N, D) f32, bf16 or f16 value
//      table is read and scored against the query in f32, with
//      dense_point_scores' formulas (hop_score.cuh: L2, inner product and
//      cosine as -ip, L1; elementwise, no expanded-norm form);
//   4. pass 2 merges them into the ef pool in (distance, position) order.
// No (Q, W, D) or (Q, W) block reaches device memory.  The distances are
// summed in another order than torch.sum's, so they agree with the plain
// version's within f32 tolerance, and the ids apart from ties; given the
// same distances the merge is the plain version's stable sort bit for bit.
//
// What bounds it on an H100: the rows it must read, one for each distinct
// candidate not in the pool, D x 4 (or 2) bytes each — at the 1M build's
// hop (Q = 1,024, E = 4, m = 16, D = 128 f32) at most 131,072 rows, 67 MB,
// 0.020 ms at 3.35 TB/s.  Design: one block a query row, the query in
// shared memory in f32; the surviving candidates are compacted first, so
// lane groups gather only rows that are scored (16-byte loads, four rows
// a group in flight, as K2); the Knuth sort and both tail passes are the
// register bitonic sort of hop_merge.cuh.  A row's result depends on its
// own inputs alone.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hop_score.cuh"

namespace {

using pgvt::BIG;
using pgvt::UNROLL;

constexpr unsigned PERM = 2654435761u;     // Knuth's multiplicative hash
constexpr unsigned PERM_INV = 244002641u;  // its inverse mod 2^32
constexpr unsigned KEY_NONE = 0xffffffffu;  // no id below 2^30 maps here
enum { F32 = 0, BF16 = 1, F16 = 2 };        // the wrapper's dtype codes

// T: value type; N: values per load (16 bytes, or 1 where rows are not
// 16-byte aligned); R: tail lanes per thread
template <typename T, int N, int R>
__global__ void gather_hop_kernel(
    const float* __restrict__ pool_d, const int* __restrict__ pool_p,
    const int* __restrict__ sel, const int* __restrict__ nb,
    const T* __restrict__ rows, int n_rows, const void* __restrict__ qs,
    int q_type, int ef, int e_sel, int m2, int d, int width, int group,
    int metric, float* __restrict__ out_d, int* __restrict__ out_p) {
  extern __shared__ int sm[];
  float* s_d = reinterpret_cast<float*>(sm);  // [width]
  int* s_pk = sm + width;                     // [width]
  int* xbuf = sm + 2 * width;                 // merge_xbuf_bytes(width)
  const int w = e_sel * m2;
  int* s_list = xbuf + 4 * width;             // [w] candidates to score
  int* s_n = s_list + w;                      // [1] their count
  float* s_q = reinterpret_cast<float*>(s_n + 1);  // [d]
  const size_t row = blockIdx.x;
  const int* row_sel = sel + row * e_sel;
  const int* row_nb = nb + row * (size_t)w;

  if (q_type == BF16) {
    const auto* q = static_cast<const __nv_bfloat16*>(qs) + row * d;
    for (int e = threadIdx.x; e < d; e += blockDim.x)
      s_q[e] = __bfloat162float(q[e]);
  } else if (q_type == F16) {
    const auto* q = static_cast<const __half*>(qs) + row * d;
    for (int e = threadIdx.x; e < d; e += blockDim.x)
      s_q[e] = __half2float(q[e]);
  } else {
    const auto* q = static_cast<const float*>(qs) + row * d;
    for (int e = threadIdx.x; e < d; e += blockDim.x) s_q[e] = q[e];
  }
  if (threadIdx.x == 0) *s_n = 0;
  // the candidate lanes' ids: -1 where the selection is -1, and where an
  // id lies past the table's rows (no row to read; the graph holds none)
  auto cand = [&](int c) {
    const int id = row_sel[c / m2] >= 0 ? row_nb[c] : -1;
    return id < n_rows ? id : -1;
  };

  if (e_sel > 1) {
    // 1. the Knuth-keyed order: sort the keys of every lane (the pool and
    // padding lanes key KEY_NONE, after every id), then candidate lane c
    // takes the c-th smallest key
    const int base = threadIdx.x * R;
    unsigned key[R];
    int pos[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = base + r;
      const int id = (e >= ef && e < ef + w) ? cand(e - ef) : -1;
      key[r] = id >= 0 ? (unsigned)id * PERM : KEY_NONE;
      pos[r] = e;
    }
    pgvt::bitonic<R>(key, pos, xbuf, width);
    __syncthreads();  // the sort's last exchange reads are done
    unsigned* s_key = reinterpret_cast<unsigned*>(s_d);  // s_d is free here
#pragma unroll
    for (int r = 0; r < R; ++r) s_key[base + r] = key[r];
    __syncthreads();
    // the ids in key order, a repeated key masked, into s_list for now
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      const unsigned k = s_key[c];
      const bool dup = c > 0 && k == s_key[c - 1];
      s_list[c] = (dup || k == KEY_NONE) ? -1 : (int)(k * PERM_INV);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float dv = BIG;
    int pk = -2;
    if (e < ef) {
      pk = pool_p[row * ef + e];
      dv = pool_d[row * ef + e];
    } else if (e < ef + w) {
      const int id = e_sel > 1 ? s_list[e - ef] : cand(e - ef);
      pk = id * 2;
      dv = id >= 0 ? 0.f : CUDART_INF_F;  // scored below
    }
    s_d[e] = dv;
    s_pk[e] = pk;
  }
  __syncthreads();

  // 2. repeated ids (the pool's copy first) and empty lanes become BIG
  pgvt::mask_repeats<R>(s_d, s_pk, xbuf, width);
  for (int e = ef + threadIdx.x; e < ef + w; e += blockDim.x)
    if (s_d[e] < BIG) s_list[atomicAdd(s_n, 1)] = e;
  __syncthreads();
  const int n = *s_n;

  // 3. score the survivors: lane group `grp` of `group` lanes takes list
  // entries grp, grp + groups, ...; every lane runs the same trip counts
  const int groups = blockDim.x / group;
  const int grp = threadIdx.x / group, gl = threadIdx.x % group;
  for (int c0 = 0; c0 < n; c0 += groups * UNROLL) {
    float acc[UNROLL];
    const T* vrow[UNROLL];
    bool live[UNROLL];
    int lane[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * groups + grp;
      live[u] = c < n;
      lane[u] = live[u] ? s_list[c] : 0;
      const int id = live[u] ? s_pk[lane[u]] >> 1 : 0;
      vrow[u] = rows + (size_t)id * d;
    }
    pgvt::score_rows<T, N>(vrow, live, s_q, d, group, gl, metric, acc);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (gl == 0 && live[u]) s_d[lane[u]] = isinf(acc[u]) ? BIG : acc[u];
  }
  __syncthreads();

  // 4. the merge
  pgvt::emit_nearest<R>(s_d, s_pk, xbuf, width, ef, out_d + row * ef,
                        out_p + row * ef);
}

template <typename T, int N>
cudaError_t launch(const float* pool_d, const int* pool_p, const int* sel,
                   const int* nb, const void* rows, int n_rows,
                   const void* qs, int q_type, int q, int ef, int e_sel,
                   int m2, int d, int width, int group, int metric,
                   float* out_d, int* out_p, cudaStream_t st) {
  const size_t smem = sizeof(int) * (2 * (size_t)width + e_sel * m2 + 1) +
                      pgvt::merge_xbuf_bytes(width) + sizeof(float) * d;
  return pgvt::with_lanes(width, [&](auto r) {
    constexpr int R = decltype(r)::value;
    cudaError_t err = cudaFuncSetAttribute(
        gather_hop_kernel<T, N, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gather_hop_kernel<T, N, R><<<q, width / R, smem, st>>>(
        pool_d, pool_p, sel, nb, static_cast<const T*>(rows), n_rows, qs,
        q_type, ef, e_sel, m2, d, width, group, metric, out_d, out_p);
    return cudaGetLastError();
  });
}

}  // namespace

// pool_d (q, ef) f32, pool_p (q, ef) int32 packed ids (id*2 | expanded),
// sel (q*e_sel,) int32, nb (q*e_sel, m2) int32, rows (n_rows, d) and qs
// (q, d) of the dtypes coded 0 f32, 1 bf16, 2 f16 (dtype, q_type).
// metric: 0 L2, 1 inner product (and cosine), 2 L1.  Writes the new
// (q, ef) pool.
extern "C" int pgvt_gather_hop(const float* pool_d, const int* pool_p,
                               const int* sel, const int* nb,
                               const void* rows, int n_rows, const void* qs,
                               int q, int ef, int e_sel, int m2, int d,
                               int dtype, int q_type, int metric,
                               float* out_d, int* out_p, void* stream) {
  const int width = pgvt::merge_width(ef, e_sel * m2);
  if (q < 1 || n_rows < 1 || ef < 1 || e_sel < 1 || m2 < 1 || d < 1 ||
      width == 0 || metric < 0 || metric > 2 || dtype < F32 ||
      dtype > F16 || q_type < F32 || q_type > F16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == F32 ? 4 : 2, n = 16 / esize;
  // 16-byte loads need 16-byte aligned rows
  const bool vec = (d * esize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const int group = pgvt::lane_group(vec, n, d);
  auto go = [&](auto t, auto nv) {
    using T = decltype(t);
    constexpr int N = decltype(nv)::value;
    return (int)launch<T, N>(pool_d, pool_p, sel, nb, rows, n_rows, qs,
                             q_type, q, ef, e_sel, m2, d, width, group,
                             metric, out_d, out_p, st);
  };
  using one = std::integral_constant<int, 1>;
  if (dtype == BF16)
    return vec ? go(__nv_bfloat16(), std::integral_constant<int, 8>())
               : go(__nv_bfloat16(), one());
  if (dtype == F16)
    return vec ? go(__half(), std::integral_constant<int, 8>())
               : go(__half(), one());
  return vec ? go(float(), std::integral_constant<int, 4>())
             : go(float(), one());
}
