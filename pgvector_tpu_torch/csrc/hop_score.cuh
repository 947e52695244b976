// The f32 / bf16 / f16 row scorer of the HNSW beam hop, shared by packed_hop.cu
// (K2: rows are slabs of the packed cache) and gather_hop.cu (K6: rows of
// the value table, gathered by id): ops/distance.py's dense_point_scores
// in f32 for UNROLL (K2) or more candidate rows at once.  A group of
// `group` adjacent lanes reads one candidate's row with N-value loads (16
// bytes where the rows are 16-byte aligned, else single values) from
// device memory, or (K2's slab ring) 16-byte loads from shared memory;
// the query sits in shared memory in f32, and a shuffle tree sums the
// group's partial sums.  bf16 and f16 values are widened to f32 exactly
// before any arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hop_merge.cuh"

namespace pgvt {

enum { L2 = 0, IP = 1, L1 = 2 };  // the wrappers' metric codes
constexpr int UNROLL = 4;         // candidates a lane group has in flight

// the 16 / sizeof(T) values of the 16 bytes u, as f32
template <typename T>
__device__ __forceinline__ void widen16(const uint4 u, float* v) {
  if constexpr (std::is_same_v<T, float>) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const __half* h = reinterpret_cast<const __half*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __half2float(h[i]);
  }
}

// N consecutive row values from p, as f32
template <typename T, int N>
struct Load {  // 16 bytes
  static_assert(N * sizeof(T) == 16, "16-byte loads");
  static __device__ __forceinline__ void get(const T* p, float* v) {
    widen16<T>(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
};

template <typename T>
struct Load<T, 1> {
  static __device__ __forceinline__ void get(const T* p, float* v) {
    if constexpr (sizeof(T) == 4) {
      v[0] = __ldg(p);
    } else if constexpr (std::is_same_v<T, __half>) {
      v[0] = __half2float(*p);
    } else {
      v[0] = __bfloat162float(*p);
    }
  }
};

// The distances of U rows (row[u], where live[u]; U = UNROLL for K2) to
// the query s_q (d values, f32, shared memory): every lane of a group of
// `group` lanes (gl its lane in the group) adds its share; on return every
// lane of the group holds the sums, negated for the inner product.  Every
// lane of the warp calls it with the same trip counts (shuffles).  SMEM:
// the rows lie in shared memory (N values are 16 bytes).
template <typename T, int N, int U = UNROLL, bool SMEM = false>
__device__ __forceinline__ void score_rows(const T* (&row)[U],
                                           bool (&live)[U],
                                           const float* s_q, int d,
                                           int group, int gl, int metric,
                                           float (&acc)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  for (int e0 = gl * N; e0 < d; e0 += group * N) {
    float v[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[u][i] = 0.f;
      } else if constexpr (SMEM) {
        widen16<T>(*reinterpret_cast<const uint4*>(row[u] + e0), v[u]);
      } else {
        Load<T, N>::get(row[u] + e0, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float q = s_q[e0 + i];
        if (metric == L2) {
          const float t = q - v[u][i];
          acc[u] = fmaf(t, t, acc[u]);
        } else if (metric == IP) {
          acc[u] = fmaf(q, v[u][i], acc[u]);
        } else {
          acc[u] += fabsf(q - v[u][i]);
        }
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    for (int off = group / 2; off > 0; off >>= 1)
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    if (metric == IP) acc[u] = -acc[u];
  }
}

// lanes per candidate: enough n-element 16-byte loads to cover a row of d,
// up to a warp; a full warp where rows are not 16-byte aligned
inline int lane_group(bool vec, int n, int d) {
  int group = 32;
  if (vec)
    while (group > 2 && (group / 2) * n >= d) group /= 2;
  return group;
}

}  // namespace pgvt
