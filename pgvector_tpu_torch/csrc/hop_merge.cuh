// The hop tail of the HNSW beam search, shared by hop_tail.cu, packed_hop.cu
// and gather_hop.cu: the device half of pgvector_tpu/ops/pallas_hop.py's
// _tail_kernel.  Per query row, over `width` lanes in shared memory laid
// out as [pool (id*2 | expanded) | W scored candidates | padding]:
//   1. order the lanes by (id, position) and mask every later copy of an
//      id, so the pool's copy and its expanded flag survive;
//   2. order by (distance, position) — the stable distance order;
//   3. emit the first ef lanes, with +inf / -2 in empty lanes.
// Only values move, so the output is bit-identical to two stable sorts
// (ops/hop_tail.py: hop_tail_plain).
//
// Design: a bitonic sort of (key, position) pairs held in registers, R
// consecutive lanes per thread.  A compare-exchange at distance j < R stays
// inside a thread, one at R <= j < 32R is a warp shuffle, and only the
// stages with j >= 32R go through shared memory, with one barrier each
// (double-buffered).  At width 512 with 128 threads that is 3 barrier
// stages of 45 per sort, where one compare-exchange per thread per stage
// through shared memory took 45.  Positions are distinct, so any correct
// sorting network gives the stable order, and the position doubles as the
// payload: the distance and the packed id are read back by position.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace pgvt {

constexpr float BIG = 3.0e38f;               // masked lanes sort last
constexpr int ID_INF = 2147483647 - 1048575;  // 2^31 - 2^20, after every id
constexpr int MAX_WIDTH = 4096;
constexpr int MIN_WIDTH = 64;                 // one warp of R = 2 lanes
constexpr int TAIL_THREADS = 128;             // threads per row, widths >= 256

// Lanes per row: the next power of two >= ef + w, at least MIN_WIDTH
// (padding lanes sort last and are never emitted).  0 if over MAX_WIDTH.
inline int merge_width(int ef, int w) {
  int width = MIN_WIDTH;
  while (width < ef + w) width <<= 1;
  return width > MAX_WIDTH ? 0 : width;
}

// Lanes per thread at a width: 2 up to width 256, then width / 128.
inline int merge_lanes(int width) {
  return width / TAIL_THREADS < 2 ? 2 : width / TAIL_THREADS;
}

// Shared-memory bytes of the exchange buffers: two of (key, position).
inline size_t merge_xbuf_bytes(int width) {
  return sizeof(int) * 4 * (size_t)width;
}

__device__ __forceinline__ int lane_id(int packed) {
  const int id = packed >> 1;  // arithmetic: -2 unpacks to -1
  return id < 0 ? ID_INF : id;
}

template <typename K>
__device__ __forceinline__ bool before(K a, int pa, K b, int pb) {
  return a < b || (a == b && pa < pb);
}

// Lane i against its partner at i ^ j in the stage of bitonic `size`: the
// lower lane keeps the first of the two in ascending runs, the later in
// descending ones.
template <typename K>
__device__ __forceinline__ void exchange(K& k, int& p, K ok, int op, int i,
                                         int j, int size) {
  const bool lower = (i & j) == 0, ascending = (i & size) == 0;
  if (before(ok, op, k, p) == (lower == ascending)) {
    k = ok;
    p = op;
  }
}

// Ascending bitonic sort of the block's width = blockDim.x * R lanes, lane
// threadIdx.x * R + r in key[r] / pos[r].  xbuf: merge_xbuf_bytes(width).
template <int R, typename K>
__device__ void bitonic(K (&key)[R], int (&pos)[R], int* xbuf, int width) {
  const int base = threadIdx.x * R;
  int buf = 0;
  for (int size = 2; size <= width; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32 * R) {  // across warps: through shared memory
        K* bk = reinterpret_cast<K*>(xbuf + buf * 2 * width);
        int* bp = xbuf + buf * 2 * width + width;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          bk[base + r] = key[r];
          bp[base + r] = pos[r];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = base + r;
          exchange(key[r], pos[r], bk[i ^ j], bp[i ^ j], i, j, size);
        }
        buf ^= 1;  // the next such stage writes the other buffer
      } else if (j >= R) {  // across the lanes of one warp
        const int lanes = j / R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const K ok = __shfl_xor_sync(0xffffffffu, key[r], lanes);
          const int op = __shfl_xor_sync(0xffffffffu, pos[r], lanes);
          exchange(key[r], pos[r], ok, op, base + r, j, size);
        }
      } else {  // inside the thread: unrolled for each j < R
#pragma unroll
        for (int jj = R / 2; jj >= 1; jj >>= 1) {
          if (jj != j) continue;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r & jj) continue;
            const int s = r | jj;
            const bool ascending = ((base + r) & size) == 0;
            if (before(key[s], pos[s], key[r], pos[r]) == ascending) {
              const K tk = key[r]; key[r] = key[s]; key[s] = tk;
              const int tp = pos[r]; pos[r] = pos[s]; pos[s] = tp;
            }
          }
        }
      }
    }
  }
}

// Pass 1 of the tail.  On entry (after a barrier) s_d / s_pk hold the
// width lanes' distances and packed ids, padding lanes BIG / -2; blockDim.x
// * R == width.  Every later copy of an id, every empty lane and every
// +-inf distance becomes BIG in s_d, so the pool's copy of an id and its
// expanded flag survive.  Ends with a barrier.
template <int R>
__device__ void mask_repeats(float* s_d, const int* s_pk, int* xbuf,
                             int width) {
  const int base = threadIdx.x * R;
  int ikey[R], pos[R];
  float dist[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ikey[r] = lane_id(s_pk[base + r]);
    pos[r] = base + r;
  }
  // (id, position) order
  bitonic<R>(ikey, pos, xbuf, width);
  __syncthreads();  // the sort's last exchange reads are done
#pragma unroll
  for (int r = 0; r < R; ++r) xbuf[base + r] = ikey[r];
  __syncthreads();
  // a later copy of an id is masked; so are empty lanes and +-inf
  // distances.  Each position is written by exactly one lane.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r, id = ikey[r];
    const bool dup = i > 0 && id != ID_INF && xbuf[i - 1] == id;
    const float d = s_d[pos[r]];
    dist[r] = (dup || id == ID_INF || isinf(d)) ? BIG : d;
  }
  __syncthreads();  // every read of s_d above is done
#pragma unroll
  for (int r = 0; r < R; ++r) s_d[pos[r]] = dist[r];
  __syncthreads();
}

// Pass 2: the (distance, position) order of the lanes, the first ef
// emitted (+inf / -2 where the lane is BIG).  Starts after a barrier.
template <int R>
__device__ void emit_nearest(const float* s_d, const int* s_pk, int* xbuf,
                             int width, int ef, float* out_d, int* out_p) {
  const int base = threadIdx.x * R;
  int pos[R];
  float dist[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dist[r] = s_d[base + r];
    pos[r] = base + r;
  }
  bitonic<R>(dist, pos, xbuf, width);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r;
    if (i < ef) {
      const float v = dist[r];
      out_d[i] = v >= BIG ? CUDART_INF_F : v;
      out_p[i] = v >= BIG ? -2 : s_pk[pos[r]];
    }
  }
}

// The tail of one row: pass 1, then pass 2.  s_d is overwritten.  Writes
// the row's ef outputs.
template <int R>
__device__ void hop_merge(float* s_d, const int* s_pk, int* xbuf, int width,
                          int ef, float* out_d, int* out_p) {
  mask_repeats<R>(s_d, s_pk, xbuf, width);
  emit_nearest<R>(s_d, s_pk, xbuf, width, ef, out_d, out_p);
}

}  // namespace pgvt
