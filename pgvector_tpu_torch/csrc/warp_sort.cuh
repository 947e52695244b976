// One warp's sort of up to 4,096 (unsigned key, position) lanes, shared by
// gather_hop.cu (K6) and select_neighbors.cu (K3): the bitonic network of
// hop_merge.cuh without a block barrier.  Up to 512 lanes (R = width / 32
// a thread, consecutive) sit in registers and exchange by shuffles; wider
// rows go through the warp's own shared memory with a __syncwarp a stage.
// Positions are distinct, so any correct network gives the stable order
// of the keys: order_key maps f32 to keys in torch.sort's ascending order.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace pgvt {

constexpr unsigned KEY_NAN = 0xfffffffeu;  // NaN sorts after +inf

// torch.sort's ascending order of f32 as unsigned keys: -0 == +0, NaN
// after +inf
__device__ __forceinline__ unsigned order_key(float f) {
  if (isnan(f)) return KEY_NAN;
  const unsigned b = __float_as_uint(f == 0.f ? 0.f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool key_before(unsigned a, int pa, unsigned b,
                                           int pb) {
  return a < b || (a == b && pa < pb);
}

// Ascending sort of the warp's 32 * R lanes by (key, position), lane * R
// + r in key[r] / pos[r]: registers and shuffles only.
template <int R>
__device__ __forceinline__ void warp_bitonic(unsigned (&key)[R],
                                             int (&pos)[R], int lane) {
  const int base = lane * R;
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= R) {  // across lanes
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned ok = __shfl_xor_sync(0xffffffffu, key[r], j / R);
          const int op = __shfl_xor_sync(0xffffffffu, pos[r], j / R);
          const int i = base + r;
          const bool lower = (i & j) == 0, asc = (i & size) == 0;
          if (key_before(ok, op, key[r], pos[r]) == (lower == asc)) {
            key[r] = ok;
            pos[r] = op;
          }
        }
      } else {  // inside the thread
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & j) continue;
          const int s = r | j;
          const bool asc = ((base + r) & size) == 0;
          if (key_before(key[s], pos[s], key[r], pos[r]) == asc) {
            const unsigned tk = key[r]; key[r] = key[s]; key[s] = tk;
            const int tp = pos[r]; pos[r] = pos[s]; pos[s] = tp;
          }
        }
      }
    }
  }
}

// The same sort over `width` (a power of two) lanes in shared memory.
__device__ inline void warp_bitonic_smem(unsigned* key, int* pos, int width,
                                         int lane) {
  for (int size = 2; size <= width; size <<= 1)
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < width / 2; t += 32) {
        const int lo = 2 * t - (t & (j - 1)), hi = lo + j;
        const unsigned klo = key[lo], khi = key[hi];
        const int plo = pos[lo], phi = pos[hi];
        if (key_before(khi, phi, klo, plo) == ((lo & size) == 0)) {
          key[lo] = khi; key[hi] = klo;
          pos[lo] = phi; pos[hi] = plo;
        }
      }
      __syncwarp();
    }
}

// Sort the warp's `width` lanes by (key_of(e), e), then call use(i, key,
// prev, pos) for every sorted index i (prev: the key at i - 1, unused at
// i = 0).  R > 0: registers (width = 32 * R); R == 0: s_key / s_pos, width
// each.  Every read key_of makes is done before the first use.  Ends
// synchronized.
template <int R, typename KeyOf, typename Use>
__device__ __forceinline__ void sort_lanes(int width, int lane,
                                           unsigned* s_key, int* s_pos,
                                           KeyOf key_of, Use use) {
  if constexpr (R > 0) {
    unsigned key[R];
    int pos[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      key[r] = key_of(lane * R + r);
      pos[r] = lane * R + r;
    }
    warp_bitonic<R>(key, pos, lane);
    const unsigned prev = __shfl_up_sync(0xffffffffu, key[R - 1], 1);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
      use(lane * R + r, key[r], r ? key[r - 1] : prev, pos[r]);
  } else {
    for (int e = lane; e < width; e += 32) {
      s_key[e] = key_of(e);
      s_pos[e] = e;
    }
    __syncwarp();
    warp_bitonic_smem(s_key, s_pos, width, lane);
    for (int i = lane; i < width; i += 32)
      use(i, s_key[i], i ? s_key[i - 1] : 0u, s_pos[i]);
  }
  __syncwarp();
}

// The lanes of a warp sort at `n` entries: the next power of two, at
// least 64; R a thread (0 past 512: shared memory).
__host__ __device__ inline int sort_width(int n) {
  int width = 64;
  while (width < n) width <<= 1;
  return width;
}

// f(std::integral_constant<int, R>()) with R the register lanes a thread
// of a sort over `width` lanes (0: shared memory)
template <typename F>
cudaError_t with_sort_lanes(int width, F&& f) {
  switch (width) {
    case 64: return f(std::integral_constant<int, 2>());
    case 128: return f(std::integral_constant<int, 4>());
    case 256: return f(std::integral_constant<int, 8>());
    case 512: return f(std::integral_constant<int, 16>());
  }
  return f(std::integral_constant<int, 0>());
}

}  // namespace pgvt
