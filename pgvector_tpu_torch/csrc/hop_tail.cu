// K2's tail as its own entry — the hop tail of the packed HNSW beam search
// over distances scored elsewhere.
//
// Replaces the Pallas kernel pgvector_tpu/ops/pallas_hop.py:_tail_kernel
// (driven by hop_tail, sorting with _bitonic_sort).  The search itself runs
// the whole hop in packed_hop.cu; this entry merges given candidate
// distances into the pool, and is held bit for bit against its plain
// version (two stable sorts, ops/hop_tail.py).
//
// What bounds it on an H100: latency, not bytes or flops — width*log^2
// (width) compare-exchanges per row with no arithmetic, and a few KB of
// input per row.  Design: one block per query row; the lanes are sorted in
// registers and warp shuffles, with shared memory only for the stages
// that cross warps (hop_merge.cuh).

#include "hop_merge.cuh"

namespace {

template <int R>
__global__ void hop_tail_kernel(const float* __restrict__ pool_d,
                                const int* __restrict__ pool_p,
                                const float* __restrict__ cand_d,
                                const int* __restrict__ cand_i, int ef, int w,
                                int width, float* __restrict__ out_d,
                                int* __restrict__ out_p) {
  extern __shared__ int sm[];
  float* s_d = reinterpret_cast<float*>(sm);  // [width]
  int* s_pk = sm + width;                     // [width]
  int* xbuf = sm + 2 * width;                 // merge_xbuf_bytes(width)
  const size_t row = blockIdx.x;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float dv = pgvt::BIG;
    int pk = -2;
    if (e < ef) {
      pk = pool_p[row * ef + e];
      dv = pool_d[row * ef + e];
    } else if (e < ef + w) {
      pk = cand_i[row * w + (e - ef)] * 2;
      dv = cand_d[row * w + (e - ef)];
    }
    s_d[e] = dv;
    s_pk[e] = pk;
  }
  __syncthreads();
  pgvt::hop_merge<R>(s_d, s_pk, xbuf, width, ef, out_d + row * ef,
                     out_p + row * ef);
}

template <int R>
cudaError_t launch(const float* pool_d, const int* pool_p, const float* cand_d,
                   const int* cand_i, int q, int ef, int w, int width,
                   float* out_d, int* out_p, cudaStream_t st) {
  const size_t smem = sizeof(int) * 2 * (size_t)width +
                      pgvt::merge_xbuf_bytes(width);
  cudaError_t err = cudaFuncSetAttribute(
      hop_tail_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  hop_tail_kernel<R><<<q, width / R, smem, st>>>(pool_d, pool_p, cand_d,
                                                 cand_i, ef, w, width, out_d,
                                                 out_p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pgvt_hop_tail(const float* pool_d, const int* pool_p,
                             const float* cand_d, const int* cand_i, int q,
                             int ef, int w, float* out_d, int* out_p,
                             void* stream) {
  const int width = pgvt::merge_width(ef, w);
  if (ef < 1 || w < 0 || width == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pgvt::merge_lanes(width)) {
    case 2: return (int)launch<2>(pool_d, pool_p, cand_d, cand_i, q, ef, w,
                                  width, out_d, out_p, st);
    case 4: return (int)launch<4>(pool_d, pool_p, cand_d, cand_i, q, ef, w,
                                  width, out_d, out_p, st);
    case 8: return (int)launch<8>(pool_d, pool_p, cand_d, cand_i, q, ef, w,
                                  width, out_d, out_p, st);
    case 16: return (int)launch<16>(pool_d, pool_p, cand_d, cand_i, q, ef, w,
                                    width, out_d, out_p, st);
    case 32: return (int)launch<32>(pool_d, pool_p, cand_d, cand_i, q, ef, w,
                                    width, out_d, out_p, st);
  }
  return (int)cudaErrorInvalidValue;
}
