// Kernel D: fused masked neighbour sum / mean over a padded [B, K] block,
//   out[b] = sum_k mask[b, k] * x[clamp(nbr[b, k], 0, U - 1)]
// accumulated in f32; the mean divides by max(sum_k mask[b, k], 1). The
// output has x's dtype (f32 or bf16).
//
// Replaces `_fused_agg_kernel` (wholegraph_tpu/ops/spmm_pallas.py:42, through
// `fused_padded_sum`) and the route the TPU took instead of it on the
// sampled path, `_gather_kernel` plus an XLA sum over K (ops/spmm.py:57-85).
// The TPU routed masked slots to an appended zero row so that every DMA was
// unconditional; here a masked slot is simply skipped and no zero row exists.
// This is the reference WholeGraph's fused `agg_concat_n2n` aggregation.
//
// Bound: bytes. Each valid edge reads one row of x (random, D * itemsize
// bytes); the ids and mask are read once and each output row written once.
// Unlike the gather-then-reduce route, the [B, K, D] intermediate never
// touches device memory.
//
// Design: one warp per centre b; lanes across D in 16-byte vectors (4 f32 or
// 8 bf16) where D and the pointers allow, single elements otherwise; an
// inner loop over K accumulates in registers. A D wider than one warp-vector
// (D = 256 f32 is two) walks the row in chunks, re-reading the ids and mask
// from L1. A grid-stride loop over centres.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void neighbor_agg_kernel(const T* __restrict__ x, int64_t n_rows,
                                    int64_t D, const int32_t* __restrict__ nbr,
                                    const uint8_t* __restrict__ mask,
                                    T* __restrict__ out, int64_t B, int64_t K,
                                    int mean) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t b = warp; b < B; b += n_warps) {
    const int32_t* nb = nbr + b * K;
    const uint8_t* mb = mask + b * K;
    float denom = 1.0f;
    if (mean) {
      int cnt = 0;
      for (int64_t k = 0; k < K; ++k) cnt += mb[k] != 0;
      denom = float(cnt > 1 ? cnt : 1);
    }
    for (int64_t c = int64_t(lane) * VEC; c < D; c += 32 * VEC) {
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int64_t k = 0; k < K; ++k) {
        if (!mb[k]) continue;
        int64_t id = nb[k];
        id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
        const Pack<T, VEC> p =
            *reinterpret_cast<const Pack<T, VEC>*>(x + id * D + c);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += to_f32(p.v[j]);
      }
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f32<T>(mean ? acc[j] / denom : acc[j]);
      *reinterpret_cast<Pack<T, VEC>*>(out + b * D + c) = o;
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, int64_t n_rows, int64_t D, const void* nbr,
            const void* mask, void* out, int64_t B, int64_t K, int mean,
            cudaStream_t stream) {
  const int threads = 256;  // 8 warps, one centre each per iteration
  int64_t blocks = (B + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  neighbor_agg_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), n_rows, D, static_cast<const int32_t*>(nbr),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), B, K, mean);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. vec: elements per load (16 bytes' worth, or 1).
extern "C" int wg_neighbor_agg(const void* x, int64_t n_rows, int64_t D,
                               const void* nbr, const void* mask, void* out,
                               int64_t B, int64_t K, int mean, int dtype,
                               int vec, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0 || n_rows <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    launch<float, 4>(x, n_rows, D, nbr, mask, out, B, K, mean, s);
  else if (dtype == 0 && vec == 1)
    launch<float, 1>(x, n_rows, D, nbr, mask, out, B, K, mean, s);
  else if (dtype == 1 && vec == 8)
    launch<__nv_bfloat16, 8>(x, n_rows, D, nbr, mask, out, B, K, mean, s);
  else if (dtype == 1 && vec == 1)
    launch<__nv_bfloat16, 1>(x, n_rows, D, nbr, mask, out, B, K, mean, s);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
