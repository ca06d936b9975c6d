// What kernels G (csr_spmm.cu) and H (csr_sddmm.cu) share: the window rule,
// here and nowhere else, and the helpers around it (the copies into shared
// memory are async_copy.cuh's, shared with kernel I).
//
// Both kernels cut a destination-sorted CSR into tiles of `tile` consecutive
// destination rows. A tile is staged when its source rows fit a shared-memory
// window: it has at least one and at most `edge_cap` edges, and its clamped
// columns span fewer than `window` rows (hi - lo < window). Its source rows
// x[lo..hi] (G) or b[lo..hi] (H) are then copied into shared memory once, in
// column slabs, instead of being read from L2 once per edge. Any other tile (a
// random CSR, a row longer than the cap, an empty tile) is computed from
// device memory. A window of 0 stages nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace wg {

constexpr int SLAB_BYTES = 128;  // bytes of a source row in one shared-memory slab

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ int32_t clamp_col(int64_t c, int64_t n_src) {
  return int32_t(c < 0 ? 0 : (c >= n_src ? n_src - 1 : c));
}

__device__ __forceinline__ void add_stat(unsigned long long* stats, int i, int64_t v) {
  if (stats) atomicAdd(stats + i, static_cast<unsigned long long>(v));
}

// The window rule for the tile whose `ne` edges start at col[e0]. Every thread
// of the CTA (THREADS of them) calls it with the same arguments. Returns true
// when the tile is staged, with its least and greatest clamped column in lo,
// hi (reduced only for a tile within the edge cap).
template <int THREADS>
__device__ __forceinline__ bool tile_staged(const int32_t* __restrict__ col, int32_t e0,
                                            int64_t ne, int64_t n_src, int window, int edge_cap,
                                            int32_t& lo, int32_t& hi) {
  __shared__ int32_t red_lo[THREADS / 32], red_hi[THREADS / 32];
  if (ne <= 0 || ne > edge_cap) return false;
  const int tid = threadIdx.x;
  int32_t l = INT_MAX, h = -1;
  for (int i = tid; i < ne; i += THREADS) {
    const int32_t c = clamp_col(col[e0 + i], n_src);
    l = c < l ? c : l;
    h = c > h ? c : h;
  }
  for (int o = 16; o; o >>= 1) {
    const int32_t ol = __shfl_xor_sync(0xffffffffu, l, o);
    const int32_t oh = __shfl_xor_sync(0xffffffffu, h, o);
    l = ol < l ? ol : l;
    h = oh > h ? oh : h;
  }
  if ((tid & 31) == 0) {
    red_lo[tid >> 5] = l;
    red_hi[tid >> 5] = h;
  }
  __syncthreads();
  lo = red_lo[0];
  hi = red_hi[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    lo = red_lo[w] < lo ? red_lo[w] : lo;
    hi = red_hi[w] > hi ? red_hi[w] : hi;
  }
  return int64_t(hi) - lo < window;
}

}  // namespace wg
