// Kernel C: sampled-column fetch,
//   nbrs[b, k] = mask[b, k] ? col[clamp(start[b] + pos[b, k], 0, E - 1)] : -1
// for any fanout K.
//
// Replaces the pair of TPU kernels that did this job together:
// `_gather_slab_kernel` (wholegraph_tpu/ops/gather_pallas.py:346), which DMAd
// each centre's enclosing 128-lane blocks of `col` into a [B, nb*128] slab,
// and `_select_lanes_kernel` (gather_pallas.py:445), which picked lane
// loc[b, k] out of that slab and asserted K <= 128 (gather_pallas.py:482).
// The block and lane arithmetic existed because a TPU DMA moves 128-lane
// rows; a GPU thread loads one 4-byte element directly, so there is neither a
// slab nor a limit on K.
//
// Bound: bytes, and at the main path's shapes latency: B*K*(4 + 1 + 4) bytes
// of positions, mask and output plus 4 bytes of `col` per valid slot, about
// 2 MB at B = 11264, K = 15. Design: one thread per (b, k), a grid-stride
// loop; the positions and the mask are read coalesced, the `col` reads are
// random 4-byte loads. Fusing the selection-sampling fixpoint that produces
// `pos` into this kernel is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sample_cols_kernel(const int32_t* __restrict__ col,
                                   int64_t n_edges,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ pos,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ out, int64_t B,
                                   int64_t K) {
  const int64_t total = B * K;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    int32_t v = -1;
    if (mask[t]) {
      int64_t e = int64_t(start[t / K]) + int64_t(pos[t]);
      e = e < 0 ? 0 : (e >= n_edges ? n_edges - 1 : e);
      v = col[e];
    }
    out[t] = v;
  }
}

}  // namespace

extern "C" int wg_sample_cols(const void* col, int64_t n_edges,
                              const void* start, const void* pos,
                              const void* mask, void* out, int64_t B,
                              int64_t K, void* stream) {
  if (B <= 0 || K <= 0 || n_edges <= 0) return int(cudaErrorInvalidValue);
  const int threads = 256;
  int64_t blocks = (B * K + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  sample_cols_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col), n_edges,
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(out), B, K);
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
