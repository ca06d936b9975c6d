// The body of kernels A and J, launched by row_gather.cu's two entry points:
// wg_row_gather (A, out-of-range ids clipped) and wg_row_gather_masked (J,
// out-of-range ids give a zero row and read nothing).
//
// One warp per output row, lanes across the row in vectors of `vec_bytes`
// (16 when the row and both base pointers allow it, so a 1 KB row is 64
// 16-byte loads, two per lane, all coalesced); a grid-stride loop over rows
// keeps the grid at a few waves of the card's SMs whatever n_ids is.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

template <typename V, bool kZeroInvalid>
__global__ void row_gather_kernel(const V* __restrict__ table,
                                  const void* __restrict__ ids, int ids64,
                                  V* __restrict__ out, int64_t n_rows,
                                  int64_t n_ids, int64_t vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_ids; i += n_warps) {
    int64_t id = ids64 ? static_cast<const int64_t*>(ids)[i]
                       : int64_t(static_cast<const int32_t*>(ids)[i]);
    V* dst = out + i * vecs_per_row;
    if (kZeroInvalid) {
      if (id < 0 || id >= n_rows) {
        for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = V();
        continue;
      }
    } else {
      id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    }
    const V* src = table + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

template <typename V, bool kZeroInvalid>
void launch_row_gather(const void* table, const void* ids, int ids64, void* out,
                       int64_t n_rows, int64_t n_ids, int64_t row_bytes,
                       cudaStream_t stream) {
  const int threads = 256;  // 8 warps, one row each per iteration
  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_gather_kernel<V, kZeroInvalid><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows,
      n_ids, row_bytes / int64_t(sizeof(V)));
}

// Checks the arguments, launches on `stream` and returns cudaGetLastError().
template <bool kZeroInvalid>
cudaError_t row_gather(const void* table, const void* ids, int ids64, void* out,
                       int64_t n_rows, int64_t n_ids, int64_t row_bytes, int vec_bytes,
                       cudaStream_t s) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes)
    return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: launch_row_gather<uint4, kZeroInvalid>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 8: launch_row_gather<uint2, kZeroInvalid>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 4: launch_row_gather<uint32_t, kZeroInvalid>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 2: launch_row_gather<uint16_t, kZeroInvalid>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 1: launch_row_gather<uint8_t, kZeroInvalid>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace wg
