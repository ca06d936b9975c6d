// The body of kernel B, shared by its two entry points: wg_row_scatter
// (row_scatter.cu, a table in device memory) and wg_host_scatter (host_rows.cu,
// kernel F, a pinned host table through its mapped device address).
//
// table[ids[i]] = rows[i] for ids in [0, n_rows); other ids are skipped. One
// warp per row, lanes across the row in vectors of `vec_bytes`, a grid-stride
// loop over rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

template <typename V>
__global__ void row_scatter_kernel(V* __restrict__ table,
                                   const void* __restrict__ ids, int ids64,
                                   const V* __restrict__ rows, int64_t n_rows,
                                   int64_t n_ids, int64_t vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_ids; i += n_warps) {
    const int64_t id = ids64 ? static_cast<const int64_t*>(ids)[i]
                             : int64_t(static_cast<const int32_t*>(ids)[i]);
    if (id < 0 || id >= n_rows) continue;
    const V* src = rows + i * vecs_per_row;
    V* dst = table + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

template <typename V>
void launch_row_scatter(void* table, const void* ids, int ids64, const void* rows,
                        int64_t n_rows, int64_t n_ids, int64_t row_bytes,
                        cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_scatter_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<V*>(table), ids, ids64, static_cast<const V*>(rows), n_rows,
      n_ids, row_bytes / int64_t(sizeof(V)));
}

// Checks the arguments, launches on `stream` and returns cudaGetLastError().
inline cudaError_t row_scatter(void* table, const void* ids, int ids64, const void* rows,
                               int64_t n_rows, int64_t n_ids, int64_t row_bytes,
                               int vec_bytes, cudaStream_t s) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes)
    return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: launch_row_scatter<uint4>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 8: launch_row_scatter<uint2>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 4: launch_row_scatter<uint32_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 2: launch_row_scatter<uint16_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 1: launch_row_scatter<uint8_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace wg
