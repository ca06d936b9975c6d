// Kernel B: row scatter, table[ids[i]] = rows[i] in place, for ids in
// [0, n_rows); other ids are skipped. With duplicate ids the winner is
// unspecified, as on the TPU.
//
// Replaces the TPU's `_scatter_kernel` (wholegraph_tpu/ops/gather_pallas.py:102,
// launched from `scatter_rows_pallas3`). The TPU wrote every slot, sending
// invalid ones to row 0 and repairing row 0 afterwards (embedding.py:219-252),
// because a per-DMA guard cost 2.7x there. On the GPU a skipped id is one
// predicate per warp, so the apply passes -1 for padding and row 0 is never
// written by it.
//
// Bound: bytes (n_ids * row_bytes read, the same written, plus the ids).
// Design: the layout of kernel A (row_gather.cu) with the roles of the
// pointers swapped: one warp per row, 16-byte vectors where the row and
// pointers allow, a grid-stride loop over rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
void launch(void* table, const void* ids, int ids64, const void* rows,
            int64_t n_rows, int64_t n_ids, int64_t row_bytes,
            cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_scatter_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<V*>(table), ids, ids64, static_cast<const V*>(rows), n_rows,
      n_ids, row_bytes / int64_t(sizeof(V)));
}

}  // namespace

extern "C" int wg_row_scatter(void* table, const void* ids, int ids64,
                              const void* rows, int64_t n_rows, int64_t n_ids,
                              int64_t row_bytes, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes)
    return int(cudaErrorInvalidValue);
  switch (vec_bytes) {
    case 16: launch<uint4>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 8: launch<uint2>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 4: launch<uint32_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 2: launch<uint16_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 1: launch<uint8_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
