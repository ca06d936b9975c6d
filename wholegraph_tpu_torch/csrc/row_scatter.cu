// Kernel B: row scatter, table[ids[i]] = rows[i] in place, for ids in
// [0, n_rows); other ids are skipped. Ids in range must be unique: rows aimed
// at one id are written by different warps at once and may interleave vector
// by vector (the store's scatter keeps one writer per id first).
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
// pointers allow, a grid-stride loop over rows. The body is in
// row_scatter.cuh, which kernel F (host_rows.cu) launches as well.

#include "row_scatter.cuh"

extern "C" int wg_row_scatter(void* table, const void* ids, int ids64,
                              const void* rows, int64_t n_rows, int64_t n_ids,
                              int64_t row_bytes, int vec_bytes, void* stream) {
  return int(wg::row_scatter(table, ids, ids64, rows, n_rows, n_ids, row_bytes, vec_bytes,
                             static_cast<cudaStream_t>(stream)));
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
