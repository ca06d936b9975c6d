// Kernel A: row gather, out[i] = table[clamp(ids[i], 0, n_rows - 1)].
// Kernel J: masked row gather, out[i] = table[ids[i]] for ids in [0, n_rows),
// a zero row with no table read for any other id.
//
// A replaces the TPU's `_gather_kernel` (wholegraph_tpu/ops/gather_pallas.py:35,
// launched from `_gather_rows_pallas3_impl`), which walked a ring of per-row
// DMAs over an SMEM block of ids padded to multiples of 1024, on the native
// [N, D//128, 128] layout. On Hopper the table is flat [N, D] and the ids are
// read by the block itself. Clip semantics keep every read in bounds, as the
// TPU's did.
//
// J replaces the TPU's `_masked_gather_kernel` (gather_pallas.py:1028,
// launched from `gather_rows_masked`), the same DMA ring with each DMA issued
// only for a slot >= 0 and the skipped rows left as garbage. J writes zeros
// there instead, inside that contract, so a store serve needs no masking pass
// after it; a skipped row costs one predicate per warp and its write.
//
// Bound: bytes. Each output row is one table row read and one row written
// (2 * n_ids * row_bytes, plus the ids; J reads nothing for an invalid id);
// there is no arithmetic. At D = 256 f32 a row is 1 KB, so the read is a
// random 1 KB burst per id.
//
// Design: one warp per output row, 16-byte vectors where the row and the
// pointers allow, a grid-stride loop over rows. The body is in row_gather.cuh.

#include "row_gather.cuh"

extern "C" int wg_row_gather(const void* table, const void* ids, int ids64,
                             void* out, int64_t n_rows, int64_t n_ids,
                             int64_t row_bytes, int vec_bytes, void* stream) {
  return int(wg::row_gather<false>(table, ids, ids64, out, n_rows, n_ids, row_bytes, vec_bytes,
                                   static_cast<cudaStream_t>(stream)));
}

extern "C" int wg_row_gather_masked(const void* table, const void* ids, int ids64,
                                    void* out, int64_t n_rows, int64_t n_ids,
                                    int64_t row_bytes, int vec_bytes, void* stream) {
  return int(wg::row_gather<true>(table, ids, ids64, out, n_rows, n_ids, row_bytes, vec_bytes,
                                  static_cast<cudaStream_t>(stream)));
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
