// Kernel B: row scatter, table[ids[i]] = rows[i] in place, for ids in
// [0, n_rows); other ids are skipped. Ids in range must be unique: rows aimed
// at one id are written by different threads at once and may interleave vector
// by vector (the store's scatter keeps one writer per id first).
//
// Replaces the TPU's `_scatter_kernel` (wholegraph_tpu/ops/gather_pallas.py:102,
// launched from `scatter_rows_pallas3`) and, through route="masked",
// `_masked_scatter_kernel` (:1066, launched at :1712). The TPU wrote every slot,
// sending invalid ones to row 0 and repairing row 0 afterwards
// (embedding.py:219-252), because a per-DMA guard cost 2.7x there. On the GPU
// a skipped id costs its 4 or 8 bytes, so the apply passes -1 for padding and
// row 0 is never written by it.
//
// Bound: bytes. Each id read once, each valid row read once from `rows` and
// written once into `table`: n_ids * id_bytes + 2 * valid * row_bytes.
//
// Design (row_scatter.cuh, row_scatter_tile_kernel): a CTA of 256 threads per
// tile of `tile` ids (ops.gather_kernels.scatter_tile: as many as would fill
// SCATTER_TILE_BYTES = 64 KB were all valid, up to 512, 2 a thread). The
// threads load the tile's ids with coalesced loads, all in flight at once; a
// ballot a warp and one prefix over the warps' counts compact the valid ones
// into shared memory, with their positions, in batch order. Then the threads
// walk the flattened (valid row, vector) space, 4 loads of `rows` in flight a
// thread before any store: the pattern of direct_gather.cuh's drain with
// source and destination swapped. So a masked slot costs its id and nothing
// more, and a narrow valid row shares a CTA's loads with its neighbours.
//
// It replaced one warp a row (lanes across the row, one row in flight a warp,
// the grid capped at 132 x 32 CTAs; now kernel F's body, warp_row_scatter):
// its lanes sat idle at narrow rows (4 of 32 at 64 bytes) and each masked slot
// cost a warp one dependent id load. Measured on an H100 (device time of a
// CUDA graph of 20 calls; tools/kernel_variants.py and chip_smoke.py
// --paired-times hetero rows), on the hetero step's typed apply, 984,064
// slots a type into rows of 192 / 128 / 64 bytes with 240,291 / 25,185 /
// 1,520 of them valid: 0.0406 / 0.0045 / 0.0034 ms, 0.71 / 0.69 / 0.37 of the
// bound, where one warp a row took 0.1158 / 0.0446 / 0.0433; at the main
// step's 1 KB rows 0.1064 against 0.1066, at the store's masked write of 2^19
// slots 0.3483 against 0.3536. Against index_copy_ of the valid rows alone
// (0.0488 / 0.0037 / 0.0024): ahead at 192 bytes, behind where almost every
// slot is masked, because the 984,064 ids (3.9 MB, 1.2 us at the card's peak)
// are read whatever their share, and a launch costs about 2 us of its own.
// Kept out: 8 loads in flight a thread (3-27 % slower: 47-80 registers against
// 30-48 lose CTAs an SM), tiles of 1024 and 2048 ids (12-126 % slower than
// 512 on the masked narrow rows), tiles of 16-32 ids, which ran 1.5 % faster
// at 1 KB rows but 1.6-14 times slower at 64-192 bytes.

#include "row_scatter.cuh"

extern "C" int wg_row_scatter(void* table, const void* ids, int ids64,
                              const void* rows, int64_t n_rows, int64_t n_ids,
                              int64_t row_bytes, int vec_bytes, int tile, void* stream) {
  return int(wg::row_scatter(table, ids, ids64, rows, n_rows, n_ids, row_bytes, vec_bytes, tile,
                             static_cast<cudaStream_t>(stream)));
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
