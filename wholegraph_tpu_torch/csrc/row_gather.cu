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
// after it.
//
// Bound: bytes. The ids read once, each distinct table row read once and
// every output row written once (J reads nothing for an invalid id); there is
// no arithmetic. At D = 256 f32 a row is 1 KB, so the read is a random 1 KB
// burst per id.
//
// A's design: J's, under the clip rule. A CTA of 256 threads per tile of
// `tile` ids (ops.gather_kernels.gather_tile: as many as fill
// GATHER_TILE_BYTES = 8 KB of output, up to 1024, 4 a thread) reads them into
// shared memory, clipped (tile_id(..., 0)), then drains the tile's output, one
// contiguous block, with 4 or 8 vector loads in flight a thread before any
// store (direct_gather.cuh). It replaced one warp a row (lanes across the row,
// one row in flight a warp, the grid capped at 132 x 32 CTAs): at the hetero
// store's 64-192-byte rows only 4-12 of a warp's 32 lanes carried a load.
// Measured on an H100 (tools/kernel_variants.py, device time of a CUDA graph
// of 20 calls), at the hetero step's typed gathers of 984,064 ids into rows of
// 192 / 128 / 64 bytes: 0.0847 / 0.0483 / 0.0254 ms, 0.84 / 0.82 / 0.79 of the
// bound, where one warp a row took 0.1533 / 0.1231 / 0.1119; at the main
// step's 180,224 ids of 1 KB rows 0.1138 against 0.1180. Two thirds of those
// typed ids are -1, clipped onto row 0; the same slots spread over random rows
// take 0.1327 / 0.0788 / 0.0255 ms, so the repeated row costs nothing (it is
// a cache hit). Kept out: the tile's first row read once into shared memory
// for the slots that repeat it (3-7 % slower); tiles of 16 KB (within 1 %) and
// of 4, 32 and 64 KB (up to 24 % slower).
//
// J's design: kernel I's direct route (direct_gather.cuh), the same body I's
// direct tiles run. A CTA of 256 threads per tile of `tile` ids (8 KB of
// output, 8 ids of 1 KB rows) reads them into shared memory under the zero
// rule, then each thread keeps 4 or 8 vector loads in flight over the tile's
// flattened (row, vector) output before it stores any, all stores coalesced.
// No span, sector count or window: uniform ids have none to use. Kept out,
// measured on an H100 (tools/kernel_variants.py): streaming stores and
// read-only loads (no faster), persistent CTAs that prefetch the next
// tile's ids (5 % slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include "direct_gather.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernel A
// ---------------------------------------------------------------------------

constexpr int ROW_GATHER_MAX_TILE = 1024;  // ids a tile: 4 a thread at most

template <typename V, int U>
__global__ void __launch_bounds__(wg::GATHER_THREADS)
row_gather_kernel(const V* __restrict__ table, const void* __restrict__ ids, int ids64,
                  V* __restrict__ out, int64_t n_rows, int64_t n_ids, int vpr, int tile) {
  __shared__ int64_t tile_ids[ROW_GATHER_MAX_TILE];
  const int64_t t0 = int64_t(blockIdx.x) * tile;
  const int m = int(n_ids - t0 < tile ? n_ids - t0 : tile);
#pragma unroll 4
  for (int j = threadIdx.x; j < m; j += wg::GATHER_THREADS)
    tile_ids[j] = wg::tile_id(wg::load_id(ids, ids64, t0 + j), n_rows, 0);
  __syncthreads();
  wg::drain<V, U>(out + t0 * vpr, tile_ids, m, vpr,
                  [&](int64_t id, int v) { return table[id * vpr + v]; });
}

template <typename V>
void launch_row_gather(const void* table, const void* ids, int ids64, void* out,
                       int64_t n_rows, int64_t n_ids, int64_t row_bytes, int tile,
                       cudaStream_t stream) {
  const int vpr = int(row_bytes / int64_t(sizeof(V)));
  const unsigned blocks = unsigned((n_ids + tile - 1) / tile);
  auto kernel = wg::loads_in_flight(tile, vpr) == 8 ? row_gather_kernel<V, 8>
                                                     : row_gather_kernel<V, 4>;
  kernel<<<blocks, wg::GATHER_THREADS, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows, n_ids, vpr, tile);
}

// ---------------------------------------------------------------------------
// Kernel J
// ---------------------------------------------------------------------------

constexpr int MASKED_MAX_TILE = 256;  // ids a tile: one per thread at most

template <typename V, int U>
__global__ void __launch_bounds__(wg::GATHER_THREADS)
masked_gather_kernel(const V* __restrict__ table, const void* __restrict__ ids, int ids64,
                     V* __restrict__ out, int64_t n_rows, int64_t n_ids, int vpr, int tile) {
  __shared__ int64_t tile_ids[MASKED_MAX_TILE];
  const int64_t t0 = int64_t(blockIdx.x) * tile;
  const int m = int(n_ids - t0 < tile ? n_ids - t0 : tile);
  if (threadIdx.x < m)
    tile_ids[threadIdx.x] = wg::tile_id(wg::load_id(ids, ids64, t0 + threadIdx.x), n_rows, 1);
  __syncthreads();
  wg::drain<V, U>(out + t0 * vpr, tile_ids, m, vpr,
                  [&](int64_t id, int v) { return table[id * vpr + v]; });
}

template <typename V>
void launch_masked_gather(const void* table, const void* ids, int ids64, void* out,
                          int64_t n_rows, int64_t n_ids, int64_t row_bytes, int tile,
                          cudaStream_t stream) {
  const int vpr = int(row_bytes / int64_t(sizeof(V)));
  const unsigned blocks = unsigned((n_ids + tile - 1) / tile);
  auto kernel = wg::loads_in_flight(tile, vpr) == 8 ? masked_gather_kernel<V, 8>
                                                     : masked_gather_kernel<V, 4>;
  kernel<<<blocks, wg::GATHER_THREADS, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows, n_ids, vpr, tile);
}

}  // namespace

// tile: ids a CTA, 1..1024 (ops.gather_kernels.gather_tile); a tile's vectors,
// tile * row_bytes / vec_bytes, below 2^31.
extern "C" int wg_row_gather(const void* table, const void* ids, int ids64,
                             void* out, int64_t n_rows, int64_t n_ids,
                             int64_t row_bytes, int vec_bytes, int tile, void* stream) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes || tile <= 0 || tile > ROW_GATHER_MAX_TILE ||
      int64_t(tile) * (row_bytes / vec_bytes) >= (int64_t(1) << 31) ||
      (n_ids + tile - 1) / tile >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_row_gather<uint4>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 8: launch_row_gather<uint2>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 4: launch_row_gather<uint32_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 2: launch_row_gather<uint16_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 1: launch_row_gather<uint8_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// tile: ids a CTA, 1..256 (ops.gather_kernels.masked_tile); a tile's vectors,
// tile * row_bytes / vec_bytes, below 2^31.
extern "C" int wg_row_gather_masked(const void* table, const void* ids, int ids64,
                                    void* out, int64_t n_rows, int64_t n_ids,
                                    int64_t row_bytes, int vec_bytes, int tile, void* stream) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes || tile <= 0 || tile > MASKED_MAX_TILE ||
      int64_t(tile) * (row_bytes / vec_bytes) >= (int64_t(1) << 31) ||
      (n_ids + tile - 1) / tile >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_masked_gather<uint4>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 8: launch_masked_gather<uint2>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 4: launch_masked_gather<uint32_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 2: launch_masked_gather<uint16_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    case 1: launch_masked_gather<uint8_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
