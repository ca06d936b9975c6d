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
// Bound: bytes. Each output row is one table row read and one row written
// (2 * n_ids * row_bytes, plus the ids; J reads nothing for an invalid id);
// there is no arithmetic. At D = 256 f32 a row is 1 KB, so the read is a
// random 1 KB burst per id.
//
// A's design: one warp per output row, 16-byte vectors where the row and the
// pointers allow, a grid-stride loop over rows. A warp keeps only its row's
// vectors in flight (two 16-byte loads a lane at 1 KB rows), each stored
// before the next row's id is read.
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

template <typename V>
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
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    V* dst = out + i * vecs_per_row;
    const V* src = table + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

template <typename V>
void launch_row_gather(const void* table, const void* ids, int ids64, void* out,
                       int64_t n_rows, int64_t n_ids, int64_t row_bytes,
                       cudaStream_t stream) {
  const int threads = 256;  // 8 warps, one row each per iteration
  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_gather_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows,
      n_ids, row_bytes / int64_t(sizeof(V)));
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

extern "C" int wg_row_gather(const void* table, const void* ids, int ids64,
                             void* out, int64_t n_rows, int64_t n_ids,
                             int64_t row_bytes, int vec_bytes, void* stream) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_row_gather<uint4>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 8: launch_row_gather<uint2>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 4: launch_row_gather<uint32_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 2: launch_row_gather<uint16_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 1: launch_row_gather<uint8_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
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
