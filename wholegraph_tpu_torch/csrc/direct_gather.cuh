// The direct drain of a row gather, shared by kernel I (sorted_gather.cu, the
// tiles it reads directly and, out of shared memory, the tiles it windows),
// kernel J (row_gather.cu, wg_row_gather_masked, every tile) and kernel A
// (row_gather.cu, wg_row_gather, every tile, under the clip rule). Kernel B
// (row_scatter.cuh) walks its valid rows in the same order with source and
// destination swapped, and takes load_id and loads_in_flight from here.
//
// A CTA of GATHER_THREADS threads owns a tile of consecutive ids. It reads
// them into shared memory under the id rule (tile_id), then walks the tile's
// output, one contiguous block of m * row_bytes, with a flattened (row,
// vector) index spread over all threads: each thread keeps U vector loads in
// flight before it stores any of them, and the stores are coalesced for any
// row width. U is 8 where the tile holds 8 or more vectors a thread (1 KB rows
// in tiles of 32) and 4 below: at 8 the 16-byte kernel takes 52 registers
// against 32, so half the CTAs an SM, which lost at 64-byte rows and won at
// 1 KB rows (kernel I, PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int GATHER_THREADS = 256;

__device__ __forceinline__ int64_t load_id(const void* ids, int ids64, int64_t i) {
  return ids64 ? static_cast<const int64_t*>(ids)[i]
               : int64_t(static_cast<const int32_t*>(ids)[i]);
}

// The id rule: an id in [0, n_rows) is itself; any other is clipped into
// range, or, with `zero_invalid`, becomes -1, a zero row that reads nothing.
__device__ __forceinline__ int64_t tile_id(int64_t id, int64_t n_rows, int zero_invalid) {
  if (id < 0 || id >= n_rows) id = zero_invalid ? -1 : (id < 0 ? 0 : n_rows - 1);
  return id;
}

// Loads in flight a thread for a tile of `tile` rows of `vpr` vectors.
__host__ __device__ __forceinline__ int loads_in_flight(int64_t tile, int64_t vpr) {
  return tile * vpr >= 8 * GATHER_THREADS ? 8 : 4;
}

// Walks the tile's output vectors k = tid, tid + GATHER_THREADS, ... in
// batches of U: `load(id, v)` for each (its row id, vector) before any store.
template <typename V, int U, typename Load>
__device__ __forceinline__ void drain(V* __restrict__ dst, const int64_t* tile_ids, int m, int vpr,
                                      Load load) {
  const int total = m * vpr;
  const int q = GATHER_THREADS / vpr, r = GATHER_THREADS % vpr;
  int i = threadIdx.x / vpr, v = threadIdx.x % vpr;
  for (int k0 = threadIdx.x; k0 < total; k0 += GATHER_THREADS * U) {
    V val[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      val[u] = V();
      if (k0 + u * GATHER_THREADS < total) {
        const int64_t id = tile_ids[i];
        if (id >= 0) val[u] = load(id, v);
      }
      i += q;
      v += r;
      if (v >= vpr) {
        v -= vpr;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u * GATHER_THREADS < total) dst[k0 + u * GATHER_THREADS] = val[u];
  }
}

}  // namespace wg
