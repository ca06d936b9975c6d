// Row scatters: table[ids[i]] = rows[i] for ids in [0, n_rows); other ids are
// skipped. Two bodies:
//
// * row_scatter (kernel B, row_scatter.cu, a table in device memory): tiles
//   of ids compacted in shared memory, then a flattened walk over the valid
//   rows. See row_scatter.cu for its design and measurements.
// * warp_row_scatter (kernel F, host_rows.cu, a pinned host table through its
//   mapped device address): one warp per row, lanes across the row in
//   vectors of `vec_bytes`, a grid-stride loop over rows. This was kernel B's
//   body before B's tiles; F keeps it, since its writes cross the host link,
//   which bounds it (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "direct_gather.cuh"

namespace wg {

// ---------------------------------------------------------------------------
// Kernel B: compacted tiles
// ---------------------------------------------------------------------------

constexpr int SCATTER_MAX_TILE = 512;  // ids a CTA: 2 a thread at most
constexpr int SCATTER_WARPS = GATHER_THREADS / 32;
constexpr int SCATTER_LOADS = 4;  // loads of `rows` in flight a thread

// A CTA of GATHER_THREADS threads owns `tile` consecutive ids. Each thread
// loads its IPT ids (coalesced, all in flight together); a ballot a warp and
// one exclusive prefix over the warps' counts give each valid id its place,
// so shared memory holds the tile's valid (id, position) pairs in batch
// order. Then the threads walk the flattened (valid row, vector) space:
// SCATTER_LOADS loads of `rows` in flight a thread before any store into
// `table`. A slot outside [0, n_rows) costs its id and nothing more.
template <typename V, int IPT>
__global__ void __launch_bounds__(GATHER_THREADS)
row_scatter_tile_kernel(V* __restrict__ table, const void* __restrict__ ids, int ids64,
                        const V* __restrict__ rows, int64_t n_rows, int64_t n_ids, int vpr,
                        int tile) {
  constexpr int U = SCATTER_LOADS;
  constexpr int NC = IPT * SCATTER_WARPS;  // counts: chunk-major, warp-minor
  static_assert(NC <= 32, "one count a lane");
  __shared__ int offs[NC + 1];
  extern __shared__ __align__(16) unsigned char scatter_smem[];
  int64_t* tile_dst = reinterpret_cast<int64_t*>(scatter_smem);  // [tile] valid ids
  int* tile_src = reinterpret_cast<int*>(tile_dst + tile);        // [tile] their positions
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = int64_t(blockIdx.x) * tile;
  const int m_ids = int(n_ids - t0 < tile ? n_ids - t0 : tile);

  int64_t id[IPT];
#pragma unroll
  for (int c = 0; c < IPT; ++c) {
    const int j = c * GATHER_THREADS + tid;
    id[c] = j < m_ids ? load_id(ids, ids64, t0 + j) : -1;
  }
  unsigned ball[IPT];
#pragma unroll
  for (int c = 0; c < IPT; ++c) {
    ball[c] = __ballot_sync(0xffffffffu, id[c] >= 0 && id[c] < n_rows);
    if (lane == 0) offs[c * SCATTER_WARPS + warp] = __popc(ball[c]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix over the NC <= 32 counts, one a lane
    const int mine = lane < NC ? offs[lane] : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < NC) offs[lane] = incl - mine;
    if (lane == 31) offs[NC] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < IPT; ++c)
    if ((ball[c] >> lane) & 1u) {
      const int p = offs[c * SCATTER_WARPS + warp] + __popc(ball[c] & below);
      tile_dst[p] = id[c];
      tile_src[p] = c * GATHER_THREADS + tid;
    }
  const int m = offs[NC];
  __syncthreads();

  const V* src = rows + t0 * vpr;
  const int total = m * vpr;
  const int q = GATHER_THREADS / vpr, r = GATHER_THREADS % vpr;
  int i = tid / vpr, v = tid % vpr;
  for (int k0 = tid; k0 < total; k0 += GATHER_THREADS * U) {
    V val[U];
    const int i0 = i, v0 = v;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * GATHER_THREADS < total) val[u] = src[int64_t(tile_src[i]) * vpr + v];
      i += q;
      v += r;
      if (v >= vpr) {
        v -= vpr;
        ++i;
      }
    }
    i = i0;  // the same (row, vector) steps again for the stores
    v = v0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * GATHER_THREADS < total) table[tile_dst[i] * vpr + v] = val[u];
      i += q;
      v += r;
      if (v >= vpr) {
        v -= vpr;
        ++i;
      }
    }
  }
}

template <typename V>
void launch_row_scatter(void* table, const void* ids, int ids64, const void* rows,
                        int64_t n_rows, int64_t n_ids, int64_t row_bytes, int tile,
                        cudaStream_t stream) {
  const int vpr = int(row_bytes / int64_t(sizeof(V)));
  const unsigned blocks = unsigned((n_ids + tile - 1) / tile);
  const size_t smem = size_t(tile) * (sizeof(int64_t) + sizeof(int));
  auto kernel = tile > GATHER_THREADS ? row_scatter_tile_kernel<V, 2>
                                      : row_scatter_tile_kernel<V, 1>;
  kernel<<<blocks, GATHER_THREADS, smem, stream>>>(static_cast<V*>(table), ids, ids64,
                                                   static_cast<const V*>(rows), n_rows, n_ids,
                                                   vpr, tile);
}

// Checks the arguments, launches on `stream` and returns cudaGetLastError().
// tile: ids a CTA, 1..SCATTER_MAX_TILE (ops.gather_kernels.scatter_tile); a
// tile's vectors, tile * row_bytes / vec_bytes, below 2^31.
inline cudaError_t row_scatter(void* table, const void* ids, int ids64, const void* rows,
                               int64_t n_rows, int64_t n_ids, int64_t row_bytes, int vec_bytes,
                               int tile, cudaStream_t s) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes || tile <= 0 || tile > SCATTER_MAX_TILE ||
      int64_t(tile) * (row_bytes / vec_bytes) >= (int64_t(1) << 31) ||
      (n_ids + tile - 1) / tile >= (int64_t(1) << 31))
    return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: launch_row_scatter<uint4>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, tile, s); break;
    case 8: launch_row_scatter<uint2>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, tile, s); break;
    case 4: launch_row_scatter<uint32_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, tile, s); break;
    case 2: launch_row_scatter<uint16_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, tile, s); break;
    case 1: launch_row_scatter<uint8_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, tile, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel F's body: one warp a row
// ---------------------------------------------------------------------------

template <typename V>
__global__ void warp_row_scatter_kernel(V* __restrict__ table,
                                        const void* __restrict__ ids, int ids64,
                                        const V* __restrict__ rows, int64_t n_rows,
                                        int64_t n_ids, int64_t vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_ids; i += n_warps) {
    const int64_t id = load_id(ids, ids64, i);
    if (id < 0 || id >= n_rows) continue;
    const V* src = rows + i * vecs_per_row;
    V* dst = table + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

template <typename V>
void launch_warp_row_scatter(void* table, const void* ids, int ids64, const void* rows,
                             int64_t n_rows, int64_t n_ids, int64_t row_bytes,
                             cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  warp_row_scatter_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<V*>(table), ids, ids64, static_cast<const V*>(rows), n_rows,
      n_ids, row_bytes / int64_t(sizeof(V)));
}

// Checks the arguments, launches on `stream` and returns cudaGetLastError().
inline cudaError_t warp_row_scatter(void* table, const void* ids, int ids64, const void* rows,
                                    int64_t n_rows, int64_t n_ids, int64_t row_bytes,
                                    int vec_bytes, cudaStream_t s) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes)
    return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: launch_warp_row_scatter<uint4>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 8: launch_warp_row_scatter<uint2>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 4: launch_warp_row_scatter<uint32_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 2: launch_warp_row_scatter<uint16_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    case 1: launch_warp_row_scatter<uint8_t>(table, ids, ids64, rows, n_rows, n_ids, row_bytes, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace wg
