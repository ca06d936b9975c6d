// Kernel I: sorted-window gather, out[i] = table[ids[i]], exact for any ids
// and fastest for sorted, dense ones. An id outside [0, n_rows) is clipped
// into range, or, with `zero_invalid`, gives a zero row and reads nothing.
//
// Replaces the TPU's `_window_gather_kernel` (wholegraph_tpu/ops/gather_pallas.py:560,
// launched from `gather_rows_window` and served by `local_take_sorted`, :913).
// There, each step of tile*group sorted ids DMAs one window of table rows into
// VMEM and selects its rows with a bit-exact one-hot matmul on the MXU; an id
// outside its window comes back as a zero row and a second pass repairs it
// with the single-row ring (:789-832). The one-hot select existed because a
// TPU core has no cheap per-row indexing out of VMEM; an SM reads shared
// memory at any address, so here a row is simply copied out of the window, and
// a tile the window does not serve is read from device memory in the same
// pass: nothing is repaired afterwards.
//
// Bound: bytes. The least the card can do is read each distinct row once and
// write each output row once (plus the ids); there is no arithmetic, and no
// float is ever formed, so NaN payloads, -0 and denormals pass unchanged. A
// window reads the whole span [lo, hi] of a tile, 1/d rows per useful row at
// id density d; direct reads fetch each id's row, in whole 32-byte sectors,
// so a narrow row costs the sectors it touches, not its bytes. Which moves
// fewer bytes is a property of each tile, so each tile decides.
//
// Design: one CTA of 256 threads per tile of `tile` consecutive ids.
//  1. The CTA reads its ids into shared memory (int64), applying the clip or
//     the zero rule, and reduces the least and greatest valid id, lo and hi,
//     the number of valid ids, and the 32-byte sectors their rows touch.
//  2. The rule, here and nowhere else: the tile is windowed when its span
//     fits the window (hi - lo < window) and the span's sectors do not exceed
//     the direct reads' sectors; otherwise it is read directly. A tile of
//     duplicates or of consecutive ids takes the window; a sparse tile reads
//     directly, moving 1/d fewer bytes at density d and skipping the barrier
//     between a window's fill and its drain. Measured on an H100 (PERF.md):
//     at 64-byte rows direct reads beat the window at densities 0.8 to
//     0.2 although they make a request a row, so sectors, not 128-byte
//     lines, are the unit.
//  3. Direct route: the shared drain of direct_gather.cuh (also kernel J's),
//     8 loads in flight a thread where the tile holds 8 or more vectors a
//     thread (1 KB rows in tiles of 32), else 4.
//  4. Window route: the span arrives by `cp.async` (16-, 8- or 4-byte, plain
//     loads for narrower vectors), one barrier, then the same drain out of
//     shared memory. Not by `cp.async.bulk` chunks on mbarriers: on device
//     memory they were no faster (3 % slower at 64-byte rows, equal at 1 KB).
//  5. Either way the tile's output, one contiguous block of m * row_bytes, is
//     written with the flattened index spread over all threads: coalesced
//     stores for any row width.
// Shared memory holds tile * 8 bytes of ids and window * row_bytes of rows;
// above 48 KB the entry point raises the kernel's dynamic shared-memory limit
// first. Span and address arithmetic is in int64. With a `stats` pointer the
// CTA adds to stats[0] 1 if it windowed, to stats[1] 1 if it read directly,
// and to stats[2] the bytes it asked of device memory (the span's bytes, or
// its valid ids' rows); the order of those atomics changes nothing but the
// counts' arrival, and the gathered rows do not depend on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "direct_gather.cuh"

namespace {

using wg::copy_to_shared;
using wg::drain;
using wg::MAX_DYNAMIC_SMEM;
constexpr int THREADS = wg::GATHER_THREADS;
constexpr int WARPS = THREADS / 32;

// 32-byte sectors touched by bytes [a, a + n), n > 0
__device__ __forceinline__ int64_t sectors(uint64_t a, uint64_t n) {
  return int64_t(((a + n - 1) >> 5) - (a >> 5) + 1);
}

// bytes of the ids' part of shared memory, rounded up so the window starts 16-byte aligned
__host__ __device__ __forceinline__ int64_t ids_bytes(int tile) {
  return (int64_t(tile) * 8 + 15) / 16 * 16;
}

template <typename V, int U>
__global__ void __launch_bounds__(THREADS)
sorted_gather_kernel(const V* __restrict__ table, const void* __restrict__ ids, int ids64,
                     V* __restrict__ out, int64_t n_rows, int64_t n_ids, int vpr, int tile,
                     int window, int zero_invalid, unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* tile_ids = reinterpret_cast<int64_t*>(smem);
  V* win = reinterpret_cast<V*>(smem + ids_bytes(tile));
  __shared__ int64_t red_lo[WARPS], red_hi[WARPS];
  __shared__ uint32_t red_sec[WARPS], red_n[WARPS];

  const int64_t t0 = int64_t(blockIdx.x) * tile;
  const int m = int(n_ids - t0 < tile ? n_ids - t0 : tile);
  const int64_t rb = int64_t(vpr) * int64_t(sizeof(V));
  const uint64_t base = reinterpret_cast<uint64_t>(table);

  // 1. ids; the least and greatest valid one, their count and their rows'
  //    sectors (below 2^31: the launch keeps tile * 8 bytes within shared
  //    memory and tile * row_bytes / 16 below 2^31)
  int64_t lo = INT64_MAX, hi = -1;
  uint32_t sec = 0, nv = 0;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const int64_t id = wg::tile_id(wg::load_id(ids, ids64, t0 + i), n_rows, zero_invalid);
    tile_ids[i] = id;
    if (id >= 0) {
      lo = id < lo ? id : lo;
      hi = id > hi ? id : hi;
      sec += uint32_t(sectors(base + uint64_t(id * rb), uint64_t(rb)));
      ++nv;
    }
  }
  for (int o = 16; o; o >>= 1) {
    const int64_t l = __shfl_xor_sync(0xffffffffu, lo, o);
    const int64_t h = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
  sec = __reduce_add_sync(0xffffffffu, sec);
  nv = __reduce_add_sync(0xffffffffu, nv);
  if ((threadIdx.x & 31) == 0) {
    red_lo[threadIdx.x >> 5] = lo;
    red_hi[threadIdx.x >> 5] = hi;
    red_sec[threadIdx.x >> 5] = sec;
    red_n[threadIdx.x >> 5] = nv;
  }
  __syncthreads();  // also publishes tile_ids
  lo = red_lo[0];
  hi = red_hi[0];
  sec = red_sec[0];
  nv = red_n[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    lo = red_lo[w] < lo ? red_lo[w] : lo;
    hi = red_hi[w] > hi ? red_hi[w] : hi;
    sec += red_sec[w];
    nv += red_n[w];
  }

  // 2. the rule: the window when the span fits it and moves no more sectors
  //    than direct reads of the tile's rows would
  const int64_t span_bytes = hi >= lo ? (hi - lo + 1) * rb : 0;
  const uint64_t span_addr = base + uint64_t(lo * rb);
  const bool windowed = hi >= lo && hi - lo < int64_t(window) &&
                        sectors(span_addr, uint64_t(span_bytes)) <= int64_t(sec);
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(stats + (windowed ? 0 : 1), 1ull);
    atomicAdd(stats + 2, static_cast<unsigned long long>(windowed ? span_bytes : int64_t(nv) * rb));
  }
  V* dst = out + t0 * vpr;
  if (!windowed) {  // 3. direct reads
    drain<V, U>(dst, tile_ids, m, vpr,
             [&](int64_t id, int v) { return table[id * vpr + v]; });
    return;
  }

  // 4. the span into shared memory, then out of it
  const int64_t nvec = (hi - lo + 1) * vpr;
  const V* src = table + lo * vpr;
  for (int64_t k = threadIdx.x; k < nvec; k += THREADS) copy_to_shared(win + k, src + k);
  wg::commit_copies();
  wg::wait_copies<0>();
  __syncthreads();
  drain<V, U>(dst, tile_ids, m, vpr, [&](int64_t id, int v) { return win[(id - lo) * vpr + v]; });
}

template <typename V>
cudaError_t launch(const void* table, const void* ids, int ids64, void* out, int64_t n_rows,
                   int64_t n_ids, int64_t row_bytes, int tile, int window, int zero_invalid,
                   void* stats, cudaStream_t stream) {
  // The rule takes no span of more sectors than a tile's direct reads, and a
  // row touches at most (row_bytes - 1) / 32 + 2 sectors, so no accepted span
  // exceeds tile * that * 32 bytes: shared memory beyond it would only cost
  // occupancy, and capping the window there changes no tile's route.
  const int64_t most = int64_t(tile) * ((row_bytes - 1) / 32 + 2) * 32 / row_bytes;
  if (window > most) window = int(most);
  const int64_t smem = ids_bytes(tile) + int64_t(window) * row_bytes;
  if (smem > MAX_DYNAMIC_SMEM) return cudaErrorInvalidValue;
  const int vpr = int(row_bytes / int64_t(sizeof(V)));
  auto go = [&](auto kernel, int64_t& raised) -> cudaError_t {
    if (smem > raised) {  // the default limit is 48 KB; raised once per larger request
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
      if (e != cudaSuccess) return e;
      raised = smem;
    }
    const int64_t blocks = (n_ids + tile - 1) / tile;
    kernel<<<(unsigned)blocks, THREADS, size_t(smem), stream>>>(
        static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows, n_ids, vpr, tile,
        window, zero_invalid, static_cast<unsigned long long*>(stats));
    return cudaGetLastError();
  };
  static int64_t raised8 = 48 * 1024, raised4 = 48 * 1024;
  return wg::loads_in_flight(tile, vpr) == 8 ? go(sorted_gather_kernel<V, 8>, raised8)
                                             : go(sorted_gather_kernel<V, 4>, raised4);
}

}  // namespace

extern "C" int wg_sorted_gather(const void* table, const void* ids, int ids64, void* out,
                                int64_t n_rows, int64_t n_ids, int64_t row_bytes, int vec_bytes,
                                int tile, int window, int zero_invalid, void* stats,
                                void* stream) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes ||
      tile <= 0 || window < 0 || int64_t(tile) * (row_bytes / vec_bytes) >= (int64_t(1) << 31) ||
      n_ids / tile >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vec_bytes) {
    case 16: e = launch<uint4>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, stats, s); break;
    case 8: e = launch<uint2>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, stats, s); break;
    case 4: e = launch<uint32_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, stats, s); break;
    case 2: e = launch<uint16_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, stats, s); break;
    case 1: e = launch<uint8_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, stats, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(e);
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
