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
// an id the window does not hold is read from device memory in the same pass:
// nothing is repaired afterwards.
//
// Bound: bytes. The least the card can do is read each distinct row once and
// write each output row once (plus the ids); there is no arithmetic, and no
// float is ever formed, so NaN payloads, -0 and denormals pass unchanged. The
// window reads the whole span [lo, hi] of a tile, 1/d rows per useful row at
// id density d, so at wide rows (D = 256 f32, a 1 KB row, which kernel A
// already reads whole and coalesced) it cannot beat A; it can where rows are
// narrow, since A's warp per row leaves lanes idle there.
//
// Design: one CTA per tile of `tile` consecutive ids.
//  1. The CTA reads its ids into shared memory (int64), applying the clip or
//     the zero rule, and reduces the least and the greatest valid id, lo and hi.
//  2. If hi - lo < window, every valid id of the tile lies in [lo, hi], so all
//     threads stream the span's rows into shared memory with contiguous
//     cp.async copies (16-byte .cg where the row and the pointers allow, 8 or
//     4 bytes otherwise; plain loads for 2- and 1-byte vectors). Sortedness is
//     not required: a clustered but shuffled tile takes this path too.
//  3. Otherwise the tile is read row by row from device memory.
//  4. Either way the tile's output, one contiguous block of m * row_bytes, is
//     written with the flattened (row, vector) index spread over all threads:
//     coalesced stores for any row width, and for rows of 32 vectors or more
//     the same per-row access as kernel A's warp per row.
// Shared memory holds tile * 8 bytes of ids and window * row_bytes of rows;
// above 48 KB the entry point raises the kernel's dynamic shared-memory limit
// first. Span and address arithmetic is in int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int64_t MAX_DYNAMIC_SMEM = 227 * 1024 - 1024;  // of the SM's 227 KB, static arrays aside

__device__ __forceinline__ int64_t load_id(const void* ids, int ids64, int64_t i) {
  return ids64 ? static_cast<const int64_t*>(ids)[i]
               : int64_t(static_cast<const int32_t*>(ids)[i]);
}

template <typename V>
__device__ __forceinline__ void copy_to_shared(V* dst, const V* src) {
  if constexpr (sizeof(V) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else if constexpr (sizeof(V) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(int(sizeof(V))) : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// bytes of the ids' part of shared memory, rounded up so the window starts 16-byte aligned
__host__ __device__ __forceinline__ int64_t ids_bytes(int tile) {
  return (int64_t(tile) * 8 + 15) / 16 * 16;
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
sorted_gather_kernel(const V* __restrict__ table, const void* __restrict__ ids, int ids64,
                     V* __restrict__ out, int64_t n_rows, int64_t n_ids, int vpr, int tile,
                     int window, int zero_invalid) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* tile_ids = reinterpret_cast<int64_t*>(smem);
  V* win = reinterpret_cast<V*>(smem + ids_bytes(tile));
  __shared__ int64_t red_lo[WARPS], red_hi[WARPS];

  const int64_t t0 = int64_t(blockIdx.x) * tile;
  const int m = int(n_ids - t0 < tile ? n_ids - t0 : tile);

  // 1. ids, and the least and greatest valid one
  int64_t lo = INT64_MAX, hi = -1;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    int64_t id = load_id(ids, ids64, t0 + i);
    if (id < 0 || id >= n_rows) id = zero_invalid ? -1 : (id < 0 ? 0 : n_rows - 1);
    tile_ids[i] = id;
    if (id >= 0) {
      lo = id < lo ? id : lo;
      hi = id > hi ? id : hi;
    }
  }
  for (int o = 16; o; o >>= 1) {
    const int64_t l = __shfl_xor_sync(0xffffffffu, lo, o);
    const int64_t h = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
  if ((threadIdx.x & 31) == 0) {
    red_lo[threadIdx.x >> 5] = lo;
    red_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();  // also publishes tile_ids
  lo = red_lo[0];
  hi = red_hi[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    lo = red_lo[w] < lo ? red_lo[w] : lo;
    hi = red_hi[w] > hi ? red_hi[w] : hi;
  }

  // 2. the span [lo, hi] into shared memory, when it fits the window
  const bool windowed = hi >= lo && hi - lo < int64_t(window);
  if (windowed) {
    const int64_t nvec = (hi - lo + 1) * vpr;
    const V* src = table + lo * vpr;
    for (int64_t k = threadIdx.x; k < nvec; k += THREADS) copy_to_shared(win + k, src + k);
    wait_copies();
    __syncthreads();
  }

  // 3./4. the tile's rows, from the window or from device memory
  V* dst = out + t0 * vpr;
  const int total = m * vpr;
  const int q = THREADS / vpr, r = THREADS % vpr;
  int i = threadIdx.x / vpr, v = threadIdx.x % vpr;
  for (int k = threadIdx.x; k < total; k += THREADS) {
    const int64_t id = tile_ids[i];
    V val = V();
    if (id >= 0) val = windowed ? win[(id - lo) * vpr + v] : table[id * vpr + v];
    dst[k] = val;
    i += q;
    v += r;
    if (v >= vpr) {
      v -= vpr;
      ++i;
    }
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* ids, int ids64, void* out, int64_t n_rows,
                   int64_t n_ids, int64_t row_bytes, int tile, int window, int zero_invalid,
                   cudaStream_t stream) {
  const int64_t smem = ids_bytes(tile) + int64_t(window) * row_bytes;
  if (smem > MAX_DYNAMIC_SMEM) return cudaErrorInvalidValue;
  static int64_t raised = 48 * 1024;  // the default limit; raised once per larger request
  if (smem > raised) {
    cudaError_t e = cudaFuncSetAttribute(sorted_gather_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  const int64_t blocks = (n_ids + tile - 1) / tile;
  sorted_gather_kernel<V><<<(unsigned)blocks, THREADS, size_t(smem), stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows, n_ids,
      int(row_bytes / int64_t(sizeof(V))), tile, window, zero_invalid);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wg_sorted_gather(const void* table, const void* ids, int ids64, void* out,
                                int64_t n_rows, int64_t n_ids, int64_t row_bytes, int vec_bytes,
                                int tile, int window, int zero_invalid, void* stream) {
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes ||
      tile <= 0 || window < 0 || int64_t(tile) * (row_bytes / vec_bytes) >= (int64_t(1) << 31) ||
      n_ids / tile >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vec_bytes) {
    case 16: e = launch<uint4>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, s); break;
    case 8: e = launch<uint2>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, s); break;
    case 4: e = launch<uint32_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, s); break;
    case 2: e = launch<uint16_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, s); break;
    case 1: e = launch<uint8_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, tile, window, zero_invalid, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(e);
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
