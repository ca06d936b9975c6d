// Kernel A: row gather, out[i] = table[clamp(ids[i], 0, n_rows - 1)].
//
// Replaces the TPU's `_gather_kernel` (wholegraph_tpu/ops/gather_pallas.py:35,
// launched from `_gather_rows_pallas3_impl`), which walked a ring of per-row
// DMAs over an SMEM block of ids padded to multiples of 1024, on the native
// [N, D//128, 128] layout. On Hopper the table is flat [N, D] and the ids are
// read by the block itself.
//
// Bound: bytes. Each output row is one table row read and one row written
// (2 * n_ids * row_bytes, plus the ids); there is no arithmetic. At D = 256
// f32 a row is 1 KB, so the read is a random 1 KB burst per id.
//
// Design: one warp per output row, lanes across the row in vectors of
// `vec_bytes` (16 when the row and both base pointers allow it, so a 1 KB row
// is 64 16-byte loads, two per lane, all coalesced); a grid-stride loop over
// rows keeps the grid at a few waves of the card's SMs whatever n_ids is.
// Clip semantics keep every read in bounds, as the TPU's did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    const V* src = table + id * vecs_per_row;
    V* dst = out + i * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

template <typename V>
void launch(const void* table, const void* ids, int ids64, void* out,
            int64_t n_rows, int64_t n_ids, int64_t row_bytes,
            cudaStream_t stream) {
  const int threads = 256;  // 8 warps, one row each per iteration
  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_gather_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows,
      n_ids, row_bytes / int64_t(sizeof(V)));
}

}  // namespace

extern "C" int wg_row_gather(const void* table, const void* ids, int ids64,
                             void* out, int64_t n_rows, int64_t n_ids,
                             int64_t row_bytes, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ids <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
      row_bytes % vec_bytes)
    return int(cudaErrorInvalidValue);
  switch (vec_bytes) {
    case 16: launch<uint4>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 8: launch<uint2>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 4: launch<uint32_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 2: launch<uint16_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    case 1: launch<uint8_t>(table, ids, ids64, out, n_rows, n_ids, row_bytes, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
