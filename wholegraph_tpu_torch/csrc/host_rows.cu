// Kernels E and F: rows of a pinned host table, read and written by the card
// over PCIe through the table's mapped device address.
//
// E (wg_host_gather): out[i] = host[slot[i]] for 0 <= slot[i] < n_rows, else a
// zero row with no host read. Replaces the TPU's `_host_fetch_kernel`
// (wholegraph_tpu/ops/gather_pallas.py:1168, a DMA ring of 4 KB host pages
// with slots < 0 skipped) and `_host_window_fetch_kernel` (:1290, the same
// function for sorted, dense slots: fetch the [min, max] span in large chunks,
// then take on the device). Both existed because a TPU host DMA moves whole
// 4 KB pages of a flat memref and each descriptor costs microseconds; the
// window and span plans (:1337-1377, :1471-1499) amortised that. On Hopper an
// SM load reaches a mapped pinned page directly at any 16-byte granule, so one
// kernel covers both regimes; sorted dense slots simply give it runs of
// adjacent rows.
//
// F (wg_host_scatter): host[slot[i]] = rows[i] for 0 <= slot[i] < n_rows,
// other slots skipped. Replaces `_host_put_kernel` (:1183). Non-negative slots
// are unique by contract (as at :1586-1588); the TPU's page read-modify-write
// (:1589-1628) is gone, because a row is written whole. F's body is kernel
// B's (row_scatter.cuh) run on the host table's device address: writes to
// mapped host memory are posted, so the warp does not wait on the link.
//
// Bound: bytes over the host link (PCIe Gen5 x16 on an H100 SXM). E reads
// each valid row once from the host and writes every out row to HBM; F reads
// each valid row from HBM and writes it to the host. There is no arithmetic.
//
// Design of E: kernel A's layout (row_gather.cu) -- one warp per row, lanes
// across the row in vectors of `vec_bytes`, a grid-stride loop over rows. A
// host read takes 1-2 us, so every lane first issues all of its loads of a row
// (up to UNROLL vectors) and only then stores them, and the grid keeps
// thousands of warps resident: tens of MB in flight, far above the link's
// rate-times-latency.
//
// Addresses: the caller passes the host allocation's base pointer and the
// table's byte offset in it; the entry point resolves the base's device
// address with cudaHostGetDevicePointer (never assuming the two are equal)
// and returns that call's error when the memory is not pinned and mapped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_scatter.cuh"

namespace {

constexpr int UNROLL = 4;

__device__ __forceinline__ int64_t load_slot(const void* slots, int slots64, int64_t i) {
  return slots64 ? static_cast<const int64_t*>(slots)[i]
                 : int64_t(static_cast<const int32_t*>(slots)[i]);
}

template <typename V>
__global__ void host_gather_kernel(const V* host, const void* __restrict__ slots,
                                   int slots64, V* __restrict__ out, int64_t n_rows,
                                   int64_t n_slots, int64_t vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_slots; i += n_warps) {
    const int64_t slot = load_slot(slots, slots64, i);
    const bool valid = slot >= 0 && slot < n_rows;
    const V* src = host + (valid ? slot : 0) * vecs_per_row;
    V* dst = out + i * vecs_per_row;
    for (int64_t v0 = lane; v0 < vecs_per_row; v0 += 32 * UNROLL) {
      V r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t v = v0 + 32 * u;
        r[u] = V();
        if (valid && v < vecs_per_row) r[u] = src[v];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t v = v0 + 32 * u;
        if (v < vecs_per_row) dst[v] = r[u];
      }
    }
  }
}

unsigned grid_for(int64_t n_slots) {
  int64_t blocks = (n_slots + 7) / 8;  // 256 threads: 8 warps, one row each
  if (blocks > 132 * 32) blocks = 132 * 32;
  return unsigned(blocks);
}

template <typename V>
void launch_gather(const void* host, const void* slots, int slots64, void* out,
                   int64_t n_rows, int64_t n_slots, int64_t row_bytes, cudaStream_t s) {
  host_gather_kernel<V><<<grid_for(n_slots), 256, 0, s>>>(
      static_cast<const V*>(host), slots, slots64, static_cast<V*>(out), n_rows, n_slots,
      row_bytes / int64_t(sizeof(V)));
}

// Device address of byte `offset` of the pinned, mapped host allocation that
// starts at `base`; 0 and the CUDA error otherwise (the error is also cleared
// from this runtime's last-error slot, so the next launch does not report it).
cudaError_t device_address(const void* base, int64_t offset, int vec_bytes, char** dev) {
  void* d = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&d, const_cast<void*>(base), 0);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  *dev = static_cast<char*>(d) + offset;
  if (reinterpret_cast<uintptr_t>(*dev) % uintptr_t(vec_bytes)) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

bool bad_args(int64_t n_rows, int64_t n_slots, int64_t row_bytes, int vec_bytes) {
  return n_slots <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
         row_bytes % vec_bytes;
}

}  // namespace

extern "C" int wg_host_gather(const void* host_base, int64_t host_offset, const void* slots,
                              int slots64, void* out, int64_t n_rows, int64_t n_slots,
                              int64_t row_bytes, int vec_bytes, void* stream) {
  if (bad_args(n_rows, n_slots, row_bytes, vec_bytes)) return int(cudaErrorInvalidValue);
  char* host = nullptr;
  cudaError_t e = device_address(host_base, host_offset, vec_bytes, &host);
  if (e != cudaSuccess) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_gather<uint4>(host, slots, slots64, out, n_rows, n_slots, row_bytes, s); break;
    case 8: launch_gather<uint2>(host, slots, slots64, out, n_rows, n_slots, row_bytes, s); break;
    case 4: launch_gather<uint32_t>(host, slots, slots64, out, n_rows, n_slots, row_bytes, s); break;
    case 2: launch_gather<uint16_t>(host, slots, slots64, out, n_rows, n_slots, row_bytes, s); break;
    case 1: launch_gather<uint8_t>(host, slots, slots64, out, n_rows, n_slots, row_bytes, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" int wg_host_scatter(const void* host_base, int64_t host_offset, const void* slots,
                               int slots64, const void* rows, int64_t n_rows, int64_t n_slots,
                               int64_t row_bytes, int vec_bytes, void* stream) {
  if (bad_args(n_rows, n_slots, row_bytes, vec_bytes)) return int(cudaErrorInvalidValue);
  char* host = nullptr;
  cudaError_t e = device_address(host_base, host_offset, vec_bytes, &host);
  if (e != cudaSuccess) return int(e);
  return int(wg::row_scatter(host, slots, slots64, rows, n_rows, n_slots, row_bytes, vec_bytes,
                             static_cast<cudaStream_t>(stream)));
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
