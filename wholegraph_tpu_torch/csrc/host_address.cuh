// The device address of a pinned, mapped host tensor, shared by kernels E
// and F (host_rows.cu) and kernel L's host route (sparse_apply.cu). A caller
// passes the host allocation's base pointer and the tensor's byte offset in
// it; the base's device address comes from cudaHostGetDevicePointer, never
// from assuming that the host and device addresses are equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

// Device address of byte `offset` of the pinned, mapped host allocation that
// starts at `base`, aligned to `align` bytes; the CUDA error otherwise (also
// cleared from this runtime's last-error slot, so the next launch does not
// report it), or cudaErrorMisalignedAddress.
inline cudaError_t device_address(const void* base, int64_t offset, int align, char** dev) {
  void* d = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&d, const_cast<void*>(base), 0);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  *dev = static_cast<char*>(d) + offset;
  if (reinterpret_cast<uintptr_t>(*dev) % uintptr_t(align)) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace wg
