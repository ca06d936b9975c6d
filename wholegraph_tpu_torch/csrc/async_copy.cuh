// Copies from device memory into shared memory, shared by kernel I
// (sorted_gather.cu, its windows) and kernels G and H (csr_spmm.cu,
// csr_sddmm.cu, through csr_tiles.cuh, their slabs).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int64_t MAX_DYNAMIC_SMEM = 227 * 1024 - 1024;  // of the SM's 227 KB, static arrays aside

// One element of P: by cp.async (16 bytes bypassing L1, 8 or 4 through it)
// where P is 4 bytes or wider, else a plain load and store.
template <typename P>
__device__ __forceinline__ void copy_to_shared(P* dst, const P* src) {
  if constexpr (sizeof(P) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else if constexpr (sizeof(P) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(int(sizeof(P))) : "memory");
  } else {
    *dst = *src;
  }
}

// Closes the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace wg
