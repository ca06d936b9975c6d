// The Timeline's stamp (utils/perf.py, Timeline.stamp): one thread reads the
// card's nanosecond clock (%globaltimer) and writes (tag, ns) into a ring at
// a cursor that it advances on the card.
//
// Replaces no TPU kernel: the JAX package times its steps from the host. It
// exists so that a span of the port (utils/perf.py, span) can be timed where
// it runs, inside a CUDA graph too: a stamp reads nothing on the host, so a
// capture records it as one kernel node, and every replay of the graph writes
// its own stamps.
//
// Layout of `buf` (int64): buf[0] is the cursor, the count of stamps asked
// for so far; row r of the ring is buf[2 * (r + 1)] (tag) and
// buf[2 * (r + 1) + 1] (ns). A stamp past `capacity` rows writes nothing and
// only advances the cursor, so the cursor less the capacity is the count
// dropped. The cursor is advanced by an atomic add, so stamps on two streams
// at once take distinct rows.
//
// Bound: one launch. It writes 16 bytes and adds to one counter; its cost on
// the card is the launch itself (a few microseconds between the kernels
// around it), which utils/perf.py's callers measure and report.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* buf, long long capacity, long long tag) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  unsigned long long slot = atomicAdd(buf, 1ULL);
  if (slot < static_cast<unsigned long long>(capacity)) {
    buf[2 * (slot + 1)] = static_cast<unsigned long long>(tag);
    buf[2 * (slot + 1) + 1] = ns;
  }
}

}  // namespace

extern "C" int wg_stamp(void* buf, int64_t capacity, int64_t tag, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf), static_cast<long long>(capacity),
      static_cast<long long>(tag));
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
