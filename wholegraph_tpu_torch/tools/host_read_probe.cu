// Read probes of a pinned, mapped host table over PCIe: how fast SM loads
// and bulk copies (cp.async.bulk) fetch 1 KB rows of host memory from the
// card, in the order given and sorted. Measurement only: no path of the port
// launches these; kernel E (csrc/host_rows.cu) was designed from what they
// show. Built and driven by host_read_probe.py.
//
// The row probes below take rows of exactly 1 KB (the bench's 256 f32) and
// slots in [0, n_rows), and copy each fetched row to out[i]. The record
// probes (probe_records, further down) read, write, or read and write back
// a sparse optimizer's three 1 KB parts of a row (a LazyAdam row's table, m
// and v), either from three tables or from one table of 3 KB records.
//
//  warp_rows<R>: one warp per R consecutive slots; every lane issues its two
//      16-byte loads of each of the R rows before any store, so R KB are in
//      flight per warp (R = 1 is the access of kernel E before its redesign).
//  stage_lanes: one CTA of 256 threads per 64 slots; each 16-byte vector of
//      the 64 rows is copied into shared memory with cp.async (64 KB in flight
//      per CTA), then stored.
//  warp_rows_l2_256: warp_rows<1> whose loads carry the L2::256B prefetch
//      size, so L2 asks the link for 256-byte blocks.
//  stage_bulk: as stage_lanes, but each row arrives by one cp.async.bulk
//      (1 KB) issued by a lane of warp 0, completion on an mbarrier; with
//      `merge`, adjacent rows (slot + 1) are fetched by one bulk copy each run.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#include <thread>
#include <vector>

namespace {

constexpr int ROW_VECS = 64;  // 1 KB rows of uint4
constexpr int TILE = 64;

template <int R>
__global__ void warp_rows(const uint4* host, const int32_t* __restrict__ slots,
                          uint4* __restrict__ out, int64_t n_slots) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i0 = warp * R; i0 < n_slots; i0 += n_warps * R) {
    uint4 v[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = i0 + r < n_slots ? i0 + r : n_slots - 1;
      const uint4* src = host + int64_t(slots[i]) * ROW_VECS;
      v[r][0] = src[lane];
      v[r][1] = src[lane + 32];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r < n_slots) {
        out[(i0 + r) * ROW_VECS + lane] = v[r][0];
        out[(i0 + r) * ROW_VECS + lane + 32] = v[r][1];
      }
    }
  }
}

// warp_rows<1> with the L2 asked to fetch 256 bytes around each load
__global__ void warp_rows_l2_256(const uint4* host, const int32_t* __restrict__ slots,
                                 uint4* __restrict__ out, int64_t n_slots) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_slots; i += n_warps) {
    const uint4* src = host + int64_t(slots[i]) * ROW_VECS;
    uint4 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[u].x), "=r"(v[u].y), "=r"(v[u].z), "=r"(v[u].w)
                   : "l"(src + lane + 32 * u));
    out[i * ROW_VECS + lane] = v[0];
    out[i * ROW_VECS + lane + 32] = v[1];
  }
}

__device__ __forceinline__ void store_tile(const uint4* stage, uint4* out, int64_t t0, int m) {
  for (int k = threadIdx.x; k < m * ROW_VECS; k += blockDim.x) out[t0 * ROW_VECS + k] = stage[k];
}

__global__ void stage_lanes(const uint4* host, const int32_t* __restrict__ slots,
                            uint4* __restrict__ out, int64_t n_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  const int64_t t0 = int64_t(blockIdx.x) * TILE;
  const int m = int(n_slots - t0 < TILE ? n_slots - t0 : TILE);
  for (int k = threadIdx.x; k < m * ROW_VECS; k += blockDim.x) {
    const uint4* src = host + int64_t(slots[t0 + k / ROW_VECS]) * ROW_VECS + k % ROW_VECS;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(stage + k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  store_tile(stage, out, t0, m);
}

__global__ void stage_bulk(const uint4* host, const int32_t* __restrict__ slots,
                           uint4* __restrict__ out, int64_t n_slots, int merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  __shared__ __align__(8) uint64_t bar;
  const int64_t t0 = int64_t(blockIdx.x) * TILE;
  const int m = int(n_slots - t0 < TILE ? n_slots - t0 : TILE);
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(unsigned(m) * 1024u) : "memory");
    __syncwarp();
    for (int r = threadIdx.x; r < m; r += 32) {
      const int32_t s0 = slots[t0 + r];
      int len = 1;
      if (merge) {  // the first row of a run of adjacent slots fetches the run
        if (r > 0 && slots[t0 + r - 1] + 1 == s0) continue;
        while (r + len < m && slots[t0 + r + len] == s0 + len) ++len;
      }
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage + r * ROW_VECS));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(dst), "l"(host + int64_t(s0) * ROW_VECS), "r"(unsigned(len) * 1024u), "r"(b)
          : "memory");
    }
  }
  unsigned done = 0;
  for (int64_t spin = 0; !done; ++spin) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(b) : "memory");
    if (spin > (int64_t(1) << 28)) __trap();  // a copy that never lands: fail, do not hang
  }
  store_tile(stage, out, t0, m);
}

}  // namespace

// mode: 1, 2, 4 = warp_rows<mode>; 20 = warp_rows_l2_256; 10 = stage_lanes;
// 11 = stage_bulk; 12 = stage_bulk with runs merged. Returns the launch's CUDA error.
extern "C" int probe_host_read(const void* host_base, int64_t host_offset, const void* slots,
                               void* out, int64_t n_slots, int mode, void* stream) {
  void* d = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&d, const_cast<void*>(host_base), 0);
  if (e != cudaSuccess) return int(e);
  const uint4* host = reinterpret_cast<const uint4*>(static_cast<char*>(d) + host_offset);
  const int32_t* s = static_cast<const int32_t*>(slots);
  uint4* o = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles = unsigned((n_slots + TILE - 1) / TILE);
  const size_t smem = TILE * 1024;
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(stage_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    cudaFuncSetAttribute(stage_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    raised = true;
  }
  switch (mode) {
    case 1: warp_rows<1><<<132 * 32, 256, 0, st>>>(host, s, o, n_slots); break;
    case 2: warp_rows<2><<<132 * 32, 256, 0, st>>>(host, s, o, n_slots); break;
    case 4: warp_rows<4><<<132 * 32, 256, 0, st>>>(host, s, o, n_slots); break;
    case 20: warp_rows_l2_256<<<132 * 32, 256, 0, st>>>(host, s, o, n_slots); break;
    case 10: stage_lanes<<<tiles, 256, smem, st>>>(host, s, o, n_slots); break;
    case 11: stage_bulk<<<tiles, 256, smem, st>>>(host, s, o, n_slots, 0); break;
    case 12: stage_bulk<<<tiles, 256, smem, st>>>(host, s, o, n_slots, 1); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Record probes: three 1 KB parts a slot, from three tables (part q of slot s
// at parts[q] + s * stride) or from one table of 3 KB records (parts[q] =
// record base + q KB, stride 3 KB). One warp a slot; a lane issues all six of
// its 16-byte loads (two a part, parts in ascending address order) before any
// store. out[i] holds slot i's three parts, 3 KB, in either case.
//   mode 0: read into out;
//   mode 1: write out[i] ^ mask back to the slot's parts (the write-back alone);
//   mode 2: read into out and write the value read ^ mask back (read, then
//           write-back). `mask` is an argument, so a store of the value read
//           (mask 0) is never dropped by the compiler.
// ---------------------------------------------------------------------------

namespace {

constexpr int PARTS = 3;
constexpr int PART_VECS = 64;  // 1 KB of uint4
constexpr int PART_LOADS = PART_VECS / 32;

struct Parts {
  uint4* p[PARTS];
  int64_t stride;  // uint4 a slot
};

__device__ __forceinline__ uint4 xor4(uint4 v, unsigned m) {
  return make_uint4(v.x ^ m, v.y ^ m, v.z ^ m, v.w ^ m);
}

__global__ void record_probe(Parts parts, const int32_t* __restrict__ slots,
                             uint4* __restrict__ out, int64_t n_slots, int mode, unsigned mask) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_slots; i += n_warps) {
    const int64_t at = int64_t(slots[i]) * parts.stride + lane;
    uint4* o = out + i * (PARTS * PART_VECS) + lane;
    uint4 v[PARTS][PART_LOADS];
    if (mode == 1) {
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
#pragma unroll
        for (int j = 0; j < PART_LOADS; ++j)
          parts.p[q][at + 32 * j] = xor4(o[q * PART_VECS + 32 * j], mask);
      continue;
    }
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
#pragma unroll
      for (int j = 0; j < PART_LOADS; ++j) v[q][j] = parts.p[q][at + 32 * j];
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
#pragma unroll
      for (int j = 0; j < PART_LOADS; ++j) {
        o[q * PART_VECS + 32 * j] = v[q][j];
        if (mode == 2) parts.p[q][at + 32 * j] = xor4(v[q][j], mask);
      }
  }
}

}  // namespace

// parts: three byte offsets from one mapped allocation's base (the record
// table's three parts) when bases[1] and bases[2] are null, else three
// allocations' bases (offset 0 each); stride in bytes. Returns the CUDA error.
extern "C" int probe_records(void* const* bases, const int64_t* offsets, int64_t stride,
                             const void* slots, void* out, int64_t n_slots, int mode,
                             unsigned mask, void* stream) {
  Parts parts;
  for (int q = 0; q < PARTS; ++q) {
    void* base = bases[q] ? bases[q] : bases[0];
    void* d = nullptr;
    cudaError_t e = cudaHostGetDevicePointer(&d, base, 0);
    if (e != cudaSuccess) return int(e);
    parts.p[q] = reinterpret_cast<uint4*>(static_cast<char*>(d) + offsets[q]);
  }
  parts.stride = stride / 16;
  if (stride % 16 || mode < 0 || mode > 2) return int(cudaErrorInvalidValue);
  record_probe<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<const int32_t*>(slots), static_cast<uint4*>(out), n_slots, mode, mask);
  return int(cudaGetLastError());
}

// Host memory of `bytes` for the probes, pinned and mapped: backing 0 by
// cudaHostAlloc; backing 1 by an anonymous mmap that asks for transparent huge
// pages (madvise MADV_HUGEPAGE), touched by `threads` threads and registered
// with cudaHostRegister(cudaHostRegisterMapped). Returns the CUDA error, or
// cudaErrorMemoryAllocation when the mmap fails.
extern "C" int probe_alloc(int64_t bytes, int backing, int threads, void** ptr) {
  *ptr = nullptr;
  if (backing == 0)
    return int(cudaHostAlloc(ptr, size_t(bytes), cudaHostAllocMapped | cudaHostAllocPortable));
  void* p = mmap(nullptr, size_t(bytes), PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return int(cudaErrorMemoryAllocation);
  madvise(p, size_t(bytes), MADV_HUGEPAGE);
  std::vector<std::thread> pool;
  const int64_t chunk = (bytes + threads - 1) / threads;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([=] {
      const int64_t lo = t * chunk, hi = lo + chunk < bytes ? lo + chunk : bytes;
      if (lo < hi) memset(static_cast<char*>(p) + lo, 0, size_t(hi - lo));
    });
  for (auto& th : pool) th.join();
  cudaError_t e = cudaHostRegister(p, size_t(bytes), cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (e != cudaSuccess) {
    munmap(p, size_t(bytes));
    return int(e);
  }
  *ptr = p;
  return 0;
}

extern "C" int probe_free(void* ptr, int64_t bytes, int backing) {
  if (backing == 0) return int(cudaFreeHost(ptr));
  cudaError_t e = cudaHostUnregister(ptr);
  munmap(ptr, size_t(bytes));
  return int(e);
}
