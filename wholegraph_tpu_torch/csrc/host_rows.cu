// Kernels E and F: rows of a pinned host table, read and written by the card
// over PCIe through the table's mapped device address.
//
// E (wg_host_gather): out[i] = host[slot[i]] for 0 <= slot[i] < n_rows, else a
// zero row with no host read. Replaces the TPU's `_host_fetch_kernel`
// (wholegraph_tpu/ops/gather_pallas.py:1168, a DMA ring of 4 KB host pages
// with slots < 0 skipped) and `_host_window_fetch_kernel` (:1290, the same
// function for sorted, dense slots: fetch the [min, max] span in large chunks,
// then take on the device). The TPU's window and span plans (:1337-1377,
// :1471-1499) sorted the slots and read the host table in address order; E
// keeps that order and drops the span: it reads each distinct row once and
// nothing between them.
//
// F (wg_host_scatter): host[slot[i]] = rows[i] for 0 <= slot[i] < n_rows,
// other slots skipped. Replaces `_host_put_kernel` (:1183). Non-negative slots
// are unique by contract (as at :1586-1588); the TPU's page read-modify-write
// (:1589-1628) is gone, because a row is written whole. F's body is kernel
// B's earlier one, one warp a row (row_scatter.cuh, warp_row_scatter), run on
// the host table's device address: writes to mapped host memory are posted,
// so the warp does not wait on the link.
//
// Bound: bytes over the host link (PCIe Gen5 x16 on an H100 SXM). E must read
// each distinct valid row once from the host and write every out row to HBM;
// F reads each valid row from HBM and writes it to the host. No arithmetic.
//
// What holds SM reads of mapped host memory back (measured with
// tools/host_read_probe.cu on an H100): not the bytes in flight (1, 2 and 4 KB
// a warp read alike), but the order of the addresses -- the same lane loads
// read 1 KB rows 1.25x (uniform) to 1.4x (clustered) faster when the slots are
// sorted -- and rows read again for duplicate slots. Bulk copies
// (cp.async.bulk) do reach mapped host memory, at a third of the lane loads'
// rate, and 16-byte cp.async copies into shared memory ran at a fifth of it,
// so E reads with plain 16-byte lane loads. Staging a tile's rows in shared
// memory before writing them (a first build) made a CTA wait at a barrier
// between its reads and its writes, and lost to one warp a slot on slots that
// were sorted and unique already; E keeps each value in a register instead.
//
// Design of E: the wrapper sorts the slots with their output positions on the
// card (invalid slots as n_rows, last); a caller whose slots need no sort
// (sorted, or unique in ascending runs) passes them as they are, with no
// positions. One CTA per tile of TILE sorted slots:
//  1. Tile t owns the slots from the first row boundary at or after t * TILE
//     to the first at or after (t + 1) * TILE, where a boundary is a slot that
//     differs from the one before it, or is invalid. So the duplicates of a
//     row all belong to one tile, and each distinct row is read once by one
//     CTA.
//  2. A scan over the tile splits it into runs: a row's adjacent equal slots,
//     or one invalid slot.
//  3. The threads take the runs' vectors flattened over (run, vector), so
//     adjacent rows are one contiguous, coalesced read and the CTAs walk the
//     table in address order: each loads its vector once (UNROLL of them in
//     flight; zero for an invalid slot) and writes it to every output
//     position of the run.
// The result does not depend on the order of the slots: unsorted slots only
// cost more reads. Vectors are 16, 8, 4, 2 or 1 bytes, the widest the row
// allows. With a `stats` pointer, each CTA adds the bytes it read from the
// host.
//
// Addresses: the caller passes the host allocation's base pointer and the
// table's byte offset in it; the entry point resolves the base's device
// address with cudaHostGetDevicePointer (host_address.cuh, never assuming the
// two are equal) and returns that call's error when the memory is not pinned
// and mapped.
//
// Memory (wg_host_alloc, wg_host_free): the host tier (HostEmbedding) takes
// its table and each optimizer state table as a page-locked, mapped
// allocation of cudaHostAlloc, zeroed here by several host threads, in place
// of PyTorch's pinned blocks, which round each tensor up to a power of two.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <thread>
#include <vector>

#include "host_address.cuh"
#include "row_scatter.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;  // slots a CTA: one a thread in the run scan
constexpr int UNROLL = 4;      // host vectors a thread has in flight

__device__ __forceinline__ int64_t load_slot(const void* slots, int slots64, int64_t i) {
  return slots64 ? static_cast<const int64_t*>(slots)[i]
                 : int64_t(static_cast<const int32_t*>(slots)[i]);
}

// True where slot k starts a new group: the first slot, the end, an invalid
// slot, or a slot unlike the one before it.
__device__ __forceinline__ bool boundary(const void* slots, int slots64, int64_t k, int64_t n,
                                         int64_t n_rows) {
  if (k <= 0 || k >= n) return true;
  const int64_t s = load_slot(slots, slots64, k);
  return s < 0 || s >= n_rows || s != load_slot(slots, slots64, k - 1);
}

// First boundary in [from, limit], by one warp 32 slots at a time; limit if
// there is none before it.
__device__ __forceinline__ int64_t next_boundary(const void* slots, int slots64, int64_t from,
                                                 int64_t limit, int64_t n, int64_t n_rows) {
  const int lane = threadIdx.x & 31;
  for (int64_t p = from; p < limit; p += 32) {
    const unsigned hit = __ballot_sync(0xffffffffu,
                                       p + lane < limit && boundary(slots, slots64, p + lane, n, n_rows));
    if (hit) return p + __ffs(hit) - 1;
  }
  return limit;
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
host_gather_kernel(const V* host, const void* __restrict__ slots, int slots64,
                   const int64_t* __restrict__ pos, V* __restrict__ out, int64_t n_rows,
                   int64_t n, int vpr, unsigned long long* stats) {
  __shared__ int64_t run_row[TILE];  // the run's row, -1 for an invalid slot
  __shared__ int run_first[TILE];    // its first slot, counted from s
  __shared__ int64_t dst[TILE];      // the output row of each owned slot below t1
  __shared__ int64_t span[2];
  __shared__ int warp_total[WARPS];

  // 1. the slots this tile owns: [s, e); those at or past t1 repeat slot t1 - 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = int64_t(blockIdx.x) * TILE, t1 = t0 + TILE < n ? t0 + TILE : n;
  if (warp == 0) {
    const int64_t s = next_boundary(slots, slots64, t0, t1, n, n_rows);
    const int64_t e = s < t1 ? next_boundary(slots, slots64, t1, n, n, n_rows) : s;
    if (lane == 0) {
      span[0] = s;
      span[1] = e;
    }
  }
  __syncthreads();
  const int64_t s = span[0], e = span[1];
  if (s >= e) return;
  const int m1 = int((e < t1 ? e : t1) - s);

  // 2. the runs of the owned slots below t1 (a block scan of their starts);
  // the last run ends at e
  int64_t key = -1;
  bool valid = false;
  int start = 0;
  if (tid < m1) {
    key = load_slot(slots, slots64, s + tid);
    valid = key >= 0 && key < n_rows;
    start = tid == 0 || !valid || key != load_slot(slots, slots64, s + tid - 1);
    dst[tid] = pos ? pos[s + tid] : s + tid;
  }
  int incl = start;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_total[w];
  int n_runs = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) n_runs += warp_total[w];
  if (start) {
    run_row[incl - 1] = valid ? key : -1;
    run_first[incl - 1] = tid;
  }
  if (stats) {  // the bytes this CTA reads from the host: one row a valid run
    const int reads = __syncthreads_count(start && valid);
    if (tid == 0 && reads)
      atomicAdd(stats, static_cast<unsigned long long>(reads) * vpr * sizeof(V));
  } else {
    __syncthreads();
  }

  // 3. each run's vectors, read once and written to every slot of the run
  // (n_runs * vpr < 2^31: the entry checks TILE * vpr)
  const int total = n_runs * vpr;
  for (int k0 = tid; k0 < total; k0 += UNROLL * THREADS) {
    V val[UNROLL];
    int run[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * THREADS;
      run[u] = k < total ? k / vpr : -1;
      v[u] = k - run[u] * vpr;
      val[u] = V();
      if (run[u] >= 0 && run_row[run[u]] >= 0) val[u] = host[run_row[run[u]] * vpr + v[u]];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (run[u] < 0) continue;
      const int64_t j1 = run[u] + 1 < n_runs ? run_first[run[u] + 1] : e - s;
      for (int64_t j = run_first[run[u]]; j < j1; ++j) {
        const int64_t p = j < m1 ? dst[j] : (pos ? pos[s + j] : s + j);
        out[p * vpr + v[u]] = val[u];
      }
    }
  }
}

template <typename V>
cudaError_t launch_gather(const void* host, const void* slots, int slots64, const int64_t* pos,
                          void* out, int64_t n_rows, int64_t n, int64_t row_bytes,
                          unsigned long long* stats, cudaStream_t s) {
  host_gather_kernel<V><<<unsigned((n + TILE - 1) / TILE), THREADS, 0, s>>>(
      static_cast<const V*>(host), slots, slots64, pos, static_cast<V*>(out), n_rows, n,
      int(row_bytes / int64_t(sizeof(V))), stats);
  return cudaGetLastError();
}

bool bad_args(int64_t n_rows, int64_t n_slots, int64_t row_bytes, int vec_bytes) {
  return n_slots <= 0 || n_rows <= 0 || row_bytes <= 0 || vec_bytes <= 0 ||
         row_bytes % vec_bytes;
}

// Zero `bytes` at `p` in `threads` threads.
void zero_bytes(void* p, int64_t bytes, int threads) {
  std::vector<std::thread> pool;
  const int64_t chunk = (bytes + threads - 1) / threads;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([=] {
      const int64_t lo = t * chunk, hi = lo + chunk < bytes ? lo + chunk : bytes;
      if (lo < hi) memset(static_cast<char*>(p) + lo, 0, size_t(hi - lo));
    });
  for (auto& th : pool) th.join();
}

}  // namespace

// slots: sorted (invalid ones anywhere), with pos[i] the output row of
// sorted slot i, or pos == nullptr for out row i. stats: null, or one int64
// to which the launch adds the bytes it reads from the host table.
extern "C" int wg_host_gather(const void* host_base, int64_t host_offset, const void* slots,
                              int slots64, const void* pos, void* out, int64_t n_rows,
                              int64_t n_slots, int64_t row_bytes, int vec_bytes, void* stats,
                              void* stream) {
  if (bad_args(n_rows, n_slots, row_bytes, vec_bytes) ||
      row_bytes / vec_bytes * TILE >= (int64_t(1) << 31) || n_slots / TILE >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  char* host = nullptr;
  cudaError_t e = wg::device_address(host_base, host_offset, vec_bytes, &host);
  if (e != cudaSuccess) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(pos);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
#define WG_E(V) \
  e = launch_gather<V>(host, slots, slots64, p, out, n_rows, n_slots, row_bytes, st, s)
  switch (vec_bytes) {
    case 16: WG_E(uint4); break;
    case 8: WG_E(uint2); break;
    case 4: WG_E(uint32_t); break;
    case 2: WG_E(uint16_t); break;
    case 1: WG_E(uint8_t); break;
    default: return int(cudaErrorInvalidValue);
  }
#undef WG_E
  return int(e);
}

extern "C" int wg_host_scatter(const void* host_base, int64_t host_offset, const void* slots,
                               int slots64, const void* rows, int64_t n_rows, int64_t n_slots,
                               int64_t row_bytes, int vec_bytes, void* stream) {
  if (bad_args(n_rows, n_slots, row_bytes, vec_bytes)) return int(cudaErrorInvalidValue);
  char* host = nullptr;
  cudaError_t e = wg::device_address(host_base, host_offset, vec_bytes, &host);
  if (e != cudaSuccess) return int(e);
  return int(wg::warp_row_scatter(host, slots, slots64, rows, n_rows, n_slots, row_bytes,
                                  vec_bytes, static_cast<cudaStream_t>(stream)));
}

// `bytes` of zeroed, page-locked host memory, mapped into the card's address
// space (cudaHostAlloc, default flags: mapped and portable under unified
// addressing), in *ptr; a CUDA error code, with *ptr null, on failure.
extern "C" int wg_host_alloc(int64_t bytes, int threads, void** ptr) {
  *ptr = nullptr;
  if (bytes <= 0 || threads <= 0) return int(cudaErrorInvalidValue);
  const cudaError_t e = cudaHostAlloc(ptr, size_t(bytes), cudaHostAllocDefault);
  if (e != cudaSuccess) {
    *ptr = nullptr;
    cudaGetLastError();
    return int(e);
  }
  zero_bytes(*ptr, bytes, threads);
  return 0;
}

// Frees what wg_host_alloc gave, after the card's work that may read it is
// done. The caller must not call it while a stream is being captured.
extern "C" int wg_host_free(void* ptr) {
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return int(e);
  return int(cudaFreeHost(ptr));
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
