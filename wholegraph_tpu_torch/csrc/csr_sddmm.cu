// Kernel H: CSR SDDMM over a destination-sorted CSR,
//   out[e] = sum_j a[dst_e, j] * b[clamp(col[e]), j]   for every edge e,
// where dst_e is the row whose [row_ptr[d], row_ptr[d+1]) holds e. a and b
// are f32 or bf16 (the same dtype) and may have a row stride; the dot is
// accumulated in f32 and out is f32.
//
// Replaces the TPU's `_sddmm_window_kernel` (wholegraph_tpu/ops/spmm_pallas.py:
// 771, through `sddmm_window`), which kept a window of source rows in VMEM and
// selected both endpoint rows of every edge out of it with int8 byte-plane
// one-hot matmuls on the MXU. In the port H also computes the attention
// gradient dw = <ct[dst], x[col]> of a weighted SpMM (GAT), which the JAX
// package sent to the XLA `sddmm_chunked` (spmm_pallas.py:652-668).
//
// Bound: bytes. a and b are read (each row once, at best), col and row_ptr
// once, out (4 bytes an edge) written once; 2 * E * D operations are far
// below the card's rate. Reading b[col_e] from L2 for every edge would move
// E * D elements (21 GB at the bench shape), 9 times the bound's bytes; the
// window reads each staged row of b once per tile.
//
// Design: two launches over tiles of `tile` consecutive destination rows, the
// TPU window carried over to shared memory.
//  1. csr_sddmm_device_kernel (256 threads, no dynamic shared memory, several
//     CTAs an SM) reads each tile's clamped columns and reduces their least
//     and greatest, lo and hi. A tile with at most `edge_cap` edges and
//     hi - lo < `window` is left to step 2: its (lo, hi) goes to `spans`. Any
//     other tile (a random graph, a row longer than edge_cap) is computed here
//     from device memory, as the first H did: groups of G lanes (G = 32,
//     fewer for rows of fewer vectors), an equal share of the tile's edges
//     each, so that one load of a warp reads up to 512 contiguous bytes of a
//     row, one or two vectors a lane a pass (NCH, two only for rows of more
//     than 32 vectors). The group holds the current row of a in registers,
//     fetches the columns of G edges and stores their sums in one access
//     each, and reduces each dot with xor shuffles. The window rule is
//     csr_tiles.cuh's (tile_staged), shared with kernel G, and this kernel
//     alone applies it; it keeps such tiles at the occupancy of a kernel
//     without shared memory. Exact on any CSR.
//  2. csr_sddmm_window_kernel (512 threads, one CTA an SM) takes the tiles
//     that step 1 marked; the others return at once. It stages the tile's
//     source rows b[lo..hi] and its rows of a in shared memory in column
//     slabs of 128 bytes a row, two slabs in flight (cp.async, double
//     buffered): slab s + 1 loads while slab s is used. Each edge is packed
//     as (local row << 16 | col - lo). Every thread takes an equal run of the
//     tile's consecutive edges (at most 8) and keeps their f32 sums in
//     registers across the slabs. For each edge it reads the whole slab row
//     of b from shared memory and dots it with the slab row of a, which it
//     keeps in registers while the edges' destination stays the same. Lane l
//     reads a row's 16-byte vectors starting at l % 8, so the 8 lanes of a
//     quarter warp touch 8 different bank groups whatever rows they read: no
//     bank conflicts and no shuffles. The sums leave through shared memory,
//     written coalesced.
// Every edge's sum is taken in an order fixed by the CSR alone (slab by slab,
// vector by vector from the thread's lane offset, or the same shuffle tree),
// so two runs are bit-identical; no atomics touch out. Shared memory of step
// 2: edge_cap * 4 bytes of edges (then sums) plus two slabs of (window +
// tile) rows; above 48 KB the entry raises the kernel's limit once.
//
// `stats`, when not null, receives what the launches did, added by one thread
// a CTA: [0] tiles staged, [1] bytes staged into shared memory, [2] tiles
// read from device memory, [3] their edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_tiles.cuh"

namespace {

using namespace wg;

constexpr int THREADS = 512;  // the window kernel's CTA
constexpr int DEV_THREADS = 256;  // the device-memory kernel's CTA
constexpr int EPT = 8;  // edges a thread: edge_cap <= EPT * THREADS

// Step 1: every tile's span; the tiles it does not stage, from device memory,
// NCH vectors of a row a lane in each pass.
template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(DEV_THREADS, 4)
csr_sddmm_device_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                        const T* __restrict__ a, int64_t lda, const T* __restrict__ b,
                        int64_t ldb, int64_t n_src, float* __restrict__ out, int64_t n_rows,
                        int n_vec, int group, int tile, int window, int edge_cap,
                        int32_t* __restrict__ spans, unsigned long long* stats) {
  using P = Pack<T, VEC>;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t d0 = int64_t(blockIdx.x) * tile;
  const int na = int(n_rows - d0 < tile ? n_rows - d0 : tile);
  const int32_t e0 = row_ptr[d0];
  const int64_t ne = int64_t(row_ptr[d0 + na]) - e0;
  int32_t* span = spans + 2 * int64_t(blockIdx.x);
  if (ne <= 0) {  // nothing to stage
    if (tid == 0) {
      span[0] = 0;
      span[1] = -1;
    }
    return;
  }
  int32_t lo, hi;
  if (tile_staged<DEV_THREADS>(col, e0, ne, n_src, window, edge_cap, lo, hi)) {
    if (tid == 0) {  // step 2 stages this tile
      span[0] = lo;
      span[1] = hi;
    }
    return;
  }
  if (tid == 0) {
    span[0] = 0;
    span[1] = -1;
    add_stat(stats, 2, 1);
    add_stat(stats, 3, ne);
  }
  // a and b from device memory by groups of `group` lanes with equal shares
  // of the tile's edges, in passes of NCH vectors a lane. A lane keeps its
  // vectors of the current row of a in registers while the edges' row stays
  // the same. Lane j of a group fetches the column of the j-th edge of each
  // batch of `group` edges and stores that edge's sum (added to the earlier
  // passes' by the same lane), one coalesced access a batch each.
  const int gl = lane & (group - 1), g0 = lane & ~(group - 1);
  const unsigned gmask = group == 32 ? 0xffffffffu : (((1u << group) - 1u) << g0);
  const int64_t beg = ne * (tid / group) / (DEV_THREADS / group);
  const int64_t end = ne * (tid / group + 1) / (DEV_THREADS / group);
  if (beg >= end) return;
  // the row of edge beg: the last d with row_ptr[d] <= e0 + beg
  int64_t d_beg = d0, h = d0 + na - 1;
  while (d_beg < h) {
    const int64_t m = (d_beg + h + 1) >> 1;
    if (row_ptr[m] <= e0 + beg) d_beg = m; else h = m - 1;
  }
  for (int v0 = 0; v0 < n_vec; v0 += NCH * group) {
    int64_t d = d_beg, cur = -1;
    P ar[NCH];
    for (int64_t i0 = beg; i0 < end; i0 += group) {
      const int cnt = int(end - i0 < group ? end - i0 : group);
      const int32_t c = gl < cnt ? clamp_col(col[e0 + i0 + gl], n_src) : 0;
      float mine = 0.0f;
      for (int j = 0; j < cnt; ++j) {
        while (row_ptr[d + 1] <= e0 + i0 + j) ++d;
        if (d != cur) {
          cur = d;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const int v = v0 + k * group + gl;
            if (v < n_vec) ar[k] = *reinterpret_cast<const P*>(a + d * lda + int64_t(v) * VEC);
          }
        }
        const T* br = b + int64_t(__shfl_sync(gmask, c, g0 + j)) * ldb;
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int v = v0 + k * group + gl;
          if (v < n_vec) {
            const P y = *reinterpret_cast<const P*>(br + int64_t(v) * VEC);
#pragma unroll
            for (int q = 0; q < VEC; ++q) p += to_f32(ar[k].v[q]) * to_f32(y.v[q]);
          }
        }
        for (int off = group >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(gmask, p, off);
        if (gl == j) mine = p;
      }
      if (gl < cnt) out[e0 + i0 + gl] = v0 == 0 ? mine : out[e0 + i0 + gl] + mine;
    }
  }
}

// Step 2: the tiles that step 1 left a span for, through shared memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
csr_sddmm_window_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                        const T* __restrict__ a, int64_t lda, const T* __restrict__ b,
                        int64_t ldb, int64_t n_src, float* __restrict__ out, int64_t n_rows,
                        int n_vec, int sv_max, int tile, int window, int edge_cap,
                        const int32_t* __restrict__ spans, unsigned long long* stats) {
  using P = Pack<T, VEC>;
  constexpr int SV = SLAB_BYTES / int(sizeof(P));  // vectors of a slab row
  const int32_t lo = spans[2 * int64_t(blockIdx.x)], hi = spans[2 * int64_t(blockIdx.x) + 1];
  if (hi < lo) return;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* edges = reinterpret_cast<uint32_t*>(smem);
  P* slabs = reinterpret_cast<P*>(smem + int64_t(edge_cap) * 4);

  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t d0 = int64_t(blockIdx.x) * tile;
  const int na = int(n_rows - d0 < tile ? n_rows - d0 : tile);
  const int32_t e0 = row_ptr[d0];
  const int ne = row_ptr[d0 + na] - e0;  // 1..edge_cap, as step 1 found
  for (int i = tid; i < ne; i += THREADS) edges[i] = uint32_t(clamp_col(col[e0 + i], n_src) - lo);
  __syncthreads();
  for (int r = tid; r < na; r += THREADS) {  // pack (local row, col - lo)
    const int32_t r0 = row_ptr[d0 + r] - e0, r1 = row_ptr[d0 + r + 1] - e0;
    for (int32_t i = r0; i < r1; ++i) edges[i] |= uint32_t(r) << 16;
  }
  __syncthreads();

  // thread tid takes the tile's edges [tid * ept, tid * ept + ept)
  const int ept = (ne + THREADS - 1) / THREADS;
  int er[EPT], ec[EPT];
  float sum[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int i = tid * ept + u;
    const bool mine = u < ept && i < ne;
    er[u] = mine ? int(edges[i] >> 16) : -1;
    ec[u] = mine ? int(edges[i] & 0xffffu) : 0;
    sum[u] = 0.0f;
  }
  const int n_b = hi - lo + 1;
  const int buf_rows = window + tile;
  const int n_slabs = (n_vec + sv_max - 1) / sv_max;
  if (tid == 0) {
    add_stat(stats, 0, 1);
    add_stat(stats, 1, int64_t(n_b + na) * n_vec * int64_t(sizeof(P)));
  }
  auto stage = [&](int s) {
    const int v0 = s * sv_max;
    const int sv = n_vec - v0 < sv_max ? n_vec - v0 : sv_max;
    P* buf = slabs + int64_t(s & 1) * buf_rows * sv_max;
    const int total = (n_b + na) * sv;
    for (int k = tid; k < total; k += THREADS) {
      const int r = k / sv, v = k - r * sv;
      if (r < n_b)
        copy_to_shared(buf + r * sv_max + v,
                       reinterpret_cast<const P*>(b + (lo + r) * ldb + int64_t(v0 + v) * VEC));
      else
        copy_to_shared(buf + (window + r - n_b) * sv_max + v,
                       reinterpret_cast<const P*>(a + (d0 + r - n_b) * lda +
                                                  int64_t(v0 + v) * VEC));
    }
    commit_copies();
  };
  stage(0);
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      stage(s + 1);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int v0 = s * sv_max;
    const int sv = n_vec - v0 < sv_max ? n_vec - v0 : sv_max;
    const P* bw = slabs + int64_t(s & 1) * buf_rows * sv_max;
    const P* aw = bw + int64_t(window) * sv_max;
    // lane l reads the slab's vectors starting at l % sv, so the 8 lanes of
    // a quarter warp hit 8 different 16-byte bank groups of their rows; ar
    // holds the row of a in that rotated order
    const int rot = lane % sv;
    P ar[SV];
    int cur = -1;
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      if (er[u] < 0) continue;
      if (er[u] != cur) {
        cur = er[u];
        int j = rot;
#pragma unroll
        for (int k = 0; k < SV; ++k) {
          if (k < sv) {
            ar[k] = aw[cur * sv_max + j];
            j = j + 1 == sv ? 0 : j + 1;
          }
        }
      }
      const P* br = bw + ec[u] * sv_max;
      float p = 0.0f;
      int j = rot;
#pragma unroll
      for (int k = 0; k < SV; ++k) {
        if (k < sv) {
          const P y = br[j];
#pragma unroll
          for (int q = 0; q < VEC; ++q) p += to_f32(ar[k].v[q]) * to_f32(y.v[q]);
          j = j + 1 == sv ? 0 : j + 1;
        }
      }
      sum[u] += p;
    }
    __syncthreads();  // the buffer of slab s is restaged with slab s + 2 next
  }
  // the sums through shared memory (edges[] is free now), written coalesced
  float* sums = reinterpret_cast<float*>(edges);
#pragma unroll
  for (int u = 0; u < EPT; ++u)
    if (er[u] >= 0) sums[tid * ept + u] = sum[u];
  __syncthreads();
  for (int i = tid; i < ne; i += THREADS) out[e0 + i] = sums[i];
}

template <typename T, int VEC>
cudaError_t launch(const void* row_ptr, const void* col, const void* a, int64_t lda,
                   const void* b, int64_t ldb, int64_t n_src, void* out, int64_t n_rows,
                   int n_vec, int tile, int window, int edge_cap, int32_t* spans,
                   unsigned long long* stats, cudaStream_t stream) {
  using P = Pack<T, VEC>;
  const int slab_vecs = SLAB_BYTES / int(sizeof(P));
  const int sv_max = n_vec < slab_vecs ? n_vec : slab_vecs;
  int group = 1;  // lanes an edge in step 1: 32 cover 512 contiguous bytes of a row a load
  while (group < 32 && group < n_vec) group *= 2;
  const int64_t smem = int64_t(edge_cap) * 4 + 2 * int64_t(window + tile) * sv_max * sizeof(P);
  if (smem > MAX_DYNAMIC_SMEM) return cudaErrorInvalidValue;
  static int64_t raised = 48 * 1024;  // the default limit; raised once per larger request
  if (smem > raised) {
    cudaError_t e = cudaFuncSetAttribute(csr_sddmm_window_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  const unsigned blocks = unsigned((n_rows + tile - 1) / tile);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const int32_t* cl = static_cast<const int32_t*>(col);
  auto device_kernel = n_vec <= group ? csr_sddmm_device_kernel<T, VEC, 1>
                                      : csr_sddmm_device_kernel<T, VEC, 2>;
  device_kernel<<<blocks, DEV_THREADS, 0, stream>>>(
      rp, cl, static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb, n_src,
      static_cast<float*>(out), n_rows, n_vec, group, tile, window, edge_cap, spans, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  csr_sddmm_window_kernel<T, VEC><<<blocks, THREADS, size_t(smem), stream>>>(
      rp, cl, static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb, n_src,
      static_cast<float*>(out), n_rows, n_vec, sv_max, tile, window, edge_cap, spans, stats);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (a and b alike). vec: elements per load; it
// divides D and both row strides, and the wrapper checked the pointers.
// lda, ldb: row strides in elements. out: [E] f32. tile, window, edge_cap:
// the plan (spmm_kernels.SDDMM_TILE, SDDMM_WINDOW, SDDMM_EDGE_CAP). spans:
// int32 scratch of 2 * ceil(n_rows / tile). stats: null, or 4 int64 counts
// that the launches add to (see the head of this file).
extern "C" int wg_csr_sddmm(const void* row_ptr, const void* col, const void* a, int64_t lda,
                            const void* b, int64_t ldb, int64_t n_src, void* out,
                            int64_t n_rows, int64_t D, int dtype, int vec, int tile, int window,
                            int edge_cap, void* spans, void* stats, void* stream) {
  if (n_rows <= 0 || D <= 0 || n_src <= 0 || vec <= 0 || D % vec || lda % vec || ldb % vec ||
      tile <= 0 || tile > 65536 || window <= 0 || window > 65536 || edge_cap <= 0 ||
      edge_cap % 4 || edge_cap > EPT * THREADS || D / vec >= (int64_t(1) << 31) ||
      n_src >= (int64_t(1) << 31) || (n_rows + tile - 1) / tile >= (int64_t(1) << 31) || !spans)
    return int(cudaErrorInvalidValue);
  const int n_vec = int(D / vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* sp = static_cast<int32_t*>(spans);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaError_t e;
#define WG_H(T, V) \
  e = launch<T, V>(row_ptr, col, a, lda, b, ldb, n_src, out, n_rows, n_vec, tile, window, \
                   edge_cap, sp, st, s)
  if (dtype == 0 && vec == 4) WG_H(float, 4);
  else if (dtype == 0 && vec == 2) WG_H(float, 2);
  else if (dtype == 0 && vec == 1) WG_H(float, 1);
  else if (dtype == 1 && vec == 8) WG_H(__nv_bfloat16, 8);
  else if (dtype == 1 && vec == 4) WG_H(__nv_bfloat16, 4);
  else if (dtype == 1 && vec == 2) WG_H(__nv_bfloat16, 2);
  else if (dtype == 1 && vec == 1) WG_H(__nv_bfloat16, 1);
  else return int(cudaErrorInvalidValue);
#undef WG_H
  return int(e);
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
