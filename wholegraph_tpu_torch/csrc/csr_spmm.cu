// Kernel G: CSR SpMM over a destination-sorted CSR,
//   out[d] = sum_{e = row_ptr[d]}^{row_ptr[d+1]-1} w_e * x[clamp(col[e])]
// with w_e = 1 when no weights are given, accumulated in f32; the mean
// divides by max(deg_d, 1), the edge count and never the weight sum. An
// empty row gives zeros. x and out are f32 or bf16 (out takes x's dtype)
// and may have a row stride (one GAT head, featv[:, h, :], runs as is).
//
// Replaces the TPU's `_spmm_window_kernel` (wholegraph_tpu/ops/spmm_pallas.py:
// 201, through `spmm_window`), which built a [T, W] adjacency tile per dst
// tile from int8 one-hots on the MXU and multiplied it into a window slab of
// x DMA'd into VMEM. Here the window of x is kept, in shared memory, and the
// one-hots are gone: a thread walks its row's edges and reads each source row
// out of the window. A tile the window cannot serve is computed from device
// memory in the same call, so the kernel is exact on any CSR (the TPU kernel
// zeroed edges outside its window). The same kernel runs the backward dx on
// the transposed CSR (the TPU left that to XLA's segment path).
//
// Bound: bytes. x is read (each distinct source row once, at best), out
// written once, col and row_ptr read once; 2 * E * D f32 operations are far
// below the card's rate. Reading x[col_e] from L2 for every edge moves
// E * D * itemsize bytes (21 GB at the bench shape, 9 times the bound's); a
// staged tile reads each of its source rows from L2 once.
//
// Design: three launches, under the window rule of csr_tiles.cuh, over tiles
// of `tile` consecutive destination rows.
//  1. csr_spmm_span_kernel (256 threads, no dynamic shared memory) decides
//     each tile (tile_staged) and writes a staged tile's (lo, hi), or an
//     empty span, to `spans`, at the occupancy of a kernel without shared
//     memory, as kernel H's first step does. Deciding in the window kernel
//     instead, two launches a call, measured 0.2 % faster to 1.7 % slower on
//     an H100 (PERF.md): the launch it saves costs no more than the pass
//     over col it would move into a kernel of two CTAs an SM.
//  2. csr_spmm_window_kernel (512 threads, two CTAs an SM) computes the staged
//     tiles; the others return at once. The tile's edges go to shared memory
//     once, as (offset of the source row in a slab, weight), and its rows are
//     ranked by degree, so that the rows of a warp walk edge lists of about
//     one length. x[lo..hi] arrives in column slabs of 128 bytes a row, two
//     buffers (cp.async) and one barrier a slab: slab s + 1 loads while slab
//     s is used. A thread owns one row of the tile and two vectors of the
//     slab, walks the row's edges with the pair's sums in f32 registers, and
//     writes the pair out; the lanes of a row write its slab bytes
//     contiguously. In a slab of eight 16-byte vectors, lane l takes vectors
//     l % 8 and (l % 8) ^ 4 in that order, so the 8 lanes of a quarter warp
//     (two rows) touch 8 different bank groups. On an H100
//     (tools/kernel_variants.py) rows in CSR order were 3.5-11 % slower than
//     ranked, a second barrier a slab 1.6-2.1 %, balancing the warps (ranks k
//     and n - 1 - k on one thread) 0.5-2.4 %, one vector a thread 1.7-4.2 %,
//     slabs of 64 bytes at three CTAs an SM 45-53 %. At 64 registers (f32,
//     16-byte vectors) registers and shared memory alike allow two CTAs an
//     SM. Most of its time is the staging, ranks and stores, not the reads
//     of x out of shared memory (PERF.md).
//  3. csr_spmm_rows_kernel (256 threads, no shared memory) computes the rows
//     of the other tiles from device memory and skips the staged tiles' rows:
//     a group of G lanes per destination row (G = 32, or the power of two
//     that covers the row's vectors when D is narrow, so a 64-wide f32 GAT
//     head takes half a warp), lanes across D in vectors of VEC elements (16
//     bytes when D, the strides and the pointers allow), NCH vectors a lane
//     in registers; each lane loads one edge's column and weight and the
//     group broadcasts them with shuffles. A grid-stride loop
//     over rows keeps the rows in flight consecutive, so a locality-ordered
//     CSR's source rows stay in L2; a CTA a tile would spread them over the
//     ~1,000 tiles resident at once, more source rows than L2 holds.
// Both routes add a row's edges in CSR order with the same fused multiply-add
// per column, acc = fma(w_e, x[c_e][j], acc), then divide by max(deg, 1) for
// the mean: the staged route is bit-identical to the device route, and two
// runs are bit-identical. No atomics touch out. Shared
// memory of step 2: edge_cap * 8 bytes of edges, 8 bytes a tile row, two
// slabs of `window` rows; above 48 KB the entry raises the kernel's limit once.
//
// `stats`, when not null, receives what the launches did, added by one thread
// a CTA: [0] tiles staged, [1] bytes of x staged into shared memory (step 2),
// [2] tiles left to device memory, an empty tile among them, [3] their edges
// (step 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_tiles.cuh"

namespace {

using namespace wg;

constexpr int SPAN_THREADS = 256;  // the span kernel's CTA
constexpr int THREADS = 512;       // the window kernel's CTA
constexpr int ROWS_THREADS = 256;  // the rows kernel's CTA

struct alignas(8) Edge {
  int32_t off;  // the source row's first vector in a slab buffer
  float w;
};

// Step 1: every tile's decision.
__global__ void __launch_bounds__(SPAN_THREADS)
csr_spmm_span_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                     int64_t n_src, int64_t n_rows, int tile, int window, int edge_cap,
                     int32_t* __restrict__ spans, unsigned long long* stats) {
  const int64_t d0 = int64_t(blockIdx.x) * tile;
  const int na = int(n_rows - d0 < tile ? n_rows - d0 : tile);
  const int32_t e0 = row_ptr[d0];
  const int64_t ne = int64_t(row_ptr[d0 + na]) - e0;
  int32_t lo, hi;
  const bool staged = tile_staged<SPAN_THREADS>(col, e0, ne, n_src, window, edge_cap, lo, hi);
  if (threadIdx.x == 0) {
    spans[2 * int64_t(blockIdx.x)] = staged ? lo : 0;
    spans[2 * int64_t(blockIdx.x) + 1] = staged ? hi : -1;
    if (!staged) {
      add_stat(stats, 2, 1);
      add_stat(stats, 3, ne);
    }
  }
}

// Step 3: the rows of the tiles step 1 did not stage, from device memory,
// one lane group a row.
template <typename T, int VEC, int NCH>
__global__ void csr_spmm_rows_kernel(const int32_t* __restrict__ row_ptr,
                                     const int32_t* __restrict__ col,
                                     const float* __restrict__ w, const T* __restrict__ x,
                                     int64_t ldx, int64_t n_src, T* __restrict__ out,
                                     int64_t ldo, int64_t n_rows, int64_t n_vec, int group,
                                     int mean, int tile_shift,
                                     const int32_t* __restrict__ spans) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g_lane = lane & (group - 1);
  const int g_base = lane & ~(group - 1);
  const unsigned g_mask = group == 32 ? 0xffffffffu : (((1u << group) - 1u) << g_base);
  const int64_t per_warp = 32 / group;
  const int64_t first = ((int64_t(blockIdx.x) * blockDim.x + tid) >> 5) * per_warp + lane / group;
  const int64_t stride = ((int64_t(gridDim.x) * blockDim.x) >> 5) * per_warp;
  const int64_t per_pass = int64_t(group) * NCH;
  for (int64_t r = first; r < n_rows; r += stride) {
    const int64_t t = r >> tile_shift;
    if (spans[2 * t] <= spans[2 * t + 1]) continue;  // staged by step 2
    const int32_t e_beg = row_ptr[r], e_end = row_ptr[r + 1];
    const int deg = e_end - e_beg;
    const float denom = float(deg > 1 ? deg : 1);
    for (int64_t v0 = 0; v0 < n_vec; v0 += per_pass) {
      float acc[NCH][VEC];
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;
      for (int32_t eb = e_beg; eb < e_end; eb += group) {
        int32_t c = 0;
        float wt = 1.0f;
        if (eb + g_lane < e_end) {
          c = clamp_col(col[eb + g_lane], n_src);
          if (w) wt = w[eb + g_lane];
        }
        const int cnt = e_end - eb < group ? e_end - eb : group;
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const int32_t cj = __shfl_sync(g_mask, c, g_base + j);
          const float wj = __shfl_sync(g_mask, wt, g_base + j);
          const T* xr = x + int64_t(cj) * ldx;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const int64_t v = v0 + int64_t(k) * group + g_lane;
            if (v < n_vec) {
              const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + v * VEC);
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[k][i] = __fmaf_rn(wj, to_f32(p.v[i]), acc[k][i]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int64_t v = v0 + int64_t(k) * group + g_lane;
        if (v < n_vec) {
          Pack<T, VEC> o;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            o.v[i] = from_f32<T>(mean ? acc[k][i] / denom : acc[k][i]);
          *reinterpret_cast<Pack<T, VEC>*>(out + r * ldo + v * VEC) = o;
        }
      }
    }
  }
}

// shared memory of step 2: edges, the tile's row offsets and rank order, two slabs
__host__ __device__ __forceinline__ int64_t rows_offset(int edge_cap) {
  return int64_t(edge_cap) * int64_t(sizeof(Edge));
}
__host__ __device__ __forceinline__ int64_t slabs_offset(int edge_cap, int tile) {
  return rows_offset(edge_cap) + (int64_t(2 * tile + 1) * 4 + 15) / 16 * 16;
}

// Step 2: the staged tiles, through shared memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
csr_spmm_window_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                       const float* __restrict__ w, const T* __restrict__ x, int64_t ldx,
                       int64_t n_src, T* __restrict__ out, int64_t ldo, int64_t n_rows,
                       int n_vec, int sv_max, int mean, int tile, int window, int edge_cap,
                       const int32_t* __restrict__ spans, unsigned long long* stats) {
  using P = Pack<T, VEC>;
  const int32_t lo = spans[2 * int64_t(blockIdx.x)], hi = spans[2 * int64_t(blockIdx.x) + 1];
  if (hi < lo) return;
  extern __shared__ __align__(16) unsigned char smem[];
  Edge* edges = reinterpret_cast<Edge*>(smem);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + rows_offset(edge_cap));  // tile + 1 offsets
  int32_t* rank_order = rows + tile + 1;  // the tile's rows by degree
  P* slabs = reinterpret_cast<P*>(smem + slabs_offset(edge_cap, tile));
  const int tid = threadIdx.x;
  const int64_t d0 = int64_t(blockIdx.x) * tile;
  const int na = int(n_rows - d0 < tile ? n_rows - d0 : tile);
  const int32_t e0 = row_ptr[d0];
  const int ne = row_ptr[d0 + na] - e0;  // 1..edge_cap, as step 1 found
  const int n_b = hi - lo + 1;
  const int n_slabs = (n_vec + sv_max - 1) / sv_max;
  if (tid == 0) {
    add_stat(stats, 0, 1);
    add_stat(stats, 1, int64_t(n_b) * n_vec * int64_t(sizeof(P)));
  }
  auto stage = [&](int s) {
    const int v0 = s * sv_max;
    const int sv = n_vec - v0 < sv_max ? n_vec - v0 : sv_max;
    P* buf = slabs + int64_t(s & 1) * window * sv_max;
    const int total = n_b * sv;
    for (int k = tid; k < total; k += THREADS) {
      const int r = k / sv, v = k - r * sv;
      copy_to_shared(buf + r * sv_max + v,
                     reinterpret_cast<const P*>(x + (lo + r) * ldx + int64_t(v0 + v) * VEC));
    }
    commit_copies();
  };
  stage(0);
  for (int i = tid; i < ne; i += THREADS)
    edges[i] = Edge{(clamp_col(col[e0 + i], n_src) - lo) * sv_max, w ? w[e0 + i] : 1.0f};
  for (int r = tid; r <= na; r += THREADS) rows[r] = row_ptr[d0 + r] - e0;
  __syncthreads();
  for (int r = tid; r < na; r += THREADS) {  // rank: rows of smaller degree, or equal and before
    const int dg = rows[r + 1] - rows[r];
    int rank = 0, prev = rows[0];
    for (int j = 0; j < na; ++j) {
      const int next = rows[j + 1], dj = next - prev;
      prev = next;
      rank += int(dj < dg) | int(dj == dg && j < r);
    }
    rank_order[rank] = r;
  }

  for (int s = 0; s < n_slabs; ++s) {
    wait_copies<0>();
    // slab s, and before the first the edges' ranks, are in; every thread is
    // done with slab s - 1, whose buffer slab s + 1 now fills while s is used
    __syncthreads();
    if (s + 1 < n_slabs) stage(s + 1);
    const int v0 = s * sv_max;
    const int sv = n_vec - v0 < sv_max ? n_vec - v0 : sv_max;
    const int tpr = (sv + 1) / 2;  // threads a row, two vectors each
    const P* buf = slabs + int64_t(s & 1) * window * sv_max;
    for (int p = tid; p < na * tpr; p += THREADS) {
      const int slot = p / tpr, q = p - slot * tpr;
      const int r = rank_order[slot];
      // an odd slot takes its second vector first: a quarter warp of two
      // rows of a 16-byte slab then reads 8 different bank groups
      const int i0 = slot & 1 ? q + tpr : q, i1 = slot & 1 ? q : q + tpr;
      const int e_beg = rows[r], e_end = rows[r + 1];
      float a0[VEC], a1[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) a0[i] = a1[i] = 0.0f;
#pragma unroll 4
      for (int e = e_beg; e < e_end; ++e) {
        const Edge ed = edges[e];
        // i0 or i1 may be sv, for an odd sv: read, unused, and inside the two
        // buffers (sv < sv_max, or sv_max = sv and buffer 1 follows buffer 0)
        const P y0 = buf[ed.off + i0], y1 = buf[ed.off + i1];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          a0[i] = __fmaf_rn(ed.w, to_f32(y0.v[i]), a0[i]);
          a1[i] = __fmaf_rn(ed.w, to_f32(y1.v[i]), a1[i]);
        }
      }
      const int deg = e_end - e_beg;
      const float denom = float(deg > 1 ? deg : 1);
      T* o = out + (d0 + r) * ldo + int64_t(v0) * VEC;
      P o0, o1;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        o0.v[i] = from_f32<T>(mean ? a0[i] / denom : a0[i]);
        o1.v[i] = from_f32<T>(mean ? a1[i] / denom : a1[i]);
      }
      if (i0 < sv) *reinterpret_cast<P*>(o + int64_t(i0) * VEC) = o0;
      if (i1 < sv) *reinterpret_cast<P*>(o + int64_t(i1) * VEC) = o1;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* row_ptr, const void* col, const void* w, const void* x,
                   int64_t ldx, int64_t n_src, void* out, int64_t ldo, int64_t n_rows,
                   int64_t n_vec, int mean, int tile, int window, int edge_cap, int32_t* spans,
                   unsigned long long* stats, cudaStream_t stream) {
  using P = Pack<T, VEC>;
  const int slab_vecs = SLAB_BYTES / int(sizeof(P));
  const int sv_max = n_vec < slab_vecs ? int(n_vec) : slab_vecs;
  int group = 1;
  while (group < 32 && group < n_vec) group *= 2;
  const int64_t chunks = (n_vec + group - 1) / group;
  const int64_t smem =
      slabs_offset(edge_cap, tile) + 2 * int64_t(window) * sv_max * int64_t(sizeof(P));
  if (smem > MAX_DYNAMIC_SMEM) return cudaErrorInvalidValue;
  static int64_t raised = 48 * 1024;  // the default limit; raised once per larger request
  if (smem > raised) {
    cudaError_t e = cudaFuncSetAttribute(csr_spmm_window_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  const unsigned tiles = unsigned((n_rows + tile - 1) / tile);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const int32_t* cl = static_cast<const int32_t*>(col);
  const float* wt = static_cast<const float*>(w);
  csr_spmm_span_kernel<<<tiles, SPAN_THREADS, 0, stream>>>(rp, cl, n_src, n_rows, tile, window,
                                                           edge_cap, spans, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  csr_spmm_window_kernel<T, VEC><<<tiles, THREADS, size_t(smem), stream>>>(
      rp, cl, wt, static_cast<const T*>(x), ldx, n_src, static_cast<T*>(out), ldo, n_rows,
      int(n_vec), sv_max, mean, tile, window, edge_cap, spans, stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t rows_per_block = (ROWS_THREADS / 32) * (32 / group);
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;
  auto rows_kernel = chunks <= 1 ? csr_spmm_rows_kernel<T, VEC, 1>
                                 : (chunks <= 2 ? csr_spmm_rows_kernel<T, VEC, 2>
                                                : csr_spmm_rows_kernel<T, VEC, 4>);
  rows_kernel<<<unsigned(blocks), ROWS_THREADS, 0, stream>>>(
      rp, cl, wt, static_cast<const T*>(x), ldx, n_src, static_cast<T*>(out), ldo, n_rows, n_vec,
      group, mean, __builtin_ctz(unsigned(tile)), spans);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. vec: elements per load (16 bytes' worth or
// fewer; it divides D and both row strides, and the wrapper checked the
// pointers). w may be null. ldx, ldo: row strides in elements. tile, window,
// edge_cap: the plan (spmm_kernels.SPMM_TILE, a power of two, SPMM_WINDOW,
// SPMM_EDGE_CAP; a window of 0 computes every tile from device memory). spans: int32 scratch
// of 2 * ceil(n_rows / tile). stats: null, or 4 int64 counts that the
// launches add to (see the head of this file).
extern "C" int wg_csr_spmm(const void* row_ptr, const void* col, const void* w,
                           const void* x, int64_t ldx, int64_t n_src,
                           void* out, int64_t ldo, int64_t n_rows, int64_t D,
                           int mean, int dtype, int vec, int tile, int window, int edge_cap,
                           void* spans, void* stats, void* stream) {
  if (n_rows <= 0 || D <= 0 || n_src <= 0 || vec <= 0 || D % vec || ldx % vec || ldo % vec ||
      tile <= 0 || tile > 65536 || (tile & (tile - 1)) || window < 0 || window > 65536 || edge_cap <= 0 ||
      edge_cap % 2 || D / vec >= (int64_t(1) << 31) || n_src >= (int64_t(1) << 31) ||
      (n_rows + tile - 1) / tile >= (int64_t(1) << 31) || !spans)
    return int(cudaErrorInvalidValue);
  const int64_t n_vec = D / vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* sp = static_cast<int32_t*>(spans);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaError_t e;
#define WG_G(T, V)                                                                          \
  e = launch<T, V>(row_ptr, col, w, x, ldx, n_src, out, ldo, n_rows, n_vec, mean, tile, window, \
                   edge_cap, sp, st, s)
  if (dtype == 0 && vec == 4) WG_G(float, 4);
  else if (dtype == 0 && vec == 2) WG_G(float, 2);
  else if (dtype == 0 && vec == 1) WG_G(float, 1);
  else if (dtype == 1 && vec == 8) WG_G(__nv_bfloat16, 8);
  else if (dtype == 1 && vec == 4) WG_G(__nv_bfloat16, 4);
  else if (dtype == 1 && vec == 2) WG_G(__nv_bfloat16, 2);
  else if (dtype == 1 && vec == 1) WG_G(__nv_bfloat16, 1);
  else return int(cudaErrorInvalidValue);
#undef WG_G
  return int(e);
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
