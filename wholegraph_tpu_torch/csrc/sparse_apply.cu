// Kernel L: the sparse optimizer's row update, fused with the apply's row
// gather and row scatter. For each slot i whose id lies in [0, n_rows):
//   g = grads[i] (f32, or bf16 / f16 widened exactly);
//   p = table[id], and the optimizer's state rows (f32) at id;
//   the optimizer's update in f32; the new rows written back in place.
// Every other slot is skipped: neither its gradient nor any row is read or
// written. Ids in range must be unique, as for kernel B: two slots of one id
// would race.
//
// Replaces, on the apply path (wholegraph_tpu/embedding/embedding.py:209-242),
// the TPU's `_gather_kernel` (wholegraph_tpu/ops/gather_pallas.py:35) on the
// table and each slot, the optimizer's update that XLA fuses into elementwise
// loops (embedding.py:217), and `_scatter_kernel` (gather_pallas.py:102) on
// each. The port ran that as kernel A x3, 16 ATen elementwise kernels
// (LazyAdam) and kernel B x3, about 52 passes over [R, D] f32; the reference
// WholeGraph runs one fused kernel per optimizer
// (embedding_optimizer_func.cu:179, 332, 595, 792).
//
// Bits: each step of the update is taken in the order and the rounding of
// ops/optimizers.py's `update` on the card, with __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and __fsqrt_rn, which the compiler never contracts
// into FMAs, so the kernel gives the plain route's bits. A host scalar s
// multiplies as ATen does (the f32 value of the Python float); LazyAdam's
// step corrections arrive as the f32 reciprocals ATen multiplies by when it
// divides a card tensor by a host scalar, by value from an eager step or at
// `step` (its row of step_table) from a replayed CUDA graph. The new table
// value is rounded to bf16 / f16 to nearest even, as `.to(dtype)` does.
//
// Bound: bytes. The ids read once; for each valid row the gradient read once,
// the table row and every state row read and written once: 7 row passes a
// valid row for LazyAdam (1.29 GB at the SAGE step's 180,224 slots of 1 KB),
// and a masked slot costs its id. A few f32 operations an element are far
// below the card's rate.
//
// Design: B's tiles (row_scatter.cuh). A CTA of 256 threads owns a tile of
// `tile` consecutive slots (ops.optim_kernels.apply_tile: as many as fill
// APPLY_TILE_BYTES of f32 rows were all valid, up to 512, 2 a thread); it
// loads their ids coalesced, compacts the valid ones into shared memory by a
// ballot a warp and one prefix over the warps' counts, and then the threads
// walk the flattened (valid row, vector) space of the tile, so rows narrower
// than a warp's reach pack several slots into one warp. A thread issues the
// loads of APPLY_ITEMS vectors (gradient through the read-only path; table
// and state with ordinary loads, since the kernel writes them) before any
// arithmetic: 8 independent 16-byte loads in flight at LazyAdam's f32 rows,
// then writes the new rows. Each valid row has one owner, so there are no
// atomics and the result is deterministic.
//
// Measured on an H100 (device time of a CUDA graph of 20 calls;
// tools/kernel_variants.py --parts L, the apply's calls of chip_smoke.py
// --paired-times apply): the SAGE step's call 0.84-0.85 of the bound, the
// hetero step's typed calls 0.68 / 0.74 / 0.18 at 192 / 128 / 64-byte rows,
// where the 984,064 ids alone take 0.0103 / 0.0075 / 0.0044 ms. Kept out:
// streaming stores (st.global.cs), 0-1.5 % slower at every call; 1 and 4
// items in flight a thread (within 1 %, but 4 is 25 % slower at 128-byte
// rows); 6 CTAs an SM at 40 registers (5-14 % slower); tiles of 8 and 16 KB
// (up to 1 % faster at 1 KB rows, 40-150 % slower at 128 bytes) and of 64
// and 128 KB (1-4 % slower at 1 KB rows, 31-33 % at 128 bytes).

// The host route (wg_sparse_apply_host, the same template with HOST set):
// the table and the state tables lie in pinned, mapped host memory
// (HostEmbedding), the gradients, ids and cache on the card. For each valid
// slot the route reads the gradient from HBM, the table row and each state row
// over PCIe, applies the same update, writes the new rows back over PCIe and,
// where lines[i] >= 0, the new table row into cache[lines[i]] on the card.
// Replaces, on the host tier's apply (wholegraph_tpu/embedding/
// host_embedding.py:185-248), the TPU's `_host_fetch_kernel` (gather_pallas.py:
// 1168) or `_host_window_fetch_kernel` (:1290) on the table and each slot, the
// update, `_host_put_kernel` (:1183) on each, and the cached lines' rewrite
// (:243-247): in the port kernel E x3, the update, kernel F x3 and kernel B,
// one after another. The reference runs the optimizer on host-mapped memory
// too (embedding.cpp:575-767).
//
// Bound: bytes over the host link (PCIe Gen5 x16, 64 GB/s each way): each
// valid row's table and state rows are read once and written once, 3 KB of
// reads and 3 KB of writes a 1 KB LazyAdam row. The composed route reads, then
// writes, so its bound is their sum over one direction's rate; here both
// directions can carry at once, so the bound is the larger of the two.
//
// Design for the link: the device route's tiles and walk, whose order is the
// slots' order (the apply's slots are ascending, and E measured sorted reads
// of mapped memory 1.25-1.4x faster, host_rows.cu); a thread's loads of its
// APPLY_ITEMS items are all in flight before it waits; its writes to
// mapped memory are posted, so it does not wait on them, and the many CTAs
// resident on each SM are at different phases, some reading while others
// write, which keeps both directions of the link busy at once. Tiles of
// APPLY_HOST_TILE_BYTES (8 KB, ops.optim_kernels) keep fewer rows in flight,
// nearer one another in the table.
//
// Memory: HostEmbedding keeps the table and each state table in an
// allocation of its own from the kernels' library (ops.host_kernels.
// host_zeros). One record a row (a row's table, m and v side by side, 3 KB
// at LazyAdam's 1 KB parts) read no faster by lane loads than three 1 KB
// runs from three tables (tools/host_read_probe.py --parts records:
// 0.92-1.08x on one machine), and one allocation for the three tables read
// slower than one a table (--parts tier), so the route reads three tables
// as before.
//
// Measured on an H100 (tools/kernel_variants.py --parts L, device time of a
// CUDA graph of 5 calls, at the host-tier SAGE step's apply call: 144,846
// valid rows of 1 KB, 445 MB each way; two calls): 19.3-19.9 ms against the
// composed route's 27.1-28.0. A probe that only reads takes 15.9-17.5 ms, one
// that only writes 8.5-8.6 and one that reads the table alone 5.4: lane loads
// read mapped memory at about 26 GB/s on those machines (E's own reads of the
// same rows alike), writes went at 52, and the route hides about two thirds
// of its writes under its reads. The reads bound it there, not the link's 64
// GB/s each way. Kept out: tiles of 32-128 KB (3-18 % slower than 2-16 KB);
// 1, 4 and 8 items in flight (within the calls' spread of 0.5-3 ms); 6 CTAs
// an SM and streaming stores (no faster).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "direct_gather.cuh"
#include "host_address.cuh"

namespace {

constexpr int APPLY_THREADS = 256;
constexpr int APPLY_MAX_TILE = 512;  // slots a tile: 2 a thread at most
constexpr int APPLY_IPT = APPLY_MAX_TILE / APPLY_THREADS;
constexpr int APPLY_ITEMS = 2;  // (row, vector) items in flight a thread, on both routes

// optimizers (ops.optim_kernels.OPT_CODES)
constexpr int OPT_SGD = 0, OPT_ADAM = 1, OPT_ADAMW = 2, OPT_RMSPROP = 3, OPT_ADAGRAD = 4;
// element types of the table and the gradients
constexpr int E_F32 = 0, E_BF16 = 1, E_F16 = 2;

struct Hyper {
  float lr, wd;
  float b1, omb1;  // LazyAdam's beta1 and 1 - beta1; RMSProp's alpha and 1 - alpha
  float b2, omb2;  // LazyAdam's beta2 and 1 - beta2
  float eps;
  float c1, c2;       // LazyAdam's step scalars (reciprocal corrections), eager
  const float* step;  // or their row of step_table on the card, when not null
};

template <int OPT>
__host__ __device__ constexpr int state_rows() {
  return OPT == OPT_SGD ? 0 : (OPT == OPT_ADAM || OPT == OPT_ADAMW) ? 2 : 1;
}

template <int E>
__device__ __forceinline__ float widen(unsigned short u) {
  if constexpr (E == E_BF16) return __uint_as_float(unsigned(u) << 16);
  else return __half2float(__ushort_as_half(u));
}

template <int E>
__device__ __forceinline__ unsigned short narrow(float x) {
  if constexpr (E == E_BF16) return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  else return __half_as_ushort(__float2half_rn(x));
}

// N elements of type E at `base + off` (elements) into f32; RO through the
// read-only path. The caller guarantees the alignment of N elements.
template <int E, int N, bool RO>
__device__ __forceinline__ void load_vec(const void* base, int64_t off, float* x) {
  if constexpr (E == E_F32) {
    const float* p = static_cast<const float*>(base) + off;
    if constexpr (N == 4) {
      const float4 v = RO ? __ldg(reinterpret_cast<const float4*>(p))
                          : *reinterpret_cast<const float4*>(p);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      x[0] = RO ? __ldg(p) : *p;
    }
  } else {
    const unsigned short* p = static_cast<const unsigned short*>(base) + off;
    if constexpr (N == 4) {
      const uint2 w = RO ? __ldg(reinterpret_cast<const uint2*>(p))
                         : *reinterpret_cast<const uint2*>(p);
      x[0] = widen<E>(w.x & 0xffffu);
      x[1] = widen<E>(w.x >> 16);
      x[2] = widen<E>(w.y & 0xffffu);
      x[3] = widen<E>(w.y >> 16);
    } else {
      x[0] = widen<E>(RO ? __ldg(p) : *p);
    }
  }
}

// N f32 values rounded to type E, stored at `base + off` (elements).
template <int E, int N>
__device__ __forceinline__ void store_vec(void* base, int64_t off, const float* x) {
  if constexpr (E == E_F32) {
    float* p = static_cast<float*>(base) + off;
    if constexpr (N == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    else *p = x[0];
  } else {
    unsigned short* p = static_cast<unsigned short*>(base) + off;
    if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(unsigned(narrow<E>(x[0])) | (unsigned(narrow<E>(x[1])) << 16),
                     unsigned(narrow<E>(x[2])) | (unsigned(narrow<E>(x[3])) << 16));
    } else {
      *p = narrow<E>(x[0]);
    }
  }
}

// One element's update, step by step as ops/optimizers.py's `update` on the
// card: p the parameter, a and b the state (m and v; RMSProp's v and
// AdaGrad's state_sum in a).
template <int OPT>
__device__ __forceinline__ void update(float g, float& p, float& a, float& b, const Hyper& h,
                                       float s1, float s2) {
  if constexpr (OPT != OPT_ADAMW) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  if constexpr (OPT == OPT_SGD) {
    p = __fsub_rn(p, __fmul_rn(h.lr, g));
  } else if constexpr (OPT == OPT_ADAM || OPT == OPT_ADAMW) {
    a = __fadd_rn(__fmul_rn(h.b1, a), __fmul_rn(h.omb1, g));
    b = __fadd_rn(__fmul_rn(h.b2, b), __fmul_rn(__fmul_rn(h.omb2, g), g));
    float upd = __fdiv_rn(__fmul_rn(a, s1), __fadd_rn(__fsqrt_rn(__fmul_rn(b, s2)), h.eps));
    if constexpr (OPT == OPT_ADAMW) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
    p = __fsub_rn(p, __fmul_rn(h.lr, upd));
  } else if constexpr (OPT == OPT_RMSPROP) {
    a = __fadd_rn(__fmul_rn(h.b1, a), __fmul_rn(__fmul_rn(h.omb1, g), g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, g), __fadd_rn(__fsqrt_rn(a), h.eps)));
  } else {  // OPT_ADAGRAD
    a = __fadd_rn(a, __fmul_rn(g, g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, g), __fadd_rn(__fsqrt_rn(a), h.eps)));
  }
}

// HOST: the host route. table, sa and sb are then the device addresses of
// pinned, mapped host tensors, and each valid slot i with lines[i] >= 0 also
// has its new table row written to cache[lines[i]] on the card; lines may be
// null (no cache line). The device route ignores lines and cache.
template <int OPT, int TE, int GE, int N, bool HOST>
__global__ void __launch_bounds__(APPLY_THREADS)
sparse_apply_kernel(void* __restrict__ table, float* __restrict__ sa, float* __restrict__ sb,
                    const void* __restrict__ ids, int ids64, const void* __restrict__ grads,
                    const int* __restrict__ lines, void* __restrict__ cache,
                    int64_t n_rows, int64_t n_ids, int vpr, int tile, Hyper h) {
  constexpr int U = APPLY_ITEMS;
  constexpr int W = APPLY_THREADS / 32;
  constexpr int NC = APPLY_IPT * W;  // counts: chunk-major, warp-minor
  constexpr int NS = state_rows<OPT>();
  static_assert(NC <= 32, "one count a lane");
  __shared__ int offs[NC + 1];
  __shared__ int64_t tile_dst[APPLY_MAX_TILE];  // the tile's valid ids
  __shared__ int tile_src[APPLY_MAX_TILE];      // their slots within the tile
  __shared__ int tile_line[HOST ? APPLY_MAX_TILE : 1];  // their cache lines, -1 for none
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = int64_t(blockIdx.x) * tile;
  const int m_ids = int(n_ids - t0 < tile ? n_ids - t0 : tile);

  // the tile's ids (and, on the host route, cache lines), coalesced, then
  // compacted by ballot (kernel B's scheme)
  int64_t id[APPLY_IPT];
  [[maybe_unused]] int line[APPLY_IPT];
#pragma unroll
  for (int c = 0; c < APPLY_IPT; ++c) {
    const int j = c * APPLY_THREADS + tid;
    id[c] = j < m_ids ? wg::load_id(ids, ids64, t0 + j) : -1;
    if constexpr (HOST) line[c] = j < m_ids && lines ? lines[t0 + j] : -1;
  }
  unsigned ball[APPLY_IPT];
#pragma unroll
  for (int c = 0; c < APPLY_IPT; ++c) {
    ball[c] = __ballot_sync(0xffffffffu, id[c] >= 0 && id[c] < n_rows);
    if (lane == 0) offs[c * W + warp] = __popc(ball[c]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix over the NC counts, one a lane
    const int mine = lane < NC ? offs[lane] : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < NC) offs[lane] = incl - mine;
    if (lane == 31) offs[NC] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < APPLY_IPT; ++c)
    if ((ball[c] >> lane) & 1u) {
      const int p = offs[c * W + warp] + __popc(ball[c] & below);
      tile_dst[p] = id[c];
      tile_src[p] = c * APPLY_THREADS + tid;
      if constexpr (HOST) tile_line[p] = line[c];
    }
  const int m = offs[NC];
  __syncthreads();

  float s1 = 0.0f, s2 = 0.0f;
  if constexpr (OPT == OPT_ADAM || OPT == OPT_ADAMW) {
    s1 = h.step ? h.step[0] : h.c1;
    s2 = h.step ? h.step[1] : h.c2;
  }
  const int64_t dim = int64_t(vpr) * N;
  const int total = m * vpr;
  const int q = APPLY_THREADS / vpr, r = APPLY_THREADS % vpr;
  int i = tid / vpr, v = tid % vpr;
  for (int k0 = tid; k0 < total; k0 += APPLY_THREADS * U) {
    float g[U][N], p[U][N], a[U][N], b[U][N];
    int64_t off[U], coff[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of the batch before any arithmetic
      off[u] = -1;
#pragma unroll
      for (int e = 0; e < N; ++e) a[u][e] = b[u][e] = 0.0f;
      if (k0 + u * APPLY_THREADS < total) {
        const int64_t col = int64_t(v) * N;
        off[u] = tile_dst[i] * dim + col;
        if constexpr (HOST) coff[u] = tile_line[i] >= 0 ? tile_line[i] * dim + col : -1;
        load_vec<GE, N, true>(grads, (t0 + tile_src[i]) * dim + col, g[u]);
        load_vec<TE, N, false>(table, off[u], p[u]);
        if constexpr (NS >= 1) load_vec<E_F32, N, false>(sa, off[u], a[u]);
        if constexpr (NS >= 2) load_vec<E_F32, N, false>(sb, off[u], b[u]);
      }
      i += q;
      v += r;
      if (v >= vpr) {
        v -= vpr;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (off[u] < 0) continue;
#pragma unroll
      for (int e = 0; e < N; ++e) update<OPT>(g[u][e], p[u][e], a[u][e], b[u][e], h, s1, s2);
      store_vec<TE, N>(table, off[u], p[u]);
      if constexpr (NS >= 1) store_vec<E_F32, N>(sa, off[u], a[u]);
      if constexpr (NS >= 2) store_vec<E_F32, N>(sb, off[u], b[u]);
      if constexpr (HOST)
        if (coff[u] >= 0) store_vec<TE, N>(cache, coff[u], p[u]);
    }
  }
}

struct Args {
  void* table;
  float* sa;
  float* sb;
  const void* ids;
  int ids64;
  const void* grads;
  const int* lines;
  void* cache;
  int64_t n_rows, n_ids;
  int vpr, tile;
  Hyper h;
  cudaStream_t stream;
};

template <int OPT, int TE, int GE, int N, bool HOST>
cudaError_t launch(const Args& a) {
  const unsigned blocks = unsigned((a.n_ids + a.tile - 1) / a.tile);
  sparse_apply_kernel<OPT, TE, GE, N, HOST><<<blocks, APPLY_THREADS, 0, a.stream>>>(
      a.table, a.sa, a.sb, a.ids, a.ids64, a.grads, a.lines, a.cache, a.n_rows, a.n_ids, a.vpr,
      a.tile, a.h);
  return cudaGetLastError();
}

template <int OPT, int TE, int GE, bool HOST>
cudaError_t by_vec(int vec, const Args& a) {
  if (vec == 4) return launch<OPT, TE, GE, 4, HOST>(a);
  if (vec == 1) return launch<OPT, TE, GE, 1, HOST>(a);
  return cudaErrorInvalidValue;
}

// the table's element type and the gradients': f32 gradients with any table,
// or, on the device route, gradients of the table's own 16-bit type (the host
// route takes f32 gradients alone: the apply's are its dedup's sums)
template <int OPT, bool HOST>
cudaError_t by_types(int te, int ge, int vec, const Args& a) {
  if (te == E_F32 && ge == E_F32) return by_vec<OPT, E_F32, E_F32, HOST>(vec, a);
  if (te == E_BF16 && ge == E_F32) return by_vec<OPT, E_BF16, E_F32, HOST>(vec, a);
  if (te == E_F16 && ge == E_F32) return by_vec<OPT, E_F16, E_F32, HOST>(vec, a);
  if constexpr (!HOST) {
    if (te == E_BF16 && ge == E_BF16) return by_vec<OPT, E_BF16, E_BF16, false>(vec, a);
    if (te == E_F16 && ge == E_F16) return by_vec<OPT, E_F16, E_F16, false>(vec, a);
  }
  return cudaErrorInvalidValue;
}

template <bool HOST>
cudaError_t by_opt(int opt, int te, int ge, int vec, const Args& a) {
  switch (opt) {
    case OPT_SGD: return by_types<OPT_SGD, HOST>(te, ge, vec, a);
    case OPT_ADAM: return by_types<OPT_ADAM, HOST>(te, ge, vec, a);
    case OPT_ADAMW: return by_types<OPT_ADAMW, HOST>(te, ge, vec, a);
    case OPT_RMSPROP: return by_types<OPT_RMSPROP, HOST>(te, ge, vec, a);
    case OPT_ADAGRAD: return by_types<OPT_ADAGRAD, HOST>(te, ge, vec, a);
  }
  return cudaErrorInvalidValue;
}

// The checks both entries share.
bool bad_args(int opt, int64_t n_rows, int64_t n_ids, int64_t dim, int vec, int tile,
              const void* table, const void* slot_a, const void* slot_b, const void* ids,
              const void* grads) {
  const int ns = opt == OPT_SGD ? 0 : (opt == OPT_ADAM || opt == OPT_ADAMW) ? 2 : 1;
  return opt < OPT_SGD || opt > OPT_ADAGRAD || n_ids <= 0 || n_rows <= 0 || dim <= 0 ||
         vec <= 0 || dim % vec || tile <= 0 || tile > APPLY_MAX_TILE ||
         int64_t(tile) * (dim / vec) >= (int64_t(1) << 31) ||
         (n_ids + tile - 1) / tile >= (int64_t(1) << 31) || table == nullptr || ids == nullptr ||
         grads == nullptr || (ns >= 1 && slot_a == nullptr) || (ns >= 2 && slot_b == nullptr);
}

}  // namespace

// Checks the arguments, launches on `stream` and returns cudaGetLastError().
// opt: OPT_*; table_dtype, grads_dtype: E_*; slot_a, slot_b: the optimizer's
// f32 state tables ([n_rows, dim]: LazyAdam's m and v, RMSProp's v, AdaGrad's
// state_sum; null where it has fewer); grads [n_ids, dim] contiguous; vec: 4
// or 1 elements a load (dim and every base pointer aligned to it); tile:
// slots a CTA, 1..APPLY_MAX_TILE (ops.optim_kernels.apply_tile). The floats
// are the optimizer's f32 hyperparameters (b1, omb1 RMSProp's alpha, 1 -
// alpha); c1, c2 LazyAdam's step scalars, read at `step` instead when it is
// not null.
extern "C" int wg_sparse_apply(int opt, void* table, int table_dtype, void* slot_a, void* slot_b,
                               const void* ids, int ids64, const void* grads, int grads_dtype,
                               int64_t n_rows, int64_t n_ids, int64_t dim, int vec, int tile,
                               float lr, float wd, float b1, float omb1, float b2, float omb2,
                               float eps, float c1, float c2, const void* step, void* stream) {
  if (bad_args(opt, n_rows, n_ids, dim, vec, tile, table, slot_a, slot_b, ids, grads))
    return int(cudaErrorInvalidValue);
  Args a{table, static_cast<float*>(slot_a), static_cast<float*>(slot_b), ids, ids64, grads,
         nullptr, nullptr, n_rows, n_ids, int(dim / vec), tile,
         Hyper{lr, wd, b1, omb1, b2, omb2, eps, c1, c2, static_cast<const float*>(step)},
         static_cast<cudaStream_t>(stream)};
  return int(by_opt<false>(opt, table_dtype, grads_dtype, vec, a));
}

// The host route: as wg_sparse_apply, with the table and the state tables in
// pinned, mapped host memory, each given as its allocation's base pointer and
// its byte offset in it (a null base for a state table the optimizer lacks),
// f32 gradients on the card, and, optionally, `lines` [n_ids] int32 on the
// card (a slot's cache line, or -1) and `cache` [lines, dim] of the table's
// type on the card, into whose line the new table row is also written.
// Returns cudaHostGetDevicePointer's error for memory that is not pinned and
// mapped, cudaErrorMisalignedAddress for a device address not aligned to vec
// elements, cudaErrorInvalidValue for lines without cache.
extern "C" int wg_sparse_apply_host(int opt, const void* table_base, int64_t table_offset,
                                    int table_dtype, const void* a_base, int64_t a_offset,
                                    const void* b_base, int64_t b_offset, const void* ids,
                                    int ids64, const void* grads, const void* lines, void* cache,
                                    int64_t n_rows, int64_t n_ids, int64_t dim, int vec,
                                    int tile, float lr, float wd, float b1, float omb1, float b2,
                                    float omb2, float eps, float c1, float c2, const void* step,
                                    void* stream) {
  if (bad_args(opt, n_rows, n_ids, dim, vec, tile, table_base, a_base, b_base, ids, grads) ||
      (lines != nullptr && cache == nullptr))
    return int(cudaErrorInvalidValue);
  const int esize = table_dtype == E_F32 ? 4 : 2;
  char *table = nullptr, *sa = nullptr, *sb = nullptr;
  cudaError_t e = wg::device_address(table_base, table_offset, vec * esize, &table);
  if (e == cudaSuccess && a_base) e = wg::device_address(a_base, a_offset, vec * 4, &sa);
  if (e == cudaSuccess && b_base) e = wg::device_address(b_base, b_offset, vec * 4, &sb);
  if (e != cudaSuccess) return int(e);
  Args a{table, reinterpret_cast<float*>(sa), reinterpret_cast<float*>(sb), ids, ids64, grads,
         static_cast<const int*>(lines), cache, n_rows, n_ids, int(dim / vec), tile,
         Hyper{lr, wd, b1, omb1, b2, omb2, eps, c1, c2, static_cast<const float*>(step)},
         static_cast<cudaStream_t>(stream)};
  return int(by_opt<true>(opt, table_dtype, E_F32, vec, a));
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
