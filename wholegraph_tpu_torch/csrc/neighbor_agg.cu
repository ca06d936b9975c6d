// Kernel D: fused masked neighbour sum / mean over a padded [B, K] block,
//   out[b] = sum_k mask[b, k] * x[clamp(nbr[b, k], 0, U - 1)]
// accumulated in f32 in ascending k; the mean divides by
// max(sum_k mask[b, k], 1). The output has x's dtype (f32 or bf16).
//
// Replaces `_fused_agg_kernel` (wholegraph_tpu/ops/spmm_pallas.py:42, its
// pallas_call at :98, through `fused_padded_sum`, :130-161) and the route the
// TPU took instead of it on the sampled path, `_gather_kernel` plus an XLA sum
// over K (ops/spmm.py:57-85). The TPU routed masked slots to an appended zero
// row so that every DMA was unconditional; here a masked slot is skipped and
// no zero row exists. This is the reference WholeGraph's fused
// `agg_concat_n2n` aggregation.
//
// Bound: bytes. Each valid slot reads one random row of x (row_bytes, 1 KB at
// the SAGE step's D = 256 f32); the ids and mask are read once (5 bytes a
// slot) and each output row written once. The [B, K, D] intermediate of the
// gather-then-reduce route never touches device memory. The adds (one a valid
// slot and column) are far below the card's f32 rate.
//
// Design. A group of `lanes` lanes (a power of two) owns one slice of a
// centre's row, `lanes` vectors wide (16 bytes where the row and the
// pointers allow: 512 bytes a warp); a warp holds 32 / lanes groups, a CTA 4
// warps.
// * The ids and mask are read once a slice: lane t of a group loads slot
//   k0 + t of its centre, coalesced, in passes of `lanes` slots (one pass
//   where K <= lanes), the next pass's slot loaded while this pass's rows are
//   read. A ballot compacts the pass's valid slots, __popc counts them for
//   the mean, and each valid slot's id is broadcast by __shfl_sync from the
//   lane that loaded it. No serial loop over K reads the mask.
// * Each lane holds one vector of the row; the loads of AGG_LOAD_VECS valid
//   neighbours are issued before any add, through the read-only path, and the
//   output goes out with streaming stores.
// * Every lane adds its neighbours in ascending k, in f32, so the result is
//   deterministic, with no atomics, and bit-equal to the earlier one-warp-a-row
//   kernel whatever the plan.
// * The host's plan (ops.spmm_kernels.agg_plan, one rule in bytes) fills the
//   card: a row narrower than a warp's 32 vectors packs several centres into
//   a warp (lanes < 32, as many lanes as the row has vectors or K slots), and
//   a wider row is split over warps, a 32-vector slice each (two warps a 1 KB
//   row), each warp reading the centre's ids again.
// It replaced one warp a centre that re-read the ids and mask for every
// 512-byte chunk of the row, counted the mean's slots in a serial loop, kept
// few dependent mask, id and row loads in flight, and capped the grid at
// 132 x 32 CTAs of 8 centres.
//
// Measured on an H100 (tools/kernel_variants.py, device time of a CUDA graph
// of 20 calls; PERF.md section 6, kernel D), ms against the earlier kernel:
// the SAGE step's first layer (11,264 centres, K = 15, 1 KB rows) 0.0568
// against 0.0634, its second (1,024 centres) 0.0042 against 0.0074, the
// GCN's 64-byte rows (2 centres a warp) 0.0030 against 0.0042. Kept out: a warp a
// whole 1 KB row, 2 vectors a lane (0.6-1.3 % slower on the step's large
// calls, 3 % over a table that L2 holds, 9 % on the second layer), 8 row
// vectors in flight a lane (4-6 % slower) or 2 (3-5 %), rolling loads (each
// neighbour's load issued as the one U before it is added: 9 % slower), a
// warp that walks its row's slices in turn (11 % slower on the second
// layer), persistent warps (1-4 % either way), L2 hints, 256-thread CTAs
// (1-3 % slower). Left open: 16-byte loads that skip L1 were 3-5 % faster
// where each row is read about once and 9-35 % slower at bench_spmm's
// call, whose rows are read 8 times each; at that call (2^16 centres,
// K = 16, every slot valid, over a 128 MB table that L2 holds a part of)
// the earlier kernel stays about 5 % ahead, and over a table L2 holds, or
// one 4 times as tall, the two tie.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int AGG_THREADS = 128;  // 4 warps a CTA
constexpr int AGG_LOAD_VECS = 4;  // row vectors a lane keeps in flight

struct F32 {
  static constexpr int bytes = 4;
};
struct BF16 {
  static constexpr int bytes = 2;
};

// bf16 bits to f32 (exact) and f32 to bf16 bits, rounded to nearest even as
// torch's cast
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf_bits(float v) {
  return unsigned(__bfloat16_as_ushort(__float2bfloat16(v)));
}

// acc[0..N) += the N elements of one vector
__device__ __forceinline__ void add_vec(float* a, uint4 v, F32) {
  a[0] += __uint_as_float(v.x);
  a[1] += __uint_as_float(v.y);
  a[2] += __uint_as_float(v.z);
  a[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add_vec(float* a, uint2 v, F32) {
  a[0] += __uint_as_float(v.x);
  a[1] += __uint_as_float(v.y);
}
__device__ __forceinline__ void add_vec(float* a, unsigned v, F32) { a[0] += __uint_as_float(v); }
__device__ __forceinline__ void add_vec(float* a, uint4 v, BF16) {
  a[0] += bf_lo(v.x);
  a[1] += bf_hi(v.x);
  a[2] += bf_lo(v.y);
  a[3] += bf_hi(v.y);
  a[4] += bf_lo(v.z);
  a[5] += bf_hi(v.z);
  a[6] += bf_lo(v.w);
  a[7] += bf_hi(v.w);
}
__device__ __forceinline__ void add_vec(float* a, uint2 v, BF16) {
  a[0] += bf_lo(v.x);
  a[1] += bf_hi(v.x);
  a[2] += bf_lo(v.y);
  a[3] += bf_hi(v.y);
}
__device__ __forceinline__ void add_vec(float* a, unsigned v, BF16) {
  a[0] += bf_lo(v);
  a[1] += bf_hi(v);
}
__device__ __forceinline__ void add_vec(float* a, unsigned short v, BF16) {
  a[0] += bf_lo(unsigned(v));
}

// one vector of N results
__device__ __forceinline__ void pack(uint4& v, const float* f, F32) {
  v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                 __float_as_uint(f[3]));
}
__device__ __forceinline__ void pack(uint2& v, const float* f, F32) {
  v = make_uint2(__float_as_uint(f[0]), __float_as_uint(f[1]));
}
__device__ __forceinline__ void pack(unsigned& v, const float* f, F32) {
  v = __float_as_uint(f[0]);
}
__device__ __forceinline__ void pack(uint4& v, const float* f, BF16) {
  v = make_uint4(bf_bits(f[0]) | bf_bits(f[1]) << 16, bf_bits(f[2]) | bf_bits(f[3]) << 16,
                 bf_bits(f[4]) | bf_bits(f[5]) << 16, bf_bits(f[6]) | bf_bits(f[7]) << 16);
}
__device__ __forceinline__ void pack(uint2& v, const float* f, BF16) {
  v = make_uint2(bf_bits(f[0]) | bf_bits(f[1]) << 16, bf_bits(f[2]) | bf_bits(f[3]) << 16);
}
__device__ __forceinline__ void pack(unsigned& v, const float* f, BF16) {
  v = bf_bits(f[0]) | bf_bits(f[1]) << 16;
}
__device__ __forceinline__ void pack(unsigned short& v, const float* f, BF16) {
  v = (unsigned short)bf_bits(f[0]);
}

// one vector of a neighbour row, through the read-only path
template <typename V>
__device__ __forceinline__ V load_row(const V* p) {
  return __ldg(p);
}

__device__ __forceinline__ int32_t clip(int32_t id, int64_t n_rows) {
  if (id < 0) return 0;
  return int64_t(id) >= n_rows ? int32_t(n_rows - 1) : id;
}

// One group of `lanes` lanes (1 << shift) a (centre, slice); lane t of a group
// reads vector slice * lanes + t of each neighbour row.
template <typename Tag, typename V>
__global__ void __launch_bounds__(AGG_THREADS)
neighbor_agg_kernel(const V* __restrict__ x, int64_t n_rows, int vpr,
                    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
                    V* __restrict__ out, int64_t B, int K, int mean, int shift, int slices) {
  constexpr int N = int(sizeof(V)) / Tag::bytes;
  constexpr int U = AGG_LOAD_VECS;  // neighbours a batch
  const int lanes = 1 << shift;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * AGG_THREADS + threadIdx.x) >> 5;
  const int64_t first = (warp / slices) << (5 - shift);  // the warp's first centre
  if (first >= B) return;  // the whole warp: no lane of it shuffles
  const int slice = int(warp % slices);
  const int g = lane >> shift, t = lane & (lanes - 1);
  const int64_t b = first + g;
  const bool live = b < B;
  const unsigned gbits = lanes == 32 ? FULL : ((1u << lanes) - 1u) << (g << shift);
  const int c = slice * lanes + t;  // this lane's vector of the row
  const bool col = c < vpr;
  const int64_t base = b * K;

  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
  int count = 0;

  bool ok = live && t < K && mask[base + t];
  int32_t id = ok ? clip(nbr[base + t], n_rows) : 0;
  for (int k0 = 0; k0 < K; k0 += lanes) {
    const int kn = k0 + lanes + t;
    const bool ok_next = live && kn < K && mask[base + kn];
    const int32_t id_next = ok_next ? clip(nbr[base + kn], n_rows) : 0;

    unsigned mine = __ballot_sync(FULL, ok) & gbits;
    const int n = __popc(mine);
    count += n;
    const int most = lanes == 32 ? n : __reduce_max_sync(FULL, n);
    for (int i = 0; i < most; i += U) {
      int32_t row[U];
      bool has[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        has[u] = mine != 0;
        row[u] = __shfl_sync(FULL, id, has[u] ? __ffs(mine) - 1 : 0);
        mine &= mine - 1;
      }
      V v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (has[u] && col) v[u] = load_row(x + int64_t(row[u]) * vpr + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (has[u] && col) add_vec(acc, v[u], Tag());
      }
    }
    ok = ok_next;
    id = id_next;
  }

  if (!live || !col) return;
  if (mean) {
    const float denom = float(count > 1 ? count : 1);
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = acc[j] / denom;
  }
  V o;
  pack(o, acc, Tag());
  __stcs(out + b * vpr + c, o);
}

template <typename Tag, typename V>
int launch(const void* x, int64_t n_rows, int vpr, const void* nbr, const void* mask, void* out,
           int64_t B, int K, int mean, int lanes, int slices, cudaStream_t stream) {
  const int shift = __builtin_ctz(unsigned(lanes));
  const int64_t warps = ((B + (32 >> shift) - 1) >> (5 - shift)) * slices;
  const int64_t blocks = (warps + AGG_THREADS / 32 - 1) / (AGG_THREADS / 32);
  if (blocks >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  neighbor_agg_kernel<Tag, V><<<unsigned(blocks), AGG_THREADS, 0, stream>>>(
      static_cast<const V*>(x), n_rows, vpr, static_cast<const int32_t*>(nbr),
      static_cast<const uint8_t*>(mask), static_cast<V*>(out), B, K, mean, shift, slices);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. vec_bytes: 16, 8, 4 (or 2 for bf16), dividing
// row_bytes and both pointers. The plan (ops.spmm_kernels.agg_plan): lanes a
// centre (a power of two to 32) and slices a row, which together cover the
// row's vectors.
extern "C" int wg_neighbor_agg(const void* x, int64_t n_rows, int64_t row_bytes, const void* nbr,
                               const void* mask, void* out, int64_t B, int64_t K, int mean,
                               int dtype, int vec_bytes, int lanes, int slices, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (B <= 0 || K <= 0 || K >= (int64_t(1) << 31) || n_rows <= 0 || row_bytes <= 0 ||
      (dtype != 0 && dtype != 1) || vec_bytes < elem || vec_bytes > 16 ||
      (vec_bytes & (vec_bytes - 1)) || row_bytes % vec_bytes || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || slices < 1)
    return int(cudaErrorInvalidValue);
  const int64_t vpr = row_bytes / vec_bytes;
  if (vpr >= (int64_t(1) << 31) || int64_t(slices) * lanes < vpr)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tag, auto vec) {
    return launch<decltype(tag), decltype(vec)>(x, n_rows, int(vpr), nbr, mask, out, B, int(K),
                                                 mean, lanes, slices, s);
  };
  if (dtype == 0) {
    switch (vec_bytes) {
      case 16: return go(F32(), uint4());
      case 8: return go(F32(), uint2());
      default: return go(F32(), 0u);
    }
  }
  switch (vec_bytes) {
    case 16: return go(BF16(), uint4());
    case 8: return go(BF16(), uint2());
    case 4: return go(BF16(), 0u);
    default: return go(BF16(), static_cast<unsigned short>(0));
  }
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
