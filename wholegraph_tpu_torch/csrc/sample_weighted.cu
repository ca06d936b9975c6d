// Kernel K: the weighted (A-Res) sampler, one launch per hop.
//
// Replaces what the weighted branch of `csr_sample_neighbors`
// (wholegraph_tpu/ops/sampling.py:186-700) ran on the TPU: `_gather_kernel`
// (wholegraph_tpu/ops/gather_pallas.py:35) fetching 128-lane weight blocks
// (sampling.py:256-306), `_gather_slab_kernel` (gather_pallas.py:346)
// fetching each centre's pair or column slabs (sampling.py:405-430,
// 834-860) and `_select_lanes_kernel` (gather_pallas.py:445) picking the
// chosen lanes (sampling.py:454, 533, 779-788), around the XLA keys and
// `approx_max_k` merges of a degree ladder. The blocks, slabs, lane selects
// and ladder existed because a TPU DMA moves 128-lane rows and XLA needs
// static shapes; a warp reads a centre's edges directly and loops as far as
// its own degree.
//
// For each centre c (of B) it writes all five fields of `SampleResult`, as
// the plain version (ops/sampling.py, `csr_sample_neighbors_weighted_plain`)
// computes them:
//  - degree, the centre id clamped as kernel C clamps it (lo =
//    row_ptr[clamp(c, 0, N)], hi = row_ptr[clamp(c + 1, 0, N)]);
//  - edge o < deg gets the key log(max(u, 1e-20)) / w where w > 0 (so a NaN
//    weight gives -inf), else -inf, with u = (h >> 8) * 2^-24 and h =
//    rand_u32(seed, c, key0 + o), the counter hash of ops/rng.py in native
//    uint32 arithmetic. `logf` and an IEEE division (no fast-math flags, no
//    __logf or __fdividef), so u = 0 gives log(1e-20), not -inf;
//  - the first min(deg, K) edges in the order key descending, then position
//    ascending, fill slots 0.. in that order; a slot is valid when its key
//    is above -inf, and a -inf key is never taken, so holes in the mask are
//    only at a row's end;
//  - positions 0 where masked; edge_ids = lo + pos in int32; neighbours
//    col[clamp(lo + pos, 0, E - 1)] where valid, else -1.
// The weight and the column of an edge come from the pair table (`pairs`,
// [E] of (col, weight bits), one 8-byte load) or from `col` and `weights`
// apart; both routes give the same bits. Edge indices are clamped into
// [0, E - 1] and an empty edge array reads weight 0.
//
// Bound: the hop reads each centre's row_ptr pair and its edges once (8
// bytes an edge) and writes B * K * 13 + 4B bytes: about 30 MB, 0.009 ms at
// 3.35 TB/s, at bench_sampling's shape (B = 65536, degrees 16..48, K = 15);
// about 98 MB, 0.029 ms, over rows of 64..256 edges. What holds it is the
// warp's work per centre, not the bytes. From the SASS (cuobjdump -sass), a
// row of 33..64 edges costs about 490 warp instructions (two keys of about
// 60 each: three hash rounds, `logf`, an IEEE division; a 64-edge sort of
// about 270, 84 of them shuffles; the stores and the neighbour's shuffle
// about 60) and a row of 17..32 about 260 (a 32-edge sort of about 96):
// about 370 a centre at the bench's shape, 0.023 ms on 528 schedulers at
// 1.98 GHz. tools/kernel_variants.py splits the time by probes that each
// take one step out.
//
// Design: one warp per centre, 8 centres a block, no atomics, so the output
// is deterministic. The order of a row is key descending, then position
// ascending. Every key lies in [-inf, -0.0] (u < 1, so logf(max(u, 1e-20))
// < 0; w = +inf gives -0.0; w <= 0, NaN or a division that overflows give
// -inf), so every key has its sign bit set, and that order is the ascending
// order of the 64-bit value (bits(key) & 0x7fffffff) << 32 | position: one
// compare, a total order, and a -inf key is 0x7f800000 in the high word.
//  - deg <= REG_EDGES (256): each lane loads its edges lane + 32 r once
//    (one coalesced pass of 8-byte pairs, or of the two arrays side by
//    side), keys each once and keeps the neighbour in a register beside
//    it. R values a lane, chosen per row (the row is warp-uniform): R_SMALL
//    = 2 to 64 edges, R_LARGE = 8 above, each tier its own code, so short
//    rows run no code of the long ones'. The warp sorts the row's 64-bit
//    values by a bitonic network over the row's power-of-two width, with
//    __shfl_xor_sync between lanes and a compare-exchange inside a lane
//    across registers. Every block is sorted ascending (a merge's first
//    step pairs i with its mirror i ^ (k - 1)), so a step's direction is
//    which element is the lower: a compare and a select. In the tier of 8
//    with K <= 32 only the 32 smallest are needed, and WarpSelect's merge
//    (each register sorted, then merged into register 0 keeping 32) does
//    fewer steps than the whole sort. Slot j takes the j-th value, and its
//    neighbour comes by a shuffle from the lane that loaded that position,
//    not from memory. No shared memory, no __syncwarp. The kernel is held
//    to 40 registers (MIN_BLOCKS): the tier of 8 spills a little, and at 72
//    registers the short rows lose more to occupancy than it gains.
//  - deg > REG_EDGES: a running top-K list, sorted in the order above, over
//    chunks of 32 edges. A chunk's edges that beat the list's last key
//    (or all while it holds fewer than K) are inserted one at a time in
//    position order: the insertion index is #{list keys >= key}, since
//    every listed edge has a lower position, and the entries above it
//    shift up by one, the highest 32 first. A hub costs O(deg + inserts *
//    K / 32), not O(deg^2). The list lives in shared memory while 8 warps'
//    K entries fit in 48 KB (K <= 768), else in the centre's own rows of
//    the pos and edge_ids outputs (key bits in edge_ids), which are
//    rewritten last: any K is taken.
// Measured on the card and not taken (PERF.md, kernel K; each a variant in
// tools/kernel_variants.py): PR 8's rank count in shared memory to 256
// edges (3.1 times slower over rows of 64..256); one tier of 8 for every
// row; tiers of 2, 4 and 8; no register cap; a network that sets each
// step's direction per element; WarpSelect's merge in the tier of 2; and a
// sort of 32-bit key prefixes with an exact check.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t C1 = 0x85EBCA6Bu;
constexpr uint32_t C2 = 0xC2B2AE35u;
constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;    // centres (warps) per block
constexpr int MIN_BLOCKS = 6;  // blocks an SM: 40 registers a thread
constexpr int R_SMALL = 2;  // edges a lane holds for rows of up to 32 R_SMALL edges
constexpr int R_LARGE = 8;  // and for rows of up to 32 R_LARGE
constexpr int REG_EDGES = 32 * R_LARGE;  // rows up to this long are ranked in registers
constexpr int64_t SMEM_LIMIT = 48 * 1024;
__host__ __device__ constexpr int log2_of(int x) { return x > 1 ? 1 + log2_of(x / 2) : 0; }
static_assert(R_SMALL > 0 && (R_SMALL & (R_SMALL - 1)) == 0 && R_LARGE > R_SMALL &&
                  (R_LARGE & (R_LARGE - 1)) == 0,
              "register counts are powers of two");

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 13;
  x *= C2;
  x ^= x >> 16;
  return x;
}

// rand_u32(seed, c, key) = mix(key ^ mix(c ^ mix(seed ^ GOLD))): the first
// two rounds depend on the centre only
__device__ __forceinline__ uint32_t centre_hash(uint32_t seed, int32_t c) {
  return mix(uint32_t(c) ^ mix(seed ^ GOLD));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Row {
  int32_t lo, deg;
};

__device__ __forceinline__ Row centre_row(const int32_t* row_ptr, int64_t n_nodes, int32_t c) {
  const int64_t a = c < 0 ? 0 : (c > n_nodes ? n_nodes : c);
  const int64_t b1 = int64_t(c) + 1;
  const int64_t b = b1 < 0 ? 0 : (b1 > n_nodes ? n_nodes : b1);
  const int32_t lo = row_ptr[a];
  return {lo, int32_t(uint32_t(row_ptr[b]) - uint32_t(lo))};
}

struct Edges {
  const int32_t* col;  // [E], or nullptr with the pair table
  const float* w;      // [E], or nullptr with the pair table
  const int2* pairs;   // [E] (col, weight bits), or nullptr
  int64_t n;
};

__device__ __forceinline__ int64_t clamp_edge(int64_t e, int64_t n) {
  return e < 0 ? 0 : (e >= n ? n - 1 : e);
}

__device__ __forceinline__ float weight_at(const Edges& g, int64_t e) {
  if (g.n == 0) return 0.f;
  e = clamp_edge(e, g.n);
  return g.pairs ? __int_as_float(g.pairs[e].y) : g.w[e];
}

__device__ __forceinline__ int32_t col_at(const Edges& g, int64_t e) {
  e = clamp_edge(e, g.n);
  return g.pairs ? g.pairs[e].x : g.col[e];
}

// the A-Res key of offset o of a centre whose hash prefix is hc
__device__ __forceinline__ float edge_key(uint32_t hc, uint32_t key0, int32_t o, float w) {
  const uint32_t h = mix((key0 + uint32_t(o)) ^ hc);
  const float u = float(h >> 8) * (1.0f / 16777216.0f);
  return w > 0.f ? logf(fmaxf(u, 1e-20f)) / w : neg_inf();
}

struct HopOut {
  int32_t* nbrs;
  uint8_t* mask;
  int32_t* pos;
  int32_t* edge_ids;
  int32_t* degree;
};

// slot j of row r0 holds the edge at position p, neighbour nbr (or nothing)
__device__ __forceinline__ void store_slot(const HopOut& o, int64_t r0, int64_t j, int32_t lo,
                                           bool valid, int32_t p, int32_t nbr) {
  o.mask[r0 + j] = valid;
  o.pos[r0 + j] = valid ? p : 0;
  o.edge_ids[r0 + j] = int32_t(uint32_t(lo) + uint32_t(valid ? p : 0));
  o.nbrs[r0 + j] = valid ? nbr : -1;
}

// the same for a slot whose edge has this key, its neighbour read from the edges
__device__ __forceinline__ void write_slot(const HopOut& o, const Edges& g, int64_t r0, int j,
                                           int32_t lo, bool taken, float key, int32_t p) {
  const bool valid = taken && key > neg_inf();
  store_slot(o, r0, j, lo, valid, p, valid ? col_at(g, int64_t(lo) + p) : -1);
}

// The register path's network over element i = lane + 32 r of the first
// `rows` registers: the lower element of a pair keeps the smaller value.
// Values are never equal but past a row, where either copy is the same. T
// is the value's type (the 64-bit order value; tools/kernel_variants.py
// also sorts 32-bit prefixes through it).
//
// i pairs with i ^ m for m < 32: lane ^ m, one shuffle a register
template <int R, typename T>
__device__ __forceinline__ void lane_step(T (&v)[R], int rows, int lane, int m, bool lower) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows) {
      const T p = __shfl_xor_sync(FULL, v[r], m);
      v[r] = (p < v[r]) == lower ? p : v[r];
    }
}

// i pairs with i ^ 32 m: registers r and r ^ m of the same lane
template <int R, typename T>
__device__ __forceinline__ void reg_step(T (&v)[R], int rows, int m) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows && (r & m) == 0 && (r | m) < R) {
      const T a = v[r], b = v[r | m];
      v[r] = a < b ? a : b;
      v[r | m] = a < b ? b : a;
    }
}

// a merge's first step above 32: i pairs with its mirror i ^ (32 (m + 1) -
// 1), lane ^ 31 of register r ^ m
template <int R, typename T>
__device__ __forceinline__ void mirror_step(T (&v)[R], int rows, int m) {
  T p[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows) p[r] = __shfl_xor_sync(FULL, v[r ^ m], 31);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows) v[r] = (p[r] < v[r]) == (r < (r ^ m)) ? p[r] : v[r];
}

// Sort the first W = 2^LOGW <= 32 R values ascending. Every block is
// sorted ascending (a merge's first step pairs i with its mirror i ^ (k -
// 1)), so a step's direction is only which element is the lower: one
// compare and one select a value.
template <int LOGW, int R, typename T>
__device__ __forceinline__ void bitonic(T (&v)[R], int lane) {
  constexpr int W = 1 << LOGW;
  constexpr int ROWS = W > 32 ? W / 32 : 1;
#pragma unroll
  for (int k = 2; k <= W; k <<= 1) {
    if (k <= 32)
      lane_step(v, ROWS, lane, k - 1, (lane & (k >> 1)) == 0);
    else
      mirror_step(v, ROWS, k / 32 - 1);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) {
      if (j >= 32)
        reg_step(v, ROWS, j / 32);
      else
        lane_step(v, ROWS, lane, j, (lane & j) == 0);
    }
  }
}

// bitonic<logw>, for the row's power-of-two width 2^logw <= 32 R
template <int LOGW, int R, typename T>
__device__ __forceinline__ void sort_width(T (&v)[R], int lane, int logw) {
  if constexpr (LOGW > 0) {
    if (logw == LOGW)
      bitonic<LOGW>(v, lane);
    else
      sort_width<LOGW - 1>(v, lane, logw);
  }
}

// x[p / 32] of lane p % 32 for a position p < d (d warp-uniform): what the
// lane that loaded position p keeps beside it
template <int R, typename T>
__device__ __forceinline__ T from_position(const T (&x)[R], int32_t p, int32_t d) {
  T out = T(0);
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (32 * q < d) {
      const T y = __shfl_sync(FULL, x[q], p & 31);
      if ((p >> 5) == q) out = y;
    }
  return out;
}

// WarpSelect's merge (Johnson, Douze and Jegou, "Billion-scale similarity
// search with GPUs") for a row that needs only its 32 smallest values: each
// of the first `rows` registers sorted ascending by itself, then merged one
// at a time into register 0 (its mirror's minimum, a bitonic run, then the
// half-cleaners), which keeps the 32 smallest, ascending
template <int R, typename T>
__device__ __forceinline__ void warp_select(T (&v)[R], int lane, int rows) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
    lane_step(v, rows, lane, k - 1, (lane & (k >> 1)) == 0);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) lane_step(v, rows, lane, j, (lane & j) == 0);
  }
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r < rows) {
      const T p = __shfl_xor_sync(FULL, v[r], 31);
      v[0] = p < v[0] ? p : v[0];
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) lane_step(v, 1, lane, j, (lane & j) == 0);
    }
}

// A row of d <= 32 R edges: each lane loads its edges lane + 32 r once
// (coalesced), keys them and keeps the neighbour beside the order value
// (bits(key) & 0x7fffffff) << 32 | position (past the row 2^64 - 1, which
// sorts last); the warp sorts the values (in the tier of R_LARGE with K <=
// 32, only the 32 smallest, by WarpSelect's merge), slot j takes the j-th,
// and its neighbour comes from the lane that loaded that position.
template <int R>
__device__ __forceinline__ void register_row(const Edges& g, const HopOut& o, Row row,
                                             int32_t d, int K, int64_t r0, uint32_t hc,
                                             uint32_t key0, int lane) {
  const int32_t take = d < K ? d : K;
  uint64_t v[R];
  int32_t nb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane + 32 * r;
    nb[r] = -1;
    v[r] = ~uint64_t(0);
    if (e < d) {
      float w = 0.f;
      if (g.n > 0) {
        const int64_t x = clamp_edge(int64_t(row.lo) + e, g.n);
        if (g.pairs) {
          const int2 pr = g.pairs[x];
          nb[r] = pr.x;
          w = __int_as_float(pr.y);
        } else {
          nb[r] = g.col[x];
          w = g.w[x];
        }
      }
      const uint32_t kb = __float_as_uint(edge_key(hc, key0, e, w)) & 0x7fffffffu;
      v[r] = uint64_t(kb) << 32 | uint32_t(e);
    }
  }
  if (R == R_LARGE && take <= 32)
    warp_select(v, lane, (d + 31) / 32);
  else
    sort_width<log2_of(32 * R)>(v, lane, d <= 1 ? 0 : 32 - __clz(d - 1));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (32 * r >= take) break;  // warp-uniform
    const int32_t p = int32_t(uint32_t(v[r]));
    const int32_t nbr = from_position(nb, p, d);
    const int j = lane + 32 * r;
    if (j < take)  // a -inf key (0x7f800000 without its sign) is masked
      store_slot(o, r0, j, row.lo, uint32_t(v[r] >> 32) != 0x7f800000u, p, nbr);
  }
  for (int64_t j = take + lane; j < K; j += 32) store_slot(o, r0, j, row.lo, false, 0, -1);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
hop_weighted(const int32_t* __restrict__ row_ptr, int64_t n_nodes, Edges g,
             const int32_t* __restrict__ centers, int64_t B, int K, uint32_t seed, uint32_t key0,
             HopOut o, int list_in_smem) {
  // (list_in_smem) [WARPS][K] list key bits and [WARPS][K] list positions
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = int64_t(blockIdx.x) * WARPS + warp;
  if (b >= B) return;  // no block-wide barrier below
  const int32_t c = centers[b];
  const Row row = centre_row(row_ptr, n_nodes, c);
  if (lane == 0) o.degree[b] = row.deg;
  if (K == 0) return;
  const int32_t d = row.deg > 0 ? row.deg : 0;
  const int64_t r0 = b * K;
  const uint32_t hc = centre_hash(seed, c);
  if (d <= 32 * R_SMALL) {
    register_row<R_SMALL>(g, o, row, d, K, r0, hc, key0, lane);
    return;
  }
  if (d <= REG_EDGES) {
    register_row<R_LARGE>(g, o, row, d, K, r0, hc, key0, lane);
    return;
  }
  int32_t* lk;  // key bits, sorted by (key descending, position ascending)
  int32_t* lp;  // positions
  if (list_in_smem) {
    lk = smem + warp * K;
    lp = smem + WARPS * K + warp * K;
  } else {
    lk = o.edge_ids + r0;
    lp = o.pos + r0;
  }
  int32_t cnt = 0;
  for (int32_t base = 0; base < d; base += 32) {
    const int32_t e = base + lane;
    const float k = e < d ? edge_key(hc, key0, e, weight_at(g, int64_t(row.lo) + e)) : neg_inf();
    const bool full = cnt == K;
    const float thr = full ? __int_as_float(lk[K - 1]) : neg_inf();
    unsigned cand = __ballot_sync(FULL, e < d && (!full || k > thr));
    while (cand) {
      const int s = __ffs(cand) - 1;
      cand &= cand - 1;
      const float ks = __shfl_sync(FULL, k, s);
      if (cnt == K && !(ks > __int_as_float(lk[K - 1]))) continue;  // warp-uniform
      int32_t part = 0;
      for (int i = lane; i < cnt; i += 32) part += __int_as_float(lk[i]) >= ks ? 1 : 0;
      const int32_t m = int32_t(__reduce_add_sync(FULL, uint32_t(part)));
      const int32_t top = cnt < K ? cnt : K - 1;  // lk[m .. top-1] -> lk[m+1 .. top]
      if (m < top) {
        for (int base_i = (top - 1) & ~31; base_i >= (m & ~31); base_i -= 32) {
          const int i = base_i + lane;
          const bool move = i >= m && i < top;
          int32_t vk = 0, vp = 0;
          if (move) {
            vk = lk[i];
            vp = lp[i];
          }
          __syncwarp();
          if (move) {
            lk[i + 1] = vk;
            lp[i + 1] = vp;
          }
          __syncwarp();
        }
      }
      if (lane == 0) {
        lk[m] = __float_as_int(ks);
        lp[m] = base + s;
      }
      __syncwarp();
      cnt = cnt < K ? cnt + 1 : K;
    }
  }
  __syncwarp();  // the list is complete before its home (maybe the outputs) is rewritten
  for (int j = lane; j < K; j += 32) {
    const bool listed = j < cnt;
    const float k = listed ? __int_as_float(lk[j]) : 0.f;
    const int32_t p = listed ? lp[j] : 0;
    write_slot(o, g, r0, j, row.lo, listed, k, p);
  }
}

}  // namespace

extern "C" int wg_sample_hop_weighted(const void* row_ptr, int64_t n_nodes, const void* col,
                                      const void* weights, const void* pairs, int64_t n_edges,
                                      const void* centers, int64_t B, int64_t K, uint32_t seed,
                                      uint32_t key0, void* nbrs, void* mask, void* pos,
                                      void* edge_ids, void* degree, void* stream) {
  if (B <= 0 || K < 0 || K >= (int64_t(1) << 31) || n_nodes < 0 || n_edges < 0 ||
      n_edges >= (int64_t(1) << 31) || B * K >= (int64_t(1) << 62) ||
      (pairs == nullptr && (col == nullptr || weights == nullptr)) ||
      (pairs != nullptr && reinterpret_cast<uintptr_t>(pairs) % 8 != 0))
    return int(cudaErrorInvalidValue);
  const Edges g{static_cast<const int32_t*>(col), static_cast<const float*>(weights),
                static_cast<const int2*>(pairs), n_edges};
  const HopOut o{static_cast<int32_t*>(nbrs), static_cast<uint8_t*>(mask),
                 static_cast<int32_t*>(pos), static_cast<int32_t*>(edge_ids),
                 static_cast<int32_t*>(degree)};
  const int64_t list_bytes = int64_t(WARPS) * K * 8;
  const int in_smem = list_bytes <= SMEM_LIMIT;
  const size_t smem = size_t(in_smem ? list_bytes : 0);
  const unsigned blocks = unsigned((B + WARPS - 1) / WARPS);
  hop_weighted<<<blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), n_nodes, g, static_cast<const int32_t*>(centers), B,
      int(K), seed, key0, o, in_smem);
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
