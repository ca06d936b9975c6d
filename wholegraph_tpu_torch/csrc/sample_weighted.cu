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
// Bound: the hop reads each centre's row_ptr pair and its edges' weights
// once (8 bytes an edge with the pair table) and writes B * K * 13 + 4B
// bytes: about 30 MB, 0.009 ms at 3.35 TB/s, at bench_sampling's shape
// (B = 65536, degrees 16..48, K = 15). What bounds this kernel is its
// arithmetic per edge (three hash rounds, a `logf`, a division) and the
// ranking, in one launch for the hop (the plain version is tens of launches
// and a sort).
//
// Design: one warp per centre, 8 centres a block, no atomics, so the output
// is deterministic.
//  - deg <= STAGE: the warp computes its keys into a stage in shared memory,
//    lane by lane (coalesced weight loads); each lane ranks its keys by a
//    count over the stage, rank(o) = #{f : key_f > key_o or (key_f == key_o
//    and f < o)}, a total order, so ranks 0..deg-1 are a permutation, and
//    the edge of rank r < K writes slot r. O(deg^2 / 32) compares a lane.
//  - deg > STAGE: a running top-K list, sorted in the order above, over
//    chunks of 32 edges. A chunk's edges that beat the list's last key
//    (or all while it holds fewer than K) are inserted one at a time in
//    position order: the insertion index is #{list keys >= key}, since
//    every listed edge has a lower position, and the entries above it
//    shift up by one, the highest 32 first. A hub costs O(deg + inserts *
//    K / 32), not O(deg^2). The list lives in shared memory while 8 warps'
//    K entries fit beside the stages (K <= 640), else in the centre's own
//    rows of the pos and edge_ids outputs (key bits in edge_ids), which
//    are rewritten last: any K is taken.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t C1 = 0x85EBCA6Bu;
constexpr uint32_t C2 = 0xC2B2AE35u;
constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;    // centres (warps) per block
constexpr int STAGE = 256;  // keys a warp ranks in shared memory
constexpr int64_t SMEM_LIMIT = 48 * 1024;

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

// slot j of row r0 holds the edge at position p with this key (or nothing)
__device__ __forceinline__ void write_slot(const HopOut& o, const Edges& g, int64_t r0, int j,
                                           int32_t lo, bool taken, float key, int32_t p) {
  const bool valid = taken && key > neg_inf();
  const int32_t pp = valid ? p : 0;
  o.mask[r0 + j] = valid;
  o.pos[r0 + j] = pp;
  o.edge_ids[r0 + j] = int32_t(uint32_t(lo) + uint32_t(pp));
  o.nbrs[r0 + j] = valid ? col_at(g, int64_t(lo) + pp) : -1;
}

__global__ void __launch_bounds__(WARPS * 32)
hop_weighted(const int32_t* __restrict__ row_ptr, int64_t n_nodes, Edges g,
             const int32_t* __restrict__ centers, int64_t B, int K, uint32_t seed, uint32_t key0,
             HopOut o, int list_in_smem) {
  // [WARPS][STAGE] stage keys, then (list_in_smem) [WARPS][K] list key bits
  // and [WARPS][K] list positions
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = int64_t(blockIdx.x) * WARPS + warp;
  if (b >= B) return;  // no block-wide barrier below
  const int32_t c = centers[b];
  const Row row = centre_row(row_ptr, n_nodes, c);
  if (lane == 0) o.degree[b] = row.deg;
  if (K == 0) return;
  const int32_t d = row.deg > 0 ? row.deg : 0;
  const int32_t take = d < K ? d : K;
  const int64_t r0 = b * K;
  const uint32_t hc = centre_hash(seed, c);
  if (d <= STAGE) {
    float* stage = reinterpret_cast<float*>(smem) + warp * STAGE;
    for (int e = lane; e < d; e += 32)
      stage[e] = edge_key(hc, key0, e, weight_at(g, int64_t(row.lo) + e));
    __syncwarp();
    for (int e = lane; e < d; e += 32) {
      const float k = stage[e];
      int32_t rank = 0;
      for (int f = 0; f < d; ++f) {
        const float kf = stage[f];
        rank += (kf > k || (kf == k && f < e)) ? 1 : 0;
      }
      if (rank < K) write_slot(o, g, r0, rank, row.lo, true, k, e);
    }
    for (int j = take + lane; j < K; j += 32) write_slot(o, g, r0, j, row.lo, false, 0.f, 0);
    return;
  }
  int32_t* lk;  // key bits, sorted by (key descending, position ascending)
  int32_t* lp;  // positions
  if (list_in_smem) {
    lk = smem + WARPS * STAGE + warp * K;
    lp = smem + WARPS * STAGE + WARPS * K + warp * K;
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
  const int64_t stage_bytes = int64_t(WARPS) * STAGE * 4;
  const int64_t list_bytes = int64_t(WARPS) * K * 8;
  const int in_smem = stage_bytes + list_bytes <= SMEM_LIMIT;
  const size_t smem = size_t(stage_bytes + (in_smem ? list_bytes : 0));
  const unsigned blocks = unsigned((B + WARPS - 1) / WARPS);
  hop_weighted<<<blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), n_nodes, g, static_cast<const int32_t*>(centers), B,
      int(K), seed, key0, o, in_smem);
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
