// Kernel C: the uniform sampler, one launch per hop, and its column fetch.
//
// Replaces the pair of TPU kernels that fetched the sampled columns,
// `_gather_slab_kernel` (wholegraph_tpu/ops/gather_pallas.py:346), which DMAd
// each centre's enclosing 128-lane blocks of `col` into a [B, nb*128] slab,
// and `_select_lanes_kernel` (gather_pallas.py:445), which picked lane
// loc[b, k] out of that slab and asserted K <= 128 (gather_pallas.py:482),
// together with the XLA draw and rank fixpoint that fed them
// (wholegraph_tpu/ops/sampling.py:141-174, the unweighted branch of
// `csr_sample_neighbors`, :696-763). The block and lane arithmetic existed
// because a TPU DMA moves 128-lane rows; a GPU thread loads one 4-byte
// element directly, so there is neither a slab nor a limit on K.
//
// Two entries:
//
// wg_sample_hop_uniform: the whole hop. For each centre c (of B) it writes
// all five fields of `SampleResult`: degree, with the centre id clamped as
// the plain version does (lo = row_ptr[clamp(c, 0, N)], hi =
// row_ptr[clamp(c + 1, 0, N)]); K draws r_j = randint(seed, c, key0 + j,
// max(deg - j, 1)), the murmur3-finaliser counter hash of ops/rng.py in
// native uint32 arithmetic (seed, centre and key wrap as uint32, a uint32
// modulo); each slot's position; the mask slot < min(deg, K); positions 0
// where masked; edge_ids = lo + pos in int32; neighbours col[clamp(lo + pos,
// 0, E - 1)] or -1. A centre with deg <= K takes positions 0..deg-1 and
// draws nothing.
//
//   Position of slot j: the least fixpoint p of p = r_j + #{chosen <= p},
//   over the positions chosen for slots < j. The plain version
//   (ops/sampling.py) and the JAX package iterate p <- r_j + #{chosen <= p}
//   from p = r_j for j + 1 rounds; `host_sample_uniform` iterates to
//   convergence. Both reach the least fixpoint: the map is monotone and
//   starts below every fixpoint, each round that moves p raises the count by
//   at least one, and the count is at most j, so j + 1 rounds converge.
//   Here a centre keeps its chosen positions sorted, s_0 < s_1 < ... <
//   s_{j-1} (distinct, because a least fixpoint is never itself chosen: were
//   p = s_i, then p - 1 >= r_j would be a smaller fixpoint). Scanning them in
//   ascending order from p = r_j and stepping p up once for every s_k <= p
//   stops stepping at the first s_k > p, so it steps exactly for the k with
//   s_k <= r_j + k, that is s_k - k <= r_j; s_k - k never decreases with k, so
//   those k are a prefix, of length m = #{k : s_k - k <= r_j}. p = r_j + m
//   is a fixpoint (s_0..s_{m-1} <= p < s_m), and no smaller one exists (by
//   induction any fixpoint q >= r_j + k once s_0..s_{k-1} <= r_j + k - 1 <=
//   q), so it is the plain version's p, bit for bit; p is then inserted at
//   index m to keep the picks sorted. The count m is a sum of independent
//   compares, so a thread (or a warp) forms it without a serial chain.
//   Degrees of 2^30 or more are outside the contract, as they are for the
//   plain version, whose unfilled slots hold the sentinel 2^30.
//
// wg_sample_cols: the fetch alone, nbrs[b, k] = mask[b, k] ?
// col[clamp(start[b] + pos[b, k], 0, E - 1)] : -1, for a position draw made
// elsewhere. No path launches it (kernel K fetches the weighted sampler's
// columns itself); chip_smoke.py checks and times it. One thread per (b, k).
//
// Bound: the hop moves little (B * (4 + 8 + 4) bytes of centres, row_ptr
// pairs and degrees, 4 bytes of `col` per valid slot, B * K * 13 bytes of
// outputs: about 2 MB at B = 11264, K = 15), so what bounds it on this card
// is latency and launch count: the plain version is about 60 launches of
// emulated uint32 hashing and ~3 launches per fixpoint round, some 350
// launches per hop at fanouts (10, 15). Design: the hop is one launch whose
// work per centre is O(K^2), independent of its degree (a hub of degree 10^6
// costs what any centre costs), with no atomics, so the output is
// deterministic.
//  - K <= 32 (templated at 16 and 32): one thread per centre, its sorted
//    picks in registers (fully unrolled compares and an insertion by
//    compare-and-swap, no dynamic indexing, so nothing spills), its
//    positions staged in shared memory; the block then writes all four
//    [B, K] outputs as one contiguous, coalesced run and loads the `col`
//    entries of its valid slots, one per thread, all in flight together.
//  - K > 32: one warp per centre. Lanes draw 32 slots at once; for each slot
//    the warp counts m with one compare per pick and a warp sum, shifts the
//    picks above m up by one (top chunk first), and writes 32 positions at
//    a time, coalesced. The picks live in shared memory while 4 warps' K
//    picks fit 48 KB (K <= 3072), and otherwise in the centre's own row of
//    the edge_ids output, which is rewritten last: any K is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t C1 = 0x85EBCA6Bu;
constexpr uint32_t C2 = 0xC2B2AE35u;
constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr int SMALL_THREADS = 64;
constexpr int WARP_CENTRES = 4;  // warps (centres) per block of the warp kernel
constexpr int64_t SMEM_PICKS = 48 * 1024;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 13;
  x *= C2;
  x ^= x >> 16;
  return x;
}

// rand_u32(seed, c, key) = mix(key ^ mix(c ^ mix(seed ^ GOLD))): `hc` is the
// first two rounds, which depend on the centre only.
__device__ __forceinline__ uint32_t centre_hash(uint32_t seed, int32_t c) {
  return mix(uint32_t(c) ^ mix(seed ^ GOLD));
}

__device__ __forceinline__ int32_t draw(uint32_t hc, uint32_t key, int32_t n) {
  return int32_t(mix(key ^ hc) % uint32_t(n < 1 ? 1 : n));
}

struct Row {
  int32_t lo, deg;
};

// lo and degree of centre c, its id clamped into [0, N] as the plain version does
__device__ __forceinline__ Row centre_row(const int32_t* row_ptr, int64_t n_nodes, int32_t c) {
  const int64_t a = c < 0 ? 0 : (c > n_nodes ? n_nodes : c);
  const int64_t b1 = int64_t(c) + 1;
  const int64_t b = b1 < 0 ? 0 : (b1 > n_nodes ? n_nodes : b1);
  const int32_t lo = row_ptr[a];
  return {lo, int32_t(uint32_t(row_ptr[b]) - uint32_t(lo))};
}

__device__ __forceinline__ int32_t fetch_col(const int32_t* col, int64_t n_edges, int32_t lo,
                                             int32_t p) {
  int64_t e = int64_t(lo) + p;
  e = e < 0 ? 0 : (e >= n_edges ? n_edges - 1 : e);
  return col[e];
}

struct HopOut {
  int32_t* nbrs;
  uint8_t* mask;
  int32_t* pos;
  int32_t* edge_ids;
  int32_t* degree;
};

// K <= KMAX: one thread per centre, picks in registers
template <int KMAX>
__global__ void __launch_bounds__(SMALL_THREADS)
hop_small(const int32_t* __restrict__ row_ptr, int64_t n_nodes, const int32_t* __restrict__ col,
          int64_t n_edges, const int32_t* __restrict__ centers, int64_t B, int K, uint32_t seed,
          uint32_t key0, HopOut o) {
  extern __shared__ int32_t stage[];  // [SMALL_THREADS][K] positions, row-major
  __shared__ Row rows[SMALL_THREADS];
  const int64_t b0 = int64_t(blockIdx.x) * SMALL_THREADS;
  const int64_t b = b0 + threadIdx.x;
  if (b < B) {
    const int32_t c = centers[b];
    const Row row = centre_row(row_ptr, n_nodes, c);
    o.degree[b] = row.deg;
    rows[threadIdx.x] = row;
    int32_t* mine = stage + threadIdx.x * K;
    if (row.deg <= K) {
      for (int j = 0; j < K; ++j) mine[j] = j < row.deg ? j : 0;
    } else {
      const uint32_t hc = centre_hash(seed, c);
      int32_t s[KMAX];  // picks so far, ascending
#pragma unroll
      for (int i = 0; i < KMAX; ++i) s[i] = 0;
#pragma unroll 1
      for (int j = 0; j < K; ++j) {
        const int32_t r = draw(hc, key0 + uint32_t(j), row.deg - j);
        int32_t m = 0;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) m += (i < j && s[i] - i <= r) ? 1 : 0;
        const int32_t p = r + m;
        int32_t carry = p;  // insert p: the larger of each pair moves up
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i < j) {
            const int32_t t = s[i];
            const bool up = t > carry;
            s[i] = up ? carry : t;
            carry = up ? t : carry;
          } else if (i == j) {
            s[i] = carry;
          }
        }
        mine[j] = p;
      }
    }
  }
  __syncthreads();
  // the block's outputs are rows b0 .. b0 + nb - 1: one contiguous run of nb * K
  const int nb = int(B - b0 < SMALL_THREADS ? B - b0 : SMALL_THREADS);
  const int total = nb * K;
  const int64_t g0 = b0 * K;
  for (int t = threadIdx.x; t < total; t += SMALL_THREADS) {
    const int lb = t / K, j = t - lb * K;
    const Row row = rows[lb];
    const bool valid = j < (row.deg < K ? row.deg : K);
    const int32_t p = stage[t];
    o.mask[g0 + t] = valid;
    o.pos[g0 + t] = p;
    o.edge_ids[g0 + t] = int32_t(uint32_t(row.lo) + uint32_t(p));
    o.nbrs[g0 + t] = (valid && n_edges > 0) ? fetch_col(col, n_edges, row.lo, p) : -1;
  }
}

// K > 32: one warp per centre, picks in shared memory or in the centre's edge_ids row
__global__ void __launch_bounds__(WARP_CENTRES * 32)
hop_warp(const int32_t* __restrict__ row_ptr, int64_t n_nodes, const int32_t* __restrict__ col,
         int64_t n_edges, const int32_t* __restrict__ centers, int64_t B, int K, uint32_t seed,
         uint32_t key0, HopOut o, int picks_in_smem) {
  extern __shared__ int32_t smem_picks[];  // [WARP_CENTRES][K] when picks_in_smem
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = int64_t(blockIdx.x) * WARP_CENTRES + warp;
  if (b >= B) return;  // no block-wide barrier below
  const int32_t c = centers[b];
  const Row row = centre_row(row_ptr, n_nodes, c);
  if (lane == 0) o.degree[b] = row.deg;
  const int64_t r0 = b * K;
  if (row.deg <= K) {
    for (int j = lane; j < K; j += 32) {
      const bool valid = j < row.deg;
      const int32_t p = valid ? j : 0;
      o.mask[r0 + j] = valid;
      o.pos[r0 + j] = p;
      o.edge_ids[r0 + j] = int32_t(uint32_t(row.lo) + uint32_t(p));
      o.nbrs[r0 + j] = (valid && n_edges > 0) ? fetch_col(col, n_edges, row.lo, p) : -1;
    }
    return;
  }
  int32_t* s = picks_in_smem ? smem_picks + int64_t(warp) * K : o.edge_ids + r0;
  const uint32_t hc = centre_hash(seed, c);
  for (int j0 = 0; j0 < K; j0 += 32) {
    const int jl = j0 + lane;
    const int32_t mine_r = jl < K ? draw(hc, key0 + uint32_t(jl), row.deg - jl) : 0;
    int32_t kept = 0;
    const int n_here = K - j0 < 32 ? K - j0 : 32;
    for (int jj = 0; jj < n_here; ++jj) {
      const int j = j0 + jj;
      const int32_t r = __shfl_sync(0xffffffffu, mine_r, jj);
      int32_t cnt = 0;
      for (int k = lane; k < j; k += 32) cnt += (s[k] - k <= r) ? 1 : 0;
      const int32_t m = int32_t(__reduce_add_sync(0xffffffffu, uint32_t(cnt)));
      const int32_t p = r + m;
      // s[m .. j-1] -> s[m+1 .. j], the highest chunk of 32 first
      if (m < j) {
        for (int base = (j - 1) & ~31; base >= (m & ~31); base -= 32) {
          const int k = base + lane;
          const bool move = k >= m && k < j;
          const int32_t v = move ? s[k] : 0;
          __syncwarp();
          if (move) s[k + 1] = v;
          __syncwarp();
        }
      }
      if (lane == 0) s[m] = p;
      __syncwarp();
      if (lane == jj) kept = p;
    }
    if (jl < K) o.pos[r0 + jl] = kept;
  }
  __syncwarp();  // every read of the picks is done before edge_ids (maybe their home) is written
  for (int j = lane; j < K; j += 32) {
    const int32_t p = o.pos[r0 + j];  // written by this lane above
    o.mask[r0 + j] = 1;
    o.edge_ids[r0 + j] = int32_t(uint32_t(row.lo) + uint32_t(p));
    o.nbrs[r0 + j] = n_edges > 0 ? fetch_col(col, n_edges, row.lo, p) : -1;
  }
}

__global__ void sample_cols_kernel(const int32_t* __restrict__ col,
                                   int64_t n_edges,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ pos,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ out, int64_t B,
                                   int64_t K) {
  const int64_t total = B * K;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    int32_t v = -1;
    if (mask[t]) {
      int64_t e = int64_t(start[t / K]) + int64_t(pos[t]);
      e = e < 0 ? 0 : (e >= n_edges ? n_edges - 1 : e);
      v = col[e];
    }
    out[t] = v;
  }
}

}  // namespace

extern "C" int wg_sample_hop_uniform(const void* row_ptr, int64_t n_nodes, const void* col,
                                     int64_t n_edges, const void* centers, int64_t B, int64_t K,
                                     uint32_t seed, uint32_t key0, void* nbrs, void* mask,
                                     void* pos, void* edge_ids, void* degree, void* stream) {
  if (B <= 0 || K < 0 || K >= (int64_t(1) << 31) || n_nodes < 0 || n_edges < 0 ||
      B * K >= (int64_t(1) << 62))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HopOut o{static_cast<int32_t*>(nbrs), static_cast<uint8_t*>(mask),
                 static_cast<int32_t*>(pos), static_cast<int32_t*>(edge_ids),
                 static_cast<int32_t*>(degree)};
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* cl = static_cast<const int32_t*>(col);
  const auto* ce = static_cast<const int32_t*>(centers);
  const int k = int(K);
  if (K <= 32) {
    const unsigned blocks = unsigned((B + SMALL_THREADS - 1) / SMALL_THREADS);
    const size_t smem = size_t(SMALL_THREADS) * size_t(K) * 4;
    if (K <= 16)
      hop_small<16><<<blocks, SMALL_THREADS, smem, st>>>(rp, n_nodes, cl, n_edges, ce, B, k, seed,
                                                         key0, o);
    else
      hop_small<32><<<blocks, SMALL_THREADS, smem, st>>>(rp, n_nodes, cl, n_edges, ce, B, k, seed,
                                                         key0, o);
  } else {
    const unsigned blocks = unsigned((B + WARP_CENTRES - 1) / WARP_CENTRES);
    const int64_t want = int64_t(WARP_CENTRES) * K * 4;
    const int in_smem = want <= SMEM_PICKS;
    hop_warp<<<blocks, WARP_CENTRES * 32, in_smem ? size_t(want) : 0, st>>>(
        rp, n_nodes, cl, n_edges, ce, B, k, seed, key0, o, in_smem);
  }
  return int(cudaGetLastError());
}

extern "C" int wg_sample_cols(const void* col, int64_t n_edges,
                              const void* start, const void* pos,
                              const void* mask, void* out, int64_t B,
                              int64_t K, void* stream) {
  if (B <= 0 || K <= 0 || n_edges <= 0) return int(cudaErrorInvalidValue);
  const int threads = 256;
  int64_t blocks = (B * K + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  sample_cols_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col), n_edges,
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(out), B, K);
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
