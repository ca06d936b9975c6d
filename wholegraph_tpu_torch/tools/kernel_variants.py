"""Design alternatives of kernels A, B, D, G, J, K and L, timed against the
kernels as built: ``python3 -m wholegraph_tpu_torch.tools.kernel_variants
[--out FILE] [--parts A B D G J K L] [--k-parent FILE]``.

Each variant is the current source of ``csrc/row_gather.cu`` (A; J, with
``direct_gather.cuh`` inlined where the variant changes it),
``csrc/row_scatter.cu`` (B, with ``row_scatter.cuh`` inlined where the
variant changes it), ``csrc/neighbor_agg.cu`` (D), ``csrc/csr_spmm.cu`` (G)
``csrc/sample_weighted.cu`` (K) or ``csrc/sparse_apply.cu`` (L) with one
stated change, applied by text
substitution
that must match: a variant whose text no longer matches the source is
reported as such and not built, so the tool never holds the kernels to its
own copy of them. The variants are built with the port's ``nvcc`` flags into
``wholegraph_tpu_torch/_build/variants/`` (one ``nvcc`` each, all started
together) and called through the kernel's own wrapper, its ``Kernel``
pointed at the variant's entry for the call. Each variant's output is held
bit-equal to the kernel's, except a probe's: a probe removes one step of a
kernel, so that the time of that step is the kernel's time less the
probe's, and its output is not kept.

* A and B at each distinct call of one hetero step at
  ``HeteroTrainConfig()`` (the typed gather's off-type slots -1, clipped
  onto row 0, and the same slots spread over random rows), of one SAGE
  step at ``SageTrainConfig()``, and B at ``bench_scatter``'s masked
  write: A over tiles of 4-64 KB of output (``GATHER_TILE_BYTES``), B
  over tiles of 16-512 ids (``scatter_tile``); variants: one warp a row
  (each kernel's earlier design), A's tile's first row read once into
  shared memory, B with 8 loads of ``rows`` in flight a thread; beside
  each call's bound and ``index_select`` / ``index_copy_``, by device time
  alone; a probe of B that reads its ids and writes no row.
* D at its calls (a)-(f) of ``chip_smoke.py --paired-times agg`` (the
  SAGE step's two layers, the sampled GCN's 16-wide last layer,
  ``bench_spmm_sampled``'s block, ``bench_spmm``'s, the first layer in
  bf16): D as built, under every plan it takes at the call (lanes a
  centre and slices a row, forced over ``ops.spmm_kernels.agg_plan``),
  and its variants: 8 and 2 row vectors in flight a lane (4 as built),
  rolling loads (each neighbour's load issued as the one U before it is
  added), a warp that walks its row's slices in turn (the earlier
  kernel's order), persistent warps on 132 x 8 and 132 x 32 CTAs,
  ordinary loads, 16-byte loads with a 256-byte L2 prefetch, kept in L2
  (evict_last) or not kept in L1, ordinary stores, 256-thread CTAs; a
  probe that reads no row; beside each call's bound and
  ``embedding_bag``, by device time alone; also ``bench_spmm``'s call over
  a table a quarter and four times as tall. ``--d-parent FILE`` builds
  another tree's ``neighbor_agg.cu`` of the earlier design (one warp a
  centre) beside D.
* G at ``bench_spmm_clustered``'s shapes (``clustered_csr(2^20, 16, 192)``,
  x [2^20, 256] f32): mean, weighted sum, and the weighted sum over the
  transposed CSR; variants: two barriers a slab, rows in CSR order (no
  rank by degree), ranks k and n - 1 - k on one thread of a 256-thread CTA,
  one vector a thread with ranks folded (snake order), the tile decision
  folded into the window kernel (two launches a call, no span kernel),
  slabs of 64 bytes at three CTAs an SM; probes: the span and rows
  launches alone (the window kernel returns at once), the window kernel
  without its edge loop (staging, ranks and stores), the edge loop without
  reads of x from shared memory. Beside them, each G kernel's registers,
  spills and shared memory as ``-Xptxas -v`` gave them in the build.
* J at ``bench_gather``'s shapes (2^19 uniform ids into a 4,000,000 x 256
  f32 table): tiles of 4, 8, 16 and 32 KB of output (``MASKED_TILE_BYTES``);
  variants: streaming stores (``st.global.cs``), loads through the
  read-only path (``ld.global.nc``), persistent CTAs that prefetch the next
  tile's ids; beside kernel A and ``index_select``.
* K at the hop of ``bench_sampling(weighted=True)`` (2,000,000 rows of
  degrees 16..48, 65,536 centres, K = 15), at the same hop over rows of
  64..256 edges, and at the two hops of a step of
  ``SageTrainConfig(sample_method="weighted")`` (1,024 centres at K = 10,
  then 11,264 at K = 15), on the pair table: its register path's
  alternatives (one tier of 8 edges a lane for every row to 256; tiers of
  2, 4 and 8; no register cap; 8 CTAs an SM at 32 registers; 2 warps a
  block; a network that sets each step's direction per element; the full
  sort in the tier of 8 in place of WarpSelect's merge, and that merge in
  both tiers; a sort of 32-bit key prefixes with an exact check) and probes
  (centre rows only; keys only, nothing written; no sort; the sort over
  plain weights; no neighbour shuffle), each kernel's registers beside
  them. ``--k-parent`` builds another tree's ``sample_weighted.cu`` beside K
  (a ``git archive`` of the parent commit: the design before the register
  path, a rank count in shared memory up to 256 edges) with that design's
  probes (centre rows only; no rank count; the count over plain weights; no
  second read of the neighbour; keys only).
* L at the sparse apply's calls (a)-(d) of ``chip_smoke.py --paired-times
  apply`` (the SAGE step's, ``bench_apply``'s after its dedup, the hetero
  step's three typed calls, the SAGE step's over a bf16 table): over tiles
  of 8-128 KB of f32 rows (``APPLY_TILE_BYTES``), and its variants: 1 and 4
  (row, vector) items in flight a thread (2 as built), at most 40
  registers (6 CTAs an SM), streaming stores; a probe that reads its ids
  and finds none valid; beside each call's bound, by device time alone,
  each kernel's registers beside them. L's host route at the host-tier
  SAGE step's apply call (``SageTrainConfig()`` with
  ``host_cache_ratio=0.25``: the table, m and v pinned, the slots
  ascending) over tiles of 2-128 KB (``APPLY_HOST_TILE_BYTES``), 1, 4 and
  8 items in flight a thread (2 as built, ``APPLY_ITEMS``), with tiles
  of 4 and 8 KB too, the variants above, and three probes that take one direction off the link
  (reads only, the writes skipped; writes only, zeros in place of the host
  reads; the table's reads alone), which show how far the route overlaps
  its reads and writes;
  beside the composed route (E, the update, F, B) and the bounds of both
  directions at once and one after the other, by device time.
  ``--parts`` limits the run to some of A, B, D, G, J, K and L.

Every function is timed in turns, three rounds, by CUDA events (the median)
and once as device time from a CUDA graph of 20 calls. Prints one JSON
line (and, with ``--out``, writes it). Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..full_graph import clustered_csr
from ..graph import GraphStructure
from ..ops import gather_kernels as G
from ..ops import sampling as SM
from ..ops import spmm_kernels as S
from ..ops.sampling import interleave_col_weights
from ..train import SageTrainConfig

VARIANT_DIR = os.path.join(kernels.BUILD_DIR, "variants")

_G_SLAB_LOOP = """  for (int s = 0; s < n_slabs; ++s) {
    wait_copies<0>();
    // slab s, and before the first the edges' ranks, are in; every thread is
    // done with slab s - 1, whose buffer slab s + 1 now fills while s is used
    __syncthreads();
    if (s + 1 < n_slabs) stage(s + 1);
"""
_G_PAIRS_END = """      if (i1 < sv) *reinterpret_cast<P*>(o + int64_t(i1) * VEC) = o1;
    }
"""
_G_PAIR_HEAD = """    for (int p = tid; p < na * tpr; p += THREADS) {
      const int slot = p / tpr, q = p - slot * tpr;
      const int r = rank_order[slot];
"""
_G_SNAKE = """    const P* buf = slabs + int64_t(s & 1) * window * sv_max;
    for (int p = tid; p < na * sv; p += THREADS) {
      const int slot = p / sv, q = p - slot * sv;
      int idx = slot;
      if (THREADS % sv == 0) {  // every other pass of the threads in reverse rank order
        const int S = THREADS / sv, k = slot / S, j = slot - k * S;
        const int c = na - k * S < S ? na - k * S : S;
        if (k & 1) idx = k * S + (c - 1 - j);
      }
      const int r = rank_order[idx];
      const int e_beg = rows[r], e_end = rows[r + 1];
      float a0[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) a0[i] = 0.0f;
#pragma unroll 4
      for (int e = e_beg; e < e_end; ++e) {
        const Edge ed = edges[e];
        const P y0 = buf[ed.off + q];
#pragma unroll
        for (int i = 0; i < VEC; ++i) a0[i] = __fmaf_rn(ed.w, to_f32(y0.v[i]), a0[i]);
      }
      const int deg = e_end - e_beg;
      const float denom = float(deg > 1 ? deg : 1);
      P o0;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o0.v[i] = from_f32<T>(mean ? a0[i] / denom : a0[i]);
      *reinterpret_cast<P*>(out + (d0 + r) * ldo + int64_t(v0 + q) * VEC) = o0;
    }
"""
_J_KERNEL_END = """  wg::drain<V, U>(out + t0 * vpr, tile_ids, m, vpr,
                  [&](int64_t id, int v) { return table[id * vpr + v]; });
}
"""
_J_PERSISTENT = """  const int64_t n_tiles = (n_ids + tile - 1) / tile;
  int64_t next = 0;
  if (threadIdx.x < tile && t0 + threadIdx.x < n_ids) next = wg::load_id(ids, ids64, t0 + threadIdx.x);
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t b = t * tile;
    const int mt = int(n_ids - b < tile ? n_ids - b : tile);
    if (threadIdx.x < mt) tile_ids[threadIdx.x] = wg::tile_id(next, n_rows, 1);
    __syncthreads();
    const int64_t tn = t + gridDim.x;
    if (tn < n_tiles && threadIdx.x < tile && tn * tile + threadIdx.x < n_ids)
      next = wg::load_id(ids, ids64, tn * tile + threadIdx.x);
    wg::drain<V, U>(out + b * vpr, tile_ids, mt, vpr,
                    [&](int64_t id, int v) { return table[id * vpr + v]; });
    __syncthreads();
  }
}
"""


_G_WINDOW_HEAD = """                       const int32_t* __restrict__ spans, unsigned long long* stats) {
  using P = Pack<T, VEC>;
  const int32_t lo = spans[2 * int64_t(blockIdx.x)], hi = spans[2 * int64_t(blockIdx.x) + 1];
  if (hi < lo) return;
"""
_G_FOLDED_HEAD = """                       int32_t* __restrict__ spans, unsigned long long* stats) {
  using P = Pack<T, VEC>;
  int32_t lo, hi;
  {
    const int64_t t0 = int64_t(blockIdx.x) * tile;
    const int nt = int(n_rows - t0 < tile ? n_rows - t0 : tile);
    const int64_t nte = int64_t(row_ptr[t0 + nt]) - row_ptr[t0];
    const bool staged =
        tile_staged<THREADS>(col, row_ptr[t0], nte, n_src, window, edge_cap, lo, hi);
    if (threadIdx.x == 0) {
      spans[2 * int64_t(blockIdx.x)] = staged ? lo : 0;
      spans[2 * int64_t(blockIdx.x) + 1] = staged ? hi : -1;
    }
    if (!staged) return;
  }
"""
_G_SPAN_LAUNCH = """  csr_spmm_span_kernel<<<tiles, SPAN_THREADS, 0, stream>>>(rp, cl, n_src, n_rows, tile, window,
                                                           edge_cap, spans, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
"""
_G_SLAB_READ = "        const P y0 = buf[ed.off + i0], y1 = buf[ed.off + i1];\n"
_G_NO_X_READ = """        P y0, y1;
#pragma unroll
        for (int i = 0; i < VEC; ++i) y0.v[i] = y1.v[i] = from_f32<T>(__int_as_float(ed.off));
"""


class Stale(Exception):
    """A substitution that no longer matches the current source."""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise Stale(old)
    return text.replace(old, new)


def _each(recipes: dict) -> tuple:
    """({name: source}, [names whose substitutions no longer match])."""
    built, stale = {}, []
    for name, make in recipes.items():
        try:
            built[name] = make()
        except (Stale, ValueError):  # ValueError: str.index found no anchor
            stale.append(name)
    return built, stale


def g_variants(src: str) -> tuple:
    def snake():
        pairs = src.index("    const int tpr = (sv + 1) / 2;")
        pairs_end = src.index(_G_PAIRS_END, pairs) + len(_G_PAIRS_END)
        return src[:pairs] + _G_SNAKE + src[pairs_end:]

    return _each({
        "G two barriers a slab": lambda: _sub(_sub(src, _G_SLAB_LOOP, """  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      stage(s + 1);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
"""), _G_PAIRS_END + "  }\n}\n", _G_PAIRS_END + "    __syncthreads();\n  }\n}\n"),
        "G rows in CSR order": lambda: _sub(src, "    rank_order[rank] = r;",
                                            "    rank_order[r] = r;"),
        "G ranks k and n-1-k a thread, 256 threads": lambda: _sub(_sub(
            src, _G_PAIR_HEAD, """    const int half = (na + 1) / 2;
    for (int p = tid; p < half * tpr; p += THREADS)
      for (int h = 0; h < 2; ++h) {
      const int slot = p / tpr, q = p - slot * tpr;
      if (h && na - 1 - slot == slot) break;
      const int r = rank_order[h ? na - 1 - slot : slot];
"""), "constexpr int THREADS = 512; ", "constexpr int THREADS = 256; "),
        "G one vector a thread, snake order": snake,
        "G tile decision in the window kernel, two launches": lambda: _sub(_sub(
            src, _G_WINDOW_HEAD, _G_FOLDED_HEAD), _G_SPAN_LAUNCH, "  cudaError_t e;\n"),
        "G slabs of 64 bytes, three CTAs an SM": lambda: _sub(_sub(
            src, "__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)"),
            "const int slab_vecs = SLAB_BYTES / int(sizeof(P));",
            "const int slab_vecs = 64 / int(sizeof(P));"),
        "probe: G span and rows launches alone": lambda: _sub(
            src, "  if (hi < lo) return;\n", "  if (hi < lo || lo >= 0) return;\n"),
        "probe: G window kernel without its edge loop": lambda: _sub(
            src, "      const int e_beg = rows[r], e_end = rows[r + 1];\n",
            "      const int e_beg = rows[r], e_end = e_beg;\n"),
        "probe: G edge loop without reads of x": lambda: _sub(src, _G_SLAB_READ, _G_NO_X_READ),
    })


def j_variants(src: str, header: str) -> tuple:
    def inline(h: str, s: str) -> str:
        return _sub(s, '#include "direct_gather.cuh"',
                    h.replace("namespace wg {", "namespace wgv {")).replace("wg::", "wgv::")

    def persistent():
        head = src[:src.index(_J_KERNEL_END)]
        text = (head[:head.rindex("  const int64_t t0")]
                + "  const int64_t t0 = int64_t(blockIdx.x) * tile;\n" + _J_PERSISTENT
                + src[src.index(_J_KERNEL_END) + len(_J_KERNEL_END):])
        return _sub(text, """  const unsigned blocks = unsigned((n_ids + tile - 1) / tile);
  auto kernel = wg::loads_in_flight(tile, vpr) == 8 ? masked_gather_kernel<V, 8>
                                                     : masked_gather_kernel<V, 4>;""",
                    """  unsigned blocks = unsigned((n_ids + tile - 1) / tile);
  auto kernel = wg::loads_in_flight(tile, vpr) == 8 ? masked_gather_kernel<V, 8>
                                                     : masked_gather_kernel<V, 4>;
  int per_sm = 0;  // one wave of resident CTAs
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wg::GATHER_THREADS, 0);
  if (blocks > unsigned(132 * per_sm)) blocks = unsigned(132 * per_sm);""")

    store = "dst[k0 + u * GATHER_THREADS] = val[u];"
    return _each({
        "J streaming stores": lambda: inline(_sub(
            header, store, "__stcs(&dst[k0 + u * GATHER_THREADS], val[u]);"), src),
        "J read-only loads": lambda: _sub(src, "{ return table[id * vpr + v]; }",
                                          "{ return __ldg(&table[id * vpr + v]); }"),
        "J persistent CTAs": persistent,
    })


_A_LAUNCH = """  const unsigned blocks = unsigned((n_ids + tile - 1) / tile);
  auto kernel = wg::loads_in_flight(tile, vpr) == 8 ? row_gather_kernel<V, 8>
                                                     : row_gather_kernel<V, 4>;
  kernel<<<blocks, wg::GATHER_THREADS, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows, n_ids, vpr, tile);
"""
_A_WARP_KERNEL = """template <typename V>
__global__ void warp_row_gather_kernel(const V* __restrict__ table, const void* __restrict__ ids,
                                       int ids64, V* __restrict__ out, int64_t n_rows,
                                       int64_t n_ids, int64_t vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < n_ids; i += n_warps) {
    const int64_t id = wg::tile_id(wg::load_id(ids, ids64, i), n_rows, 0);
    V* dst = out + i * vecs_per_row;
    const V* src = table + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

"""
_A_WARP_LAUNCH = """  int64_t blocks = (n_ids + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  warp_row_gather_kernel<V><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const V*>(table), ids, ids64, static_cast<V*>(out), n_rows, n_ids, vpr);
"""
_A_REPEAT = """  wg::drain<V, U>(out + t0 * vpr, tile_ids, m, vpr,
                  [&](int64_t id, int v) { return table[id * vpr + v]; });
"""
_A_REPEAT_ONCE = """  // the tile's first id's row, in shared memory once for every slot that repeats it
  __shared__ V first_row[64];
  const int64_t first = tile_ids[0];
  const bool cache = vpr <= 64;
  if (cache)
    for (int v = threadIdx.x; v < vpr; v += wg::GATHER_THREADS) first_row[v] = table[first * vpr + v];
  __syncthreads();
  wg::drain<V, U>(out + t0 * vpr, tile_ids, m, vpr, [&](int64_t id, int v) {
    return cache && id == first ? first_row[v] : table[id * vpr + v];
  });
"""
_B_CALL = """  return int(wg::row_scatter(table, ids, ids64, rows, n_rows, n_ids, row_bytes, vec_bytes, tile,
"""
_B_WARP_CALL = """  return int(wg::warp_row_scatter(table, ids, ids64, rows, n_rows, n_ids, row_bytes, vec_bytes,
"""
_B_LOADS = "constexpr int SCATTER_LOADS = 4;"
_B_VALID = "ball[c] = __ballot_sync(0xffffffffu, id[c] >= 0 && id[c] < n_rows);"


def _inline_scatter(src: str, header: str) -> str:
    """``src`` with its ``#include "row_scatter.cuh"`` replaced by
    ``header``'s text in a namespace of its own (which sees ``wg``'s
    helpers), so that a variant may change it."""
    return _sub(src, '#include "row_scatter.cuh"',
                header.replace("namespace wg {", "namespace wgv {\nusing namespace wg;")
                ).replace("wg::row_scatter(", "wgv::row_scatter(")


_L_ITEMS = "constexpr int APPLY_ITEMS = 2;"
_L_BOUNDS = "__global__ void __launch_bounds__(APPLY_THREADS)\nsparse_apply_kernel("
_L_VALID = "ball[c] = __ballot_sync(0xffffffffu, id[c] >= 0 && id[c] < n_rows);"
L_TILE_BYTES = (8192, 16384, 32768, 65536, 131072)  # APPLY_TILE_BYTES tried
_L_U = "  constexpr int U = APPLY_ITEMS;"
_L_HOST_LOADS = """        load_vec<TE, N, false>(table, off[u], p[u]);
        if constexpr (NS >= 1) load_vec<E_F32, N, false>(sa, off[u], a[u]);
        if constexpr (NS >= 2) load_vec<E_F32, N, false>(sb, off[u], b[u]);
"""
_L_HOST_STORE = "      store_vec<TE, N>(table, off[u], p[u]);\n"
_L_HOST_STATE = """        if constexpr (NS >= 1) load_vec<E_F32, N, false>(sa, off[u], a[u]);
        if constexpr (NS >= 2) load_vec<E_F32, N, false>(sb, off[u], b[u]);
"""
L_HOST_TILE_BYTES = (2048, 4096, 8192, 16384, 32768, 65536, 131072)  # APPLY_HOST_TILE_BYTES tried


def l_variants(src: str) -> tuple:
    """Kernel L's alternatives: 1 and 4 items in flight a thread, 6 CTAs an
    SM (at most 40 registers), streaming stores (``st.global.cs``) in place
    of ordinary ones for the f32 rows and single elements; a probe that
    reads the ids and finds none valid (the id pass alone)."""
    return _each({
        "L 1 item in flight a thread": lambda: _sub(src, _L_ITEMS,
                                                    "constexpr int APPLY_ITEMS = 1;"),
        "L 4 items in flight a thread": lambda: _sub(src, _L_ITEMS,
                                                     "constexpr int APPLY_ITEMS = 4;"),
        "L 6 CTAs an SM": lambda: _sub(src, _L_BOUNDS, _L_BOUNDS.replace(
            "(APPLY_THREADS)", "(APPLY_THREADS, 6)")),
        "L streaming stores": lambda: _sub(_sub(_sub(
            src, "*reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);",
            "__stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));"),
            "else *p = x[0];", "else __stcs(p, x[0]);"),
            "*p = narrow<E>(x[0]);", "__stcs(p, narrow<E>(x[0]));"),
        "probe: L reads its ids, no row": lambda: _sub(
            src, _L_VALID, _L_VALID.replace("id[c] < n_rows", "id[c] < -n_rows")),
        **{f"L host {k} item{'s' if k > 1 else ''} in flight a thread": (
            lambda k=k: _sub(src, _L_U, f"  constexpr int U = HOST ? {k} : APPLY_ITEMS;"))
           for k in (1, 4, 8)},
        "probe: L host reads only": lambda: _sub(
            src, _L_HOST_STORE, "      if (HOST && p[u][0] != 12345.0f) continue;\n"
            + _L_HOST_STORE),
        "probe: L host reads the table only": lambda: _sub(_sub(
            src, _L_HOST_STORE, "      if (HOST && p[u][0] != 12345.0f) continue;\n"
            + _L_HOST_STORE), _L_HOST_STATE, _L_HOST_STATE.replace("(NS >= ", "(!HOST && NS >= ")),
        "probe: L host writes only": lambda: _sub(
            src, _L_HOST_LOADS, "        if constexpr (HOST) {\n#pragma unroll\n"
            "          for (int e = 0; e < N; ++e) p[u][e] = 0.0f;\n        } else {\n"
            + _L_HOST_LOADS + "        }\n"),
    })


def l_cases(gen) -> dict:
    """{case: (table, slots, ids, grads, optimizer, step, lr)}: kernel L's
    calls (a)-(d) as ``apply_rows`` receives them."""
    from ..embedding import Embedding, LazyAdam
    from ..embedding import embedding as emb_mod
    from ..train import (HeteroTrainConfig, SageTrainConfig, build_hetero, build_synthetic,
                         hetero_train_step, train_step)

    calls = {}
    rec = []
    st = build_synthetic(SageTrainConfig(), device="cuda", seed=0)
    c = torch.randint(0, st.config.n_nodes, (st.config.batch,), generator=gen, device="cuda",
                      dtype=torch.int32)
    with recording(emb_mod, "apply_rows", rec):
        train_step(st, c, st.labels[c.long()], seed=0)
    calls["(a)"] = rec[0]
    t, slots, *rest = rec[0]
    calls["(d) bf16 table"] = (t.to(torch.bfloat16), {k: v.clone() for k, v in slots.items()},
                               *rest)
    del st
    rec = []
    eb = Embedding.create(1_000_000, 256, optimizer=LazyAdam(), device="cuda")
    eb.init(torch.Generator(device="cuda").manual_seed(0))
    ids = torch.randint(0, 1_000_000, (1 << 17,), generator=gen, device="cuda")
    with recording(emb_mod, "apply_rows", rec):
        eb.apply_gradients(ids, torch.ones(1 << 17, 256, device="cuda"), 0.01)
    calls["(b)"] = rec[0]
    rec = []
    hcfg = HeteroTrainConfig()
    hst = build_hetero(hcfg, device="cuda", seed=0)
    hc = hst.train_ids[torch.randperm(hst.train_ids.numel(), generator=gen,
                                      device="cuda")[:hcfg.batch]]
    with recording(emb_mod, "apply_rows", rec):
        hetero_train_step(hst, hc, hst.labels[hc.long()], seed=0)
    for call in rec:
        calls[f"(c) {call[0].shape[1] * 4}-byte rows"] = call
    del hst
    torch.cuda.empty_cache()
    return calls


def l_section(libs: dict, names, gen) -> dict:
    """L as built, over tile sizes, and its variants, in turns at each of
    :func:`l_cases`, beside each call's bound; every output but a probe's
    held bit-equal to L's plain version."""
    from ..ops import optim_kernels as OK

    out = {}
    for case, (table, slots, ids, grads, opt, step, lr) in l_cases(gen).items():
        def call(t, s, lib=None, tb=None):
            def run():
                saved = OK.APPLY_TILE_BYTES
                OK.APPLY_TILE_BYTES = tb or saved
                try:
                    if lib is None:
                        return OK.apply_rows(t, s, ids, grads, opt, step, lr)
                    with launching(OK.SPARSE_APPLY, lib):
                        return OK.apply_rows(t, s, ids, grads, opt, step, lr)
                finally:
                    OK.APPLY_TILE_BYTES = saved
            return run

        def copy():
            return table.clone(), {k: v.clone() for k, v in slots.items()}

        ref_t, ref_s = copy()
        OK.apply_rows_plain(ref_t, ref_s, ids, grads, opt, step, lr)
        variants = {"L": (None, None),
                    **{f"L tiles of {tb // 1024} KB": (None, tb) for tb in L_TILE_BYTES},
                    **{name: (libs[name], None) for name in names}}
        for name, v in variants.items():  # each on its own copy, once, against the plain route
            if name.startswith("probe"):
                continue
            t, s = copy()
            call(t, s, *v)()
            if not (torch.equal(t.view(torch.uint8), ref_t.view(torch.uint8))
                    and all(torch.equal(s[k].view(torch.uint8), ref_s[k].view(torch.uint8))
                            for k in s)):
                raise SystemExit(f"kernel_variants: {name} differs from L's plain version ({case})")
            del t, s
        del ref_t, ref_s
        t, s = copy()  # the timed calls update one copy in place
        fns = {name: call(t, s, *v) for name, v in variants.items()}
        valid = int(((ids >= 0) & (ids < table.shape[0])).sum())
        row = (grads.element_size() + 2 * table.element_size() + 8 * len(slots)) * table.shape[1]
        nbytes = ids.element_size() * ids.numel() + valid * row
        out[case] = {"bound_ms": nbytes / 3.35e12 * 1e3, "valid": valid, "slots": ids.numel(),
                     "tile": OK.apply_tile(table.shape[1] * 4), **device_turns(fns)}
        del fns, t, s
        torch.cuda.empty_cache()
    return out


def a_variants(src: str) -> tuple:
    """Kernel A's alternatives: the parent's design (one warp a row), and a
    tile's first id's row read once into shared memory for the slots that
    repeat it (the hot row of clipped ids)."""
    return _each({
        "A one warp a row (the parent's design)": lambda: _sub(_sub(
            src, _A_LAUNCH, _A_WARP_LAUNCH), "template <typename V>\nvoid launch_row_gather(",
            _A_WARP_KERNEL + "template <typename V>\nvoid launch_row_gather("),
        "A the tile's first row read once": lambda: _sub(src, _A_REPEAT, _A_REPEAT_ONCE),
    })


def b_variants(src: str, header: str) -> tuple:
    """Kernel B's alternatives: the parent's design (one warp a row, kernel
    F's body), and 8 loads of ``rows`` in flight a thread; a probe that
    reads the ids and finds none valid (the id pass alone)."""
    return _each({
        "probe: B reads its ids, no row": lambda: _inline_scatter(
            src, _sub(header, _B_VALID, _B_VALID.replace("id[c] < n_rows", "id[c] < -n_rows"))),
        "B one warp a row (the parent's design)": lambda: _sub(src, _B_CALL, _B_WARP_CALL),
        "B 8 loads in flight a thread": lambda: _inline_scatter(
            src, _sub(header, _B_LOADS, "constexpr int SCATTER_LOADS = 8;")),
    })


_K_RANK = """      int32_t rank = 0;
      for (int f = 0; f < d; ++f) {
        const float kf = stage[f];
        rank += (kf > k || (kf == k && f < e)) ? 1 : 0;
      }
"""
_K_STAGE_FILL = "      stage[e] = edge_key(hc, key0, e, weight_at(g, int64_t(row.lo) + e));\n"
_K_STAGE_RANKS = """    __syncwarp();
    for (int e = lane; e < d; e += 32) {
      const float k = stage[e];
"""


def k_stage_probes(src: str) -> tuple:
    """Probes of kernel K's stage design (the rank count in shared memory
    for every row up to 256 edges, the design before the register path),
    each taking one step out."""
    return _each({
        "probe: K centre rows only": lambda: _sub(src, "  if (K == 0) return;\n",
                                                  "  if (K >= 0) return;\n"),
        "probe: K no rank count (slot e for e < K)": lambda: _sub(
            src, _K_RANK, "      const int32_t rank = e;\n"),
        "probe: K rank count over plain weights": lambda: _sub(
            src, _K_STAGE_FILL, "      stage[e] = weight_at(g, int64_t(row.lo) + e);\n"),
        "probe: K no col re-read (neighbour -1)": lambda: _sub(
            src, "o.nbrs[r0 + j] = valid ? col_at(g, int64_t(lo) + pp) : -1;",
            "o.nbrs[r0 + j] = -1;"),
        # a store that never happens (every key is <= -0.0) keeps the keys live
        "probe: K keys only (stage filled, nothing written)": lambda: _sub(
            src, _K_STAGE_RANKS, "    __syncwarp();\n    if (lane < d && stage[lane] > 0.f) "
            "o.mask[r0] = 1;\n    return;\n" + _K_STAGE_RANKS[len("    __syncwarp();\n"):]),
    })


_K_FULL_SORT = "    sort_width<log2_of(32 * R)>(v, lane, d <= 1 ? 0 : 32 - __clz(d - 1));\n"
_K_MERGE = "  if (R == R_LARGE && take <= 32)\n"
_K_SORT = _K_MERGE + "    warp_select(v, lane, (d + 31) / 32);\n  else\n" + _K_FULL_SORT
_K_KEY = "__float_as_uint(edge_key(hc, key0, e, w))"
_K_NBR = "    const int32_t nbr = from_position(nb, p, d);\n"
_K_WARPS = "constexpr int WARPS = 8;"
_K_MIN_BLOCKS = "constexpr int MIN_BLOCKS = 6;"
_K_SMALL_TIER = "  if (d <= 32 * R_SMALL) {\n"
_K_LARGE_TIER = "  if (d <= REG_EDGES) {\n"
_K_BITONIC = ("template <int LOGW, int R, typename T>\n__device__ __forceinline__ void bitonic(",
              "// bitonic<logw>, for the row's")
# the textbook network: block k ascending where (i & k) == 0, each step's
# direction set per element (the first design of the register path)
_K_BITONIC_DIRECTED = """template <int LOGW, int R, typename T>
__device__ __forceinline__ void bitonic(T (&v)[R], int lane) {
  constexpr int W = 1 << LOGW;
  constexpr int ROWS = W > 32 ? W / 32 : 1;
#pragma unroll
  for (int k = 2; k <= W; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool up = ((lane + 32 * r) & k) == 0;
        if (j < 32) {
          const T p = __shfl_xor_sync(FULL, v[r], j);
          v[r] = (p < v[r]) == (((lane & j) == 0) == up) ? p : v[r];
        } else if ((r & (j / 32)) == 0) {
          const T a = v[r], b = v[r | (j / 32)];
          v[r] = (a < b) == up ? a : b;
          v[r | (j / 32)] = (a < b) == up ? b : a;
        }
      }
}

"""
# 32-bit prefixes (key bits >> (LOG - 1)) << LOG | position (LOG = log2(32
# R)) sorted first; their order is kept where no two neighbours in it have
# their 64-bit values the other way round (an exact check), else the 64-bit
# values are sorted
_K_PREFIX_SORT = """  {
    constexpr int LOG = log2_of(32 * R);
    const int logw = d <= 1 ? 0 : 32 - __clz(d - 1);
    uint32_t s[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      s[r] = lane + 32 * r < d ? uint32_t(v[r] >> 32 >> (LOG - 1)) << LOG | uint32_t(v[r])
                               : 0xffffffffu;
    sort_width<LOG>(s, lane, logw);
    uint64_t w64[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint64_t x = from_position(v, int32_t(s[r] & (32 * R - 1)), d);
      w64[r] = lane + 32 * r < d ? x : ~uint64_t(0);
    }
    bool wrong = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint64_t next = __shfl_down_sync(FULL, w64[r], 1);
      const uint64_t wrap = __shfl_sync(FULL, w64[r + 1 < R ? r + 1 : r], 0);
      if (lane == 31) next = wrap;
      wrong |= lane + 32 * r + 1 < d && w64[r] > next;
    }
    if (__any_sync(FULL, wrong)) {
      sort_width<LOG>(v, lane, logw);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = w64[r];
    }
  }
"""


def _k_bitonic_directed(src: str) -> str:
    a, b = src.index(_K_BITONIC[0]), src.index(_K_BITONIC[1])
    return src[:a] + _K_BITONIC_DIRECTED + src[b:]


def k_register_variants(src: str) -> tuple:
    """Kernel K's register design (rows of up to 32 R_LARGE edges):
    alternatives, held bit-equal to K, and probes that each take one step
    out of it."""
    return _each({
        "K one tier: R = 8 for every row to 256 edges": lambda: _sub(
            src, _K_SMALL_TIER, "  if (d <= 0) {\n"),
        "K tiers R = 2, 4 and 8": lambda: _sub(
            src, _K_LARGE_TIER, "  if (d <= 128) {\n    register_row<4>(g, o, row, d, K, r0, hc, "
            "key0, lane);\n    return;\n  }\n" + _K_LARGE_TIER),
        "K without the register cap": lambda: _sub(src, _K_MIN_BLOCKS,
                                                   "constexpr int MIN_BLOCKS = 1;"),
        "K at 8 CTAs an SM (32 registers)": lambda: _sub(src, _K_MIN_BLOCKS,
                                                         "constexpr int MIN_BLOCKS = 8;"),
        "K 2 warps a block (40 registers)": lambda: _sub(_sub(
            src, _K_WARPS, "constexpr int WARPS = 2;"), _K_MIN_BLOCKS,
            "constexpr int MIN_BLOCKS = 24;"),
        "K direction per step": lambda: _k_bitonic_directed(src),
        "K full sort in the tier of 8 (no WarpSelect merge)": lambda: _sub(
            src, _K_MERGE, "  if (false)\n"),
        "K WarpSelect merge in both tiers (K <= 32)": lambda: _sub(
            src, _K_MERGE, "  if (take <= 32 && d > 32)\n"),
        "K 32-bit prefix sort, exact check": lambda: _sub(src, _K_FULL_SORT, _K_PREFIX_SORT),
        "probe: K centre rows only": lambda: _sub(src, "  if (K == 0) return;\n",
                                                  "  if (K >= 0) return;\n"),
        # a store that never happens (no value has these bits) keeps the keys live
        "probe: K keys only (nothing written)": lambda: _sub(
            src, _K_SORT, "  uint64_t fold = 0;\n  for (int r = 0; r < R; ++r) fold ^= v[r];\n"
            "  if (fold == 0x7fc0000000000001ull) o.mask[r0] = 1;\n  return;\n"),
        "probe: K no sort (slot j takes position j)": lambda: _sub(src, _K_SORT, ""),
        "probe: K sort over plain weights": lambda: _sub(src, _K_KEY, "__float_as_uint(w)"),
        "probe: K no neighbour shuffle (neighbour -1)": lambda: _sub(
            src, _K_NBR, "    const int32_t nbr = -1;\n"),
    })


def l_host_section(libs: dict, names, gen) -> dict:
    """L's host route at the host-tier SAGE step's apply call, as built,
    over host tile sizes, and under each L variant and host probe, in turns
    by device time (a CUDA graph of 5 calls), beside the composed route (E
    on the table, m and v, the update, F on each, B on the lines) and the
    bounds of both link directions at once and one after the other. Every
    output but a probe's is held bit-equal to L's host route as built (the
    card tests hold that to the composed route), each from the rows as they
    were before the call; the touched rows are restored at the end."""
    from ..embedding import host_embedding as host_mod
    from ..ops import optim_kernels as OK
    from ..ops.gather_kernels import scatter_rows
    from ..ops.host_kernels import host_scatter_rows
    from ..train import SageTrainConfig, build_synthetic, train_step

    st = build_synthetic(SageTrainConfig(), device="cuda", seed=0, host_cache_ratio=0.25)
    rec = []
    real = host_mod.apply_rows_host
    host_mod.apply_rows_host = lambda *a, **kw: rec.append((a, kw)) or real(*a, **kw)
    try:
        c = torch.randint(0, st.config.n_nodes, (st.config.batch,), generator=gen,
                          device="cuda", dtype=torch.int32)
        train_step(st, c, st.labels[c.long()], seed=0)
    finally:
        host_mod.apply_rows_host = real
    (table, slots, ids, grads, opt, step, lr), kw = rec[0]
    torch.cuda.synchronize()
    valid = (ids >= 0) & (ids < table.shape[0])
    vids, hits = ids[valid].long().cpu(), kw["lines"][valid & (kw["lines"] >= 0)].long()

    def rows():
        torch.cuda.synchronize()
        return [table[vids], kw["cache_rows"][hits]] + [v[vids] for v in slots.values()]

    def restore(saved):
        torch.cuda.synchronize()
        table[vids], kw["cache_rows"][hits] = saved[0], saved[1]
        for v, r in zip(slots.values(), saved[2:]):
            v[vids] = r

    def call(lib=None, tb=None):
        def run():
            saved = OK.APPLY_HOST_TILE_BYTES
            OK.APPLY_HOST_TILE_BYTES = tb or saved
            try:
                if lib is None:
                    return OK.apply_rows_host(table, slots, ids, grads, opt, step, lr, **kw)
                with launching(OK.SPARSE_APPLY_HOST, lib):
                    return OK.apply_rows_host(table, slots, ids, grads, opt, step, lr, **kw)
            finally:
                OK.APPLY_HOST_TILE_BYTES = saved
        return run

    def composed():
        OK._composed_host(OK._host_take, host_scatter_rows, scatter_rows, table, slots, ids,
                          grads, opt, step, lr, kw["lines"], kw["cache_rows"])

    before = rows()
    restore(before)
    call()()
    ref = rows()
    items = [n for n in names if n.startswith("L host ") and " item" in n]
    variants = {"L host": (None, None),
                **{f"L host tiles of {tb // 1024} KB": (None, tb) for tb in L_HOST_TILE_BYTES},
                **{name: (libs[name], None) for name in names},
                **{f"{name}, tiles of {tb // 1024} KB": (libs[name], tb) for name in items
                   for tb in (4096, 8192)}}
    for name, v in variants.items():
        if name.startswith("probe"):
            continue
        restore(before)
        call(*v)()
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(rows(), ref)):
            raise SystemExit(f"kernel_variants: {name} differs from L's host route")
    fns = {"composed (E x3, update, F x3, B)": composed,
           **{name: call(*v) for name, v in variants.items()}}
    rounds = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            rounds[k].append(graph_ms(fn, 5))
    restore(ref)
    n_valid = vids.numel()
    link = n_valid * table.shape[1] * (table.element_size() + 4 * len(slots))
    out = {"slots": ids.numel(), "valid": n_valid, "cached": hits.numel(),
           "link_bytes_each_way": link, "duplex_bound_ms": link / 64e9 * 1e3,
           "in_turn_bound_ms": 2 * link / 64e9 * 1e3,
           "tile": OK.apply_tile(table.shape[1] * 4, OK.APPLY_HOST_TILE_BYTES),
           **{k: {"device_ms": statistics.median(v), "spread": max(v) - min(v)}
              for k, v in rounds.items()}}
    del st, table, slots, ids, grads, kw, before, ref
    return out


def ptxas(log: str, match: str) -> dict:
    """{kernel: what ``-Xptxas -v`` reported for it} for the entry functions
    whose mangled name holds ``match``: registers, barriers and static
    shared memory, and the stack and spills."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                out.setdefault(name, [])
        elif name and ("Used" in line or "spill" in line) and line.strip() not in out[name]:
            out[name].append(line.strip().replace("ptxas info    : ", ""))
    return {k: "; ".join(v) for k, v in out.items()}


def build(variants: dict) -> tuple:
    """({name: ctypes library}, {name: compiler output}), all nvcc
    processes started together."""
    nvcc = kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("kernel_variants: nvcc not found")
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        src = os.path.join(VARIANT_DIR, f"variant{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(VARIANT_DIR, f"libvariant{i}.so")
        procs[name] = (lib, subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
                                              "-o", lib, src], stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"kernel_variants: {name} did not build:\n{out}")
        libs[name], logs[name] = ctypes.CDLL(lib), out
    return libs, logs


@contextlib.contextmanager
def launching(kern: kernels.Kernel, lib: ctypes.CDLL):
    """``kern``'s wrapper launches ``lib``'s entry of the same name."""
    kern._fn or kern._load()
    fn = getattr(lib, kern.entry)
    fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    saved, kern._fn = kern._fn, fn
    try:
        yield
    finally:
        kern._fn = saved


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()  # the card is busy while the host enqueues the timed calls
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return cuda_ms(g.replay, iters=5, warmup=1) / iters


def in_turns(fns: dict) -> dict:
    rounds = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            rounds[k].append(cuda_ms(fn))
    return {k: {"ms": statistics.median(v), "device_ms": graph_ms(fns[k])} for k, v in rounds.items()}


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


K_FIELDS = ("neighbors", "mask", "positions", "edge_ids", "degree")


BENCH_ROWS = 2_000_000   # bench_sampling's rows (degrees 16..48, mean 32)
BENCH_BATCH = 1 << 16    # its batch
BENCH_K = 15             # its fanout


def weighted_bench_graph(gen, low=16, high=48) -> tuple:
    """(row_ptr, col, w, centers) on the card: the graph and centres of
    ``bench_sampling(weighted=True)`` (``bench.py:311-375``): BENCH_ROWS rows
    of degrees ``RandomState(1).randint(low, high + 1)`` (16..48 there),
    uniform columns, weights ``U[0, 1) + 0.1`` and BENCH_BATCH uniform
    centres, drawn from ``gen``. ``chip_smoke.weighted_phase`` and
    :func:`k_cases` both take the bench hop from here."""
    degs = np.random.RandomState(1).randint(low, high + 1, BENCH_ROWS)
    rp = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)).cuda()
    E = int(rp[-1])
    col = torch.randint(0, BENCH_ROWS, (E,), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.rand(E, generator=gen, device="cuda") + 0.1
    centers = torch.randint(0, BENCH_ROWS, (BENCH_BATCH,), generator=gen, device="cuda",
                            dtype=torch.int32)
    return rp, col, w, centers


def k_cases(gen) -> dict:
    """{case: (row_ptr, pairs, centers, K, seed, hop)}, on the pair table:
    the hop of ``bench_sampling(weighted=True)`` (:func:`weighted_bench_graph`,
    K = 15); the same hop over rows of 64..256 edges (the regime between
    R = 2's registers and the list mode: a user's hop over a denser graph);
    and the two hops of a step at ``SageTrainConfig(sample_method=
    "weighted")`` (2,000,000 rows of degrees 8..24; 1,024 centres at K = 10,
    then the 11,264 of the sample's next level at K = 15)."""
    out = {}
    for name, (low, high) in (("bench", (16, 48)), ("rows of 64..256 edges", (64, 256))):
        rp, col, w, centers = weighted_bench_graph(gen, low, high)
        pairs = interleave_col_weights(col, w)
        del col, w
        out[f"{name} [{BENCH_BATCH}, {BENCH_K}]"] = (rp, pairs, centers, BENCH_K, 0, 0)
    cfg = SageTrainConfig()
    n, deg = cfg.n_nodes, cfg.deg
    degs = np.random.RandomState(1).randint(deg // 2, deg + deg // 2 + 1, n)
    rp = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)).cuda()
    E = int(rp[-1])
    col = torch.randint(0, n, (E,), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.rand(E, generator=gen, device="cuda") + 0.1
    g = GraphStructure(rp, col, n, max_degree=int(degs.max()), edge_weight=w
                       ).with_weighted_fastpath()
    c = torch.randint(0, n, (cfg.batch,), generator=gen, device="cuda", dtype=torch.int32)
    ml = g.multilayer_sample(c, cfg.fanouts, seed=0, weighted=True)
    for hop, K in enumerate(cfg.fanouts):
        hc = torch.where(ml.level_masks[hop], ml.level_gids[hop], 0)
        out[f"step hop{hop} [{hc.numel()}, {K}]"] = (rp, g.cw_blocks, hc, K, 0, hop)
    return out


def k_section(libs: dict, names: list, gen) -> dict:
    """K as built and its variants in turns at each of :func:`k_cases`;
    every variant but a probe must give K's five fields bit for bit."""
    out = {}
    for case, (rp, pairs, centers, K, seed, hop) in k_cases(gen).items():
        def k_call(lib=None, a=(rp, pairs, centers, K, seed, hop)):
            def call():
                r, p, c, k, s, h = a
                if lib is None:
                    return SM.sample_hop_weighted(r, None, None, c, k, s, h, pairs=p)
                with launching(SM.SAMPLE_HOP_WEIGHTED, lib):
                    return SM.sample_hop_weighted(r, None, None, c, k, s, h, pairs=p)
            return call

        ref = k_call()()
        fns = {"K": k_call(), **{name: k_call(libs[name]) for name in names}}
        for name, fn in fns.items():
            got = fn()
            if not name.startswith("probe") and not all(
                    torch.equal(getattr(got, f), getattr(ref, f)) for f in K_FIELDS):
                raise SystemExit(f"kernel_variants: {name} differs from kernel K ({case})")
        out[f"K {case}"] = in_turns(fns)
    return out


A_TILE_BYTES = (4096, 8192, 16384, 32768, 65536)       # GATHER_TILE_BYTES tried
B_TILE_IDS = (16, 32, 64, 128, 256, 512)  # ids a CTA of B tried
STORE_ROWS, STORE_BATCH = 4_000_000, 1 << 19           # bench_scatter's table and batch


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Every call of ``module.name`` appends its arguments to ``calls``."""
    fn = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def composed_apply():
    """The sparse apply by its composed route (kernel A on the table and each
    slot, the optimizer's update, kernel B on each), which kernel L
    replaced on the path, so that A and B are timed at the apply's shapes."""
    from ..ops import optim_kernels

    route = optim_kernels.apply_route
    optim_kernels.apply_route = lambda optimizer: "composed"
    try:
        yield
    finally:
        optim_kernels.apply_route = route


def step_calls(step, state, centers, labels) -> tuple:
    """(A's calls, B's calls) of one training step: the embedding's gather,
    the apply's by its composed route (:func:`composed_apply`), and
    ``ops.gather``'s (the RGCN's neighbour rows)."""
    from ..embedding import embedding as emb_mod
    from ..ops import gather as gather_mod
    from ..ops import optim_kernels

    a, b = [], []
    with recording(emb_mod, "gather_rows", a), recording(gather_mod, "gather_rows", a), \
            recording(optim_kernels, "gather_rows", a), \
            recording(optim_kernels, "scatter_rows", b), composed_apply():
        step(state, centers, labels, seed=0)
    torch.cuda.synchronize()
    return [(t.detach(), i) for t, i in a], [(t, i, r) for t, i, r in b]


def ab_cases(gen) -> tuple:
    """({case: (table, ids)} for A, {case: (table, ids, rows)} for B) on the
    card: each distinct A and B call of one hetero step at
    ``HeteroTrainConfig()`` (the typed gather's off-type slots -1, clipped
    onto row 0, and the same slots spread over random rows, to price the
    hot row) and of one SAGE step at ``SageTrainConfig()``, and B's masked
    write at ``bench_scatter``'s shape (2^19 uniform ids into 4,000,000 x
    256 f32, a repeated id's earlier slots -1)."""
    from ..train import (HeteroTrainConfig, build_hetero, build_synthetic, hetero_train_step,
                         train_step)

    a_cases, b_cases = {}, {}
    hcfg = HeteroTrainConfig()
    st = build_hetero(hcfg, device="cuda", seed=0)
    c = st.train_ids[torch.randperm(st.train_ids.numel(), generator=gen, device="cuda")[:hcfg.batch]]
    a, b = step_calls(hetero_train_step, st, c, st.labels[c.long()])
    seen = set()
    for i, (t, ids) in enumerate(a):
        key = (tuple(t.shape), ids.data_ptr())
        if key in seen:  # the apply's m and v reads repeat its table read
            continue
        seen.add(key)
        a_cases[f"hetero A{i} [{ids.numel()}] of {list(t.shape)}"] = (t, ids)
        if bool((ids < 0).any()):
            spread = torch.where(ids < 0, torch.randint(0, t.shape[0], ids.shape, generator=gen,
                                                        device="cuda", dtype=ids.dtype), ids)
            a_cases[f"hetero A{i} [{ids.numel()}] of {list(t.shape)}, -1 spread"] = (t, spread)
    for i, (t, ids, rows) in enumerate(b):
        if i % 3 == 0:  # a type's table write; its m and v writes are alike
            b_cases[f"hetero B{i} [{ids.numel()}] into {list(t.shape)}"] = (t, ids, rows)
    del st
    cfg = SageTrainConfig()
    st = build_synthetic(cfg, device="cuda", seed=0)
    c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device="cuda",
                      dtype=torch.int32)
    a, b = step_calls(train_step, st, c, st.labels[c.long()])
    for i, (t, ids) in enumerate(a[:2]):  # the gather, the apply's table read
        a_cases[f"main A{i} [{ids.numel()}] of {list(t.shape)}"] = (t, ids)
    t, ids, rows = b[0]
    b_cases[f"main B0 [{ids.numel()}] into {list(t.shape)}"] = (t, ids, rows)
    del st, a, b
    data = torch.randn(STORE_ROWS, 256, generator=gen, device="cuda")
    u = torch.randint(0, STORE_ROWS, (STORE_BATCH,), generator=gen, device="cuda")
    last = torch.full((STORE_ROWS,), -1, dtype=torch.long, device="cuda").scatter_reduce_(
        0, u, torch.arange(STORE_BATCH, device="cuda"), "amax")
    slots = torch.where(last[u] == torch.arange(STORE_BATCH, device="cuda"), u, -1).to(torch.int32)
    rows = torch.randn(STORE_BATCH, 256, generator=gen, device="cuda")
    b_cases[f"store B masked [{STORE_BATCH}] into [{STORE_ROWS}, 256]"] = (data, slots, rows)
    torch.cuda.empty_cache()
    return a_cases, b_cases


def device_turns(fns: dict) -> dict:
    """Device ms of each function (a CUDA graph of 20 calls), in turns over
    three rounds: the median and the spread."""
    rounds = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            rounds[k].append(graph_ms(fn))
    return {k: {"device_ms": statistics.median(v), "spread": max(v) - min(v)}
            for k, v in rounds.items()}


def ab_section(libs: dict, a_names, b_names, gen) -> dict:
    """A and B as built, over tile sizes, and their variants, in turns at
    each of :func:`ab_cases`, beside each case's bound and library call;
    every output held bit-equal to the plain version's. ``a_names`` or
    ``b_names`` None leaves that kernel out."""
    a_cases, b_cases = ab_cases(gen)
    a_cases = a_cases if a_names is not None else {}
    b_cases = b_cases if b_names is not None else {}
    out = {}

    def a_call(t, ids, lib=None, tb=None):
        def call():
            saved = G.GATHER_TILE_BYTES
            G.GATHER_TILE_BYTES = tb or saved
            try:
                if lib is None:
                    return G.gather_rows(t, ids)
                with launching(G.ROW_GATHER, lib):
                    return G.gather_rows(t, ids)
            finally:
                G.GATHER_TILE_BYTES = saved
        return call

    for case, (t, ids) in a_cases.items():
        rb, m = t.shape[1] * t.element_size(), ids.numel()
        clipped = ids.long().clamp(0, t.shape[0] - 1)
        ref = G.gather_rows_plain(t, ids)
        fns = {"A": a_call(t, ids),
               **{f"A tiles of {tb // 1024} KB": a_call(t, ids, tb=tb) for tb in A_TILE_BYTES},
               **{name: a_call(t, ids, libs[name]) for name in a_names},
               "index_select": lambda: torch.index_select(t, 0, clipped)}
        for name, fn in fns.items():
            if name != "index_select" and not torch.equal(fn().view(torch.uint8),
                                                          ref.view(torch.uint8)):
                raise SystemExit(f"kernel_variants: {name} differs from A's plain version ({case})")
        nbytes = ids.element_size() * m + torch.unique(clipped).numel() * rb + m * rb
        out[case] = {"bound_ms": nbytes / 3.35e12 * 1e3, "tile": G.gather_tile(rb),
                     **device_turns(fns)}
        del ref, clipped
        torch.cuda.empty_cache()

    def b_call(t, ids, rows, lib=None, tile=None):
        def call():
            plan = G.scatter_tile
            if tile is not None:
                G.scatter_tile = lambda row_bytes: tile
            try:
                if lib is None:
                    return G.scatter_rows(t, ids, rows)
                with launching(G.ROW_SCATTER, lib):
                    return G.scatter_rows(t, ids, rows)
            finally:
                G.scatter_tile = plan
        return call

    for case, (t, ids, rows) in b_cases.items():
        rb = t.shape[1] * t.element_size()
        ok = (ids >= 0) & (ids < t.shape[0])
        vids, vrows = ids[ok].long(), rows[ok]
        ref = G.scatter_rows_plain(t.clone(), ids, rows)
        variants = {"B": (None, None),
                    **{f"B tiles of {n} ids": (None, n) for n in B_TILE_IDS},
                    **{name: (libs[name], None) for name in b_names}}
        for name, v in variants.items():
            if name.startswith("probe"):
                continue
            t2 = t.clone()
            b_call(t2, ids, rows, *v)()
            if not torch.equal(t2.view(torch.uint8), ref.view(torch.uint8)):
                raise SystemExit(f"kernel_variants: {name} differs from B's plain version ({case})")
            del t2
        fns = {name: b_call(t, ids, rows, *v) for name, v in variants.items()}
        fns["index_copy_"] = lambda: t.index_copy_(0, vids, vrows)
        nbytes = ids.element_size() * ids.numel() + 2 * vids.numel() * rb
        out[case] = {"bound_ms": nbytes / 3.35e12 * 1e3, "tile": G.scatter_tile(rb),
                     "valid": vids.numel(), **device_turns(fns)}
        del ref
        torch.cuda.empty_cache()
    return out


_D_LOADS = "constexpr int AGG_LOAD_VECS = 4;"
_D_THREADS = "constexpr int AGG_THREADS = 128;"
_D_BATCH = """    for (int i = 0; i < most; i += U) {
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
"""
_D_NEXT = """        has[u] = mine != 0;
        {
          const int32_t row = __shfl_sync(FULL, id, has[u] ? __ffs(mine) - 1 : 0);
          mine &= mine - 1;
          if (has[u] && col) v[u] = load_row(x + int64_t(row) * vpr + c);
        }
"""
_D_ROLLING = ("""    bool has[U];
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
""" + _D_NEXT + """    }
    for (int i = 0; i < most; i += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (has[u] && col) add_vec(acc, v[u], Tag());
""" + _D_NEXT + """      }
    }
""")
_D_LOAD = "        if (has[u] && col) v[u] = load_row(x + int64_t(row[u]) * vpr + c);\n"
_D_STORE = "  __stcs(out + b * vpr + c, o);\n"
_D_LDG = "  return __ldg(p);\n"
_D_TASK = ("  const int64_t first = (warp / slices) << (5 - shift);  // the warp's first centre\n"
           "  if (first >= B) return;  // the whole warp: no lane of it shuffles\n"
           "  const int slice = int(warp % slices);\n")
_D_TAIL = ("  if (!live || !col) return;\n", "  if (live && col) {\n")
_D_END = ("  __stcs(out + b * vpr + c, o);\n}\n", "  __stcs(out + b * vpr + c, o);\n  }\n  }\n}\n")


def _d_load16(ptx: str, policy: bool = False) -> str:
    """``load_row``'s body with 16-byte vectors loaded by ``ptx`` (an L2
    cache policy made first where ``policy``), every other width by
    ``__ldg``."""
    pol = ('    uint64_t pol;\n    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" '
           ': "=l"(pol));\n') if policy else ""
    return ("  if constexpr (sizeof(V) == 16) {\n    uint4 v;\n" + pol
            + f'    asm("{ptx} {{%0, %1, %2, %3}}, [%4]{", %5" if policy else ""};"\n'
            '        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p)'
            + (', "l"(pol)' if policy else "") + ");\n    return v;\n  } else {\n"
            "    return __ldg(p);\n  }\n")


def _d_walk(src: str) -> str:
    """D with each warp walking all slices of its centres' rows in turn
    (the earlier kernel's order) instead of a warp a slice."""
    src = _sub(src, _D_TASK, "  const int64_t first = warp << (5 - shift);\n"
                             "  if (first >= B) return;\n"
                             "  for (int slice = 0; slice < slices; ++slice) {\n")
    src = _sub(_sub(src, *_D_TAIL), *_D_END)
    return _sub(src, ">> (5 - shift)) * slices;", ">> (5 - shift));")


def _d_persistent(src: str, ctas: int) -> str:
    """D on a grid of at most 132 x ``ctas`` CTAs whose warps stride over
    the (centre group, slice) tasks, as the earlier kernel's grid did."""
    src = _sub(src, _D_TASK,
               "  const int64_t n_tasks = ((B + (32 >> shift) - 1) >> (5 - shift)) * slices;\n"
               "  for (int64_t task = warp; task < n_tasks;\n"
               "       task += int64_t(gridDim.x) * (AGG_THREADS / 32)) {\n"
               "  const int64_t first = (task / slices) << (5 - shift);\n"
               "  const int slice = int(task % slices);\n")
    src = _sub(_sub(src, *_D_TAIL), *_D_END)
    return _sub(src, "<<<unsigned(blocks), ",
                f"<<<unsigned(blocks < 132 * {ctas} ? blocks : 132 * {ctas}), ")


def d_variants(src: str) -> tuple:
    """Kernel D's alternatives (the module docstring lists them); a probe
    that reads the ids and mask and no row (the ballot, shuffles and stores
    alone)."""
    return _each({
        "D 8 vectors in flight a lane": lambda: _sub(src, _D_LOADS, _D_LOADS.replace("4", "8")),
        "D 2 vectors in flight a lane": lambda: _sub(src, _D_LOADS, _D_LOADS.replace("4", "2")),
        "D rolling loads": lambda: _sub(src, _D_BATCH, _D_ROLLING),
        "D walks its slices in turn": lambda: _d_walk(src),
        "D persistent warps, 132 x 8 CTAs": lambda: _d_persistent(src, 8),
        "D persistent warps, 132 x 32 CTAs": lambda: _d_persistent(src, 32),
        "D ordinary loads": lambda: _sub(src, _D_LOAD, _D_LOAD.replace(
            "load_row(x + int64_t(row[u]) * vpr + c)", "x[int64_t(row[u]) * vpr + c]")),
        "D 16-byte loads with a 256-byte L2 prefetch": lambda: _sub(
            src, _D_LDG, _d_load16("ld.global.nc.L2::256B.v4.u32")),
        "D 16-byte loads kept in L2 (evict_last)": lambda: _sub(
            src, _D_LDG, _d_load16("ld.global.nc.L2::cache_hint.v4.u32", policy=True)),
        "D 16-byte loads not kept in L1": lambda: _sub(
            src, _D_LDG, _d_load16("ld.global.nc.L1::no_allocate.v4.u32")),
        "D ordinary stores": lambda: _sub(src, _D_STORE, "  out[b * vpr + c] = o;\n"),
        "D 256 threads a CTA": lambda: _sub(src, _D_THREADS, _D_THREADS.replace("128", "256")),
        "probe: D reads no row": lambda: _sub(
            src, _D_LOAD, "        if (has[u] && col) v[u] = V();\n"),
    })


D_SAMPLED_NODES = 2_000_000  # bench_spmm_sampled's graph (bench.py:477-545)
D_BENCH = (1 << 17, 1 << 16, 16)  # bench_spmm's rows, centres and K (bench.py:375)


def d_cases(gen) -> dict:
    """{case: (x, nbr, mask, mean)} on the card: kernel D's calls (a)-(f) as
    ``chip_smoke.py --paired-times agg`` builds them -- the SAGE step's two
    layers at ``SageTrainConfig()``, the sampled GCN's last layer (16-wide
    rows), ``bench_spmm_sampled``'s block, ``bench_spmm``'s (every slot
    valid, mean) and call (a) in bf16."""
    import dataclasses

    from ..train import build_synthetic, train_step

    cfg = SageTrainConfig()
    out = {}
    for tag, kw in (("sage", {}), ("gcn", {"model_type": "gcn", "degree_mode": "block"})):
        st = build_synthetic(dataclasses.replace(cfg, **kw), device="cuda", seed=0)
        c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device="cuda",
                          dtype=torch.int32)
        calls = []
        with recording(S, "neighbor_reduce", calls):
            train_step(st, c, st.labels[c.long()], seed=0)
        calls = [(x.detach(), n, m, mean) for x, n, m, mean in calls]
        if tag == "sage":
            out["(a) SAGE layer 0"], out["(b) SAGE layer 1"] = calls
            x, n, m, mean = calls[0]
            out["(f) SAGE layer 0 bf16"] = (x.to(torch.bfloat16), n, m, mean)
        else:
            out["(c) GCN last layer"] = next(a for a in calls if a[0].shape[1] == cfg.num_classes)
        del st, calls
        torch.cuda.empty_cache()
    n = D_SAMPLED_NODES
    g = clustered_csr(n, 16, 192, seed=0)
    rs = np.random.RandomState(0)  # the bench's draws after its graph's
    rs.randint(-96, 97, int(rs.randint(8, 32, n).sum()))
    centers = torch.from_numpy(np.sort(rs.choice(n, 1024, replace=False)).astype(np.int32)).cuda()
    ml = g.multilayer_sample(centers, (10, 15), seed=1)
    hop = ml.hops[1]
    x = torch.randn(ml.run_bounds(1)[-1], 256, generator=gen, device="cuda")
    out["(d) sampled_agg block"] = (x, hop.nbr_idx, hop.mask, True)
    del g, ml
    rows, B, K = D_BENCH
    for n, tag in ((rows, ""), (rows >> 2, ", a table L2 holds"), (rows << 2, ", 4 x its rows")):
        x = torch.randn(n, 256, generator=gen, device="cuda")
        nbr = torch.randint(0, n, (B, K), generator=gen, device="cuda", dtype=torch.int32)
        out["(e) bench_spmm" + tag] = (x, nbr, torch.ones(B, K, dtype=torch.bool, device="cuda"),
                                       True)
    torch.cuda.empty_cache()
    return out


_D_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def d_parent_call(lib: ctypes.CDLL, x, nbr, mask, mean):
    """A call of another tree's ``neighbor_agg.cu`` of the earlier design (one
    warp a centre), bound with that tree's entry: (x, n_rows, D, nbr, mask,
    out, B, K, mean, dtype, elements a load, stream)."""
    fn = lib.wg_neighbor_agg
    fn.argtypes, fn.restype = _D_PARENT_ARGS, ctypes.c_int
    B, K = nbr.shape
    D = x.shape[1]
    wide = 16 // x.element_size()

    def call():
        out = torch.empty(B, D, dtype=x.dtype, device=x.device)
        vec = wide if x.data_ptr() % 16 == 0 and D % wide == 0 else 1
        rc = fn(x.data_ptr(), x.shape[0], D, nbr.data_ptr(), mask.data_ptr(), out.data_ptr(), B,
                K, int(mean), int(x.dtype == torch.bfloat16), vec,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"kernel_variants: the parent's D failed with CUDA error {rc}")
        return out
    return call


def d_plans(K: int, row_bytes: int, vec_bytes: int) -> list:
    """Plans of kernel D to force at a call: every lane count from 32 down
    to the row's vectors (or to 8 for a wide row), each with the slices
    that cover the row."""
    vpr = row_bytes // vec_bytes
    low = min(S._pow2_at_least(vpr), 8)
    return [(l, -(-vpr // l)) for l in (1, 2, 4, 8, 16, 32) if l >= low]


def d_section(libs: dict, names: list, gen) -> dict:
    """D as built, under each forced plan, and its variants, in turns at
    each of :func:`d_cases`, beside each call's bound and ``embedding_bag``;
    every output held bit-equal to the kernel's (each adds in ascending k),
    probes excepted."""
    out = {}
    for case, (x, nbr, mask, mean) in d_cases(gen).items():
        B, K = nbr.shape
        rb = x.shape[1] * x.element_size()
        vec = G.vector_bytes(rb, x.data_ptr())

        def d_call(lib=None, plan=None):
            def call():
                saved = S.agg_plan
                if plan is not None:
                    S.agg_plan = lambda *a: plan
                try:
                    if lib is None:
                        return S.neighbor_reduce(x, nbr, mask, mean)
                    with launching(S.NEIGHBOR_AGG, lib):
                        return S.neighbor_reduce(x, nbr, mask, mean)
                finally:
                    S.agg_plan = saved
            return call

        ref = d_call()()
        fns = {"D": d_call(),
               **{f"D plan {p}": d_call(plan=p) for p in d_plans(K, rb, vec)},
               **{name: d_call(libs[name]) for name in names if name != "D parent"}}
        if "D parent" in names:
            fns["D parent"] = d_parent_call(libs["D parent"], x, nbr, mask, mean)
        for name, fn in fns.items():
            if not name.startswith("probe") and not torch.equal(fn().view(torch.uint8),
                                                                ref.view(torch.uint8)):
                raise SystemExit(f"kernel_variants: {name} differs from kernel D ({case})")
        w = mask.to(x.dtype)
        if mean:
            w = w / w.sum(dim=1, keepdim=True).clamp(min=1.0)
        idx = nbr.long()
        fns["embedding_bag"] = lambda: torch.nn.functional.embedding_bag(
            idx, x, mode="sum", per_sample_weights=w)
        uniq = torch.unique(nbr[mask].long()).numel()
        nbytes = 5 * B * K + uniq * rb + B * rb
        out[case] = {"shape": f"[{B}, {K}] over [{x.shape[0]}, {x.shape[1]}] {x.dtype}",
                     "bound_ms": nbytes / 3.35e12 * 1e3, "plan": S.agg_plan(K, rb, vec),
                     **device_turns(fns)}
        del ref
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", nargs="+", choices=("A", "B", "D", "G", "J", "K", "L"),
                    default=("A", "B", "D", "G", "J", "K", "L"))
    ap.add_argument("--d-parent", default=None,
                    help="another tree's neighbor_agg.cu of the earlier design, built and timed "
                         "beside D")
    ap.add_argument("--k-parent", default=None,
                    help="another tree's sample_weighted.cu, built and timed beside K, with "
                         "the stage design's probes applied to it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    kernels.build_all()
    read = lambda name: open(os.path.join(kernels.CSRC, name)).read()  # noqa: E731
    variants, stale = {}, []
    gv, jv, kv = {}, {}, {}
    if "G" in args.parts:
        gv, st = g_variants(read("csr_spmm.cu"))
        stale += st
    if "J" in args.parts:
        jv, st = j_variants(read("row_gather.cu"), read("direct_gather.cuh"))
        stale += st
    if "K" in args.parts:
        kv, stale_k = k_register_variants(read("sample_weighted.cu"))
        stale += stale_k
    if "K" in args.parts and args.k_parent:
        with open(args.k_parent) as f:
            parent = f.read()
        if "seed_ptr" not in parent:  # bound with this tree's argument list, it would misread
            raise SystemExit("kernel_variants: --k-parent needs a sample_weighted.cu whose entry "
                             "takes the seed's address after the seed, as this tree's does")
        pv, st = k_stage_probes(parent)
        kv.update({"K parent": parent, **{f"{k} (parent)": v for k, v in pv.items()}})
        stale += [f"{k} (parent)" for k in st]
    av, bv = {}, {}
    if "A" in args.parts:
        av, st = a_variants(read("row_gather.cu"))
        stale += st
    if "B" in args.parts:
        bv, st = b_variants(read("row_scatter.cu"), read("row_scatter.cuh"))
        stale += st
    dv = {}
    if "D" in args.parts:
        dv, st = d_variants(read("neighbor_agg.cu"))
        stale += st
        if args.d_parent:
            with open(args.d_parent) as f:
                dv["D parent"] = f.read()
    lv = {}
    if "L" in args.parts:
        lv, st = l_variants(read("sparse_apply.cu"))
        stale += st
    variants = {**gv, **jv, **kv, **av, **bv, **dv, **lv}
    libs, logs = build(variants) if variants else ({}, {})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def built_log(source):
        with open(os.path.splitext(kernels.library_path(os.path.join(kernels.CSRC, source)))[0]
                  + ".log") as f:
            return f.read()

    out = {"device": smi, "parts": list(args.parts), "stale": stale, "ptxas": {}}
    if gv:
        out["ptxas"].update({"G": ptxas(built_log("csr_spmm.cu"), "csr_spmm"),
                             **{name: ptxas(logs[name], "csr_spmm_window") for name in gv}})
    if "K" in args.parts:
        out["ptxas"].update({"K": ptxas(built_log("sample_weighted.cu"), "hop_weighted"),
                             **{name: ptxas(logs[name], "hop_weighted") for name in kv}})
    if "K" in args.parts:
        k_gen = torch.Generator(device="cuda")
        k_gen.manual_seed(8)  # as chip_smoke.weighted_phase's: the same bench hop
        out.update(k_section(libs, list(kv), k_gen))
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    if "A" in args.parts or "B" in args.parts:
        out["ptxas"].update({"A": ptxas(built_log("row_gather.cu"), "row_gather_kernel"),
                             "B": ptxas(built_log("row_scatter.cu"), "row_scatter_tile"),
                             **{name: ptxas(logs[name], "row_") for name in {**av, **bv}}})
        out["AB"] = ab_section(libs, list(av) if "A" in args.parts else None,
                               list(bv) if "B" in args.parts else None, gen)
        torch.cuda.empty_cache()

    if "D" in args.parts:
        out["ptxas"].update({"D": ptxas(built_log("neighbor_agg.cu"), "neighbor_agg"),
                             **{name: ptxas(logs[name], "neighbor_agg") for name in dv}})
        out["D"] = d_section(libs, list(dv), gen)
        torch.cuda.empty_cache()

    if "L" in args.parts:
        out["ptxas"].update({"L": ptxas(built_log("sparse_apply.cu"), "sparse_apply"),
                             **{name: ptxas(logs[name], "sparse_apply") for name in lv}})
        out["L"] = l_section(libs, [n for n in lv if " host " not in n], gen)
        torch.cuda.empty_cache()
        out["L host"] = l_host_section(libs, list(lv), gen)
        torch.cuda.empty_cache()

    if "J" in args.parts:
        n, B = 4_000_000, 1 << 19
        data = torch.randn(n, 256, generator=gen, device="cuda")
        ids = torch.randint(0, n, (B,), generator=gen, device="cuda", dtype=torch.int32)
        idx = ids.long()
        ref = G.gather_rows_masked(data, ids)
        tile_bytes = G.MASKED_TILE_BYTES

        def j_call(lib=None, tb=tile_bytes):
            def call():
                G.MASKED_TILE_BYTES = tb
                try:
                    if lib is None:
                        return G.gather_rows_masked(data, ids)
                    with launching(G.ROW_GATHER_MASKED, lib):
                        return G.gather_rows_masked(data, ids)
                finally:
                    G.MASKED_TILE_BYTES = tile_bytes
            return call

        fns = {"A": lambda: G.gather_rows(data, ids),
               "index_select": lambda: torch.index_select(data, 0, idx)}
        fns.update({f"J tiles of {tb // 1024} KB": j_call(tb=tb)
                    for tb in (4096, 8192, 16384, 32768)})
        fns.update({name: j_call(libs[name]) for name in jv})
        for name, fn in fns.items():
            if name.startswith("J") and not torch.equal(bits(fn()), bits(ref)):
                raise SystemExit(f"kernel_variants: {name} differs from kernel J")
        out["J"] = in_turns(fns)
        out["J"]["shape"] = f"{B} uniform ids into [{n}, 256] f32, kernel tiles of {tile_bytes} bytes"
        del data, ids, idx, ref
        torch.cuda.empty_cache()

    if "G" in args.parts:
        g = clustered_csr(1 << 20, 16, 192)
        x = torch.randn(g.node_count, 256, generator=gen, device="cuda")
        w = torch.rand(g.edge_count, generator=gen, device="cuda")
        t_rp, t_col, perm = S.transpose_csr(g.row_ptr, g.col, g.node_count)
        cases = {"mean": ((g.row_ptr, g.col, x), {"reduce": "mean"}),
                 "weighted": ((g.row_ptr, g.col, x), {"edge_weight": w}),
                 "transposed": ((t_rp, t_col, x), {"edge_weight": w[perm]})}
        for case, (a, kw) in cases.items():
            ref = S.csr_spmm(*a, **kw)

            def g_call(lib=None, a=a, kw=kw):
                def call():
                    if lib is None:
                        return S.csr_spmm(*a, **kw)
                    with launching(S.CSR_SPMM, lib):
                        return S.csr_spmm(*a, **kw)
                return call

            fns = {"G": g_call(), **{name: g_call(libs[name]) for name in gv}}
            for name, fn in fns.items():
                if not name.startswith("probe") and not torch.equal(bits(fn()), bits(ref)):
                    raise SystemExit(f"kernel_variants: {name} differs from kernel G ({case})")
            out[f"G {case}"] = in_turns(fns)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
