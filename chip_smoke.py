"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths through their public entry points: the sampled
GraphSAGE training step (``wholegraph_tpu_torch.train``) with its embedding
in device memory, the same step with the sampled GCN, GAT and RGCN, the
typed-node (hetero) step, the host-memory tier's gather (``HostEmbedding.gather``)
at ``bench_host_gather``'s shapes, the same training step with the table
and LazyAdam's m and v in pinned host memory, full-graph message
passing (``wholegraph_tpu_torch.full_graph``: SAGE, GCN and GAT over a
``FullGraph``, forward and backward), and the sharded row store
(``ShardedTable.gather`` and ``.scatter``). In order:

1. builds every hand-written kernel from ``wholegraph_tpu_torch/csrc``;
2. measures the host link: the pinned->card and card->pinned rate of a
   1 GiB ``copy_`` (CUDA events), the yardstick printed beside kernels E and
   F (their bounds take the link's data-sheet peak, LINK_BYTES_PER_S);
3. builds the full-width synthetic state (``SageTrainConfig()``: 2M nodes,
   dim 256, batch 1024, fanouts (10, 15)) and runs one step that records the
   arguments of every kernel wrapper call;
4. holds kernels A-D against their plain PyTorch versions on exactly those
   tensors (plus A in bf16 and D as a sum), and times kernel, plain version
   and one PyTorch library call computing the same function. Kernel C is the
   whole sampler hop (``sample_hop_uniform``): bit-equal to its plain
   version on all five ``SampleResult`` fields on the step's two hops and on
   graphs with rows of degree 0, K and K + 1, a hub and out-of-range
   centres at K = 1, 10, 15 and 200, one kernel launched per
   ``csr_sample_neighbors`` call (its counter and torch.profiler); timed,
   also as device time from a CUDA graph, beside the parent's route (the PyTorch draw, then C's fetch ``sample_cols``), the
   plain version and the fetch's ``take`` (a reference: no single PyTorch
   call samples); C's fetch route checked on the same hops' positions;
5. runs a tiny step three times from the same numpy-made graph, table and
   weights on the card and on the CPU, with the embedding in device memory
   and in the host tier: the RNG and samples must be bit-equal, losses and
   touched rows equal within tolerance, untouched rows unchanged, and every
   cached row equal to its host row; then three tiny steps each of the
   sampled GCN (block and true degrees), GAT, RGCN and the hetero step on
   the card and on the CPU, losses within 1e-5 and the tables' summed row
   gradients (SGD) within 1e-4 of the largest;
6. the device-memory path: resets the launch counters, trains STEPS
   full-width steps timed by CUDA events (per step and per stage of
   ``train.STAGES``), fails if any of kernels A-D was not launched or the
   sampler launched anything but kernel C's hop, once a hop, and profiles
   ten more steps with ``torch.profiler`` (launches per step, busy share,
   the sample stage beside the step);
7. ``[weighted]``: kernel K, the weighted sampler hop, at
   ``bench_sampling(weighted=True)``'s shape (2,000,000 rows of degrees
   16..48, 64 M edges, weights ``U[0, 1) + 0.1`` and their pair table,
   65,536 centres, K = 15): both routes (pair table, separate arrays) held
   against the plain version on the card by the equality rule of
   ``ops.sampling.weighted_near_ties`` (bit for bit on every centre without
   two keys within 4 ulps near its cut; the near-tie counts printed), the
   routes bit-equal, one K launch a ``csr_sample_neighbors`` call by its
   count and no other kernel by the profiler; timed by CUDA events and as
   device time, beside the separate route, the plain version, the bound
   and ``torch.topk`` of the ready key matrix (a reference), and split by
   the probes of ``tools/kernel_variants.py`` (each takes one step out of
   K's register path: centre rows only, keys only, no sort, the sort over
   plain weights, no neighbour shuffle) with each build's registers,
   built from this checkout and timed in turns beside K; then degrees 0,
   K, K + 1, 32, 33, 64, 65, 128, 129, 256, 257 and a hub of 2^17,
   weights 0, -1, NaN and inf and out-of-range centres at K = 1, 15 and
   200;
8. ``[weighted_train]``: the device-memory step at
   ``SageTrainConfig(sample_method="weighted")`` (the graph of step 3 plus
   its weights and pair table): one captured step whose two K calls are
   checked and timed, then WEIGHTED_STEPS timed steps with the counts from
   0, failing unless K ran twice a step and C never, with the stage split,
   peak memory and a profiled window; a tiny weighted step, card against
   CPU, runs in ``[parity]``;
9. ``[sampled_agg]``: ``padded_reduce_windowed`` at
   ``bench_spmm_sampled``'s shape (the (10, 15) sample of 1,024 sorted
   centres over ``clustered_csr(2,000,000, 16, 192)``, x [U, 256] f32, the
   bench's per-run windows, mean): one kernel D launch, bit-equal to
   ``padded_reduce``, within K f32 ulps of the plain version, its gradient
   finite; timed;
9a. ``[sampled_models]``: the device-memory step at ``SageTrainConfig()``'s
   full width for the sampled GCN with block and with true degrees
   (``with_degrees=True``), GAT (4 heads of 64, one in the last layer) and
   RGCN (2 pseudo-relations): for each, one captured step whose every A, B,
   C and D call is held against its plain version (A, B and C bit-equal, D
   within K f32 ulps; D only in GCN, A also for GAT's and RGCN's neighbour
   rows), then NEW_STEPS timed steps with the counts from 0, failing unless
   each kernel ran exactly its calls a step; median, p90, stage split, peak
   memory and a profiled window;
9b. ``[hetero]``: ``HeteroTrainConfig()`` (the hetero example's widths,
   counts times 250: 1,000,000 papers, 375,000 authors, 50,000
   institutions, about 20M edges of 6 relations, the store under LazyAdam),
   its numpy build timed on its own line, then as in 9a (A 14 and B 9
   calls a step, C 2, no D);
10. the host gather: a 4,000,000 x 256 f32 pinned table behind an empty
   cache, batch 524,288, uniform ids and ids clustered in a span of
   1.25 x batch rows; kernel E bit-equal to its plain version, its rate
   against the link's, the bytes it read across the link (E's own count)
   and its sort's share, and the library routes (a CPU
   ``index_select`` into pinned staging and a copy; a span ``copy_`` and a
   take on the card);
11. the host-tier path: ``SageTrainConfig()`` with ``cache_ratio=0.25`` and
   the top-degree rows cached; one captured step whose every E and F call is
   held against its plain version (E with the link bytes it read; F by its
   written rows and a sample of
   untouched rows), and so is every A and B call on the cache's lines; then
   HOST_STEPS timed steps with the stage split, the
   cache hit fraction, peak device memory and pinned bytes, failing if any
   of kernels A-F was not launched (C: once a hop);
12. ``[fg_spmm]``: kernel G at ``bench_spmm_clustered``'s shapes
   (``clustered_csr(2^20, 16, 192)``, 20,441,541 edges, x [2^20, 256] f32):
   mean, sum and weighted sum held against the plain version, each also
   bit-equal to G with staging off (``_stage=False``, every tile through
   device memory) and to itself, with G's own counts (tiles staged, bytes
   staged, tiles and edges left to device memory); the same degrees with
   uniform columns (no tile staged); then the forward plus backward of
   ``spmm_window``'s mean with G's transposed launch held against its plain
   version and dx against an ``index_add_`` scatter; times (CUDA events and
   device time from a CUDA graph) beside the bound, the plain version and
   cuSPARSE (``torch.sparse.mm``);
13. ``[fg_sddmm]``: kernel H at ``bench_sddmm_clustered``'s shapes, and on
    the same degrees with uniform columns (no tile's window fits), against
    its plain version (and against itself: two runs bit-identical), beside
    cuSPARSE ``sampled_addmm``, with H's own counts of the tiles it staged,
    the bytes it staged in shared memory and the edges it read from device
    memory;
14. ``[fg_gat]``: the GAT layer at ``bench_gat_layer``'s shapes (2^18 nodes,
    4 heads of 64 over width 256, self loop): one captured forward plus
    backward with the counts from 0, every G and H call held against its
    plain version, ``attn_src``'s gradient nonzero; forward and forward
    plus backward timed;
15. ``[fg_parity]``: tiny full-graph SAGE, GCN and GAT on the card against
    the CPU from the same numpy data;
16. ``[fg_model]``: ``FullGraphConfig()`` (the bench graph, a [2^20, 256]
    f32 device-memory embedding as the features) with a 2-layer SAGE and a
    2-layer GCN: for each, the counts from 0, ``eval_full_graph`` on
    FG_CENTERS centres, FG_STEPS timed ``full_graph_value_and_grad`` runs,
    failing unless A and G (both routes) were launched;
17. ``[store]``: the sharded row store (``ShardedTable``) at the JAX
    benches' shapes, a 4,000,000 x 256 table of random rows: with the counts
    from 0, ``gather(local_kernel="sorted")`` on ``bench_gather_sorted``'s
    ids (2^19 sorted unique ids at density 0.8; kernel I, f32 and bf16),
    ``gather`` on ``bench_gather``'s (2^19 uniform ids; kernel J) and
    ``scatter(donate=True)`` on ``bench_scatter``'s (kernel B's masked
    route), failing unless each launched; then each call held bit-equal to
    its plain version and timed beside its bound, kernel A on the same ids
    and ``index_select`` (``index_copy_`` for the scatter), with I's own
    counts (``_stats``: tiles windowed, tiles read directly, bytes read);
    I against A and ``index_select`` over densities 1.0, 0.8, 0.5, 0.2 at
    D = 256 and D = 16, by CUDA events and by device time (a CUDA graph),
    with its counts; I exact on unsorted,
    duplicated and out-of-range ids; the add against float64; a tiny table
    on the card against the CPU;

then prints a ``kernels`` JSON line (A-K, G's forward and transposed
routes apart, B's masked launches beside its own, A-D's launches over the
NEW_STEPS steps of each model of 9a and 9b; ``launches`` counts
wrapper calls, and G's and H's ``launches_per_call`` the kernels one
bench call launched, as torch.profiler saw them, which must be G's span,
window and rows kernels and H's two), the card's
name and power limit, and,
as the last line, ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA it exits non-zero before printing any result.

``python3 chip_smoke.py --paired-times [part ...]`` only builds the kernels
and times them through entry points that every tree of the port with the
row store has (:func:`paired_times`; parts ``steps``, ``store``, ``sweep``,
``spmm``, ``sddmm``, all by default; ``weighted``, uniform and weighted
steps in turns, only when named), so that the same function also times
another tree: run it from that tree's root as ``python3 -c "import runpy,
sys; sys.argv = ['chip_smoke.py', '--paired-times', 'store', 'spmm'];
runpy.run_path('<path of this file>', run_name='__main__')"``, which imports
that tree's package, for runs of two trees in turns on one card.
"""

import contextlib
import dataclasses
import inspect
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this smoke test needs a GPU")

import wholegraph_tpu_torch as wt  # noqa: E402
from wholegraph_tpu_torch import kernels  # noqa: E402
from wholegraph_tpu_torch.embedding import (SGD, Embedding, HostEmbedding,  # noqa: E402
                                            LazyAdam, hot_ids_by_degree)
from wholegraph_tpu_torch.embedding import embedding as emb_mod  # noqa: E402
from wholegraph_tpu_torch.embedding import host_embedding as host_mod  # noqa: E402
from wholegraph_tpu_torch.graph import GraphStructure, HeteroFeatureStore  # noqa: E402
from wholegraph_tpu_torch.models import GATConv, HomoGNN  # noqa: E402
from wholegraph_tpu_torch.ops import KERNELS  # noqa: E402
from wholegraph_tpu_torch.ops import gather as gather_mod  # noqa: E402
from wholegraph_tpu_torch.ops import gather_kernels as G  # noqa: E402
from wholegraph_tpu_torch.ops import host_kernels as H  # noqa: E402
from wholegraph_tpu_torch.ops import rng  # noqa: E402
from wholegraph_tpu_torch.ops import sampling as sampling_mod  # noqa: E402
from wholegraph_tpu_torch.ops import spmm_kernels as S  # noqa: E402
from wholegraph_tpu_torch.tools import kernel_variants  # noqa: E402
from wholegraph_tpu_torch.train import STAGES  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
LINK_BYTES_PER_S = 64e9     # H100 SXM PCIe Gen5 x16: 128 GB/s both ways (NVIDIA data sheet)
STEPS = 100                 # timed full-width steps (p90 has 10 beyond it)
HOST_STEPS = 30             # timed host-tier steps (p90 has 3 beyond it)
HOST_CACHE_RATIO = 0.25     # __graft_entry__.py's host-tier cache_ratio
FG_STEPS = 20               # timed full-graph value_and_grad runs per model (p90 has 2 beyond it)
FG_CENTERS = 1024           # centres of the full-graph evaluation and loss
STORE_ROWS = 4_000_000      # bench_gather's, bench_gather_sorted's and bench_scatter's table rows
STORE_BATCH = 1 << 19       # their batch
F32_EPS = float(np.finfo(np.float32).eps)
BF16_EPS = 2.0 ** -7
SAMPLE_FIELDS = ("neighbors", "mask", "positions", "edge_ids", "degree")


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters=20, warmup=3, lead=True):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, by CUDA events.
    With ``lead`` one more call is enqueued before the first
    event, so that the card is busy while the host enqueues the timed
    calls: the host's latency to its first launch (tens of microseconds
    through a ctypes wrapper) is not in the time unless the host cannot
    keep ahead of the card. ``lead=False`` times from the first call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead:
        fn()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes, ops=0.0):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def link_bound_ms(link_bytes, hbm_bytes):
    """Least time for bytes that cross the host link at its data-sheet peak
    and bytes that stay in device memory."""
    return max(link_bytes / LINK_BYTES_PER_S, hbm_bytes / HBM_BYTES_PER_S) * 1e3, "bytes"


def link_yardsticks(t, link_bytes, delivered, copy_gbps):
    """Beside a host-row call's times: the ms its link bytes take at this
    run's ``copy_`` rate, and its delivered GB/s against the link's peak and
    against that rate."""
    t.update(copy_ms=link_bytes / (copy_gbps * 1e6), delivered_GBps=delivered / t["ms"] / 1e6)
    t.update(peak_share=t["delivered_GBps"] / (LINK_BYTES_PER_S / 1e9),
             copy_share=t["delivered_GBps"] / copy_gbps)
    return t


@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name`` (a kernel
    wrapper as the path looks it up) into ``calls``. Nothing but the
    embedding's tables is written after such a call, and the scatter
    checks work on copies of those or on their written rows."""
    fn = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def reset_launches():
    for k in KERNELS:
        k.launches = 0
        k.routes.clear()


def read_launches():
    return {k.name: k.launches for k in KERNELS}


def free_pinned():
    """Return cached pinned blocks to the system (PyTorch's caching host
    allocator keeps freed ones); True where this PyTorch offers the call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()
    return fn is not None


def pinned_bytes(tensors):
    """(bytes the tensors asked for, the caching host allocator's own count
    of the pinned bytes it holds -- ``allocated_bytes.current`` of
    ``torch.cuda.host_memory_stats()``, active and cached blocks at their
    rounded sizes -- or None where this PyTorch lacks that count)."""
    asked = sum(t.untyped_storage().nbytes() for t in tensors)
    fn = getattr(torch.cuda, "host_memory_stats", None)
    held = fn().get("allocated_bytes.current") if fn is not None else None
    return asked, held


# ---------------------------------------------------------------------------
# kernel checks on the main path's own tensors
# ---------------------------------------------------------------------------


def timings(case, kernel, plain, library, bound, iters=20, plain_iters=20):
    """One main-path call's times (ms, CUDA events) beside its bound."""
    b_ms, by = bound
    return {"case": case, "ms": cuda_ms(kernel, iters),
            "plain_ms": cuda_ms(plain, plain_iters, warmup=min(3, plain_iters)),
            "library_ms": cuda_ms(library, plain_iters, warmup=min(3, plain_iters)),
            "bound_ms": b_ms, "bound_by": by}


def check_gather(calls):
    """Kernel A on the embedding gather and the apply's three row reads."""
    errs, times = [], []
    for i, (table, ids) in enumerate(calls):
        n, rb = table.shape[0], table.shape[1] * table.element_size()
        for t in ((table, table.to(torch.bfloat16)) if i == 0 else (table,)):
            err = max_err(G.gather_rows(t, ids), G.gather_rows_plain(t, ids))
            require(err == 0.0, f"row_gather {t.dtype} differs from its plain version: {err}")
            errs.append({"case": f"call{i} {str(t.dtype)[6:]}", "max_abs_err": err, "tol": 0.0})
        clipped = ids.long().clamp(0, n - 1)
        m = ids.numel()
        times.append(timings(
            f"call{i} [{m}] of [{n}, {table.shape[1]}]",
            lambda: G.gather_rows(table, ids), lambda: G.gather_rows_plain(table, ids),
            lambda: torch.index_select(table, 0, clipped),
            bound_ms(4 * m + torch.unique(clipped).numel() * rb + m * rb)))
    return errs, times


def check_scatter(calls):
    """Kernel B on the apply's write-backs, into a copy of each table."""
    errs, times = [], []
    for i, (table, ids, rows) in enumerate(calls):
        n, rb = table.shape[0], table.shape[1] * table.element_size()
        a, b = table.clone(), table.clone()
        G.scatter_rows(a, ids, rows)
        G.scatter_rows_plain(b, ids, rows)
        err = max_err(a, b)
        require(err == 0.0, f"row_scatter differs from its plain version: {err}")
        errs.append({"case": f"call{i}", "max_abs_err": err, "tol": 0.0})
        valid = (ids >= 0) & (ids < n)
        vids, vrows = ids[valid].long(), rows[valid]
        times.append(timings(
            f"call{i} [{ids.numel()}] into [{n}, {table.shape[1]}]",
            lambda: G.scatter_rows(a, ids, rows), lambda: G.scatter_rows_plain(a, ids, rows),
            lambda: a.index_copy_(0, vids, vrows),
            bound_ms(4 * ids.numel() + 2 * vids.numel() * rb)))
        del a, b
    return errs, times


def same_sample(a, b):
    """All five fields of two SampleResults bit-equal (dtypes included)."""
    return all(getattr(a, f).dtype == getattr(b, f).dtype and torch.equal(getattr(a, f), getattr(b, f))
               for f in SAMPLE_FIELDS)


def parent_route(row_ptr, col, centers, K, seed, hop):
    """The parent's hop: the draw and the rank fixpoint as PyTorch ops, then
    the separate column fetch (C's ``wg_sample_cols``)."""
    start, deg = sampling_mod._centre_rows(row_ptr, centers)
    pos, mask = sampling_mod._sample_positions_uniform(deg, K, seed, centers, hop)
    return G.sample_cols(col, start, pos, mask), mask, pos, start[:, None] + pos, deg


def profiled(fn, iters=1):
    """By torch.profiler over ``iters`` calls of ``fn()`` (copies and memsets
    not counted): the kernel launches it recorded per call, and their
    names. On an H100 the profiler missed launches of some windows (19 of
    20 recorded, 2 of 20, none of 1), so a count it gives is a lower bound
    and times come from :func:`graph_ms`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
            and not e.key.startswith(("Memcpy", "Memset"))]
    return sum(e.count for e in kern) / iters, [e.key[:60] for e in kern]


G_KERNELS = ("csr_spmm_span_kernel", "csr_spmm_window_kernel", "csr_spmm_rows_kernel")
H_KERNELS = ("csr_sddmm_device_kernel", "csr_sddmm_window_kernel")


def launch_structure(case, fn, expect, tries=5):
    """The kernels one call of ``fn()`` launches, as torch.profiler saw
    them: the distinct kernel names of up to ``tries`` windows of 5 calls,
    gathered until each of ``expect`` (one name for each kernel the wrapper
    should launch) has been seen; the profiler misses launches on that
    machine, so one window can show fewer. Fails unless it saw exactly the
    kernels of ``expect``. Returns their number and the most launches a
    call that one window recorded."""
    seen, most = set(), 0.0
    for _ in range(tries):
        n_kern, names = profiled(fn, 5)
        seen.update(names)
        most = max(most, n_kern)
        if all(any(x in k for k in seen) for x in expect):
            break
    require(all(any(x in k for k in seen) for x in expect)
            and all(any(x in k for x in expect) for k in seen),
            f"{case}: the profiler saw the kernels {sorted(seen)}, expected {list(expect)}")
    return {"kernels_per_call": len(seen), "profiler_launches_per_call": most,
            "kernels_seen": sorted(seen)}


def graph_ms(fn, iters=20):
    """Device ms of one call of ``fn()``: ``iters`` calls captured in a CUDA
    graph, the graph replayed and timed by CUDA events. The graph launches
    the calls' kernels back to back, so none of the host's per-call work
    (checks, allocations, the launch itself) is in the time, where at
    D = 16 it is most of what :func:`cuda_ms` reads."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    ms = cuda_ms(g.replay, iters=5, warmup=1) / iters
    del g
    return ms


def sampler_cases(gen):
    """Graphs and centres beyond the step's: rows of degree 0, K and K + 1,
    a hub of degree 10^6, every centre id outside [0, n) of either sign."""
    out = []
    for K in (1, 10, 15, 200):
        n = 20_000
        degs = torch.randint(0, 2 * K + 4, (n,), generator=gen, device="cuda")
        degs[:6] = torch.tensor([0, 0, 0, K, K + 1, 1_000_000], device="cuda")
        row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                             torch.cumsum(degs, 0)]).to(torch.int32)
        col = torch.randint(0, n, (int(row_ptr[-1]),), generator=gen, device="cuda",
                            dtype=torch.int32)
        centers = torch.cat([torch.arange(n, device="cuda"),
                             torch.tensor([5, 5, 3, 4, 0, -1, -7, n, n + 9, -(2**31), 2**31 - 1],
                                          device="cuda")]).to(torch.int32)
        out.append((f"K={K} degrees 0, K, K+1, hub 10^6, out-of-range centres",
                    (row_ptr, col, centers, K, 17, 1)))
    return out


def check_sample_hop(calls, gen):
    """Kernel C on each hop of the step, and on :func:`sampler_cases`: the
    hop kernel bit-equal to its plain version on all five fields, and one
    kernel launch per hop; C's fetch route on the same hops' positions.
    Times per hop: the kernel (CUDA events, and its device time by
    :func:`graph_ms`), the parent's route (the PyTorch draw then the fetch), the
    plain version, and the fetch's ``take`` with its index and mask inside
    the timed call (a reference: no single PyTorch call samples)."""
    errs, times = [], []
    cases = [(f"hop{i} B={c[2].numel()} K={c[3]}", c) for i, c in enumerate(calls)]
    for case, (row_ptr, col, centers, K, seed, hop) in cases + sampler_cases(gen):
        got = sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed, hop)
        ref = sampling_mod.csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)
        require(same_sample(got, ref), f"sample_hop_uniform ({case}) differs from its plain version")
        require(same_sample(got, sampling_mod.SampleResult(*parent_route(
            row_ptr, col, centers, K, seed, hop))), f"the parent's route differs ({case})")

        def call():
            return wt.ops.csr_sample_neighbors(row_ptr, col, centers, K, seed=seed, hop=hop)

        k0 = sampling_mod.SAMPLE_HOP.launches
        call()
        require(sampling_mod.SAMPLE_HOP.launches == k0 + 1,
                f"csr_sample_neighbors ({case}) did not launch kernel C once")
        for _ in range(3):  # a window in which the profiler recorded something
            n_kern, names = profiled(call, 5)
            if names:
                break
        require(names and n_kern <= 1 and all("hop_" in k for k in names),
                f"csr_sample_neighbors ({case}) launched other kernels: {n_kern} a call, {names}")
        dev_ms = graph_ms(call)
        valid = int(ref.mask.sum())
        errs.append({"case": case, "max_abs_err": 0.0, "tol": 0.0, "fields": list(SAMPLE_FIELDS),
                     "valid_slots": valid, "kernels_per_call": n_kern})
        # C's fetch route, on the same positions
        start, _ = sampling_mod._centre_rows(row_ptr, centers)
        fetch = G.sample_cols(col, start, ref.positions, ref.mask)
        require(torch.equal(fetch, G.sample_cols_plain(col, start, ref.positions, ref.mask)),
                f"sample_cols ({case}) differs from its plain version")
        if not case.startswith("hop"):
            continue
        B = centers.numel()
        pos, mask, n_e = ref.positions, ref.mask, col.shape[0]

        def take():  # the fetch alone, index and mask in the call
            e = (start.long()[:, None] + pos.long()).clamp(0, n_e - 1)
            return torch.where(mask, torch.take(col, e), -1)

        nbytes = B * (4 + 8 + 4) + 4 * valid + B * K * 13
        b_ms, by = bound_ms(nbytes)
        t = {"case": f"{case.split()[0]} [{B}, {K}]", "ms": cuda_ms(
                lambda: sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed, hop)),
             "parent_route_ms": cuda_ms(lambda: parent_route(row_ptr, col, centers, K, seed, hop),
                                        10),
             "plain_ms": cuda_ms(lambda: sampling_mod.csr_sample_neighbors_plain(
                 row_ptr, col, centers, K, seed, hop), 10),
             "device_ms": dev_ms, "library_ms": None, "take_ms": cuda_ms(take), "bound_ms": b_ms,
             "bound_by": by,
             "bytes": nbytes, "valid_slots": valid,
             "fetch_route": {"ms": cuda_ms(lambda: G.sample_cols(col, start, pos, mask)),
                             "plain_ms": cuda_ms(lambda: G.sample_cols_plain(col, start, pos,
                                                                             mask)),
                             "bound_ms": bound_ms(4 * B + 9 * B * K + 4 * valid)[0]}}
        t["bound_share"] = t["bound_ms"] / t["ms"]
        times.append(t)
        log(f"[check] sample_hop_uniform {t['case']}: kernel {t['ms']} ms (CUDA events over "
            f"back-to-back calls; its device time {dev_ms} ms, from a CUDA graph), parent's route "
            f"{t['parent_route_ms']} ms, plain {t['plain_ms']} ms, fetch take {t['take_ms']} ms "
            f"(reference), bound {b_ms} ms; fetch route sample_cols {t['fetch_route']['ms']} ms")
    return errs, times


def check_neighbor_agg(calls):
    """Kernel D on each layer's aggregation, as called (mean) and as a sum,
    in f32 and bf16. Tolerance: the kernel and the plain version add up to K
    f32 values in other orders, so they may differ by K f32 ulps of the
    largest output; in bf16 both round the f32 sum, one bf16 ulp apart at
    most."""
    errs, times = [], []
    for i, (x, nbr, mask, mean) in enumerate(calls):
        B, K = nbr.shape
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            for m in (mean, not mean):
                ref = S.neighbor_reduce_plain(xd, nbr, mask, m)
                scale = max(1.0, ref.float().abs().max().item())
                tol = K * F32_EPS * scale + (BF16_EPS * scale if dt == torch.bfloat16 else 0.0)
                err = max_err(S.neighbor_reduce(xd, nbr, mask, m), ref)
                require(err <= tol, f"neighbor_agg {dt} mean={m} err {err} > tol {tol}")
                errs.append({"case": f"layer{i} {str(dt)[6:]} {'mean' if m else 'sum'}",
                             "max_abs_err": err, "tol": tol})
        w = mask.float()
        if mean:
            w = w / w.sum(dim=1, keepdim=True).clamp(min=1.0)
        idx = nbr.long()
        rb = x.shape[1] * x.element_size()
        uniq = torch.unique(nbr[mask]).numel()
        times.append(timings(
            f"layer{i} [{B}, {K}] over [{x.shape[0]}, {x.shape[1]}]",
            lambda: S.neighbor_reduce(x, nbr, mask, mean),
            lambda: S.neighbor_reduce_plain(x, nbr, mask, mean),
            lambda: F.embedding_bag(idx, x, mode="sum", per_sample_weights=w),
            bound_ms(5 * B * K + uniq * rb + B * rb, int(mask.sum()) * x.shape[1])))
    return errs, times


def time_host_gather(case, table, slots, link, kw=None):
    """Kernel E on one call (``host_gather_rows(table, slots, **kw)``, the
    sort of its plan included): times beside its bound at the link's peak
    and the measured ``copy_`` rate, the bytes E moves across the link (each
    distinct valid row once), the plan's sort alone, and the library route a
    caller without E would take: a CPU ``index_select`` of the valid rows
    into pinned staging, then a non-blocking copy to the card (the ids sit
    on the CPU beforehand)."""
    kw = kw or {}
    rb = table.shape[1] * table.element_size()
    valid = (slots >= 0) & (slots < table.shape[0])
    vids = slots[valid].long().cpu()
    staging = H.pinned_empty((vids.numel(), table.shape[1]), table.dtype)
    dst = torch.empty((vids.numel(), table.shape[1]), dtype=table.dtype, device=slots.device)

    def library():
        torch.index_select(table, 0, vids, out=staging)
        dst.copy_(staging, non_blocking=True)

    uniq = torch.unique(vids).numel()
    t = timings(case, lambda: H.host_gather_rows(table, slots, **kw),
                lambda: H.host_gather_rows_plain(table, slots), library,
                link_bound_ms(uniq * rb, slots.numel() * (4 + rb)),
                iters=10, plain_iters=2)
    read = torch.zeros(1, dtype=torch.int64, device=slots.device)
    H.host_gather_rows(table, slots, **kw, _stats=read)  # E counts the bytes it reads
    t.update(rows=slots.numel(), valid_rows=vids.numel(), unique_rows=uniq,
             link_bytes_read=int(read.item()), link_bytes_asked=vids.numel() * rb,
             plan_ms=cuda_ms(lambda: H.host_gather_plan(slots, table.shape[0]), 10)
             if kw.get("_sort", True) else 0.0)
    return link_yardsticks(t, uniq * rb, vids.numel() * rb, link["h2d_GBps"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def quantile(values, q):
    return float(np.quantile(np.asarray(values), q))


def link_rates():
    """Pinned->card and card->pinned rate of a 1 GiB ``copy_``, GB/s."""
    n = 1 << 30
    host = H.pinned_empty((n,), torch.uint8).fill_(1)
    dev = torch.empty((n,), dtype=torch.uint8, device="cuda")
    h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), iters=5, warmup=1)
    d2h = cuda_ms(lambda: host.copy_(dev, non_blocking=True), iters=5, warmup=1)
    del host, dev
    free_pinned()
    return {"h2d_GBps": n / h2d / 1e6, "d2h_GBps": n / d2h / 1e6, "bytes": n,
            "h2d_ms": h2d, "d2h_ms": d2h}


def device_time(state, batch, step_ms, steps=10, sample_ms=None, step=None):
    """Kernel time per training step (``step``, ``wt.train_step`` unless
    given) under torch.profiler, its share of the unprofiled median step,
    launches per step, and the kernels that take most of it."""
    step = step or wt.train_step
    work = [batch() for _ in range(steps)]
    return profile_steps("profile", lambda i: step(state, *work[i], seed=1000 + i),
                         step_ms, steps, sample_ms)


def profile_steps(tag, step, step_ms, steps, sample_ms=None):
    """Kernel time per call of ``step(i)`` under torch.profiler over
    ``steps`` calls, its share of the unprofiled median ``step_ms``, the
    kernel launches per call, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    # device-side entries, less user annotations (Optimizer.step's range),
    # which span kernels already counted
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    per_step = sum(e.count for e in kern) / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    log(f"[{tag}] {steps} steps: device busy {busy_ms} ms per step, "
        f"{len(kern)} kernel names, {per_step} launches per step; "
        f"busy share of the {step_ms} ms median step: {busy_ms / step_ms}"
        + ("" if sample_ms is None else f"; its sample stage {sample_ms} ms"))
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
            f"{e.count // steps:5d}x  {e.key[:100]}")
    return {"busy_ms": busy_ms, "launches_per_step": per_step, "busy_share": busy_ms / step_ms}


def coherent(emb):
    """Every cached row equals its host row (host_embedding.py:24-27)."""
    torch.cuda.synchronize()
    cached = emb.cache_map >= 0
    lines = emb.cache_map[cached].long()
    return torch.equal(emb.cache_rows[lines].cpu(), emb.host_table[cached.cpu()])


def small_parity():
    """A tiny step on the card and on the CPU from the same numpy data, with
    the embedding in device memory and in the host tier."""
    cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=128, hidden=128, num_classes=16,
                             batch=32, fanouts=(10, 15))
    rs = np.random.RandomState(7)
    degs = rs.randint(cfg.deg // 2, cfg.deg + cfg.deg // 2 + 1, cfg.n_nodes)
    degs[:4] = 0
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, cfg.n_nodes, row_ptr[-1]).astype(np.int32)
    table = (rs.randn(cfg.n_nodes, cfg.dim) / np.sqrt(cfg.dim)).astype(np.float32)
    labels = rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32)
    ref_model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device="cpu")
    weights = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32) / np.sqrt(v.shape[-1]))
               for k, v in ref_model.state_dict().items()}
    batches = [rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32) for _ in range(3)]
    hot = hot_ids_by_degree(row_ptr, HOST_CACHE_RATIO)

    def state(dev, host):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=dev)
        model.load_state_dict(weights)
        if host:
            emb = HostEmbedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(),
                                       cache_ratio=HOST_CACHE_RATIO, device=dev)
            emb.from_array(table, hot_ids=hot)
        else:
            emb = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=dev)
            emb.from_array(table)
        return wt.SageTrainState(
            cfg, GraphStructure(torch.from_numpy(row_ptr).to(dev), torch.from_numpy(col).to(dev),
                                cfg.n_nodes),
            emb, model, torch.optim.Adam(model.parameters(), lr=cfg.lr),
            torch.from_numpy(labels).to(dev))

    runs = {"hbm_gpu": state("cuda", False), "hbm_cpu": state("cpu", False),
            "host_gpu": state("cuda", True), "host_cpu": state("cpu", True)}
    gpu, cpu = runs["hbm_gpu"], runs["hbm_cpu"]
    keys = torch.from_numpy(rs.randint(-2**31, 2**31, 4096).astype(np.int64))
    require(torch.equal(rng.rand_u32(5, keys.cuda(), keys.flip(0).cuda()).cpu(),
                        rng.rand_u32(5, keys, keys.flip(0))), "rng differs between GPU and CPU")
    c0 = torch.from_numpy(batches[0])
    mg = gpu.graph.multilayer_sample(c0.cuda(), cfg.fanouts, seed=0)
    mc = cpu.graph.multilayer_sample(c0, cfg.fanouts, seed=0)
    require(torch.equal(mg.unique_gids.cpu(), mc.unique_gids) and
            torch.equal(mg.unique_mask.cpu(), mc.unique_mask) and
            all(torch.equal(a.nbr_idx.cpu(), b.nbr_idx) and torch.equal(a.mask.cpu(), b.mask)
                for a, b in zip(mg.hops, mc.hops)), "samples differ between GPU and CPU")
    tol = 1e-5  # f32 sums in other orders on the two devices, over three Adam steps
    losses, touched = {k: [] for k in runs}, []
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        for name, st in runs.items():
            cd = c.to(st.labels.device)
            losses[name].append(float(wt.train_step(st, cd, st.labels[cd.long()], seed=i)))
        ml = cpu.graph.multilayer_sample(c, cfg.fanouts, seed=i)
        touched.append(ml.unique_gids[ml.unique_mask])
    rows = torch.unique(torch.cat(touched)).long()
    untouched = torch.ones(cfg.n_nodes, dtype=torch.bool)
    untouched[rows] = False
    tables = {"hbm_gpu": gpu.embedding.table.cpu(), "hbm_cpu": cpu.embedding.table,
              "host_gpu": torch.from_numpy(runs["host_gpu"].embedding.to_array()),
              "host_cpu": runs["host_cpu"].embedding.host_table}
    errs = {}
    for a, b in (("hbm_gpu", "hbm_cpu"), ("host_gpu", "host_cpu"), ("host_gpu", "hbm_gpu")):
        for la, lb in zip(losses[a], losses[b]):
            require(abs(la - lb) <= tol * max(1.0, abs(lb)), f"loss {la} ({a}) vs {lb} ({b})")
        errs[f"{a}/{b}"] = max_err(tables[a][rows], tables[b][rows])
        require(errs[f"{a}/{b}"] <= tol, f"touched rows differ, {a} vs {b}: {errs}")
    for name in ("hbm_gpu", "host_gpu"):
        require(torch.equal(tables[name][untouched], torch.from_numpy(table)[untouched]),
                f"untouched rows changed ({name})")
    require(coherent(runs["host_gpu"].embedding), "host tier: a cached row differs from the host")
    log(f"[parity] 3 tiny steps, losses {json.dumps(losses)}, touched rows {rows.numel()}, "
        f"max row diffs {errs} (tol {tol}); host tier: {len(hot)} rows cached, coherent")


def train_timed(state, batch, steps, seed0, step=None):
    """``steps`` timed steps of ``step`` (``wt.train_step`` unless given):
    per-step and per-stage CUDA-event ms, host clock ms, losses."""
    step = step or wt.train_step
    names = ("start",) + STAGES
    step_ms, host_ms, losses = [], [], []
    stage_ms = {s: [] for s in STAGES}
    for i in range(steps):
        c, y = batch()
        torch.cuda.synchronize()
        events = {}

        def mark(stage):
            events[stage] = torch.cuda.Event(enable_timing=True)
            events[stage].record()

        t0 = time.perf_counter()
        mark("start")
        loss = step(state, c, y, seed=seed0 + i, mark=mark)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(events["start"].elapsed_time(events[STAGES[-1]]))
        for a, b in zip(names, names[1:]):
            stage_ms[b].append(events[a].elapsed_time(events[b]))
        losses.append(float(loss))
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return step_ms, host_ms, stage_ms, losses, c


def timed_steps(tag, state, batch, steps, profile_steps=10, step=None):
    """One warm-up step; ``steps`` timed steps (:func:`train_timed`) with the
    launch counts from 0, reported; then ``profile_steps`` under the profiler
    (:func:`device_time`). ``step`` is ``wt.train_step`` unless given.
    Returns the summary, the launches of the timed steps and the last
    batch's centres."""
    step = step or wt.train_step
    float(step(state, *batch(), seed=1))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, stage_ms, losses, c = train_timed(state, batch, steps, 2, step)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    report_steps(tag, steps, step_ms, host_ms, stage_ms, losses, peak, launches)
    med, sample = statistics.median(step_ms), statistics.median(stage_ms["sample"])
    summary = {"step_median_ms": med, "step_p90_ms": quantile(step_ms, 0.9),
               "sample_median_ms": sample, "peak_bytes": peak,
               "stage_medians_ms": {k: statistics.median(v) for k, v in stage_ms.items()},
               "wrapper_launches_per_step": {k: v / steps for k, v in launches.items() if v},
               **device_time(state, batch, med, profile_steps, sample, step)}
    return summary, launches, c


def report_steps(tag, steps, step_ms, host_ms, stage_ms, losses, peak, launches):
    log(f"[{tag}] {steps} steps at full width: first losses {losses[:5]}, last {losses[-5:]}")
    log(f"[{tag}] step ms (CUDA events) median {statistics.median(step_ms)}, "
        f"p90 {quantile(step_ms, 0.9)}, min {min(step_ms)}, max {max(step_ms)}; "
        f"sample stage median {statistics.median(stage_ms['sample'])}; "
        f"host clock median {statistics.median(host_ms)}; "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB); hand-written kernel launches "
        f"{launches} ({sum(launches.values()) / steps} per step)")
    log(f"[{tag}] stage ms medians (CUDA events): "
        + json.dumps({s: statistics.median(v) for s, v in stage_ms.items()}))


def host_gather_phase(link):
    """The host tier's gather at bench_host_gather's shapes (empty cache)."""
    n, dim, batch = 4_000_000, 256, 1 << 19
    t0 = time.perf_counter()
    emb = HostEmbedding.create(n, dim, cache_ratio=1e-9)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    emb.init(gen)  # random rows, so bit-equality says something
    torch.cuda.synchronize()
    asked, held = pinned_bytes([emb.host_table])
    log(f"[host_gather] [{n}, {dim}] f32 pinned table in {time.perf_counter() - t0:.2f} s: "
        f"{asked} bytes asked; the caching host allocator holds {held} pinned bytes")
    span = int(batch * 1.25)
    base = int(torch.randint(0, n - span, (1,), generator=gen, device="cuda"))
    regimes = {
        "uniform": torch.randint(0, n, (batch,), generator=gen, device="cuda", dtype=torch.int32),
        "clustered": base + torch.randint(0, span, (batch,), generator=gen, device="cuda",
                                          dtype=torch.int32),
    }
    out, errs = [], []
    for regime, ids in regimes.items():
        calls = []
        torch.cuda.synchronize()
        reset_launches()
        with capture_kw(host_mod, "host_gather_rows", calls):
            rows = emb.gather(ids)
            torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        require(launches.get("host_gather", 0) > 0 and launches.get("row_gather", 0) > 0,
                f"host gather ({regime}) did not launch kernels E and A: {launches}")
        (table, slots), kw = calls[0]
        ref = H.host_gather_rows_plain(table, slots)
        err = max_err(H.host_gather_rows(table, slots, **kw), ref)
        require(err == 0.0 and torch.equal(rows, ref),
                f"host_gather ({regime}) differs from its plain version: {err}")
        errs.append({"case": f"bench {regime}", "max_abs_err": err, "tol": 0.0})
        t = time_host_gather(f"bench {regime} [{batch}] of [{n}, {dim}]", table, slots, link, kw)
        t.update(regime=regime, launches=launches, gather_ms=cuda_ms(lambda: emb.gather(ids), 10))
        rb = dim * 4
        if regime == "clustered":  # row 10's yardstick: the span's copy_, then a take
            lo, hi = int(slots.min()), int(slots.max())
            span_dev = torch.empty((hi - lo + 1, dim), device="cuda")
            rel = (slots - lo).long()
            t["library_cpu_ms"] = t["library_ms"]
            t["library_ms"] = cuda_ms(lambda: torch.index_select(
                span_dev.copy_(emb.host_table[lo:hi + 1], non_blocking=True), 0, rel),
                iters=5, warmup=1)
            t.update(span_rows=hi - lo + 1, library="span copy_ + index_select",
                     library_cpu="CPU index_select + copy")
            del span_dev
        else:
            t["library"] = "CPU index_select + copy"
        log(f"[host_gather] {regime}: E {t['ms']} ms for {batch} rows of {rb} B, "
            f"{t['delivered_GBps']} GB/s delivered = {t['peak_share']} of the link's "
            f"{LINK_BYTES_PER_S / 1e9} GB/s peak, {t['copy_share']} of its {link['h2d_GBps']} "
            f"GB/s copy_; whole gather {t['gather_ms']} ms; bound {t['bound_ms']} ms (at the "
            f"copy_ rate {t['copy_ms']} ms); plain {t['plain_ms']} ms; library {t['library_ms']} ms"
            + (f" (CPU route {t['library_cpu_ms']} ms)" if "library_cpu_ms" in t else "")
            + f"; {t['unique_rows']} unique rows: E read {t['link_bytes_read']} bytes across the "
            f"link ({t['link_bytes_asked']} asked for), its sort {t['plan_ms']} ms of it; "
            f"launches {launches}")
        out.append(t)
        del calls, table, slots, rows, ref
    del emb, regimes
    log(f"[host_gather] table freed; host cache emptied: {free_pinned()}")
    return out, errs


def check_host_steps(emb, calls_e, calls_f, snap, sample, link):
    """Every E and F call of one captured host-tier step against its plain
    version; F by its written rows and a sample of untouched rows."""
    errs, times = {"E": [], "F": []}, {"E": [], "F": []}
    torch.cuda.synchronize()
    for i, ((table, slots), kw) in enumerate(calls_e):
        err = max_err(H.host_gather_rows(table, slots, **kw),
                      H.host_gather_rows_plain(table, slots))
        require(err == 0.0, f"host_gather step call{i} differs from its plain version: {err}")
        regime = "step gather (misses)" if i == 0 else "step apply (sorted unique slots)"
        errs["E"].append({"case": f"step call{i}", "max_abs_err": err, "tol": 0.0})
        t = time_host_gather(f"step call{i} [{slots.numel()}] of {list(table.shape)}",
                             table, slots, link, kw)
        t["regime"] = regime
        log(f"[check] host_gather step call{i} ({regime}): E {t['ms']} ms, read "
            f"{t['link_bytes_read']} bytes across the link ({t['unique_rows']} distinct rows, "
            f"{t['link_bytes_asked']} bytes asked for), sort {t['plan_ms']} ms")
        times["E"].append(t)
    names = {id(emb.host_table): "table", **{id(t): s for s, t in emb.host_slots.items()}}
    for i, (table, slots, rows) in enumerate(calls_f):
        n, rb = table.shape[0], table.shape[1] * table.element_size()
        valid = (slots >= 0) & (slots < n)
        vids = slots[valid].long().cpu()
        written = table[vids]
        err = max_err(written, rows[valid].cpu())
        require(err == 0.0, f"host_scatter step call{i}: written rows differ: {err}")
        name = names[id(table)]
        keep = ~torch.isin(sample, vids)
        require(torch.equal(table[sample[keep]], snap[name][keep]),
                f"host_scatter step call{i}: an untouched row of {name} changed")
        errs["F"].append({"case": f"step call{i} ({name})", "max_abs_err": err, "tol": 0.0,
                          "untouched_rows_checked": int(keep.sum())})
        vrows = rows[valid]
        staging = H.pinned_empty(tuple(vrows.shape), vrows.dtype)

        def library():  # a D2H copy of the valid rows, then a CPU index_copy_
            staging.copy_(vrows)
            table.index_copy_(0, vids, staging)

        t = timings(f"step call{i} [{slots.numel()}] into [{n}, {table.shape[1]}] ({name})",
                    lambda: H.host_scatter_rows(table, slots, rows),
                    lambda: H.host_scatter_rows_plain(table, slots, rows), library,
                    link_bound_ms(vids.numel() * rb, slots.numel() * 4 + vids.numel() * rb),
                    iters=10, plain_iters=2)
        t.update(valid_rows=vids.numel(), library="D2H copy + CPU index_copy_")
        times["F"].append(link_yardsticks(t, vids.numel() * rb, vids.numel() * rb,
                                          link["d2h_GBps"]))
    return errs, times


def host_tier_phase(cfg, link):
    """The sampled GraphSAGE step with the table, m and v in pinned host
    memory (HostEmbedding, cache_ratio HOST_CACHE_RATIO)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = wt.build_synthetic(cfg, device=dev, seed=0, host_cache_ratio=HOST_CACHE_RATIO)
    torch.cuda.synchronize()
    emb = state.embedding
    host_tensors = [emb.host_table, *emb.host_slots.values()]
    asked, held = pinned_bytes(host_tensors)
    log(f"[host_tier] state built in {time.perf_counter() - t0:.2f} s: {emb.hot_cap} cache "
        f"lines ({emb.cache_rows.nbytes} bytes on the card), pinned {asked} bytes asked; the "
        f"caching host allocator holds {held} pinned bytes")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def batch():
        c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                          dtype=torch.int32)
        return c, state.labels[c.long()]

    # a sample of rows of the table, m and v, to show F leaves untouched rows alone
    sample = torch.randperm(cfg.n_nodes, generator=torch.Generator().manual_seed(6))[:65536]
    snap = {"table": emb.host_table[sample]}
    snap.update({s: t[sample] for s, t in emb.host_slots.items()})
    calls = {k: [] for k in "ABCDEF"}
    with capture(host_mod, "gather_rows", calls["A"]), \
            capture(host_mod, "scatter_rows", calls["B"]), \
            capture(sampling_mod, "sample_hop_uniform", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]), \
            capture_kw(host_mod, "host_gather_rows", calls["E"]), \
            capture(host_mod, "host_scatter_rows", calls["F"]):
        c, y = batch()
        loss0 = float(wt.train_step(state, c, y, seed=0))
    require(np.isfinite(loss0), f"first host-tier step loss {loss0}")
    per_step = {k: len(v) for k, v in calls.items()}
    # E: the gather's misses and the apply's table, m and v reads; F: three
    # write-backs; A: the cache hits; B: the cached lines' rewrite
    require(per_step == {"A": 1, "B": 1, "C": 2, "D": 2, "E": 4, "F": 3},
            f"unexpected host-tier calls per step {per_step}")
    ml = state.graph.multilayer_sample(c, cfg.fanouts, seed=0)
    ids = ml.unique_gids[ml.unique_mask]
    hit = emb.cache_hit_fraction(ids)
    misses = int(((calls["E"][0][0][1] >= 0)).sum())
    log(f"[host_tier] captured step: calls {per_step}, loss {loss0:.5f}, {ids.numel()} unique "
        f"rows, cache hit fraction {hit}, {misses} rows fetched from the host")
    errs, times = check_host_steps(emb, calls["E"], calls["F"], snap, sample, link)
    # A on the cache hits' lines of cache_rows, B on the rewrite of the
    # cached lines (the new rows of the step's hits, -1 for the rest)
    for key, check in (("A", check_gather), ("B", check_scatter)):
        errs[key], times[key] = check(calls[key])
        for e in errs[key] + times[key]:
            e["case"] = "host tier " + e["case"]
    require(coherent(emb), "host tier: a cached row differs from its host row")
    for key, name in (("E", "host_gather"), ("F", "host_scatter"), ("A", "row_gather"),
                      ("B", "row_scatter")):
        log(f"[check] {name} (host tier): " + json.dumps(errs[key]))
    del calls, snap

    _, launches, c = timed_steps("host_tier", state, batch, HOST_STEPS, profile_steps=5)
    path = (G.ROW_GATHER, G.ROW_SCATTER, sampling_mod.SAMPLE_HOP, S.NEIGHBOR_AGG, H.HOST_GATHER,
            H.HOST_SCATTER)
    require(all(launches[k.name] > 0 for k in path), f"a kernel of the host tier never ran: {launches}")
    require(launches["sample_hop_uniform"] == 2 * HOST_STEPS and launches["sample_cols"] == 0,
            f"the host tier's sampler did not run one kernel C launch per hop: {launches}")
    require(bool(torch.isfinite(emb.gather(c)).all()), "non-finite host-tier rows")
    require(coherent(emb), "host tier: the cache lost coherence over the timed steps")
    log(f"[host_tier] pinned {asked} bytes asked ({held} held); cache hit fraction {hit}; "
        f"link h2d {link['h2d_GBps']} GB/s, d2h {link['d2h_GBps']} GB/s")
    del state, emb, host_tensors
    free_pinned()
    return errs, times, launches


# ---------------------------------------------------------------------------
# the full-graph paths: kernels G (CSR SpMM) and H (CSR SDDMM)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def capture_kw(module, name, calls):
    """As :func:`capture`, keeping each call's ``(args, kwargs)``."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def longest_row(row_ptr):
    return int((row_ptr[1:] - row_ptr[:-1]).max()) if row_ptr.numel() > 1 else 0


def g_tol(ref, K, dtype=torch.float32):
    """Kernel G against its plain version: both add up to K values (K the
    CSR's longest row) in other orders, so K f32 ulps of the largest output,
    plus one bf16 ulp when the output is rounded to bf16."""
    scale = max(1.0, ref.float().abs().max().item())
    return K * F32_EPS * scale + (BF16_EPS * scale if dtype == torch.bfloat16 else 0.0)


def h_tol(ref, D):
    """Kernel H against its plain version: a dot of D products in other
    orders, D f32 ulps of the largest value."""
    return D * F32_EPS * max(1.0, ref.abs().max().item())


def sparse_csr(row_ptr, col, vals, n_cols):
    """The CSR as a torch sparse tensor, for the cuSPARSE yardsticks."""
    return torch.sparse_csr_tensor(row_ptr, col, vals, size=(row_ptr.numel() - 1, n_cols),
                                   check_invariants=False)


def spmm_stats(args, kw):
    """Kernel G's own counts for one call: tiles staged, bytes of x staged,
    tiles and edges left to device memory (none where the tree's G does
    not count)."""
    if "_stats" not in inspect.signature(S.csr_spmm).parameters:
        return {}
    st = torch.zeros(4, dtype=torch.int64, device=args[2].device)
    S.csr_spmm(*args, **kw, _stats=st)
    return dict(zip(("tiles_staged", "staged_bytes", "tiles_from_device_memory",
                     "edges_from_device_memory"), st.tolist()))


def spmm_times(case, args, kw, library, iters=20, plain_iters=3):
    """One kernel G call (``csr_spmm(*args, **kw)``) held against its plain
    version, then timed (CUDA events, and device time from a CUDA graph)
    beside its bound, the plain version and the cuSPARSE call ``library``,
    with G's own counts."""
    row_ptr, col, x = args
    plain_kw = {k: v for k, v in kw.items() if k != "route"}
    ref = S.csr_spmm_plain(*args, **plain_kw)
    K = longest_row(row_ptr)
    tol = g_tol(ref, K, x.dtype)
    err = max_err(S.csr_spmm(*args, **kw), ref)
    require(err <= tol, f"csr_spmm {case} err {err} > tol {tol}")
    E, D, es = col.numel(), x.shape[1], x.element_size()
    rows_read = torch.unique(col).numel()
    nbytes = (rows_read * D * es + ref.numel() * es + 4 * E + 4 * row_ptr.numel()
              + (4 * E if kw.get("edge_weight") is not None else 0))
    b_ms, by = bound_ms(nbytes, 2.0 * E * D)
    t = {"case": case, "ms": cuda_ms(lambda: S.csr_spmm(*args, **kw), iters),
         "device_ms": graph_ms(lambda: S.csr_spmm(*args, **kw)),
         "plain_ms": cuda_ms(lambda: S.csr_spmm_plain(*args, **plain_kw), plain_iters,
                             warmup=1),
         "library_ms": cuda_ms(library, iters), "bound_ms": b_ms, "bound_by": by,
         "edges": E, "dim": D, "longest_row": K, "source_rows_read": rows_read,
         "per_edge_row_bytes": E * D * es, **spmm_stats(args, kw)}
    t["Medges_per_s"] = E / t["ms"] / 1e3
    t["bound_share"] = b_ms / t["ms"]
    return {"case": case, "max_abs_err": err, "tol": tol}, t


def check_routes(case, args, kw):
    """Kernel G staged (the default) bit-equal to G with staging off, every
    tile through device memory, and to itself."""
    out = S.csr_spmm(*args, **kw)
    require(bit_equal(out, S.csr_spmm(*args, **kw, _stage=False)),
            f"csr_spmm {case}: the staged route differs from the device route")
    require(bit_equal(out, S.csr_spmm(*args, **kw)), f"csr_spmm {case}: two runs differ")
    return {"case": f"{case}: staged == device route, two runs bit-identical",
            "max_abs_err": 0.0, "tol": 0.0}


def sddmm_times(case, args, library, iters=20, plain_iters=3):
    """One kernel H call held against its plain version, then timed."""
    row_ptr, col, a, b = args
    ref = S.csr_sddmm_plain(*args)
    tol = h_tol(ref, a.shape[1])
    err = max_err(S.csr_sddmm(*args), ref)
    require(err <= tol, f"csr_sddmm {case} err {err} > tol {tol}")
    require(torch.equal(S.csr_sddmm(*args), S.csr_sddmm(*args)),
            f"csr_sddmm {case}: two runs differ")
    E, D, es = col.numel(), a.shape[1], a.element_size()
    a_rows = int(((row_ptr[1:] - row_ptr[:-1]) > 0).sum())
    b_rows = torch.unique(col).numel()
    nbytes = (a_rows + b_rows) * D * es + 4 * E + 4 * row_ptr.numel() + 4 * E
    b_ms, by = bound_ms(nbytes, 2.0 * E * D)
    # H's own counts: the tiles it staged in shared memory and the bytes of
    # b[lo..hi] and a it staged there, the tiles and edges it read from
    # device memory
    stats = torch.zeros(4, dtype=torch.int64, device=a.device)
    S.csr_sddmm(*args, _stats=stats)
    staged, staged_bytes, dev_tiles, dev_edges = stats.tolist()
    t = {"case": case, "ms": cuda_ms(lambda: S.csr_sddmm(*args), iters),
         "plain_ms": cuda_ms(lambda: S.csr_sddmm_plain(*args), plain_iters, warmup=1),
         "library_ms": cuda_ms(library, iters), "bound_ms": b_ms, "bound_by": by,
         "edges": E, "dim": D, "tiles_staged": staged, "staged_bytes": staged_bytes,
         "tiles_from_device_memory": dev_tiles, "edges_from_device_memory": dev_edges,
         "per_edge_row_bytes": E * D * es}
    t["Medges_per_s"] = E / t["ms"] / 1e3
    t["bound_share"] = b_ms / t["ms"]
    return {"case": case, "max_abs_err": err, "tol": tol}, t


def fmt_g_stats(t):
    return (f"G counted {t['tiles_staged']} tiles staging {t['staged_bytes']} bytes of x in "
            f"shared memory ({t['per_edge_row_bytes']} bytes of x rows if read per edge) and "
            f"{t['tiles_from_device_memory']} tiles ({t['edges_from_device_memory']} edges) "
            f"left to device memory")


def fmt_staged(t):
    return (f"H counted {t['tiles_staged']} tiles staging {t['staged_bytes']} bytes in shared "
            f"memory ({t['per_edge_row_bytes']} bytes of b rows if read per edge) and "
            f"{t['tiles_from_device_memory']} tiles ({t['edges_from_device_memory']} edges) "
            f"reading device memory; two runs bit-identical")


def fmt_times(t):
    return (f"{t['ms']} ms ({t['Medges_per_s']} Medges/s, {t['bound_share']} of the "
            f"{t['bound_ms']} ms bound, {t['bound_by']}"
            + (f"; device {t['device_ms']} ms" if "device_ms" in t else "")
            + f"); plain {t['plain_ms']} ms; cuSPARSE {t['library_ms']} ms"
            + (f"; kernels a call {t['kernels_seen']}" if "kernels_seen" in t else ""))


def fg_spmm_phase(g, fg):
    """Kernel G at bench_spmm_clustered's shapes (x [2^20, 256] f32): the
    forward as mean, sum and weighted sum, and the forward plus backward of
    ``sum(spmm_window(..., reduce="mean"))`` with its transposed launch."""
    n, dim = g.node_count, 256
    E = g.edge_count
    rp, col = g.row_ptr, g.col
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    x = torch.randn(n, dim, generator=gen, device="cuda")
    w = torch.rand(E, generator=gen, device="cuda")
    dst = S.csr_edge_dst(rp, E)
    inv_deg = 1.0 / (rp[1:] - rp[:-1]).clamp(min=1).float()
    errs, times = [], []
    for case, reduce, weight, vals in (("mean", "mean", None, inv_deg[dst]),
                                       ("sum", "sum", None, torch.ones(E, device="cuda")),
                                       ("weighted sum", "sum", w, w)):
        lib = sparse_csr(rp, col, vals, n)
        kw = {"reduce": reduce, "edge_weight": weight}
        e, t = spmm_times(f"bench {case} [{n}, {dim}] f32", (rp, col, x), kw,
                          lambda: torch.sparse.mm(lib, x))
        t.update(launch_structure(f"[fg_spmm] G {case}", lambda: S.csr_spmm(rp, col, x, **kw),
                                  G_KERNELS))
        errs += [e, check_routes(f"bench {case}", (rp, col, x), kw)]
        times.append(t)
        require(t["tiles_staged"] == -(-n // S.SPMM_TILE) and t["tiles_from_device_memory"] == 0,
                f"[fg_spmm] G {case}: not every tile of the bench graph was staged: {t}")
        log(f"[fg_spmm] G {case}: " + fmt_times(t) + f"; err {e['max_abs_err']} (tol {e['tol']}); "
            + fmt_g_stats(t) + "; bit-equal to the device route and to itself")
        del lib
    # the bench degrees with uniform columns: no tile's window fits
    ucol = random_cols(rp, n, gen)
    lib = sparse_csr(rp, ucol, inv_deg[dst], n)
    kw = {"reduce": "mean"}
    e, t = spmm_times(f"uniform columns mean [{n}, {dim}] f32", (rp, ucol, x), kw,
                      lambda: torch.sparse.mm(lib, x))
    require(t["tiles_staged"] == 0, f"[fg_spmm] G staged a tile of uniform columns: {t}")
    errs += [e, check_routes("uniform columns mean", (rp, ucol, x), kw)]
    times.append(t)
    log(f"[fg_spmm] G uniform columns mean: " + fmt_times(t) + f"; err {e['max_abs_err']} "
        f"(tol {e['tol']}); " + fmt_g_stats(t))
    del lib, ucol

    # forward + backward of spmm_window's mean with respect to x
    xg = x.clone().requires_grad_()
    plan = {"window": fg.window, "edge_cap": fg.edge_cap}

    def fwd_bwd():
        xg.grad = None
        S.spmm_window(rp, col, xg, reduce="mean", **plan).sum().backward()

    calls = []
    with capture_kw(S, "csr_spmm", calls):
        fwd_bwd()
        torch.cuda.synchronize()
    require(len(calls) == 2 and calls[1][1].get("route") == "transposed",
            f"spmm_window's forward + backward made {len(calls)} G calls: "
            f"{[c[1].get('route', 'forward') for c in calls]}")
    (t_rp, t_col, ctd), kw = calls[1]
    K_t = longest_row(t_rp)
    # the plain backward, independently: dx[col_e] += ct[dst_e] / deg, chunked
    dx_ref = torch.zeros_like(x)
    ct = torch.ones(n, dim, device="cuda") * inv_deg[:, None]
    for i in range(0, E, S.PLAIN_CHUNK):
        j = slice(i, i + S.PLAIN_CHUNK)
        dx_ref.index_add_(0, col[j].long(), ct[dst[j]])
    del ct
    err_dx = max_err(xg.grad, dx_ref)
    tol_dx = g_tol(dx_ref, K_t)
    require(err_dx <= tol_dx, f"spmm_window mean dx err {err_dx} > tol {tol_dx}")
    lib_t = sparse_csr(t_rp, t_col, torch.ones(E, device="cuda"), n)
    e_t, t_t = spmm_times(f"bench backward dx (transposed CSR, longest row {K_t})",
                          (t_rp, t_col, ctd), kw, lambda: torch.sparse.mm(lib_t, ctd))
    t_t.update(launch_structure("[fg_spmm] G transposed",
                                lambda: S.csr_spmm(t_rp, t_col, ctd, **kw), G_KERNELS))
    e_dx = {"case": "bench backward dx vs index_add_ scatter", "max_abs_err": err_dx,
            "tol": tol_dx}
    e_r = check_routes("bench backward dx", (t_rp, t_col, ctd), kw)
    log(f"[fg_spmm] G transposed (backward dx): " + fmt_times(t_t)
        + f"; err {e_t['max_abs_err']} (tol {e_t['tol']}); whole dx against an index_add_ "
        f"scatter: err {err_dx} (tol {tol_dx}); " + fmt_g_stats(t_t)
        + "; bit-equal to the device route and to itself")
    fb_ms = cuda_ms(fwd_bwd, 5, warmup=1)
    tr_ms = cuda_ms(lambda: S.transpose_csr(rp, col, n), 5, warmup=1)
    fb = {"fwd_bwd_ms": fb_ms, "fwd_bwd_Medges_per_s": E / fb_ms / 1e3,
          "transpose_csr_ms": tr_ms}
    log(f"[fg_spmm] spmm_window mean forward + backward: {fb_ms} ms "
        f"({fb['fwd_bwd_Medges_per_s']} Medges/s; the transposed CSR is built in each call, "
        f"{tr_ms} ms of it)")
    del xg, lib_t, calls, dx_ref, x, w, dst
    torch.cuda.empty_cache()
    return (errs, times), ([e_t, e_dx, e_r], [t_t]), fb


def random_cols(row_ptr, n_src, gen):
    """Uniform columns in [0, n_src) for the CSR's rows, sorted within each
    row: a graph with the bench graph's degrees and no locality."""
    E = int(row_ptr[-1])
    col = torch.randint(0, n_src, (E,), generator=gen, device=row_ptr.device)
    key = S.csr_edge_dst(row_ptr, E).long() * n_src + col
    return (key.sort().values % n_src).to(torch.int32)


def fg_sddmm_phase(g):
    """Kernel H at bench_sddmm_clustered's shapes (a, b [2^20, 256] f32), on
    the bench graph and on its degrees with uniform columns."""
    n, dim = g.node_count, 256
    rp, col = g.row_ptr, g.col
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    a = torch.randn(n, dim, generator=gen, device="cuda")
    b = torch.randn(n, dim, generator=gen, device="cuda")
    errs, times = [], []
    for name, cols in (("bench", col), ("random", random_cols(rp, n, gen))):
        pattern = sparse_csr(rp, cols, torch.ones(g.edge_count, device="cuda"), n)
        e, t = sddmm_times(f"{name} [{n}, {dim}] f32", (rp, cols, a, b),
                           lambda: torch.sparse.sampled_addmm(pattern, a, b.t(), beta=0.0))
        t.update(launch_structure(f"[fg_sddmm] H {name}", lambda: S.csr_sddmm(rp, cols, a, b),
                                  H_KERNELS))
        lib_err = max_err(torch.sparse.sampled_addmm(pattern, a, b.t(), beta=0.0).values(),
                          S.csr_sddmm(rp, cols, a, b))
        t["library_max_abs_err"] = lib_err
        log(f"[fg_sddmm] H {name}: " + fmt_times(t) + f"; err {e['max_abs_err']} (tol "
            f"{e['tol']}); cuSPARSE sampled_addmm differs from H by {lib_err}; " + fmt_staged(t))
        errs.append(e)
        times.append(t)
        del pattern, cols
    del a, b
    torch.cuda.empty_cache()
    return errs, times


PAIRED_STEPS = 30       # timed device-memory steps of a paired run
PAIRED_HOST_STEPS = 10  # timed host-tier steps of a paired run
PAIRED_PARTS = ("steps", "store", "sweep", "spmm", "sddmm")
OWN_PARTS = ("weighted",)  # this tree's entry points only, never run by default


def paired_times(parts=PAIRED_PARTS):
    """Kernels through entry points that every tree of the port with the row
    store has, so that this function also times another tree (run from its
    root as the module docstring says). One JSON line, by part:

    * ``steps``: PAIRED_STEPS device-memory steps and PAIRED_HOST_STEPS
      host-tier steps (:func:`timed_steps`), and the two hops of a step
      through ``csr_sample_neighbors`` (ms, device ms, kernels a hop);
    * ``store``: kernel I at ``bench_gather_sorted``'s ids as the store
      calls it, f32 and bf16, and kernel J at ``bench_gather``'s uniform
      ids (:func:`gather_times`: beside A and ``index_select``, in turns),
      each also as device time from a CUDA graph, and J and
      ``index_select`` by :func:`cuda_ms` with and without ``lead``;
    * ``sweep``: kernel I over density (:func:`sorted_sweep`);
    * ``spmm``: kernel G at the bench graph's mean and transposed (the
      backward's dx) calls, on its degrees with uniform columns, and one GAT
      head call (``bench_gat_layer``'s graph, a [2^18, 64] view with row
      stride 256, attention weights), by :func:`spmm_times`;
    * ``sddmm``: kernel H through ``csr_sddmm`` on the bench graph and on
      uniform columns, at D = 256 and at GAT's head width (views of a
      [2^20, 4, 64] tensor), 20 calls each;
    * ``weighted`` (named only; trees before weighted sampling lack it):
      PAIRED_STEPS uniform and weighted device-memory steps in turns
      (uniform, weighted, weighted, uniform) on the same graph, table and
      model, so that the two samplers are compared in one call; beside each,
      the host's time to enqueue one ``multilayer_sample`` (20 calls, no
      synchronisation inside) and its time by CUDA events."""
    secs = kernels.build_all()
    dev = torch.device("cuda")
    out = {"build_s": max(secs.values()), "device": torch.cuda.get_device_name(0),
           "parts": list(parts)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cfg = wt.SageTrainConfig()

    def batcher(state):
        def batch():
            c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                              dtype=torch.int32)
            return c, state.labels[c.long()]
        return batch

    if "weighted" in parts:
        states = {m: wt.build_synthetic(dataclasses.replace(cfg, sample_method=m), device=dev,
                                        seed=0) for m in ("unweighted", "weighted")}
        out["weighted_turns"] = []
        for m in ("unweighted", "weighted", "weighted", "unweighted"):
            summary, launches, _ = timed_steps(f"paired {m}", states[m], batcher(states[m]),
                                               PAIRED_STEPS, 5)
            require(launches["sample_hop_weighted" if m == "weighted" else "sample_hop_uniform"]
                    == 2 * PAIRED_STEPS, f"[paired] {m} steps: launches {launches}")
            st = states[m]
            c = batcher(st)()[0]

            def sample():
                return st.graph.multilayer_sample(c, cfg.fanouts, seed=0,
                                                  weighted=m == "weighted")

            sample()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                sample()
            host_ms = (time.perf_counter() - t0) * 1e3 / 20  # enqueue only: no sync inside
            out["weighted_turns"].append({"method": m, **{k: summary[k] for k in (
                "step_median_ms", "step_p90_ms", "sample_median_ms", "busy_ms")},
                "sample_host_enqueue_ms": host_ms, "sample_cuda_ms": cuda_ms(sample)})
        del states
        torch.cuda.empty_cache()
    if "steps" in parts:
        state = wt.build_synthetic(cfg, device=dev, seed=0)
        out["hbm"], _, c = timed_steps("paired hbm", state, batcher(state), PAIRED_STEPS, 5)
        g = state.graph
        ml = g.multilayer_sample(c, cfg.fanouts, seed=0)
        hop_centres = (c, torch.where(ml.level_masks[1], ml.level_gids[1], 0))
        for hop, (cent, K) in enumerate(zip(hop_centres, cfg.fanouts)):
            def call():
                return wt.ops.csr_sample_neighbors(g.row_ptr, g.col, cent, K, seed=0, hop=hop)

            out[f"hop{hop}"] = {"ms": cuda_ms(call), "device_ms": graph_ms(call),
                                "kernels_seen": profiled(call, 5)[0], "shape": [cent.numel(), K]}
        del state, g, ml, c
        torch.cuda.empty_cache()
        hstate = wt.build_synthetic(cfg, device=dev, seed=0, host_cache_ratio=HOST_CACHE_RATIO)
        out["host"], _, _ = timed_steps("paired host", hstate, batcher(hstate), PAIRED_HOST_STEPS,
                                        5)
        del hstate
        free_pinned()

    n, batch_n = STORE_ROWS, STORE_BATCH
    if "store" in parts or "sweep" in parts:
        data = torch.randn(n, 256, generator=gen, device=dev)
    if "store" in parts:
        ids_s = sorted_ids(gen, n, batch_n, 0.8)
        for tag, t in (("f32", data), ("bf16", data.to(torch.bfloat16))):
            kern = lambda: G.gather_rows_sorted(t, ids_s, zero_invalid=True)  # noqa: E731
            out[f"I_bench_{tag}"] = {**gather_times(
                tag, kern, lambda: G.gather_rows_masked_plain(t, ids_s), t, ids_s),
                "device_ms": graph_ms(kern),
                "row_gather_device_ms": graph_ms(lambda: G.gather_rows(t, ids_s)),
                **sorted_stats(t, ids_s, zero_invalid=True)}
        ids_u = torch.randint(0, n, (batch_n,), generator=gen, device=dev, dtype=torch.int32)
        idx_u = ids_u.long()
        kern = lambda: G.gather_rows_masked(data, ids_u)  # noqa: E731
        require(bit_equal(kern(), G.gather_rows_masked_plain(data, ids_u)),
                "[paired] J differs from its plain version")
        out["J_bench"] = {**gather_times("uniform f32", kern,
                                         lambda: G.gather_rows_masked_plain(data, ids_u),
                                         data, ids_u),
                          "device_ms": graph_ms(kern),
                          "row_gather_device_ms": graph_ms(lambda: G.gather_rows(data, ids_u)),
                          "library_device_ms": graph_ms(
                              lambda: torch.index_select(data, 0, idx_u))}
        # J and index_select by both definitions of cuda_ms, in turns, medians
        fns = {"J": kern, "index_select": lambda: torch.index_select(data, 0, idx_u)}
        rounds = {f"{k}_ms_{tag}": [] for k in fns for tag in ("lead", "no_lead")}
        for _ in range(3):
            for k, fn in fns.items():
                for tag in ("lead", "no_lead"):
                    rounds[f"{k}_ms_{tag}"].append(cuda_ms(fn, lead=tag == "lead"))
        out["J_bench"]["cuda_ms_definitions"] = {k: statistics.median(v)
                                                 for k, v in rounds.items()}
    if "sweep" in parts:
        out["I_sweep"] = sorted_sweep({"D=256 f32": data, "D=16 f32": torch.randn(
            n, 16, generator=gen, device=dev)}, gen, n, batch_n)
    if "store" in parts or "sweep" in parts:
        del data
        torch.cuda.empty_cache()

    if "spmm" in parts or "sddmm" in parts:
        g = wt.clustered_csr(1 << 20, 16, 192)
        rp, N, E = g.row_ptr, g.node_count, g.edge_count
        ucol = random_cols(rp, N, gen)
    if "spmm" in parts:
        x = torch.randn(N, 256, generator=gen, device=dev)
        w = torch.rand(E, generator=gen, device=dev)
        t_rp, t_col, perm = S.transpose_csr(rp, g.col, N)
        inv_deg = 1.0 / (rp[1:] - rp[:-1]).clamp(min=1).float()
        mean_vals = inv_deg[S.csr_edge_dst(rp, E)]
        gg = wt.clustered_csr(1 << 18, 16, 192)
        featv = torch.randn(gg.node_count, 4, 64, generator=gen, device=dev)
        alpha = torch.rand(gg.edge_count, generator=gen, device=dev)
        cases = {"mean": ((rp, g.col, x), {"reduce": "mean"}, mean_vals),
                 "transposed": ((t_rp, t_col, x), {"edge_weight": w[perm]}, w[perm]),
                 "uniform_mean": ((rp, ucol, x), {"reduce": "mean"}, mean_vals),
                 "gat_head": ((gg.row_ptr, gg.col, featv[:, 1, :]), {"edge_weight": alpha},
                              alpha)}
        for name, (args, kw, vals) in cases.items():
            lib = sparse_csr(args[0], args[1], vals.contiguous(), args[2].shape[0])
            xs = args[2]
            _, out[f"G_{name}"] = spmm_times(name, args, kw, lambda: torch.sparse.mm(lib, xs))
            del lib
        del x, w, t_rp, t_col, perm, gg, featv, alpha
        torch.cuda.empty_cache()
    if "sddmm" in parts:
        a = torch.randn(N, 256, generator=gen, device=dev)
        b = torch.randn(N, 256, generator=gen, device=dev)
        ha, hb = a.view(N, 4, 64)[:, 1, :], b.view(N, 4, 64)[:, 2, :]
        for name, cols in (("clustered", g.col), ("random", ucol)):
            for dim, p, q in ((256, a, b), (64, ha, hb)):
                S.csr_sddmm(rp, cols, p, q)
                out[f"H_{name}_D{dim}_ms"] = cuda_ms(lambda: S.csr_sddmm(rp, cols, p, q))
    log("[paired] " + json.dumps(out))


def init_gat(layer, gen):
    """bench_gat_layer's layer with random weights: ``proj`` ~ normal with
    std 1/sqrt(fan_in), ``attn_*`` uniform within ±sqrt(6 / (H + D))."""
    with torch.no_grad():
        w = layer.proj.weight
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device) / math.sqrt(w.shape[1]))
        for p in (layer.attn_src, layer.attn_dst):
            lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((2 * torch.rand(p.shape, generator=gen, device=p.device) - 1) * lim)


def fg_gat_phase():
    """The GAT layer at bench_gat_layer's shapes: clustered_csr(2^18, 16,
    192), 4 heads of 64 over input width 256, self loop. One captured
    forward + backward (counts from 0) whose every G and H call is held
    against its plain version, then the forward and the forward + backward
    timed."""
    n, heads, dh, din = 1 << 18, 4, 64, 256
    t0 = time.perf_counter()
    g = wt.clustered_csr(n, 16, 192)
    fg = g.to_full_graph(windowed=True)
    torch.cuda.synchronize()
    require(g.edge_count == 5_111_434, f"GAT bench graph has {g.edge_count} edges")
    layer = GATConv(din, dh, num_heads=heads, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    init_gat(layer, gen)
    feats = torch.randn(n, din, generator=gen, device="cuda")
    log(f"[fg_gat] clustered_csr(2^18, 16, 192): {g.edge_count} edges, plan window {fg.window}; "
        f"layer {heads} x {dh} over {din}, built in {time.perf_counter() - t0:.2f} s")

    def fwd_bwd():
        layer.zero_grad(set_to_none=True)
        x = feats.detach().requires_grad_()
        loss = layer(x, fg).sum()
        loss.backward()
        return loss.detach(), x.grad

    g_calls, h_calls = [], []
    torch.cuda.synchronize()
    reset_launches()
    with capture_kw(S, "csr_spmm", g_calls), capture_kw(S, "csr_sddmm", h_calls):
        loss, dx = fwd_bwd()
        torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(S.CSR_SPMM.routes)
    require(launches["csr_spmm"] > 0 and launches["csr_sddmm"] > 0
            and routes.get("transposed", 0) > 0 and routes.get("forward", 0) > 0,
            f"the GAT layer did not launch G (both routes) and H: {launches} {routes}")
    require(len(g_calls) == 2 * heads and len(h_calls) == heads,
            f"GAT calls: {len(g_calls)} G, {len(h_calls)} H")
    require(bool(torch.isfinite(loss)) and bool(torch.isfinite(dx).all()), "non-finite GAT grads")
    attn = layer.attn_src.grad.abs().max().item()
    require(attn > 0, "attn_src's gradient is zero")
    errs = {"forward": [], "transposed": [], "sddmm": []}
    times = {"forward": [], "transposed": [], "sddmm": []}
    for i, (args, kw) in enumerate(g_calls):
        route = kw.get("route", "forward")
        first = not times[route]
        rp_, col_, x_ = args
        w_ = kw["edge_weight"]
        if first:  # time the first call of each route, check every call
            lib = sparse_csr(rp_, col_, w_.contiguous(), x_.shape[0])
            e, t = spmm_times(f"GAT G {route} call {i} [{x_.shape[0]}, {x_.shape[1]}] "
                              f"stride {x_.stride(0)}", args, kw,
                              lambda: torch.sparse.mm(lib, x_), iters=10)
            times[route].append(t)
            del lib
        else:
            ref = S.csr_spmm_plain(*args, reduce=kw["reduce"], edge_weight=w_)
            tol = g_tol(ref, longest_row(rp_))
            e = {"case": f"GAT G {route} call {i}",
                 "max_abs_err": max_err(S.csr_spmm(*args, **kw), ref), "tol": tol}
            require(e["max_abs_err"] <= tol, f"GAT G call {i}: {e}")
        errs[route].append(e)
    for i, args in enumerate(a for a, _ in h_calls):
        if i == 0:
            pat = sparse_csr(args[0], args[1], torch.ones(args[1].numel(), device="cuda"),
                             args[3].shape[0])
            e, t = sddmm_times(f"GAT H (attention dw) call {i} [{args[2].shape[0]}, "
                               f"{args[2].shape[1]}]", args,
                               lambda: torch.sparse.sampled_addmm(pat, args[2], args[3].t(),
                                                                  beta=0.0), iters=10)
            times["sddmm"].append(t)
            del pat
        else:
            ref = S.csr_sddmm_plain(*args)
            e = {"case": f"GAT H call {i}", "max_abs_err": max_err(S.csr_sddmm(*args), ref),
                 "tol": h_tol(ref, args[2].shape[1])}
            require(e["max_abs_err"] <= e["tol"], f"GAT H call {i}: {e}")
        errs["sddmm"].append(e)
    del g_calls, h_calls
    for route in errs:
        log(f"[fg_gat] {route}: " + json.dumps(errs[route]))
        for t in times[route]:
            log(f"[fg_gat]   {t['case']}: " + fmt_times(t)
                + "; " + (fmt_staged(t) if route == "sddmm" else fmt_g_stats(t)))

    def fwd():
        with torch.no_grad():
            layer(feats, fg)

    torch.cuda.reset_peak_memory_stats()
    f_ms = cuda_ms(fwd, 10, warmup=2)
    fb_ms = cuda_ms(fwd_bwd, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    E = g.edge_count
    log(f"[fg_gat] forward {f_ms} ms ({E / f_ms / 1e3} Medges/s), forward + backward over "
        f"params and features {fb_ms} ms ({E / fb_ms / 1e3} Medges/s); loss {float(loss)}, "
        f"max |d attn_src| {attn}; peak memory {peak} bytes; launches of one forward + "
        f"backward {launches}, G routes {routes}")
    profile_steps("fg_gat profile", lambda i: fwd_bwd(), fb_ms, 3)
    summary = {"fwd_ms": f_ms, "fwd_bwd_ms": fb_ms, "edges": E, "peak_bytes": peak,
               "launches": launches, "routes": routes}
    del layer, feats, fg, g
    torch.cuda.empty_cache()
    return errs, times, summary


def fg_parity():
    """Tiny SAGE, GCN and GAT full-graph models on the card and on the CPU
    from the same numpy-made graph, features and weights: logits within
    1e-5 and every gradient within 1e-4 of the largest CPU value (f32 sums
    in other orders)."""
    cfg = wt.FullGraphConfig(n_nodes=700, deg=6, width=40, dim=64, hidden=64, num_classes=4)
    errs = {}
    for mt in ("sage", "gcn", "gat"):
        c = dataclasses.replace(cfg, model_type=mt)
        cpu = wt.build_full_graph(c, device="cpu", seed=1)
        model = HomoGNN(c.dim, c.hidden, c.num_classes, model_type=mt, device="cuda")
        model.load_state_dict(cpu.model.state_dict())
        gfg = GraphStructure(cpu.graph.row_ptr.cuda(), cpu.graph.col.cuda(),
                             c.n_nodes).to_full_graph(windowed=True)
        x = cpu.embedding.table
        centers = torch.arange(0, c.n_nodes, 7, dtype=torch.int32)
        y = cpu.labels[centers.long()]
        with torch.no_grad():
            la, lb = model(x.cuda(), graph=gfg).cpu(), cpu.model(x, graph=cpu.fg)
        fa = wt.full_graph_value_and_grad(model, x.cuda(), gfg, centers.cuda(), y.cuda())
        fb = wt.full_graph_value_and_grad(cpu.model, x, cpu.fg, centers, y)
        errs[mt] = {"logits": max_err(la, lb), "loss": abs(float(fa[0]) - float(fb[0])),
                    "dx": max_err(fa[1][1].cpu(), fb[1][1])}
        require(errs[mt]["logits"] <= 1e-5 * max(1.0, lb.abs().max().item()),
                f"[fg_parity] {mt} logits {errs[mt]}")
        require(errs[mt]["loss"] <= 1e-5 * max(1.0, abs(float(fb[0]))), f"{mt} loss {errs[mt]}")
        for name, gb in [("dx", fb[1][1])] + list(fb[1][0].items()):
            ga = fa[1][1] if name == "dx" else fa[1][0][name]
            err = max_err(ga.cpu(), gb)
            errs[mt][name] = err
            require(err <= 1e-4 * max(1.0, gb.abs().max().item()),
                    f"[fg_parity] {mt} gradient {name} differs: {err}")
    log(f"[fg_parity] tiny full-graph models (700 nodes, width 64), card vs CPU: "
        + json.dumps(errs))


def check_model_calls(mt, a_calls, g_calls):
    """The A call of an evaluation (bit-equal) and every G call of it and
    of one forward + backward, against their plain versions."""
    a_err = max_err(G.gather_rows(*a_calls[0]), G.gather_rows_plain(*a_calls[0]))
    require(a_err == 0.0, f"[fg_model] {mt}: row_gather differs from its plain version")
    checks = []
    for i, (args, kw) in enumerate(g_calls):
        ref = S.csr_spmm_plain(*args, reduce=kw["reduce"], edge_weight=kw.get("edge_weight"))
        err, tol = max_err(S.csr_spmm(*args, **kw), ref), g_tol(ref, longest_row(args[0]))
        require(err <= tol, f"[fg_model] {mt} G call {i}: err {err} > tol {tol}")
        checks.append({"case": f"{mt} G {kw.get('route', 'forward')} call {i} "
                               f"{list(args[2].shape)}", "max_abs_err": err, "tol": tol})
    return checks


def fg_model_phase():
    """``FullGraphConfig()``: the bench graph, a device-memory Embedding of
    [2^20, 256] f32 features, a 2-layer SAGE (mean) and a 2-layer GCN. For
    each: counts from 0, ``eval_full_graph`` on FG_CENTERS centres, then
    FG_STEPS timed ``full_graph_value_and_grad`` runs, counts read."""
    cfg = wt.FullGraphConfig()
    t0 = time.perf_counter()
    st = wt.build_full_graph(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[fg_model] {cfg} built in {time.perf_counter() - t0:.2f} s: "
        f"{st.graph.edge_count} edges, plan window {st.fg.window}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    centers = torch.randperm(cfg.n_nodes, generator=gen, device="cuda")[:FG_CENTERS].to(torch.int32)
    labels = st.labels[centers.long()]
    gcn = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, num_layers=cfg.num_layers,
                  model_type="gcn", device="cuda")
    gcn.reset_parameters(gen)
    x = st.embedding.table
    out = {}
    for mt, model in (("sage", st.model), ("gcn", gcn)):
        # warm-up (it builds the graph's transposed CSR once), capturing
        # every A and G call, each then held against its plain version
        a_calls, g_calls = [], []
        with capture(emb_mod, "gather_rows", a_calls), capture_kw(S, "csr_spmm", g_calls):
            wt.eval_full_graph(model, st.embedding, st.fg, centers, labels)
            wt.full_graph_value_and_grad(model, x, st.fg, centers, labels)
            torch.cuda.synchronize()
        require(len(a_calls) == 1 and len(g_calls) == 3 * cfg.num_layers,
                f"[fg_model] {mt}: {len(a_calls)} A and {len(g_calls)} G calls")
        checks = check_model_calls(mt, a_calls, g_calls)
        log(f"[fg_model] {mt}: A over all {cfg.n_nodes} ids bit-equal to its plain version; "
            f"G calls of one evaluation and one forward + backward: " + json.dumps(checks))
        del a_calls, g_calls
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        e_loss, e_acc = wt.eval_full_graph(model, st.embedding, st.fg, centers, labels)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t1) * 1e3
        step_ms, host_ms, losses = [], [], []
        for _ in range(FG_STEPS):
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            ev0.record()
            loss, (grads, dx) = wt.full_graph_value_and_grad(model, x, st.fg, centers, labels)
            ev1.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t1) * 1e3)
            step_ms.append(ev0.elapsed_time(ev1))
            losses.append(float(loss))
        launches = read_launches()
        routes = dict(S.CSR_SPMM.routes)
        peak = torch.cuda.max_memory_allocated()
        require(np.isfinite(float(e_loss)) and all(np.isfinite(losses)),
                f"[fg_model] {mt}: non-finite loss {float(e_loss)} {losses}")
        require(bool(torch.isfinite(dx).all()) and all(bool(torch.isfinite(v).all())
                                                       for v in grads.values()),
                f"[fg_model] {mt}: non-finite gradients")
        require(launches["row_gather"] > 0 and launches["csr_spmm"] > 0
                and routes.get("forward", 0) > 0 and routes.get("transposed", 0) > 0,
                f"[fg_model] {mt} did not launch A and G (both routes): {launches} {routes}")
        med = statistics.median(step_ms)
        log(f"[fg_model] {mt}: eval_full_graph on {FG_CENTERS} centres: loss {float(e_loss)}, "
            f"accuracy {float(e_acc)}, {eval_ms} ms (host clock)")
        log(f"[fg_model] {mt}: full_graph_value_and_grad ms (CUDA events) median {med}, "
            f"p90 {quantile(step_ms, 0.9)}, min {min(step_ms)}, max {max(step_ms)}; host clock "
            f"median {statistics.median(host_ms)}; losses {losses[:3]}; peak memory {peak} "
            f"bytes ({peak / 2**30:.2f} GiB); launches {launches}, G routes {routes}")
        profile_steps(f"fg_model {mt} profile",
                      lambda i: wt.full_graph_value_and_grad(model, x, st.fg, centers, labels),
                      med, 3)
        out[mt] = {"launches": launches, "routes": routes, "step_ms_median": med,
                   "step_ms_p90": quantile(step_ms, 0.9), "eval_ms": eval_ms, "peak_bytes": peak,
                   "checks": checks}
    del st, gcn, x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the sharded row store: kernels I (sorted-window gather) and J (masked
# gather), and kernel B's masked route
# ---------------------------------------------------------------------------


def bits(t):
    """The tensor's bits, so NaN payloads and -0 compare exactly."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def bit_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def sorted_ids(gen, n, batch, density):
    """``bench_gather_sorted``'s ids (``bench.py:178-185``): ``batch``
    sorted unique ids drawn from a span of ``batch / density`` rows at a
    random base."""
    span = int(batch / density)
    base = int(torch.randint(0, n - span, (1,), generator=gen, device="cuda"))
    pick = torch.randperm(span, generator=gen, device="cuda")[:batch]
    return torch.sort(base + pick).values.to(torch.int32)


def cold_ms(fn, arg_sets, iters=20):
    """As :func:`cuda_ms`, each call on the next of ``arg_sets`` in turn, so
    that no call finds the rows of the one before it in the 50 MB L2."""
    it = itertools.cycle(arg_sets)
    return cuda_ms(lambda: fn(*next(it)), iters)


def sorted_stats(data, slots, **kw):
    """Kernel I's own counts for one call: tiles windowed, tiles read
    directly, bytes asked of device memory (none where the tree's kernel I
    does not count)."""
    if "_stats" not in inspect.signature(G.gather_rows_sorted).parameters:
        return {}
    st = torch.zeros(3, dtype=torch.int64, device=slots.device)
    G.gather_rows_sorted(data, slots, **kw, _stats=st)
    w, d, nbytes = st.tolist()
    return {"windowed_tiles": w, "direct_tiles": d, "bytes_read": nbytes,
            "window_share": w / max(w + d, 1)}


def gather_times(case, kernel, plain, data, slots, iters=20):
    """One store gather call timed beside its bound (each distinct valid row
    read once, each output row written once, the ids read once), its plain
    version, kernel A on the same slots and ``index_select``. The kernel, A
    and ``index_select`` are timed in turns, three rounds, and each keeps its
    median: on an H100 the first timing after the phase's set-up has read
    up to 17 % slower than the same call timed next."""
    rb = data.shape[1] * data.element_size()
    valid = slots[(slots >= 0) & (slots < data.shape[0])]
    nbytes = torch.unique(valid).numel() * rb + slots.numel() * (rb + slots.element_size())
    clipped = slots.long().clamp(0, data.shape[0] - 1)
    fns = {"ms": kernel, "row_gather_ms": lambda: G.gather_rows(data, slots),
           "library_ms": lambda: torch.index_select(data, 0, clipped)}
    rounds = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            rounds[k].append(cuda_ms(fn, iters))
    b_ms, by = bound_ms(nbytes)
    t = {"case": case, **{k: statistics.median(v) for k, v in rounds.items()},
         "plain_ms": cuda_ms(plain, 5), "bound_ms": b_ms, "bound_by": by, "rounds": rounds}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["GBps_delivered"] = slots.numel() * rb / t["ms"] / 1e6
    return t


def sorted_sweep(tables, gen, n, batch):
    """Kernel I against A and ``index_select`` over id density on each of
    ``tables`` ([n, D] by name), as the store calls I (``local_take_sorted``
    with the density), held bit-equal to its plain version: ms by CUDA
    events, warm (the same ids each call) and cold (four id sets in turn;
    D = 16's spans fit the 50 MB L2), the device ms of each from a CUDA
    graph (:func:`graph_ms`; at D = 16 the host's share of a call is
    larger than the kernel's), and I's own counts."""
    sweep = []
    for name, data in tables.items():
        rb = data.shape[1] * data.element_size()
        for d in (1.0, 0.8, 0.5, 0.2):
            sets = [sorted_ids(gen, n, batch, d) for _ in range(4)]
            sl = sets[0]
            idx = sl.long()
            require(bit_equal(gather_mod.local_take_sorted(data, sl, density=d),
                              G.gather_rows_plain(data, sl)),
                    f"[store] local_take_sorted {name} d={d} differs from its plain version")
            fns = {"I": lambda: G.gather_rows_sorted(data, sl, density=d),
                   "A": lambda: G.gather_rows(data, sl),
                   "index_select": lambda: torch.index_select(data, 0, idx)}
            r = {"table": name, "density": d, **{f"{k}_ms": cuda_ms(f) for k, f in fns.items()},
                 **{f"{k}_device_ms": graph_ms(f) for k, f in fns.items()},
                 "I_cold_ms": cold_ms(lambda s: G.gather_rows_sorted(data, s, density=d),
                                      [(s,) for s in sets]),
                 "A_cold_ms": cold_ms(lambda s: G.gather_rows(data, s), [(s,) for s in sets]),
                 "bound_ms": bound_ms(batch * (2 * rb + 4))[0],
                 **dict(zip(("tile", "window"), G.sorted_plan(rb, density=d))),
                 **sorted_stats(data, sl, density=d)}
            r.update(I_over_A=r["I_ms"] / r["A_ms"], I_over_A_cold=r["I_cold_ms"] / r["A_cold_ms"],
                     I_over_A_device=r["I_device_ms"] / r["A_device_ms"])
            sweep.append(r)
            log(f"[store] sweep {name} d={d}: I {r['I_ms']} ms, A {r['A_ms']} ms (I/A "
                f"{r['I_over_A']}), index_select {r['index_select_ms']} ms; cold I "
                f"{r['I_cold_ms']} ms, A {r['A_cold_ms']} ms (I/A {r['I_over_A_cold']}); device "
                f"I {r['I_device_ms']} ms, A {r['A_device_ms']} ms (I/A {r['I_over_A_device']}), "
                f"index_select {r['index_select_device_ms']} ms; bound {r['bound_ms']} ms; tile "
                f"{r['tile']} window {r['window']} (the launch caps it at the longest span its "
                f"rule accepts); I's counts: {r.get('windowed_tiles')} tiles windowed, "
                f"{r.get('direct_tiles')} direct, {r.get('bytes_read')} bytes read")
    return sweep


def store_parity():
    """A tiny ShardedTable on the card and on the CPU from the same numpy
    data: gather on both routes, the gather's gradient, scatter as a set
    and as an add; unique ids, so every sum has one term and all are equal."""
    rs = np.random.RandomState(31)
    arr = rs.randn(500, 40).astype(np.float32)
    ids = np.sort(np.concatenate([rs.permutation(500)[:300], [-3, -1, 500, 777]])).astype(np.int32)
    rows = rs.randn(ids.size, 40).astype(np.float32)
    res = {}
    for d in ("cuda", "cpu"):
        t = wt.ShardedTable.from_array(arr, device=d)
        i, r = torch.from_numpy(ids).to(d), torch.from_numpy(rows).to(d)
        out = {lk: t.gather(i, local_kernel=lk).cpu() for lk in ("ring", "sorted")}
        data = t.data.clone().requires_grad_()
        gather_mod.gather(data, i, plan=t.plan, local_kernel="sorted").backward(r)
        out["grad"] = data.grad.cpu()
        out["set"] = torch.from_numpy(t.scatter(i, r).to_array())
        out["add"] = torch.from_numpy(t.scatter(i, r, accumulate=True).to_array())
        res[d] = out
    for k in res["cpu"]:
        require(torch.equal(res["cuda"][k], res["cpu"][k]), f"[store] parity: {k} differs")
    log(f"[store] parity: a [500, 40] table, {ids.size} ids (4 out of range), card == CPU for "
        f"{sorted(res['cpu'])}")


def store_phase():
    """The sharded row store at the JAX benches' shapes: a 4,000,000 x 256
    f32 ShardedTable (and a bf16 one) of random rows; the counts from 0, then
    ``gather(local_kernel="sorted")`` at ``bench_gather_sorted``'s ids
    (kernel I, f32 and bf16), ``gather`` at ``bench_gather``'s (kernel J)
    and ``scatter(donate=True)`` at ``bench_scatter``'s (kernel B, masked
    route), counts read; then every call checked and timed, I swept over
    density and a narrow table, I's exactness on unsorted, duplicated and
    out-of-range ids, the add, and the tiny card-vs-CPU parity."""
    n, dim, batch = STORE_ROWS, 256, STORE_BATCH
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)

    def randn(g, shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    table = wt.ShardedTable.create(n, dim, init=randn, generator=gen)
    table16 = wt.ShardedTable.create(n, dim, "bfloat16", init=randn, generator=gen)
    ids_s = sorted_ids(gen, n, batch, 0.8)
    ids_u = torch.randint(0, n, (batch,), generator=gen, device="cuda", dtype=torch.int32)
    rows_w = torch.randn(batch, dim, generator=gen, device="cuda")
    sample = torch.randperm(n, generator=gen, device="cuda")[:65536]
    sample = sample[~torch.isin(sample, ids_u.long())]
    snap = table.data[sample].clone()
    before = table.data.clone()  # for the add's check and the scatter's timing
    torch.cuda.synchronize()
    log(f"[store] [{n}, {dim}] f32 and bf16 tables ({table.data.nbytes} + {table16.data.nbytes} "
        f"bytes) in {time.perf_counter() - t0:.2f} s")

    # the main path, counts from 0
    calls = {"I": [], "J": [], "B": []}
    torch.cuda.synchronize()
    reset_launches()
    with capture_kw(gather_mod, "gather_rows_sorted", calls["I"]), \
            capture_kw(gather_mod, "gather_rows_masked", calls["J"]), \
            capture_kw(gather_mod, "scatter_rows_masked", calls["B"]):
        out_s = table.gather(ids_s, local_kernel="sorted")
        out_s16 = table16.gather(ids_s, local_kernel="sorted")
        out_r = table.gather(ids_u)
        table = table.scatter(ids_u, rows_w, donate=True)
        torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(G.ROW_SCATTER.routes)
    require(launches["sorted_gather"] == 2 and launches["row_gather_masked"] == 1
            and routes.get("masked", 0) == 1,
            f"[store] the store did not launch I, J and B (masked): {launches} {routes}")
    require([len(calls[k]) for k in "IJB"] == [2, 1, 1], f"[store] calls {calls}")

    errs, times = {"I": [], "J": [], "B": []}, {"I": [], "J": [], "B": []}
    # I on the sorted bench ids, f32 and bf16
    # (the f32 table was scattered into since; its gathers are checked on the copy before)
    for (args, kw), out, tag in zip(calls["I"], (out_s, out_s16), ("f32", "bf16")):
        data, slots = args
        src = before if tag == "f32" else data
        ref = G.gather_rows_masked_plain(src, slots)
        ok = bit_equal(G.gather_rows_sorted(src, slots, **kw), ref) and bit_equal(out, ref)
        require(ok, f"[store] sorted_gather {tag} differs from its plain version")
        errs["I"].append({"case": f"bench sorted d=0.8 {tag}", "max_abs_err": 0.0, "tol": 0.0})
        t = gather_times(f"bench sorted [{batch}] of [{n}, {dim}] {tag}",
                         lambda: G.gather_rows_sorted(data, slots, **kw),
                         lambda: G.gather_rows_masked_plain(data, slots), data, slots)
        tile, window = G.sorted_plan(dim * data.element_size())
        t.update(tile=tile, window=window, **sorted_stats(data, slots, **kw),
                 gather_ms=cuda_ms(lambda: (table if tag == "f32" else table16).gather(
                     ids_s, local_kernel="sorted")))
        times["I"].append(t)
        log(f"[store] I sorted {tag}: {t['ms']} ms ({t['GBps_delivered']} GB/s delivered, "
            f"{t['bound_share']} of the {t['bound_ms']} ms bound); A on the same ids "
            f"{t['row_gather_ms']} ms; plain {t['plain_ms']} ms; index_select {t['library_ms']} ms; "
            f"tile {tile}, window {window}; I's counts: {t['windowed_tiles']} tiles windowed, "
            f"{t['direct_tiles']} direct, {t['bytes_read']} bytes read; "
            f"ShardedTable.gather {t['gather_ms']} ms")
    # J on the uniform bench ids
    (data, slots), kw = calls["J"][0]
    ref = G.gather_rows_masked_plain(before, slots)
    require(bit_equal(G.gather_rows_masked(before, slots), ref) and bit_equal(out_r, ref),
            "[store] row_gather_masked differs from its plain version")
    del ref
    errs["J"].append({"case": "bench uniform", "max_abs_err": 0.0, "tol": 0.0})
    t = gather_times(f"bench uniform [{batch}] of [{n}, {dim}] f32",
                     lambda: G.gather_rows_masked(data, slots),
                     lambda: G.gather_rows_masked_plain(data, slots), data, slots)
    idx_u = slots.long()
    t.update(gather_ms=cuda_ms(lambda: table.gather(ids_u)),
             device_ms=graph_ms(lambda: G.gather_rows_masked(data, slots)),
             row_gather_device_ms=graph_ms(lambda: G.gather_rows(data, slots)),
             library_device_ms=graph_ms(lambda: torch.index_select(data, 0, idx_u)),
             tile=G.masked_tile(dim * data.element_size()))
    times["J"].append(t)
    log(f"[store] J uniform: {t['ms']} ms ({t['GBps_delivered']} GB/s delivered, "
        f"{t['bound_share']} of the {t['bound_ms']} ms bound; device {t['device_ms']} ms); A on "
        f"the same ids {t['row_gather_ms']} ms (device {t['row_gather_device_ms']}); plain "
        f"{t['plain_ms']} ms; index_select {t['library_ms']} ms (device "
        f"{t['library_device_ms']}); tiles of {t['tile']} ids; ShardedTable.gather "
        f"{t['gather_ms']} ms")
    # B (masked) on the bench scatter: every id's row is the last row aimed at it
    (data, slots, rows), kw = calls["B"][0]
    uids, inv = torch.unique(ids_u.long(), return_inverse=True)
    last = torch.zeros(uids.numel(), dtype=torch.long, device="cuda").scatter_reduce_(
        0, inv, torch.arange(batch, device="cuda"), "amax", include_self=False)
    require(bit_equal(data[uids], rows_w[last]),
            "[store] a written row is not the last row aimed at it")
    kept, krows = slots[slots >= 0].long(), rows[slots >= 0]
    require(kept.numel() == uids.numel() and bit_equal(data[kept], krows),
            "[store] row_scatter (masked) did not write each kept row whole")
    require(bit_equal(data[sample], snap), "[store] the scatter changed an untouched row")
    errs["B"].append({"case": "bench scatter", "max_abs_err": 0.0, "tol": 0.0,
                      "rows_written": uids.numel(), "untouched_rows_checked": sample.numel()})
    rb = dim * 4
    t = timings(f"bench scatter [{batch}] into [{n}, {dim}] f32",
                lambda: G.scatter_rows_masked(data, slots, rows),
                lambda: G.scatter_rows_plain(data, slots, rows),
                lambda: data.index_copy_(0, kept, krows),
                bound_ms(batch * 4 + 2 * uids.numel() * rb), plain_iters=5)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["scatter_ms"] = cuda_ms(lambda: table.scatter(ids_u, rows_w, donate=True))
    times["B"].append(t)
    log(f"[store] B masked scatter: {t['ms']} ms ({t['bound_share']} of the {t['bound_ms']} ms "
        f"bound, {uids.numel()} distinct rows written); plain {t['plain_ms']} ms; index_copy_ "
        f"{t['library_ms']} ms; ShardedTable.scatter (one writer per id kept first) "
        f"{t['scatter_ms']} ms")
    # the add: against a float64 sum over the touched rows
    added = dataclasses.replace(table, data=before).scatter(ids_u, rows_w, accumulate=True)
    ref = before[uids].double().index_add_(0, inv, rows_w.double())
    kmax = int(torch.bincount(inv).max())
    err = max_err(added.data[uids], ref)
    tol = (kmax + 1) * F32_EPS * max(1.0, ref.abs().max().item())
    untouched = bit_equal(added.data[sample], before[sample])
    require(err <= tol and untouched, f"[store] scatter add: err {err} > tol {tol} or "
            f"an untouched row changed ({untouched})")
    errs["B"].append({"case": "bench scatter accumulate=True (index_add_) vs float64",
                      "max_abs_err": err, "tol": tol})
    del added, before, snap, ref
    log(f"[store] scatter accumulate=True: err {err} against float64 (tol {tol}, up to {kmax} "
        "rows per id)")

    # I against A over density, and on a narrow table
    sweep = sorted_sweep({"D=256 f32": table.data, "D=16 f32": wt.ShardedTable.create(
        n, 16, init=randn, generator=gen).data}, gen, n, batch)
    # I is exact on any ids: unsorted, duplicated, out of range
    data = table.data
    cases = {"unsorted": ids_s[torch.randperm(batch, generator=gen, device="cuda")],
             "duplicated": torch.sort(ids_s[torch.randint(0, batch // 8, (batch,), generator=gen,
                                                          device="cuda")]).values,
             "out of range": torch.sort(torch.cat([ids_s[:-8], torch.tensor(
                 [-1, -7, n, n + 5, -(2**31), 2**31 - 1, 0, n - 1], dtype=torch.int32,
                 device="cuda")])).values}
    for case, sl in cases.items():
        zero = bit_equal(table.gather(sl, local_kernel="sorted"), G.gather_rows_masked_plain(data, sl))
        clip = bit_equal(gather_mod.local_take_sorted(data, sl), G.gather_rows_plain(data, sl))
        require(zero and clip, f"[store] sorted gather on {case} ids: zero {zero} clip {clip}")
        errs["I"].append({"case": f"{case} ids, zero and clip", "max_abs_err": 0.0, "tol": 0.0})
    oob = ids_u.clone()
    bad_ids = torch.tensor([-1, n, n + 9, -(2**31)], dtype=torch.int32, device="cuda")
    oob[::4096] = bad_ids[torch.arange(oob[::4096].numel(), device="cuda") % 4]
    got = table.gather(oob)
    bad = (oob < 0) | (oob >= n)
    require(bit_equal(got, G.gather_rows_masked_plain(table.data, oob)) and not got[bad].any(),
            "[store] the ring gather's out-of-range rows are not zero")
    errs["J"].append({"case": f"{int(bad.sum())} out-of-range ids give zero rows",
                      "max_abs_err": 0.0, "tol": 0.0})
    log(f"[store] exact on {sorted(cases)} ids (I, zero and clip) and zero rows for "
        f"{int(bad.sum())} out-of-range ids (J)")
    del table, table16, data, calls, out_s, out_s16, out_r, rows_w
    torch.cuda.empty_cache()
    store_parity()
    log(f"[store] phase done in {time.perf_counter() - t0:.2f} s; tables freed")
    return errs, times, sweep, launches, routes


# ---------------------------------------------------------------------------
# the weighted sampler (kernel K) and the windowed sampled aggregation (D)
# ---------------------------------------------------------------------------

WEIGHTED_ROWS = kernel_variants.BENCH_ROWS    # bench_sampling's rows (degrees 16..48)
WEIGHTED_BATCH = kernel_variants.BENCH_BATCH  # its batch
WEIGHTED_K = kernel_variants.BENCH_K          # its fanout
WEIGHTED_STEPS = 30          # timed full-width weighted steps (p90 has 3 beyond it)
KW = sampling_mod.SAMPLE_HOP_WEIGHTED


def weighted_route(route, row_ptr, col, w, pairs, centers, K, seed, hop, max_degree):
    """One ``csr_sample_neighbors`` call on the pair table or on the
    separate arrays; fails unless it launched kernel K once."""
    k0 = KW.launches
    res = wt.ops.csr_sample_neighbors(row_ptr, col, centers, K, seed=seed, hop=hop, weights=w,
                                      max_degree=max_degree,
                                      cw_blocks=pairs if route == "pairs" else None)
    require(KW.launches == k0 + 1, f"csr_sample_neighbors ({route}) did not launch K once")
    return res


def check_weighted(case, row_ptr, col, w, pairs, centers, K, seed, hop, max_degree):
    """Kernel K on both routes against its plain version on the card by the
    equality rule (``ops.sampling.weighted_near_ties``: bit for bit on every
    centre without two keys within 4 ulps near its cut), the two routes
    bit-equal; the near-tie counts printed."""
    ref = sampling_mod.csr_sample_neighbors_weighted_plain(row_ptr, col, w, centers, K, seed, hop)
    near, inside = sampling_mod.weighted_near_ties(row_ptr, col, w, centers, K, seed, hop)
    ref_f = {f: getattr(ref, f) for f in SAMPLE_FIELDS}
    out = {"case": case, "max_abs_err": 0.0, "tol": 0.0, "fields": list(SAMPLE_FIELDS),
           "centres": centers.numel(), "valid_slots": int(ref.mask.sum())}
    got = {}
    for route in ("pairs", "separate"):
        got[route] = weighted_route(route, row_ptr, col, w, pairs, centers, K, seed, hop,
                                    max_degree)
        n_near, n_differ, n_bad = sampling_mod.weighted_rule(
            {f: getattr(got[route], f) for f in SAMPLE_FIELDS}, ref_f, near, inside)
        require(n_bad == 0, f"K ({case}, {route}): {n_bad} centres break the equality rule")
        out.update({f"near_ties_{route}": n_near, f"near_ties_differing_{route}": n_differ})
    require(same_sample(got["pairs"], got["separate"]), f"K ({case}): the two routes differ")
    log(f"[weighted] {case}: K equal to its plain version on both routes by the rule; near-tie "
        f"centres {out['near_ties_pairs']}, of them differing {out['near_ties_differing_pairs']} "
        f"(pairs) / {out['near_ties_differing_separate']} (separate); routes bit-equal")
    return out, ref


def weighted_cases(gen):
    """Graphs and centres beyond the bench's: rows of degree 0, K, K + 1,
    32, 33, 64, 65, 128 and 129 (the edges of K's register tiers: one
    value a lane, two, the tier of 8, its sort widths), 256 and 257 (the
    registers' edge and the list mode's) and a hub of 2^17 edges; weights with zeros, negatives, NaNs and infinities among
    them; every centre id outside [0, n) of either sign."""
    out = []
    for K in (1, 15, 200):
        n = 20_000
        degs = torch.randint(0, 2 * K + 4, (n,), generator=gen, device="cuda")
        degs[:13] = torch.tensor([0, 0, K, K + 1, 256, 257, 1 << 17, 32, 33, 64, 65, 128, 129],
                                 device="cuda")
        row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                             torch.cumsum(degs, 0)]).to(torch.int32)
        E = int(row_ptr[-1])
        col = torch.randint(0, n, (E,), generator=gen, device="cuda", dtype=torch.int32)
        w = torch.rand(E, generator=gen, device="cuda") + 0.01
        pick = torch.rand(E, generator=gen, device="cuda")
        w[pick < 0.05] = 0.0
        w[(pick >= 0.05) & (pick < 0.07)] = -1.0
        w[(pick >= 0.07) & (pick < 0.08)] = float("nan")
        w[(pick >= 0.08) & (pick < 0.09)] = float("inf")
        centers = torch.cat([torch.arange(n, device="cuda"),
                             torch.tensor([6, 6, 3, 4, 0, -1, -7, n, n + 9, -(2**31), 2**31 - 1],
                                          device="cuda")]).to(torch.int32)
        out.append((f"K={K} degrees 0, K, K+1, 32, 33, 64, 65, 128, 129, 256, 257, hub 2^17, "
                    f"weights 0/-1/NaN/inf, out-of-range centres", (row_ptr, col, w, centers, K)))
    return out


def weighted_hop_times(case, row_ptr, col, w, pairs, centers, K, seed, hop, iters=20):
    """One K call's times: the pair table's and the separate arrays' by CUDA
    events, its device time (a CUDA graph), the plain version, and for
    reference ``torch.topk`` of the padded [B, max degree] key matrix
    (built beforehand: no single PyTorch call samples); the bound counts
    the centres, their row_ptr pairs, 8 bytes an edge of theirs and the
    outputs."""
    B = centers.numel()
    start, deg = sampling_mod._centre_rows(row_ptr, centers)
    edges = int(deg.clamp(min=0).long().sum())
    keys = sampling_mod._weighted_keys(start, deg, w, seed, centers, hop,
                                       max(int(deg.max()), 1) if B else 1)

    def call():
        return sampling_mod.sample_hop_weighted(row_ptr, None, None, centers, K, seed, hop,
                                                pairs=pairs)

    nbytes = B * (4 + 8) + 8 * edges + B * K * 13 + 4 * B
    b_ms, by = bound_ms(nbytes)
    t = {"case": case, "ms": cuda_ms(call, iters), "device_ms": graph_ms(call),
         "separate_ms": cuda_ms(lambda: sampling_mod.sample_hop_weighted(
             row_ptr, col, w, centers, K, seed, hop), iters),
         "plain_ms": cuda_ms(lambda: sampling_mod.csr_sample_neighbors_weighted_plain(
             row_ptr, None, None, centers, K, seed, hop, pairs=pairs), 3, warmup=1),
         "library_ms": None, "topk_ms": cuda_ms(lambda: torch.topk(keys, min(K, keys.shape[1]),
                                                                   dim=1), iters),
         "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "edges": edges}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    log(f"[weighted] {case}: K {t['ms']} ms by CUDA events (pair table; separate arrays "
        f"{t['separate_ms']}), device {t['device_ms']} ms from a CUDA graph, plain {t['plain_ms']} "
        f"ms, topk of the ready key matrix {t['topk_ms']} ms (reference), bound {b_ms} ms "
        f"({nbytes} bytes)")
    return t


def weighted_split(case, row_ptr, pairs, centers, K, seed, hop):
    """Where K's time goes at one hop: the probes of
    ``tools/kernel_variants.k_register_variants``, each the current source
    with one step of the register path taken out (output not kept), built
    from this checkout and timed in turns beside K, by CUDA events (median
    of three) and as device time from a CUDA graph. A probe whose
    substitution no longer matches the source is named and left out, as
    the tool leaves it out."""
    with open(os.path.join(kernels.CSRC, KW.source)) as f:
        variants, stale = kernel_variants.k_register_variants(f.read())
    probes = {k: v for k, v in variants.items() if k.startswith("probe")}
    if stale:
        log(f"[weighted] K's probes that no longer match its source, left out: {stale}")
    libs, logs = kernel_variants.build(probes) if probes else ({}, {})

    def call(lib=None):
        def run():
            with kernel_variants.launching(KW, lib) if lib else contextlib.nullcontext():
                return sampling_mod.sample_hop_weighted(row_ptr, None, None, centers, K, seed,
                                                        hop, pairs=pairs)
        return run

    t = kernel_variants.in_turns({"K": call(), **{k: call(libs[k]) for k in probes}})
    with open(os.path.splitext(kernels.library_path(os.path.join(kernels.CSRC, KW.source)))[0]
              + ".log") as f:
        regs = {"K": kernel_variants.ptxas(f.read(), "hop_weighted"),
                **{k: kernel_variants.ptxas(logs[k], "hop_weighted") for k in probes}}
    log(f"[weighted] split of K at {case} (device ms, CUDA graph; CUDA events in the JSON): "
        + ", ".join(f"{k}: {v['device_ms']}" for k, v in t.items()))
    log(f"[weighted] K's build: {json.dumps(regs['K'])}")
    return {"case": case, "times": t, "ptxas": regs, "stale": stale}


def weighted_phase():
    """``[weighted]``: kernel K at ``bench_sampling(weighted=True)``'s shape
    (``bench.py:311-375``): 2,000,000 rows of degrees
    ``RandomState(1).randint(16, 49)``, uniform columns, weights ``U[0, 1) +
    0.1``, its pair table, 65,536 centres, K = 15, seed 0, declared
    max_degree 65,536. Both routes held against the plain version by the
    equality rule, one K launch a call by its count and no other kernel by
    the profiler, timed; then the edge cases at K = 1, 15 and 200."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    row_ptr, col, w, centers = kernel_variants.weighted_bench_graph(gen)
    E = int(row_ptr[-1])
    pairs = wt.ops.interleave_col_weights(col, w)
    torch.cuda.synchronize()
    log(f"[weighted] bench graph: {WEIGHTED_ROWS} rows, {E} edges, pair table "
        f"{pairs.nbytes} bytes, built in {time.perf_counter() - t0:.2f} s")
    args = (row_ptr, col, w, pairs, centers, WEIGHTED_K, 0, 0)
    errs = [check_weighted(f"bench [{WEIGHTED_BATCH}, {WEIGHTED_K}]", *args, 65536)[0]]

    def call():
        return weighted_route("pairs", *args, 65536)

    for _ in range(3):  # a window in which the profiler recorded something
        n_kern, names = profiled(call, 5)
        if names:
            break
    require(names and n_kern <= 1 and all("hop_weighted" in k for k in names),
            f"csr_sample_neighbors (weighted) launched other kernels: {n_kern} a call, {names}")
    errs[0]["kernels_per_call"] = n_kern
    bench = weighted_hop_times(f"bench [{WEIGHTED_BATCH}, {WEIGHTED_K}]", *args)
    bench["split"] = weighted_split(bench["case"], row_ptr, pairs, centers, WEIGHTED_K, 0, 0)
    del row_ptr, col, w, pairs, args
    torch.cuda.empty_cache()
    for case, (rp, cl, wc, ce, K) in weighted_cases(gen):
        errs.append(check_weighted(case, rp, cl, wc, wt.ops.interleave_col_weights(cl, wc), ce, K,
                                   17, 1, 1 << 17)[0])
    return errs, bench


def weighted_train_phase(cfg, batch_of):
    """``[weighted_train]``: the device-memory step at
    ``SageTrainConfig(sample_method="weighted")``, full width (the graph,
    table and model of ``[train]`` plus 128 MB of weights and the 256 MB
    pair table). One captured step whose two K calls are held against the
    plain version and timed; then WEIGHTED_STEPS timed steps with the counts
    from 0: two K launches a step and no C launch, A, B and D launched, the
    loss finite."""
    wcfg = dataclasses.replace(cfg, sample_method="weighted")
    t0 = time.perf_counter()
    state = wt.build_synthetic(wcfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[weighted_train] {wcfg} built in {time.perf_counter() - t0:.2f} s: "
        f"{state.graph.edge_count} edges, weights {state.graph.edge_weight.nbytes} bytes, "
        f"pair table {state.graph.cw_blocks.nbytes} bytes")
    batch = batch_of(state)
    calls = []
    with capture_kw(sampling_mod, "sample_hop_weighted", calls):
        loss0 = float(wt.train_step(state, *batch(), seed=0))
    require(np.isfinite(loss0) and len(calls) == 2,
            f"a weighted step: loss {loss0}, {len(calls)} K calls (2 expected)")
    g = state.graph
    errs, times = [], []
    for i, (a, kw) in enumerate(calls):
        _, _, _, centers, K, seed, hop = a
        case = f"hop{i} [{centers.numel()}, {K}]"
        errs.append(check_weighted(case, g.row_ptr, g.col, g.edge_weight, g.cw_blocks, centers,
                                   K, seed, hop, g.max_degree)[0])
        times.append(weighted_hop_times(case, g.row_ptr, g.col, g.edge_weight, g.cw_blocks,
                                        centers, K, seed, hop))
    del calls
    summary, launches, c = timed_steps("weighted_train", state, batch, WEIGHTED_STEPS)
    require(launches[KW.name] == 2 * WEIGHTED_STEPS and launches["sample_hop_uniform"] == 0
            and launches["sample_cols"] == 0,
            f"the weighted sampler did not run one K launch a hop and nothing else: {launches}")
    require(all(launches[k] > 0 for k in ("row_gather", "row_scatter", "neighbor_agg")),
            f"a kernel of the weighted step never ran: {launches}")
    require(bool(torch.isfinite(state.embedding.table[c.long()]).all()), "non-finite table rows")
    del state, g
    torch.cuda.empty_cache()
    return errs, times, launches, summary


def weighted_parity():
    """``[parity]``: a tiny weighted step three times from the same numpy
    graph, weights, table and model on the card and on the CPU: the samples
    bit-equal (no centre of these batches has a near tie), the losses within
    tolerance."""
    cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=128, hidden=128, num_classes=16,
                             batch=32, fanouts=(10, 15), sample_method="weighted")
    rs = np.random.RandomState(9)
    degs = rs.randint(cfg.deg // 2, cfg.deg + cfg.deg // 2 + 1, cfg.n_nodes)
    degs[:4] = 0
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, cfg.n_nodes, row_ptr[-1]).astype(np.int32)
    wts = (rs.rand(row_ptr[-1]) + 0.1).astype(np.float32)
    table = (rs.randn(cfg.n_nodes, cfg.dim) / np.sqrt(cfg.dim)).astype(np.float32)
    labels = rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32)
    ref_model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device="cpu")
    weights = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32) / np.sqrt(v.shape[-1]))
               for k, v in ref_model.state_dict().items()}
    batches = [rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32) for _ in range(3)]

    def state(dev):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=dev)
        model.load_state_dict(weights)
        graph = GraphStructure(torch.from_numpy(row_ptr).to(dev), torch.from_numpy(col).to(dev),
                               cfg.n_nodes, edge_weight=torch.from_numpy(wts).to(dev))
        return wt.SageTrainState(
            cfg, graph.with_weighted_fastpath(),
            Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=dev
                             ).from_array(table),
            model, torch.optim.Adam(model.parameters(), lr=cfg.lr),
            torch.from_numpy(labels).to(dev))

    gpu, cpu = state("cuda"), state("cpu")
    tol = 1e-5  # f32 sums in other orders on the two devices, over three Adam steps
    losses = {"gpu": [], "cpu": []}
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        mc = cpu.graph.multilayer_sample(c, cfg.fanouts, seed=i, weighted=True)
        for l, K in enumerate(cfg.fanouts):
            hop_centres = torch.where(mc.level_masks[l], mc.level_gids[l], 0)
            near, _ = sampling_mod.weighted_near_ties(cpu.graph.row_ptr, cpu.graph.col,
                                                      cpu.graph.edge_weight, hop_centres, K, i, l)
            require(not near.any(), f"a near tie in the weighted parity batch {i}, hop {l}")
        mg = gpu.graph.multilayer_sample(c.cuda(), cfg.fanouts, seed=i, weighted=True)
        require(torch.equal(mg.unique_gids.cpu(), mc.unique_gids)
                and all(torch.equal(a.nbr_idx.cpu(), b.nbr_idx) and torch.equal(a.mask.cpu(), b.mask)
                        for a, b in zip(mg.hops, mc.hops)),
                f"weighted samples differ between GPU and CPU (batch {i})")
        for name, st in (("gpu", gpu), ("cpu", cpu)):
            cd = c.to(st.labels.device)
            losses[name].append(float(wt.train_step(st, cd, st.labels[cd.long()], seed=i)))
    for la, lb in zip(losses["gpu"], losses["cpu"]):
        require(abs(la - lb) <= tol * max(1.0, abs(lb)), f"weighted loss {la} (gpu) vs {lb} (cpu)")
    log(f"[parity] 3 tiny weighted steps, samples bit-equal, losses {json.dumps(losses)} "
        f"(tol {tol})")


def sampled_agg_phase():
    """``[sampled_agg]``: ``padded_reduce_windowed`` at
    ``bench_spmm_sampled``'s shape (``bench.py:477-545``): the deepest hop
    of a (10, 15) sample of 1,024 sorted centres over
    ``clustered_csr(2,000,000, 16, 192)``, the centres drawn as the bench
    draws them, x [U, 256] f32 random, the bench's per-run windows, mean.
    One D launch, bit-equal to ``padded_reduce`` (the same kernel) and
    within K f32 ulps of the plain version; its gradient runs; timed beside
    ``padded_reduce``."""
    t0 = time.perf_counter()
    n = 2_000_000
    g = wt.clustered_csr(n, 16, 192, seed=0)
    rs = np.random.RandomState(0)  # the bench's draws after its graph's
    E = int(rs.randint(8, 32, n).sum())
    rs.randint(-96, 97, E)
    require(E == g.edge_count, f"the bench graph has {g.edge_count} edges, the draws {E}")
    centers = torch.from_numpy(np.sort(rs.choice(n, 1024, replace=False)).astype(np.int32)).cuda()
    ml = g.multilayer_sample(centers, (10, 15), seed=1)
    L = 1
    hop = ml.hops[L]
    rb = ml.run_bounds(L)
    wins = tuple(min(-(-min(b2 - b1, 1024) // 128) * 128, 1024) for b1, b2 in zip(rb, rb[1:]))
    U = rb[-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    x = torch.randn(U, 256, generator=gen, device="cuda")
    nbr, msk = hop.nbr_idx, hop.mask
    log(f"[sampled_agg] {g.edge_count} edges; block [{nbr.shape[0]}, {nbr.shape[1]}] over "
        f"[{U}, 256], run bounds {rb}, windows {wins}, {int(msk.sum())} edges; built in "
        f"{time.perf_counter() - t0:.2f} s")

    def windowed():
        return wt.ops.padded_reduce_windowed(x, nbr, msk, "mean", run_bounds=rb, windows=wins)

    d0 = S.NEIGHBOR_AGG.launches
    out = windowed()
    require(S.NEIGHBOR_AGG.launches == d0 + 1, "padded_reduce_windowed did not launch D once")
    require(bit_equal(out, wt.ops.padded_reduce(x, nbr, msk, "mean")),
            "padded_reduce_windowed differs from padded_reduce")
    ref = S.neighbor_reduce_plain(x, nbr, msk, True)
    K = nbr.shape[1]
    tol = K * F32_EPS * max(1.0, ref.abs().max().item())
    err = max_err(out, ref)
    require(err <= tol, f"padded_reduce_windowed err {err} > tol {tol}")
    xg = x.clone().requires_grad_()
    wt.ops.padded_reduce_windowed(xg, nbr, msk, "mean", run_bounds=rb, windows=wins).sum().backward()
    require(bool(torch.isfinite(xg.grad).all()), "non-finite gradient of padded_reduce_windowed")
    rb_ = 256 * 4
    uniq = torch.unique(nbr[msk]).numel()
    def padded():
        return wt.ops.padded_reduce(x, nbr, msk, "mean")

    t = {"case": f"hop1 [{nbr.shape[0]}, {K}] over [{U}, 256] mean", "max_abs_err": err,
         "tol": tol, "ms": cuda_ms(windowed), "device_ms": graph_ms(windowed),
         "padded_reduce_ms": cuda_ms(padded), "padded_reduce_device_ms": graph_ms(padded),
         "plain_ms": cuda_ms(lambda: S.neighbor_reduce_plain(x, nbr, msk, True), 5),
         "bound_ms": bound_ms(5 * nbr.numel() + uniq * rb_ + nbr.shape[0] * rb_,
                              int(msk.sum()) * 256)[0]}
    log(f"[sampled_agg] padded_reduce_windowed (D): one launch, bit-equal to padded_reduce, err "
        f"{err} (tol {tol}) against the plain version; {t['ms']} ms by CUDA events, device "
        f"{t['device_ms']} ms (padded_reduce {t['padded_reduce_ms']}, device "
        f"{t['padded_reduce_device_ms']}), plain {t['plain_ms']}, bound {t['bound_ms']}")
    del g, ml, x, xg
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------
# the sampled GCN, GAT and RGCN steps and the hetero step
# ---------------------------------------------------------------------------

NEW_STEPS = 30  # timed steps of each sampled model and of the hetero step (p90 has 3 beyond it)
SAMPLED_MODELS = (("gcn_block", {"model_type": "gcn", "degree_mode": "block"}),
                  ("gcn_true", {"model_type": "gcn", "degree_mode": "true"}),
                  ("gat", {"model_type": "gat"}),
                  ("rgcn", {"model_type": "rgcn"}))


def check_hops(calls):
    """Kernel C on each hop of a captured step: bit-equal to its plain
    version on all five ``SampleResult`` fields, timed beside it (CUDA
    events, and device time from a CUDA graph) and beside its bound."""
    errs, times = [], []
    for i, (row_ptr, col, centers, K, seed, hop) in enumerate(calls):
        def kernel():
            return sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed, hop)

        def plain():
            return sampling_mod.csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)

        ref = plain()
        require(same_sample(kernel(), ref), f"sample_hop_uniform hop{i} differs from its plain "
                                            "version")
        B, valid = centers.numel(), int(ref.mask.sum())
        case = f"hop{i} [{B}, {K}]"
        errs.append({"case": case, "max_abs_err": 0.0, "tol": 0.0, "valid_slots": valid})
        b_ms, by = bound_ms(B * (4 + 8 + 4) + 4 * valid + B * K * 13)
        times.append({"case": case, "ms": cuda_ms(kernel), "device_ms": graph_ms(kernel),
                      "plain_ms": cuda_ms(plain, 5), "library_ms": None, "bound_ms": b_ms,
                      "bound_by": by})
    return errs, times


def captured_step(step, state, c, y):
    """One step with every A, B, C and D wrapper call recorded; A's calls
    come from the embedding's gather and apply and from
    ``padded_gather_neighbors`` (GAT's and RGCN's neighbour rows)."""
    calls = {k: [] for k in "ABCD"}
    with capture(emb_mod, "gather_rows", calls["A"]), \
            capture(gather_mod, "gather_rows", calls["A"]), \
            capture(emb_mod, "scatter_rows", calls["B"]), \
            capture(sampling_mod, "sample_hop_uniform", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]):
        loss = float(step(state, c, y, seed=0))
    require(np.isfinite(loss), f"captured step loss {loss}")
    calls["A"] = [(t.detach(), ids) for t, ids in calls["A"]]
    calls["D"] = [(x.detach(), nbr, mask, mean) for x, nbr, mask, mean in calls["D"]]
    return calls, loss


def check_new_step(tag, step, state, batch, per_step):
    """A captured step whose calls per step must be ``per_step`` and whose
    every A, B, C and D call is held against its plain version; then
    NEW_STEPS timed steps with the counts from 0, which must be exactly
    ``per_step`` a step for A-D and nothing of K or C's fetch route."""
    calls, loss0 = captured_step(step, state, *batch())
    got = {k: len(v) for k, v in calls.items()}
    require(got == per_step, f"[{tag}] calls per step {got}, expected {per_step}")
    checks = {}
    for key, kern, fn in (("A", G.ROW_GATHER, check_gather), ("B", G.ROW_SCATTER, check_scatter),
                          ("C", sampling_mod.SAMPLE_HOP, check_hops),
                          ("D", S.NEIGHBOR_AGG, check_neighbor_agg)):
        if calls[key]:
            checks[kern.name] = fn(calls[key])
            for e in checks[kern.name][0] + checks[kern.name][1]:
                e["case"] = f"{tag} {e['case']}"
            log(f"[check] {kern.name} ({tag}): " + json.dumps(checks[kern.name][0]))
    log(f"[{tag}] captured step: calls {got}, loss {loss0:.5f}")
    del calls
    summary, launches, c = timed_steps(tag, state, batch, NEW_STEPS, profile_steps=5, step=step)
    want = {G.ROW_GATHER.name: per_step["A"], G.ROW_SCATTER.name: per_step["B"],
            sampling_mod.SAMPLE_HOP.name: per_step["C"], S.NEIGHBOR_AGG.name: per_step["D"]}
    want = {k: v * NEW_STEPS for k, v in want.items()}
    others = {k: v for k, v in launches.items() if k not in want and v}
    require(all(launches[k] == v for k, v in want.items()) and not others,
            f"[{tag}] launches {launches} over {NEW_STEPS} steps, expected {want} and no other")
    summary["launches"] = launches
    return summary, checks


def sampled_models_phase(cfg, batch_of):
    """``[sampled_models]``: the device-memory step at ``SageTrainConfig()``'s
    full width (the graph, table and batch of ``[train]``) for the sampled
    GCN with block and with true degrees, GAT (4 heads of 64, one head in
    the last layer) and RGCN (2 pseudo-relations): each through
    :func:`check_new_step`."""
    out, checks = {}, {}
    for tag, kw in SAMPLED_MODELS:
        mcfg = dataclasses.replace(cfg, **kw)
        t0 = time.perf_counter()
        state = wt.build_synthetic(mcfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        log(f"[sampled_models] {tag}: {mcfg} built in {time.perf_counter() - t0:.2f} s, "
            f"{state.graph.edge_count} edges")
        gcn = kw["model_type"] == "gcn"
        out[tag], checks[tag] = check_new_step(tag, wt.train_step, state, batch_of(state),
                                               {"A": 4 if gcn else 6, "B": 3, "C": 2,
                                                "D": 2 if gcn else 0})
        out[tag]["config"] = kw
        del state
        torch.cuda.empty_cache()
    log("[sampled_models] " + json.dumps({t: {k: v[k] for k in ("step_median_ms", "step_p90_ms",
                                                                 "peak_bytes", "busy_share")}
                                          for t, v in out.items()}))
    return out, checks


def hetero_phase():
    """``[hetero]``: ``HeteroTrainConfig()`` (the hetero example's widths,
    counts times 250: 1,000,000 papers, 375,000 authors, 50,000
    institutions) with the store trained under LazyAdam. The numpy build is
    timed on its own line; then :func:`check_new_step` on
    ``hetero_train_step`` with batches of distinct training papers."""
    cfg = wt.HeteroTrainConfig()
    t0 = time.perf_counter()
    state = wt.build_hetero(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    g = state.graph
    log(f"[hetero] {cfg}: dataset (numpy), CSR and store built in {time.perf_counter() - t0:.2f} s "
        f"(host side): {g.node_count} nodes, {g.edge_count} edges, {g.num_relations} relations, "
        f"max degree {g.max_degree}, tables " + json.dumps(
            {n: list(e.table.shape) for n, e in state.store.embeddings.items()}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    train = state.train_ids

    def batch():
        c = train[torch.randperm(train.numel(), generator=gen, device="cuda")[:cfg.batch]]
        return c, state.labels[c.long()]

    summary, checks = check_new_step("hetero", wt.hetero_train_step, state, batch,
                                     {"A": 14, "B": 9, "C": 2, "D": 0})
    for n, e in state.store.embeddings.items():
        require(bool(torch.isfinite(e.table).all()), f"[hetero] non-finite {n} table")
    del state
    torch.cuda.empty_cache()
    return summary, checks


def card_copy(cpu):
    """A card copy of a CPU ``SageTrainState``: its graph (edge types
    included), table and sparse optimizer, labels and weights, a fresh
    Adam."""
    g, c = cpu.graph, cpu.config
    model = HomoGNN(c.dim, c.hidden, c.num_classes, model_type=c.model_type,
                    num_heads=c.num_heads, num_relations=c.num_relations,
                    degree_mode=c.degree_mode, device="cuda")
    model.load_state_dict(cpu.model.state_dict())
    graph = GraphStructure(g.row_ptr.cuda(), g.col.cuda(), g.node_count, max_degree=g.max_degree,
                           edge_type=None if g.edge_type is None else g.edge_type.cuda(),
                           num_relations=g.num_relations)
    emb = Embedding.create(g.node_count, c.dim, optimizer=cpu.embedding.optimizer, device="cuda")
    return dataclasses.replace(cpu, graph=graph, embedding=emb.from_array(cpu.embedding.to_array()),
                               model=model, dense_opt=torch.optim.Adam(model.parameters(), lr=c.lr),
                               labels=cpu.labels.cuda())


def model_parity():
    """``[parity]``: three tiny steps of each sampled model and of the
    hetero step on the card and on the CPU from the same graph, table (or
    store) and weights: losses within 1e-5, and each table's change over
    the steps divided by the rate (the summed row gradients) within 1e-4
    of the largest (f32 sums in other orders). The tables train under SGD
    here: LazyAdam's step g / (|g| + 1e-8) turns f32 noise of 1e-9 on an
    element whose gradient is near 0 into a difference of up to the rate
    (the small and weighted parities hold LazyAdam on SAGE, whose row
    gradients keep clear of that)."""
    tol = 1e-5
    rs = np.random.RandomState(8)
    errs = {}

    def compare(tag, states, step, lr, batches, tables):
        before = [(a.clone(), b.clone()) for a, b in tables()]
        losses = {"gpu": [], "cpu": []}
        for i, c in enumerate(batches):
            for name, st in zip(("gpu", "cpu"), states):
                cd = c.to(st.labels.device)
                losses[name].append(float(step(st, cd, st.labels[cd.long()], seed=i)))
        for la, lb in zip(losses["gpu"], losses["cpu"]):
            require(abs(la - lb) <= tol * max(1.0, abs(lb)), f"{tag} loss {la} (gpu) vs {lb} (cpu)")
        err = 0.0
        for (a, b), (a0, b0) in zip(tables(), before):
            ga, gb = (a - a0).cpu() / lr, (b - b0) / lr
            e = max_err(ga, gb)
            require(e <= 1e-4 * max(1.0, gb.abs().max().item()),
                    f"[parity] {tag}: summed row gradients differ by {e}")
            err = max(err, e)
        errs[tag] = {"losses": losses, "summed_grad_err": err}

    for tag, kw in SAMPLED_MODELS:
        cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=128, hidden=128, num_classes=16,
                                 batch=32, fanouts=(10, 15), **kw)
        cpu = wt.build_synthetic(cfg, device="cpu", seed=3)
        cpu.embedding = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=SGD(), device="cpu"
                                         ).from_array(cpu.embedding.to_array())
        gpu = card_copy(cpu)
        batches = [torch.from_numpy(rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32))
                   for _ in range(3)]
        compare(tag, (gpu, cpu), wt.train_step, cfg.lr, batches,
                lambda: [(gpu.embedding.table, cpu.embedding.table)])
    hcfg = wt.HeteroTrainConfig(n_paper=800, n_author=300, n_inst=40, num_classes=8, hidden=128,
                                batch=64, fanouts=(10, 10))
    hcpu, hgpu = wt.build_hetero(hcfg, device="cpu", seed=2), wt.build_hetero(hcfg, device="cuda",
                                                                             seed=2)
    hgpu.model.load_state_dict(hcpu.model.state_dict())
    for st in (hcpu, hgpu):
        st.store = HeteroFeatureStore.create(st.store.space, optimizer=SGD(),
                                             device=st.labels.device).from_arrays(
            {n: e.to_array() for n, e in hcpu.store.embeddings.items()})
    batches = [torch.from_numpy(rs.choice(hcpu.train_ids.numpy(), hcfg.batch, replace=False))
               for _ in range(3)]
    compare("hetero", (hgpu, hcpu), wt.hetero_train_step, hcfg.lr * 0.1, batches,
            lambda: [(hgpu.store.embeddings[n].table, hcpu.store.embeddings[n].table)
                     for n in hcpu.store.space.names])
    log("[parity] 3 tiny steps each of GCN (block, true), GAT, RGCN and hetero, card vs CPU: "
        + json.dumps(errs))


def bench_entry(kern, name, launches, errs, main_call, calls, **extra):
    """One kernel's line from the times of its bench-shape call."""
    return {
        "name": name, "route": "cuda", "source": f"wholegraph_tpu_torch/csrc/{kern.source}",
        "replaces": kern.replaces, "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "tol": max(e["tol"] for e in errs),
        **{k: main_call[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "case": main_call["case"], "calls": calls, "checks": errs, **extra,
    }


def kernel_entry(kern, launches, errs, times, **extra):
    """One kernel's line: times per step (the sum over the step's calls; a
    library time only where every call has one); for E and F also the link
    bytes' time at the measured ``copy_`` rate, for C its parent's route and
    the fetch's ``take``."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "copy_ms", "parent_route_ms", "take_ms")
    total = {k: sum(t[k] for t in times) for k in keys if all(t.get(k) is not None for t in times)}
    total.setdefault("library_ms", None)
    return {
        "name": kern.name, "route": "cuda", "source": f"wholegraph_tpu_torch/csrc/{kern.source}",
        "replaces": kern.replaces, "launches": launches[kern.name],
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "tol": max(e["tol"] for e in errs), **total,
        "bound_by": "operations" if any(t["bound_by"] == "operations" for t in times) else "bytes",
        "calls": times, "checks": errs, **extra,
    }


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = kernels.build_all()
    log(f"[build] {len(secs)} sources in {time.perf_counter() - t0:.2f} s: {secs}")

    link = link_rates()
    log(f"[link] pinned->card {link['h2d_GBps']} GB/s, card->pinned {link['d2h_GBps']} GB/s "
        f"(1 GiB copy_, CUDA events) on {smi}")

    cfg = wt.SageTrainConfig()
    t0 = time.perf_counter()
    state = wt.build_synthetic(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[setup] {cfg} built in {time.perf_counter() - t0:.2f} s, "
        f"{state.graph.edge_count} edges")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def batch_of(st):
        def batch():
            c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                              dtype=torch.int32)
            return c, st.labels[c.long()]
        return batch

    batch = batch_of(state)

    # one full-width step that records every kernel wrapper's arguments
    calls = {k: [] for k in ("A", "B", "C", "D")}
    with capture(emb_mod, "gather_rows", calls["A"]), \
            capture(emb_mod, "scatter_rows", calls["B"]), \
            capture(sampling_mod, "sample_hop_uniform", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]):
        c, y = batch()
        loss0 = float(wt.train_step(state, c, y, seed=0))
    require(np.isfinite(loss0), f"first step loss {loss0}")
    per_step = {k: len(v) for k, v in calls.items()}
    log(f"[capture] calls per step: {per_step}, loss {loss0:.5f}")
    # A: the embedding gather + the apply's table, m and v reads; B: three
    # write-backs; C: one fetch per hop; D: one aggregation per layer
    require(per_step == {"A": 4, "B": 3, "C": 2, "D": 2}, f"unexpected calls per step {per_step}")

    checks = {}
    for key, kern, fn in (("A", G.ROW_GATHER, check_gather), ("B", G.ROW_SCATTER, check_scatter),
                          ("C", sampling_mod.SAMPLE_HOP, lambda c: check_sample_hop(c, gen)),
                          ("D", S.NEIGHBOR_AGG, check_neighbor_agg)):
        require(calls[key], f"kernel {kern.name} was not called by the main path")
        checks[key] = (kern, fn(calls[key]))
        log(f"[check] {kern.name}: {json.dumps(checks[key][1][0])}")
    del calls

    small_parity()
    weighted_parity()
    model_parity()

    # the device-memory path: reset the counters, train, read them
    _, launches, c = timed_steps("train", state, batch, STEPS)
    require(all(launches[k.name] > 0 for k, _ in checks.values()),
            f"a kernel of the path never ran: {launches}")
    require(launches["sample_hop_uniform"] == 2 * STEPS and launches["sample_cols"] == 0,
            f"the sampler did not run one kernel C launch per hop: {launches}")
    require(bool(torch.isfinite(state.embedding.table[c.long()]).all()), "non-finite table rows")
    del state, batch
    torch.cuda.empty_cache()

    # the weighted sampler (kernel K) and the windowed sampled aggregation (D)
    w_errs, w_bench = weighted_phase()
    wt_errs, wt_times, wt_launches, wt_summary = weighted_train_phase(cfg, batch_of)
    sagg = sampled_agg_phase()
    # the sampled GCN, GAT and RGCN steps, and the hetero step
    sm, sm_checks = sampled_models_phase(cfg, batch_of)
    het, het_checks = hetero_phase()
    new_steps = {**sm, "hetero": het}
    new_checks = {**sm_checks, "hetero": het_checks}

    bench, bench_errs = host_gather_phase(link)
    host_errs, host_times, host_launches = host_tier_phase(cfg, link)

    # the full-graph paths (kernels G and H)
    t0 = time.perf_counter()
    g = wt.clustered_csr(1 << 20, 16, 192)
    fg = g.to_full_graph(windowed=True)
    torch.cuda.synchronize()
    require(g.edge_count == 20_441_541, f"the bench graph has {g.edge_count} edges")
    require(fg.window is not None, "the bench graph's tile plan is infeasible")
    log(f"[fg_spmm] clustered_csr(2^20, 16, 192): {g.edge_count} edges, longest row "
        f"{longest_row(g.row_ptr)}, JAX plan window {fg.window}, edge_cap {fg.edge_cap}; built "
        f"in {time.perf_counter() - t0:.2f} s")
    (g_errs, g_times), (gt_errs, gt_times), g_fb = fg_spmm_phase(g, fg)
    h_errs, h_times = fg_sddmm_phase(g)
    del g, fg
    torch.cuda.empty_cache()
    gat_errs, gat_times, gat = fg_gat_phase()
    fg_parity()
    fgm = fg_model_phase()
    st_errs, st_times, st_sweep, st_launches, st_routes = store_phase()

    fg_launches = {k: sum(m["launches"][k] for m in fgm.values()) for k in launches}
    fg_routes = {r: sum(m["routes"].get(r, 0) for m in fgm.values())
                 for r in ("forward", "transposed")}
    fgm_checks = {r: [c for m in fgm.values() for c in m["checks"] if f" {r} " in c["case"]]
                  for r in ("forward", "transposed")}
    out = [kernel_entry(kern, launches, errs + host_errs.get(key, []), times, steps=STEPS,
                        launches_host_tier=host_launches[kern.name],
                        launches_fg_model=fg_launches[kern.name],
                        host_tier_calls=host_times.get(key, []))
           for key, (kern, (errs, times)) in checks.items()]
    b = next(e for e in out if e["name"] == G.ROW_SCATTER.name)  # B gains its masked route
    b.update(launches_masked=st_routes["masked"], store_scatter=st_times["B"][0])
    b["checks"] = b["checks"] + st_errs["B"]
    c = next(e for e in out if e["name"] == sampling_mod.SAMPLE_HOP.name)  # C's fetch route
    c.update(library="none: no single PyTorch call samples; take_ms is the fetch's torch.take "
                     "with its index and mask in the call, for reference only",
             fetch_route={"name": G.SAMPLE_COLS.name, "entry": G.SAMPLE_COLS.entry,
                          "launches": launches[G.SAMPLE_COLS.name],
                          **{k: sum(t["fetch_route"][k] for t in c["calls"])
                             for k in ("ms", "plain_ms", "bound_ms")}})
    for e in out:  # A-D on the new steps: launches over NEW_STEPS steps, checks and calls
        e["launches_new_steps"] = {t: v["launches"][e["name"]] for t, v in new_steps.items()}
        e["new_steps"] = NEW_STEPS
        for t, ch in new_checks.items():
            if e["name"] in ch:
                e["checks"] = e["checks"] + ch[e["name"]][0]
                e["calls_" + t] = ch[e["name"]][1]
        e["max_abs_err"] = max(c["max_abs_err"] for c in e["checks"])
        e["tol"] = max(c["tol"] for c in e["checks"])
    a = next(e for e in out if e["name"] == G.ROW_GATHER.name)  # the new steps' readings
    a["new_step_summaries"] = {t: {k: v for k, v in s.items() if k != "launches"}
                               for t, s in new_steps.items()}
    d = next(e for e in out if e["name"] == S.NEIGHBOR_AGG.name)  # D gains the windowed call
    d.update(sampled_agg=sagg)
    d["checks"] = d["checks"] + [{k: sagg[k] for k in ("case", "max_abs_err", "tol")}]
    out.append(kernel_entry(H.HOST_GATHER, host_launches, host_errs["E"] + bench_errs,
                            host_times["E"], steps=HOST_STEPS, bench=bench, link=link))
    out.append(kernel_entry(H.HOST_SCATTER, host_launches, host_errs["F"], host_times["F"],
                            steps=HOST_STEPS, link=link))
    out.append(bench_entry(S.CSR_SPMM, "csr_spmm", fg_routes["forward"],
                        g_errs + gat_errs["forward"] + fgm_checks["forward"], g_times[0],
                        g_times + gat_times["forward"], call_route="forward",
                        launches_per_call=g_times[0]["kernels_per_call"],
                        launches_fg_gat=gat["routes"].get("forward", 0),
                        fg_model=fgm, fg_gat=gat))
    out.append(bench_entry(S.CSR_SPMM, "csr_spmm_transposed", fg_routes["transposed"],
                        gt_errs + gat_errs["transposed"] + fgm_checks["transposed"], gt_times[0],
                        gt_times + gat_times["transposed"], call_route="transposed",
                        launches_per_call=gt_times[0]["kernels_per_call"],
                        launches_fg_gat=gat["routes"].get("transposed", 0),
                        spmm_window_fwd_bwd=g_fb))
    out.append(bench_entry(S.CSR_SDDMM, "csr_sddmm", gat["launches"]["csr_sddmm"],
                        h_errs + gat_errs["sddmm"], h_times[0], h_times + gat_times["sddmm"],
                        launches_per_call=h_times[0]["kernels_per_call"],
                        launches_path="fg_gat (one forward + backward)"))
    out.append(bench_entry(G.SORTED_GATHER, "sorted_gather", st_launches["sorted_gather"],
                           st_errs["I"], st_times["I"][0], st_times["I"], sweep=st_sweep,
                           launches_path="store (f32 and bf16 sorted gathers)"))
    out.append(bench_entry(G.ROW_GATHER_MASKED, "row_gather_masked",
                           st_launches["row_gather_masked"], st_errs["J"], st_times["J"][0],
                           st_times["J"], launches_path="store (ring gather)"))
    out.append(bench_entry(
        KW, KW.name, wt_launches[KW.name], w_errs + wt_errs, w_bench, [w_bench] + wt_times,
        launches_path=f"weighted_train ({WEIGHTED_STEPS} steps)", launches_per_hop=1,
        launches_per_step=wt_launches[KW.name] / WEIGHTED_STEPS,
        step_ms={k: sum(t[k] for t in wt_times) for k in ("ms", "device_ms", "plain_ms",
                                                           "bound_ms")},
        library="none: no single PyTorch call samples; topk_ms is torch.topk of the ready "
                "padded key matrix, for reference only",
        weighted_train=wt_summary))
    log(json.dumps({"kernels": out}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--paired-times"]:
        require(set(sys.argv[2:]) <= set(PAIRED_PARTS + OWN_PARTS),
                f"--paired-times takes parts among {PAIRED_PARTS + OWN_PARTS}, got {sys.argv[2:]}")
        paired_times(tuple(sys.argv[2:]) or PAIRED_PARTS)
    else:
        main()
