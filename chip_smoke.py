"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths through their public entry points: the sampled
GraphSAGE training step (``wholegraph_tpu_torch.train``) with its embedding
in device memory, the host-memory tier's gather (``HostEmbedding.gather``)
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
   and one PyTorch library call computing the same function;
5. runs a tiny step three times from the same numpy-made graph, table and
   weights on the card and on the CPU, with the embedding in device memory
   and in the host tier: the RNG and samples must be bit-equal, losses and
   touched rows equal within tolerance, untouched rows unchanged, and every
   cached row equal to its host row;
6. the device-memory path: resets the launch counters, trains STEPS
   full-width steps timed by CUDA events (per step and per stage of
   ``train.STAGES``), fails if any of kernels A-D was not launched, and
   profiles ten more steps with ``torch.profiler``;
7. the host gather: a 4,000,000 x 256 f32 pinned table behind an empty
   cache, batch 524,288, uniform ids and ids clustered in a span of
   1.25 x batch rows; kernel E bit-equal to its plain version, its rate
   against the link's, and the library routes (a CPU ``index_select`` into
   pinned staging and a copy; a span ``copy_`` and a take on the card);
8. the host-tier path: ``SageTrainConfig()`` with ``cache_ratio=0.25`` and
   the top-degree rows cached; one captured step whose every E and F call is
   held against its plain version (F by its written rows and a sample of
   untouched rows), and so is every A and B call on the cache's lines; then
   HOST_STEPS timed steps with the stage split, the
   cache hit fraction, peak device memory and pinned bytes, failing if any
   of kernels A-F was not launched;
9. ``[fg_spmm]``: kernel G at ``bench_spmm_clustered``'s shapes
   (``clustered_csr(2^20, 16, 192)``, 20,441,541 edges, x [2^20, 256] f32):
   mean, sum and weighted sum held against the plain version, then the
   forward plus backward of ``spmm_window``'s mean with G's transposed
   launch held against its plain version and dx against an ``index_add_``
   scatter; times beside the bound, the plain version and cuSPARSE
   (``torch.sparse.mm``);
10. ``[fg_sddmm]``: kernel H at ``bench_sddmm_clustered``'s shapes against
    its plain version, beside cuSPARSE ``sampled_addmm``;
11. ``[fg_gat]``: the GAT layer at ``bench_gat_layer``'s shapes (2^18 nodes,
    4 heads of 64 over width 256, self loop): one captured forward plus
    backward with the counts from 0, every G and H call held against its
    plain version, ``attn_src``'s gradient nonzero; forward and forward
    plus backward timed;
12. ``[fg_parity]``: tiny full-graph SAGE, GCN and GAT on the card against
    the CPU from the same numpy data;
13. ``[fg_model]``: ``FullGraphConfig()`` (the bench graph, a [2^20, 256]
    f32 device-memory embedding as the features) with a 2-layer SAGE and a
    2-layer GCN: for each, the counts from 0, ``eval_full_graph`` on
    FG_CENTERS centres, FG_STEPS timed ``full_graph_value_and_grad`` runs,
    failing unless A and G (both routes) were launched;
14. ``[store]``: the sharded row store (``ShardedTable``) at the JAX
    benches' shapes, a 4,000,000 x 256 table of random rows: with the counts
    from 0, ``gather(local_kernel="sorted")`` on ``bench_gather_sorted``'s
    ids (2^19 sorted unique ids at density 0.8; kernel I, f32 and bf16),
    ``gather`` on ``bench_gather``'s (2^19 uniform ids; kernel J) and
    ``scatter(donate=True)`` on ``bench_scatter``'s (kernel B's masked
    route), failing unless each launched; then each call held bit-equal to
    its plain version and timed beside its bound, kernel A on the same ids
    and ``index_select`` (``index_copy_`` for the scatter); I against A over
    densities 1.0, 0.8, 0.5, 0.2 at D = 256 and D = 16; I exact on unsorted,
    duplicated and out-of-range ids; the add against float64; a tiny table
    on the card against the CPU;

then prints a ``kernels`` JSON line (A-J, G's forward and transposed
routes apart, B's masked launches beside its own), the card's name and
power limit, and,
as the last line, ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA it exits non-zero before printing any result.
"""

import contextlib
import dataclasses
import json
import math
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
from wholegraph_tpu_torch.embedding import (Embedding, HostEmbedding, LazyAdam,  # noqa: E402
                                            hot_ids_by_degree)
from wholegraph_tpu_torch.embedding import embedding as emb_mod  # noqa: E402
from wholegraph_tpu_torch.embedding import host_embedding as host_mod  # noqa: E402
from wholegraph_tpu_torch.graph import GraphStructure  # noqa: E402
from wholegraph_tpu_torch.models import GATConv, HomoGNN  # noqa: E402
from wholegraph_tpu_torch.ops import KERNELS  # noqa: E402
from wholegraph_tpu_torch.ops import gather as gather_mod  # noqa: E402
from wholegraph_tpu_torch.ops import gather_kernels as G  # noqa: E402
from wholegraph_tpu_torch.ops import host_kernels as H  # noqa: E402
from wholegraph_tpu_torch.ops import rng  # noqa: E402
from wholegraph_tpu_torch.ops import sampling as sampling_mod  # noqa: E402
from wholegraph_tpu_torch.ops import spmm_kernels as S  # noqa: E402
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


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def check_sample_cols(calls):
    """Kernel C on each hop's sampled-column fetch."""
    errs, times = [], []
    for i, (col, start, pos, mask) in enumerate(calls):
        err = max_err(G.sample_cols(col, start, pos, mask), G.sample_cols_plain(col, start, pos, mask))
        require(err == 0.0, f"sample_cols differs from its plain version: {err}")
        B, K = pos.shape
        errs.append({"case": f"hop{i} B={B} K={K}", "max_abs_err": err, "tol": 0.0})
        flat = (start.long()[:, None] + pos.long()).clamp(0, col.shape[0] - 1)
        times.append(timings(
            f"hop{i} [{B}, {K}]",
            lambda: G.sample_cols(col, start, pos, mask),
            lambda: G.sample_cols_plain(col, start, pos, mask),
            lambda: torch.take(col, flat),
            bound_ms(4 * B + 9 * B * K + 4 * int(mask.sum()))))
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


def time_host_gather(case, table, slots, link):
    """Kernel E on one call: times beside its bound at the link's peak and
    the measured ``copy_`` rate, and the library route a caller without E
    would take: a CPU
    ``index_select`` of the valid rows into pinned staging, then a
    non-blocking copy to the card (the ids sit on the CPU beforehand)."""
    rb = table.shape[1] * table.element_size()
    valid = (slots >= 0) & (slots < table.shape[0])
    vids = slots[valid].long().cpu()
    staging = H.pinned_empty((vids.numel(), table.shape[1]), table.dtype)
    dst = torch.empty((vids.numel(), table.shape[1]), dtype=table.dtype, device=slots.device)

    def library():
        torch.index_select(table, 0, vids, out=staging)
        dst.copy_(staging, non_blocking=True)

    uniq = torch.unique(vids).numel()
    t = timings(case, lambda: H.host_gather_rows(table, slots),
                lambda: H.host_gather_rows_plain(table, slots), library,
                link_bound_ms(uniq * rb, slots.numel() * (4 + rb)),
                iters=10, plain_iters=2)
    t.update(rows=slots.numel(), valid_rows=vids.numel(), unique_rows=uniq)
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


def device_time(state, batch, step_ms, steps=10):
    """Kernel time per training step under torch.profiler, its share of the
    unprofiled median step, and the kernels that take most of it."""
    work = [batch() for _ in range(steps)]
    profile_steps("profile", lambda i: wt.train_step(state, *work[i], seed=1000 + i),
                  step_ms, steps)


def profile_steps(tag, step, step_ms, steps):
    """Kernel time per call of ``step(i)`` under torch.profiler over
    ``steps`` calls, its share of the unprofiled median ``step_ms``, and the
    kernels that take most of it."""
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
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    log(f"[{tag}] {steps} steps: device busy {busy_ms} ms per step, "
        f"{len(kern)} kernel names, {sum(e.count for e in kern) / steps} launches per step; "
        f"busy share of the {step_ms} ms median step: {busy_ms / step_ms}")
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
            f"{e.count // steps:5d}x  {e.key[:100]}")


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


def train_timed(state, batch, steps, seed0):
    """``steps`` timed steps: per-step and per-stage CUDA-event ms, host
    clock ms, losses."""
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
        loss = wt.train_step(state, c, y, seed=seed0 + i, mark=mark)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(events["start"].elapsed_time(events[STAGES[-1]]))
        for a, b in zip(names, names[1:]):
            stage_ms[b].append(events[a].elapsed_time(events[b]))
        losses.append(float(loss))
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return step_ms, host_ms, stage_ms, losses, c


def report_steps(tag, steps, step_ms, host_ms, stage_ms, losses, peak, launches):
    log(f"[{tag}] {steps} steps at full width: first losses {losses[:5]}, last {losses[-5:]}")
    log(f"[{tag}] step ms (CUDA events) median {statistics.median(step_ms)}, "
        f"p90 {quantile(step_ms, 0.9)}, min {min(step_ms)}, max {max(step_ms)}; "
        f"host clock median {statistics.median(host_ms)}; "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB); launches {launches}")
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
        with capture(host_mod, "host_gather_rows", calls):
            rows = emb.gather(ids)
            torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        require(launches.get("host_gather", 0) > 0 and launches.get("row_gather", 0) > 0,
                f"host gather ({regime}) did not launch kernels E and A: {launches}")
        table, slots = calls[0]
        ref = H.host_gather_rows_plain(table, slots)
        err = max_err(H.host_gather_rows(table, slots), ref)
        require(err == 0.0 and torch.equal(rows, ref),
                f"host_gather ({regime}) differs from its plain version: {err}")
        errs.append({"case": f"bench {regime}", "max_abs_err": err, "tol": 0.0})
        t = time_host_gather(f"bench {regime} [{batch}] of [{n}, {dim}]", table, slots, link)
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
            + f"; {t['unique_rows']} unique rows; launches {launches}")
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
    for i, (table, slots) in enumerate(calls_e):
        err = max_err(H.host_gather_rows(table, slots), H.host_gather_rows_plain(table, slots))
        require(err == 0.0, f"host_gather step call{i} differs from its plain version: {err}")
        regime = "step gather (misses)" if i == 0 else "step apply (sorted unique slots)"
        errs["E"].append({"case": f"step call{i}", "max_abs_err": err, "tol": 0.0})
        t = time_host_gather(f"step call{i} [{slots.numel()}] of {list(table.shape)}",
                             table, slots, link)
        t["regime"] = regime
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
            capture(sampling_mod, "sample_cols", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]), \
            capture(host_mod, "host_gather_rows", calls["E"]), \
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
    misses = int(((calls["E"][0][1] >= 0)).sum())
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

    float(wt.train_step(state, *batch(), seed=1))  # one more warm-up step
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, stage_ms, losses, c = train_timed(state, batch, HOST_STEPS, 2)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    path = (G.ROW_GATHER, G.ROW_SCATTER, G.SAMPLE_COLS, S.NEIGHBOR_AGG, H.HOST_GATHER,
            H.HOST_SCATTER)
    require(all(launches[k.name] > 0 for k in path), f"a kernel of the host tier never ran: {launches}")
    require(bool(torch.isfinite(emb.gather(c)).all()), "non-finite host-tier rows")
    require(coherent(emb), "host tier: the cache lost coherence over the timed steps")
    report_steps("host_tier", HOST_STEPS, step_ms, host_ms, stage_ms, losses, peak, launches)
    log(f"[host_tier] pinned {asked} bytes asked ({held} held); cache hit fraction {hit}; "
        f"link h2d {link['h2d_GBps']} GB/s, d2h {link['d2h_GBps']} GB/s")
    device_time(state, batch, statistics.median(step_ms), steps=5)
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


def spmm_times(case, args, kw, library, iters=20, plain_iters=3):
    """One kernel G call (``csr_spmm(*args, **kw)``) held against its plain
    version, then timed beside its bound, the plain version and the
    cuSPARSE call ``library``."""
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
         "plain_ms": cuda_ms(lambda: S.csr_spmm_plain(*args, **plain_kw), plain_iters,
                             warmup=1),
         "library_ms": cuda_ms(library, iters), "bound_ms": b_ms, "bound_by": by,
         "edges": E, "dim": D, "longest_row": K, "source_rows_read": rows_read}
    t["Medges_per_s"] = E / t["ms"] / 1e3
    t["bound_share"] = b_ms / t["ms"]
    return {"case": case, "max_abs_err": err, "tol": tol}, t


def sddmm_times(case, args, library, iters=20, plain_iters=3):
    """One kernel H call held against its plain version, then timed."""
    row_ptr, col, a, b = args
    ref = S.csr_sddmm_plain(*args)
    tol = h_tol(ref, a.shape[1])
    err = max_err(S.csr_sddmm(*args), ref)
    require(err <= tol, f"csr_sddmm {case} err {err} > tol {tol}")
    E, D, es = col.numel(), a.shape[1], a.element_size()
    a_rows = int(((row_ptr[1:] - row_ptr[:-1]) > 0).sum())
    b_rows = torch.unique(col).numel()
    nbytes = (a_rows + b_rows) * D * es + 4 * E + 4 * row_ptr.numel() + 4 * E
    b_ms, by = bound_ms(nbytes, 2.0 * E * D)
    t = {"case": case, "ms": cuda_ms(lambda: S.csr_sddmm(*args), iters),
         "plain_ms": cuda_ms(lambda: S.csr_sddmm_plain(*args), plain_iters, warmup=1),
         "library_ms": cuda_ms(library, iters), "bound_ms": b_ms, "bound_by": by,
         "edges": E, "dim": D}
    t["Medges_per_s"] = E / t["ms"] / 1e3
    t["bound_share"] = b_ms / t["ms"]
    return {"case": case, "max_abs_err": err, "tol": tol}, t


def fmt_times(t):
    return (f"{t['ms']} ms ({t['Medges_per_s']} Medges/s, {t['bound_share']} of the "
            f"{t['bound_ms']} ms bound, {t['bound_by']}); plain {t['plain_ms']} ms; "
            f"cuSPARSE {t['library_ms']} ms")


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
        e, t = spmm_times(f"bench {case} [{n}, {dim}] f32", (rp, col, x),
                          {"reduce": reduce, "edge_weight": weight},
                          lambda: torch.sparse.mm(lib, x))
        errs.append(e)
        times.append(t)
        log(f"[fg_spmm] G {case}: " + fmt_times(t) + f"; err {e['max_abs_err']} (tol {e['tol']})")
        del lib

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
    e_dx = {"case": "bench backward dx vs index_add_ scatter", "max_abs_err": err_dx,
            "tol": tol_dx}
    log(f"[fg_spmm] G transposed (backward dx): " + fmt_times(t_t)
        + f"; err {e_t['max_abs_err']} (tol {e_t['tol']}); whole dx against an index_add_ "
        f"scatter: err {err_dx} (tol {tol_dx})")
    fb_ms = cuda_ms(fwd_bwd, 5, warmup=1)
    tr_ms = cuda_ms(lambda: S.transpose_csr(rp, col, n), 5, warmup=1)
    fb = {"fwd_bwd_ms": fb_ms, "fwd_bwd_Medges_per_s": E / fb_ms / 1e3,
          "transpose_csr_ms": tr_ms}
    log(f"[fg_spmm] spmm_window mean forward + backward: {fb_ms} ms "
        f"({fb['fwd_bwd_Medges_per_s']} Medges/s; the transposed CSR is built in each call, "
        f"{tr_ms} ms of it)")
    del xg, lib_t, calls, dx_ref, x, w, dst
    torch.cuda.empty_cache()
    return (errs, times), ([e_t, e_dx], [t_t]), fb


def fg_sddmm_phase(g):
    """Kernel H at bench_sddmm_clustered's shapes (a, b [2^20, 256] f32)."""
    n, dim = g.node_count, 256
    rp, col = g.row_ptr, g.col
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    a = torch.randn(n, dim, generator=gen, device="cuda")
    b = torch.randn(n, dim, generator=gen, device="cuda")
    pattern = sparse_csr(rp, col, torch.ones(g.edge_count, device="cuda"), n)
    e, t = sddmm_times(f"bench [{n}, {dim}] f32", (rp, col, a, b),
                       lambda: torch.sparse.sampled_addmm(pattern, a, b.t(), beta=0.0))
    lib_err = max_err(torch.sparse.sampled_addmm(pattern, a, b.t(), beta=0.0).values(),
                      S.csr_sddmm(rp, col, a, b))
    t["library_max_abs_err"] = lib_err
    log(f"[fg_sddmm] H: " + fmt_times(t) + f"; err {e['max_abs_err']} (tol {e['tol']}); "
        f"cuSPARSE sampled_addmm differs from H by {lib_err}")
    del a, b, pattern
    torch.cuda.empty_cache()
    return [e], [t]


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
            log(f"[fg_gat]   {t['case']}: " + fmt_times(t))

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


def window_share(slots, n, tile, window):
    """Share of kernel I's tiles whose rows (clipped into [0, n)) span at
    most ``window`` rows, so they are served from shared memory."""
    s = slots.long().clamp(0, n - 1)
    pad = -s.numel() % tile
    if pad:
        s = torch.cat([s, s[-1:].expand(pad)])
    t = s.view(-1, tile)
    return float(((t.max(1).values - t.min(1).values) < window).float().mean())


def gather_times(case, kernel, plain, data, slots, iters=20):
    """One store gather call timed beside its bound (each distinct valid row
    read once, each output row written once, the ids read once), its plain
    version, kernel A on the same slots and ``index_select``."""
    rb = data.shape[1] * data.element_size()
    valid = slots[(slots >= 0) & (slots < data.shape[0])]
    nbytes = torch.unique(valid).numel() * rb + slots.numel() * (rb + slots.element_size())
    clipped = slots.long().clamp(0, data.shape[0] - 1)
    t = timings(case, kernel, plain, lambda: torch.index_select(data, 0, clipped),
                bound_ms(nbytes), iters=iters, plain_iters=5)
    t["row_gather_ms"] = cuda_ms(lambda: G.gather_rows(data, slots), iters)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["GBps_delivered"] = slots.numel() * rb / t["ms"] / 1e6
    return t


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
        t.update(tile=tile, window=window, window_share=window_share(slots, n, tile, window),
                 gather_ms=cuda_ms(lambda: (table if tag == "f32" else table16).gather(
                     ids_s, local_kernel="sorted")))
        times["I"].append(t)
        log(f"[store] I sorted {tag}: {t['ms']} ms ({t['GBps_delivered']} GB/s delivered, "
            f"{t['bound_share']} of the {t['bound_ms']} ms bound); A on the same ids "
            f"{t['row_gather_ms']} ms; plain {t['plain_ms']} ms; index_select {t['library_ms']} ms; "
            f"tile {tile}, window {window}, {t['window_share']} of the tiles windowed; "
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
    t["gather_ms"] = cuda_ms(lambda: table.gather(ids_u))
    times["J"].append(t)
    log(f"[store] J uniform: {t['ms']} ms ({t['GBps_delivered']} GB/s delivered, "
        f"{t['bound_share']} of the {t['bound_ms']} ms bound); A on the same ids "
        f"{t['row_gather_ms']} ms; plain {t['plain_ms']} ms; index_select {t['library_ms']} ms; "
        f"ShardedTable.gather {t['gather_ms']} ms")
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
    narrow = wt.ShardedTable.create(n, 16, init=randn, generator=gen)
    sweep = []
    for name, tab in (("D=256 f32", table), ("D=16 f32", narrow)):
        data = tab.data
        rb = data.shape[1] * data.element_size()
        for d in (1.0, 0.8, 0.5, 0.2):
            sl = sorted_ids(gen, n, batch, d)
            got = gather_mod.local_take_sorted(data, sl, density=d)
            require(bit_equal(got, G.gather_rows_plain(data, sl)),
                    f"[store] local_take_sorted {name} d={d} differs from its plain version")
            tile, window = G.sorted_plan(rb, density=d)
            i_ms = cuda_ms(lambda: G.gather_rows_sorted(data, sl, density=d))
            a_ms = cuda_ms(lambda: G.gather_rows(data, sl))
            b_ms, _ = bound_ms(batch * (2 * rb + 4))
            sweep.append({"table": name, "density": d, "I_ms": i_ms, "A_ms": a_ms,
                          "I_over_A": i_ms / a_ms, "bound_ms": b_ms, "tile": tile,
                          "window": window, "window_share": window_share(sl, n, tile, window)})
            log(f"[store] sweep {name} d={d}: I {i_ms} ms, A {a_ms} ms (I/A {i_ms / a_ms}); "
                f"bound {b_ms} ms; tile {tile} window {window}, "
                f"{sweep[-1]['window_share']} of the tiles windowed")
    del narrow
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
    """One kernel's line: times per step (the sum over the step's calls);
    for E and F also the link bytes' time at the measured ``copy_`` rate."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms") + (
        ("copy_ms",) if all("copy_ms" in t for t in times) else ())
    total = {k: sum(t[k] for t in times) for k in keys}
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

    def batch():
        c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                          dtype=torch.int32)
        return c, state.labels[c.long()]

    # one full-width step that records every kernel wrapper's arguments
    calls = {k: [] for k in ("A", "B", "C", "D")}
    with capture(emb_mod, "gather_rows", calls["A"]), \
            capture(emb_mod, "scatter_rows", calls["B"]), \
            capture(sampling_mod, "sample_cols", calls["C"]), \
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
                          ("C", G.SAMPLE_COLS, check_sample_cols),
                          ("D", S.NEIGHBOR_AGG, check_neighbor_agg)):
        require(calls[key], f"kernel {kern.name} was not called by the main path")
        checks[key] = (kern, fn(calls[key]))
        log(f"[check] {kern.name}: {json.dumps(checks[key][1][0])}")
    del calls

    small_parity()

    # the device-memory path: reset the counters, train, read them
    c, y = batch()
    float(wt.train_step(state, c, y, seed=1))  # one more warm-up step
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, stage_ms, losses, c = train_timed(state, batch, STEPS, 2)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(all(launches[k.name] > 0 for k, _ in checks.values()),
            f"a kernel of the path never ran: {launches}")
    require(bool(torch.isfinite(state.embedding.table[c.long()]).all()), "non-finite table rows")
    report_steps("train", STEPS, step_ms, host_ms, stage_ms, losses, peak, launches)
    device_time(state, batch, statistics.median(step_ms))
    del state
    torch.cuda.empty_cache()

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
    out.append(kernel_entry(H.HOST_GATHER, host_launches, host_errs["E"] + bench_errs,
                            host_times["E"], steps=HOST_STEPS, bench=bench, link=link))
    out.append(kernel_entry(H.HOST_SCATTER, host_launches, host_errs["F"], host_times["F"],
                            steps=HOST_STEPS, link=link))
    out.append(bench_entry(S.CSR_SPMM, "csr_spmm", fg_routes["forward"],
                        g_errs + gat_errs["forward"] + fgm_checks["forward"], g_times[0],
                        g_times + gat_times["forward"], call_route="forward",
                        launches_fg_gat=gat["routes"].get("forward", 0),
                        fg_model=fgm, fg_gat=gat))
    out.append(bench_entry(S.CSR_SPMM, "csr_spmm_transposed", fg_routes["transposed"],
                        gt_errs + gat_errs["transposed"] + fgm_checks["transposed"], gt_times[0],
                        gt_times + gat_times["transposed"], call_route="transposed",
                        launches_fg_gat=gat["routes"].get("transposed", 0),
                        spmm_window_fwd_bwd=g_fb))
    out.append(bench_entry(S.CSR_SDDMM, "csr_sddmm", gat["launches"]["csr_sddmm"],
                        h_errs + gat_errs["sddmm"], h_times[0], h_times + gat_times["sddmm"],
                        launches_path="fg_gat (one forward + backward)"))
    out.append(bench_entry(G.SORTED_GATHER, "sorted_gather", st_launches["sorted_gather"],
                           st_errs["I"], st_times["I"][0], st_times["I"], sweep=st_sweep,
                           launches_path="store (f32 and bf16 sorted gathers)"))
    out.append(bench_entry(G.ROW_GATHER_MASKED, "row_gather_masked",
                           st_launches["row_gather_masked"], st_errs["J"], st_times["J"][0],
                           st_times["J"], launches_path="store (ring gather)"))
    log(json.dumps({"kernels": out}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
