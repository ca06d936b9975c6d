"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the sampled GraphSAGE training step
(``wholegraph_tpu_torch.train``), through its public entry points:

1. builds every hand-written kernel from ``wholegraph_tpu_torch/csrc``;
2. builds the full-width synthetic state (``SageTrainConfig()``: 2M nodes,
   dim 256, batch 1024, fanouts (10, 15)) and runs one step that records the
   arguments of every kernel wrapper call;
3. holds each kernel against its plain PyTorch version on exactly those
   tensors (plus A in bf16 and D as a sum), and times kernel, plain version
   and one PyTorch library call computing the same function;
4. runs a tiny step three times on the GPU and on the CPU from the same
   numpy-made graph, table and weights: the RNG and samples must be
   bit-equal, the losses and touched rows equal within tolerance;
5. resets the launch counters, trains STEPS full-width steps timed by CUDA
   events (per step and per stage of ``train.STAGES``), and fails if any
   kernel of the path was not launched;
6. profiles ten more steps with ``torch.profiler`` for the device's kernel
   time per step and the kernels that take most of it;

then prints a ``kernels`` JSON line, the card's name and power limit, and,
as the last line, ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA it exits non-zero before printing any result.
"""

import contextlib
import json
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
from wholegraph_tpu_torch.embedding import Embedding, LazyAdam  # noqa: E402
from wholegraph_tpu_torch.embedding import embedding as emb_mod  # noqa: E402
from wholegraph_tpu_torch.graph import GraphStructure  # noqa: E402
from wholegraph_tpu_torch.models import HomoGNN  # noqa: E402
from wholegraph_tpu_torch.ops import gather_kernels as G  # noqa: E402
from wholegraph_tpu_torch.ops import rng  # noqa: E402
from wholegraph_tpu_torch.ops import sampling as sampling_mod  # noqa: E402
from wholegraph_tpu_torch.ops import spmm_kernels as S  # noqa: E402
from wholegraph_tpu_torch.train import STAGES  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
STEPS = 100                 # timed full-width steps (p90 has 10 beyond it)
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


@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name`` (a kernel
    wrapper as the main path looks it up) into ``calls``. Nothing but the
    embedding's tables is written after such a call, and the scatter
    check works on copies of those."""
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


# ---------------------------------------------------------------------------
# kernel checks on the main path's own tensors
# ---------------------------------------------------------------------------


def timings(case, kernel, plain, library, bound):
    """One main-path call's times (ms, CUDA events) beside its bound."""
    b_ms, by = bound
    return {"case": case, "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library), "bound_ms": b_ms, "bound_by": by}


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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def quantile(values, q):
    return float(np.quantile(np.asarray(values), q))


def device_time(state, batch, step_ms, steps=10):
    """Kernel time per step under torch.profiler, its share of the
    unprofiled median step, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    work = [batch() for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, (c, y) in enumerate(work):
            wt.train_step(state, c, y, seed=1000 + i)
        torch.cuda.synchronize()
    # device-side entries, less user annotations (Optimizer.step's range),
    # which span kernels already counted
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    log(f"[profile] {steps} steps: device busy {busy_ms} ms per step, "
        f"{len(kern)} kernel names, {sum(e.count for e in kern) / steps} launches per step; "
        f"busy share of the {step_ms} ms median step: {busy_ms / step_ms}")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
            f"{e.count // steps:5d}x  {e.key[:100]}")


def small_parity():
    """A tiny step on the GPU and on the CPU from the same numpy data."""
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

    def state(dev):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=dev)
        model.load_state_dict(weights)
        return wt.SageTrainState(
            cfg, GraphStructure(torch.from_numpy(row_ptr).to(dev), torch.from_numpy(col).to(dev),
                                cfg.n_nodes),
            Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=dev)
            .from_array(table),
            model, torch.optim.Adam(model.parameters(), lr=cfg.lr),
            torch.from_numpy(labels).to(dev))

    gpu, cpu = state("cuda"), state("cpu")
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
    losses, touched = [], []
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        lg = float(wt.train_step(gpu, c.cuda(), gpu.labels[c.long().cuda()], seed=i))
        lc = float(wt.train_step(cpu, c, cpu.labels[c.long()], seed=i))
        require(abs(lg - lc) <= tol * max(1.0, abs(lc)), f"step {i}: loss {lg} (GPU) vs {lc} (CPU)")
        losses.append((lg, lc))
        ml = cpu.graph.multilayer_sample(c, cfg.fanouts, seed=i)
        touched.append(ml.unique_gids[ml.unique_mask])
    rows = torch.unique(torch.cat(touched)).long()
    err = max_err(gpu.embedding.table.cpu()[rows], cpu.embedding.table[rows])
    require(err <= tol, f"touched rows differ between GPU and CPU: {err}")
    untouched = torch.ones(cfg.n_nodes, dtype=torch.bool)
    untouched[rows] = False
    require(torch.equal(gpu.embedding.table.cpu()[untouched], torch.from_numpy(table)[untouched]),
            "untouched rows changed on the GPU")
    log(f"[parity] 3 tiny steps, losses (GPU, CPU) {losses}, touched rows {rows.numel()}, "
        f"max row diff {err:.3g} (tol {tol})")


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
    log(f"[build] {len(secs)} kernels in {time.perf_counter() - t0:.2f} s: {secs}")

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
        checks[kern.name] = (kern, fn(calls[key]))
        log(f"[check] {kern.name}: {json.dumps(checks[kern.name][1][0])}")
    del calls

    small_parity()

    # the main path: reset the counters, train, read them
    c, y = batch()
    float(wt.train_step(state, c, y, seed=1))  # one more warm-up step
    for kern, _ in checks.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    names = ("start",) + STAGES
    step_ms, host_ms, losses = [], [], []
    stage_ms = {s: [] for s in STAGES}
    for i in range(STEPS):
        c, y = batch()
        torch.cuda.synchronize()
        events = {}

        def mark(stage):
            events[stage] = torch.cuda.Event(enable_timing=True)
            events[stage].record()

        t0 = time.perf_counter()
        mark("start")
        loss = wt.train_step(state, c, y, seed=2 + i, mark=mark)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(events["start"].elapsed_time(events[STAGES[-1]]))
        for a, b in zip(names, names[1:]):
            stage_ms[b].append(events[a].elapsed_time(events[b]))
        losses.append(float(loss))
    launches = {kern.name: kern.launches for kern, _ in checks.values()}
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(all(n > 0 for n in launches.values()), f"a kernel of the path never ran: {launches}")
    require(bool(torch.isfinite(state.embedding.table[c.long()]).all()), "non-finite table rows")

    log(f"[train] {STEPS} steps at full width: first losses {losses[:5]}, last {losses[-5:]}")
    log(f"[train] step ms (CUDA events) median {statistics.median(step_ms)}, "
        f"p90 {quantile(step_ms, 0.9)}, min {min(step_ms)}, max {max(step_ms)}; "
        f"host clock median {statistics.median(host_ms)}; "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB); launches {launches}")
    log("[train] stage ms medians (CUDA events): "
        + json.dumps({s: statistics.median(v) for s, v in stage_ms.items()}))
    device_time(state, batch, statistics.median(step_ms))

    # times are per step: the sum over the step's calls, listed in "calls"
    out = []
    for name, (kern, (errs, times)) in checks.items():
        total = {k: sum(t[k] for t in times) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out.append({
            "name": name, "route": "cuda", "source": f"wholegraph_tpu_torch/csrc/{kern.source}",
            "replaces": kern.replaces, "launches": launches[name],
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "tol": max(e["tol"] for e in errs), **total,
            "bound_by": "operations" if any(t["bound_by"] == "operations" for t in times)
            else "bytes",
            "steps": STEPS, "calls": times, "checks": errs,
        })
    log(json.dumps({"kernels": out}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
