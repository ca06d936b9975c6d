"""The port's spans and its Timeline of device stamps (``utils.perf.span``,
``utils.perf.Timeline``), and the arithmetic of the benchmark's readers of
them (``wgbench/metrics/_timeline.py``) on hand-made stamp rows.

On the CPU a stamp's device clock is the host's ``perf_counter_ns``, so the
same code runs here as on a card. The tests marked ``cuda`` need the card
(the stamp kernel has no CPU mode) and skip without one; run them there
with ``python -m pytest tests/test_torch_timeline.py -q -m cuda --noconftest``.
This file imports nothing of JAX."""

import contextlib
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch import train as T
from wholegraph_tpu_torch.full_graph import FullGraphConfig, build_full_graph
from wholegraph_tpu_torch.utils import perf
from wgbench.metrics import _timeline as R

torch.set_num_threads(1)

CFG = wt.SageTrainConfig(n_nodes=300, deg=8, dim=16, hidden=16, num_classes=4, batch=16,
                         fanouts=(3, 4))
HETERO = wt.HeteroTrainConfig(n_paper=40, n_author=10, n_inst=5, num_classes=3, hidden=8,
                              batch=4, fanouts=(2, 2))


def _batch(state, seed=0):
    c = torch.from_numpy(np.random.RandomState(seed).choice(CFG.n_nodes, CFG.batch,
                                                            replace=False).astype(np.int32))
    return c, state.labels[c.long()]


# -- spans ---------------------------------------------------------------------


def test_span_is_one_shared_null_context_when_nothing_records():
    a = perf.span("sample")
    assert a is perf.span("gather") and isinstance(a, contextlib.nullcontext)
    with perf.Timeline(device="cpu"):
        assert perf.span("sample") is not a
    assert perf.active_timeline() is None and perf.span("sample") is a


@pytest.mark.parametrize("model_type", ["sage", "gat"])
def test_profiler_sees_the_spans_nested(model_type):
    """Under a CPU profiler a step's spans are ``wg::`` host ranges:
    ``append_unique`` inside ``sample``, each layer (``conv.<model>``) inside
    ``forward_backward``, everything inside ``step``."""
    from torch.profiler import ProfilerActivity, profile

    state = wt.build_synthetic(dataclasses.replace(CFG, model_type=model_type, num_heads=2),
                               device="cpu", seed=1)
    c, y = _batch(state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wt.train_step(state, c, y, seed=0)
    got = {}
    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    for ev in prof.events():
        if ev.name.startswith("wg::"):
            # not the user scope, which the profiler would also lay over the card's events
            assert ev.scope != user
            got.setdefault(ev.name[4:], []).append((ev.time_range.start, ev.time_range.end))
    L = len(CFG.fanouts)
    conv = "conv." + model_type
    assert {k: len(v) for k, v in got.items()} == {
        "step": 1, "sample": 1, "append_unique": L, "gather": 1,
        "forward_backward": 1, conv: L, "dense_adam": 1, "sparse_apply": 1}

    def inside(inner, outer):
        return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in got[outer]) for i0, i1 in got[inner])

    for inner, outer in (("append_unique", "sample"),
                         (conv, "forward_backward"), ("sample", "step"), ("gather", "step"),
                         ("sparse_apply", "step")):
        assert inside(inner, outer), (inner, outer)


@pytest.mark.parametrize("case", ["sage", "gat", "host_tier", "hetero"])
def test_a_timeline_over_a_step_records_step_then_the_stages(case):
    """Inside a Timeline a step records one ``step`` span and, directly in
    it, ``train.STAGES`` in order, each within the step (the hetero step
    applies once a type), every stamp with its host clock."""
    if case == "hetero":
        state = wt.build_hetero(HETERO, device="cpu")
        c = state.train_ids[:HETERO.batch]
        step = lambda: wt.hetero_train_step(state, c, state.labels[c.long()], seed=0)  # noqa: E731
    else:
        cfg = dataclasses.replace(CFG, model_type="gat" if case == "gat" else "sage",
                                  num_heads=2)
        state = wt.build_synthetic(cfg, device="cpu", seed=2,
                                   host_cache_ratio=0.25 if case == "host_tier" else None)
        c, y = _batch(state)
        step = lambda: wt.train_step(state, c, y, seed=0)  # noqa: E731
    with perf.Timeline(device="cpu") as tl:
        step()
    spans = tl.spans()
    top, stages = [s for s in spans if s.depth == 0], [s for s in spans if s.depth == 1]
    names = [s.name for s in stages]
    assert [s.name for s in top] == ["step"]
    assert [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n] == list(T.STAGES)
    assert all(top[0].start_ns <= s.start_ns <= s.end_ns <= top[0].end_ns for s in stages)
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    assert all(s.host_start_ns is not None and s.host_end_ns is not None for s in spans)
    assert tl.dropped == 0


@pytest.mark.parametrize("steps", [1, 3, 5])
def test_a_timeline_over_a_cpu_epoch_records_a_step_a_batch(steps):
    state = wt.build_synthetic(CFG, device="cpu", seed=3)
    rs = np.random.RandomState(steps)
    c = torch.from_numpy(rs.randint(0, CFG.n_nodes, (steps, CFG.batch)).astype(np.int32))
    with perf.Timeline(device="cpu") as tl:
        T.train_epoch(state, c, state.labels[c.long()], torch.arange(steps))
    d = tl.durations()
    assert len(d["step"]) == steps
    assert all(len(d[s]) == steps for s in T.STAGES)
    assert len(d["append_unique"]) == steps * len(CFG.fanouts)
    starts = [s.start_ns for s in tl.spans() if s.name == "step"]
    assert starts == sorted(starts) and state.embedding.step == steps


def test_full_graph_pass_spans_each_layer_and_its_spmm():
    fs = build_full_graph(FullGraphConfig(n_nodes=200, deg=4, width=16, dim=8, hidden=8,
                                          num_classes=3), device="cpu")
    x = fs.embedding.gather(torch.arange(200, dtype=torch.int32))
    with perf.Timeline(device="cpu") as tl, torch.no_grad():
        fs.model(x, graph=fs.fg)
    spans = tl.spans()
    L = fs.model.num_layers
    assert [s.name for s in spans if s.depth == 0] == ["conv.sage"] * L
    # the last layer (8 -> 3) projects first, its fg_spmm inside that span
    assert [s.name for s in spans if s.depth == 1] == ["fg_spmm"] * (L - 1) + [
        "sage.project_first"]
    assert [s.depth for s in spans if s.name == "fg_spmm"] == [1] * (L - 1) + [2]


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_a_full_ring_counts_its_drops_and_writes_nothing_past_its_end(capacity):
    tl = perf.Timeline(capacity, device="cpu")
    with tl:
        for i in range(5):
            tl.stamp(f"s{i}", perf.ENTER)
    rows = tl.read()
    assert [r[0] for r in rows] == [f"s{i}" for i in range(min(5, capacity))]
    assert tl.dropped == max(5 - capacity, 0) and int(tl.buf[0, 0]) == 5
    assert tl.buf.shape == (capacity + 1, 2)
    assert [r[3] for r in rows] == tl.host_ns[:len(rows)]


def test_timelines_nest_and_a_graph_is_bound_to_the_active_one():
    state = wt.build_synthetic(CFG, device="cpu", seed=4)
    outside = T._reads(state, None)
    a, b = perf.Timeline(8, device="cpu"), perf.Timeline(8, device="cpu")
    with a:
        in_a = T._reads(state, None)
        with b:
            assert perf.active_timeline() is b and T._reads(state, None) != in_a
            with pytest.raises(wt.utils.WholeGraphError):
                b.__enter__()
        assert perf.active_timeline() is a and T._reads(state, None) == in_a
    assert perf.active_timeline() is None and T._reads(state, None) == outside != in_a


# -- the benchmark readers' arithmetic, on hand-made rows ------------------------


def _rows(spec):
    """Rows from ``(name, phase, device ns[, host ns])`` tuples."""
    return [(n, p, t, h[0] if h else None) for n, p, t, *h in spec]


def _steps(bounds):
    """A ``step`` span at each ``(enter, exit)`` in ns, a ``sample`` inside each."""
    out = []
    for t0, t1 in bounds:
        out += [("step", "enter", t0), ("sample", "enter", t0 + 10), ("sample", "exit", t1 - 10),
                ("step", "exit", t1)]
    return _rows(out)


def test_pair_nests_and_closes_the_latest_span_of_a_name():
    spans = perf.pair_spans(_rows([("a", "enter", 0, 5), ("b", "enter", 1), ("b", "enter", 2),
                                   ("b", "exit", 3), ("b", "exit", 4), ("a", "exit", 9, 50),
                                   ("c", "enter", 10)]))
    assert spans == [("a", 0, 9, 5, 50, 0), ("b", 1, 4, None, None, 1),
                     ("b", 2, 3, None, None, 2)]
    assert spans[1].ms == 3e-6 and spans[0].host_end_ns == 50


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 21)), 95, 19), (list(range(1, 101)), 95, 95), ([3.0], 95, 3.0),
    ([5, 1, 4, 2, 3], 50, 3), (list(range(191, 0, -1)), 95, 182)])
def test_nearest_rank(values, q, want):
    assert R.nearest_rank(values, q) == want


def test_step_intervals_gap_share_and_medians():
    ms = 1_000_000
    spans = perf.pair_spans(_steps([(0, 4 * ms), (5 * ms, 9 * ms), (11 * ms, 15 * ms)]))
    assert R.step_intervals_ms(spans) == [5.0, 6.0]
    assert R.gap_share_pct(spans) == pytest.approx(100.0 * 3 / 15)
    assert R.medians_ms(spans) == {"sample": pytest.approx(3.99998), "step": 4.0}
    assert R.durations_ms(spans, "sample") == [pytest.approx(3.99998)] * 3


def test_batch_host_ms_runs_from_a_batch_first_entry_to_its_last_exit():
    ms = 1_000_000
    rows = []
    for b, (h0, h1) in enumerate([(0, 3), (10, 12), (20, 27)]):
        t = 100 * b
        rows += [("sample", "enter", t, h0 * ms), ("append_unique", "enter", t + 1, h0 * ms + 1),
                 ("append_unique", "exit", t + 2, h0 * ms + 2),
                 ("sample", "exit", t + 3, h0 * ms + 3),
                 ("gather", "enter", t + 4, h0 * ms + 4), ("gather", "exit", t + 5, h1 * ms)]
    spans = perf.pair_spans(_rows(rows))
    assert R.batch_host_ms(spans) == [3.0, 2.0, 7.0]


def test_idle_gaps_go_to_the_innermost_open_span():
    """Each idle gap between the device's busy intervals goes to the
    innermost span open when it began, or to none between steps."""
    spans = [perf.SpanTime("step", 0.0, 40.0, None, None, 0),
             perf.SpanTime("sample", 5.0, 20.0, None, None, 1),
             perf.SpanTime("step", 100.0, 140.0, None, None, 0)]
    device = [("k", 0.0, 6.0), ("k", 8.0, 30.0), ("k", 28.0, 39.0), ("k", 41.0, 42.0),
              ("k", 100.0, 120.0), ("k", 125.0, 140.0)]
    idle = R.idle_by_span(device, spans)
    assert idle == pytest.approx({"sample": 0.002, "step": 0.002 + 0.005, R.NO_SPAN: 0.058})


MODES = sorted(p.stem for p in (pathlib.Path(R.__file__).parents[1] / "modes").glob("*.py"))


@pytest.mark.parametrize("mode_name", MODES)
def test_every_mode_has_its_timeline_unit(mode_name):
    """Each mode file has ``timelines/<mode>.py`` with the unit that a
    reading traces and the reading; a mode without one raises."""
    mod = R.unit_of(mode_name)
    assert callable(mod.unit) and callable(mod.reading)
    with pytest.raises(ModuleNotFoundError):
        R.unit_of("no_such_mode")


@pytest.mark.parametrize("lost,jump", [((), 0.0), ((0, 7, 8, 30), 0.0), ((12,), 3000.0)])
def test_ring_rows_go_on_the_profiler_clock_where_the_profiler_missed_stamps(lost, jump):
    """The profiler saw all but ``lost`` of 40 stamps on a clock 5 us off
    the card's, which steps by ``jump`` us after the 20th: every row seen
    keeps its own profiled time, every row unseen the offset beside it."""
    rs = np.random.RandomState(len(lost))
    ns = np.cumsum(rs.randint(2000, 40000, 40)).tolist()
    true_us = [t / 1e3 + 5.0 + (jump if k >= 20 else 0.0) for k, t in enumerate(ns)]
    seen = [t for k, t in enumerate(true_us) if k not in lost]
    assert R.on_profiler_clock(ns, seen) == pytest.approx(true_us)
    assert R.on_profiler_clock(ns, []) is None
    assert R.on_profiler_clock(ns[:10], [t + 50 * (k % 2) for k, t in enumerate(true_us)]) is None


@pytest.mark.parametrize("cell", ["sage-products.train", "sage-products.infer",
                                  "sage-products.fullgraph"])
def test_the_readings_of_a_tiny_cell_on_the_cpu(cell, tmp_path):
    """The benchmark's readings run their mode again inside a Timeline; on
    the CPU (no profiler pass) their spans and numbers come out whole. The
    readers themselves report nothing off the card."""
    from wgbench import inputs as I
    from wgbench import program
    from wgbench.metrics.context import ReadContext
    from wgbench.run import Run
    from wgbench.tests.tiny import tiny_cell

    c = tiny_cell(str(tmp_path), cell)
    run = Run(c, 5, "cpu")
    run.inputs = I.make_all(run.cfg, run.seed, run.device)
    run.built = program.Built(run.cfg, run.mix, run.inputs, run.device)
    mode = c.mode().Runner(run)
    mode.setup()
    ctx = ReadContext(run, mode, {"seconds": 1.0, "attempted": 1})
    assert all(c.reader(m["name"])(ctx) is None for m in c.per_layer
               if m["source"] == "program_span")
    if cell.endswith("train"):
        r = R.unit_of("train_epoch").reading(mode, perf, run.device, profile=False)
        S = mode.traffic.per_pass
        assert r["spans"] > S and r["step_ms_p95"] > 0 and 0 <= r["launch_gap_share"] < 100
        assert set(T.STAGES) - {"sparse_apply"} <= set(r["median_ms"])
    elif cell.endswith("infer"):
        r = R.unit_of("sampled_infer").reading(mode, perf, run.device, 4)
        assert r["batch_host_ms"] > 0 and r["median_ms"]["sample"] > 0
    else:
        r = R.unit_of("full_graph_infer").reading(mode, perf, run.device, 2)
        assert r["fg_spmm_ms_a_pass"] > 0 and r["median_ms"]["fg_spmm"] > 0
    assert r["dropped"] == 0


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamp kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_state(dev, model_type="sage"):
    st = wt.build_synthetic(dataclasses.replace(CFG, model_type=model_type, num_heads=2),
                            device=dev, seed=2)
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=CFG.lr, capturable=True)
    return st


def _step_call(st, dev):
    c = torch.arange(CFG.batch, dtype=torch.int32, device=dev)
    y, seed = st.labels[c.long()], torch.zeros((), dtype=torch.int64, device=dev)
    corr = st.embedding.optimizer.step_table([1], dev)[0]
    return lambda: wt.train_step(st, c, y, seed, corrections=corr)


@pytest.mark.cuda
def test_stamp_kernel_builds_and_its_stamps_increase(dev):
    tl = perf.Timeline(64, device=dev)
    x = torch.randn(1 << 20, device=dev)
    with tl:
        for i in range(20):
            with perf.span(f"s{i % 3}"):
                x = x * 1.0001
    rows = tl.read()
    assert len(rows) == 40 and tl.dropped == 0
    ns = [r[2] for r in rows]
    assert all(a <= b for a, b in zip(ns, ns[1:])) and ns[-1] > ns[0]
    assert all(r[3] is not None for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["sage", "gat"])
def test_a_step_graph_holds_stamps_only_inside_a_timeline(dev, model_type, monkeypatch):
    """A step captured outside a Timeline has the kernel nodes of a capture
    with no spans at all; one captured inside a Timeline has those nodes
    and, on top, one stamp node for each stamp its capture asked for."""
    from wgbench.probe import graph_kernels

    st = _card_state(dev, model_type)
    call = _step_call(st, dev)
    plain = graph_kernels(call)
    with monkeypatch.context() as m:
        m.setattr(perf, "span", lambda name: contextlib.nullcontext())
        parent_style = graph_kernels(call)
    assert plain == parent_style and not any(R.STAMP_KERNEL in k for k in plain)
    tl = perf.Timeline(1 << 12, device=dev)
    with tl:
        call()  # graph_kernels runs one call eagerly, then the capture
        before = perf.STAMP.launches
        stamped = graph_kernels(call)
        asked = perf.STAMP.launches - before
    stamps = [k for k in stamped if R.STAMP_KERNEL in k]
    assert [k for k in stamped if R.STAMP_KERNEL not in k] == plain
    assert len(stamps) == asked // 2 > 0  # graph_kernels' eager call asked as many again


@pytest.mark.cuda
def test_train_epoch_recaptures_when_the_timeline_changes(dev):
    st = _card_state(dev)
    rs = np.random.RandomState(5)
    S = 5
    c = torch.from_numpy(rs.randint(0, CFG.n_nodes, (S, CFG.batch)).astype(np.int32)).to(dev)
    y = st.labels[c.long()]
    seeds = torch.arange(S)
    T.train_epoch(st, c, y, seeds)
    g0 = st.epoch_graph
    T.train_epoch(st, c, y, seeds)
    assert st.epoch_graph is g0  # no Timeline either time: replayed
    tl = perf.Timeline(1 << 12, device=dev)
    with tl:
        T.train_epoch(st, c, y, seeds)
        g1 = st.epoch_graph
        first = len(tl.read())
        T.train_epoch(st, c, y, seeds)
        assert st.epoch_graph is g1 and g1 is not g0
    steps = [s for s in tl.spans() if s.name == "step"]
    assert len(steps) == 2 * S and tl.dropped == 0
    assert sum(s.host_start_ns is None for s in steps) == 2 * S - T.WARMUP_STEPS  # replays
    assert all(s.host_start_ns is None for s in perf.pair_spans(tl.read()[first:]))
    T.train_epoch(st, c, y, seeds)
    assert st.epoch_graph is not g1  # outside the Timeline again: captured again
