"""Readings of the port's own spans and device stamps (``utils.perf.span``
and ``utils.perf.Timeline``): the cell's mode run again inside a Timeline
after the window, with the profiler off, and reduced to the per-layer
metrics that read it.

How a mode is run and read inside a Timeline is the mode's own, in
``wgbench/timelines/<mode>.py`` (:func:`unit_of`): ``reading(mode, perf,
device)`` gives the reading, ``unit(mode)`` the unit of work it traces. This
file holds what they share: the arithmetic on the spans and the profiled
pass that lays the stamps on the profiler's clock.

Each reading prints one ``[timeline]`` line to standard error: the median
device ms of every span, the spans counted and the stamps dropped. A
reading is None off the card, with a program that has no Timeline, and
where the ring dropped a stamp.
"""

from __future__ import annotations

import importlib
import json
import statistics
import sys
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CAPACITY = 1 << 16  # stamps a reading's Timeline holds: three training passes need about 16K
STAMP_KERNEL = "stamp_kernel"  # the name of the port's stamp kernel, as the profiler shows it
NO_SPAN = "(no span)"
TOP = 10


def port_perf():
    """The port's ``utils.perf`` where it has spans and a Timeline, else None."""
    try:
        from wholegraph_tpu_torch.utils import perf
    except ImportError:
        return None
    return perf if hasattr(perf, "Timeline") and hasattr(perf, "span") else None


def unit_of(mode_name: str) -> ModuleType:
    """The module ``wgbench/timelines/<mode_name>.py``; a mode without one
    raises ``ModuleNotFoundError``."""
    return importlib.import_module(f"wgbench.timelines.{mode_name}")


def mode_constant(mode, name: str):
    """A constant of the mode file that defines the runner ``mode`` (its
    ``TRACED``)."""
    return getattr(sys.modules[type(mode).__module__], name)


# -- arithmetic on the spans (``utils.perf.SpanTime``) -------------------------


def durations_ms(spans: Sequence, name: str) -> List[float]:
    return [s.ms for s in spans if s.name == name]


def nearest_rank(values: Sequence[float], q: int = 95) -> float:
    """The ``q``-th percentile by nearest rank, as ``infer_batch_ms_p95``."""
    v = sorted(values)
    return v[max(0, -(-q * len(v) // 100) - 1)]


def step_intervals_ms(spans: Sequence, name: str = "step") -> List[float]:
    """Device ms from each ``name`` span's entry to the next one's: a step
    and the gap after it."""
    starts = [s.start_ns for s in spans if s.name == name]
    return [(b - a) / 1e6 for a, b in zip(starts, starts[1:])]


def gap_share_pct(spans: Sequence, name: str = "step") -> float:
    """The device time between one ``name`` span's exit and the next one's
    entry, summed, over the time from the first entry to the last exit, in %."""
    steps = [s for s in spans if s.name == name]
    gaps = sum(b.start_ns - a.end_ns for a, b in zip(steps, steps[1:]))
    return 100.0 * gaps / (steps[-1].end_ns - steps[0].start_ns)


def batch_host_ms(spans: Sequence, first: str = "sample") -> List[float]:
    """Host ms of each batch from its first span's entry to its last span's
    exit; a batch starts at each outermost ``first`` span."""
    groups: List[List] = []
    for s in spans:
        if s.depth != 0:
            continue
        if s.name == first:
            groups.append([])
        if groups:
            groups[-1].append(s)
    return [(max(s.host_end_ns for s in g) - min(s.host_start_ns for s in g)) / 1e6
            for g in groups]


def medians_ms(spans: Sequence) -> Dict[str, float]:
    names = sorted({s.name for s in spans})
    return {n: statistics.median(durations_ms(spans, n)) for n in names}


def on_profiler_clock(ring_ns: Sequence[int], prof_us: Sequence[float], most_lost: int = 64
                      ) -> Optional[List[float]]:
    """Every ring row's time on the profiler's clock, from the profiler's
    stamp kernels ``prof_us`` (their starts, ascending), which may miss up
    to ``most_lost`` of the ring's stamps, or None
    where they cannot fit. The profiled stamps are laid on the rows, in
    order, where the intervals between consecutive profiled stamps best
    match those between their rows (least summed difference, by dynamic
    programming over the rows skipped so far), so a step of one clock
    against the other costs one interval. A row the profiler missed takes
    the offset of the match before it (after it, at the start)."""
    x = [t / 1e3 for t in ring_ns]
    y = list(prof_us)
    n, m = len(x), len(y)
    d = n - m
    if not m or not 0 <= d <= most_lost:
        return None
    cost = [0.0] * (d + 1)  # y[j] on row j + s, for each s rows skipped before it
    back: List[List[int]] = []
    for j in range(1, m):
        dy = y[j] - y[j - 1]
        new, arg = [], []
        for s in range(d + 1):
            xi = x[j + s]
            c, sp = min((cost[sp] + abs(dy - xi + x[j - 1 + sp]), sp) for sp in range(s + 1))
            new.append(c)
            arg.append(sp)
        cost = new
        back.append(arg)
    s = min(range(d + 1), key=cost.__getitem__)
    times: List[Optional[float]] = [None] * n
    for j in range(m - 1, -1, -1):
        times[j + s] = y[j]
        if j:
            s = back[j - 1][s]
    last = next(t - xx for t, xx in zip(times, x) if t is not None)
    for k in range(n):
        if times[k] is None:
            times[k] = x[k] + last
        else:
            last = times[k] - x[k]
    return times


def idle_by_span(device: Sequence[Tuple[str, float, float]], spans_us: Sequence
                 ) -> Dict[str, float]:
    """Idle device ms between the device's busy intervals (the union of
    ``device``'s ``(name, start us, end us)``), each gap put down to the
    innermost span of ``spans_us`` (times in us) open when it began."""
    merged: List[List[float]] = []
    for _, s, e in sorted(device, key=lambda d: d[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    by_start = sorted(spans_us, key=lambda sp: sp.start_ns)
    active: List = []
    at = 0
    out: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):  # gaps in ascending order: one sweep
        while at < len(by_start) and by_start[at].start_ns <= e0:
            active.append(by_start[at])
            at += 1
        active = [sp for sp in active if sp.end_ns > e0]
        key = min(active, key=lambda sp: sp.end_ns - sp.start_ns).name if active else NO_SPAN
        out[key] = out.get(key, 0.0) + (s1 - e0) / 1e3
    return out


# -- the runs ------------------------------------------------------------------


def say(what: str, reading: Dict) -> None:
    print(f"[timeline] {what}: {json.dumps(reading)}", file=sys.stderr, flush=True)


def profiled(block: Callable[[], None], perf, tl, before: int) -> Dict:
    """``block()`` under ``torch.profiler``; its stamps (the ring's rows
    from ``before`` on) laid on the profiler's clock by its stamp kernels
    (:func:`on_profiler_clock`), and the idle gaps by open span; only the
    two counts where they do not fit."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize()
    dev = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    rows = tl.read()[before:]
    stamps = sorted(d[1] for d in dev if STAMP_KERNEL in d[0])
    out = {"stamps_profiled": len(stamps), "stamps_in_ring": len(rows)}
    placed = on_profiler_clock([r[2] for r in rows], stamps)
    if placed is None:
        return out
    # each span's bounds are its own stamps' starts on the profiler's clock
    spans = perf.pair_spans([(r[0], r[1], t, r[3]) for r, t in zip(rows, placed)])
    idle = idle_by_span(dev, spans)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    out.update(idle_ms=sum(idle.values()), idle_ms_by_span=[[k, v] for k, v in top])
    return out


def reading(ctx, mode_name: str) -> Optional[Dict]:
    """The cell's reading (``timelines/<mode_name>.py``'s ``reading``), made
    once a run (kept on ``ctx``); None unless the cell's mode is
    ``mode_name``, on a card, with a program that has a Timeline."""
    perf = port_perf()
    if ctx.mode_name != mode_name or perf is None or ctx.run.device.type != "cuda":
        return None
    cache = ctx.__dict__.setdefault("_timeline_readings", {})
    if mode_name not in cache:
        cache[mode_name] = unit_of(mode_name).reading(ctx.mode, perf, ctx.run.device)
    return cache[mode_name]
