"""A training cell inside a Timeline: passes through ``train.train_epoch``.

The first pass captures the step's graph again (a graph captured inside a
Timeline writes its stamps at every replay); the second replays it for
every step and is the one read: one ``step`` span a step, so 191 intervals
between the entries of 192 steps. A third pass replays the graph under
``torch.profiler``: its stamp kernels, laid in order on the ring's rows,
put every span on the profiler's clock, and each idle gap of the device is
put down to the innermost span open on the device when the gap began."""

from __future__ import annotations

from typing import Dict, Optional

from wgbench.metrics import _timeline as T


def unit(mode):
    return mode.one_pass, "pass"


def reading(mode, perf, device, profile: bool = True) -> Optional[Dict]:
    tl = perf.Timeline(T.CAPACITY, device)
    with tl:
        mode.one_pass()  # the capture inside the Timeline
        first = len(tl.read())
        mode.one_pass()  # every step a replay: the pass read
        rows = tl.read()[first:]
        idle = T.profiled(mode.one_pass, perf, tl, len(tl.read())) if profile else None
    spans = perf.pair_spans(rows)
    out = {"dropped": tl.dropped, "spans": len(spans), "median_ms": T.medians_ms(spans),
           "step_ms_p95": T.nearest_rank(T.step_intervals_ms(spans)),
           "launch_gap_share": T.gap_share_pct(spans), "idle": idle}
    T.say("train pass", out)
    return None if tl.dropped else out
