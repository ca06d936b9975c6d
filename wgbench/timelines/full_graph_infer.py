"""A full-graph cell inside a Timeline: the mode's ``TRACED`` passes, read
one by one: the ``fg_spmm`` spans of a pass summed, the median over the
passes, and the median of every span of the last pass."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from wgbench.metrics import _timeline as T


def unit(mode):
    return mode.one_pass, "pass"


def reading(mode, perf, device, passes: Optional[int] = None) -> Optional[Dict]:
    passes = passes or T.mode_constant(mode, "TRACED")
    tl = perf.Timeline(T.CAPACITY, device)
    sums, spans = [], []
    with tl:
        for _ in range(passes):
            first = len(tl.read())
            mode.one_pass()
            spans = perf.pair_spans(tl.read()[first:])
            sums.append(sum(T.durations_ms(spans, "fg_spmm")))
    out = {"dropped": tl.dropped, "spans_a_pass": len(spans), "median_ms": T.medians_ms(spans),
           "fg_spmm_ms_a_pass": statistics.median(sums)}
    T.say(f"{passes} passes", out)
    return None if tl.dropped else out
