"""An evaluation cell inside a Timeline: the mode's ``TRACED`` batches of
its body, read as one: the median of every span and the host's enqueue
time of a batch (:func:`metrics._timeline.batch_host_ms`)."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from wgbench.metrics import _timeline as T


def unit(mode, batches: Optional[int] = None):
    n = batches or T.mode_constant(mode, "TRACED")
    return (lambda: mode.run_batches(n, None, events=False)), f"{n} batches"


def reading(mode, perf, device, batches: Optional[int] = None) -> Optional[Dict]:
    block, what = unit(mode, batches)
    tl = perf.Timeline(T.CAPACITY, device)
    with tl:
        block()
    spans = tl.spans()
    out = {"dropped": tl.dropped, "spans": len(spans), "median_ms": T.medians_ms(spans),
           "batch_host_ms": statistics.median(T.batch_host_ms(spans))}
    T.say(what, out)
    return None if tl.dropped else out
