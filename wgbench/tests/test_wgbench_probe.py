"""The reduction of a profiled window to busy time, device operations and
idle gaps, on a hand-made trace."""

import pytest

from wgbench.probe import reduce_trace


def test_reduce_trace_by_hand():
    # device: [0, 10] k1, [5, 12] k2 (overlaps), [20, 30] k1, [35, 36] memcpy
    dev = [("k1", 0, 10), ("k2", 5, 12), ("k1", 20, 30), ("memcpy", 35, 36)]
    # host: a launch spans the first gap's start (12) inside a longer step; nothing at 30
    host = [("step", 0, 25), ("cudaGraphLaunch", 11, 14), ("sync", 31, 40)]
    r = reduce_trace(dev, host)
    assert r["busy_s"] == pytest.approx((12 + 10 + 1) / 1e6)
    assert r["device_ops"][0] == ["k1", pytest.approx(20 / 1e6)]
    assert [n for n, _ in r["device_ops"]] == ["k1", "k2", "memcpy"]
    gaps = dict((n, v) for n, v in r["idle_gaps"])
    assert gaps == {"cudaGraphLaunch": pytest.approx(8 / 1e6),
                    "no host operation": pytest.approx(5 / 1e6)}
    assert r["device_events"] == 4
