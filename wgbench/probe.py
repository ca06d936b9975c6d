"""How the harness reads the device: device time of a chain of calls, the
kernel launches of one call, and a profiled window.

:func:`measure_chain` and :func:`graph_kernels` are frozen copies of the
port's ``utils.perf.measure_chain`` and of ``chip_smoke.py``'s
``graph_kernels``, kept here so that the yardstick does not move with the
program. :func:`profile_window` runs a block under ``torch.profiler`` and
reduces its trace to busy time, device operations by name and idle gaps by
what the host was doing.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, List, Optional

import torch

REPLAYS = 5


def _capture(step_fn: Callable, n_calls: int, pool=None) -> "torch.cuda.CUDAGraph":
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool):
        for i in range(n_calls):
            step_fn(i)
    return g


def _replay_ms(g: "torch.cuda.CUDAGraph", reps: int) -> float:
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def measure_chain(step_fn: Callable, n_iters: int = 8) -> float:
    """Device seconds per call of ``step_fn(i)``: one call on a side stream
    to warm up, then CUDA graphs of 1 and ``1 + n_iters`` calls, each
    replayed :data:`REPLAYS` times and timed by CUDA events; the one-call
    graph's time is differenced out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_fn(0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    base_g = _capture(step_fn, 1)
    full_g = _capture(step_fn, 1 + n_iters, pool=base_g.pool())
    base, full = _replay_ms(base_g, REPLAYS), _replay_ms(full_g, REPLAYS)
    del base_g, full_g
    return max((full - base) / n_iters / 1e3, 1e-9)


def graph_kernels(fn: Callable) -> List[str]:
    """The kernel launches of one call of ``fn()``, by name: the call run
    once, then captured in a CUDA graph whose kernel nodes are read back
    through libcuda (cuGraphGetNodes, cuFuncGetName)."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} returned CUresult {rc}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = vp(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_uint8 * 128)()  # CUDA_KERNEL_NODE_PARAMS_v2
        call("cuGraphKernelNodeGetParams_v2", vp(node), params)
        func = vp.from_buffer(params, 0).value
        name = ctypes.c_char_p()
        if func:
            call("cuFuncGetName", ctypes.byref(name), vp(func))
        else:
            call("cuKernelGetName", ctypes.byref(name), vp(vp.from_buffer(params, 56).value))
        names.append(name.value.decode())
    graph.reset()
    return names


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(device_events: List[tuple], host_events: List[tuple], top: int = 10) -> Dict:
    """From device events ``(name, start_us, end_us)`` and host events of the
    same clock: busy seconds (the union of the device intervals), the device
    operations that took most time, and the idle gaps between device work,
    summed by the innermost host operation under way when each began."""
    merged = _merge([(s, e) for _, s, e in device_events])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for name, s, e in device_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps: Dict[str, float] = {}
    hosts = sorted(host_events, key=lambda h: h[1])
    active: List[tuple] = []
    at = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):  # gaps in ascending order: one sweep
        while at < len(hosts) and hosts[at][1] <= e0:
            active.append(hosts[at])
            at += 1
        active = [h for h in active if h[2] >= e0]
        inner = min(active, key=lambda h: h[2] - h[1]) if active else None
        key = inner[0] if inner else "no host operation"
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0)
    return {
        "busy_s": busy_us / 1e6,
        "device_ops": [[n, v / 1e6] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, v / 1e6] for n, v in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
        "device_events": len(device_events),
    }


def profile_window(block: Callable[[], None]) -> Optional[Dict]:
    """``block()`` under ``torch.profiler`` (host and card), the card
    synchronised before and after. Returns :func:`reduce_trace`'s reading
    with ``window_s``, the host clock over the block, or None where the
    trace holds no device operation."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((ev.name, tr.start, tr.end))
        elif ev.device_type == torch.autograd.DeviceType.CPU:
            host.append((ev.name, tr.start, tr.end))
    if not dev:
        return None
    out = reduce_trace(dev, host)
    out["window_s"] = window_s
    return out
