"""Performance measurement and tracing: a chained-call timer, spans at the
port's layer boundaries, and a ring of device stamps. Import it as
``utils.perf``: ``utils.trace`` is the logger's.

:func:`measure_chain` times a chain of calls by device time where a card
runs them: the calls are captured in one CUDA graph and its replay is timed
by CUDA events, so none of the host's per-call work (checks, allocations,
the launches themselves) is in the time. A one-call graph's time is
differenced out, as the JAX function differences out its one-trip loop.

:func:`span` marks a layer of the running program where its callee does
the work (``with perf.span("gather"): ...``). It costs one check of two
flags while nothing records. Under ``torch.profiler`` it opens a host
range ``wg::<name>``; inside an active :class:`Timeline` it
stamps the card at entry and at exit. A stamp is one launch of a one-thread
kernel (``csrc/stamp.cu``) that reads the card's nanosecond clock, so a
span is timed where it runs, also inside a CUDA graph: a graph captured
inside a Timeline writes its stamps at every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from .device import DeviceLike, resolve_device
from .error import check_input

REPLAYS = 5  # timed replays of each of measure_chain's graphs


def capture_chain(step_fn: Callable, n_calls: int, *args, pool=None) -> "torch.cuda.CUDAGraph":
    """``step_fn(i, *args)`` for ``i`` in ``0..n_calls-1`` captured in one
    CUDA graph on the current card (``pool``: a graph memory pool to
    share). Warm the calls up first: capture launches nothing."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool):
        for i in range(n_calls):
            step_fn(i, *args)
    return g


def _replay_ms(g: "torch.cuda.CUDAGraph", reps: int) -> float:
    """Mean ms of one replay of ``g`` over ``reps`` back to back, by CUDA events."""
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def measure_chain(step_fn: Callable, n_iters: int = 8, *args,
                  device: DeviceLike = "cuda") -> float:
    """Seconds per call of ``step_fn(i, *args)`` in a dependent chain of
    calls (each call's work follows the last's on one stream).

    On a card: one call on a side stream to warm up, then graphs of 1 and
    ``1 + n_iters`` calls (``i`` = 0, 1, ...), each replayed REPLAYS times
    and timed by CUDA events; the one-call graph's time is differenced out.
    On the CPU: the same chains by wall time. The calls must not read the
    device on the host, or the capture fails."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        def chain(n):
            t0 = time.perf_counter()
            for i in range(n):
                step_fn(i, *args)
            return time.perf_counter() - t0

        chain(1)  # warm
        base, full = chain(1), chain(1 + n_iters)
        return max((full - base) / n_iters, 1e-9)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step_fn(0, *args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        base_g = capture_chain(step_fn, 1, *args)
        full_g = capture_chain(step_fn, 1 + n_iters, *args, pool=base_g.pool())
        base, full = _replay_ms(base_g, REPLAYS), _replay_ms(full_g, REPLAYS)
        del base_g, full_g
    return max((full - base) / n_iters / 1e3, 1e-9)


# ---------------------------------------------------------------------------
# Spans and the Timeline of device stamps
# ---------------------------------------------------------------------------

ENTER, EXIT = "enter", "exit"

STAMP = kernels.Kernel(
    "stamp", "stamp.cu", "wg_stamp",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p],
    replaces="none: the Timeline's clock on the card (the JAX package times from the host)",
)

_profiler = torch.autograd.profiler  # its _is_profiler_enabled is True while a profiler records
# a host range of the profiler's function scope: record_function's user scope would also lay
# the range over the card's events (gpu_user_annotation) and count its gaps as busy time
_HostRange = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()  # the one context every span returns while nothing records
_active: Optional["Timeline"] = None  # the Timeline entered, if any


def active_timeline() -> Optional["Timeline"]:
    """The :class:`Timeline` entered (``with tl:``), or None."""
    return _active


def span(name: str):
    """A context that marks the layer ``name`` of the running program.

    While no profiler records and no :class:`Timeline` is active it is one
    shared null context. Under a profiler it opens the host range
    ``wg::<name>`` (on the host only: no range on the card); inside an active
    Timeline it stamps the card (or, on the CPU, the host clock) at entry
    and at exit."""
    if _active is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, _active)


class _Span:
    __slots__ = ("name", "tl", "rf")

    def __init__(self, name: str, tl: Optional["Timeline"]):
        self.name, self.tl, self.rf = name, tl, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = _HostRange("wg::" + self.name)
            self.rf.__enter__()
        if self.tl is not None:
            self.tl.stamp(self.name, ENTER)
        return self

    def __exit__(self, *exc):
        if self.tl is not None:
            self.tl.stamp(self.name, EXIT)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _stamp_plain(buf: torch.Tensor, capacity: int, tag: int) -> None:
    """The stamp kernel's work on the CPU: the host clock as the device's."""
    ns = time.perf_counter_ns()
    slot = int(buf[0, 0])
    buf[0, 0] = slot + 1
    if slot < capacity:
        buf[slot + 1, 0] = tag
        buf[slot + 1, 1] = ns


class SpanTime(NamedTuple):
    """One span as a :class:`Timeline` recorded it: device ns at entry and
    exit, host ``perf_counter_ns`` at each (None where a graph's replay
    wrote the stamp) and its depth among the spans open at its entry."""

    name: str
    start_ns: int
    end_ns: int
    host_start_ns: Optional[int]
    host_end_ns: Optional[int]
    depth: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def pair_spans(rows: Sequence[Tuple[str, str, int, Optional[int]]]) -> List[SpanTime]:
    """Rows ``(name, ENTER or EXIT, device ns, host ns or None)`` in the
    ring's order (:meth:`Timeline.read`, or the same rows on another clock)
    paired into spans, in the order they were entered: each exit closes the
    latest open span of its name. Spans left open are dropped."""
    out: List[Optional[SpanTime]] = []
    stack: List[Tuple[str, int, int, Optional[int]]] = []  # (name, index in out, ns, host)
    for name, phase, ns, host in rows:
        if phase == ENTER:
            stack.append((name, len(out), ns, host))
            out.append(None)
            continue
        for k in range(len(stack) - 1, -1, -1):
            if stack[k][0] == name:
                _, at, ns0, host0 = stack.pop(k)
                out[at] = SpanTime(name, ns0, ns, host0, host, k)
                break
    return [s for s in out if s is not None]


class Timeline:
    """A ring of device stamps that :func:`span` writes while the Timeline
    is entered (``with tl: ...``).

    Each stamp writes ``(tag, ns)`` at a cursor that the card advances: the
    tag names the span, whether it entered or left, and the host's own
    ``perf_counter_ns`` at that moment by its index in :attr:`host_ns` (no
    index for a stamp recorded into a CUDA graph: each replay writes one
    with no host clock). A full ring writes nothing more and counts what it
    dropped (:attr:`dropped`, after :meth:`read`). On the CPU the device
    clock is ``perf_counter_ns``. A CUDA graph captured inside a Timeline
    writes into its ring at every replay, so it must be replayed only
    inside it (``train.train_epoch`` captures again when the active
    Timeline changes)."""

    def __init__(self, capacity: int = 1 << 16, device: DeviceLike = "cuda"):
        check_input(capacity > 0, f"capacity must be positive, got {capacity}")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        # row 0 holds the cursor; the ring is rows 1..capacity
        self.buf = torch.zeros((self.capacity + 1, 2), dtype=torch.int64, device=self.device)
        self.names: List[str] = []
        self._codes: Dict[str, int] = {}
        self.host_ns: List[int] = []
        self.dropped = 0
        self._outer: Optional[Timeline] = None

    def __enter__(self) -> "Timeline":
        global _active
        check_input(_active is not self, "this Timeline is active already")
        self._outer, _active = _active, self
        return self

    def __exit__(self, *exc) -> bool:
        global _active
        _active, self._outer = self._outer, None
        return False

    def stamp(self, name: str, phase: str) -> None:
        """Stamp ``name``'s entry (``ENTER``) or exit (``EXIT``) on the
        current stream of the Timeline's device."""
        code = self._codes.get(name)
        if code is None:
            code = self._codes[name] = len(self.names)
            self.names.append(name)
        tag = 2 * code + (phase == EXIT)
        cuda = self.device.type == "cuda"
        if not (cuda and torch.cuda.is_current_stream_capturing()):
            self.host_ns.append(time.perf_counter_ns())
            tag |= len(self.host_ns) << 32  # the host clock's index, plus one
        if cuda:
            STAMP(self.buf.data_ptr(), self.capacity, tag, kernels.cuda_stream(self.device))
        else:
            _stamp_plain(self.buf, self.capacity, tag)

    def read(self) -> List[Tuple[str, str, int, Optional[int]]]:
        """Every stamp written so far, in the ring's order: ``(name, ENTER
        or EXIT, device ns, host ns or None)``. Copies the ring back once
        (waiting for the card) and sets :attr:`dropped`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        buf = self.buf.cpu()
        asked = int(buf[0, 0])
        self.dropped = max(asked - self.capacity, 0)
        rows = []
        for tag, ns in buf[1:1 + min(asked, self.capacity)].tolist():
            code, host = tag & 0xFFFFFFFF, tag >> 32
            rows.append((self.names[code >> 1], EXIT if code & 1 else ENTER, ns,
                         self.host_ns[host - 1] if host else None))
        return rows

    def spans(self) -> List[SpanTime]:
        """:meth:`read`'s stamps paired into spans (:func:`pair_spans`)."""
        return pair_spans(self.read())

    def durations(self) -> Dict[str, List[float]]:
        """Device ms of every closed span, by name, in the order entered."""
        out: Dict[str, List[float]] = {}
        for s in self.spans():
            out.setdefault(s.name, []).append(s.ms)
        return out
