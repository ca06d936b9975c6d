"""What a per-layer reader is handed: the run, its build, mode and window,
the profiled window, and helpers to time a call by device time at the cell's
own shapes and to count a batch's valid work with the reference's sampler.

A reader ``metrics/<name>.py`` defines ``read(ctx)`` and returns a number,
or None where the cell gives it nothing to read (the harness then leaves
the metric out of the line).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import probe
from ..reference.sampler import multilayer_sample
from .counts import SampleCounts, padded_levels


class ReadContext:
    def __init__(self, run, mode, window: Dict):
        self.run, self.mode, self.window = run, mode, window
        self.cfg, self.mix = run.cfg, run.mix
        self.mode_name = run.mix["mode"]
        self.build, self.built = run.build, run.built
        self.profile: Optional[Dict] = None
        self.kernels_by_graph: Optional[int] = None
        self.kernels_by_profiler: Optional[float] = None
        self.unit_name = mode.UNIT
        self._counts: Optional[SampleCounts] = None
        self._sample = None

    # -- the traced window ------------------------------------------------------

    def trace(self) -> None:
        """The profiled window (the mode's traced block) and the kernels of
        one call counted two ways: the nodes of its
        CUDA graph, and the profiler's kernels over the window per call."""
        block, units = self.mode.traced_block()
        self.profile = probe.profile_window(block)
        if self.profile:
            self.kernels_by_profiler = self.profile["device_events"] / units
        try:
            self.kernels_by_graph = len(probe.graph_kernels(self.mode.one_call()))
        except Exception as exc:  # a body that cannot be captured: say so, count nothing
            self.kernels_by_graph = f"not counted ({type(exc).__name__}: {exc})"[:200]

    def device_s(self, fn: Callable[[], object], n_iters: int = 8) -> Optional[float]:
        """Device seconds of one call of ``fn()`` (:func:`probe.measure_chain`),
        None off the card."""
        if self.run.device.type != "cuda":
            return None
        return probe.measure_chain(lambda i: fn(), n_iters)

    # -- the representative batch ----------------------------------------------

    def representative(self) -> Dict:
        return self.mode.representative()

    def program_sample(self):
        """The port's sample of the representative batch (the inputs of the
        calls a reader times)."""
        if self._sample is None:
            r = self.representative()
            self._sample = self.built.graph.multilayer_sample(r["centers"], self.cfg["fanouts"],
                                                              seed=r["seed"])
        return self._sample

    def counts(self) -> SampleCounts:
        """The representative batch's valid sizes, from the reference's sampler."""
        if self._counts is None:
            r = self.representative()
            inp = self.run.inputs
            s = multilayer_sample(inp["row_ptr"], inp["col"], r["centers"], self.cfg["fanouts"],
                                  r["seed"])
            self._counts = SampleCounts(
                padded=padded_levels(int(r["centers"].shape[0]), self.cfg["fanouts"]),
                levels=[int(l.shape[0]) for l in s.levels],
                slots=[int(h.valid.sum()) for h in s.hops],
                distinct=[int(torch.unique(h.nbrs[h.valid]).shape[0]) for h in s.hops],
                fanouts=list(self.cfg["fanouts"]))
        return self._counts

    def seconds_per_unit(self) -> float:
        """The window's seconds per step, batch or pass."""
        return self.window["seconds"] / self.window["attempted"]

    def close(self) -> None:
        self.run = self.mode = self.build = self.built = self._sample = None
