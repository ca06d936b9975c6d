"""The system under test: how a cell finds its build and its mode, and the
common parts of the runners of the traffic modes.

A build is a file of its own, ``builds/<build>.py``, found by the name a
configuration gives under ``build`` (:func:`load_build`). It defines

- ``make_inputs(cfg, seed, device)``: every input of a run, made on
  ``device`` from the seed, the same again for the same seed; a dict that
  holds at least ``labels`` (a label a node) and ``splits`` (node ids by
  split name), which :class:`Mode` and the traffic read, and whatever else
  the build's objects, modes and reference need;
- ``Built(cfg, mix, inputs, device)``: the port's objects made from the
  inputs, with ``times`` (seconds by part of the build, for the set-up's
  line) and ``leaves()`` (the trained parameters under the reference's
  names);
- ``train_flops(ctx)`` and ``infer_flops(ctx)``: the valid operations of
  the representative training step, or of the inference batch or pass, of
  the cell that a reader's ``ctx`` holds, or None where the build does not
  count the cell's mode;
- ``tiny(cfg)``: the configuration shrunk for runs on the CPU in tests.

A mode is a file of its own, ``modes/<mode>.py``, found by the name a mix
gives under ``mode`` (:func:`load_mode`). It defines

- ``Runner``, a :class:`Mode`: the mode's set-up (its checked first steps,
  where it trains, and its warm-up), its measured window, its traced
  window, and what the comparison with the reference reads (``check``);
- ``reference_record(cfg, mix, seed, ref, check, precision, **fault)``:
  what the plain reference produces where ``check`` holds the port's;
- ``compare(program, reference)``: the numbers of one record against the
  other, ``{"numbers": {...}}`` and whatever a look at them needs;
- ``FAULTS``: named keyword sets of ``reference_record`` that plant a fault
  in the reference, for :mod:`wgbench.control` (may be empty).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time
from types import ModuleType
from typing import Dict

import torch

from .traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load(sub: str, name: str, here: str) -> ModuleType:
    """The module of ``<sub>/<name>.py`` under ``here``, loaded once a path."""
    path = os.path.join(here, sub, f"{name}.py")
    key = f"wgbench_{sub}_{name}_" + format(abs(hash(path)), "x")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def load_mode(name: str, here: str = HERE) -> ModuleType:
    """The module of ``modes/<name>.py`` under ``here``."""
    return _load("modes", name, here)


def load_build(name: str, here: str = HERE) -> ModuleType:
    """The module of ``builds/<name>.py`` under ``here``."""
    return _load("builds", name, here)


def Built(cfg: Dict, mix: Dict, inputs: Dict, device):
    """The port's objects of the build that ``cfg`` names (``builds/`` of
    this package), made from ``inputs``."""
    return load_build(cfg["build"]).Built(cfg, mix, inputs, device)


class Mode:
    """Common parts of a runner; ``self.check`` holds what the comparison
    reads. ``UNIT`` names what the window counts as ``attempted`` (a step,
    a batch, a pass); ``notes`` adds to the set-up's line."""

    UNIT = "call"
    notes = ""

    def __init__(self, run):
        self.run = run
        self.built = run.built
        self.dev: torch.device = run.device
        split = run.mix.get("split")
        self.traffic = (Traffic(run.mix, run.seed, run.inputs["splits"][split],
                                run.inputs["labels"]) if split else None)
        self.check: Dict = {}

    def reset_peak(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)

    def whole_passes(self, seconds: float):
        """``one_pass`` again and again, the card synchronised after each,
        until ``seconds`` have passed: ``(passes, seconds taken)``."""
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.one_pass()
            _sync(self.dev)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                return n, time.perf_counter() - t0

    def control_record(self) -> Dict:
        """What the comparison reads, from a run of set-up alone (and, where
        the mode compares the window's outputs, the calls that make them)."""
        return self.check
