"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names cells, configurations, traffic mixes and metrics; each part is a
file of its own under ``wgbench/``:

- configuration ``<c>``: ``configs/<c>.json``, whose required ``build``
  names a build ``<b>``: ``builds/<b>.py``, which makes the cell's inputs
  from the seed, builds the port's objects and counts the whole step's
  operations (:mod:`wgbench.program`);
- traffic mix ``<t>``: ``workloads/<t>.json``, whose ``mode`` names a
  mode ``<m>``: ``modes/<m>.py``, its runner, reference and comparison
  (:mod:`wgbench.program`);
- per-layer metric ``<m>``: ``metrics/<m>.py``, a module with
  ``read(ctx)`` that returns a number or None;
- the correctness limits of cell ``<w>``: ``limits/<w>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def root_of(here: str = HERE) -> str:
    return os.path.dirname(here)


def load_benchmark(root: Optional[str] = None) -> Dict:
    with open(os.path.join(root or root_of(), "BENCHMARK.json")) as f:
        return json.load(f)


def _json(here: str, sub: str, name: str) -> Dict:
    path = os.path.join(here, sub, f"{name}.json")
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` and every part it names."""

    def __init__(self, bench: Dict, name: str, here: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.here = here
        self.config = _json(here, "configs", self.entry["config"])
        if "build" not in self.config:
            raise ValueError(f"configs/{self.entry['config']}.json has no 'build' key: it "
                             f"must name the build (builds/<build>.py) that makes its inputs "
                             f"and objects")
        self.mix = _json(here, "workloads", self.entry["traffic"])
        self.limits = _json(here, "limits", name)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def mode(self):
        """The module of ``modes/<mode>.py``, the mode the cell's mix names."""
        from .program import load_mode
        return load_mode(self.mix["mode"], self.here)

    def build(self):
        """The module of ``builds/<build>.py``, the build the cell's
        configuration names."""
        from .program import load_build
        return load_build(self.config["build"], self.here)

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "wgbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def cells(bench: Dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]
