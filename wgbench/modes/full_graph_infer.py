"""Mode ``full_graph_infer``: the node-classification example's full-graph
evaluation pass, ``model(emb.gather(ids), graph=fg)`` over
``to_full_graph(windowed=True)``, again and again. The plan is made in
set-up; the last pass's logits are compared: ``logit_gap``, the widest gap
between a logit and the reference's over the reference logits' root mean
square, over every node.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from wgbench.check import logit_numbers
from wgbench.program import Mode, _sync
from wgbench.reference.models import full_graph_sage

TRACED = 3  # passes in the traced window
FAULTS: Dict[str, Dict] = {}


class Runner(Mode):
    UNIT = "pass"

    def __init__(self, run):
        super().__init__(run)
        t0 = time.perf_counter()
        self.fg = self.built.graph.to_full_graph(windowed=True)
        self.notes = f", full-graph plan {time.perf_counter() - t0:.3f}"
        n = int(run.cfg["nodes"])
        self.ids = torch.arange(n, dtype=torch.int32, device=self.dev)
        self.logits = None

    def one_pass(self) -> None:
        with torch.no_grad():
            self.logits = self.built.model(self.built.emb.gather(self.ids), graph=self.fg)

    def setup(self) -> None:
        self.reset_peak()
        self.one_pass()
        _sync(self.dev)

    def window(self, seconds: float) -> Dict:
        n, dt = self.whole_passes(seconds)
        self.check = {"logits": self.logits}
        units = n * self.ids.shape[0]
        return {"seconds": dt, "passes": n, "attempted": n, "units": units,
                "infer_nodes_per_s": units / dt}

    def control_record(self) -> Dict:
        return {"logits": self.logits}

    def traced_block(self):
        def block():
            for _ in range(TRACED):
                self.one_pass()
        return block, TRACED

    def one_call(self):
        return self.one_pass

    def representative(self) -> Dict:
        return {}


def reference_record(cfg: Dict, mix: Dict, seed: int, ref: Dict, check: Dict,
                     precision: str = "float32") -> Dict:
    """The reference's logits of every node."""
    return {"logits": full_graph_sage(ref["row_ptr"], ref["col"], ref["features"],
                                      ref["weights"], precision)}


def compare(program: Dict, reference: Dict) -> Dict:
    return logit_numbers([(program["logits"], reference["logits"])])
