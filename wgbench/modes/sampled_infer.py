"""Mode ``sampled_infer``: the node-classification example's sampled
evaluation body (``multilayer_sample``, ``gather_features``, the model, its
loss and accuracy) under ``torch.no_grad``, over the split a batch at a
time; batch ``i``'s sampler seed is the traffic's.

The logits of ``compare_batches`` batches, drawn from the seed among the
first ``compare_from_first``, are kept and compared: ``logit_gap``, the
widest gap between a logit and the reference's, over the reference logits'
root mean square, over the kept batches. A compared batch that the window
did not reach is late, not wrong: it runs after the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from wgbench.check import logit_numbers
from wgbench.program import Mode, _sync
from wgbench.reference import steps as R
from wgbench.traffic import Traffic

WARM = 3  # batches run in set-up
TRACED = 50  # batches in the traced window
FAULTS: Dict[str, Dict] = {}


class Runner(Mode):
    UNIT = "batch"

    def __init__(self, run):
        super().__init__(run)
        k, first = int(run.mix["compare_batches"]), int(run.mix["compare_from_first"])
        from wgbench.inputs import generator
        g = generator(run.seed, "traffic", "cpu", 0xC0)
        self.compare = sorted(torch.randperm(first, generator=g)[:k].tolist())
        self.saved: Dict[int, torch.Tensor] = {}

    def body(self, c: torch.Tensor, y: torch.Tensor, seed: int):
        from wholegraph_tpu_torch.models import accuracy, cross_entropy_loss
        from wholegraph_tpu_torch.train import gather_features

        b = self.built
        ml = b.graph.multilayer_sample(c, b.cfg["fanouts"], seed=seed)
        rows = gather_features(b.state, ml.unique_gids)
        logits = b.model(rows * ml.unique_mask[:, None], ml)
        return logits, cross_entropy_loss(logits, y), accuracy(logits, y)

    def setup(self) -> None:
        self.reset_peak()
        with torch.no_grad():
            for i in range(WARM):
                c, y = self.traffic.batch_at(i)
                self.body(c, y, self.traffic.sampler_seed(i))
        _sync(self.dev)
        self.next = 0

    def run_batches(self, count: Optional[int], seconds: Optional[float], events: bool) -> Dict:
        tr = self.traffic
        evs: List = []
        losses = []
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        with torch.no_grad():
            while True:
                i = self.next
                if events:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    evs.append(ev)
                c, y = tr.batch_at(i)
                logits, loss, acc = self.body(c, y, tr.sampler_seed(i))
                losses.append(torch.stack([loss, acc]))
                if i in self.compare and i not in self.saved:
                    self.saved[i] = logits.clone()
                self.next += 1
                n += 1
                if count is not None and n >= count:
                    break
                if seconds is not None and time.perf_counter() - t0 >= seconds:
                    break
            if events:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                evs.append(end)
            torch.stack(losses).mean(dim=0)  # the example's means over the batches
        _sync(self.dev)
        dt = time.perf_counter() - t0
        out = {"seconds": dt, "batches": n, "attempted": n, "units": n * tr.batch,
               "infer_nodes_per_s": n * tr.batch / dt}
        if events:
            ms = sorted(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))
            out["infer_batch_ms_p95"] = ms[max(0, -(-95 * len(ms) // 100) - 1)]
            out["batch_ms_median"] = ms[len(ms) // 2]
        return out

    def window(self, seconds: float) -> Dict:
        self.next = 0
        out = self.run_batches(None, seconds, events=self.dev.type == "cuda")
        late = max(self.compare) + 1 - self.next
        if late > 0:  # compared batches the window did not reach: run after it closes, untimed
            self.run_batches(late, None, events=False)
        self.check = {"saved": self.saved}
        return out

    def control_record(self) -> Dict:
        self.next = 0
        self.run_batches(int(self.run.mix["compare_from_first"]), None, events=False)
        return {"saved": self.saved}

    def traced_block(self):
        return (lambda: self.run_batches(TRACED, None, events=False)), TRACED

    def one_call(self):
        c, y = self.traffic.batch_at(0)
        seed = self.traffic.sampler_seed(0)

        def call():
            with torch.no_grad():
                self.body(c, y, seed)
        return call

    def representative(self) -> Dict:
        c, y = self.traffic.batch_at(0)
        return {"centers": c, "labels": y, "seed": self.traffic.sampler_seed(0)}


def reference_record(cfg: Dict, mix: Dict, seed: int, ref: Dict, check: Dict,
                     precision: str = "float32") -> Dict:
    """The reference's logits of the batches ``check`` kept."""
    tr = Traffic(mix, seed, ref["splits"][mix["split"]], ref["labels"])
    return {"saved": {i: R.infer_batch(cfg, ref["weights"], ref["row_ptr"], ref["col"],
                                       ref["features"], tr.batch_at(i)[0], tr.sampler_seed(i),
                                       precision)
                      for i in check["saved"]}}


def compare(program: Dict, reference: Dict) -> Dict:
    return logit_numbers([(program["saved"][i], reference["saved"][i])
                          for i in program["saved"]])
