"""The system under test: the port's objects built from the benchmark's
inputs, and the common parts of the runners of the traffic modes.

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


def load_mode(name: str, here: str = HERE) -> ModuleType:
    """The module of ``modes/<name>.py`` under ``here``, loaded once a path."""
    path = os.path.join(here, "modes", f"{name}.py")
    key = "wgbench_mode_" + name + "_" + format(abs(hash(path)), "x")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


class Built:
    """The port's graph, table, model, dense optimizer and training state."""

    def __init__(self, cfg: Dict, mix: Dict, inputs: Dict, device: torch.device):
        marks = [time.perf_counter()]
        from wholegraph_tpu_torch.embedding import Embedding, create_optimizer
        from wholegraph_tpu_torch.graph import GraphStructure
        from wholegraph_tpu_torch.models import HomoGNN
        from wholegraph_tpu_torch.train import SageTrainConfig, SageTrainState

        self.cfg, self.mix, self.device = cfg, mix, device
        n, dim = int(cfg["nodes"]), int(cfg["feat_dim"])
        row_ptr, col = inputs["row_ptr"], inputs["col"]
        self.max_degree = int((row_ptr[1:] - row_ptr[:-1]).max())
        marks.append(time.perf_counter())
        self.graph = GraphStructure(row_ptr, col, n, max_degree=self.max_degree)
        opt = create_optimizer(cfg["embedding_optimizer"])
        self.emb = Embedding(n, dim, opt, torch.float32, device, table=inputs["features"])
        marks.append(time.perf_counter())
        heads = int(cfg.get("heads", 1))
        self.model = HomoGNN(dim, int(cfg["hidden"]), int(cfg["num_classes"]),
                             num_layers=int(cfg["num_layers"]), dropout=float(cfg["dropout"]),
                             aggregator="mean", model_type=cfg["model"], num_heads=heads,
                             device=device)
        with torch.no_grad():
            for conv, wt in zip(self.model.convs, inputs["weights"]):
                conv.proj.weight.copy_(wt["w"].t())
                if cfg["model"] == "sage":
                    conv.proj.bias.copy_(wt["b"])
                else:
                    conv.attn_src.copy_(wt["attn_src"])
                    conv.attn_dst.copy_(wt["attn_dst"])
        marks.append(time.perf_counter())
        self.dense_opt = torch.optim.Adam(self.model.parameters(), lr=float(cfg["lr"]),
                                          capturable=device.type == "cuda")
        elr = cfg.get("embedding_lr")
        tcfg = SageTrainConfig(
            n_nodes=n, dim=dim, hidden=int(cfg["hidden"]), num_classes=int(cfg["num_classes"]),
            batch=int(mix["batch"]) if "batch" in mix else 1, fanouts=tuple(cfg["fanouts"]),
            lr=float(cfg["lr"]), model_type=cfg["model"], num_heads=heads,
            train_embedding=bool(cfg["train_embedding"]),
            embedding_lr=None if elr is None else float(elr),
            embedding_optimizer=cfg["embedding_optimizer"])
        self.state = SageTrainState(tcfg, self.graph, self.emb, self.model, self.dense_opt,
                                    inputs["labels"])
        marks.append(time.perf_counter())
        self.times = dict(zip(("imports", "graph and table", "model", "optimizer"),
                              (b - a for a, b in zip(marks, marks[1:]))))

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The model's parameters under the reference's leaf names."""
        out = {}
        for i, conv in enumerate(self.model.convs):
            out[f"{i}.w"] = conv.proj.weight
            if self.cfg["model"] == "sage":
                out[f"{i}.b"] = conv.proj.bias
            else:
                out[f"{i}.attn_src"] = conv.attn_src
                out[f"{i}.attn_dst"] = conv.attn_dst
        return out


class Mode:
    """Common parts of a runner; ``self.check`` holds what the comparison
    reads. ``UNIT`` names what the window counts as ``attempted`` (a step,
    a batch, a pass); ``notes`` adds to the set-up's line."""

    UNIT = "call"
    notes = ""

    def __init__(self, run):
        self.run = run
        self.built: Built = run.built
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
