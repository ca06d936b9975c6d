"""Plain training steps and inference of the reference, from the inputs the
benchmark made (:mod:`wgbench.inputs`) and nothing of the port.

A training step: sample, take the rows of the last level, the forward and
cross-entropy, the gradients, then Adam on the dense weights (PyTorch's
defaults: betas 0.9, 0.999, eps 1e-8) and, where the table is trained,
LazyAdam on the rows the step touched (the same constants; m and v change
only on those rows; both bias-corrected by the global step, 1-based).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from . import models
from .sampler import multilayer_sample

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Trainer:
    """The reference's model, its dense Adam state and, with ``table``, a
    trained table under LazyAdam. ``history`` keeps what the comparison
    reads: each step's loss, the first step's gradient norm of every leaf,
    and every leaf's initial value."""

    def __init__(self, cfg: Dict, weights: List[Dict[str, torch.Tensor]], row_ptr, col,
                 features: torch.Tensor, precision: str = "float32"):
        self.cfg, self.row_ptr, self.col = cfg, row_ptr, col
        self.precision = precision
        self.weights = [{k: v.clone().requires_grad_() for k, v in wt.items()} for wt in weights]
        self.init = {name: p.detach().clone() for name, p in self.leaves().items()}
        self.m = {name: torch.zeros_like(p) for name, p in self.leaves().items()}
        self.v = {name: torch.zeros_like(p) for name, p in self.leaves().items()}
        self.table = features
        self.train_table = bool(cfg["train_embedding"])
        if self.train_table:
            self.table_m = torch.zeros_like(features)
            self.table_v = torch.zeros_like(features)
            self.touched = torch.zeros(features.shape[0], dtype=torch.bool, device=features.device)
            self.table_init_rows: Dict[int, torch.Tensor] = {}
        self.t = 0
        self.losses: List[float] = []
        self.first_grad_norms: Optional[Dict[str, float]] = None

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {f"{i}.{k}": p for i, wt in enumerate(self.weights) for k, p in wt.items()}

    def step(self, centres: torch.Tensor, labels: torch.Tensor, seed: int) -> None:
        cfg = self.cfg
        s = multilayer_sample(self.row_ptr, self.col, centres, cfg["fanouts"], seed)
        ids = s.levels[-1]
        x = self.table[ids].clone()
        if self.train_table:
            x.requires_grad_()
            new = ids[~self.touched[ids]]
            if new.numel():  # the rows as they were before their first update
                self.table_init_rows[len(self.table_init_rows)] = (new, self.table[new].clone())
        logits = models.sampled_forward(cfg["model"], self.weights, s, x, self.precision)
        loss = models.cross_entropy(logits, labels)
        leaves = self.leaves()
        grads = torch.autograd.grad(loss, list(leaves.values()) + ([x] if self.train_table else []))
        self.t += 1
        self.losses.append(float(loss.detach()))
        norms = {name: float(g.norm()) for name, g in zip(leaves, grads)}
        if self.train_table:
            norms["table"] = float(grads[-1].norm())
        if self.first_grad_norms is None:
            self.first_grad_norms = norms
        c1, c2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        lr = float(cfg["lr"])
        with torch.no_grad():
            for (name, p), g in zip(leaves.items(), grads):
                self.m[name].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                self.v[name].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                denom = (self.v[name] / c2).sqrt() + EPS
                p -= lr * (self.m[name] / c1) / denom
            if self.train_table:
                g = grads[-1]
                elr = float(cfg["embedding_lr"])
                m = self.table_m[ids].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v = self.table_v[ids].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                self.table_m[ids], self.table_v[ids] = m, v
                self.table[ids] -= elr * (m / c1) / ((v / c2).sqrt() + EPS)
                self.touched[ids] = True

    def change_norms(self) -> Dict[str, float]:
        """Each leaf's distance from its initial value, the table's over the
        rows the steps touched."""
        out = {name: float((p.detach() - self.init[name]).norm())
               for name, p in self.leaves().items()}
        if self.train_table:
            sq = 0.0
            for ids, rows in self.table_init_rows.values():
                sq += float(((self.table[ids] - rows) ** 2).sum())
            out["table"] = math.sqrt(sq)
        return out


@torch.no_grad()
def infer_batch(cfg: Dict, weights, row_ptr, col, features, centres: torch.Tensor, seed: int,
                precision: str = "float32") -> torch.Tensor:
    """Logits of ``centres`` from one sampled evaluation batch."""
    s = multilayer_sample(row_ptr, col, centres, cfg["fanouts"], seed)
    return models.sampled_forward(cfg["model"], weights, s, features[s.levels[-1]], precision)


def logit_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap between the two logits, over the reference logits'
    root mean square."""
    ref = reference.to(torch.float64)
    rms = float(ref.pow(2).mean().sqrt())
    return float((program.to(torch.float64) - ref).abs().max()) / max(rms, 1e-30)


def norm_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf ``|program norm - reference norm| / max(reference norm,
    median reference norm)`` over ``leaves``."""
    refs = sorted(reference[k] for k in leaves)
    med = refs[len(refs) // 2] if len(refs) % 2 else 0.5 * (refs[len(refs) // 2 - 1] + refs[len(refs) // 2])
    return {k: abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in leaves}


def counted_leaves(first_grads: Dict[str, float], rule: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    ``rule`` times the median leaf's."""
    vals = sorted(first_grads.values())
    med = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
    return [k for k, v in first_grads.items() if v >= rule * med]
