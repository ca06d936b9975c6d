"""What decides ``correct``: the port's outputs of the timed path against
the plain reference (:mod:`wgbench.reference`), which works everything out
again from inputs it makes itself from the seed.

Each mode's file (``modes/<mode>.py``) says what its runner keeps, what
the reference produces in its place and which numbers the two give; a
cell compares those numbers that ``limits/<cell>.json`` gives a limit,
each held to it. ``precision="tf32"`` runs the reference with its
products rounded to TF32: the control, which the limits must fail.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, Tuple

import torch

from .reference.steps import logit_gap


def logit_numbers(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> Dict:
    """``logit_gap``, the widest over the pairs of (port, reference) logits,
    and where each pair parts."""
    gap = max((logit_gap(p, r) for p, r in pairs), default=math.inf)
    return {"numbers": {"logit_gap": gap}, "rows": [wide_rows(p, r) for p, r in pairs]}


def wide_rows(program: torch.Tensor, reference: torch.Tensor, share: float = 1e-4) -> Dict:
    """Where two sets of logits part: the rows whose widest gap passes
    ``share`` of the reference's root mean square, and the first of them."""
    ref = reference.to(torch.float64)
    rms = float(ref.pow(2).mean().sqrt())
    gap = (program.to(torch.float64) - ref).abs().amax(dim=1) / max(rms, 1e-30)
    rows = torch.nonzero(gap > share)[:, 0]
    return {"rows": int(rows.numel()), "of": int(gap.numel()), "first": rows[:5].tolist()}


def reference_numbers(mode: ModuleType, build: ModuleType, cfg: Dict, mix: Dict, seed: int,
                      check: Dict, dev, precision: str = "float32", **fault) -> Dict:
    """The numbers of ``check`` (what the timed path produced) against the
    reference, with TF32 off whatever the caller set, from inputs it makes
    again from the seed by the cell's build (its ``make_inputs``).
    ``precision`` and ``fault`` change the reference (the control's
    readings)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = build.make_inputs(cfg, seed, dev)
        return mode.compare(check, mode.reference_record(cfg, mix, seed, ref, check, precision,
                                                         **fault))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict, Dict]:
    """``correct``, each number the cell compares beside its limit, and the
    numbers it does not compare (those without a limit in its file). A
    compared number must be present, finite and at most its limit."""
    checks, ok = {}, True
    for name, lim in limits.items():
        value = numbers.get(name, math.inf)
        ok &= math.isfinite(value) and value <= lim
        checks[name] = {"value": value, "limit": lim}
    return ok, checks, {k: v for k, v in numbers.items() if k not in limits}
