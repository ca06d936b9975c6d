"""Sparse (row-wise) embedding optimizers.

Port of ``wholegraph_tpu/embedding/optimizers.py:49-149`` (reference:
cpp/src/wholememory_ops/functions/embedding_optimizer_func.cu: sgd :179,
lazy_adam :332, ada_grad :595, rms_prop :792). Each optimizer updates ONLY
the rows the batch touched: :meth:`SparseOptimizer.update` receives those
rows, their summed gradients and the same rows of each state slot, all
f32 ``[R, D]``, and returns the new rows; the embedding writes them back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import DeviceLike

Slots = Dict[str, torch.Tensor]
# the step an update is for: an int, or its row of step_table on the rows' device
StepLike = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """Base class: a named set of per-row state slots + a row-block update
    (embedding_optimizer_impl_base, embedding_optimizer.hpp:83-123)."""

    name: str = "base"

    @property
    def slot_names(self) -> Tuple[str, ...]:
        return ()

    def update(self, rows: torch.Tensor, grads: torch.Tensor, slots: Slots, step: StepLike,
               lr: float) -> Tuple[torch.Tensor, Slots]:
        raise NotImplementedError

    def step_table(self, steps: Sequence[int], device: DeviceLike) -> torch.Tensor:
        """``[S, k]`` float32 on ``device``: row s holds what :meth:`update`
        computes from the step ``steps[s]``, for a step that a CUDA graph
        replays (``train.train_epoch``), which reads row s on the card and
        passes it to :meth:`update` as ``step``. Empty (k = 0) for an
        optimizer whose update does not depend on the step."""
        return torch.zeros((len(steps), 0), dtype=torch.float32, device=torch.device(device))


@dataclasses.dataclass(frozen=True)
class SGD(SparseOptimizer):
    """SGD with optional weight decay (embedding_optimizer_func.cu:179)."""

    weight_decay: float = 0.0
    name: str = "sgd"

    def update(self, rows, grads, slots, step, lr):
        g = grads + self.weight_decay * rows
        return rows - lr * g, slots


@dataclasses.dataclass(frozen=True)
class LazyAdam(SparseOptimizer):
    """Lazy Adam / AdamW (embedding_optimizer_func.cu:332). Bias correction
    uses the embedding's global step, or that step's row of
    :meth:`step_table` on the card; m/v change only for touched rows."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    adam_w: bool = False
    name: str = "lazy_adam"

    @property
    def slot_names(self):
        return ("m", "v")

    def corrections(self, step: int) -> Tuple[float, float]:
        """The bias corrections ``(1 - beta1^t, 1 - beta2^t)`` of step ``t``,
        in f32 as the JAX package computes them."""
        t = np.float32(step)
        return (float(np.float32(1.0) - np.float32(self.beta1) ** t),
                float(np.float32(1.0) - np.float32(self.beta2) ** t))

    def step_rows(self, steps, card: bool) -> np.ndarray:
        """``[S, 2]`` float32 on the host: the corrections of each step, or
        with ``card`` their f32 reciprocals, which a card multiplies by
        (:meth:`step_table`; kernel L's scalars for an eager step)."""
        rows = np.asarray([self.corrections(int(t)) for t in steps], np.float32).reshape(-1, 2)
        return np.float32(1.0) / rows if card else rows

    def step_table(self, steps, device):
        """Row s: the corrections of ``steps[s]``, computed on the host as
        the eager step computes them. On a card their f32 reciprocals: ATen
        divides a CUDA tensor by a host scalar as a product with the
        scalar's f32 reciprocal, so a product here gives the eager step's
        bits; on the CPU it divides, and so does :meth:`update`."""
        dev = torch.device(device)
        return torch.from_numpy(self.step_rows(steps, dev.type == "cuda")).to(dev)

    def update(self, rows, grads, slots, step, lr):
        g = grads if self.adam_w else grads + self.weight_decay * rows
        m = self.beta1 * slots["m"] + (1.0 - self.beta1) * g
        v = self.beta2 * slots["v"] + (1.0 - self.beta2) * g * g
        if isinstance(step, torch.Tensor):  # a row of step_table, on the rows' device
            if step.is_cuda:
                m_hat, v_hat = m * step[0], v * step[1]
            else:
                m_hat, v_hat = m / step[0], v / step[1]
        else:
            c1, c2 = self.corrections(step)
            m_hat, v_hat = m / c1, v / c2
        upd = m_hat / (torch.sqrt(v_hat) + self.epsilon)
        if self.adam_w:
            upd = upd + self.weight_decay * rows
        return rows - lr * upd, {"m": m, "v": v}


@dataclasses.dataclass(frozen=True)
class RMSProp(SparseOptimizer):
    """RMSProp (embedding_optimizer_func.cu:792)."""

    alpha: float = 0.99
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    name: str = "rms_prop"

    @property
    def slot_names(self):
        return ("v",)

    def update(self, rows, grads, slots, step, lr):
        g = grads + self.weight_decay * rows
        v = self.alpha * slots["v"] + (1.0 - self.alpha) * g * g
        return rows - lr * g / (torch.sqrt(v) + self.epsilon), {"v": v}


@dataclasses.dataclass(frozen=True)
class AdaGrad(SparseOptimizer):
    """AdaGrad (embedding_optimizer_func.cu:595)."""

    epsilon: float = 1e-8
    weight_decay: float = 0.0
    name: str = "ada_grad"

    @property
    def slot_names(self):
        return ("state_sum",)

    def update(self, rows, grads, slots, step, lr):
        g = grads + self.weight_decay * rows
        s = slots["state_sum"] + g * g
        return rows - lr * g / (torch.sqrt(s) + self.epsilon), {"state_sum": s}


_REGISTRY = {
    "sgd": SGD,
    "lazy_adam": LazyAdam,
    "adam": LazyAdam,
    "rms_prop": RMSProp,
    "rmsprop": RMSProp,
    "ada_grad": AdaGrad,
    "adagrad": AdaGrad,
}


def create_optimizer(name: str, **hyper) -> SparseOptimizer:
    """Factory by name (wholememory_create_embedding_optimizer analog)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(set(_REGISTRY))}")
    return _REGISTRY[key](**hyper)
