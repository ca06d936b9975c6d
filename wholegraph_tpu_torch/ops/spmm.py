"""Padded-neighbourhood aggregation for sampled blocks.

Port of the padded regime of ``wholegraph_tpu/ops/spmm.py:35-107``:
``padded_gather_neighbors``, ``padded_reduce`` and ``padded_softmax``.
On the TPU ``padded_reduce`` gathered rows with ``_gather_kernel`` and
summed them in XLA; here sum and mean go through the fused kernel D
(:class:`~wholegraph_tpu_torch.ops.spmm_kernels.NeighborReduce`), and max
stays plain PyTorch, as it was plain XLA.
"""

from __future__ import annotations

import torch

from .gather import local_take
from .spmm_kernels import NeighborReduce


def padded_gather_neighbors(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """x: [U, D] node features; nbr_idx: [B, K] → [B, K, D] (clip)."""
    B, K = nbr_idx.shape
    return local_take(x, nbr_idx.reshape(-1)).reshape(B, K, -1)


def padded_reduce(x: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
                  reduce: str = "mean") -> torch.Tensor:
    """Aggregate neighbour features over the padded K axis.

    x: [U, D], nbr_idx (int32) / mask (bool): [B, K] → [B, D]. ``mean``
    divides by ``max(count, 1)``; ``max`` gives 0 for a row with no valid
    slot."""
    if reduce in ("sum", "mean"):
        return NeighborReduce.apply(x, nbr_idx, mask, reduce == "mean")
    if reduce == "max":
        neigh = padded_gather_neighbors(x, nbr_idx)
        out = torch.where(mask[..., None], neigh, float("-inf")).amax(dim=1)
        return torch.where(mask.any(dim=1, keepdim=True), out, 0.0)
    raise ValueError(f"unknown reduce {reduce!r}")


def padded_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Masked softmax over the padded neighbour axis (GAT attention)."""
    z = torch.where(mask, logits, -1e30)
    z = z - z.amax(dim=dim, keepdim=True).detach()
    e = torch.where(mask, torch.exp(z), 0.0)
    return e / e.sum(dim=dim, keepdim=True).clamp(min=1e-16)
