"""Local row take / write / add on one device.

Port of the single-shard part of ``wholegraph_tpu/ops/gather.py``:
``local_take`` (``gather.py:92-152``), ``local_write`` and ``local_add``
(``:155-169``). The multi-device exchange is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .gather_kernels import gather_rows


class _LocalTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, slots):
        ctx.save_for_backward(slots)
        ctx.shard_shape = shard.shape
        ctx.shard_dtype = shard.dtype
        return gather_rows(shard, slots)

    @staticmethod
    def backward(ctx, ct):
        (slots,) = ctx.saved_tensors
        n = ctx.shard_shape[0]
        clipped = slots.long().clamp(0, n - 1)
        dshard = torch.zeros(ctx.shard_shape, dtype=ct.dtype, device=ct.device)
        dshard.index_add_(0, clipped, ct)
        return dshard.to(ctx.shard_dtype), None


def local_take(shard: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[i] = shard[clip(slots[i])]`` for a [N, D] shard (kernel A on
    CUDA). Differentiable in ``shard``: the backward is the matching
    scatter-add (``index_add_``, as XLA's scatter-add is on the TPU)."""
    return _LocalTake.apply(shard, slots)


def _drop_masked(shard: torch.Tensor, slots: torch.Tensor, mask: Optional[torch.Tensor]):
    keep = (slots >= 0) & (slots < shard.shape[0])
    if mask is not None:
        keep &= mask
    return keep


def local_write(shard: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy of ``shard`` with ``rows`` written at ``slots``; out-of-range
    slots and ``mask=False`` rows are dropped (scatter_func_kernel analog)."""
    keep = _drop_masked(shard, slots, mask)
    out = shard.clone()
    out[slots[keep].long()] = rows.reshape(rows.shape[0], *shard.shape[1:])[keep].to(shard.dtype)
    return out


def local_add(shard: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy of ``shard`` with ``rows`` added at ``slots`` (duplicates
    accumulate); out-of-range slots and ``mask=False`` rows are dropped."""
    keep = _drop_masked(shard, slots, mask)
    rows = rows.reshape(rows.shape[0], *shard.shape[1:]).to(shard.dtype)
    return shard.clone().index_add_(0, slots[keep].long(), rows[keep])
