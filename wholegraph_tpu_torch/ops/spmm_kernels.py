"""Fused masked neighbour sum / mean: kernel D.

The counterpart of ``wholegraph_tpu/ops/spmm_pallas.py``'s
``fused_padded_sum``. :func:`neighbor_reduce` is the wrapper: on CUDA
tensors it launches ``csrc/neighbor_agg.cu`` or raises; on CPU tensors it
runs :func:`neighbor_reduce_plain`. :class:`NeighborReduce` gives it a
gradient, the scatter-add over edges of ``spmm_pallas._fps_bwd``
(``spmm_pallas.py:146-158``), on either device.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils.error import check_input
from .gather_kernels import on_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

NEIGHBOR_AGG = kernels.Kernel(
    "neighbor_agg", "neighbor_agg.cu", "wg_neighbor_agg",
    [_P, _L, _L, _P, _P, _P, _L, _L, _I, _I, _I, _P],
    replaces="wholegraph_tpu/ops/spmm_pallas.py:42",  # _fused_agg_kernel
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def neighbor_reduce_plain(x: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
                          mean: bool) -> torch.Tensor:
    """``sum_k mask[b, k] * x[clip(nbr_idx[b, k])]`` in f32, divided by
    ``max(count, 1)`` for the mean, returned in x's dtype."""
    idx = nbr_idx.long().clamp(0, x.shape[0] - 1)
    s = torch.where(mask[..., None], x[idx].float(), 0.0).sum(dim=1)
    if mean:
        s = s / mask.sum(dim=1, keepdim=True).clamp(min=1).float()
    return s.to(x.dtype)


def neighbor_reduce(x: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
                    mean: bool) -> torch.Tensor:
    """Masked neighbour sum (or mean) of ``x`` [U, D] over a padded
    ``nbr_idx``/``mask`` [B, K] block → [B, D] in x's dtype. No gradient: see
    :class:`NeighborReduce`."""
    check_input(x.dim() == 2, f"x must be [U, D], got {tuple(x.shape)}")
    check_input(nbr_idx.dim() == 2 and nbr_idx.dtype == torch.int32, "nbr_idx must be [B, K] int32")
    check_input(mask.shape == nbr_idx.shape and mask.dtype == torch.bool, "mask must be bool like nbr_idx")
    check_input(x.dtype in _DTYPE_CODE, f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    B, K = nbr_idx.shape
    D = x.shape[1]
    if B == 0 or D == 0:
        return torch.zeros((B, D), dtype=x.dtype, device=x.device)
    check_input(x.shape[0] > 0, "reduce over an empty x")
    if not on_cuda(x, nbr_idx, mask):
        return neighbor_reduce_plain(x, nbr_idx, mask, mean)
    if K == 0:
        return torch.zeros((B, D), dtype=x.dtype, device=x.device)
    check_input(x.is_contiguous(), "x must be contiguous")
    nbr_idx, mask = nbr_idx.contiguous(), mask.contiguous()
    out = torch.empty((B, D), dtype=x.dtype, device=x.device)
    wide = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 and D % wide == 0
    NEIGHBOR_AGG(x.data_ptr(), x.shape[0], D, nbr_idx.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), B, K, int(mean), _DTYPE_CODE[x.dtype],
                 wide if aligned else 1, kernels.cuda_stream(x.device))
    return out


class NeighborReduce(torch.autograd.Function):
    """Differentiable :func:`neighbor_reduce`. The backward scatters each
    edge's output cotangent (scaled by 1/count for the mean) onto its
    neighbour row: ``dx[nbr[b, k]] += mask[b, k] * ct[b]``."""

    @staticmethod
    def forward(ctx, x, nbr_idx, mask, mean: bool):
        ctx.save_for_backward(nbr_idx, mask)
        ctx.mean = mean
        ctx.x_shape = x.shape
        return neighbor_reduce(x, nbr_idx, mask, mean)

    @staticmethod
    def backward(ctx, ct):
        nbr_idx, mask = ctx.saved_tensors
        U, D = ctx.x_shape
        B, K = nbr_idx.shape
        w = mask.to(torch.float32)
        if ctx.mean:
            w = w / w.sum(dim=1, keepdim=True).clamp(min=1.0)
        edges = (w[..., None] * ct.float()[:, None, :]).reshape(B * K, D)
        # masked slots land in an extra row U that is cut off (the mode="drop"
        # of _fps_bwd), so a non-finite cotangent never leaks through them
        idx = torch.where(mask, nbr_idx.long().clamp(0, U - 1), U).reshape(-1)
        dx = torch.zeros((U + 1, D), dtype=torch.float32, device=ct.device).index_add_(0, idx, edges)
        return dx[:U].to(ct.dtype), None, None, None
