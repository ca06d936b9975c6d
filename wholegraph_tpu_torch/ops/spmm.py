"""Sparse aggregation: the padded regime for sampled blocks and the COO
regime for full graphs.

Port of ``wholegraph_tpu/ops/spmm.py``:

* padded regime (``:35-107``): ``padded_gather_neighbors``,
  ``padded_reduce`` and ``padded_softmax``. On the TPU ``padded_reduce``
  gathered rows with ``_gather_kernel`` and summed them in XLA; here sum
  and mean go through the fused kernel D
  (:class:`~wholegraph_tpu_torch.ops.spmm_kernels.NeighborReduce`), and max
  stays plain PyTorch, as it was plain XLA.
* COO regime (``:257-401``): ``spmm``, ``sddmm``, ``sddmm_chunked``,
  ``edge_softmax`` and the host-side ``plan_spmm_tiles``. These are plain
  PyTorch, as the JAX versions are plain XLA; the full-graph convs route
  sum and mean through kernel G instead (``models/conv.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Edge-list (COO) regime — full graph
# ---------------------------------------------------------------------------


def _segment_ids(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment ids as int64, those outside ``[0, num_segments)`` sent to an
    extra segment ``num_segments`` that callers cut off (the drop mode of
    ``jax.ops.segment_*``)."""
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{seg[e] == s} values[e]`` over the first axis; ids out
    of range are dropped. Differentiable in ``values``."""
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    return out.index_add(0, _segment_ids(seg, num_segments), values)[:num_segments]


def segment_max(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = max_{seg[e] == s} values[e]``, ``-inf`` for an empty
    segment (``jax.ops.segment_max``); ids out of range are dropped."""
    idx = _segment_ids(seg, num_segments).view((-1,) + (1,) * (values.dim() - 1))
    out = values.new_full((num_segments + 1,) + tuple(values.shape[1:]), float("-inf"))
    out = out.scatter_reduce(0, idx.expand_as(values), values, "amax", include_self=True)
    return out[:num_segments]


def spmm(edge_src: torch.Tensor, edge_dst: torch.Tensor, x: torch.Tensor, num_dst: int,
         reduce: str = "sum", edge_weight: Optional[torch.Tensor] = None,
         indices_are_sorted: bool = True) -> torch.Tensor:
    """``out[d] = reduce_{(s, d) ∈ E} (w_e ·) x[s]``, the SpMM over a COO
    edge list. Source ids are clipped; ``mean`` divides by the edge count
    (``max(count, 1)``), never the weight sum; ``max`` gives ``-inf`` for a
    destination with no edge, as ``jax.ops.segment_max`` does.
    ``indices_are_sorted`` is accepted for the JAX signature and unused."""
    msgs = local_take(x, edge_src)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    if reduce in ("sum", "mean"):
        out = segment_sum(msgs, edge_dst, num_dst)
        if reduce == "mean":
            cnt = segment_sum(torch.ones_like(edge_dst, dtype=x.dtype), edge_dst, num_dst)
            out = out / cnt.clamp(min=1)[:, None]
        return out
    if reduce == "max":
        return segment_max(msgs, edge_dst, num_dst)
    raise ValueError(f"unknown reduce {reduce!r}")


def sddmm(edge_src: torch.Tensor, edge_dst: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """``e_(s, d) = <a[d], b[s]>`` per edge, the SDDMM (ids clipped).
    Materialises two ``[E, D]`` intermediates: full-graph edge counts need
    :func:`sddmm_chunked`."""
    return (local_take(a, edge_dst) * local_take(b, edge_src)).sum(dim=-1)


def sddmm_chunked(edge_src: torch.Tensor, edge_dst: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, *, chunk: int = 1 << 20) -> torch.Tensor:
    """:func:`sddmm` in O(chunk × D) memory, one chunk of edges at a time."""
    E = edge_src.shape[0]
    if E <= chunk:
        return sddmm(edge_src, edge_dst, a, b)
    return torch.cat([sddmm(edge_src[i:i + chunk], edge_dst[i:i + chunk], a, b)
                      for i in range(0, E, chunk)])


def edge_softmax(edge_dst: torch.Tensor, logits: torch.Tensor, num_dst: int,
                 indices_are_sorted: bool = True) -> torch.Tensor:
    """Softmax of the edge ``logits`` [E, ...] over each destination's
    edges (GAT full-graph); the subtracted maximum carries no gradient."""
    mx = segment_max(logits.detach(), edge_dst, num_dst)
    dst = edge_dst.long().clamp(0, max(num_dst - 1, 0))
    e = torch.exp(logits - mx[dst])
    s = segment_sum(e, edge_dst, num_dst)
    return e / s[dst].clamp(min=1e-16)


def plan_spmm_tiles(row_ptr, col, tile: int = 512) -> Tuple[int, int, bool]:
    """Host-side tile plan ``(window, edge_cap, feasible)`` of the JAX
    package's windowed kernels, vectorised: ``window`` is the widest source
    span of any ``tile``-row destination tile, ``edge_cap`` the most edges
    in any tile, both rounded up to 128; ``feasible`` is False when the
    graph has no usable locality (``window > max(2048, n_src // 4)``).

    The port's kernels need no plan (``ops/spmm_kernels.py``); the plan is
    kept so that ``to_full_graph(windowed=True)`` records what the JAX
    package records."""
    rp = np.asarray(row_ptr).astype(np.int64)
    c = np.asarray(col)
    n = rp.shape[0] - 1
    nt = -(-n // tile)
    t = np.arange(nt, dtype=np.int64)
    e0 = rp[np.minimum(t * tile, n)]
    e1 = rp[np.minimum((t + 1) * tile, n)]
    counts = e1 - e0
    edge_cap = max(1, int(counts.max())) if nt else 1
    window = 128
    starts = e0[counts > 0]
    if starts.size:
        # tiles are contiguous edge ranges, so each non-empty tile's edges
        # end where the next non-empty tile's begin
        ce = c[: int(rp[n])].astype(np.int64)
        span = np.maximum.reduceat(ce, starts) - np.minimum.reduceat(ce, starts) + 1
        window = max(window, int(span.max()))
    window = -(-window // 128) * 128
    edge_cap = -(-edge_cap // 128) * 128
    n_src = int(c.max()) + 1 if len(c) else 1
    return window, edge_cap, window <= max(2048, n_src // 4)
