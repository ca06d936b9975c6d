"""Row gather and scatter on one device: local take / write / add, and the
sharded store's gather and scatter at world 1.

Port of the single-shard part of ``wholegraph_tpu/ops/gather.py``:
``local_take`` (``gather.py:92-152``), ``local_write`` and ``local_add``
(``:155-169``), ``gather`` and ``scatter`` (``:701-874``) for a plan of one
shard, and ``local_take_sorted`` (``gather_pallas.py:913-971``). The
multi-device exchange is not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from ..utils.error import check_input
from .gather_kernels import gather_rows, gather_rows_masked, gather_rows_sorted, scatter_rows_masked

if TYPE_CHECKING:  # memory/ imports this module
    from ..memory.partition import PartitionPlan


class _Take(torch.autograd.Function):
    """``take(shard, slots)`` with the backward of a row gather: the
    cotangent scatter-added onto the rows read (``index_add_``, as XLA's
    scatter-add is on the TPU). With ``clip`` the slots are clipped into
    range, as the take does; otherwise out-of-range slots read nothing and
    their cotangent is dropped."""

    @staticmethod
    def forward(ctx, shard, slots, take, clip):
        ctx.save_for_backward(slots)
        ctx.shard_shape, ctx.shard_dtype, ctx.clip = shard.shape, shard.dtype, clip
        return take(shard, slots)

    @staticmethod
    def backward(ctx, ct):
        (slots,) = ctx.saved_tensors
        n = ctx.shard_shape[0]
        dshard = torch.zeros(ctx.shard_shape, dtype=ct.dtype, device=ct.device)
        if ctx.clip:
            dshard.index_add_(0, slots.long().clamp(0, n - 1), ct)
        else:
            keep = (slots >= 0) & (slots < n)
            dshard.index_add_(0, slots[keep].long(), ct[keep])
        return dshard.to(ctx.shard_dtype), None, None, None


def local_take(shard: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[i] = shard[clip(slots[i])]`` for a [N, D] shard (kernel A on
    CUDA). Differentiable in ``shard``: the backward is the matching
    scatter-add."""
    return _Take.apply(shard, slots, gather_rows, True)


def local_take_sorted(shard: torch.Tensor, slots: torch.Tensor, *, density: float = 1.0,
                      tile=None, window=None) -> torch.Tensor:
    """``out[i] = shard[clip(slots[i])]`` for a [N, D] shard, exact for any
    slots and fastest for sorted, dense ones (``gather_pallas.local_take_sorted``,
    the reference's sorted-ids fast path, gather_op.cpp:118-120): kernel I
    on CUDA, whose windows ``density`` (expected distinct rows over span)
    sizes unless ``tile`` and ``window`` are given. Nothing is repaired
    afterwards: an id outside its tile's window is read directly in the same
    launch. Differentiable in ``shard``, as :func:`local_take`."""
    def take(t, s):
        return gather_rows_sorted(t, s, tile=tile, window=window, density=density)

    return _Take.apply(shard, slots, take, True)


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


# ---------------------------------------------------------------------------
# The sharded store's gather and scatter (world 1)
# ---------------------------------------------------------------------------


def _world1_slots(plan: PartitionPlan, ids: torch.Tensor) -> torch.Tensor:
    """Physical slot of each logical id: the id itself for ids in ``[0, n)``,
    since a plan of one shard places logical row i at physical row i (block
    plans at offset 0, round-robin blocks dealt in order). An id outside
    ``[0, n)`` must not reach a row: the kernels skip slots outside the
    physical table themselves, so only a plan with padding rows past ``n``
    (round-robin) needs those ids set to -1 here."""
    if plan.world != 1:
        raise NotImplementedError(
            f"a plan of world {plan.world}: the sharded exchange is not ported yet "
            "(ROADMAP Queue 1 item 13); the port's store serves plans of one shard")
    check_input(ids.dim() == 1 and ids.dtype in (torch.int32, torch.int64),
                f"ids must be 1-D int32/int64, got {tuple(ids.shape)} {ids.dtype}")
    if plan.total_physical_rows == plan.n:
        return ids
    return torch.where(ids < plan.n, ids, -1)


def _last_writers(slots: torch.Tensor) -> torch.Tensor:
    """``slots`` with every repeated slot but its last occurrence set to -1.
    Kernel B writes rows in parallel, so two rows aimed at one slot could
    interleave vector by vector; with one writer left per slot each row is
    written whole, and the last one wins, as in a sequential write."""
    s, order = torch.sort(slots, stable=True)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[:-1] != s[1:]
    keep = torch.empty_like(last)
    keep[order] = last
    return torch.where(keep, slots, -1)


def gather(data: torch.Tensor, ids: torch.Tensor, *, plan: PartitionPlan, method: str = "auto",
           capacity_factor: float = 2.0, dedup: bool = False,
           local_kernel: str = "ring") -> torch.Tensor:
    """Rows of a sharded table by logical id (``gather.py:701-781``) for a
    plan of one shard. ``data`` is the physical table ``[capacity, D]`` (or
    ``[capacity]``, served as ``[capacity, 1]``); ids outside ``[0, n)``
    give zero rows, as the JAX docstring states (its world-1 branch clips
    instead: quirk R7). ``local_kernel`` picks the serve: ``"ring"`` kernel
    J, ``"sorted"`` kernel I with zero rows for invalid ids (fastest for
    sorted, dense ids). ``method``, ``capacity_factor`` and ``dedup`` shape
    the exchange between shards and change nothing here, as in the JAX
    world-1 branch. Differentiable in ``data``; the out-of-range ids'
    cotangent is dropped. Plans of more shards raise NotImplementedError."""
    del method, capacity_factor, dedup  # the exchange's knobs; world 1 has no exchange
    check_input(local_kernel in ("ring", "sorted"), f"unknown local_kernel {local_kernel!r}")
    if data.dim() == 1:  # 1-D tables (e.g. CSR row_ptr/col): lift to [n, 1]
        return gather(data[:, None], ids, plan=plan, local_kernel=local_kernel)[:, 0]
    check_input(data.dim() == 2, f"data must be [rows, D] or [rows], got {tuple(data.shape)}")
    slots = _world1_slots(plan, ids)
    if local_kernel == "sorted":
        def take(t, s):
            return gather_rows_sorted(t, s, zero_invalid=True)
    else:
        take = gather_rows_masked
    return _Take.apply(data, slots, take, False)


def scatter(data: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, *, plan: PartitionPlan,
            accumulate: bool = False, capacity_factor: float = 2.0, donate: bool = False,
            exact: bool = True) -> torch.Tensor:
    """Write (or, with ``accumulate``, add) ``rows`` at logical ``ids`` of a
    sharded table (``gather.py:828-874``) for a plan of one shard; ids
    outside ``[0, n)`` are dropped. A set with duplicate ids writes the
    last of their rows, whole (the JAX package leaves the winner
    unspecified); an add sums every one. The set is
    kernel B's masked route (:func:`scatter_rows_masked`), the add
    ``index_add_`` (XLA's scatter-add on the TPU, not a Pallas kernel).
    ``donate=True`` writes into ``data`` and returns it; otherwise ``data``
    is left as it was and a new table is returned, as in the JAX package.
    ``capacity_factor`` and ``exact`` shape the exchange between shards and
    change nothing here."""
    del capacity_factor, exact  # the exchange's knobs; world 1 has no exchange
    if data.dim() == 1:
        out = scatter(data[:, None], ids, rows.reshape(-1, 1), plan=plan,
                      accumulate=accumulate, donate=donate)
        return out[:, 0]
    slots = _world1_slots(plan, ids)
    check_input(rows.shape == (ids.shape[0], data.shape[1]),
                f"rows {tuple(rows.shape)} != ({ids.shape[0]}, {data.shape[1]})")
    out = data if donate else data.clone()
    rows = rows.to(data.dtype)
    if accumulate:
        keep = _drop_masked(out, slots, None)
        return out.index_add_(0, slots[keep].long(), rows[keep])
    return scatter_rows_masked(out, _last_writers(slots), rows)
