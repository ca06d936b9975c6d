"""The sparse apply's row update: kernel L, and its plain version.

The counterpart, on the apply path (``wholegraph_tpu/embedding/embedding.py:
209-242``), of ``wholegraph_tpu/ops/gather_pallas.py``'s ``_gather_kernel``
on the table and each optimizer slot, the optimizer's elementwise update
(``embedding.py:217``, which XLA fuses) and ``_scatter_kernel`` on each.
:func:`apply_rows` is the wrapper: on CUDA tensors it launches kernel L
(``csrc/sparse_apply.cu``), one launch for the rows, the update and the
write-back, for every optimizer of ``embedding.optimizers``' registry; an
optimizer from outside it runs the composed route, kernel A on the table and
each slot, its own ``update``, kernel B on each (:func:`apply_route`). On CPU
tensors, and only there, it runs :func:`apply_rows_plain`, the same
composition through the plain gather and scatter, which is also what L is
checked against on the card, bit for bit.

:func:`apply_rows_host` is the same step on a table and state tables in
pinned, mapped host memory (``HostEmbedding``), the counterpart of
``wholegraph_tpu/embedding/host_embedding.py``'s ``_host_apply_shard``
(``:185-248``: ``_host_take`` on the table and each slot, the update,
``_host_write`` on each, the cached lines' rewrite): on a card, kernel L's
host route, one launch that reads the rows over PCIe, updates them, writes
them back and rewrites their cache lines; an optimizer from outside the
registry runs kernel E on the table and each slot, its own ``update``,
kernel F on each and kernel B on the cache lines. On the CPU it runs
:func:`apply_rows_host_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import kernels
from ..utils.error import check_input
from .gather_kernels import (gather_rows, gather_rows_plain, on_cuda, scatter_rows,
                             scatter_rows_plain)
from .host_kernels import (_address, _on_card, host_gather_rows, host_gather_rows_plain,
                           host_scatter_rows, host_scatter_rows_plain)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

SPARSE_APPLY = kernels.Kernel(
    "sparse_apply", "sparse_apply.cu", "wg_sparse_apply",
    [_I, _P, _I, _P, _P, _P, _I, _P, _I, _L, _L, _L, _I, _I] + [_F] * 9 + [_P, _P],
    # _gather_kernel and _scatter_kernel on the apply path (embedding.py:209-242)
    replaces="wholegraph_tpu/ops/gather_pallas.py:35,102",
)

SPARSE_APPLY_HOST = kernels.Kernel(
    "sparse_apply_host", "sparse_apply.cu", "wg_sparse_apply_host",
    [_I, _P, _L, _I, _P, _L, _P, _L, _P, _I, _P, _P, _P, _L, _L, _L, _I, _I] + [_F] * 9
    + [_P, _P],
    # on the host tier's apply (host_embedding.py:185-248): _host_fetch_kernel, _host_put_kernel
    # and _host_window_fetch_kernel
    replaces="wholegraph_tpu/ops/gather_pallas.py:1168,1183,1290",
)

# the optimizer codes and element types of csrc/sparse_apply.cu
OPT_SGD, OPT_ADAM, OPT_ADAMW, OPT_RMSPROP, OPT_ADAGRAD = range(5)
_ELEMENT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# f32 row bytes a CTA of kernel L aims at, were all its slots valid, and the most
# slots a CTA takes (csrc/sparse_apply.cu): 32 slots of 1 KB rows, 512 at 64 bytes.
# On an H100 (tools/kernel_variants.py --parts L) 8-16 KB ran up to 1 % faster at
# 1 KB rows and 40-150 % slower at the hetero store's 128-byte rows, 64-128 KB 1-4 %
# slower at 1 KB and 31-33 % at 128 bytes.
APPLY_TILE_BYTES = 32 * 1024
APPLY_MAX_TILE = 512
# The same on the host route, over pinned, mapped host tables: 8 slots of 1 KB rows. On an
# H100 (tools/kernel_variants.py --parts L, the host-tier step's apply call) 2-16 KB ran 2-7 %
# faster than 32 KB, 64-128 KB 9-18 % slower: fewer rows in flight at once keep the reads
# nearer one another in the table.
APPLY_HOST_TILE_BYTES = 8 * 1024

StepLike = Union[int, torch.Tensor]


def apply_tile(row_bytes: int, tile_bytes: int = 0) -> int:
    """Slots per CTA of kernel L for f32 rows of ``row_bytes`` (``dim * 4``,
    the update's rows whatever the table's type): as many as fill
    ``tile_bytes`` (APPLY_TILE_BYTES unless given) were all of them valid,
    from 1 to APPLY_MAX_TILE (2 a thread). A masked slot costs a CTA only its
    id, so narrow rows take the most slots."""
    return max(1, min(APPLY_MAX_TILE, (tile_bytes or APPLY_TILE_BYTES) // max(row_bytes, 1)))


def apply_route(optimizer) -> str:
    """``"fused"`` (kernel L) for an optimizer of the registry's own types
    (SGD, LazyAdam with or without ``adam_w``, RMSProp, AdaGrad), else
    ``"composed"`` (kernel A, the optimizer's ``update``, kernel B): a
    subclass may change ``update``, which L would not see. The type alone
    chooses; a kernel that fails to build or launch raises."""
    from ..embedding import optimizers as opt

    return "fused" if type(optimizer) in (opt.SGD, opt.LazyAdam, opt.RMSProp,
                                          opt.AdaGrad) else "composed"


def _f32(x: float) -> float:
    """The f32 value ATen takes for a Python float beside an f32 tensor."""
    return float(np.float32(x))


def kernel_params(optimizer, step: StepLike, lr: float):
    """``(code, floats, step row)`` that kernel L takes for an optimizer of
    the fused route (its state tables are its ``slot_names``, in order): the
    nine f32 scalars (lr, weight decay, b1, 1 - b1, b2, 1 - b2,
    epsilon, c1, c2; RMSProp's alpha and 1 - alpha as b1 and 1 - b1) as the
    plain route's ATen calls take them (each Python float rounded to f32,
    ``1 - beta`` computed in Python first), and, for LazyAdam with ``step`` a
    tensor, that row of ``step_table`` (read on the card; c1 and c2 are then
    0). For an int step, LazyAdam's c1 and c2 are the reciprocals its
    ``step_table`` holds on a card (``LazyAdam.step_rows(..., card=True)``):
    ATen divides a card tensor by a host scalar as a product with the
    scalar's f32 reciprocal."""
    from ..embedding import optimizers as opt

    kind = type(optimizer)
    b1 = omb1 = b2 = omb2 = eps = c1 = c2 = 0.0
    row = None
    if kind is opt.SGD:
        code = OPT_SGD
    elif kind is opt.LazyAdam:
        code = OPT_ADAMW if optimizer.adam_w else OPT_ADAM
        b1, omb1, b2, omb2 = optimizer.beta1, 1.0 - optimizer.beta1, optimizer.beta2, \
            1.0 - optimizer.beta2
        eps = optimizer.epsilon
        if isinstance(step, torch.Tensor):
            check_input(step.dtype == torch.float32 and step.numel() == 2,
                        f"LazyAdam's step row must be 2 float32 values, got {step.dtype} "
                        f"{tuple(step.shape)}")
            row = step
        else:
            c1, c2 = (float(x) for x in optimizer.step_rows([int(step)], card=True)[0])
    elif kind is opt.RMSProp:
        code = OPT_RMSPROP
        b1, omb1, eps = optimizer.alpha, 1.0 - optimizer.alpha, optimizer.epsilon
    elif kind is opt.AdaGrad:
        code = OPT_ADAGRAD
        eps = optimizer.epsilon
    else:
        raise ValueError(f"kernel L does not take {kind.__name__}; see apply_route")
    floats = tuple(_f32(x) for x in (lr, optimizer.weight_decay, b1, omb1, b2, omb2, eps))
    return code, floats + (c1, c2), row


def _check(table: torch.Tensor, slots: Dict[str, torch.Tensor], ids: torch.Tensor,
           grads: torch.Tensor) -> None:
    check_input(table.dim() == 2, f"table must be [N, D], got {tuple(table.shape)}")
    check_input(ids.dim() == 1 and ids.dtype in (torch.int32, torch.int64),
                f"ids must be 1-D int32/int64, got {ids.dtype} {tuple(ids.shape)}")
    check_input(grads.shape == (ids.shape[0], table.shape[1]),
                f"grads {tuple(grads.shape)} != ({ids.shape[0]}, {table.shape[1]})")
    for name, s in slots.items():
        check_input(s.shape == table.shape and s.dtype == torch.float32,
                    f"slot {name} must be float32 {tuple(table.shape)}, got {s.dtype} "
                    f"{tuple(s.shape)}")


def _composed(gather, scatter, table, slots, ids, grads, optimizer, step, lr) -> None:
    """Rows by ``gather``, ``optimizer.update`` in f32, rows back by
    ``scatter``; slots outside ``[0, N)`` touch nothing."""
    valid = (ids >= 0) & (ids < table.shape[0])
    take = torch.where(valid, ids, 0)
    names = tuple(sorted(slots))
    rows = gather(table, take).float()
    srows = {s: gather(slots[s], take) for s in names}
    new_rows, new_srows = optimizer.update(rows, grads.float(), srows, step, lr)
    write = torch.where(valid, ids, -1)
    scatter(table, write, new_rows.to(table.dtype).contiguous())
    for s in names:
        scatter(slots[s], write, new_srows[s].contiguous())


def apply_rows_plain(table: torch.Tensor, slots: Dict[str, torch.Tensor], ids: torch.Tensor,
                     grads: torch.Tensor, optimizer, step: StepLike, lr: float) -> None:
    """The optimizer's step on ``table`` and its ``slots`` at ``ids``, in
    place: ``gather_rows_plain`` of the table (widened to f32) and of each
    slot, ``optimizer.update`` with ``grads.float()``, ``scatter_rows_plain``
    of the new rows (the table's rounded to its type). Slots outside ``[0,
    N)`` touch nothing; ids in range must be unique."""
    _check(table, slots, ids, grads)
    _composed(gather_rows_plain, scatter_rows_plain, table, slots, ids, grads, optimizer, step,
              lr)


def apply_rows(table: torch.Tensor, slots: Dict[str, torch.Tensor], ids: torch.Tensor,
               grads: torch.Tensor, optimizer, step: StepLike, lr: float) -> None:
    """The sparse optimizer's step on the rows of ``table`` [N, D] and of
    each f32 slot (``slots``: name -> [N, D]) at ``ids`` [R], in place,
    with the row gradients ``grads`` [R, D] (f32, or bf16 / f16 widened
    exactly) at ``step`` (the global step, or LazyAdam's row of
    ``step_table`` on the rows' device) and rate ``lr``. A slot whose id
    lies outside ``[0, N)`` is skipped: neither its gradient nor any row is
    read or written. Ids in range must be unique.

    On CUDA tensors: kernel L, one launch, for an optimizer of the
    registry (:func:`apply_route`), bit-equal to :func:`apply_rows_plain`
    on the card; otherwise kernel A on the table and each slot, the
    optimizer's ``update``, kernel B on each. On CPU tensors:
    :func:`apply_rows_plain`."""
    _check(table, slots, ids, grads)
    if not on_cuda(table, ids, grads, *slots.values()):
        return apply_rows_plain(table, slots, ids, grads, optimizer, step, lr)
    if apply_route(optimizer) == "composed":
        return _composed(gather_rows, scatter_rows, table, slots, ids, grads, optimizer, step, lr)
    code, floats, row = kernel_params(optimizer, step, lr)
    names = optimizer.slot_names
    check_input(set(names) == set(slots), f"slots {sorted(slots)} != {sorted(names)}")
    check_input(table.dtype in _ELEMENT, f"kernel L takes float32, bfloat16 or float16 "
                                         f"tables, got {table.dtype}")
    check_input(table.is_contiguous() and all(s.is_contiguous() for s in slots.values()),
                "table and slots must be contiguous")
    R, D = grads.shape
    if R == 0 or D == 0 or table.shape[0] == 0:
        return None
    if grads.dtype not in (torch.float32, table.dtype):
        grads = grads.float()
    ids, grads = ids.contiguous(), grads.contiguous()
    state = [slots[s] for s in names]
    if row is not None:
        check_input(row.device == table.device, "the step row must lie on the table's card")
        row = row.contiguous()
    ptrs = [table.data_ptr(), grads.data_ptr()] + [s.data_ptr() for s in state]
    vec = 4 if D % 4 == 0 and all(p % (4 * t.element_size()) == 0 for p, t in zip(
        ptrs, [table, grads] + state)) else 1
    tile = apply_tile(D * 4)
    check_input(tile * (D // vec) < 2**31, "a tile of rows must hold fewer than 2^31 vectors")
    SPARSE_APPLY(code, table.data_ptr(), _ELEMENT[table.dtype],
                 *(state[k].data_ptr() if k < len(state) else None for k in range(2)),
                 ids.data_ptr(), int(ids.dtype == torch.int64), grads.data_ptr(),
                 _ELEMENT[grads.dtype], table.shape[0], R, D, vec, tile, *floats,
                 None if row is None else row.data_ptr(), kernels.cuda_stream(table.device))
    return None


# ---------------------------------------------------------------------------
# The host route: the table and its state tables in pinned, mapped host memory
# ---------------------------------------------------------------------------


def _check_host(table, slots, ids, grads, lines, cache_rows) -> None:
    _check(table, slots, ids, grads)
    check_input((lines is None) == (cache_rows is None), "lines and cache_rows come together")
    if lines is not None:
        check_input(lines.shape == ids.shape and lines.dtype in (torch.int32, torch.int64),
                    f"lines must be int32/int64 {tuple(ids.shape)}, got {lines.dtype} "
                    f"{tuple(lines.shape)}")
        check_input(cache_rows.dim() == 2 and cache_rows.shape[1] == table.shape[1]
                    and cache_rows.dtype == table.dtype,
                    f"cache_rows must be [H, {table.shape[1]}] {table.dtype}, got "
                    f"{cache_rows.dtype} {tuple(cache_rows.shape)}")


def _composed_host(gather, scatter, line_scatter, table, slots, ids, grads, optimizer, step, lr,
                   lines, cache_rows) -> None:
    """Rows by ``gather`` (a host row gather), ``optimizer.update`` in f32,
    rows back by ``scatter`` (a host row scatter), and the new table rows
    into ``cache_rows`` at ``lines`` by ``line_scatter``; slots outside ``[0,
    N)`` touch nothing."""
    names = tuple(sorted(slots))
    rows = gather(table, ids).float()
    srows = {s: gather(slots[s], ids) for s in names}
    new_rows, new_srows = optimizer.update(rows, grads.float(), srows, step, lr)
    new_rows = new_rows.to(table.dtype).contiguous()
    scatter(table, ids, new_rows)
    for s in names:
        scatter(slots[s], ids, new_srows[s].contiguous())
    if lines is not None:
        valid = (ids >= 0) & (ids < table.shape[0])
        line_scatter(cache_rows, torch.where(valid & (lines >= 0), lines, -1), new_rows)


def _host_take(table, ids):
    # the apply's slots are ascending and unique: kernel E needs no sort
    return host_gather_rows(table, ids, _sort=False)


def apply_rows_host_plain(table: torch.Tensor, slots: Dict[str, torch.Tensor], ids: torch.Tensor,
                          grads: torch.Tensor, optimizer, step: StepLike, lr: float, *,
                          lines: Optional[torch.Tensor] = None,
                          cache_rows: Optional[torch.Tensor] = None) -> None:
    """The optimizer's step on the host ``table`` and its host ``slots`` at
    ``ids``, in place: ``host_gather_rows_plain`` of the table (widened to
    f32) and of each slot, ``optimizer.update`` with ``grads.float()``,
    ``host_scatter_rows_plain`` of the new rows (the table's rounded to its
    type), and ``scatter_rows_plain`` of the new table rows into
    ``cache_rows`` at ``lines`` where a valid slot has one (>= 0). Slots
    outside ``[0, N)`` touch nothing; ids in range must be unique."""
    _check_host(table, slots, ids, grads, lines, cache_rows)
    _composed_host(host_gather_rows_plain, host_scatter_rows_plain, scatter_rows_plain, table,
                   slots, ids, grads, optimizer, step, lr, lines, cache_rows)


def apply_rows_host(table: torch.Tensor, slots: Dict[str, torch.Tensor], ids: torch.Tensor,
                    grads: torch.Tensor, optimizer, step: StepLike, lr: float, *,
                    lines: Optional[torch.Tensor] = None,
                    cache_rows: Optional[torch.Tensor] = None) -> None:
    """:func:`apply_rows` on a ``table`` [N, D] and f32 ``slots`` (name ->
    [N, D]) in pinned, mapped host memory, with ``ids`` [R] and f32 ``grads``
    [R, D] (widened if not) on the card, in place; with ``lines`` [R] (a
    slot's line of ``cache_rows``, or -1) and ``cache_rows`` [H, D] of the
    table's type on the card, each valid slot's new table row is also
    written into its cache line, so a cache that equalled the host rows
    still does. Ids in range must be unique; ascending ids read the host in
    address order.

    CPU ids: :func:`apply_rows_host_plain`. CUDA ids: a table or slot that
    is not pinned raises :class:`CudaError`; an optimizer of the registry
    (:func:`apply_route`) runs kernel L's host route, one launch,
    bit-equal to kernel E on the table and each slot, the update on the
    card, kernel F on each and kernel B on the lines; any other optimizer
    runs that composed route."""
    _check_host(table, slots, ids, grads, lines, cache_rows)
    card = [ids, grads] + ([lines, cache_rows] if lines is not None else [])
    on_card = [_on_card(t, *card) for t in (table, *slots.values())]
    if not on_card[0]:
        return apply_rows_host_plain(table, slots, ids, grads, optimizer, step, lr, lines=lines,
                                     cache_rows=cache_rows)
    if apply_route(optimizer) == "composed":
        return _composed_host(_host_take, host_scatter_rows, scatter_rows, table, slots, ids,
                              grads, optimizer, step, lr, lines, cache_rows)
    code, floats, row = kernel_params(optimizer, step, lr)
    names = optimizer.slot_names
    check_input(set(names) == set(slots), f"slots {sorted(slots)} != {sorted(names)}")
    check_input(table.dtype in _ELEMENT, f"kernel L takes float32, bfloat16 or float16 "
                                         f"tables, got {table.dtype}")
    R, D = grads.shape
    if R == 0 or D == 0 or table.shape[0] == 0:
        return None
    ids, grads = ids.contiguous(), grads.float().contiguous()
    state = [slots[s] for s in names]
    if row is not None:
        check_input(row.device == ids.device, "the step row must lie on the ids' card")
        row = row.contiguous()
    if lines is not None:
        check_input(cache_rows.is_contiguous(), "cache_rows must be contiguous")
        lines = lines.to(torch.int32).contiguous()
    ptrs = [table.data_ptr(), grads.data_ptr()] + [s.data_ptr() for s in state] + (
        [cache_rows.data_ptr()] if lines is not None else [])
    tensors = [table, grads] + state + ([cache_rows] if lines is not None else [])
    vec = 4 if D % 4 == 0 and all(p % (4 * t.element_size()) == 0
                                  for p, t in zip(ptrs, tensors)) else 1
    tile = apply_tile(D * 4, APPLY_HOST_TILE_BYTES)
    check_input(tile * (D // vec) < 2**31, "a tile of rows must hold fewer than 2^31 vectors")
    where = [_address(t) for t in [table] + state] + [(None, 0)] * (2 - len(state))
    SPARSE_APPLY_HOST(code, *where[0], _ELEMENT[table.dtype], *where[1], *where[2],
                      ids.data_ptr(), int(ids.dtype == torch.int64), grads.data_ptr(),
                      None if lines is None else lines.data_ptr(),
                      None if lines is None else cache_rows.data_ptr(),
                      table.shape[0], R, D, vec, tile, *floats,
                      None if row is None else row.data_ptr(), kernels.cuda_stream(ids.device))
    return None


__all__ = ["SPARSE_APPLY", "SPARSE_APPLY_HOST", "APPLY_TILE_BYTES", "APPLY_HOST_TILE_BYTES",
           "APPLY_MAX_TILE", "apply_tile", "apply_route", "kernel_params", "apply_rows",
           "apply_rows_plain", "apply_rows_host", "apply_rows_host_plain", "OPT_SGD", "OPT_ADAM",
           "OPT_ADAMW", "OPT_RMSPROP", "OPT_ADAGRAD"]
