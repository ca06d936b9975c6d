"""Rows of a pinned host table, fetched and written by the card: kernels E and F.

The counterpart of the host section of ``wholegraph_tpu/ops/gather_pallas.py``
(``:1002-1628``). A host table is an ``[N, D]`` CPU tensor in page-locked
memory that CUDA has mapped into the card's address space
(:func:`pinned_empty`); kernel E (``csrc/host_rows.cu``) reads its rows over
PCIe at given slots and kernel F writes them, both through the mapped device
address (F runs kernel B's body, ``csrc/row_scatter.cuh``, there). The TPU's flat-memref contract, its 4 KB host pages and its window,
span and ring plans (``:1270-1273``, ``:1013-1025``, ``:1337-1377``) stay
behind: one kernel serves scattered and sorted-dense slots alike.

Dispatch: CPU slots and a CPU table run the plain version beside each
wrapper (``*_plain``); CUDA slots and a **pinned** CPU table launch the
kernel; anything else raises :class:`CudaError`. A table that is not pinned
never falls back to a host-side ``index_select``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import kernels
from ..utils.error import CudaError, check_input
from .gather_kernels import vector_bytes

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_P, _L, _P, _I, _P, _L, _L, _L, _I, _P]

HOST_GATHER = kernels.Kernel(
    "host_gather", "host_rows.cu", "wg_host_gather", _ARGS,
    # _host_fetch_kernel and _host_window_fetch_kernel
    replaces="wholegraph_tpu/ops/gather_pallas.py:1168,1290",
)
HOST_SCATTER = kernels.Kernel(
    "host_scatter", "host_rows.cu", "wg_host_scatter", _ARGS,
    replaces="wholegraph_tpu/ops/gather_pallas.py:1183",  # _host_put_kernel
)


def pinned_empty(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised CPU tensor in page-locked memory that CUDA maps into
    the card's address space, so kernels E and F reach it over PCIe.

    It comes from PyTorch's caching host allocator (``cudaHostAlloc``, mapped
    under unified addressing): a request is rounded up to a power of two of
    bytes, and freed memory stays cached by that allocator. Needs CUDA."""
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


def _check(table: torch.Tensor, slots: torch.Tensor) -> None:
    check_input(table.dim() == 2, f"host table must be [N, D], got {tuple(table.shape)}")
    check_input(slots.dim() == 1, f"slots must be 1-D, got {tuple(slots.shape)}")
    check_input(slots.dtype in (torch.int32, torch.int64),
                f"slots must be int32/int64, got {slots.dtype}")


def _on_card(table: torch.Tensor, *on_device: torch.Tensor) -> bool:
    """False for a CPU table with CPU slots (and rows); True for a pinned,
    contiguous CPU table with CUDA slots (and rows) on one device; raises
    otherwise."""
    types = {t.device.type for t in on_device}
    if table.device.type == "cpu" and types == {"cpu"}:
        return False
    if (table.device.type != "cpu" or types != {"cuda"}
            or len({t.device for t in on_device}) != 1):
        raise CudaError("host rows need a CPU table with CPU slots, or a pinned CPU table "
                        f"with CUDA slots; got table on {table.device}, others on "
                        f"{[str(t.device) for t in on_device]}")
    if not table.is_pinned():
        raise CudaError("the host table is not in pinned, mapped memory (allocate it with "
                        "pinned_empty); a kernel cannot reach it from the card")
    check_input(table.is_contiguous(), "host table must be contiguous")
    return True


def _launch(kernel: kernels.Kernel, table: torch.Tensor, slots: torch.Tensor,
            dev_rows: torch.Tensor) -> None:
    row_bytes = table.shape[1] * table.element_size()
    base = table.untyped_storage().data_ptr()
    kernel(base, table.data_ptr() - base, slots.data_ptr(), int(slots.dtype == torch.int64),
           dev_rows.data_ptr(), table.shape[0], slots.shape[0], row_bytes,
           vector_bytes(row_bytes, table.data_ptr(), dev_rows.data_ptr()),
           kernels.cuda_stream(slots.device))


# ---------------------------------------------------------------------------
# Kernel E: host row fetch
# ---------------------------------------------------------------------------


def host_gather_rows_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[slots[i]]`` for ``0 <= slots[i] < N``, else a zero
    row; computed where ``table`` lies, returned on ``slots``' device."""
    s = slots.to(table.device)
    valid = (s >= 0) & (s < table.shape[0])
    out = table.new_zeros((s.shape[0], table.shape[1]))
    out[valid] = table[s[valid].long()]
    return out.to(slots.device)


def host_gather_rows(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Rows of the host ``table`` [N, D] at ``slots`` [B], on ``slots``'
    device; a slot outside ``[0, N)`` gives a zero row and no host read (the
    contract of ``gather_pallas.host_gather_rows`` with its garbage rows made
    zero). Kernel E for CUDA slots and a pinned table."""
    _check(table, slots)
    if not _on_card(table, slots):
        return host_gather_rows_plain(table, slots)
    slots = slots.contiguous()
    out = torch.empty((slots.shape[0], table.shape[1]), dtype=table.dtype, device=slots.device)
    if out.numel() == 0 or table.shape[0] == 0:
        return out.zero_()
    _launch(HOST_GATHER, table, slots, out)
    return out


# ---------------------------------------------------------------------------
# Kernel F: host row write-back
# ---------------------------------------------------------------------------


def host_scatter_rows_plain(table: torch.Tensor, slots: torch.Tensor,
                            rows: torch.Tensor) -> torch.Tensor:
    """``table[slots[i]] = rows[i]`` in place for ``0 <= slots[i] < N``,
    computed where ``table`` lies."""
    s, r = slots.to(table.device), rows.to(table.device)
    ok = (s >= 0) & (s < table.shape[0])
    table[s[ok].long()] = r[ok]
    return table


def host_scatter_rows(table: torch.Tensor, slots: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` [B, D] into the host ``table`` [N, D] at ``slots`` in
    place; slots outside ``[0, N)`` are skipped, and non-negative slots must
    be unique (the contract of ``gather_pallas.host_scatter_rows``). Kernel F
    for CUDA slots and rows and a pinned table. Returns ``table``."""
    _check(table, slots)
    check_input(rows.shape == (slots.shape[0], table.shape[1]),
                f"rows {tuple(rows.shape)} != ({slots.shape[0]}, {table.shape[1]})")
    check_input(rows.dtype == table.dtype, f"rows dtype {rows.dtype} != table dtype {table.dtype}")
    if not _on_card(table, slots, rows):
        return host_scatter_rows_plain(table, slots, rows)
    slots, rows = slots.contiguous(), rows.contiguous()
    if rows.numel() == 0 or table.shape[0] == 0:
        return table
    _launch(HOST_SCATTER, table, slots, rows)
    return table
