"""Rows of a pinned host table, fetched and written by the card: kernels E and F.

The counterpart of the host section of ``wholegraph_tpu/ops/gather_pallas.py``
(``:1002-1628``). A host table is an ``[N, D]`` CPU tensor in page-locked
memory that CUDA has mapped into the card's address space
(:func:`pinned_empty`); kernel E (``csrc/host_rows.cu``) reads its rows over
PCIe at given slots and kernel F writes them, both through the mapped device
address (F runs kernel B's body, ``csrc/row_scatter.cuh``, there). The
TPU's flat-memref contract, its 4 KB host pages and its ring plan
(``:1270-1273``, ``:1013-1025``) stay behind; of its window and span plans
(``:1337-1377``, ``:1471-1499``) E keeps the sort (:func:`host_gather_plan`):
it reads the distinct rows once each, in address order.

The host tier (``HostEmbedding``) keeps its table and each optimizer state
table in an allocation of its own size from the kernels' library
(:func:`host_zeros`), not in PyTorch's power-of-two pinned blocks.

Dispatch: CPU slots and a CPU table run the plain version beside each
wrapper (``*_plain``); CUDA slots and a **pinned** CPU table launch the
kernel; anything else raises :class:`CudaError`. A table that is not pinned
never falls back to a host-side ``index_select``.
"""

from __future__ import annotations

import ctypes
import os
import warnings
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..utils.error import CudaError, check_input
from .gather_kernels import vector_bytes

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_P, _L, _P, _I, _P, _L, _L, _L, _I, _P]

HOST_GATHER = kernels.Kernel(
    "host_gather", "host_rows.cu", "wg_host_gather",
    [_P, _L, _P, _I, _P, _P, _L, _L, _L, _I, _P, _P],
    # _host_fetch_kernel and _host_window_fetch_kernel
    replaces="wholegraph_tpu/ops/gather_pallas.py:1168,1290",
)
HOST_SCATTER = kernels.Kernel(
    "host_scatter", "host_rows.cu", "wg_host_scatter", _ARGS,
    replaces="wholegraph_tpu/ops/gather_pallas.py:1183",  # _host_put_kernel
)


# The host tier's memory (HostEmbedding): a page-locked, mapped allocation from the kernels'
# library (csrc/host_rows.cu wg_host_alloc, cudaHostAlloc) for the table and one for each f32
# optimizer state table, each request rounded up to a multiple of HOST_ROUND bytes. On an H100
# (tools/host_read_probe.py --parts tier, every choice held at once and timed in turns):
# allocations whose size is no multiple of 2 MiB read 37-51 % slower, by kernel L's host
# route and E alike; one allocation for all three tables read 11 % slower than one a table.
HOST_ROUND = 2 << 20
_HOST_BYTES = {"current": 0, "allocations": 0}
_DEFERRED: List[Tuple[int, int]] = []  # (pointer, bytes) whose free waits for a capture's end


def _host_lib():
    lib = kernels.load("host_rows.cu")
    if not getattr(lib, "_alloc_ready", False):
        lib.wg_host_alloc.argtypes = [_L, _I, ctypes.POINTER(_P)]
        lib.wg_host_free.argtypes = [_P]
        lib.wg_host_alloc.restype = lib.wg_host_free.restype = _I
        lib.wg_error_string.argtypes = [_I]
        lib.wg_error_string.restype = ctypes.c_char_p
        lib._alloc_ready = True
    return lib


def _release(lib, ptr: int, nbytes: int) -> None:
    rc = lib.wg_host_free(ptr)
    if rc != 0:
        warnings.warn(f"wg_host_free of {nbytes} host bytes failed with CUDA error {rc} "
                      f"({lib.wg_error_string(rc).decode()}); the memory stays allocated",
                      RuntimeWarning, stacklevel=2)
        return
    _HOST_BYTES["current"] -= nbytes


def release_deferred_host_memory() -> None:
    """Frees the host memory whose last view died while the current stream
    was capturing a CUDA graph, where a free (which synchronizes the device)
    would invalidate the capture; :func:`host_zeros` and every later free
    call it too."""
    if _DEFERRED and not torch.cuda.is_current_stream_capturing():
        lib = _host_lib()
        while _DEFERRED:
            _release(lib, *_DEFERRED.pop())


def _free_host(lib, ptr: int, nbytes: int) -> None:
    _DEFERRED.append((ptr, nbytes))
    release_deferred_host_memory()


def host_zeros(shape: Sequence[int], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A zero CPU tensor of ``shape`` and ``dtype`` in an allocation of its
    own bytes: for a CUDA ``device`` page-locked and mapped, from the
    kernels' library (``wg_host_alloc``) in a request rounded up to a
    multiple of HOST_ROUND, and freed with the last view of it, after the
    card's work (or, if that happens during a graph capture, at the next
    call of :func:`release_deferred_host_memory`); for the CPU ordinary
    memory. :func:`host_alloc_bytes` counts the bytes the library holds."""
    shape = tuple(int(d) for d in shape)
    nbytes = torch.Size(shape).numel() * torch.tensor([], dtype=dtype).element_size()
    check_input(nbytes > 0, "a host allocation needs a positive size")
    if device.type != "cuda":
        return torch.zeros(shape, dtype=dtype)
    release_deferred_host_memory()
    asked = -(-nbytes // HOST_ROUND) * HOST_ROUND
    lib = _host_lib()
    ptr = ctypes.c_void_p()
    rc = lib.wg_host_alloc(asked, min(os.cpu_count() or 1, 16), ctypes.byref(ptr))
    if rc != 0 or not ptr.value:
        raise CudaError(f"wg_host_alloc of {asked} bytes failed with CUDA error {rc} "
                        f"({lib.wg_error_string(rc).decode()})")
    block = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
    weakref.finalize(block, _free_host, lib, ptr.value, asked)
    _HOST_BYTES["current"] += asked
    _HOST_BYTES["allocations"] += 1
    return torch.frombuffer(block, dtype=torch.uint8).view(dtype).view(shape)


def host_alloc_bytes() -> Dict[str, int]:
    """Bytes of host memory the kernels' library holds for host tables
    (:func:`host_zeros`): ``current`` and the ``allocations`` made."""
    return dict(_HOST_BYTES)


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
                        "host_zeros or pinned_empty); a kernel cannot reach it from the card")
    check_input(table.is_contiguous(), "host table must be contiguous")
    return True


def _address(table: torch.Tensor):
    """(allocation base, byte offset of the table in it)"""
    base = table.untyped_storage().data_ptr()
    return base, table.data_ptr() - base


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


def host_gather_plan(slots: torch.Tensor, n_rows: int):
    """The order in which kernel E reads the host table: ``(keys, pos)``,
    the slots sorted ascending with every slot outside ``[0, n_rows)`` made
    ``n_rows`` (so it sorts last), and ``pos[i]`` the output row of
    ``keys[i]`` (int64), so that ``out[pos[i]] = table[keys[i]]``. Keys are
    int32 while ``n_rows`` allows it. Plain torch ops, on ``slots``' device
    (about 0.1 ms for 2^19 slots on an H100, as the JAX ``_span_plan``
    sorts around its kernel, ``gather_pallas.py:1471-1499``)."""
    dt = torch.int32 if n_rows < 2**31 - 1 else torch.int64
    valid = (slots >= 0) & (slots < n_rows)
    return torch.sort(torch.where(valid, slots.to(dt), n_rows))


def host_gather_rows(table: torch.Tensor, slots: torch.Tensor, *, _sort: bool = True,
                     _stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of the host ``table`` [N, D] at ``slots`` [B], on ``slots``'
    device; a slot outside ``[0, N)`` gives a zero row and no host read (the
    contract of ``gather_pallas.host_gather_rows`` with its garbage rows made
    zero). Slots may come in any order and repeat. Kernel E for CUDA slots
    and a pinned table: it reads each distinct row once, in address order.

    Two internal arguments, which leave the result as it is: ``_sort=False``
    skips the sort of :func:`host_gather_plan` for a caller whose valid
    slots are unique and in an order worth reading as given
    (``HostEmbedding``'s apply and cache fill give them sorted; the training
    step's gather gives the sampler's unique ids, in ascending runs).
    ``_stats``, for reports: an int64 tensor on the card to which the
    kernel adds the bytes it read from the host; the plain version leaves it
    as it is."""
    _check(table, slots)
    if not _on_card(table, slots):
        return host_gather_rows_plain(table, slots)
    out = torch.empty((slots.shape[0], table.shape[1]), dtype=table.dtype, device=slots.device)
    if out.numel() == 0 or table.shape[0] == 0:
        return out.zero_()
    check_input(_stats is None or (_stats.dtype == torch.int64 and _stats.numel() >= 1
                                   and _stats.device == slots.device),
                "_stats must be an int64 tensor on the slots' device")
    if _sort:
        keys, pos = host_gather_plan(slots, table.shape[0])
    else:
        keys, pos = slots.contiguous(), None
    row_bytes = table.shape[1] * table.element_size()
    base, offset = _address(table)
    HOST_GATHER(base, offset, keys.data_ptr(), int(keys.dtype == torch.int64),
                None if pos is None else pos.data_ptr(), out.data_ptr(), table.shape[0],
                keys.shape[0], row_bytes, vector_bytes(row_bytes, table.data_ptr(), out.data_ptr()),
                None if _stats is None else _stats.data_ptr(), kernels.cuda_stream(slots.device))
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
    row_bytes = table.shape[1] * table.element_size()
    base, offset = _address(table)
    HOST_SCATTER(base, offset, slots.data_ptr(), int(slots.dtype == torch.int64), rows.data_ptr(),
                 table.shape[0], slots.shape[0], row_bytes,
                 vector_bytes(row_bytes, table.data_ptr(), rows.data_ptr()),
                 kernels.cuda_stream(slots.device))
    return table
