"""Binary file lists to and from the row store.

Port of ``wholegraph_tpu/io/file_io.py:34-192`` (the reference's
``wholememory_load_from_file`` / ``wholememory_store_to_file``,
cpp/src/wholememory/file_io.cpp). A file list is an ordered list of raw
binary files, each a whole number of rows of ``entry_size = dim *
itemsize`` bytes; rows are numbered in file order. The bytes on disk are
the JAX package's, so each package reads the other's files.

Reads go through the native reader (``csrc/fastio.cpp``, :mod:`.native`).
For a table on the card, the rows pass through a ring of two pinned
staging buffers of STAGING_BYTES each: the reader fills one while the other
is copied to the card (``copy_``, asynchronous), so loading a table of any
size pins no more than the ring. A host-located table, or any table of a
CPU run, is read straight into its own memory. :func:`read_rows_plain` and
:func:`write_rows_plain` are the numpy reader and writer that the native
ones are held against.

At world W each rank reads only the rows its shard owns (a block plan's
one range of rows, a round-robin plan's blocks), into a host buffer
(pinned for a card) and then onto its device; :func:`store_table` writes
each rank's own part files.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..memory.partition import PartitionPlan
from ..memory.sharded_table import LOCATIONS, ShardedTable, _host_empty, default_plan
from ..ops.host_kernels import pinned_empty
from ..parallel.mesh import Mesh
from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import as_torch_dtype
from ..utils.error import check_input
from .native import read_rows_native, write_rows_native

# bytes of each of the two pinned staging buffers of a load onto the card
STAGING_BYTES = 128 << 20


def filelist_entry_counts(filelist: Sequence[str], entry_size: int) -> List[int]:
    """Rows in each file; a file whose size is not a whole number of rows
    raises (file_io.cpp's size checks)."""
    counts = []
    for f in filelist:
        sz = os.path.getsize(f)
        check_input(sz % entry_size == 0, f"{f}: size {sz} not a multiple of {entry_size}")
        counts.append(sz // entry_size)
    return counts


def read_rows_plain(filelist: Sequence[str], file_starts, entry_size: int, lo: int, hi: int,
                    out) -> None:
    """The plain version of :func:`~.native.read_rows_native`: global rows
    ``[lo, hi)`` into the first bytes of ``out`` (a uint8 numpy array or
    CPU tensor), file by file with numpy."""
    flat = out.numpy() if isinstance(out, torch.Tensor) else out
    flat = flat.reshape(-1)
    check_input(hi <= file_starts[-1], f"row range [{lo},{hi}) exceeds total {file_starts[-1]}")
    fi = int(np.searchsorted(file_starts, lo, side="right") - 1)
    row, off = lo, 0
    while row < hi:
        fstart, fend = int(file_starts[fi]), int(file_starts[fi + 1])
        r0, r1 = row - fstart, min(hi, fend) - fstart
        nbytes = (r1 - r0) * entry_size
        with open(filelist[fi], "rb") as fh:
            fh.seek(r0 * entry_size)
            buf = fh.read(nbytes)
        check_input(len(buf) == nbytes, f"short read from {filelist[fi]}")
        flat[off:off + nbytes] = np.frombuffer(buf, np.uint8)
        off += nbytes
        row = fstart + r1
        fi += 1


def write_rows_plain(path: str, data) -> None:
    """The plain version of :func:`~.native.write_rows_native`."""
    arr = data.numpy() if isinstance(data, torch.Tensor) else np.ascontiguousarray(data)
    arr.view(np.uint8).tofile(path)


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _read_to_card(filelist, starts, entry_size: int, n: int, dst: torch.Tensor,
                  direct: Optional[bool]) -> None:
    """Rows ``[0, n)`` into the card's flat byte view ``dst`` through the
    two pinned staging buffers: the read of one chunk overlaps the copy of
    the one before."""
    chunk = max(1, STAGING_BYTES // entry_size)
    bufs = [pinned_empty((min(chunk, n) * entry_size,), torch.uint8) for _ in range(2)]
    done = [None, None]
    stream = torch.cuda.current_stream(dst.device)
    for k, lo in enumerate(range(0, n, chunk)):
        hi, b = min(n, lo + chunk), k % 2
        if done[b] is not None:
            done[b].synchronize()  # the copy out of this buffer has finished
        read_rows_native(filelist, starts, entry_size, lo, hi, bufs[b], direct=direct)
        nb = (hi - lo) * entry_size
        dst[lo * entry_size:lo * entry_size + nb].copy_(bufs[b][:nb], non_blocking=True)
        done[b] = torch.cuda.Event()
        done[b].record(stream)
    stream.synchronize()  # before the staging buffers go back to the allocator


def load_filelist(filelist, dim: int, dtype, *, plan: Optional[PartitionPlan] = None,
                  round_robin_size: int = 0, expected_rows: Optional[int] = None,
                  location: str = "device", direct: Optional[bool] = None,
                  device: DeviceLike = "cuda", mesh: Optional[Mesh] = None,
                  axis="data") -> ShardedTable:
    """A new :class:`ShardedTable` read from a binary file list
    (``wholememory_load_from_file`` analog, wholememory.h:450-456):
    ``[n, dim]`` rows of ``dtype`` (``[n]`` when ``dim == 0``), placed by
    ``plan``, or by a round-robin plan of ``round_robin_size`` blocks
    (file_io.cpp:102), or an equal one. At world 1 every plan places
    logical row i at physical row i; a round-robin plan's padding rows
    are zero. ``location="host"`` keeps the rows in pinned host memory.
    ``direct=True`` reads with O_DIRECT, None as ``WGTPU_DIRECT_IO`` says
    (:data:`~.native.DIRECT_IO`). A file whose size is not a whole
    number of rows, or a total other than ``expected_rows``, raises. With a
    ``mesh`` of W ranks the plan is over them (equal, round-robin or the
    caller's) and each rank reads only its shard's rows: the table equals
    the JAX package's ``load_filelist`` on a mesh of W devices."""
    if isinstance(filelist, (str, os.PathLike)):
        filelist = [filelist]
    filelist = [os.fspath(f) for f in filelist]
    dev = resolve_device(device)
    check_input(location in LOCATIONS, f"location must be one of {LOCATIONS}, got {location!r}")
    dt = as_torch_dtype(dtype)
    entry_size = max(int(dim), 1) * dt.itemsize
    counts = filelist_entry_counts(filelist, entry_size)
    n = sum(counts)
    if expected_rows is not None:
        check_input(n == expected_rows, f"filelist has {n} rows, expected {expected_rows}")
    world = 1 if mesh is None else mesh.axis_size(axis)
    if plan is None and round_robin_size:
        plan = PartitionPlan.round_robin(n, world, round_robin_size)
    plan = default_plan(plan, n, mesh, axis)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    if plan.world > 1:
        return _load_shard(filelist, starts, entry_size, plan, dim, dt, location, direct, dev,
                           mesh, axis)
    shape = (plan.total_physical_rows, dim) if dim else (plan.total_physical_rows,)
    if location == "host" or dev.type == "cpu":
        data = _host_empty(shape, dt, dev)
        read_rows_native(filelist, starts, entry_size, 0, n, _bytes_of(data), direct=direct)
        data[n:] = 0
        table = ShardedTable(data, plan, "host", dev)
        return table if location == "host" else table.to_location("device")
    data = torch.empty(shape, dtype=dt, device=dev)
    data[n:] = 0
    if n:
        _read_to_card(filelist, starts, entry_size, n, _bytes_of(data), direct)
    return ShardedTable(data, plan, "device", dev)


def shard_ranges(plan: PartitionPlan, s: int) -> List[tuple]:
    """Shard ``s``'s logical rows as ``(lo, hi)`` ranges in slot order: one
    for a block plan, a block each for a round-robin plan."""
    ids = plan.shard_logical_ids(s)
    if not ids.size:
        return []
    if plan.mode == "block":
        return [(int(ids[0]), int(ids[-1]) + 1)]
    return [(int(lo), min(int(lo) + plan.rr_block, plan.n)) for lo in ids[::plan.rr_block]]


def _load_shard(filelist, starts, entry_size: int, plan: PartitionPlan, dim: int,
                dt: torch.dtype, location: str, direct: Optional[bool], dev: torch.device,
                mesh: Mesh, axis) -> ShardedTable:
    """This rank's shard ``[capacity, dim]``: its ranges of rows read into a
    host buffer, padding rows zero, then moved to the card."""
    s = mesh.axis_index(axis)
    shape = (plan.capacity, dim) if dim else (plan.capacity,)
    data = _host_empty(shape, dt, dev)
    flat = _bytes_of(data)
    off = 0
    for lo, hi in shard_ranges(plan, s):
        read_rows_native(filelist, starts, entry_size, lo, hi, flat[off:], direct=direct)
        off += (hi - lo) * entry_size
    data[plan.shard_rows[s]:] = 0
    table = ShardedTable(data, plan, "host", dev, mesh, axis)
    return table if location == "host" else table.to_location("device")


def _shard_rows(table: ShardedTable, s: int, *, copy: bool) -> torch.Tensor:
    """Shard ``s``'s owned rows as a contiguous CPU tensor of the table's
    own dtype (a bfloat16 table stays bfloat16): a view of a host table's
    memory, or with ``copy`` (and always for a table on the card) a copy
    taken now, the card's stream synchronised."""
    rows = table.shard_data(s)
    if rows.device.type == "cpu" and not copy:
        return rows
    return rows.to("cpu", copy=True)


def part_path(path_prefix: str, s: int, world: int) -> str:
    """``{prefix}_part_{s}_of_{world}``, the part files' names in both packages."""
    return f"{path_prefix}_part_{s}_of_{world}"


def store_table(table: ShardedTable, path_prefix: str) -> List[str]:
    """Each shard's owned rows to ``{prefix}_part_{s}_of_{W}``
    (``wholememory_store_to_file`` analog), with the native threaded
    writer; returns the paths. The bytes are those of the JAX package's
    ``store_table`` for the same rows. At world W each rank writes its own
    part."""
    paths = []
    for s in table.addressable_shard_ids():
        p = part_path(path_prefix, s, table.plan.world)
        write_rows_native(p, _shard_rows(table, s, copy=False))
        paths.append(p)
    return paths


def load_table_from_parts(path_prefix: str, part_count: int, dim: int, dtype, *,
                          plan: Optional[PartitionPlan] = None,
                          saved_plan: Optional[PartitionPlan] = None, location: str = "device",
                          device: DeviceLike = "cuda") -> ShardedTable:
    """A table from the part files :func:`store_table` wrote at any world
    (``part_count``): block saves concatenate to logical row order and
    stream through :func:`load_filelist`; a round-robin save needs its
    ``saved_plan`` to put rows back in logical order first. So a table
    saved over 8 devices loads at world 1."""
    filelist = [part_path(path_prefix, s, part_count) for s in range(part_count)]
    if saved_plan is not None and saved_plan.mode != "block":
        dt = as_torch_dtype(dtype)
        logical = torch.zeros((saved_plan.n, dim) if dim else (saved_plan.n,), dtype=dt)
        for s, f in enumerate(filelist):
            rows = torch.from_numpy(np.fromfile(f, np.uint8)).view(dt)
            ids = torch.from_numpy(saved_plan.shard_logical_ids(s))
            logical[ids] = rows.reshape(-1, dim) if dim else rows
        return ShardedTable.from_array(logical, plan=plan, location=location, device=device)
    return load_filelist(filelist, dim, dtype, plan=plan, location=location, device=device)
