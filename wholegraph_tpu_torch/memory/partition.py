"""Row-partition plans for sharded tables.

Port of ``wholegraph_tpu/memory/partition.py``: the per-shard entry
partition of the reference (memory_handle.cpp:69-78), custom non-equal
partitions (wholememory.h:259-268) and the round-robin storage-index map
(map_indices_func.cu, file_io.cpp:102-199). A plan maps a *logical* row id
to ``(owner shard, slot within the shard)``; the physical table holds
``world * capacity`` rows, shard ``s`` owning ``[s*capacity, s*capacity +
shard_rows[s])``.

The mapping functions take and return torch tensors (``*_np`` takes numpy)
and reproduce the JAX package's integer results exactly, out-of-range ids
included, so a plan made here and one made there place every row alike.
Plans of any world are index math and are ported whole; the tables and the
exchange that use ``world > 1`` are not (ROADMAP Queue 1 item 13).

Index width: the JAX package refuses tables of ``2**31`` physical rows or
more (``ops/gather.py:72-81``), because with x64 disabled it indexes in
int32. The port indexes in int64 (``physical_index`` widens int32 ids when
the table needs it), so it accepts such tables.

Three modes:

* ``block`` equal — shard ``s`` owns logical rows ``[s*per, min((s+1)*per, n))``
  with ``per = ceil(n/world)`` (the reference's default plan).
* ``block`` custom — arbitrary per-shard row counts (non-equal partitions).
* ``round_robin`` — fixed-size blocks of rows dealt round-robin to shards
  (the reference's round-robin file sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.error import check_input


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Static, hashable description of a 1-D row partition over ``world`` shards.

    Attributes:
      n: number of logical rows.
      world: number of shards.
      shard_rows: rows owned by each shard; ``sum(shard_rows) == n``.
      capacity: per-shard physical slot count. The physical table has
        ``world * capacity`` rows; rows past ``shard_rows[s]`` within a shard
        are padding.
      mode: 'block' or 'round_robin'.
      rr_block: round-robin block size when ``mode == 'round_robin'``.
    """

    n: int
    world: int
    shard_rows: Tuple[int, ...]
    capacity: int
    mode: str = "block"
    rr_block: int = 0

    # ---- constructors -------------------------------------------------------

    @staticmethod
    def equal(n: int, world: int) -> "PartitionPlan":
        """Default plan: ceil-divided contiguous blocks (reference default)."""
        check_input(n >= 0 and world >= 1, "bad partition args")
        per = _ceil_div(max(n, 1), world)
        rows = tuple(max(0, min(per, n - s * per)) for s in range(world))
        return PartitionPlan(n=n, world=world, shard_rows=rows, capacity=per)

    @staticmethod
    def custom(shard_rows) -> "PartitionPlan":
        """Non-equal contiguous blocks (reference rank_entry_partition)."""
        rows = tuple(int(r) for r in shard_rows)
        check_input(all(r >= 0 for r in rows), "negative shard size")
        return PartitionPlan(n=sum(rows), world=len(rows), shard_rows=rows,
                             capacity=max(max(rows), 1))

    @staticmethod
    def round_robin(n: int, world: int, block: int) -> "PartitionPlan":
        """Blocks of ``block`` rows dealt round-robin to shards (reference
        round-robin file sharding, file_io.cpp:102)."""
        check_input(n >= 0 and world >= 1 and block >= 1, "bad rr partition args")
        nblocks = _ceil_div(n, block)
        rows = tuple(sum(min(block, n - b * block) for b in range(s, nblocks, world))
                     for s in range(world))
        capacity = _ceil_div(nblocks, world) * block if nblocks else 1
        return PartitionPlan(n=n, world=world, shard_rows=rows, capacity=max(capacity, 1),
                             mode="round_robin", rr_block=block)

    # ---- derived (host-side) ------------------------------------------------

    @property
    def is_equal_block(self) -> bool:
        if self.mode != "block":
            return False
        per = self.capacity
        return all(r == max(0, min(per, self.n - s * per))
                   for s, r in enumerate(self.shard_rows)
                   ) and per == _ceil_div(max(self.n, 1), self.world)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Cumulative logical start row of each shard (block modes)."""
        out, acc = [], 0
        for r in self.shard_rows:
            out.append(acc)
            acc += r
        return tuple(out)

    @property
    def total_physical_rows(self) -> int:
        return self.world * self.capacity

    def shard_row_start(self, s: int) -> int:
        return self.offsets[s]

    def shard_logical_ids(self, s: int) -> np.ndarray:
        """Logical row ids owned by shard ``s``, in slot order (int64)."""
        if self.mode == "block":
            start = self.offsets[s]
            return np.arange(start, start + self.shard_rows[s], dtype=np.int64)
        nblocks = _ceil_div(self.n, self.rr_block) if self.n else 0
        ids = [np.arange(b * self.rr_block, min((b + 1) * self.rr_block, self.n), dtype=np.int64)
               for b in range(s, nblocks, self.world)]
        return np.concatenate(ids) if ids else np.zeros((0,), dtype=np.int64)

    # ---- torch mapping functions --------------------------------------------

    def _offsets_at(self, owner: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``offsets[owner]`` with the JAX package's indexing rule: a
        negative index counts from the end, then the index is clamped into
        range (``jnp`` gathers clamp; torch would raise)."""
        offs = torch.tensor(self.offsets, dtype=dtype, device=owner.device)
        idx = torch.where(owner < 0, owner + self.world, owner).clamp(0, self.world - 1)
        return offs[idx.long()]

    def owner(self, ids: torch.Tensor) -> torch.Tensor:
        """Owning shard of each logical row id, int32."""
        if self.mode == "round_robin":
            return ((ids // self.rr_block) % self.world).to(torch.int32)
        if self.is_equal_block:
            return torch.clamp(ids // self.capacity, max=self.world - 1).to(torch.int32)
        offs = torch.tensor(self.offsets + (self.n,), dtype=ids.dtype, device=ids.device)
        return (torch.searchsorted(offs, ids.contiguous(), right=True) - 1).to(torch.int32)

    def local_slot(self, ids: torch.Tensor, owner: torch.Tensor | None = None) -> torch.Tensor:
        """Slot of each logical row within its owner shard, in ``ids``' dtype."""
        if self.mode == "round_robin":
            blk = ids // self.rr_block
            return (blk // self.world) * self.rr_block + ids % self.rr_block
        if owner is None:
            owner = self.owner(ids)
        return ids - self._offsets_at(owner, ids.dtype)

    def physical_index(self, ids: torch.Tensor) -> torch.Tensor:
        """Row index into the physical ``[world * capacity]`` table, in
        ``ids``' dtype; int32 ids are widened to int64 when the table has
        ``2**31`` physical rows or more."""
        if ids.dtype == torch.int32 and self.total_physical_rows >= 2**31:
            ids = ids.long()
        owner = self.owner(ids)
        return owner.to(ids.dtype) * self.capacity + self.local_slot(ids, owner)

    def physical_index_np(self, ids) -> np.ndarray:
        """Host (numpy, int64) version of :meth:`physical_index` for I/O paths."""
        ids = np.asarray(ids, dtype=np.int64)
        if self.mode == "round_robin":
            blk = ids // self.rr_block
            owner = blk % self.world
            slot = (blk // self.world) * self.rr_block + ids % self.rr_block
            return owner * self.capacity + slot
        offs = np.asarray(self.offsets + (self.n,), dtype=np.int64)
        owner = np.searchsorted(offs, ids, side="right") - 1
        return owner * self.capacity + ids - offs[owner]
