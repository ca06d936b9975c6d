"""ShardedTable: the WholeMemory-equivalent row store, on one card.

Port of ``wholegraph_tpu/memory/sharded_table.py`` for a plan of one shard.
A logical ``[n, dim]`` table (``[n]`` when ``dim == 0``) is stored as its
physical ``[plan.total_physical_rows, dim]`` tensor, rows placed by the
:class:`~wholegraph_tpu_torch.memory.partition.PartitionPlan`; logical ids
go through the plan on every access, so a round-robin or padded plan reads
the same rows as the JAX package's. Tables sharded over several cards, and
the exchange between them, are not ported yet (ROADMAP Queue 1 item 13).

Like the JAX table it is functional: :meth:`ShardedTable.scatter` returns a
new table and leaves this one as it was, unless ``donate=True`` asks for
the write in place.

``location``: ``"device"`` keeps the rows in the card's memory and serves
:meth:`gather` and :meth:`scatter` (kernels J or I, and B); ``"host"``
keeps them in pinned host memory, the staging tier of the JAX package
(``sharded_table.py:86-96``), which serves neither: move it to the card
with :meth:`to_location` first. (The host-memory tier that the card reads
in place is :class:`~wholegraph_tpu_torch.embedding.HostEmbedding`.) On a
CPU-only run (``device="cpu"``) a host table is an ordinary CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.gather import gather as _gather_rows, scatter as _scatter_rows
from ..ops.host_kernels import pinned_empty
from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import as_torch_dtype
from ..utils.error import NotSupported, check_input
from .partition import PartitionPlan

LOCATIONS = ("device", "host")


def _check_plan(plan: PartitionPlan, n: int) -> None:
    if plan.world != 1:
        raise NotImplementedError(
            f"a plan of world {plan.world}: tables sharded over several cards are not "
            "ported yet (ROADMAP Queue 1 item 13); the port's store holds one shard")
    check_input(plan.n == n, f"plan rows {plan.n} != table rows {n}")


def _host_empty(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Pinned host memory for a card's table; plain CPU memory for a CPU run."""
    if device.type == "cuda":
        return pinned_empty(shape, dtype)
    return torch.empty(shape, dtype=dtype)


def _as_cpu_tensor(arr) -> torch.Tensor:
    """A CPU tensor of ``arr`` (a tensor, or a numpy array, ``bfloat16``
    included), keeping its dtype."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu()
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it over
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """numpy copy of a CPU tensor; bfloat16 widened to float32, exactly."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


@dataclasses.dataclass
class ShardedTable:
    """A logical ``[n, dim]`` table stored by a one-shard partition plan.

    Attributes:
      data: physical rows ``[plan.total_physical_rows, dim]`` (or
        ``[plan.total_physical_rows]`` for a 1-D table).
      plan: row partition plan, ``world == 1``.
      location: ``"device"`` or ``"host"`` (pinned host memory).
      device: the card the table serves (``cpu`` on a CPU-only run).
    """

    data: torch.Tensor
    plan: PartitionPlan
    location: str = "device"
    device: torch.device = torch.device("cuda")

    # -- properties -----------------------------------------------------------

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def dim(self) -> int:
        return self.data.shape[1] if self.data.dim() > 1 else 0

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def shape(self):
        return (self.n, self.dim) if self.dim else (self.n,)

    def to_location(self, location: str) -> "ShardedTable":
        """The table moved to ``"device"`` or ``"host"`` memory."""
        check_input(location in LOCATIONS, f"location must be one of {LOCATIONS}, got {location!r}")
        if location == self.location:
            return self
        if location == "host":
            data = _host_empty(tuple(self.data.shape), self.dtype, self.device).copy_(self.data)
        else:
            data = self.data.to(self.device)
        return dataclasses.replace(self, data=data, location=location)

    # -- creation -------------------------------------------------------------

    @staticmethod
    def create(n: int, dim: int, dtype="float32", *, plan: Optional[PartitionPlan] = None,
               init: Optional[Callable] = None, generator: Optional[torch.Generator] = None,
               location: str = "device", device: DeviceLike = "cuda") -> "ShardedTable":
        """A zero table, or one filled by ``init(generator, shape, dtype)``
        (a tensor of the physical shape; ``generator`` defaults to one on
        ``device`` seeded with 0) — the create_wholememory analog
        (memory_handle.cpp:1793)."""
        dev = resolve_device(device)
        check_input(location in LOCATIONS, f"location must be one of {LOCATIONS}, got {location!r}")
        check_input(n >= 0 and dim >= 0, "n and dim must not be negative")
        plan = PartitionPlan.equal(n, 1) if plan is None else plan
        _check_plan(plan, n)
        shape = (plan.total_physical_rows, dim) if dim else (plan.total_physical_rows,)
        dt = as_torch_dtype(dtype)
        if init is None:
            data = (torch.zeros(shape, dtype=dt, device=dev) if location == "device"
                    else _host_empty(shape, dt, dev).zero_())
            return ShardedTable(data, plan, location, dev)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        vals = init(gen, shape, dt)
        check_input(tuple(vals.shape) == shape, f"init gave {tuple(vals.shape)}, not {shape}")
        return ShardedTable(vals.to(device=dev, dtype=dt), plan, "device", dev).to_location(location)

    @staticmethod
    def from_array(arr, *, plan: Optional[PartitionPlan] = None, location: str = "device",
                   device: DeviceLike = "cuda") -> "ShardedTable":
        """A table from a host logical ``[n, dim]`` (or ``[n]``) array or
        tensor, its rows placed by ``plan.physical_index_np``."""
        dev = resolve_device(device)
        check_input(location in LOCATIONS, f"location must be one of {LOCATIONS}, got {location!r}")
        src = _as_cpu_tensor(arr)
        check_input(src.dim() in (1, 2), f"array must be [n, dim] or [n], got {tuple(src.shape)}")
        n = src.shape[0]
        plan = PartitionPlan.equal(n, 1) if plan is None else plan
        _check_plan(plan, n)
        phys = torch.zeros((plan.total_physical_rows, *src.shape[1:]), dtype=src.dtype)
        phys[torch.from_numpy(plan.physical_index_np(np.arange(n)))] = src
        if location == "host":
            return ShardedTable(_host_empty(tuple(phys.shape), phys.dtype, dev).copy_(phys), plan,
                                "host", dev)
        return ShardedTable(phys.to(dev), plan, "device", dev)

    @staticmethod
    def from_filelist(*args, **kwargs) -> "ShardedTable":
        """Not ported yet: file IO is the IO slice's (ROADMAP Queue 1 item 16)."""
        raise NotImplementedError(
            "ShardedTable.from_filelist waits for the IO slice (ROADMAP Queue 1 item 16)")

    # -- access ---------------------------------------------------------------

    def _served(self, what: str) -> None:
        if self.location != "device":
            raise NotSupported(
                f"{what} on a host-located table: the host location is a staging tier; "
                "call to_location('device') first")

    def gather(self, ids: torch.Tensor, **kw) -> torch.Tensor:
        """Rows by logical id (wholememory_gather analog); ids outside
        ``[0, n)`` give zero rows. Keywords go to :func:`ops.gather`
        (``local_kernel="ring"`` or ``"sorted"``)."""
        self._served("gather")
        return _gather_rows(self.data, ids, plan=self.plan, **kw)

    def scatter(self, ids: torch.Tensor, rows: torch.Tensor, **kw) -> "ShardedTable":
        """Rows written by logical id; a new table unless ``donate=True``.
        Keywords go to :func:`ops.scatter` (``accumulate``, ``donate``)."""
        self._served("scatter")
        data = _scatter_rows(self.data, ids, rows, plan=self.plan, **kw)
        return dataclasses.replace(self, data=data)

    def _logical(self, ids: np.ndarray) -> np.ndarray:
        phys = torch.from_numpy(self.plan.physical_index_np(ids))
        return _to_numpy(self.data.detach()[phys.to(self.data.device)].cpu())

    def to_array(self) -> np.ndarray:
        """The logical ``[n, dim]`` array on the host (tests, IO); a bfloat16
        table comes back widened to float32, exactly."""
        return self._logical(np.arange(self.n))

    def addressable_shard_ids(self):
        """Plan shards whose rows this process holds: every one, at world 1."""
        return list(range(self.plan.world))

    def local_shard(self, s: int) -> np.ndarray:
        """Host copy of shard ``s``'s owned rows, in slot order, without
        padding (get_local_memory analog)."""
        check_input(s in self.addressable_shard_ids(), f"shard {s} is not held here")
        start = s * self.plan.capacity
        return _to_numpy(self.data.detach()[start:start + self.plan.shard_rows[s]].cpu())

    def sub_rows(self, start: int, stop: int) -> np.ndarray:
        """Host copy of logical rows ``[start, stop)`` (subtensor analog)."""
        return self._logical(np.arange(self.n)[start:stop])
