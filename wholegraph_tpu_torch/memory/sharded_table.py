"""ShardedTable: the WholeMemory-equivalent row store.

Port of ``wholegraph_tpu/memory/sharded_table.py``. A logical ``[n, dim]``
table (``[n]`` when ``dim == 0``) is placed by a
:class:`~wholegraph_tpu_torch.memory.partition.PartitionPlan`; logical ids
go through the plan on every access, so a round-robin or padded plan reads
the same rows as the JAX package's. At world 1 the table is its physical
``[plan.total_physical_rows, dim]`` tensor on one card. At world W each
rank is a process holding only its shard ``[plan.capacity, dim]`` (rank r's
shard is shard r of the plan), with the :class:`~wholegraph_tpu_torch.parallel.Mesh`
of the ranks; :meth:`gather` and :meth:`scatter` exchange ids and rows
between them (:mod:`wholegraph_tpu_torch.ops.gather`), and every rank calls
them together. :meth:`ShardedTable.from_filelist` reads a table from files
(:mod:`~wholegraph_tpu_torch.io`), each rank only its own rows.

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
from ..parallel.mesh import Mesh
from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import as_torch_dtype
from ..utils.error import NotSupported, check_input
from .partition import PartitionPlan

LOCATIONS = ("device", "host")


def world_of(mesh: Optional[Mesh], axis="data") -> int:
    """Ranks along ``axis`` of ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.axis_size(axis)


def default_plan(plan: Optional[PartitionPlan], n: int, mesh: Optional[Mesh],
                 axis="data") -> PartitionPlan:
    """``plan``, or the equal plan over the mesh axis; checked against ``n``
    rows and the axis's ranks."""
    world = world_of(mesh, axis)
    plan = PartitionPlan.equal(n, world) if plan is None else plan
    check_input(plan.n == n, f"plan rows {plan.n} != table rows {n}")
    check_input(plan.world == world,
                f"a plan of world {plan.world} needs a mesh of as many ranks along {axis!r}"
                + ("" if mesh is None else f", not {world}"))
    return plan


def local_rows(plan: PartitionPlan, shard: int, logical: torch.Tensor) -> torch.Tensor:
    """Shard ``shard``'s physical rows ``[capacity, ...]`` of a logical
    ``[n, ...]`` tensor (padding rows zero)."""
    out = logical.new_zeros((plan.capacity, *logical.shape[1:]))
    ids = torch.from_numpy(plan.shard_logical_ids(shard)).to(logical.device)
    out[:ids.shape[0]] = logical[ids]
    return out


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
    """A logical ``[n, dim]`` table stored by a partition plan.

    Attributes:
      data: at world 1 the physical rows ``[plan.total_physical_rows, dim]``
        (or ``[plan.total_physical_rows]`` for a 1-D table); at world W this
        rank's shard ``[plan.capacity, dim]``.
      plan: row partition plan over ``plan.world`` shards.
      location: ``"device"`` or ``"host"`` (pinned host memory).
      device: the card the table serves (``cpu`` on a CPU-only run).
      mesh, axis: at world W, the ranks' mesh and the axis the table is
        sharded over (``("node", "device")`` on a hierarchy mesh).
    """

    data: torch.Tensor
    plan: PartitionPlan
    location: str = "device"
    device: torch.device = torch.device("cuda")
    mesh: Optional[Mesh] = None
    axis: object = "data"

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
               location: str = "device", device: DeviceLike = "cuda",
               mesh: Optional[Mesh] = None, axis="data") -> "ShardedTable":
        """A zero table, or one filled by ``init(generator, shape, dtype)``
        (a tensor of the whole physical shape ``[plan.total_physical_rows,
        dim]``, as the JAX package draws it; ``generator`` defaults to one on
        ``device`` seeded with 0) — the create_wholememory analog
        (memory_handle.cpp:1793). At world W (``mesh``) every rank draws the
        whole table and keeps its shard."""
        dev = resolve_device(device)
        check_input(location in LOCATIONS, f"location must be one of {LOCATIONS}, got {location!r}")
        check_input(n >= 0 and dim >= 0, "n and dim must not be negative")
        plan = default_plan(plan, n, mesh, axis)
        rows = plan.total_physical_rows if plan.world == 1 else plan.capacity
        shape = (rows, dim) if dim else (rows,)
        dt = as_torch_dtype(dtype)
        mesh = mesh if plan.world > 1 else None
        if init is None:
            data = (torch.zeros(shape, dtype=dt, device=dev) if location == "device"
                    else _host_empty(shape, dt, dev).zero_())
            return ShardedTable(data, plan, location, dev, mesh, axis)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        full = (plan.total_physical_rows, dim) if dim else (plan.total_physical_rows,)
        vals = init(gen, full, dt)
        check_input(tuple(vals.shape) == full, f"init gave {tuple(vals.shape)}, not {full}")
        if plan.world > 1:
            start = mesh.axis_index(axis) * plan.capacity
            vals = vals[start:start + plan.capacity]
        return ShardedTable(vals.to(device=dev, dtype=dt).contiguous(), plan, "device", dev, mesh,
                            axis).to_location(location)

    @staticmethod
    def from_array(arr, *, plan: Optional[PartitionPlan] = None, location: str = "device",
                   device: DeviceLike = "cuda", mesh: Optional[Mesh] = None,
                   axis="data") -> "ShardedTable":
        """A table from a host logical ``[n, dim]`` (or ``[n]``) array or
        tensor, its rows placed by ``plan.physical_index_np``. At world W
        every rank passes the whole array and keeps its shard's rows."""
        dev = resolve_device(device)
        check_input(location in LOCATIONS, f"location must be one of {LOCATIONS}, got {location!r}")
        src = _as_cpu_tensor(arr)
        check_input(src.dim() in (1, 2), f"array must be [n, dim] or [n], got {tuple(src.shape)}")
        n = src.shape[0]
        plan = default_plan(plan, n, mesh, axis)
        if plan.world > 1:
            phys = local_rows(plan, mesh.axis_index(axis), src)
        else:
            mesh = None
            phys = torch.zeros((plan.total_physical_rows, *src.shape[1:]), dtype=src.dtype)
            phys[torch.from_numpy(plan.physical_index_np(np.arange(n)))] = src
        if location == "host":
            return ShardedTable(_host_empty(tuple(phys.shape), phys.dtype, dev).copy_(phys), plan,
                                "host", dev, mesh, axis)
        return ShardedTable(phys.to(dev), plan, "device", dev, mesh, axis)

    @staticmethod
    def from_filelist(filelist, dim: int, dtype, *, plan: Optional[PartitionPlan] = None,
                      round_robin_size: int = 0, expected_rows: Optional[int] = None,
                      location: str = "device", direct: Optional[bool] = None,
                      device: DeviceLike = "cuda", mesh: Optional[Mesh] = None,
                      axis="data") -> "ShardedTable":
        """A table read from a binary file list (tensor.from_filelist
        analog, torch/tensor.py:155): :func:`~wholegraph_tpu_torch.io.load_filelist`.
        ``location="host"`` keeps the rows in pinned host memory. ``direct``
        None reads with O_DIRECT when ``WGTPU_DIRECT_IO=1``. At world W each
        rank reads only its shard's rows."""
        from ..io.file_io import load_filelist

        return load_filelist(filelist, dim, dtype, plan=plan, round_robin_size=round_robin_size,
                             expected_rows=expected_rows, location=location, direct=direct,
                             device=device, mesh=mesh, axis=axis)

    # -- access ---------------------------------------------------------------

    def _served(self, what: str) -> None:
        if self.location != "device":
            raise NotSupported(
                f"{what} on a host-located table: the host location is a staging tier; "
                "call to_location('device') first")

    def gather(self, ids: torch.Tensor, **kw) -> torch.Tensor:
        """Rows by logical id (wholememory_gather analog); ids outside
        ``[0, n)`` give zero rows. Keywords go to :func:`ops.gather`
        (``local_kernel="ring"`` or ``"sorted"``; at world W ``method``,
        ``capacity_factor``, ``dedup``). At world W every rank calls it with
        its own ids."""
        self._served("gather")
        return _gather_rows(self.data, ids, plan=self.plan, mesh=self.mesh, axis=self.axis, **kw)

    def scatter(self, ids: torch.Tensor, rows: torch.Tensor, **kw) -> "ShardedTable":
        """Rows written by logical id; a new table unless ``donate=True``.
        Keywords go to :func:`ops.scatter` (``accumulate``, ``donate``; at
        world W ``capacity_factor``, ``exact``)."""
        self._served("scatter")
        data = _scatter_rows(self.data, ids, rows, plan=self.plan, mesh=self.mesh,
                             axis=self.axis, **kw)
        return dataclasses.replace(self, data=data)

    def physical(self) -> torch.Tensor:
        """The whole physical table on this rank's device: the table itself
        at world 1, every rank's shard gathered at world W (a collective)."""
        if self.plan.world == 1:
            return self.data.detach()
        from ..parallel.collectives import fetch_global

        return fetch_global(self.data.to(self.device), self.mesh, self.axis)

    def _logical(self, ids: np.ndarray) -> np.ndarray:
        phys = torch.from_numpy(self.plan.physical_index_np(ids))
        data = self.physical()
        return _to_numpy(data[phys.to(data.device)].cpu())

    def to_array(self) -> np.ndarray:
        """The logical ``[n, dim]`` array on the host (tests, IO); a bfloat16
        table comes back widened to float32, exactly. At world W a
        collective: every rank gets the whole array."""
        return self._logical(np.arange(self.n))

    def addressable_shard_ids(self):
        """Plan shards whose rows this process holds: every one at world 1,
        its rank's at world W."""
        if self.plan.world == 1:
            return list(range(self.plan.world))
        return [self.mesh.axis_index(self.axis)]

    def shard_data(self, s: int) -> torch.Tensor:
        """Shard ``s``'s owned rows of :attr:`data` (a view, no padding)."""
        check_input(s in self.addressable_shard_ids(), f"shard {s} is not held here")
        start = s * self.plan.capacity if self.plan.world == 1 else 0
        return self.data.detach()[start:start + self.plan.shard_rows[s]]

    def local_shard(self, s: int) -> np.ndarray:
        """Host copy of shard ``s``'s owned rows, in slot order, without
        padding (get_local_memory analog)."""
        return _to_numpy(self.shard_data(s).cpu())

    def sub_rows(self, start: int, stop: int) -> np.ndarray:
        """Host copy of logical rows ``[start, stop)`` (subtensor analog; at
        world W a collective)."""
        return self._logical(np.arange(self.n)[start:stop])
