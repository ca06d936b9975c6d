"""Host-memory embedding with a device cache, on one card or over ranks.

Port of ``wholegraph_tpu/embedding/host_embedding.py``, the counterpart of
the reference's ``device_cached_host_embedding`` (embedding.cpp:564-767):
the table and one f32 tensor per optimizer state slot live in pinned host
memory, and the card keeps a cache of hot rows.

- ``host_table`` [rows, D] and ``host_slots`` [rows, D] f32 are CPU tensors
  in page-locked, mapped memory, each in an allocation of its own bytes (the
  request rounded up to 2 MiB) from the kernels' library
  (:func:`~..ops.host_kernels.host_zeros`), freed with the embedding (on
  the CPU ordinary memory); the card reads their rows over PCIe with kernel
  E (the gather) and reads, updates and writes them back with kernel L's
  host route (the apply).
- ``cache_map`` [rows] int32 on the card maps a row's slot to its cache
  line or -1; ``cache_rows`` [hot_cap, D] on the card holds the cached
  rows. The hot set is static between :meth:`HostEmbedding.rebuild_cache`
  calls (``hot_ids_by_degree``, or ``hot_ids_by_count`` over a
  ``TouchCounter``).
- Coherence invariant: for every cached row, ``cache_rows[line]`` equals
  the host row. Every update writes the host (the source of truth) and
  the cached line (``update_cache_direct``, embedding.cpp:640-650), in the
  same launch.

At world 1 ``rows`` is ``n`` and a row's slot is its id. At world W
(``mesh=``, one process a rank) each rank holds its shard of the table and
of every slot, ``rows = plan.capacity`` placed by the
:class:`~wholegraph_tpu_torch.memory.PartitionPlan`, and a cache of its own
``hot_cap = max(int(plan.capacity * cache_ratio), 1)`` lines, which holds
only the hot rows it owns (the reference: each rank fronts its own
partition). The gather is the exact exchange (``gather_exact_loop``) with
the owner's serve of hits from the cache and misses from its host shard
(``_serve_cached_host``, ``host_embedding.py:146-160``); the apply dedups,
sends every (id, gradient) pair to its owner (``exchange_grads_exact``) and
steps the owner's rows (``_host_apply_shard``, ``:185-249``).

As the port's :class:`~.embedding.Embedding`, the object owns its tensors
and updates them in place.

Ordering: kernels E and L run on the current stream, so a step's E reads
see the previous step's L writes. Host code that touches the pinned
tensors (:meth:`from_array`, :meth:`init`, :meth:`to_array`,
:meth:`slot_to_array`) first waits for the card, because a kernel may still
be writing them; so does every collective on the gloo route
(``parallel/collectives.py``), so a copy gloo makes of a card tensor sees
the F writes enqueued before it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..memory import PartitionPlan, ShardedTable
from ..memory.sharded_table import default_plan, local_rows
from ..ops.gather import EXCHANGE_STATS, _bucket_cap, _in_range, gather_exact_loop
from ..ops.gather_kernels import gather_rows
from ..ops.host_kernels import host_gather_rows, host_zeros
from ..ops.optim_kernels import apply_rows_host
from ..parallel.mesh import Mesh
from ..utils import perf
from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import as_torch_dtype
from ..utils.error import check_input
# re-exported, as JAX's host_embedding does (wholegraph_tpu/embedding/host_embedding.py:558-563)
from .cache import hot_ids_by_degree  # noqa: F401
from .embedding import _dedup_sorted, exchange_grads_exact, row_train_step
from .optimizers import SGD, SparseOptimizer


class HostEmbedding:
    """Embedding table and sparse optimizer state in pinned host memory,
    fronted by a cache of hot rows on the card (device_cached_host_embedding
    analog); at world W this rank's shard of them. With ``device="cpu"``
    every tensor is an ordinary CPU tensor and the kernels' plain versions
    run."""

    def __init__(self, n: int, dim: int, optimizer: SparseOptimizer, dtype: torch.dtype,
                 cache_ratio: float, device: torch.device, *,
                 plan: Optional[PartitionPlan] = None, mesh: Optional[Mesh] = None,
                 axis="data"):
        self.n, self.dim = int(n), int(dim)
        self.plan = default_plan(plan, self.n, mesh, axis)
        if self.plan.world == 1:
            self.plan = PartitionPlan.equal(self.n, 1)  # every world-1 plan places row i at i
        self.mesh = mesh if self.plan.world > 1 else None
        self.axis = axis
        self.optimizer = optimizer
        self.dtype = dtype
        self.device = device
        rows = self.plan.capacity
        self.hot_cap = max(int(rows * cache_ratio), 1)

        shape = (rows, self.dim)
        self.host_table = host_zeros(shape, dtype, device)
        self.host_slots: Dict[str, torch.Tensor] = {s: host_zeros(shape, torch.float32, device)
                                                    for s in optimizer.slot_names}
        self.cache_map = torch.full((rows,), -1, dtype=torch.int32, device=device)
        self.cache_rows = torch.zeros((self.hot_cap, self.dim), dtype=dtype, device=device)
        self.step = 0

    @property
    def world(self) -> int:
        return self.plan.world

    def _rank(self) -> int:
        return 0 if self.world == 1 else self.mesh.axis_index(self.axis)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(n: int, dim: int, *, optimizer: Optional[SparseOptimizer] = None,
               dtype="float32", cache_ratio: float = 0.1, device: DeviceLike = "cuda",
               mesh: Optional[Mesh] = None, axis="data",
               plan: Optional[PartitionPlan] = None) -> "HostEmbedding":
        """A zero host table with zero optimizer slots and an empty cache of
        ``max(int(capacity * cache_ratio), 1)`` lines on ``device`` (the
        reference's cache_ratio knob, embedding_cache.hpp:27-33), ``capacity``
        being ``n`` at world 1 and a shard's rows under ``plan`` (equal by
        default) with a ``mesh`` of W ranks, of which this rank holds its
        own."""
        check_input(n > 0 and dim > 0, "n and dim must be positive")
        return HostEmbedding(n, dim, optimizer or SGD(), as_torch_dtype(dtype), cache_ratio,
                             resolve_device(device), plan=plan, mesh=mesh, axis=axis)

    def _wait(self) -> None:
        """Wait for the card before host code touches the pinned tensors."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _local(self, logical: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a logical ``[n, dim]`` tensor."""
        if self.world == 1:
            return logical
        return local_rows(self.plan, self._rank(), logical)

    @torch.no_grad()
    def from_array(self, arr, hot_ids=None) -> "HostEmbedding":
        """Table from a host ``[n, dim]`` array (at world W every rank passes
        the whole array and keeps its rows), zero slots, step 0, and the
        cache filled with ``hot_ids`` (e.g. :func:`~.cache.hot_ids_by_degree`;
        default: nothing cached)."""
        arr = np.asarray(arr)
        check_input(arr.shape == (self.n, self.dim), f"array shape {arr.shape} != {(self.n, self.dim)}")
        self._wait()
        self.host_table.copy_(self._local(torch.from_numpy(np.ascontiguousarray(arr))))
        return self._reset(hot_ids)

    @torch.no_grad()
    def init(self, generator: torch.Generator, hot_ids=None) -> "HostEmbedding":
        """Scaled-normal table (std 1/sqrt(dim)) drawn from ``generator``,
        the same draw as :meth:`Embedding.init` (at world W every rank draws
        the whole table and keeps its rows); zero slots, step 0, the cache
        filled with ``hot_ids``."""
        vals = torch.randn((self.n, self.dim), generator=generator, device=generator.device)
        self._wait()
        self.host_table.copy_(self._local(vals.mul_(1.0 / math.sqrt(self.dim))))
        del vals
        return self._reset(hot_ids)

    def _reset(self, hot_ids) -> "HostEmbedding":
        for s in self.host_slots.values():
            s.zero_()
        self.step = 0
        return self.rebuild_cache(hot_ids)

    def _hot_slots(self, hot_ids) -> np.ndarray:
        """The slots of this rank's shard that ``hot_ids`` caches: the sorted
        unique hot ids this rank owns, the first ``hot_cap`` of them in that
        order (``host_embedding.py:334-350``), as slots."""
        hot = np.unique(np.asarray(hot_ids if hot_ids is not None else [], np.int64))
        if not len(hot):
            return hot
        check_input(hot[0] >= 0 and hot[-1] < self.n, "hot id out of range")
        pidx = self.plan.physical_index_np(hot)
        mine = np.nonzero(pidx // self.plan.capacity == self._rank())[0][: self.hot_cap]
        return pidx[mine] % self.plan.capacity

    @torch.no_grad()
    def rebuild_cache(self, hot_ids) -> "HostEmbedding":
        """Re-select the cached rows and fill them from the current host
        table (kernel E); host table, slots and step are untouched, so the
        coherence invariant holds by construction. ``hot_ids`` is a host
        array of row ids, the same on every rank; each rank caches
        :meth:`_hot_slots`, and None or an empty array caches nothing."""
        self.cache_map.fill_(-1)
        self.cache_rows.zero_()
        slots = self._hot_slots(hot_ids)
        if len(slots):
            ids = torch.from_numpy(slots).to(self.device)
            self.cache_map[ids] = torch.arange(ids.shape[0], dtype=torch.int32, device=self.device)
            self.cache_rows[: ids.shape[0]] = host_gather_rows(self.host_table, ids, _sort=False)
        return self

    # -- forward --------------------------------------------------------------

    def _serve(self, slot: torch.Tensor, sort: bool = True) -> torch.Tensor:
        """Rows at this rank's ``slot`` (-1 for none): hits from
        ``cache_rows`` (kernel A), misses from the host shard (kernel E, slot
        -1 for every hit, so the host link carries only the misses), zero
        rows for -1 (``_serve_cached_host``, host_embedding.py:146-160)."""
        valid = slot >= 0
        line = self.cache_map[torch.where(valid, slot, 0).long()]
        hit = valid & (line >= 0)
        hot = gather_rows(self.cache_rows, torch.where(hit, line, 0))
        cold = host_gather_rows(self.host_table, torch.where(valid & ~hit, slot, -1), _sort=sort)
        return torch.where(hit[:, None], hot, cold)

    def gather(self, ids: torch.Tensor, *, capacity_factor: float = 2.0,
               _sort: bool = True) -> torch.Tensor:
        """Rows at ``ids`` [B] on the card, zero rows for ids outside ``[0,
        n)``. At world 1 this rank's serve; at world W every rank passes its
        own ids (as many on every rank) and the exact exchange
        (``gather_exact_loop``, ``capacity_factor`` its bucket headroom)
        brings them to their owners, whose serve answers them.
        ``_sort=False`` (internal, world 1) passes to
        :func:`host_gather_rows` for ids that are unique and need no sort,
        as the sampler's are."""
        check_input(ids.dim() == 1, f"ids must be 1-D, got {tuple(ids.shape)}")
        if self.world == 1:
            valid = (ids >= 0) & (ids < self.n)
            return self._serve(torch.where(valid, ids, -1), _sort)
        plan = self.plan
        ok, owner0 = _in_range(ids, plan)
        out = self.cache_rows.new_zeros((ids.shape[0], self.dim))
        delivered = torch.cat([~ok, ok.new_ones(1)])  # out-of-range ids stay zero rows

        def serve(req):
            valid = req < plan.n
            return self._serve(torch.where(valid, plan.local_slot(torch.where(valid, req, 0)), -1))

        EXCHANGE_STATS["calls"] += 1
        return gather_exact_loop(serve, ids, owner0, out, delivered, world=plan.world,
                                 mesh=self.mesh, axis=self.axis,
                                 cap=_bucket_cap(ids.shape[0], plan.world, capacity_factor),
                                 oob=plan.n)

    # -- backward / optimizer -------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, ids: torch.Tensor, grads: torch.Tensor, lr: float, *,
                        mask: Optional[torch.Tensor] = None,
                        capacity_factor: float = 2.0) -> "HostEmbedding":
        """Sparse optimizer step on the host rows and their cached lines, in
        place (``_host_apply_shard``, host_embedding.py:185-248).

        Duplicate ids are summed; masked-out ids and ids outside ``[0, n)``
        touch nothing. At world W every rank passes its own (ids, grads), as
        many on every rank: :func:`exchange_grads_exact` sums duplicates
        within and across ranks on their owner. The owner's touched rows,
        their optimizer state and the cached lines among them go through
        :func:`~..ops.optim_kernels.apply_rows_host` at the owner's slots
        (ascending): on a card one launch of kernel L's host route reads the
        rows over PCIe, updates them, writes them back and rewrites their
        cache lines; an optimizer from outside the registry runs kernel E on
        the table and each slot, its update, kernel F on each and kernel B
        on the lines. Its span is ``sparse_apply`` (``utils.perf.span``)."""
        with perf.span("sparse_apply"):
            return self._apply_gradients(ids, grads, lr, mask, capacity_factor)

    def _apply_gradients(self, ids, grads, lr, mask, capacity_factor) -> "HostEmbedding":
        """:meth:`apply_gradients` inside its span."""
        check_input(ids.dim() == 1 and grads.shape == (ids.shape[0], self.dim),
                    f"ids {tuple(ids.shape)} / grads {tuple(grads.shape)} mismatch")
        self.step += 1
        oob = self.n
        valid = (ids >= 0) & (ids < oob)
        if mask is not None:
            valid &= mask
        uids, ugrads = _dedup_sorted(torch.where(valid, ids, oob), grads, oob)
        if self.world > 1:
            cap = _bucket_cap(ids.shape[0], self.world, capacity_factor)
            uids, ugrads = exchange_grads_exact(uids, ugrads, plan=self.plan, mesh=self.mesh,
                                                axis=self.axis, cap=cap)
        valid = uids < oob
        slot = torch.where(valid, uids, 0)
        if self.world > 1:
            slot = self.plan.local_slot(slot)
        line = torch.where(valid, self.cache_map[torch.where(valid, slot, 0).long()], -1)
        # the valid ids are ascending, and so are their slots
        apply_rows_host(self.host_table, self.host_slots, torch.where(valid, slot, -1), ugrads,
                        self.optimizer, self.step, lr, lines=line, cache_rows=self.cache_rows)
        return self

    def make_train_step(self, loss_fn: Callable, lr: float) -> Callable:
        """``step(ids, *batch, mask=None) -> loss``: gather, mask the rows,
        take ``loss_fn(rows, *batch)`` and its gradient with respect to the
        rows, and apply it (host_embedding.py:424-433); at world W the step
        of the ranks' mean loss (:func:`~.embedding.row_train_step`)."""
        return row_train_step(self.gather, loss_fn,
                              lambda ids, g, mask: self.apply_gradients(ids, g, lr, mask=mask),
                              mesh=self.mesh)

    # -- host access (tests / checkpoint / diagnostics) -----------------------

    def _logical(self, t: torch.Tensor) -> np.ndarray:
        self._wait()
        if self.world == 1:  # numpy has no bfloat16: widened to f32, exactly, as at world W
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
        return ShardedTable(t, self.plan, "host", self.device, self.mesh, self.axis).to_array()

    def to_array(self) -> np.ndarray:
        """The logical ``[n, dim]`` table, a bfloat16 one widened to float32,
        exactly (at world W a collective: every rank gets the whole table)."""
        return self._logical(self.host_table)

    def slot_to_array(self, name: str) -> np.ndarray:
        """An optimizer slot's logical ``[n, dim]`` array (at world W a
        collective)."""
        return self._logical(self.host_slots[name])

    def _global_map(self) -> np.ndarray:
        """The cache map of every shard, ``[world * capacity]`` by physical
        row (at world W a collective)."""
        cmap = self.cache_map
        if self.world > 1:
            from ..parallel.collectives import fetch_global

            cmap = fetch_global(cmap, self.mesh, self.axis)
        return cmap.cpu().numpy()

    def cached_ids(self) -> np.ndarray:
        """The logical ids of every cached row over the ranks, sorted (at
        world W a collective)."""
        phys = np.nonzero(self._global_map() >= 0)[0]
        logical = np.full(self.plan.total_physical_rows, -1, np.int64)
        every = np.arange(self.n, dtype=np.int64)
        logical[self.plan.physical_index_np(every)] = every
        return np.sort(logical[phys])

    def cache_hit_fraction(self, ids) -> float:
        """Fraction of ``ids`` the device cache would serve; at world W every
        rank passes its own ids and gets the fraction over all the ranks'."""
        ids = (ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids))
        ids = ids.reshape(-1).astype(np.int64)
        ok = (ids >= 0) & (ids < self.n)
        phys = self.plan.physical_index_np(np.where(ok, ids, 0))
        hits = ok & (self._global_map()[phys] >= 0)
        counts = torch.tensor([float(hits.sum()), float(len(ids))], dtype=torch.float64)
        if self.world > 1:
            from ..parallel.collectives import all_reduce

            counts = all_reduce(counts.to(self.device), self.mesh, self.axis).cpu()
        return float(counts[0] / counts[1])


def bench_host_gather(n_rows: int = 4_000_000, dim: int = 256, batch: int = 1 << 19,
                      iters: int = 8, clustered: bool = False, device: DeviceLike = "cuda"):
    """Host-tier gather rate at world 1 with an empty cache
    (``host_embedding.py:566-614``, ``bench.py --metric host_gather``): the
    gather of ``batch`` ids from a zero ``[n_rows, dim]`` f32 host table,
    every row a miss, so kernel E reads each from the host. Returns
    ``(GB/s of rows delivered, seconds per gather)``, the median of three
    :func:`~..utils.perf.measure_chain` runs of ``iters`` gathers (a CUDA
    graph of them on a card).

    ``clustered=True`` draws each batch from a window of ``1.25 * batch``
    rows at a random base (the deduplicated sorted batch's regime), uniform
    ids otherwise; the ``iters + 1`` batches are drawn on the device
    beforehand, from a generator seeded 0, so each gather of the chain has
    its own."""
    from ..utils.perf import measure_chain

    dev = resolve_device(device)
    emb = HostEmbedding.create(n_rows, dim, cache_ratio=1e-9, device=dev)
    span = int(batch * 1.25)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if clustered:
        base = torch.randint(0, max(n_rows - span, 1), (iters + 1, 1), generator=gen, device=dev)
        ids = base + torch.randint(0, span, (iters + 1, batch), generator=gen, device=dev)
    else:
        ids = torch.randint(0, n_rows, (iters + 1, batch), generator=gen, device=dev)
    ids = ids.to(torch.int32)

    def step(i):
        return emb.gather(ids[i])

    dt = sorted(measure_chain(step, iters, device=dev) for _ in range(3))[1]
    return batch * dim * 4 / dt / 1e9, dt
