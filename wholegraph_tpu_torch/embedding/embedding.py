"""Trainable embedding table, on one card or sharded over ranks.

Port of ``wholegraph_tpu/embedding/embedding.py``: a parameter table, one
f32 tensor per optimizer state slot, and a global step. At world 1 the
table is a flat ``[n, dim]`` tensor; at world W (``mesh=``) each rank holds
its shard ``[plan.capacity, dim]`` of the table and of every slot, placed by
the :class:`~wholegraph_tpu_torch.memory.PartitionPlan`. Unlike the JAX
package's functional ``EmbeddingState``, the object owns its tensors and
:meth:`Embedding.apply_gradients` updates them in place, so the table is
never double-buffered.

The training pattern is the JAX package's (and the reference's deferred
apply, torch/embedding.py:214-238): ``rows = emb.gather(ids)`` is a plain
tensor; the trainer takes the gradient with respect to ``rows`` and hands
it to :meth:`Embedding.apply_gradients`.

On CUDA the apply is kernel L (:func:`~wholegraph_tpu_torch.ops.optim_kernels.
apply_rows`): one launch reads each touched row of the table and of each
slot, updates it and writes it back, for every optimizer of the registry
(an optimizer from elsewhere runs kernel A, its ``update`` and kernel B).
Padding slots are skipped, so they never touch row 0's table row or
optimizer state (``embedding.py:611-621``); the TPU's row-0 dump-and-fix
(``:219-252``) is not needed.

At world W the gather is the store's exchange (:func:`ops.gather.gather`)
and the apply follows the reference's flow (embedding.cpp:146-300;
``embedding.py:270-443``): each rank dedups its (id, gradient) pairs, the
exact multi-round bucket exchange (:func:`exchange_grads_exact`) brings
every pair to its owner, which merges the rounds into a pending
accumulator of JAX's worst case, ``min(world * B, capacity)`` rows, and
steps each touched row once with its summed gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..memory import PartitionPlan, ShardedTable
from ..memory.sharded_table import default_plan, local_rows
from ..ops.gather import (_bucket_cap, _round_up, gather as _store_gather, local_take_sorted,
                          remaining, send_round)
from ..ops.gather_kernels import gather_rows
from ..ops.optim_kernels import apply_rows
from ..parallel.mesh import Mesh
from ..utils import perf
from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import as_torch_dtype
from ..utils.error import check_input
from .optimizers import SGD, SparseOptimizer


def _dedup_sorted(ids: torch.Tensor, grads: torch.Tensor, oob: int):
    """Sort (ids, grads) by id and sum the gradients of duplicates. Returns
    (unique_ids [R] padded with ``oob``, summed_grads [R, D] f32 padded with
    zero rows) — dedup_indice_and_gradients analog (embedding.cpp:261-269)."""
    R = ids.shape[0]
    sids, order = torch.sort(ids, stable=True)
    valid = sids < oob
    sgrads = torch.where(valid[:, None], grads[order].float(), 0.0)
    leader = torch.ones(R, dtype=torch.bool, device=ids.device)
    leader[1:] = sids[1:] != sids[:-1]
    leader &= valid
    seg = (torch.cumsum(leader, 0) - 1).clamp(min=0)
    seg_grads = torch.zeros_like(sgrads).index_add_(0, seg, sgrads)
    uids = torch.full((R,), oob, dtype=ids.dtype, device=ids.device)
    uids.scatter_reduce_(0, seg, sids, reduce="amin", include_self=True)
    return uids, seg_grads


def exchange_grads_exact(uids_l: torch.Tensor, ugrads_l: torch.Tensor, *, plan: PartitionPlan,
                         mesh: Mesh, axis, cap: int):
    """The exact multi-round exchange of this rank's deduplicated (id,
    gradient) pairs to their owners (``embedding.py:342-395``). Each round
    sends at most ``cap`` pairs to an owner; the owner merges every round
    into a pending accumulator (sort and segment sum) of ``P = min(world *
    B, capacity)`` rows, JAX's worst case: an owner never receives more
    distinct ids than it owns rows, and the pairs arrive deduplicated.
    Returns ``(pend_ids [P], pend_grads [P, D] f32)``: this rank's touched
    ids ascending, padding ``>= n``. Every rank of the axis calls it."""
    world, oob, B = plan.world, plan.n, uids_l.shape[0]
    valid = uids_l < oob
    owner0 = torch.where(valid, plan.owner(torch.where(valid, uids_l, 0)), world)
    P = min(world * B, _round_up(plan.capacity, 8))
    pend_ids = torch.full((P,), oob, dtype=uids_l.dtype, device=uids_l.device)
    pend_grads = ugrads_l.new_zeros((P, ugrads_l.shape[1]), dtype=torch.float32)
    ugrads_l = ugrads_l.float().contiguous()
    delivered = torch.cat([~valid, valid.new_ones(1)])  # padding needs no delivery
    while True:
        recv_ids, recv_grads, _ = send_round(uids_l, owner0, delivered, ugrads_l, world=world,
                                             mesh=mesh, axis=axis, cap=cap, oob=oob)
        m_ids, m_grads = _dedup_sorted(torch.cat([pend_ids, recv_ids]),
                                       torch.cat([pend_grads, recv_grads]), oob)
        pend_ids, pend_grads = m_ids[:P], m_grads[:P]  # the valid ids are a prefix
        if remaining(delivered, mesh, axis) == 0:
            return pend_ids, pend_grads


def row_train_step(gather: Callable, loss_fn: Callable, apply: Callable,
                   mesh: Optional[Mesh] = None) -> Callable:
    """``step(ids, *batch, mask=None) -> loss``: ``rows = gather(ids)`` times
    ``mask``, ``loss_fn(rows, *batch)`` and its gradient with respect to the
    rows, then ``apply(ids, grads, mask)`` (the embeddings'
    ``make_train_step``). With a ``mesh`` of W ranks the step is that of
    the ranks' mean loss: each rank's row gradients are divided by W and the
    loss returned is the mean over the ranks (JAX's loss over the global
    batch, when ``loss_fn`` is a mean and the ranks' batches are equal)."""
    world = 1 if mesh is None else mesh.size

    def step(ids, *batch, mask=None):
        rows = gather(ids)
        if mask is not None:
            rows = rows * mask[:, None]
        rows.requires_grad_()
        loss = loss_fn(rows, *batch)
        (drows,) = torch.autograd.grad(loss, rows)
        if world == 1:
            apply(ids, drows, mask)
            return loss.detach()
        from ..parallel.collectives import all_reduce

        apply(ids, drows / world, mask)
        return all_reduce(loss.detach().float().reshape(1), mesh)[0] / world

    return step


class Embedding:
    """Embedding table + sparse optimizer state on one device, or this
    rank's shard of them (wholememory_embedding_t analog, embedding.h:74-244).

    At world 1 ``table`` and each slot are ``[n, dim]``; with a ``mesh`` of
    W ranks along ``axis`` they are this rank's shard ``[plan.capacity,
    dim]`` of ``plan`` (equal over the axis by default)."""

    def __init__(self, n: int, dim: int, optimizer: SparseOptimizer, dtype: torch.dtype,
                 device: torch.device, table: Optional[torch.Tensor] = None,
                 slots: Optional[Mapping[str, torch.Tensor]] = None, *,
                 plan: Optional[PartitionPlan] = None, mesh: Optional[Mesh] = None,
                 axis="data"):
        self.n, self.dim = int(n), int(dim)
        self.plan = default_plan(plan, self.n, mesh, axis)
        self.mesh = mesh if self.plan.world > 1 else None
        self.axis = axis
        if self.plan.world == 1:
            self.plan = PartitionPlan.equal(self.n, 1)  # every world-1 plan places row i at i
        rows = self.n if self.plan.world == 1 else self.plan.capacity
        self.optimizer = optimizer
        self.dtype = dtype
        self.device = device
        self.table = (torch.zeros((rows, self.dim), dtype=dtype, device=device)
                      if table is None else table)
        check_input(tuple(self.table.shape) == (rows, self.dim),
                    f"table {tuple(self.table.shape)} != {(rows, self.dim)}")
        slots = slots or {}
        self.slots: Dict[str, torch.Tensor] = {
            s: slots[s] if s in slots
            else torch.zeros((rows, self.dim), dtype=torch.float32, device=device)
            for s in optimizer.slot_names
        }
        self.step = 0

    @property
    def world(self) -> int:
        return self.plan.world

    def _local(self, logical: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a logical ``[n, dim]`` tensor (the tensor
        itself at world 1)."""
        if self.world == 1:
            return logical
        return local_rows(self.plan, self.mesh.axis_index(self.axis), logical)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(n: int, dim: int, *, optimizer: Optional[SparseOptimizer] = None,
               dtype="float32", device: DeviceLike = "cuda", mesh: Optional[Mesh] = None,
               axis="data", plan: Optional[PartitionPlan] = None) -> "Embedding":
        """A zero table with zero optimizer slots on ``device``; with a
        ``mesh`` of W ranks, this rank's shard of it."""
        check_input(n > 0 and dim > 0, "n and dim must be positive")
        return Embedding(n, dim, optimizer or SGD(), as_torch_dtype(dtype),
                         resolve_device(device), plan=plan, mesh=mesh, axis=axis)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Embedding":
        """Scaled-normal table (std 1/sqrt(dim)) drawn from ``generator``,
        zero slots, step 0. A CPU generator gives the same table on any
        device; a CUDA one draws on the card. At world W every rank draws
        the whole logical table from the same stream and keeps its rows, so
        the table is the world-1 table from the same generator."""
        vals = torch.randn((self.n, self.dim), generator=generator, device=generator.device)
        self.table.copy_(self._local(vals.mul_(1.0 / math.sqrt(self.dim))))
        for s in self.slots.values():
            s.zero_()
        self.step = 0
        return self

    def from_array(self, arr) -> "Embedding":
        """Table from a host ``[n, dim]`` array; zero slots, step 0."""
        return self.state_from_numpy(arr, {s: None for s in self.slots}, 0)

    @torch.no_grad()
    def state_from_numpy(self, table, slots: Mapping[str, Optional[np.ndarray]],
                         step: int) -> "Embedding":
        """Load table, optimizer slots and step from host arrays, e.g. the
        JAX package's ``to_array`` / ``slot_to_array`` and ``int(state.step)``.
        A slot given as None is zeroed. The arrays are logical ``[n, dim]``;
        at world W each rank keeps its rows."""
        table = np.asarray(table)
        check_input(table.shape == (self.n, self.dim), f"table shape {table.shape} != {(self.n, self.dim)}")
        check_input(set(slots) == set(self.slots), f"slots {sorted(slots)} != {sorted(self.slots)}")
        self.table.copy_(self._local(torch.from_numpy(np.ascontiguousarray(table))))
        for name, arr in slots.items():
            if arr is None:
                self.slots[name].zero_()
            else:
                arr = np.asarray(arr, dtype=np.float32)
                check_input(arr.shape == (self.n, self.dim), f"slot {name} shape {arr.shape}")
                self.slots[name].copy_(self._local(torch.from_numpy(np.ascontiguousarray(arr))))
        self.step = int(step)
        return self

    @staticmethod
    def from_filelist(filelist, dim: int, *, optimizer: Optional[SparseOptimizer] = None,
                      dtype="float32", expected_rows: Optional[int] = None,
                      direct: Optional[bool] = None, device: DeviceLike = "cuda",
                      round_robin_size: int = 0, mesh: Optional[Mesh] = None,
                      axis="data") -> "Embedding":
        """An embedding whose table is read from a binary file list (rows
        of ``dim`` values of ``dtype``, numbered in file order), zero slots,
        step 0 (``embedding.py:562-590``; create_embedding_from_filelist,
        torch/embedding.py:462). The rows go through
        :func:`~wholegraph_tpu_torch.io.load_filelist` onto the card, with
        O_DIRECT when ``direct`` is True, or None and ``WGTPU_DIRECT_IO=1``. With
        a ``mesh`` of W ranks each rank reads only its shard's rows, placed
        by the equal plan or, with ``round_robin_size``, by blocks of that
        many rows dealt round-robin (the reference's round-robin files,
        file_io.cpp:102); at world 1 every row lies at its own id whatever
        the value."""
        from ..io.file_io import load_filelist

        table = load_filelist(filelist, dim, dtype, expected_rows=expected_rows, direct=direct,
                              round_robin_size=round_robin_size, device=device, mesh=mesh,
                              axis=axis)
        data = table.data[:table.n] if table.plan.world == 1 else table.data
        return Embedding(table.n, dim, optimizer or SGD(), table.dtype, table.device, table=data,
                         plan=table.plan, mesh=mesh, axis=axis)

    # -- forward --------------------------------------------------------------

    def gather(self, ids: torch.Tensor, *, local_kernel: str = "ring", **kw) -> torch.Tensor:
        """Rows at ``ids``. At world 1 with clip semantics, as the JAX
        package's one-device gather: kernel A on CUDA, or with
        ``local_kernel="sorted"`` kernel I
        (:func:`~wholegraph_tpu_torch.ops.local_take_sorted`, fastest for
        sorted, dense ids); the exchange's keywords change nothing. At world
        W the store's exchange (:func:`ops.gather.gather`, keywords
        ``method``, ``capacity_factor``, ``dedup``): every rank passes its
        ids, and ids outside ``[0, n)`` give zero rows."""
        check_input(local_kernel in ("ring", "sorted"), f"unknown local_kernel {local_kernel!r}")
        check_input(set(kw) <= {"method", "capacity_factor", "dedup"},
                    f"unknown gather keywords {sorted(kw)}")
        if self.world > 1:
            return _store_gather(self.table, ids, plan=self.plan, mesh=self.mesh, axis=self.axis,
                                 local_kernel=local_kernel, **kw)
        if local_kernel == "sorted":
            return local_take_sorted(self.table, ids)
        return gather_rows(self.table, ids)

    def as_sharded_table(self) -> ShardedTable:
        """The table as a :class:`ShardedTable` sharing its memory (a view
        for reads: a donated scatter into it writes this table)."""
        return ShardedTable(self.table, self.plan, "device", self.device, self.mesh, self.axis)

    # -- backward / optimizer -------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, ids: torch.Tensor, grads: torch.Tensor, lr: float, *,
                        mask: Optional[torch.Tensor] = None, assume_unique: bool = False,
                        unique_chunk: Optional[int] = None,
                        capacity_factor: float = 2.0,
                        corrections: Optional[torch.Tensor] = None) -> "Embedding":
        """Sparse optimizer step from (ids, row gradients), in place
        (wholememory_embedding_gather_gradient_apply analog).

        Duplicate ids are summed unless ``assume_unique=True`` (the caller
        warrants that the masked ids are unique, as ``append_unique``'s
        output is). ``mask`` marks valid slots: masked-out and out-of-range
        ids touch neither the table nor any optimizer slot.

        ``unique_chunk`` (a positive multiple of 1024, ``embedding.py:
        106-135``): the deduplicated ids go through the optimizer in chunks
        of that many, stopping after the last chunk that holds a valid id, so
        the cost follows the rows really touched, not the buffer (a
        sampler's valid ids come first). Exact for any layout of the ids,
        valid ids after padding included: the table and slots come out
        bit-equal to the call without it. Finding the last valid position
        costs one read from the device to the host.

        At world W every rank passes its own (ids, grads), the same count on
        every rank: duplicates within and across ranks are summed, by
        :func:`exchange_grads_exact` (``capacity_factor`` the bucket
        headroom), and each owner steps its touched rows once.

        ``corrections``: this step's row of ``optimizer.step_table`` on the
        card, for a step that a CUDA graph replays
        (:func:`~wholegraph_tpu_torch.train.train_epoch`): the update reads
        its step-dependent scalars there, and :attr:`step` is left for the
        caller to advance. ``unique_chunk`` is refused with it: finding the
        last valid id reads the device on the host.

        Its span is ``sparse_apply`` (``utils.perf.span``)."""
        with perf.span("sparse_apply"):
            return self._apply_gradients(ids, grads, lr, mask, assume_unique, unique_chunk,
                                         capacity_factor, corrections)

    def _apply_gradients(self, ids, grads, lr, mask, assume_unique, unique_chunk,
                         capacity_factor, corrections) -> "Embedding":
        """:meth:`apply_gradients` inside its span."""
        check_input(ids.dim() == 1 and grads.shape == (ids.shape[0], self.dim),
                    f"ids {tuple(ids.shape)} / grads {tuple(grads.shape)} mismatch")
        if unique_chunk is not None:
            check_input(unique_chunk >= 1024 and unique_chunk % 1024 == 0,
                        "unique_chunk must be a positive multiple of 1024")
            check_input(corrections is None,
                        "unique_chunk reads the device on the host, which a replayed step "
                        "cannot: ROADMAP Queue 4 item 15")
        if corrections is None:
            self.step += 1
        step = self.step if corrections is None else corrections
        oob = self.n
        valid = (ids >= 0) & (ids < oob)
        if mask is not None:
            valid &= mask
        ids = torch.where(valid, ids, oob)
        if assume_unique:  # the apply skips the slots at ``oob``: their gradients are not read
            uids, ugrads = ids, grads
        else:
            uids, ugrads = _dedup_sorted(ids, grads, oob)
        if self.world > 1:
            cap = _bucket_cap(ids.shape[0], self.world, capacity_factor)
            uids, ugrads = exchange_grads_exact(uids, ugrads, plan=self.plan, mesh=self.mesh,
                                                axis=self.axis, cap=cap)
        R = uids.shape[0]
        if unique_chunk is None or R <= unique_chunk:
            self._step_rows(uids, ugrads, lr, step)
            return self
        valid_at = torch.nonzero(uids < oob)
        last = int(valid_at[-1, 0]) if valid_at.numel() else -1  # the one device-to-host read
        for c0 in range(0, last + 1, unique_chunk):
            self._step_rows(uids[c0:c0 + unique_chunk], ugrads[c0:c0 + unique_chunk], lr, step)
        return self

    def _step_rows(self, uids: torch.Tensor, ugrads: torch.Tensor, lr: float,
                   step: Union[int, torch.Tensor]) -> None:
        """The optimizer on the rows of ``uids`` (unique below ``n``, owned
        by this rank; ``n`` marks padding) with their gradients ``ugrads``
        (f32 or the table's type) at ``step`` (the global step, or its row of
        the optimizer's ``step_table``): :func:`~wholegraph_tpu_torch.ops.
        optim_kernels.apply_rows`, kernel L on the card."""
        if self.world > 1:
            valid = uids < self.n
            uids = torch.where(valid, self.plan.local_slot(torch.where(valid, uids, 0)), -1)
        apply_rows(self.table, self.slots, uids, ugrads, self.optimizer, step, lr)

    def make_train_step(self, loss_fn: Callable, lr: float, *, gather_kwargs=None,
                        apply_kwargs=None) -> Callable:
        """``step(ids, *batch, mask=None) -> loss``, the reference's
        training pattern (EmbeddingLookupFn forward and deferred sparse
        apply, torch/embedding.py:214-238; ``embedding.py:665-692``):
        gather the rows at ``ids``, multiply them by ``mask``, take
        ``loss_fn(rows, *batch)`` and its gradient with respect to the
        rows, and apply it with ``mask=``, so padding slots touch nothing.
        ``gather_kwargs`` go to :meth:`gather`, ``apply_kwargs`` to
        :meth:`apply_gradients` (e.g. ``assume_unique=True`` for a
        sampler's unique ids). At world W each rank steps its own ids and
        batch, and the step is that of the ranks' mean loss
        (:func:`row_train_step`)."""
        gkw, akw = gather_kwargs or {}, apply_kwargs or {}
        return row_train_step(lambda ids: self.gather(ids, **gkw), loss_fn,
                              lambda ids, g, mask: self.apply_gradients(ids, g, lr, mask=mask,
                                                                        **akw),
                              mesh=self.mesh)

    # -- host access (tests / checkpoint) -------------------------------------

    def _logical(self, t: torch.Tensor) -> np.ndarray:
        if self.world == 1:  # numpy has no bfloat16: widened to f32, exactly, as at world W
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return ShardedTable(t, self.plan, "device", self.device, self.mesh, self.axis).to_array()

    def to_array(self) -> np.ndarray:
        """The logical ``[n, dim]`` table on the host, a bfloat16 one widened
        to float32, exactly (at world W a collective)."""
        return self._logical(self.table)

    def slot_to_array(self, name: str) -> np.ndarray:
        """An optimizer slot's logical ``[n, dim]`` array (at world W a collective)."""
        return self._logical(self.slots[name])
