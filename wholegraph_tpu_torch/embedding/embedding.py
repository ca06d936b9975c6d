"""Trainable embedding table on one device.

Port of the single-device part of ``wholegraph_tpu/embedding/embedding.py``:
a flat ``[n, dim]`` parameter table, one f32 ``[n, dim]`` tensor per
optimizer state slot, and a global step. Unlike the JAX package's
functional ``EmbeddingState``, the object owns its tensors and
:meth:`Embedding.apply_gradients` updates them in place, so the table is
never double-buffered.

The training pattern is the JAX package's (and the reference's deferred
apply, torch/embedding.py:214-238): ``rows = emb.gather(ids)`` is a plain
tensor; the trainer takes the gradient with respect to ``rows`` and hands
it to :meth:`Embedding.apply_gradients`.

On CUDA the apply reads the touched rows of the table and of each slot with
kernel A, updates them elementwise in PyTorch, and writes them back with
kernel B. Padding ids go to the scatter as -1 and are skipped, so they never
touch row 0's table row or optimizer state (``embedding.py:611-621``); the
TPU's row-0 dump-and-fix (``:219-252``) is not needed.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..memory import PartitionPlan, ShardedTable
from ..ops.gather import local_take_sorted
from ..ops.gather_kernels import gather_rows, scatter_rows
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


class Embedding:
    """Embedding table + sparse optimizer state on one device
    (wholememory_embedding_t analog, embedding.h:74-244)."""

    def __init__(self, n: int, dim: int, optimizer: SparseOptimizer, dtype: torch.dtype,
                 device: torch.device):
        self.n, self.dim = int(n), int(dim)
        self.optimizer = optimizer
        self.dtype = dtype
        self.device = device
        self.table = torch.zeros((self.n, self.dim), dtype=dtype, device=device)
        self.slots: Dict[str, torch.Tensor] = {
            s: torch.zeros((self.n, self.dim), dtype=torch.float32, device=device)
            for s in optimizer.slot_names
        }
        self.step = 0

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(n: int, dim: int, *, optimizer: Optional[SparseOptimizer] = None,
               dtype="float32", device: DeviceLike = "cuda") -> "Embedding":
        """A zero table with zero optimizer slots on ``device``."""
        check_input(n > 0 and dim > 0, "n and dim must be positive")
        return Embedding(n, dim, optimizer or SGD(), as_torch_dtype(dtype),
                         resolve_device(device))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Embedding":
        """Scaled-normal table (std 1/sqrt(dim)) drawn from ``generator``,
        zero slots, step 0. A CPU generator gives the same table on any
        device; a CUDA one draws on the card."""
        vals = torch.randn((self.n, self.dim), generator=generator, device=generator.device)
        self.table.copy_(vals.mul_(1.0 / math.sqrt(self.dim)))
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
        A slot given as None is zeroed."""
        table = np.asarray(table)
        check_input(table.shape == (self.n, self.dim), f"table shape {table.shape} != {(self.n, self.dim)}")
        check_input(set(slots) == set(self.slots), f"slots {sorted(slots)} != {sorted(self.slots)}")
        self.table.copy_(torch.from_numpy(np.ascontiguousarray(table)))
        for name, arr in slots.items():
            if arr is None:
                self.slots[name].zero_()
            else:
                arr = np.asarray(arr, dtype=np.float32)
                check_input(arr.shape == (self.n, self.dim), f"slot {name} shape {arr.shape}")
                self.slots[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        self.step = int(step)
        return self

    # -- forward --------------------------------------------------------------

    def gather(self, ids: torch.Tensor, *, local_kernel: str = "ring") -> torch.Tensor:
        """Rows at ``ids`` (clip semantics, as the JAX package's one-device
        gather): kernel A on CUDA, or with ``local_kernel="sorted"`` kernel I
        (:func:`~wholegraph_tpu_torch.ops.local_take_sorted`, fastest for
        sorted, dense ids)."""
        check_input(local_kernel in ("ring", "sorted"), f"unknown local_kernel {local_kernel!r}")
        if local_kernel == "sorted":
            return local_take_sorted(self.table, ids)
        return gather_rows(self.table, ids)

    def as_sharded_table(self) -> ShardedTable:
        """The table as a one-shard :class:`ShardedTable` sharing its memory
        (a view for reads: a donated scatter into it writes this table)."""
        return ShardedTable(self.table, PartitionPlan.equal(self.n, 1), "device", self.device)

    # -- backward / optimizer -------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, ids: torch.Tensor, grads: torch.Tensor, lr: float, *,
                        mask: Optional[torch.Tensor] = None, assume_unique: bool = False,
                        unique_chunk: Optional[int] = None) -> "Embedding":
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
        costs one read from the device to the host."""
        check_input(ids.dim() == 1 and grads.shape == (ids.shape[0], self.dim),
                    f"ids {tuple(ids.shape)} / grads {tuple(grads.shape)} mismatch")
        if unique_chunk is not None:
            check_input(unique_chunk >= 1024 and unique_chunk % 1024 == 0,
                        "unique_chunk must be a positive multiple of 1024")
        self.step += 1
        oob = self.n
        valid = (ids >= 0) & (ids < oob)
        if mask is not None:
            valid &= mask
        ids = torch.where(valid, ids, oob)
        if assume_unique:
            uids, ugrads = ids, torch.where(valid[:, None], grads.float(), 0.0)
        else:
            uids, ugrads = _dedup_sorted(ids, grads, oob)
        R = uids.shape[0]
        if unique_chunk is None or R <= unique_chunk:
            self._step_rows(uids, ugrads, lr)
            return self
        valid_at = torch.nonzero(uids < oob)
        last = int(valid_at[-1, 0]) if valid_at.numel() else -1  # the one device-to-host read
        for c0 in range(0, last + 1, unique_chunk):
            self._step_rows(uids[c0:c0 + unique_chunk], ugrads[c0:c0 + unique_chunk], lr)
        return self

    def _step_rows(self, uids: torch.Tensor, ugrads: torch.Tensor, lr: float) -> None:
        """The optimizer on the rows of ``uids`` (unique below ``n``; ``n``
        marks padding): kernel A reads table and slots, kernel B writes them."""
        valid = uids < self.n
        take_idx = torch.where(valid, uids, 0)
        names = tuple(sorted(self.slots))
        rows = gather_rows(self.table, take_idx).float()
        srows = {s: gather_rows(self.slots[s], take_idx) for s in names}
        new_rows, new_srows = self.optimizer.update(rows, ugrads, srows, self.step, lr)
        write_idx = torch.where(valid, uids, -1)
        scatter_rows(self.table, write_idx, new_rows.to(self.dtype).contiguous())
        for s in names:
            scatter_rows(self.slots[s], write_idx, new_srows[s].contiguous())

    # -- host access (tests / checkpoint) -------------------------------------

    def to_array(self) -> np.ndarray:
        return self.table.detach().cpu().numpy()

    def slot_to_array(self, name: str) -> np.ndarray:
        return self.slots[name].detach().cpu().numpy()
