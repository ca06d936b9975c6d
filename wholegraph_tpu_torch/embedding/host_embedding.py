"""Host-memory embedding with a device cache, one device.

Port of ``wholegraph_tpu/embedding/host_embedding.py`` at world 1, the
counterpart of the reference's ``device_cached_host_embedding``
(embedding.cpp:564-767): the table and one f32 tensor per optimizer state
slot live in pinned host memory, and the card keeps a cache of hot rows.

- ``host_table`` [n, D] and ``host_slots`` [n, D] f32 are CPU tensors in
  page-locked, mapped memory (:func:`~..ops.host_kernels.pinned_empty`);
  the card reads and writes their rows over PCIe with kernels E and F.
- ``cache_map`` [n] int32 on the card maps a row to its cache line or -1;
  ``cache_rows`` [hot_cap, D] on the card holds the cached rows. The hot
  set is static between :meth:`HostEmbedding.rebuild_cache` calls
  (``hot_ids_by_degree``, or ``hot_ids_by_count`` over a ``TouchCounter``).
- Coherence invariant: for every cached row, ``cache_rows[line]`` equals
  the host row. Every update writes the host (the source of truth) and
  the cached line (``update_cache_direct``, embedding.cpp:640-650).

As the port's :class:`~.embedding.Embedding`, the object owns its tensors
and updates them in place. At world 1 a row's slot is its id
(``memory/partition.py:68-73``, ``:171-180``), so there is no partition plan.

Ordering: kernels E and F run on the current stream, so a step's E reads
see the previous step's F writes. Host code that touches the pinned
tensors (:meth:`from_array`, :meth:`init`, :meth:`to_array`,
:meth:`slot_to_array`) first waits for the card, because a kernel may still
be writing them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.gather_kernels import gather_rows, scatter_rows
from ..ops.host_kernels import host_gather_rows, host_scatter_rows, pinned_empty
from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import as_torch_dtype
from ..utils.error import check_input
from .embedding import _dedup_sorted
from .optimizers import SGD, SparseOptimizer


class HostEmbedding:
    """Embedding table and sparse optimizer state in pinned host memory,
    fronted by a cache of hot rows on the card (device_cached_host_embedding
    analog). With ``device="cpu"`` every tensor is an ordinary CPU tensor
    and the kernels' plain versions run."""

    def __init__(self, n: int, dim: int, optimizer: SparseOptimizer, dtype: torch.dtype,
                 cache_ratio: float, device: torch.device):
        self.n, self.dim = int(n), int(dim)
        self.optimizer = optimizer
        self.dtype = dtype
        self.device = device
        self.hot_cap = max(int(self.n * cache_ratio), 1)

        def host(dt):
            shape = (self.n, self.dim)
            t = pinned_empty(shape, dt) if device.type == "cuda" else torch.empty(shape, dtype=dt)
            return t.zero_()

        self.host_table = host(dtype)
        self.host_slots: Dict[str, torch.Tensor] = {s: host(torch.float32)
                                                    for s in optimizer.slot_names}
        self.cache_map = torch.full((self.n,), -1, dtype=torch.int32, device=device)
        self.cache_rows = torch.zeros((self.hot_cap, self.dim), dtype=dtype, device=device)
        self.step = 0

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(n: int, dim: int, *, optimizer: Optional[SparseOptimizer] = None,
               dtype="float32", cache_ratio: float = 0.1,
               device: DeviceLike = "cuda") -> "HostEmbedding":
        """A zero host table with zero optimizer slots and an empty cache of
        ``max(int(n * cache_ratio), 1)`` lines on ``device`` (the reference's
        cache_ratio knob, embedding_cache.hpp:27-33)."""
        check_input(n > 0 and dim > 0, "n and dim must be positive")
        return HostEmbedding(n, dim, optimizer or SGD(), as_torch_dtype(dtype), cache_ratio,
                             resolve_device(device))

    def _wait(self) -> None:
        """Wait for the card before host code touches the pinned tensors."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def from_array(self, arr, hot_ids=None) -> "HostEmbedding":
        """Table from a host ``[n, dim]`` array, zero slots, step 0, and the
        cache filled with ``hot_ids`` (e.g. :func:`~.cache.hot_ids_by_degree`;
        default: nothing cached)."""
        arr = np.asarray(arr)
        check_input(arr.shape == (self.n, self.dim), f"array shape {arr.shape} != {(self.n, self.dim)}")
        self._wait()
        self.host_table.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        return self._reset(hot_ids)

    @torch.no_grad()
    def init(self, generator: torch.Generator, hot_ids=None) -> "HostEmbedding":
        """Scaled-normal table (std 1/sqrt(dim)) drawn from ``generator``,
        the same draw as :meth:`Embedding.init`; zero slots, step 0, the
        cache filled with ``hot_ids``."""
        vals = torch.randn((self.n, self.dim), generator=generator, device=generator.device)
        self._wait()
        self.host_table.copy_(vals.mul_(1.0 / math.sqrt(self.dim)))
        del vals
        return self._reset(hot_ids)

    def _reset(self, hot_ids) -> "HostEmbedding":
        for s in self.host_slots.values():
            s.zero_()
        self.step = 0
        return self.rebuild_cache(hot_ids)

    @torch.no_grad()
    def rebuild_cache(self, hot_ids) -> "HostEmbedding":
        """Re-select the cached rows and fill them from the current host
        table (kernel E); host table, slots and step are untouched, so the
        coherence invariant holds by construction. ``hot_ids`` is a host
        array of row ids; the first ``hot_cap`` of its sorted unique ids are
        cached, and None or an empty array caches nothing."""
        self.cache_map.fill_(-1)
        self.cache_rows.zero_()
        hot = np.unique(np.asarray(hot_ids if hot_ids is not None else [], np.int64))
        if len(hot):
            check_input(hot[0] >= 0 and hot[-1] < self.n, "hot id out of range")
            ids = torch.from_numpy(hot[: self.hot_cap]).to(self.device)
            self.cache_map[ids] = torch.arange(ids.shape[0], dtype=torch.int32, device=self.device)
            self.cache_rows[: ids.shape[0]] = host_gather_rows(self.host_table, ids, _sort=False)
        return self

    # -- forward --------------------------------------------------------------

    def gather(self, ids: torch.Tensor, *, _sort: bool = True) -> torch.Tensor:
        """Rows at ``ids`` [B] on the card: hits from ``cache_rows`` (kernel
        A), misses from the host (kernel E, slot -1 for every hit, so the
        host link carries only the misses), zero rows for ids outside
        ``[0, n)`` (``_serve_cached_host``, host_embedding.py:146-160).
        ``_sort=False`` (internal) passes to :func:`host_gather_rows` for
        ids that are unique and need no sort, as the sampler's are."""
        check_input(ids.dim() == 1, f"ids must be 1-D, got {tuple(ids.shape)}")
        valid = (ids >= 0) & (ids < self.n)
        slot = torch.where(valid, ids, 0)
        line = self.cache_map[slot.long()]
        hit = valid & (line >= 0)
        hot = gather_rows(self.cache_rows, torch.where(hit, line, 0))
        cold = host_gather_rows(self.host_table, torch.where(valid & ~hit, slot, -1), _sort=_sort)
        return torch.where(hit[:, None], hot, cold)

    # -- backward / optimizer -------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, ids: torch.Tensor, grads: torch.Tensor, lr: float, *,
                        mask: Optional[torch.Tensor] = None) -> "HostEmbedding":
        """Sparse optimizer step on the host rows and their cached lines, in
        place (``_host_apply_shard`` at world 1, host_embedding.py:185-248).

        Duplicate ids are summed; masked-out ids and ids outside ``[0, n)``
        touch nothing. The touched rows and their optimizer state are read
        from the host (kernel E, once per tensor), updated on the card,
        written back to the host (kernel F, once per tensor), and the cached
        lines among them are rewritten (kernel B, -1 for the others)."""
        check_input(ids.dim() == 1 and grads.shape == (ids.shape[0], self.dim),
                    f"ids {tuple(ids.shape)} / grads {tuple(grads.shape)} mismatch")
        self.step += 1
        oob = self.n
        valid = (ids >= 0) & (ids < oob)
        if mask is not None:
            valid &= mask
        uids, ugrads = _dedup_sorted(torch.where(valid, ids, oob), grads, oob)
        valid = uids < oob
        slot = torch.where(valid, uids, -1)
        names = tuple(sorted(self.host_slots))
        # the valid slots are ascending (_dedup_sorted), so kernel E needs no sort
        rows = host_gather_rows(self.host_table, slot, _sort=False).float()
        srows = {s: host_gather_rows(self.host_slots[s], slot, _sort=False) for s in names}
        new_rows, new_srows = self.optimizer.update(rows, ugrads, srows, self.step, lr)
        new_rows = new_rows.to(self.dtype).contiguous()
        host_scatter_rows(self.host_table, slot, new_rows)
        for s in names:
            host_scatter_rows(self.host_slots[s], slot, new_srows[s].contiguous())
        line = self.cache_map[torch.where(valid, uids, 0).long()]
        scatter_rows(self.cache_rows, torch.where(valid & (line >= 0), line, -1), new_rows)
        return self

    def make_train_step(self, loss_fn: Callable, lr: float) -> Callable:
        """``step(ids, *batch, mask=None) -> loss``: gather, mask the rows,
        take ``loss_fn(rows, *batch)`` and its gradient with respect to the
        rows, and apply it (host_embedding.py:424-433)."""

        def step(ids, *batch, mask=None):
            rows = self.gather(ids)
            if mask is not None:
                rows = rows * mask[:, None]
            rows.requires_grad_()
            loss = loss_fn(rows, *batch)
            (drows,) = torch.autograd.grad(loss, rows)
            self.apply_gradients(ids, drows, lr, mask=mask)
            return loss.detach()

        return step

    # -- host access (tests / checkpoint / diagnostics) -----------------------

    def to_array(self) -> np.ndarray:
        self._wait()
        return self.host_table.numpy().copy()

    def slot_to_array(self, name: str) -> np.ndarray:
        self._wait()
        return self.host_slots[name].numpy().copy()

    def cache_hit_fraction(self, ids) -> float:
        """Fraction of ``ids`` the device cache would serve."""
        ids = torch.as_tensor(ids).reshape(-1).to(self.device).long()
        valid = (ids >= 0) & (ids < self.n)
        hit = valid & (self.cache_map[torch.where(valid, ids, 0)] >= 0)
        return float(hit.float().mean())
