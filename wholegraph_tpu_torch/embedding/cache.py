"""Hot-row selection for the host tier's device cache, one device.

Port of the one-device part of ``wholegraph_tpu/embedding/cache.py``: the
static top-degree hot set (``hot_ids_by_degree``, ``:113-119``) and the
frequency-adaptive admission (``TouchCounter`` and its functions,
``:140-185``), the steady state the reference's LFU cache converges to
(embedding_cache_func.cu:118-210). The counts are a tensor on the
embedding's device; :func:`touch` and :func:`decay` update it in place.
The hot set feeds :meth:`HostEmbedding.rebuild_cache`.

The replicated ``HotCache`` and ``gather_with_cache`` (``:44-111``,
``:213-316``) wait for the sharded store.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def hot_ids_by_degree(row_ptr, ratio: float) -> np.ndarray:
    """The ``max(int(n * ratio), 1)`` highest-degree node ids, sorted (the
    cache_ratio analog, embedding.h cache policy). ``row_ptr`` is a numpy
    array or a tensor."""
    row_ptr = row_ptr.cpu().numpy() if isinstance(row_ptr, torch.Tensor) else np.asarray(row_ptr)
    n = len(row_ptr) - 1
    h = max(int(n * ratio), 1)
    deg = np.diff(row_ptr)
    return np.sort(np.argpartition(deg, -h)[-h:])


@dataclasses.dataclass
class TouchCounter:
    """Per-row access counts, 4 B a row: the whole-node analog of the
    reference's per-line 14-bit LFU counters, aged by :func:`decay`
    (embedding_cache.hpp:52-112)."""

    counts: torch.Tensor  # [n] int32


def make_touch_counter(n: int, device: DeviceLike = "cuda") -> TouchCounter:
    return TouchCounter(torch.zeros((n,), dtype=torch.int32, device=resolve_device(device)))


def touch(counter: TouchCounter, ids: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> TouchCounter:
    """Count one access per valid id, in place, with no host sync. Ids
    outside ``[0, n)`` and masked-out ids are not counted. Returns
    ``counter``."""
    n = counter.counts.shape[0]
    ids = ids.reshape(-1).long()
    ok = (ids >= 0) & (ids < n)
    if mask is not None:
        ok &= mask.reshape(-1)
    counter.counts.index_add_(0, torch.where(ok, ids, 0), ok.to(torch.int32))
    return counter


def decay(counter: TouchCounter, factor: int = 2) -> TouchCounter:
    """Age the counts in place (``counts //= factor``), so the hot set can
    follow a shifting distribution. Returns ``counter``."""
    counter.counts.floor_divide_(factor)
    return counter


def hot_ids_by_count(counter: TouchCounter, size: int) -> np.ndarray:
    """The ``size`` most-touched row ids, sorted (host side; for a cache
    rebuild)."""
    c = counter.counts.cpu().numpy()
    size = min(max(int(size), 1), len(c))
    return np.sort(np.argpartition(c, -size)[-size:])
