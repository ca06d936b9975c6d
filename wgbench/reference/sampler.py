"""Plain multi-hop uniform neighbour sampling without replacement.

For a centre ``c`` of degree ``d`` at hop ``h`` with fanout ``K``: when
``d <= K`` every position ``0..d-1`` is taken; otherwise slot ``j`` draws
``r_j = randint(seed, c, h * 2^20 + j, d - j)`` and takes the
``(r_j + 1)``-th smallest position not taken by slots ``< j``. A node's
draws depend on its id alone, so each level is a set of node ids:
``levels[0]`` the centres as given, ``levels[l + 1]`` the sorted union of
``levels[l]`` and its sampled neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from . import rng


@dataclasses.dataclass
class Hop:
    targets: torch.Tensor  # [T] node ids (levels[h])
    nbrs: torch.Tensor  # [T, K] neighbour ids, -1 where not valid
    valid: torch.Tensor  # [T, K] bool


@dataclasses.dataclass
class Sample:
    levels: List[torch.Tensor]  # levels[0] = centres; levels[l + 1] sorted, int64
    hops: List[Hop]


def sample_hop(row_ptr: torch.Tensor, col: torch.Tensor, centres: torch.Tensor, K: int,
               seed: int, hop: int) -> Hop:
    c = centres.to(torch.int64)
    start = row_ptr[c].to(torch.int64)
    deg = row_ptr[c + 1].to(torch.int64) - start
    T = c.shape[0]
    slots = torch.arange(K, dtype=torch.int64, device=c.device)
    r = rng.randint(seed, c[:, None], hop * rng.HOP_STRIDE + slots[None, :],
                    (deg[:, None] - slots[None, :]).clamp(min=1))
    chosen = torch.empty((T, K), dtype=torch.int64, device=c.device)
    for j in range(K):
        p = r[:, j].clone()
        if j:
            prev = torch.sort(chosen[:, :j], dim=1).values
            for k in range(j):  # ascending: each earlier pick at or below p moves p up one
                p += (prev[:, k] <= p).to(torch.int64)
        chosen[:, j] = p
    pos = torch.where(deg[:, None] <= K, slots[None, :], chosen)
    valid = slots[None, :] < deg.clamp(max=K)[:, None]
    nbrs = torch.where(valid, col[(start[:, None] + torch.where(valid, pos, 0))].to(torch.int64),
                       -1)
    return Hop(centres.to(torch.int64), nbrs, valid)


def multilayer_sample(row_ptr: torch.Tensor, col: torch.Tensor, centres: torch.Tensor,
                      fanouts: Sequence[int], seed: int) -> Sample:
    levels = [centres.to(torch.int64)]
    hops = []
    for h, K in enumerate(fanouts):
        hop = sample_hop(row_ptr, col, levels[h], K, seed, h)
        hops.append(hop)
        levels.append(torch.unique(torch.cat([levels[h], hop.nbrs[hop.valid]])))
    return Sample(levels, hops)


def positions(sorted_ids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Index of each of ``ids`` in the sorted ``sorted_ids`` (ids present)."""
    return torch.searchsorted(sorted_ids, ids.clamp(min=0))
