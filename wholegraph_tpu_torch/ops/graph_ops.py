"""Append-unique relabelling of a sampled hop.

Port of ``wholegraph_tpu/ops/graph_ops.py:28-94`` (the reference's
graph_append_unique, graph_op.h:38-44). Sort-based, static-shaped, no host
synchronisation: the same contract as the JAX package and bit-equal to it.
"""

from __future__ import annotations

import torch

_SENTINEL = 2**31 - 1  # int32 max: masked neighbours sort last


def _segment_max(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max of int64 ``values``; empty segments hold int64 min."""
    out = torch.full((n,), torch.iinfo(torch.int64).min, dtype=torch.int64, device=values.device)
    return out.scatter_reduce_(0, seg, values, reduce="amax", include_self=True)


def append_unique(targets: torch.Tensor, neighbors: torch.Tensor, neighbor_mask: torch.Tensor):
    """Unique(targets ∪ neighbors) with the targets first.

    Args:
      targets: [T] unique target node ids.
      neighbors: [M] neighbour node ids (the flattened padded [B, K]).
      neighbor_mask: [M] validity of each neighbour slot.

    Returns:
      unique_ids: [T+M] int32; ``unique_ids[:T] == targets``, new ids follow
        in ascending order, entries past ``unique_count`` are -1.
      unique_count: 0-dim int32 tensor, the number of valid unique ids.
      neighbor_map: [M] int32 index of each neighbour in ``unique_ids``,
        -1 where masked.
    """
    T, M = targets.shape[0], neighbors.shape[0]
    bound = T + M
    dev = targets.device

    tgt = targets.to(torch.int64)
    nbr = torch.where(neighbor_mask, neighbors.to(torch.int64), _SENTINEL)
    arr = torch.cat([tgt, nbr])
    is_tgt = torch.cat([torch.ones(T, dtype=torch.int64, device=dev),
                        torch.zeros(M, dtype=torch.int64, device=dev)])

    # sort by (id, target first); ids are non-negative int32, so the int64
    # key id * 2 + bit cannot overflow
    order = torch.argsort(arr * 2 + (1 - is_tgt), stable=True)
    sid = arr[order]
    stgt = is_tgt[order]

    leader = torch.ones(bound, dtype=torch.bool, device=dev)
    leader[1:] = sid[1:] != sid[:-1]
    leader &= sid < _SENTINEL
    seg = (torch.cumsum(leader, 0) - 1).clamp(min=0)

    grp_has_tgt = _segment_max(stgt, seg, bound)
    grp_tpos = _segment_max(torch.where(stgt == 1, order, -1), seg, bound)
    has_tgt_elem = grp_has_tgt[seg] > 0

    # rank the new (non-target) groups in ascending id order after the targets
    leader_nt = leader & ~has_tgt_elem
    nt_rank_elem = torch.cumsum(leader_nt, 0) - 1
    grp_nt_rank = _segment_max(torch.where(leader_nt, nt_rank_elem, -1), seg, bound)

    grp_out_pos = torch.where(grp_has_tgt > 0, grp_tpos, T + grp_nt_rank)
    out_pos_elem = grp_out_pos[seg]

    unique_ids = torch.full((bound + 1,), -1, dtype=torch.int32, device=dev)
    unique_ids.scatter_(0, torch.where(leader, out_pos_elem, bound), sid.to(torch.int32))
    unique_ids = unique_ids[:bound]
    unique_count = (T + leader_nt.sum()).to(torch.int32)

    # raw → unique map back in input order
    pos_concat = torch.empty(bound, dtype=torch.int64, device=dev)
    pos_concat[order] = out_pos_elem
    neighbor_map = torch.where(neighbor_mask, pos_concat[T:], -1).to(torch.int32)
    return unique_ids, unique_count, neighbor_map
