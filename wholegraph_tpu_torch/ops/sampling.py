"""CSR neighbour sampling, uniform without replacement.

Port of the unweighted half of ``wholegraph_tpu/ops/sampling.py``:
:class:`SampleResult`, the selection-sampling fixpoint
``_sample_positions_uniform`` (``sampling.py:141-174``) and
``csr_sample_neighbors`` without weights (``:696-763``). Bit-equal to the
JAX package and to ``wholegraph_tpu.testing.host_sample_uniform``.

For slot j the sampler draws ``r_j ~ U[0, deg - j)`` from the counter RNG
(keyed by seed, centre id and ``hop * 2^20 + j``) and maps it to the
(r_j+1)-th smallest position not taken by slots < j through the monotone
fixpoint ``p <- r_j + #{chosen <= p}``. The fixpoint runs here in PyTorch;
the column fetch that follows is kernel C on CUDA
(:func:`~wholegraph_tpu_torch.ops.gather_kernels.sample_cols`), which, unlike
the TPU's lane select, takes any fanout K.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.error import check_input
from . import rng
from .gather_kernels import sample_cols

HOP_STRIDE = 1 << 20  # rng key stride between hops (slot fits below)


@dataclasses.dataclass
class SampleResult:
    """Padded sampling output.

    neighbors: [B, K] sampled neighbour ids, -1 where ~mask
    mask:      [B, K] slot validity
    positions: [B, K] sampled offsets within each centre's adjacency list
    edge_ids:  [B, K] global edge indices (row_ptr[c] + position)
    degree:    [B]    centre out-degrees
    """

    neighbors: torch.Tensor
    mask: torch.Tensor
    positions: torch.Tensor
    edge_ids: torch.Tensor
    degree: torch.Tensor


def _sample_positions_uniform(deg: torch.Tensor, K: int, seed: int,
                              centers: torch.Tensor, hop: int):
    """K distinct uniform positions in [0, deg) per centre, padded and
    masked: returns (pos [B, K] int32, mask [B, K] bool)."""
    B = deg.shape[0]
    dev = deg.device
    slots = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    # every slot's draw at once: r[:, j] = randint(seed, c, hop*S + j, max(deg - j, 1))
    r = rng.randint(seed, centers[:, None], hop * HOP_STRIDE + slots,
                    (deg[:, None] - slots).clamp(min=1))
    sel = torch.full((B, K), 1 << 30, dtype=torch.int32, device=dev)
    for j in range(K):
        rj = r[:, j]
        p = rj
        # the rank-adjust converges in <= j+1 applications (the JAX
        # package's loop bound, so the result is the same bit for bit)
        for _ in range(j + 1):
            p = rj + (sel <= p[:, None]).sum(dim=1, dtype=torch.int32)
        sel[:, j] = p
    take_all = deg[:, None] <= K
    pos = torch.where(take_all, slots, sel)
    mask = slots < deg.clamp(max=K)[:, None]
    return torch.where(mask, pos, 0).to(torch.int32), mask


def csr_sample_neighbors(row_ptr: torch.Tensor, col: torch.Tensor, centers: torch.Tensor,
                         max_sample: int, *, seed: int = 0, hop: int = 0) -> SampleResult:
    """Sample up to ``max_sample`` neighbours per centre, uniformly without
    replacement (wholegraph_csr_unweighted_sample_without_replacement
    analog). ``row_ptr`` [N+1] and ``col`` [E] are int32 tensors on the
    centres' device; centre ids are clipped into the graph as the JAX
    package's fetch does."""
    K = int(max_sample)
    check_input(K >= 0, "max_sample must be >= 0")
    check_input(col.shape[0] < 2**31, "edge offsets are int32: the graph must have < 2^31 edges")
    centers = centers.to(torch.int32)
    last = row_ptr.shape[0] - 1
    lo = row_ptr[centers.long().clamp(0, last)]
    hi = row_ptr[(centers.long() + 1).clamp(0, last)]
    start = lo.to(torch.int32)
    deg = (hi - lo).to(torch.int32)
    pos, mask = _sample_positions_uniform(deg, K, seed, centers, hop)
    edge_ids = start[:, None] + pos
    nbrs = sample_cols(col, start, pos, mask)
    return SampleResult(nbrs, mask, pos, edge_ids, deg)
