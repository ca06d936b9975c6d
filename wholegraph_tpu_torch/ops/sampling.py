"""CSR neighbour sampling, uniform without replacement.

Port of the unweighted half of ``wholegraph_tpu/ops/sampling.py``:
:class:`SampleResult`, the selection-sampling fixpoint
``_sample_positions_uniform`` (``sampling.py:141-174``) and
``csr_sample_neighbors`` without weights (``:696-763``). Bit-equal to the
JAX package and to ``wholegraph_tpu.testing.host_sample_uniform``.

For slot j the sampler draws ``r_j ~ U[0, deg - j)`` from the counter RNG
(keyed by seed, centre id and ``hop * 2^20 + j``) and maps it to the
(r_j+1)-th smallest position not taken by slots < j through the monotone
fixpoint ``p <- r_j + #{chosen <= p}``. On CUDA a whole hop -- degrees,
draws, fixpoint, mask, edge ids and the column fetch -- is one launch of
kernel C (:func:`sample_hop_uniform`, ``csrc/sample_cols.cu``), for any
fanout K. On the CPU the same function runs as PyTorch ops
(:func:`csr_sample_neighbors_plain`: the draw and fixpoint here, then
:func:`~wholegraph_tpu_torch.ops.gather_kernels.sample_cols_plain`); that
is the kernel's plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import kernels
from ..utils.error import check_input
from . import rng
from .gather_kernels import on_cuda, sample_cols_plain

HOP_STRIDE = 1 << 20  # rng key stride between hops (slot fits below)

_P, _L, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32

SAMPLE_HOP = kernels.Kernel(
    "sample_hop_uniform", "sample_cols.cu", "wg_sample_hop_uniform",
    [_P, _L, _P, _L, _P, _L, _L, _U32, _U32, _P, _P, _P, _P, _P, _P],
    # _gather_slab_kernel and _select_lanes_kernel, with the draw that feeds them
    replaces="wholegraph_tpu/ops/gather_pallas.py:346,445",
)


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


def _centre_rows(row_ptr: torch.Tensor, centers: torch.Tensor):
    """(start, degree) of each centre, int32, its id clamped into the graph
    as the JAX package's fetch does."""
    last = row_ptr.shape[0] - 1
    lo = row_ptr[centers.long().clamp(0, last)]
    hi = row_ptr[(centers.long() + 1).clamp(0, last)]
    return lo.to(torch.int32), (hi - lo).to(torch.int32)


def csr_sample_neighbors_plain(row_ptr: torch.Tensor, col: torch.Tensor, centers: torch.Tensor,
                               K: int, seed: int = 0, hop: int = 0) -> SampleResult:
    """Kernel C's plain version, on any device: the draw and the rank
    fixpoint as PyTorch ops, then the plain column fetch."""
    centers = centers.to(torch.int32)
    start, deg = _centre_rows(row_ptr, centers)
    pos, mask = _sample_positions_uniform(deg, K, seed, centers, hop)
    if col.shape[0] == 0 or pos.numel() == 0:
        nbrs = torch.full(pos.shape, -1, dtype=torch.int32, device=pos.device)
    else:
        nbrs = sample_cols_plain(col, start, pos, mask)
    return SampleResult(nbrs, mask, pos, start[:, None] + pos, deg)


def sample_hop_uniform(row_ptr: torch.Tensor, col: torch.Tensor, centers: torch.Tensor,
                       K: int, seed: int, hop: int) -> SampleResult:
    """One hop of the uniform sampler on CUDA tensors: kernel C, one launch
    that writes all five fields of :class:`SampleResult`. ``row_ptr`` [N+1],
    ``col`` [E] and ``centers`` [B] are int32 on one card."""
    check_input(on_cuda(row_ptr, col, centers), "sample_hop_uniform takes CUDA tensors")
    check_input(all(t.dim() == 1 and t.dtype == torch.int32 for t in (row_ptr, col, centers))
                and row_ptr.shape[0] >= 1, "row_ptr [N+1], col [E] and centers [B] must be int32")
    check_input(0 <= K < 2**31 and col.shape[0] < 2**31, "K and E must be below 2^31")
    B = centers.shape[0]
    dev = centers.device
    outs = (torch.empty((B, K), dtype=torch.int32, device=dev),
            torch.empty((B, K), dtype=torch.bool, device=dev),
            torch.empty((B, K), dtype=torch.int32, device=dev),
            torch.empty((B, K), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))
    if B == 0:
        return SampleResult(*outs)
    row_ptr, col, centers = (t.contiguous() for t in (row_ptr, col, centers))
    SAMPLE_HOP(row_ptr.data_ptr(), row_ptr.shape[0] - 1, col.data_ptr(), col.shape[0],
               centers.data_ptr(), B, K, int(seed) & 0xFFFFFFFF,
               (int(hop) * HOP_STRIDE) & 0xFFFFFFFF, *(t.data_ptr() for t in outs),
               kernels.cuda_stream(dev))
    return SampleResult(*outs)


def csr_sample_neighbors(row_ptr: torch.Tensor, col: torch.Tensor, centers: torch.Tensor,
                         max_sample: int, *, seed: int = 0, hop: int = 0) -> SampleResult:
    """Sample up to ``max_sample`` neighbours per centre, uniformly without
    replacement (wholegraph_csr_unweighted_sample_without_replacement
    analog). ``row_ptr`` [N+1] (int32, or int64 with offsets below 2^31)
    and ``col`` [E] (int32) are on the centres' device; centre ids are
    clipped into the graph as the JAX package's fetch does. On CUDA one
    launch of kernel C; on the CPU its plain version."""
    K = int(max_sample)
    check_input(K >= 0, "max_sample must be >= 0")
    check_input(col.shape[0] < 2**31, "edge offsets are int32: the graph must have < 2^31 edges")
    check_input(row_ptr.dim() == 1 and row_ptr.shape[0] >= 1, "row_ptr must be [N+1]")
    if row_ptr.dtype == torch.int64:  # its offsets are int32 on either device
        check_input(int(row_ptr[-1]) < 2**31, "row_ptr's offsets must be below 2^31")
    if not on_cuda(row_ptr, col, centers):
        return csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)
    return sample_hop_uniform(row_ptr.to(torch.int32), col, centers.to(torch.int32), K, seed,
                              hop)
