"""CSR neighbour sampling without replacement, uniform and weighted.

Port of ``wholegraph_tpu/ops/sampling.py``: :class:`SampleResult`, the
uniform selection-sampling fixpoint ``_sample_positions_uniform``
(``sampling.py:141-174``), the weighted A-Res draw
``_sample_positions_weighted`` (``:186-700``), ``interleave_col_weights``
(``:355-381``) and ``csr_sample_neighbors`` (``:696-763``). Bit-equal to the
JAX package and to ``wholegraph_tpu.testing.host_sample_uniform``; the
weighted half is equal under the rule of :func:`weighted_near_ties`.

Uniform: for slot j the sampler draws ``r_j ~ U[0, deg - j)`` from the
counter RNG (keyed by seed, centre id and ``hop * 2^20 + j``) and maps it to
the (r_j+1)-th smallest position not taken by slots < j through the
monotone fixpoint ``p <- r_j + #{chosen <= p}``. On CUDA a whole hop --
degrees, draws, fixpoint, mask, edge ids and the column fetch -- is one
launch of kernel C (:func:`sample_hop_uniform`, ``csrc/sample_cols.cu``),
for any fanout K. On the CPU the same function runs as PyTorch ops
(:func:`csr_sample_neighbors_plain`: the draw and fixpoint here, then
:func:`~wholegraph_tpu_torch.ops.gather_kernels.sample_cols_plain`); that
is the kernel's plain version.

Weighted (A-Res, reference weighted_sample_without_replacement_func.cuh:
45-61): edge o of a centre gets the key ``log(max(u_o, 1e-20)) / w_o`` where
``w_o > 0``, else ``-inf``, with ``u_o = rand_uniform(seed, centre, hop *
2^20 + o)``; the centre keeps its first ``min(deg, K)`` edges by key
descending, then position ascending, and a slot whose key is ``-inf`` is
masked (position 0, neighbour -1). On CUDA a hop is one launch of kernel K
(:func:`sample_hop_weighted`, ``csrc/sample_weighted.cu``), reading the
``[E, 2]`` pair table of :func:`interleave_col_weights` or ``col`` and the
weights apart; on the CPU :func:`csr_sample_neighbors_weighted_plain` is its
plain version. JAX's degree ladder, 128-lane blocks and ``chunk=512`` are
TPU mechanics and stay behind: the plain version's cost follows the batch's
real degrees, and K's follows each centre's.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Optional, Tuple

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
SAMPLE_HOP_WEIGHTED = kernels.Kernel(
    "sample_hop_weighted", "sample_weighted.cu", "wg_sample_hop_weighted",
    [_P, _L, _P, _P, _P, _L, _P, _L, _L, _U32, _U32, _P, _P, _P, _P, _P, _P],
    # on the weighted path: _gather_kernel (weight blocks), _gather_slab_kernel
    # (pair and col slabs) and _select_lanes_kernel, with the A-Res draw
    replaces="wholegraph_tpu/ops/gather_pallas.py:35,346,445",
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


# ---------------------------------------------------------------------------
# Weighted: A-Res, the first min(deg, K) edges by key
# ---------------------------------------------------------------------------

# keys a step of the plain version holds at most: centres are taken in
# groups of like degree so that a hub does not widen every row
PLAIN_KEYS = 1 << 24


def interleave_col_weights(col: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The pair table ``[E, 2]`` int32: row e is ``(col[e], bits of
    float32(weights[e]))``. Kernel K reads one 8-byte pair for both an
    edge's key and its neighbour. The JAX package lays the same pairs out
    as ``[ceil(E/128), 256]`` blocks of 128 columns then 128 weights, for
    the TPU's lane DMAs; build the table once per graph
    (``GraphStructure.with_weighted_fastpath``)."""
    check_input(col.dim() == 1 and weights.shape == col.shape,
                "col and weights must be [E] alike")
    return torch.stack([col.to(torch.int32),
                        weights.to(torch.float32).contiguous().view(torch.int32)], dim=1)


def _edge_weights(col, weights, pairs):
    """(col [E] int32, weights [E] f32) of either route."""
    if pairs is not None:
        return pairs[:, 0], pairs[:, 1].contiguous().view(torch.float32)
    return col, weights.to(torch.float32)


def _weighted_keys(start, deg, w_all, seed, centers, hop, width):
    """[b, width] keys of the rows' first ``width`` edges, -inf past a
    row's degree or where ``w <= 0`` (NaN included)."""
    offs = torch.arange(width, dtype=torch.int32, device=deg.device)[None, :]
    valid = offs < deg[:, None]
    E = w_all.shape[0]
    if E == 0:
        w = torch.zeros(valid.shape, dtype=torch.float32, device=deg.device)
    else:
        e = (start.long()[:, None] + offs).clamp(0, E - 1)
        w = torch.where(valid, w_all[e], 0.0)
    u = rng.rand_uniform(seed, centers[:, None], hop * HOP_STRIDE + offs)
    key = torch.log(u.clamp(min=1e-20)) / w
    return torch.where(valid & (w > 0), key, float("-inf"))


def _weighted_order(start, deg, w_all, seed, centers, hop, width):
    """The first ``width`` (key, position) of every centre in sampling
    order: key descending, then position ascending (a stable sort). Centres
    go in groups of like degree, each group at most PLAIN_KEYS keys wide, so
    the work follows the batch's real degrees."""
    B = deg.shape[0]
    dev = deg.device
    keys = torch.full((B, width), float("-inf"), dtype=torch.float32, device=dev)
    pos = torch.zeros((B, width), dtype=torch.int32, device=dev)
    if B == 0:
        return keys, pos
    d = deg.clamp(min=0).cpu().long()
    by_deg = torch.argsort(d, stable=True)
    ds = d[by_deg]
    i = 0
    while i < B:
        # rows i..i+r-1 of the sorted degrees, r * (their widest row) <= PLAIN_KEYS
        need = torch.arange(1, B - i + 1) * ds[i:].clamp(min=1)
        r = max(1, int(torch.searchsorted(need, PLAIN_KEYS, right=True)))
        rows = by_deg[i:i + r].to(dev)
        full = max(int(ds[i + r - 1]), 1)
        k = _weighted_keys(start[rows], deg[rows], w_all, seed, centers[rows], hop, full)
        sk, order = torch.sort(k, dim=1, descending=True, stable=True)
        m = min(full, width)
        keys[rows, :m] = sk[:, :m]
        pos[rows, :m] = order[:, :m].to(torch.int32)
        i += r
    return keys, pos


def _sample_positions_weighted(start, deg, K, seed, centers, hop, w_all):
    """A-Res positions (pos [B, K] int32, mask [B, K] bool): the first
    ``min(deg, K)`` edges by key, a slot masked where its key is -inf."""
    keys, order = _weighted_order(start, deg, w_all, seed, centers, hop, K)
    slots = torch.arange(K, dtype=torch.int32, device=deg.device)[None, :]
    mask = (slots < deg.clamp(max=K)[:, None]) & (keys > float("-inf"))
    return torch.where(mask, order, 0).to(torch.int32), mask


def csr_sample_neighbors_weighted_plain(row_ptr: torch.Tensor, col: Optional[torch.Tensor],
                                        weights: Optional[torch.Tensor], centers: torch.Tensor,
                                        K: int, seed: int = 0, hop: int = 0,
                                        pairs: Optional[torch.Tensor] = None) -> SampleResult:
    """Kernel K's plain version, on any device: the A-Res draw as PyTorch
    ops and the column fetch, from ``col`` and ``weights`` or from the pair
    table ``pairs``."""
    col, w_all = _edge_weights(col, weights, pairs)
    centers = centers.to(torch.int32)
    start, deg = _centre_rows(row_ptr, centers)
    pos, mask = _sample_positions_weighted(start, deg, K, seed, centers, hop, w_all)
    if col.shape[0] == 0 or pos.numel() == 0:
        nbrs = torch.full(pos.shape, -1, dtype=torch.int32, device=pos.device)
    else:
        nbrs = sample_cols_plain(col, start, pos, mask)
    return SampleResult(nbrs, mask, pos, start[:, None] + pos, deg)


def weighted_near_ties(row_ptr: torch.Tensor, col: Optional[torch.Tensor],
                       weights: Optional[torch.Tensor], centers: torch.Tensor, K: int,
                       seed: int = 0, hop: int = 0, pairs: Optional[torch.Tensor] = None,
                       ulps: int = 4):
    """The equality rule of weighted samples. Two implementations of ``log``
    differ by up to a few ulps (over the 2^24 values of ``u``, torch and
    numpy on the CPU up to 4 apart: ``scripts/log_ulps.py``), so keys cannot
    be promised bit-equal, only the positions they select where no two keys
    near the cut are that close.

    A centre is a near tie when two of its finite keys (this plain
    version's, on the tensors' device) lie within ``ulps`` of each other,
    compared as int32 bit patterns of f32 keys of one sign, and one of them
    is among its first ``min(deg, K) + 1`` keys in order. Every other centre
    must match bit for bit. Returns ``(near [B] bool, inside [B] bool)``:
    ``inside`` marks the near ties whose every close pair lies within the
    first ``min(deg, K)`` keys, where the selected set, and so the degree,
    mask count and valid neighbours, must still agree."""
    _, w_all = _edge_weights(col, weights, pairs)
    centers = centers.to(torch.int32)
    start, deg = _centre_rows(row_ptr, centers)
    # keys in order are monotone, so a key's closest partner is a neighbour
    # in that order: the pairs (r, r + 1) with r <= min(deg, K) cover the rule
    keys, _ = _weighted_order(start, deg, w_all, seed, centers, hop, K + 2)
    a, b = keys[:, :-1], keys[:, 1:]
    finite = torch.isfinite(a) & torch.isfinite(b)
    same_sign = torch.signbit(a) == torch.signbit(b)
    gap = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    r = torch.arange(K + 1, device=deg.device)[None, :]
    take = deg.clamp(min=0, max=K)[:, None]
    close = finite & same_sign & (gap <= ulps) & (r <= take)
    near = close.any(dim=1)
    inside = near & ~(close & (r + 1 >= take)).any(dim=1)
    return near, inside


def weighted_rule(got: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
                  near: torch.Tensor, inside: torch.Tensor) -> Tuple[int, int, int]:
    """Hold the sample ``got`` to ``ref`` (``{field: tensor}`` of any of the
    :class:`SampleResult` fields, ``ref``'s fields compared) by the rule of
    :func:`weighted_near_ties`. Returns ``(near-tie centres, near-tie
    centres that differ, centres that break the rule)``: a centre breaks it
    when it differs without a near tie, or differs with one inside its first
    ``min(deg, K)`` keys in its degree or its set of valid positions (and so
    in its count of valid slots and its valid neighbours)."""
    near, inside = near.cpu(), inside.cpu()
    same = torch.ones(near.shape, dtype=torch.bool)
    for f, b in ref.items():
        a, b = got[f].cpu(), b.cpu()
        same &= (a == b) if a.dim() == 1 else (a == b).all(dim=1)
    differ = ~same
    bad = differ & ~near
    pos_a, pos_b = got["positions"].cpu(), ref["positions"].cpu()
    m_a, m_b = got["mask"].cpu(), ref["mask"].cpu()
    deg_differs = ((got["degree"].cpu() != ref["degree"].cpu()) if "degree" in ref
                   else torch.zeros_like(bad))
    for i in torch.nonzero(inside & differ)[:, 0].tolist():
        if deg_differs[i] or not torch.equal(pos_a[i][m_a[i]].sort().values,
                                             pos_b[i][m_b[i]].sort().values):
            bad[i] = True
    return int(near.sum()), int((near & differ).sum()), int(bad.sum())


def sample_hop_weighted(row_ptr: torch.Tensor, col: Optional[torch.Tensor],
                        weights: Optional[torch.Tensor], centers: torch.Tensor, K: int,
                        seed: int, hop: int, pairs: Optional[torch.Tensor] = None
                        ) -> SampleResult:
    """One hop of the weighted sampler on CUDA tensors: kernel K, one launch
    that writes all five fields of :class:`SampleResult`. ``row_ptr`` [N+1]
    and ``centers`` [B] int32; the edges as the pair table ``pairs`` [E, 2]
    int32 (:func:`interleave_col_weights`) or as ``col`` [E] int32 and
    ``weights`` [E] float32, all on one card."""
    if pairs is not None:
        edges = (pairs,)
        check_input(pairs.dim() == 2 and pairs.shape[1] == 2 and pairs.dtype == torch.int32,
                    "pairs must be [E, 2] int32")
    else:
        check_input(col is not None and weights is not None, "give pairs, or col and weights")
        edges = (col, weights)
        check_input(col.dim() == 1 and col.dtype == torch.int32 and weights.dtype == torch.float32
                    and weights.shape == col.shape, "col [E] int32 and weights [E] float32")
    check_input(on_cuda(row_ptr, centers, *edges), "sample_hop_weighted takes CUDA tensors")
    check_input(all(t.dim() == 1 and t.dtype == torch.int32 for t in (row_ptr, centers))
                and row_ptr.shape[0] >= 1, "row_ptr [N+1] and centers [B] must be int32")
    E = edges[0].shape[0]
    check_input(0 <= K < 2**31 and E < 2**31, "K and E must be below 2^31")
    B = centers.shape[0]
    dev = centers.device
    outs = (torch.empty((B, K), dtype=torch.int32, device=dev),
            torch.empty((B, K), dtype=torch.bool, device=dev),
            torch.empty((B, K), dtype=torch.int32, device=dev),
            torch.empty((B, K), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))
    if B == 0:
        return SampleResult(*outs)
    row_ptr, centers = row_ptr.contiguous(), centers.contiguous()
    edges = tuple(t.contiguous() for t in edges)
    ptrs = ((0, 0, edges[0].data_ptr()) if pairs is not None
            else (edges[0].data_ptr(), edges[1].data_ptr(), 0))
    SAMPLE_HOP_WEIGHTED(row_ptr.data_ptr(), row_ptr.shape[0] - 1, *ptrs, E, centers.data_ptr(),
                        B, K, int(seed) & 0xFFFFFFFF, (int(hop) * HOP_STRIDE) & 0xFFFFFFFF,
                        *(t.data_ptr() for t in outs), kernels.cuda_stream(dev))
    return SampleResult(*outs)


def csr_sample_neighbors(row_ptr: torch.Tensor, col: torch.Tensor, centers: torch.Tensor,
                         max_sample: int, *, seed: int = 0, hop: int = 0,
                         weights: Optional[torch.Tensor] = None,
                         max_degree: Optional[int] = None,
                         cw_blocks: Optional[torch.Tensor] = None) -> SampleResult:
    """Sample up to ``max_sample`` neighbours per centre without
    replacement (wholegraph_csr_{unweighted,weighted}_sample_without_
    replacement analog). ``row_ptr`` [N+1] (int32, or int64 with offsets
    below 2^31) and ``col`` [E] (int32) are on the centres' device; centre
    ids are clipped into the graph as the JAX package's fetch does.

    Uniform when ``weights`` is None: on CUDA one launch of kernel C, on the
    CPU its plain version. Weighted (A-Res) otherwise, which needs the
    graph's ``max_degree`` as the JAX package does (neither version depends
    on its value): on CUDA one launch of kernel K, reading ``cw_blocks``,
    the pair table of :func:`interleave_col_weights`, when given and
    ``col`` and ``weights`` otherwise; on the CPU its plain version."""
    K = int(max_sample)
    check_input(K >= 0, "max_sample must be >= 0")
    if col.shape[0] >= 2**31:
        raise NotImplementedError(
            f"graph has {col.shape[0]} edges >= 2^31; edge offsets are int32, so each "
            "shard of the CSR must hold fewer")
    check_input(row_ptr.dim() == 1 and row_ptr.shape[0] >= 1, "row_ptr must be [N+1]")
    if weights is not None and max_degree is None:
        raise ValueError("weighted sampling requires static max_degree")
    if row_ptr.dtype == torch.int64:  # its offsets are int32 on either device
        check_input(int(row_ptr[-1]) < 2**31, "row_ptr's offsets must be below 2^31")
    edges = (col,) if weights is None else (col, weights)
    if cw_blocks is not None and weights is not None:
        edges = (cw_blocks,)
    if not on_cuda(row_ptr, centers, *edges):
        if weights is None:
            return csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)
        return csr_sample_neighbors_weighted_plain(row_ptr, col, weights, centers, K, seed, hop,
                                                   pairs=cw_blocks)
    row_ptr, centers = row_ptr.to(torch.int32), centers.to(torch.int32)
    if weights is None:
        return sample_hop_uniform(row_ptr, col, centers, K, seed, hop)
    if cw_blocks is not None:
        return sample_hop_weighted(row_ptr, None, None, centers, K, seed, hop, pairs=cw_blocks)
    return sample_hop_weighted(row_ptr, col, weights.to(torch.float32), centers, K, seed, hop)
