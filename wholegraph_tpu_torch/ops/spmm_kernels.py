"""Sparse aggregation kernels: D (padded blocks), G (CSR SpMM) and H (CSR
SDDMM).

The counterpart of ``wholegraph_tpu/ops/spmm_pallas.py``. Each public
function here is a wrapper: on CUDA tensors it launches its hand-written
kernel (``csrc/neighbor_agg.cu``, ``csrc/csr_spmm.cu``,
``csrc/csr_sddmm.cu``) or raises; on CPU tensors, and only there, it runs
the plain PyTorch version beside it (``*_plain``).

* :func:`neighbor_reduce` (kernel D) is ``fused_padded_sum``, whose forward
  clips a valid slot's id into ``[0, U)``. :class:`NeighborReduce` gives it
  the gradient of JAX's ``padded_reduce`` (``wholegraph_tpu/ops/spmm.py:
  35-43``, a gather through the same clip): a scatter-add that sends a valid
  slot's gradient to its clipped row. That equals ``spmm_pallas._fps_bwd``'s
  (``spmm_pallas.py:146-158``) only for ids in range: ``_fps_bwd`` drops an
  id ``>= U`` and sends -1 to row ``U - 1`` (ROADMAP quirk R14).
* :func:`csr_spmm` (kernel G) and :func:`csr_sddmm` (kernel H) replace the
  windowed kernels ``_spmm_window_kernel`` and ``_sddmm_window_kernel``.
  :class:`CsrSpmm` and :class:`CsrSddmm` give them gradients whose
  transposed direction is kernel G again, on the CSR that
  :func:`transpose_csr` builds, and whose attention direction is kernel H.
  :func:`spmm_window` and :func:`sddmm_window` keep the JAX entry points'
  signatures and checks; the tile plan they take is checked and unused.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

from .. import kernels
from ..utils.error import check_input
from .gather_kernels import on_cuda, vector_bytes

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

NEIGHBOR_AGG = kernels.Kernel(
    "neighbor_agg", "neighbor_agg.cu", "wg_neighbor_agg",
    [_P, _L, _L, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _P],
    replaces="wholegraph_tpu/ops/spmm_pallas.py:42",  # _fused_agg_kernel
)
CSR_SPMM = kernels.Kernel(
    "csr_spmm", "csr_spmm.cu", "wg_csr_spmm",
    [_P, _P, _P, _P, _L, _L, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    replaces="wholegraph_tpu/ops/spmm_pallas.py:201",  # _spmm_window_kernel
)
CSR_SDDMM = kernels.Kernel(
    "csr_sddmm", "csr_sddmm.cu", "wg_csr_sddmm",
    [_P, _P, _P, _L, _P, _L, _L, _P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P],
    replaces="wholegraph_tpu/ops/spmm_pallas.py:771",  # _sddmm_window_kernel
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel H's plan: destination rows per CTA, the widest source span it stages
# in shared memory, and the most edges a staged tile may have
SDDMM_TILE = 128
SDDMM_WINDOW = 384
SDDMM_EDGE_CAP = 4096
# kernel G's: a tile of 128 rows of a CSR whose edges reach d ± 96 spans at
# most 320 source rows; two 40 KB slabs and 28 KB of edges keep two CTAs an SM
SPMM_TILE = 128
SPMM_WINDOW = 320
SPMM_EDGE_CAP = 3584


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def agg_plan(K: int, row_bytes: int, vec_bytes: int) -> Tuple[int, int]:
    """Kernel D's plan (``csrc/neighbor_agg.cu``) for centres of ``K`` slots
    over rows of ``row_bytes`` read in vectors of ``vec_bytes``: (lanes a
    centre, slices a row).

    A centre takes as many lanes (a power of two, up to a warp's 32) as its
    row has vectors or its slots number, so that one pass loads its ids and
    one reads its slice, one vector a lane: a narrower row packs
    ``32 // lanes`` centres into a warp, and a wider one is split over warps
    in slices of 32 vectors (512 bytes at 16-byte vectors). Whole 1 KB rows
    in one warp, 2 vectors a lane, were slower at every call measured, small
    or large (``PERF.md`` §6, kernel D), so the number of centres does not
    enter."""
    vpr = row_bytes // vec_bytes
    lanes = min(32, _pow2_at_least(max(vpr, min(K, 32))))
    return lanes, -(-vpr // lanes)


# edges per step of the plain versions: an unchunked [E, D] intermediate is
# 21 GB at the bench shape (the chunking of spmm_pallas._segment_spmm_chunked)
PLAIN_CHUNK = 1 << 20


def neighbor_reduce_plain(x: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
                          mean: bool) -> torch.Tensor:
    """``sum_k mask[b, k] * x[clip(nbr_idx[b, k])]`` in f32, divided by
    ``max(count, 1)`` for the mean, returned in x's dtype."""
    idx = nbr_idx.long().clamp(0, x.shape[0] - 1)
    s = torch.where(mask[..., None], x[idx].float(), 0.0).sum(dim=1)
    if mean:
        s = s / mask.sum(dim=1, keepdim=True).clamp(min=1).float()
    return s.to(x.dtype)


def neighbor_reduce(x: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
                    mean: bool) -> torch.Tensor:
    """Masked neighbour sum (or mean) of ``x`` [U, D] over a padded
    ``nbr_idx``/``mask`` [B, K] block → [B, D] in x's dtype. No gradient: see
    :class:`NeighborReduce`."""
    check_input(x.dim() == 2, f"x must be [U, D], got {tuple(x.shape)}")
    check_input(nbr_idx.dim() == 2 and nbr_idx.dtype == torch.int32, "nbr_idx must be [B, K] int32")
    check_input(mask.shape == nbr_idx.shape and mask.dtype == torch.bool, "mask must be bool like nbr_idx")
    check_input(x.dtype in _DTYPE_CODE, f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    B, K = nbr_idx.shape
    D = x.shape[1]
    if B == 0 or D == 0:
        return torch.zeros((B, D), dtype=x.dtype, device=x.device)
    check_input(x.shape[0] > 0, "reduce over an empty x")
    if not on_cuda(x, nbr_idx, mask):
        return neighbor_reduce_plain(x, nbr_idx, mask, mean)
    if K == 0:
        return torch.zeros((B, D), dtype=x.dtype, device=x.device)
    check_input(x.is_contiguous(), "x must be contiguous")
    check_input(K < 2**31, "K must be below 2^31")
    nbr_idx, mask = nbr_idx.contiguous(), mask.contiguous()
    out = torch.empty((B, D), dtype=x.dtype, device=x.device)
    row_bytes = D * x.element_size()
    vec = vector_bytes(row_bytes, x.data_ptr(), out.data_ptr())
    NEIGHBOR_AGG(x.data_ptr(), x.shape[0], row_bytes, nbr_idx.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), B, K, int(mean), _DTYPE_CODE[x.dtype], vec,
                 *agg_plan(K, row_bytes, vec), kernels.cuda_stream(x.device))
    return out


class NeighborReduce(torch.autograd.Function):
    """Differentiable :func:`neighbor_reduce`. The backward scatters each
    edge's output cotangent (scaled by 1/count for the mean) onto its
    neighbour row: ``dx[nbr[b, k]] += mask[b, k] * ct[b]``."""

    @staticmethod
    def forward(ctx, x, nbr_idx, mask, mean: bool):
        ctx.save_for_backward(nbr_idx, mask)
        ctx.mean = mean
        ctx.x_shape = x.shape
        return neighbor_reduce(x, nbr_idx, mask, mean)

    @staticmethod
    def backward(ctx, ct):
        nbr_idx, mask = ctx.saved_tensors
        U, D = ctx.x_shape
        B, K = nbr_idx.shape
        w = mask.to(torch.float32)
        if ctx.mean:
            w = w / w.sum(dim=1, keepdim=True).clamp(min=1.0)
        edges = (w[..., None] * ct.float()[:, None, :]).reshape(B * K, D)
        # masked slots land in an extra row U that is cut off (the mode="drop"
        # of _fps_bwd), so a non-finite cotangent never leaks through them
        idx = torch.where(mask, nbr_idx.long().clamp(0, U - 1), U).reshape(-1)
        dx = torch.zeros((U + 1, D), dtype=torch.float32, device=ct.device).index_add_(0, idx, edges)
        return dx[:U].to(ct.dtype), None, None, None


# ---------------------------------------------------------------------------
# Kernels G and H: CSR SpMM and SDDMM
# ---------------------------------------------------------------------------


def _check_csr(row_ptr: torch.Tensor, col: torch.Tensor) -> None:
    check_input(row_ptr.dim() == 1 and row_ptr.shape[0] >= 1, "row_ptr must be [n + 1]")
    check_input(col.dim() == 1, "col must be 1-D")
    for name, t in (("row_ptr", row_ptr), ("col", col)):
        check_input(t.dtype in (torch.int32, torch.int64), f"{name} must be int32/int64, got {t.dtype}")
    check_input(col.shape[0] < 2**31, "edge offsets are int32: the graph must have < 2^31 edges")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride along its last axis (a row stride is kept)."""
    return t if t.stride(1) == 1 else t.contiguous()


def _index32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _vec(t: torch.Tensor, *others: torch.Tensor) -> int:
    """Elements per vector load for rows of ``t`` (and of ``others``, same
    dtype): the widest of 16, 8, 4, 2 bytes that divides the row, every row
    stride and every base pointer."""
    es = t.element_size()
    row = t.shape[1] * es
    for o in (t,) + others:
        row = math.gcd(row, o.stride(0) * es)
    return vector_bytes(row, *(o.data_ptr() for o in (t,) + others)) // es


def csr_edge_dst(row_ptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """Each edge's destination row, int64 ``[n_edges]``: row d repeated
    ``row_ptr[d+1] - row_ptr[d]`` times."""
    n = row_ptr.shape[0] - 1
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=row_ptr.device), deg,
                                   output_size=n_edges)


def csr_spmm_plain(row_ptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor, *,
                   reduce: str = "sum", edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[d] = Σ_{e ∈ row d} (w_e ·) x[clip(col[e])]`` in f32, divided by
    ``max(deg_d, 1)`` for the mean, in x's dtype; ``PLAIN_CHUNK`` edges at
    a time, summed with ``index_add_``."""
    n, E, D = row_ptr.shape[0] - 1, col.shape[0], x.shape[1]
    out = torch.zeros((n, D), dtype=torch.float32, device=x.device)
    if E:
        dst = csr_edge_dst(row_ptr, E)
        src = col.long().clamp(0, x.shape[0] - 1)
        for i in range(0, E, PLAIN_CHUNK):
            msgs = x[src[i:i + PLAIN_CHUNK]].float()
            if edge_weight is not None:
                msgs = msgs * edge_weight[i:i + PLAIN_CHUNK, None].float()
            out.index_add_(0, dst[i:i + PLAIN_CHUNK], msgs)
    if reduce == "mean":
        out = out / (row_ptr[1:] - row_ptr[:-1]).clamp(min=1).float()[:, None]
    return out.to(x.dtype)


def _check_stats(stats: Optional[torch.Tensor], device: torch.device) -> None:
    check_input(stats is None or (stats.dtype == torch.int64 and stats.numel() >= 4
                                  and stats.device == device and stats.is_contiguous()),
                "_stats must be a contiguous int64 tensor of 4 on the operands' device")


def csr_spmm(row_ptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor, *,
             reduce: str = "sum", edge_weight: Optional[torch.Tensor] = None,
             route: str = "forward", _stats: Optional[torch.Tensor] = None,
             _stage: bool = True) -> torch.Tensor:
    """Kernel G: the SpMM over a destination-sorted CSR, ``out[d] =
    Σ_{e=row_ptr[d]}^{row_ptr[d+1]-1} w_e · x[clip(col[e])]`` (``w_e = 1``
    without weights), accumulated in f32 and returned in x's dtype (f32 or
    bf16). ``mean`` divides by ``max(deg_d, 1)``, the edge count; an empty
    row gives zeros. ``x`` [n_src, D] may have a row stride. ``route``
    labels the launch in ``CSR_SPMM.routes``. No gradient: see
    :class:`CsrSpmm`.

    ``_stats`` and ``_stage`` are internal, for reports and checks.
    ``_stats``: an int64 tensor of 4 on x's device to which the kernel adds
    the tiles it staged in shared memory, the bytes of x it staged, the
    tiles it left to device memory and their edges; the plain version
    leaves it as it is. ``_stage=False`` computes every tile from device
    memory (bit-identical: the kernel adds each row's edges in one order on
    either route)."""
    _check_csr(row_ptr, col)
    check_input(reduce in ("sum", "mean"), f"unknown reduce {reduce!r}")
    check_input(x.dim() == 2, f"x must be [n_src, D], got {tuple(x.shape)}")
    check_input(x.dtype in _DTYPE_CODE, f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    _check_stats(_stats, x.device)
    E = col.shape[0]
    tensors = [row_ptr, col, x]
    if edge_weight is not None:
        check_input(edge_weight.shape == (E,), f"edge_weight must be [{E}]")
        check_input(edge_weight.is_floating_point(), "edge_weight must be floating point")
        tensors.append(edge_weight)
    check_input(x.shape[0] > 0 or E == 0, "an SpMM with edges over an empty x")
    if not on_cuda(*tensors):
        return csr_spmm_plain(row_ptr, col, x, reduce=reduce, edge_weight=edge_weight)
    n, D = row_ptr.shape[0] - 1, x.shape[1]
    if n == 0 or D == 0 or E == 0:
        return torch.zeros((n, D), dtype=x.dtype, device=x.device)
    x = _rows(x)
    out = torch.empty((n, D), dtype=x.dtype, device=x.device)
    w = None if edge_weight is None else edge_weight.to(torch.float32).contiguous()
    spans = torch.empty((2 * -(-n // SPMM_TILE),), dtype=torch.int32, device=x.device)
    row_ptr, col = _index32(row_ptr), _index32(col)
    CSR_SPMM(row_ptr.data_ptr(), col.data_ptr(), None if w is None else w.data_ptr(),
             x.data_ptr(), x.stride(0), x.shape[0], out.data_ptr(), out.stride(0), n, D,
             int(reduce == "mean"), _DTYPE_CODE[x.dtype], _vec(x, out), SPMM_TILE,
             SPMM_WINDOW if _stage else 0,
             SPMM_EDGE_CAP, spans.data_ptr(), None if _stats is None else _stats.data_ptr(),
             kernels.cuda_stream(x.device), route=route)
    return out


def csr_sddmm_plain(row_ptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """``out[e] = <a[dst_e], b[clip(col[e])]>`` in f32, ``PLAIN_CHUNK``
    edges at a time."""
    E = col.shape[0]
    out = torch.empty((E,), dtype=torch.float32, device=a.device)
    if E:
        dst = csr_edge_dst(row_ptr, E)
        src = col.long().clamp(0, b.shape[0] - 1)
        for i in range(0, E, PLAIN_CHUNK):
            j = slice(i, i + PLAIN_CHUNK)
            out[j] = (a[dst[j]].float() * b[src[j]].float()).sum(dim=-1)
    return out


def csr_sddmm(row_ptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, *, _stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel H: the SDDMM over a destination-sorted CSR, ``out[e] =
    Σ_j a[dst_e, j] · b[clip(col[e]), j]`` for every edge, ``dst_e`` from
    ``row_ptr``; a [n, D] and b [n_src, D] (f32 or bf16, alike, either with
    a row stride), accumulated in f32, out [E] f32. No gradient: see
    :class:`CsrSddmm`.

    ``_stats`` is internal, for reports: an int64 tensor of 4 on the card
    to which the kernel adds the tiles it staged in shared memory, the bytes
    it staged, the tiles it read from device memory and their edges. The
    plain version leaves it as it is."""
    _check_csr(row_ptr, col)
    check_input(a.dim() == 2 and b.dim() == 2, "a and b must be 2-D")
    check_input(a.shape[1] == b.shape[1], "a/b dim mismatch")
    check_input(a.shape[0] == row_ptr.shape[0] - 1, "a rows != num_dst")
    check_input(a.dtype == b.dtype and a.dtype in _DTYPE_CODE,
                f"a and b must share a dtype in {list(_DTYPE_CODE)}, got {a.dtype}, {b.dtype}")
    E = col.shape[0]
    check_input(b.shape[0] > 0 or E == 0, "an SDDMM with edges over an empty b")
    if not on_cuda(row_ptr, col, a, b):
        return csr_sddmm_plain(row_ptr, col, a, b)
    if E == 0 or a.shape[1] == 0:
        return torch.zeros((E,), dtype=torch.float32, device=a.device)
    _check_stats(_stats, a.device)
    a, b = _rows(a), _rows(b)
    out = torch.empty((E,), dtype=torch.float32, device=a.device)
    spans = torch.empty((2 * -(-a.shape[0] // SDDMM_TILE),), dtype=torch.int32, device=a.device)
    row_ptr, col = _index32(row_ptr), _index32(col)
    CSR_SDDMM(row_ptr.data_ptr(), col.data_ptr(), a.data_ptr(), a.stride(0), b.data_ptr(),
              b.stride(0), b.shape[0], out.data_ptr(), a.shape[0], a.shape[1],
              _DTYPE_CODE[a.dtype], _vec(a, b), SDDMM_TILE, SDDMM_WINDOW, SDDMM_EDGE_CAP,
              spans.data_ptr(), None if _stats is None else _stats.data_ptr(),
              kernels.cuda_stream(a.device))
    return out


def transpose_csr(row_ptr: torch.Tensor, col: torch.Tensor,
                  n_src: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The transposed CSR, on the CSR's device: ``(t_row_ptr [n_src + 1]
    int32, t_col [E] int32, perm [E] int64)``. ``perm`` is a stable sort of
    the (clipped) ``col``, so edge ``perm[k]`` is the k-th edge in source
    order, and ``t_col[k]`` is its destination."""
    E = col.shape[0]
    c = col.to(torch.int32).clamp(0, max(n_src - 1, 0))
    perm = torch.sort(c, stable=True).indices
    t_col = csr_edge_dst(row_ptr, E)[perm].to(torch.int32)
    counts = torch.bincount(c, minlength=n_src)
    t_row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    return t_row_ptr, t_col, perm


Transposed = Optional[Callable[[], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]


class CsrSpmm(torch.autograd.Function):
    """Differentiable :func:`csr_spmm`:
    ``CsrSpmm.apply(row_ptr, col, x, edge_weight, reduce, weight_grad=True,
    transposed=None)``.

    * dx: kernel G on the transposed CSR over ``ct`` (scaled by
      ``1/max(deg_d, 1)`` for the mean, as ``spmm_pallas._sw_bwd`` does),
      weighted by ``edge_weight[perm]``;
    * dw: kernel H, ``<ct[dst_e], x[col_e]>`` (the same scaled ``ct``),
      when the weights need a gradient and ``weight_grad`` is true; zeros
      when ``weight_grad`` is false (``spmm_pallas.py:669-674``).

    ``transposed`` returns the :func:`transpose_csr` of the CSR (a
    ``FullGraph`` caches it); None builds it in the backward."""

    @staticmethod
    def forward(ctx, row_ptr, col, x, edge_weight, reduce: str, weight_grad: bool = True,
                transposed: Transposed = None):
        save_x = edge_weight is not None and weight_grad
        ctx.save_for_backward(row_ptr, col, x if save_x else None, edge_weight)
        ctx.reduce, ctx.weight_grad, ctx.transposed = reduce, weight_grad, transposed
        ctx.x_rows, ctx.x_dtype = x.shape[0], x.dtype
        return csr_spmm(row_ptr, col, x, reduce=reduce, edge_weight=edge_weight)

    @staticmethod
    def backward(ctx, ct):
        row_ptr, col, x, w = ctx.saved_tensors
        if ctx.reduce == "mean":
            deg = (row_ptr[1:] - row_ptr[:-1]).clamp(min=1).to(ct.dtype)
            ct = ct / deg[:, None]
        dx = dw = None
        if ctx.needs_input_grad[2]:
            t_row_ptr, t_col, perm = (ctx.transposed() if ctx.transposed is not None
                                      else transpose_csr(row_ptr, col, ctx.x_rows))
            dx = csr_spmm(t_row_ptr, t_col, ct, reduce="sum",
                          edge_weight=None if w is None else w[perm],
                          route="transposed").to(ctx.x_dtype)
        if w is not None and ctx.needs_input_grad[3]:
            dw = (csr_sddmm(row_ptr, col, ct.to(x.dtype), x).to(w.dtype) if ctx.weight_grad
                  else torch.zeros_like(w))
        return None, None, dx, dw, None, None, None


class CsrSddmm(torch.autograd.Function):
    """Differentiable :func:`csr_sddmm`:
    ``CsrSddmm.apply(row_ptr, col, a, b, transposed=None)``.

    * da: kernel G over ``b`` weighted by ``ct``;
    * db: kernel G on the transposed CSR over ``a`` weighted by
      ``ct[perm]`` (``spmm_pallas._sdw_bwd``, ``:981-1004``)."""

    @staticmethod
    def forward(ctx, row_ptr, col, a, b, transposed: Transposed = None):
        ctx.save_for_backward(row_ptr, col, a, b)
        ctx.transposed = transposed
        return csr_sddmm(row_ptr, col, a, b)

    @staticmethod
    def backward(ctx, ct):
        row_ptr, col, a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[2]:
            da = csr_spmm(row_ptr, col, b, reduce="sum", edge_weight=ct).to(a.dtype)
        if ctx.needs_input_grad[3]:
            t_row_ptr, t_col, perm = (ctx.transposed() if ctx.transposed is not None
                                      else transpose_csr(row_ptr, col, b.shape[0]))
            db = csr_spmm(t_row_ptr, t_col, a, reduce="sum", edge_weight=ct[perm],
                          route="transposed").to(b.dtype)
        return None, None, da, db, None


def spmm_window(row_ptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor, *, window: int,
                edge_cap: int, tile: int = 256, reduce: str = "sum",
                edge_weight: Optional[torch.Tensor] = None, weight_grad: bool = True,
                weight_precision: str = "highest") -> torch.Tensor:
    """``spmm_pallas.spmm_window``'s entry point: the differentiable SpMM
    ``out[d] = Σ_{e ∈ row d} (w_e ·) x[col_e]`` (sum or mean) through
    :class:`CsrSpmm` (kernel G on the card), returned in x's dtype.

    The argument checks are the JAX package's: an unknown reduce, a
    weighted mean (the JAX kernel would divide by the weight sum) and an
    unknown ``weight_precision`` are rejected. ``window``, ``edge_cap``,
    ``tile`` and ``weight_precision`` are checked and then unused: kernel G
    needs no tile plan, is exact on any CSR (no out-of-window zeros) and
    takes the weights in f32. There is no ``dim % 128`` rule and no VMEM
    estimate."""
    check_input(reduce in ("sum", "mean"), f"unknown reduce {reduce!r}")
    check_input(not (reduce == "mean" and edge_weight is not None),
                "spmm_window: weighted mean is unsupported (weight-sum vs edge-count "
                "normalisation mismatch) — use reduce='sum' and normalise outside")
    check_input(weight_precision in ("highest", "split2", "bf16"),
                f"unknown weight_precision {weight_precision!r}")
    check_input(int(window) > 0 and int(edge_cap) > 0 and int(tile) > 0,
                "window, edge_cap and tile must be positive")
    return CsrSpmm.apply(row_ptr, col, x, edge_weight, reduce, bool(weight_grad), None)


def sddmm_window(row_ptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 *, window: int, edge_cap: int, tile: int = 256,
                 select_mode: str = "exact") -> torch.Tensor:
    """``spmm_pallas.sddmm_window``'s entry point: the differentiable SDDMM
    ``e_k = <a[dst_k], b[col_k]>`` over the CSR's edges through
    :class:`CsrSddmm` (kernel H on the card), f32 ``[E]``.

    The argument checks are the JAX package's (a/b width mismatch, ``a``
    rows != num_dst, unknown ``select_mode``). ``window``, ``edge_cap``,
    ``tile`` and ``select_mode`` are checked and then unused: kernel H
    needs no tile plan and reads the rows in their own precision. There is
    no ``dim % 128`` rule and no VMEM estimate."""
    check_input(a.shape[1] == b.shape[1], "a/b dim mismatch")
    check_input(a.shape[0] == row_ptr.shape[0] - 1, "a rows != num_dst")
    check_input(select_mode in ("exact", "split2"), f"unknown select_mode {select_mode!r}")
    check_input(int(window) > 0 and int(edge_cap) > 0 and int(tile) > 0,
                "window, edge_cap and tile must be positive")
    return CsrSddmm.apply(row_ptr, col, a, b, None)
