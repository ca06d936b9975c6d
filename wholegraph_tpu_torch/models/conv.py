"""Graph convolutions on sampled blocks and on full graphs.

Port of ``wholegraph_tpu/models/conv.py``: :class:`FullGraph`, the
full-graph aggregation ``_fg_spmm`` and the fused GAT message passing
``_fg_gat_windowed``, and the convs :class:`SAGEConv`, :class:`GCNConv`,
:class:`GATConv` and :class:`RGCNConv`, each on sampled blocks and on a
full graph. On a sampled block, sum and mean aggregations run kernel D
(``_hop_reduce``) and neighbour rows come through ``padded_gather_neighbors``
(kernel A); on a full graph, sum and mean aggregations run kernel G
(:class:`~wholegraph_tpu_torch.ops.spmm_kernels.CsrSpmm`, whose backward is G
on the transposed CSR and, for GAT's attention weights, kernel H). Where
the JAX package leaves the math to XLA (the sampled GAT's logits and
softmax, RGCN's one-hot einsums and segment sums), the port uses plain
PyTorch. :func:`gat_attention` and :func:`rgcn_relation_mean` serve the
full-graph convs and the halo layers of :mod:`..graph.partitioned` alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.structure import HopSubgraph
from ..ops import spmm as S
from ..ops.spmm_kernels import CsrSpmm, transpose_csr
from ..utils import perf
from ..utils.error import check_input


@dataclasses.dataclass
class FullGraph:
    """COO edges sorted by destination over one node set of ``num_nodes``
    rows, with their CSR ``row_ptr`` [num_nodes + 1] int32: messages flow
    ``edge_src`` → ``edge_dst``, and ``edge_src`` is the CSR's ``col``.

    Built directly from a COO (``row_ptr=None``) the graph derives
    ``row_ptr`` from ``edge_dst``, which must then be sorted;
    ``GraphStructure.to_full_graph`` passes its own CSR.
    ``edge_type`` [E] int32 holds each edge's relation id (RGCN). ``window`` and
    ``edge_cap`` record the JAX package's tile plan where
    ``to_full_graph(windowed=True)`` found one feasible; kernel G needs no
    plan, so they change no route. :meth:`transposed` builds the transposed
    CSR of the backward once, on first use."""

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    num_nodes: int
    edge_type: Optional[torch.Tensor] = None
    row_ptr: Optional[torch.Tensor] = None
    window: Optional[int] = None
    edge_cap: Optional[int] = None
    _transposed: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        E, n = self.edge_src.shape[0], int(self.num_nodes)
        check_input(self.edge_src.dim() == 1 and self.edge_dst.shape == (E,)
                    and (self.edge_type is None or self.edge_type.shape == (E,)),
                    "edge_src, edge_dst and edge_type must be [E]")
        if self.row_ptr is None:
            dst = self.edge_dst
            check_input(E == 0 or (bool((dst[1:] >= dst[:-1]).all())
                                   and int(dst[0]) >= 0 and int(dst[-1]) < n),
                        "FullGraph edges must be sorted by destination, with ids in "
                        "[0, num_nodes)")
            self.row_ptr = torch.searchsorted(
                dst, torch.arange(n + 1, device=dst.device, dtype=dst.dtype),
                out_int32=True)
        check_input(self.row_ptr.shape == (n + 1,), f"row_ptr must be [{n + 1}]")

    @property
    def in_degree(self) -> torch.Tensor:
        """Edges into each node, [num_nodes] int32."""
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def transposed(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``transpose_csr(row_ptr, edge_src, num_nodes)``, built once."""
        if self._transposed is None:
            self._transposed = transpose_csr(self.row_ptr, self.edge_src, self.num_nodes)
        return self._transposed


Adj = Union[HopSubgraph, FullGraph]


def _fg_spmm(g: FullGraph, x: torch.Tensor, reduce: str,
             edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-graph aggregation. Sum and mean (weighted or not: the mean
    divides by the edge count) run :class:`CsrSpmm`, kernel G on the card,
    whatever plan the graph records; max stays the plain COO ``spmm``. Its
    span is ``fg_spmm``."""
    with perf.span("fg_spmm"):
        if reduce in ("sum", "mean"):
            return CsrSpmm.apply(g.row_ptr, g.edge_src, x, edge_weight, reduce, True,
                                 g.transposed)
        return S.spmm(g.edge_src, g.edge_dst, x, g.num_nodes, reduce, edge_weight=edge_weight)


def gat_attention(e_src: torch.Tensor, e_dst: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, *, negative_slope: float,
                  add_self_loop: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """GAT's attention over a destination-sorted edge list, in plain
    PyTorch: the ``[E, H]`` logits ``leaky_relu(e_src[src] + e_dst[dst])``
    and their softmax over each destination's edges. ``e_src`` [n_src, H]
    and ``e_dst`` [n_dst, H] are the attention terms; the first ``n_dst``
    source rows are the destinations themselves, whose self loop (with
    ``add_self_loop``) joins each softmax analytically, so the edge list
    stays intact. Returns ``(alpha [E, H], alpha_self [n_dst, H] or
    None)``; the subtracted maximum carries no gradient."""
    N = e_dst.shape[0]
    logits = F.leaky_relu(e_src[src] + e_dst[dst], negative_slope)  # [E, H]
    if not add_self_loop:
        return S.edge_softmax(dst, logits, N), None
    l_self = F.leaky_relu(e_src[:N] + e_dst, negative_slope)  # [N, H]
    mx = torch.maximum(S.segment_max(logits.detach(), dst, N), l_self.detach())
    z = torch.exp(logits - mx[dst])
    z_self = torch.exp(l_self - mx)
    den = S.segment_sum(z, dst, N) + z_self
    return z / den[dst].clamp(min=1e-16), z_self / den.clamp(min=1e-16)


def rgcn_relation_mean(x: torch.Tensor, w_rel: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, edge_type: torch.Tensor,
                       n_dst: int) -> torch.Tensor:
    """RGCN's message passing over an edge list, in plain PyTorch (as XLA
    in JAX): the mean of each relation's neighbours through that relation's
    weight, summed over the relations, ``Σ_r mean_{s ∈ N_r(d)} x[s] @
    W_r`` [n_dst, Dout], from ``x`` [n_src, Din] and ``w_rel`` [R, Din,
    Dout]: an ``index_add_`` of the ``[E, Dout]`` messages into ``n_dst·R``
    segments."""
    R = w_rel.shape[0]
    h = torch.einsum("nd,rde->nre", x, w_rel).reshape(x.shape[0] * R, -1)  # [n_src·R, Dout]
    et = edge_type.long()
    msgs = h.index_select(0, src.long() * R + et)  # [E, Dout]
    seg = dst.long() * R + et
    summed = S.segment_sum(msgs, seg, n_dst * R).view(n_dst, R, -1)
    cnt = S.segment_sum(x.new_ones(src.shape[0]), seg, n_dst * R).view(n_dst, R, 1)
    return (summed / cnt.clamp(min=1.0)).sum(dim=1)


def _fg_gat_windowed(g: FullGraph, featv: torch.Tensor, e_src_n: torch.Tensor,
                     e_dst_n: torch.Tensor, *, negative_slope: float,
                     add_self_loop: bool) -> torch.Tensor:
    """Full-graph GAT message passing (``conv.py:100-186``): the attention
    of :func:`gat_attention` from the ``[N, H]`` attention terms, then
    kernel G once per head weighted by ``alpha[:, h]`` over the strided head
    view ``featv[:, h, :]``, plus ``alpha_self · featv``. The attention
    gradient is kernel H (:class:`CsrSpmm`'s dw)."""
    H = featv.shape[1]
    src = g.edge_src
    alpha, alpha_self = gat_attention(e_src_n, e_dst_n, src, g.edge_dst,
                                      negative_slope=negative_slope, add_self_loop=add_self_loop)
    out = torch.stack([
        CsrSpmm.apply(g.row_ptr, src, featv[:, h, :], alpha[:, h], "sum", True, g.transposed)
        for h in range(H)], dim=1)  # [N, H, D]
    if alpha_self is not None:
        out = out + alpha_self[..., None].to(featv.dtype) * featv
    return out


def _hop_reduce(x: torch.Tensor, g: HopSubgraph, reduce: str) -> torch.Tensor:
    """Sampled-block aggregation (``conv.py:195-210``): a hop that carries a
    windowed plan (``MultilayerSample.with_windowed_agg``) goes through
    ``padded_reduce_windowed`` for sum and mean, any other through
    ``padded_reduce``. Both are kernel D on the card and exact; JAX's extra
    guards (D a multiple of 128, at most 4,096 rows off the TPU) are its
    windowed kernel's and stay behind."""
    if g.run_bounds is not None and g.windows is not None and reduce in ("sum", "mean"):
        return S.padded_reduce_windowed(x, g.nbr_idx, g.mask, reduce,
                                        run_bounds=g.run_bounds, windows=g.windows)
    return S.padded_reduce(x, g.nbr_idx, g.mask, reduce)


class SAGEConv(nn.Module):
    """GraphSAGE conv: ``concat[x_self, agg(x_neigh)] @ W + b``
    (CuGraphSAGEConv analog, sage_conv.py:73-95: agg_concat_n2n + linear).

    On a :class:`HopSubgraph`, ``x`` holds the next level's unique nodes and
    the block's targets are its first ``g.num_targets`` rows; on a
    :class:`FullGraph`, ``x`` holds every node. The concat order matches the
    JAX package's so that a bridged flax ``proj`` kernel loads 1:1.

    On a :class:`FullGraph` with a sum or mean aggregator, a layer that
    narrows (``out_dim`` rounded up to 4 below ``in_dim``) projects before
    it aggregates: :meth:`_project_first`."""

    def __init__(self, in_dim: int, out_dim: int, aggregator: str = "mean",
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.aggregator = aggregator
        self.proj = nn.Linear(2 * in_dim, out_dim, bias=bias, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, g: Adj) -> torch.Tensor:
        if isinstance(g, HopSubgraph):
            xs = x[: g.num_targets]
            xn = _hop_reduce(x, g, self.aggregator)
        else:
            w = -(-self.proj.out_features // 4) * 4
            if self.aggregator in ("sum", "mean") and w < x.shape[1]:
                return self._project_first(x, g, w)
            xs, xn = x, _fg_spmm(g, x, self.aggregator)
        return self.proj(torch.cat([xs, xn], dim=-1))

    def _project_first(self, x: torch.Tensor, g: FullGraph, w: int) -> torch.Tensor:
        """``x @ W_s + agg(x @ W_n) + b``, which equals ``proj(cat[x,
        agg(x)])`` because a sum or mean over neighbours is linear (DGL's
        ``lin_before_mp``): kernel G reads rows of ``w`` columns, not
        ``in_dim``. ``W_n`` takes zero rows up to ``w``, so that G's rows are
        whole 16-byte vectors; the zero columns are cut off after it. Its
        span is ``sage.project_first``."""
        din, dout = x.shape[1], self.proj.out_features
        W = self.proj.weight
        with perf.span("sage.project_first"):
            w_n = torch.cat([W[:, din:], W.new_zeros(w - dout, din)])  # [w, din]
            agg = _fg_spmm(g, F.linear(x, w_n), self.aggregator)
            return F.linear(x, W[:, :din], self.proj.bias) + agg[:, :dout]


class GCNConv(nn.Module):
    """GCN conv with the symmetric ``D^-1/2 A D^-1/2`` normalisation and an
    implicit self loop (``conv.py:243-305``): ``h = x @ W``, ``out =
    (Σ_{s → d} h[s] / sqrt(deg_s) + h[d] / sqrt(deg_d)) / sqrt(deg_d)`` plus
    ``bias``, with ``deg`` counting the self loop.

    On a :class:`FullGraph`, ``deg`` is the in-degree + 1. On a sampled
    :class:`HopSubgraph`, ``degree_mode`` picks the degrees:

    * ``"block"``: the block's own (DGL GraphConv block semantics): a
      target's valid slots + 1, and each source row's count of valid slots
      that name it, + 1 for the target rows (the prefix of ``x``);
    * ``"true"``: the graph's, from ``HopSubgraph.node_degree``
      (``multilayer_sample(with_degrees=True)``; without it the conv raises
      ``InvalidInput``): with fanout >= the largest degree the sampled
      output equals the full-graph pass;
    * ``"auto"``: true degrees where the hop carries them, else block.

    The sampled sum is ``_hop_reduce``: kernel D on the card."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, degree_mode: str = "auto",
                 device=None, dtype=None):
        super().__init__()
        check_input(degree_mode in ("auto", "block", "true"),
                    f"degree_mode {degree_mode!r} is 'auto', 'block' or 'true'")
        self.degree_mode = degree_mode
        self.proj = nn.Linear(in_dim, out_dim, bias=False, device=device, dtype=dtype)
        self.bias = (nn.Parameter(torch.zeros(out_dim, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, g: Adj) -> torch.Tensor:
        h = self.proj(x)
        if isinstance(g, HopSubgraph):
            out = self._sampled(h, g)
        else:
            inv = torch.rsqrt(g.in_degree.to(h.dtype) + 1.0)[:, None]
            out = (_fg_spmm(g, h * inv, "sum") + h * inv) * inv
        return out if self.bias is None else out + self.bias

    def _sampled(self, h: torch.Tensor, g: HopSubgraph) -> torch.Tensor:
        B, U = g.num_targets, h.shape[0]
        check_input(self.degree_mode != "true" or g.node_degree is not None,
                    "degree_mode='true' needs HopSubgraph.node_degree; sample with "
                    "multilayer_sample(with_degrees=True)")
        if self.degree_mode != "block" and g.node_degree is not None:
            inv_src = torch.rsqrt((g.node_degree.to(h.dtype) + 1.0).clamp(min=1.0))
            inv_dst = inv_src[:B]
        else:
            # masked slots go to an extra row U that is cut off (JAX's drop mode)
            flat = torch.where(g.mask, g.nbr_idx, U).reshape(-1).long()
            deg_src = h.new_zeros(U + 1).index_add_(0, flat, h.new_ones(flat.shape[0]))[:U]
            deg_src[:B] += 1.0
            inv_src = torch.rsqrt(deg_src.clamp(min=1.0))
            inv_dst = torch.rsqrt((g.mask.sum(dim=1) + 1).to(h.dtype))
        hs = h * inv_src[:, None]
        return (_hop_reduce(hs, g, "sum") + hs[:B]) * inv_dst[:, None]


class GATConv(nn.Module):
    """Multi-head GAT conv (CuGraphGATConv analog, gat_conv.py:22-102;
    ``conv.py:308-394``): ``out_dim`` per head, ``num_heads`` heads,
    concatenated (``concat_heads``) or averaged. Parameters: ``proj`` (no
    bias), ``attn_src`` and ``attn_dst`` [H, out_dim].

    On a sampled :class:`HopSubgraph` (with ``add_self_loop`` the target's
    own row joins its slots as column 0): the neighbours' projected rows
    [B, K', H·D] come through ``padded_gather_neighbors`` (kernel A, clip),
    then the logits, ``padded_softmax`` over the valid slots and the
    weighted sum, in plain PyTorch as they are plain XLA in JAX. On a
    :class:`FullGraph`: ``_fg_gat_windowed``."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 negative_slope: float = 0.2, add_self_loop: bool = True,
                 concat_heads: bool = True, device=None, dtype=None):
        super().__init__()
        self.out_dim, self.num_heads = out_dim, num_heads
        self.negative_slope, self.add_self_loop = negative_slope, add_self_loop
        self.concat_heads = concat_heads
        self.proj = nn.Linear(in_dim, num_heads * out_dim, bias=False, device=device, dtype=dtype)
        self.attn_src = nn.Parameter(torch.empty(num_heads, out_dim, device=device, dtype=dtype))
        self.attn_dst = nn.Parameter(torch.empty(num_heads, out_dim, device=device, dtype=dtype))
        nn.init.xavier_uniform_(self.attn_src)  # flax glorot_uniform on [H, D]
        nn.init.xavier_uniform_(self.attn_dst)

    def forward(self, x: torch.Tensor, g: Adj) -> torch.Tensor:
        H, D = self.num_heads, self.out_dim
        feat = self.proj(x)
        featv = feat.view(-1, H, D)
        if isinstance(g, HopSubgraph):
            B = g.num_targets
            e_dst = torch.einsum("bhd,hd->bh", featv[:B], self.attn_dst)
            nbr, mask = g.nbr_idx, g.mask
            if self.add_self_loop:
                self_idx = torch.arange(B, dtype=nbr.dtype, device=nbr.device)[:, None]
                nbr = torch.cat([self_idx, nbr], dim=1)
                mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
            nfeat = S.padded_gather_neighbors(feat, nbr).view(B, -1, H, D)  # [B, K', H, D]
            e_src = torch.einsum("bkhd,hd->bkh", nfeat, self.attn_src)
            logits = F.leaky_relu(e_src + e_dst[:, None, :], self.negative_slope)
            alpha = S.padded_softmax(logits, mask[..., None].expand_as(logits), dim=1)
            out = (alpha[..., None] * nfeat).sum(dim=1)  # [B, H, D]
        else:
            e_src_n = torch.einsum("nhd,hd->nh", featv, self.attn_src)
            e_dst_n = torch.einsum("nhd,hd->nh", featv, self.attn_dst)
            out = _fg_gat_windowed(g, featv, e_src_n, e_dst_n,
                                   negative_slope=self.negative_slope,
                                   add_self_loop=self.add_self_loop)
        if self.concat_heads:
            return out.reshape(out.shape[0], H * D)
        return out.mean(dim=1)


class RGCNConv(nn.Module):
    """Relational GCN conv (``conv.py:397-442``): the mean of each
    relation's neighbours through that relation's weight, summed over the
    relations, plus a self transform: ``out = Σ_r mean_{s ∈ N_r(d)} x[s] @
    W_r + x[d] @ W_self + bias``. Parameters: ``w_rel`` [R, Din, Dout], a
    bias-free ``self`` linear layer, ``bias``.

    ``edge_type`` gives each slot's (on a :class:`HopSubgraph`, [B, K]) or
    each edge's (on a :class:`FullGraph`, [E]) relation; the full graph's
    own ``edge_type`` serves when it is None. On a hop the neighbour rows
    come through ``padded_gather_neighbors`` (kernel A), then a one-hot of
    the types times the mask, per-relation counts ``max(Σ, 1)`` and two
    einsums. On a full graph the per-relation segment mean runs in plain
    PyTorch (``index_add_`` into ``N·R`` segments), holding an [E, Dout]
    intermediate: it fits the card only at small sizes."""

    def __init__(self, in_dim: int, out_dim: int, num_relations: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        check_input(num_relations > 0, "RGCNConv needs num_relations > 0")
        self.num_relations = num_relations
        self.w_rel = nn.Parameter(torch.empty(num_relations, in_dim, out_dim, device=device,
                                              dtype=dtype))
        limit = math.sqrt(6.0 / (num_relations * (in_dim + out_dim)))  # flax glorot_uniform
        nn.init.uniform_(self.w_rel, -limit, limit)
        self.self = nn.Linear(in_dim, out_dim, bias=False, device=device, dtype=dtype)
        self.bias = (nn.Parameter(torch.zeros(out_dim, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, g: Adj,
                edge_type: Optional[torch.Tensor] = None) -> torch.Tensor:
        R = self.num_relations
        rel = torch.arange(R, device=x.device)
        if isinstance(g, HopSubgraph):
            check_input(edge_type is not None, "RGCNConv on a HopSubgraph needs edge_type")
            nfeat = S.padded_gather_neighbors(x, g.nbr_idx)  # [B, K, Din]
            # one-hot by comparison: a type outside [0, R) gives a zero row, as jax.nn.one_hot
            onehot = (edge_type[..., None] == rel).to(x.dtype) * g.mask[..., None]
            cnt = onehot.sum(dim=1).clamp(min=1.0)  # [B, R]
            agg = torch.einsum("bkr,bkd->brd", onehot, nfeat) / cnt[..., None]
            out = torch.einsum("brd,rde->be", agg, self.w_rel) + self.self(x[: g.num_targets])
        else:
            et = edge_type if edge_type is not None else g.edge_type
            check_input(et is not None, "RGCNConv on a FullGraph needs edge_type")
            out = (rgcn_relation_mean(x, self.w_rel, g.edge_src, g.edge_dst, et, g.num_nodes)
                   + self.self(x))
        return out if self.bias is None else out + self.bias
