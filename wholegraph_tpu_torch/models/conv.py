"""Graph convolutions on sampled blocks and on full graphs.

Port of ``wholegraph_tpu/models/conv.py``: :class:`FullGraph`, the
full-graph aggregation ``_fg_spmm`` and the fused GAT message passing
``_fg_gat_windowed``, and the convs :class:`SAGEConv` (sampled and
full-graph), :class:`GCNConv` and :class:`GATConv` (full-graph). On a full
graph, sum and mean aggregations run kernel G (:class:`~wholegraph_tpu_torch.
ops.spmm_kernels.CsrSpmm`, whose backward is G on the transposed CSR and,
for GAT's attention weights, kernel H). The sampled branches of GCN and GAT,
GCN's ``degree_mode`` and RGCN are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.structure import HopSubgraph
from ..ops import spmm as S
from ..ops.spmm_kernels import CsrSpmm, transpose_csr
from ..utils.error import NotSupported, check_input


@dataclasses.dataclass
class FullGraph:
    """COO edges sorted by destination over one node set of ``num_nodes``
    rows, with their CSR ``row_ptr`` [num_nodes + 1] int32: messages flow
    ``edge_src`` → ``edge_dst``, and ``edge_src`` is the CSR's ``col``.

    Built directly from a COO (``row_ptr=None``) the graph derives
    ``row_ptr`` from ``edge_dst``, which must then be sorted;
    ``GraphStructure.to_full_graph`` passes its own CSR. ``window`` and
    ``edge_cap`` record the JAX package's tile plan where
    ``to_full_graph(windowed=True)`` found one feasible; kernel G needs no
    plan, so they change no route. :meth:`transposed` builds the transposed
    CSR of the backward once, on first use."""

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    num_nodes: int
    row_ptr: Optional[torch.Tensor] = None
    window: Optional[int] = None
    edge_cap: Optional[int] = None
    _transposed: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        E, n = self.edge_src.shape[0], int(self.num_nodes)
        check_input(self.edge_src.dim() == 1 and self.edge_dst.shape == (E,),
                    "edge_src and edge_dst must be [E]")
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
    whatever plan the graph records; max stays the plain COO ``spmm``."""
    if reduce in ("sum", "mean"):
        return CsrSpmm.apply(g.row_ptr, g.edge_src, x, edge_weight, reduce, True, g.transposed)
    return S.spmm(g.edge_src, g.edge_dst, x, g.num_nodes, reduce, edge_weight=edge_weight)


def _fg_gat_windowed(g: FullGraph, featv: torch.Tensor, e_src_n: torch.Tensor,
                     e_dst_n: torch.Tensor, *, negative_slope: float,
                     add_self_loop: bool) -> torch.Tensor:
    """Full-graph GAT message passing (``conv.py:100-186``): the ``[E, H]``
    logits from the ``[N, H]`` attention terms, the edge softmax over each
    destination's edges in plain PyTorch (a self loop joins each node's
    softmax analytically, so the CSR stays intact), then kernel G once per
    head weighted by ``alpha[:, h]`` over the strided head view
    ``featv[:, h, :]``, plus ``alpha_self · featv``. The attention gradient
    is kernel H (:class:`CsrSpmm`'s dw)."""
    N, H, D = featv.shape
    src, dst = g.edge_src, g.edge_dst
    logits = F.leaky_relu(e_src_n[src] + e_dst_n[dst], negative_slope)  # [E, H]
    if add_self_loop:
        l_self = F.leaky_relu(e_src_n + e_dst_n, negative_slope)  # [N, H]
        mx = torch.maximum(S.segment_max(logits.detach(), dst, N), l_self.detach())
        z = torch.exp(logits - mx[dst])
        z_self = torch.exp(l_self - mx)
        den = S.segment_sum(z, dst, N) + z_self
        alpha = z / den[dst].clamp(min=1e-16)
        alpha_self = z_self / den.clamp(min=1e-16)
    else:
        alpha = S.edge_softmax(dst, logits, N)
        alpha_self = None
    out = torch.stack([
        CsrSpmm.apply(g.row_ptr, src, featv[:, h, :], alpha[:, h], "sum", True, g.transposed)
        for h in range(H)], dim=1)  # [N, H, D]
    if alpha_self is not None:
        out = out + alpha_self[..., None].to(featv.dtype) * featv
    return out


def _not_ported(conv: str) -> None:
    raise NotSupported(f"{conv} on a sampled HopSubgraph is not ported yet "
                       "(only the full-graph branch)")


class SAGEConv(nn.Module):
    """GraphSAGE conv: ``concat[x_self, agg(x_neigh)] @ W + b``
    (CuGraphSAGEConv analog, sage_conv.py:73-95: agg_concat_n2n + linear).

    On a :class:`HopSubgraph`, ``x`` holds the next level's unique nodes and
    the block's targets are its first ``g.num_targets`` rows; on a
    :class:`FullGraph`, ``x`` holds every node. The concat order matches the
    JAX package's so that a bridged flax ``proj`` kernel loads 1:1."""

    def __init__(self, in_dim: int, out_dim: int, aggregator: str = "mean",
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.aggregator = aggregator
        self.proj = nn.Linear(2 * in_dim, out_dim, bias=bias, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, g: Adj) -> torch.Tensor:
        if isinstance(g, HopSubgraph):
            xs = x[: g.num_targets]
            xn = S.padded_reduce(x, g.nbr_idx, g.mask, self.aggregator)
        else:
            xs, xn = x, _fg_spmm(g, x, self.aggregator)
        return self.proj(torch.cat([xs, xn], dim=-1))


class GCNConv(nn.Module):
    """GCN conv with the symmetric ``D^-1/2 A D^-1/2`` normalisation and an
    implicit self loop, on a :class:`FullGraph`: ``h = x @ W``, ``out =
    (Σ_{e into d} h[s] / sqrt(deg_s) + h[d] / sqrt(deg_d)) / sqrt(deg_d)``
    with ``deg = in-degree + 1``, plus ``bias``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(in_dim, out_dim, bias=False, device=device, dtype=dtype)
        self.bias = (nn.Parameter(torch.zeros(out_dim, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, g: Adj) -> torch.Tensor:
        if isinstance(g, HopSubgraph):
            _not_ported("GCNConv")
        h = self.proj(x)
        inv = torch.rsqrt(g.in_degree.to(h.dtype) + 1.0)[:, None]
        out = (_fg_spmm(g, h * inv, "sum") + h * inv) * inv
        return out if self.bias is None else out + self.bias


class GATConv(nn.Module):
    """Multi-head GAT conv (CuGraphGATConv analog, gat_conv.py:22-102) on a
    :class:`FullGraph`: ``out_dim`` per head, ``num_heads`` heads,
    concatenated (``concat_heads``) or averaged. Parameters: ``proj``
    (no bias), ``attn_src`` and ``attn_dst`` [H, out_dim]."""

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
        if isinstance(g, HopSubgraph):
            _not_ported("GATConv")
        H, D = self.num_heads, self.out_dim
        featv = self.proj(x).view(-1, H, D)
        e_src_n = torch.einsum("nhd,hd->nh", featv, self.attn_src)
        e_dst_n = torch.einsum("nhd,hd->nh", featv, self.attn_dst)
        out = _fg_gat_windowed(g, featv, e_src_n, e_dst_n, negative_slope=self.negative_slope,
                               add_self_loop=self.add_self_loop)
        if self.concat_heads:
            return out.reshape(out.shape[0], H * D)
        return out.mean(dim=1)
