"""End-to-end GNN for node classification, on sampled blocks or a full graph.

Port of ``resolve_framework``, ``make_conv``, ``HomoGNN``,
``TypedProjection``, ``HeteroGNN``, ``cross_entropy_loss`` and ``accuracy``
(``wholegraph_tpu/models/gnn.py:28-212``). SAGE, GCN, GAT and RGCN run on
sampled blocks and on a :class:`~.conv.FullGraph`; the hetero model puts a
per-type projection in front of the homogeneous stack.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.structure import MultilayerSample
from ..utils import perf
from ..utils.device import DeviceLike, resolve_device
from ..utils.error import check_input
from ..utils.logger import warn
from .conv import FullGraph, GATConv, GCNConv, RGCNConv, SAGEConv

MODEL_TYPES = ("sage", "graphsage", "gcn", "gat", "rgcn")
_NATIVE_FRAMEWORKS = ("wg", "native", "tpu")


def resolve_framework(name: str) -> str:
    """The reference's framework strings (dgl|pyg|wg|cugraph,
    gnn_model.py:25-43, the examples' ``--framework``) all resolve to the
    port's own convs; a name that is not native is logged."""
    if name not in _NATIVE_FRAMEWORKS:
        warn("framework %r is not available here; using native convs", name)
    return "native"


def make_conv(model_type: str, in_dim: int, out_dim: int, *, num_heads: int = 1,
              num_relations: int = 0, aggregator: str = "mean", degree_mode: str = "auto",
              device=None) -> nn.Module:
    """The conv of ``model_type`` from ``in_dim`` to ``out_dim`` features; a
    GAT conv has ``num_heads`` heads of ``out_dim // num_heads``,
    concatenated, an RGCN conv ``num_relations`` relations, a GCN conv the
    ``degree_mode`` of its sampled branch (``gnn.py:38-56``)."""
    mt = model_type.lower()
    if mt in ("sage", "graphsage"):
        return SAGEConv(in_dim, out_dim, aggregator=aggregator, device=device)
    if mt == "gcn":
        return GCNConv(in_dim, out_dim, degree_mode=degree_mode, device=device)
    if mt == "gat":
        heads = max(num_heads, 1)
        return GATConv(in_dim, out_dim // heads, num_heads=heads, device=device)
    if mt == "rgcn":
        return RGCNConv(in_dim, out_dim, num_relations, device=device)
    raise ValueError(f"unknown model type {model_type!r}")


def _dense_init(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``Dense``'s lecun_normal without its truncation: std
    1/sqrt(fan_in); the bias, if any, 0."""
    w = layer.weight
    w.copy_(torch.randn(w.shape, generator=generator, device=generator.device)
            / math.sqrt(w.shape[1]))
    if layer.bias is not None:
        layer.bias.zero_()


def _glorot_uniform(p: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(p.shape, generator=generator, device=generator.device)
    p.copy_((2.0 * u - 1.0) * limit)


class HomoGNN(nn.Module):
    """Multi-layer homogeneous GNN (HomoGNNModel analog,
    gnn_model.py:191-261) of SAGE, GCN, GAT or RGCN convs, with relu and
    dropout between layers; the last layer of a GAT has one head.

    Sampled mode: ``forward(x, sample)`` with ``x`` = features of the
    deepest unique node set and ``sample`` = the :class:`MultilayerSample`;
    hops run deepest first. Full-graph mode: ``forward(x, graph=fg)`` with
    ``x`` = every node's features; the stack runs over the one
    :class:`FullGraph`. An RGCN takes each layer's edge types from
    ``edge_types`` (one per hop, in hop order) or else from the hop or the
    full graph (``gnn.py:108-114``).

    Dropout follows the JAX package's explicit ``train`` flag, not
    ``nn.Module.training``, and draws from the ``generator`` it is given.
    Each layer of the forward is the span ``conv.<model_type>``
    (``conv.sage``, ``conv.gat``; ``utils.perf.span``)."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, num_classes: int = 40,
                 num_layers: int = 2, dropout: float = 0.5, aggregator: str = "mean",
                 model_type: str = "sage", num_heads: int = 4, num_relations: int = 0,
                 degree_mode: str = "auto", device: DeviceLike = "cuda"):
        super().__init__()
        mt = model_type.lower()
        check_input(mt in MODEL_TYPES, f"model_type {model_type!r} is one of {MODEL_TYPES}")
        if mt == "gat":
            check_input(hidden_dim % max(num_heads, 1) == 0,
                        f"hidden_dim {hidden_dim} must divide num_heads {num_heads}")
        dev = resolve_device(device)
        self.model_type = mt
        self._span = "conv." + mt  # each layer's span (utils.perf.span)
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            make_conv(mt, dims[i], dims[i + 1], aggregator=aggregator, device=dev,
                      num_heads=num_heads if i < num_layers - 1 else 1,
                      num_relations=num_relations, degree_mode=degree_mode)
            for i in range(num_layers)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Every parameter drawn from ``generator``, conv by conv: the dense
        kernel (``proj``, or RGCN's ``self``) ~ normal with std
        1/sqrt(fan_in) (flax ``Dense``'s lecun_normal without its
        truncation); RGCN's ``w_rel`` [R, Din, Dout] and GAT's ``attn_src``
        and ``attn_dst`` [H, D] ~ flax's glorot_uniform (fans R·Din and
        R·Dout; H and D); biases 0. A CPU generator gives the same weights
        on any device."""
        for conv in self.convs:
            dense = conv.self if isinstance(conv, RGCNConv) else conv.proj
            _dense_init(dense, generator)
            if isinstance(conv, RGCNConv):
                R, din, dout = conv.w_rel.shape
                _glorot_uniform(conv.w_rel, R * din, R * dout, generator)
            for name in ("attn_src", "attn_dst"):
                p = getattr(conv, name, None)
                if p is not None:
                    _glorot_uniform(p, p.shape[0], p.shape[1], generator)
            if isinstance(conv, (GCNConv, RGCNConv)) and conv.bias is not None:
                conv.bias.zero_()

    def forward(self, x: torch.Tensor, sample: Optional[MultilayerSample] = None,
                graph: Optional[FullGraph] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                edge_types: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
        L = self.num_layers
        if sample is not None:
            check_input(len(sample.hops) == L, "fanouts must match num_layers")
            adjs = list(reversed(sample.hops))  # deepest hop first
        else:
            check_input(graph is not None, "need sample= or graph=")
            adjs = [graph] * L
        for i, adj in enumerate(adjs):
            with perf.span(self._span):
                if self.model_type == "rgcn":
                    et = edge_types[L - 1 - i] if edge_types is not None else None
                    x = self.convs[i](x, adj, et if et is not None else adj.edge_type)
                else:
                    x = self.convs[i](x, adj)
                if i < L - 1:
                    x = F.relu(x)
                    if train and self.dropout > 0:
                        check_input(generator is not None, "train=True needs a dropout generator")
                        keep = (torch.rand(x.shape, generator=generator, device=x.device)
                                >= self.dropout)
                        x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return x


class TypedProjection(nn.Module):
    """Per-type feature rows of different widths projected to one width
    (``gnn.py:144-162``): ``out = Σ_t mask_t · (rows_t @ W_t + b_t)``, one
    ``nn.Linear`` a type named ``proj_{name}``, summed over the types in
    sorted name order. The companion of
    :meth:`~wholegraph_tpu_torch.graph.HeteroFeatureStore.gather_typed`."""

    def __init__(self, in_dims: Mapping[str, int], out_dim: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.names = tuple(sorted(in_dims))
        for name in self.names:
            setattr(self, f"proj_{name}", nn.Linear(in_dims[name], out_dim, bias=bias,
                                                    device=device, dtype=dtype))

    def forward(self, rows_by_type: Mapping[str, torch.Tensor],
                masks_by_type: Mapping[str, torch.Tensor]) -> torch.Tensor:
        out = None
        for name in sorted(rows_by_type):
            h = getattr(self, f"proj_{name}")(rows_by_type[name])
            h = torch.where(masks_by_type[name][:, None], h, 0.0)
            out = h if out is None else out + h
        return out

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each type's kernel ~ normal with std 1/sqrt(its width), biases 0,
        in sorted name order."""
        for name in self.names:
            _dense_init(getattr(self, f"proj_{name}"), generator)


class HeteroGNN(nn.Module):
    """Typed-node and typed-edge GNN (``gnn.py:165-212``):
    :class:`TypedProjection` of each type's rows to ``hidden_dim``
    (``typed_proj``), relu, then a :class:`HomoGNN` (``gnn``; RGCN by
    default, whose relations come from the sampled hops or the full
    graph)."""

    def __init__(self, in_dims: Mapping[str, int], hidden_dim: int = 256,
                 num_classes: int = 40, num_layers: int = 2, num_relations: int = 0,
                 model_type: str = "rgcn", num_heads: int = 4, dropout: float = 0.5,
                 aggregator: str = "mean", device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.typed_proj = TypedProjection(in_dims, hidden_dim, device=dev)
        self.gnn = HomoGNN(hidden_dim, hidden_dim, num_classes, num_layers=num_layers,
                           dropout=dropout, aggregator=aggregator, model_type=model_type,
                           num_heads=num_heads, num_relations=num_relations, device=dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.typed_proj.reset_parameters(generator)
        self.gnn.reset_parameters(generator)

    def forward(self, rows_by_type: Dict[str, torch.Tensor], masks_by_type: Dict[str, torch.Tensor],
                sample: Optional[MultilayerSample] = None, graph: Optional[FullGraph] = None,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.typed_proj(rows_by_type, masks_by_type))
        return self.gnn(x, sample=sample, graph=graph, train=train, generator=generator)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked softmax cross-entropy (examples/node_classfication.py loss)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is None:
        return -ll.mean()
    m = mask.to(logits.dtype)
    return -(ll * m).sum() / m.sum().clamp(min=1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    if mask is None:
        return correct.mean()
    m = mask.to(torch.float32)
    return (correct * m).sum() / m.sum().clamp(min=1)
