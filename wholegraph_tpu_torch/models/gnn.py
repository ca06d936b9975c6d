"""End-to-end GNN for node classification, on sampled blocks or a full graph.

Port of ``make_conv``, ``HomoGNN``, ``cross_entropy_loss`` and ``accuracy``
(``wholegraph_tpu/models/gnn.py:38-141``). SAGE, GCN and GAT run on a
:class:`~.conv.FullGraph`; on sampled blocks only SAGE is ported (the
sampled GCN and GAT branches and RGCN are not yet).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.structure import MultilayerSample
from ..utils.device import DeviceLike, resolve_device
from ..utils.error import check_input
from .conv import FullGraph, GATConv, GCNConv, SAGEConv

MODEL_TYPES = ("sage", "graphsage", "gcn", "gat")


def make_conv(model_type: str, in_dim: int, out_dim: int, *, num_heads: int = 1,
              aggregator: str = "mean", device=None) -> nn.Module:
    """The conv of ``model_type`` from ``in_dim`` to ``out_dim`` features; a
    GAT conv has ``num_heads`` heads of ``out_dim // num_heads``,
    concatenated (``gnn.py:38-56``)."""
    mt = model_type.lower()
    if mt in ("sage", "graphsage"):
        return SAGEConv(in_dim, out_dim, aggregator=aggregator, device=device)
    if mt == "gcn":
        return GCNConv(in_dim, out_dim, device=device)
    if mt == "gat":
        heads = max(num_heads, 1)
        return GATConv(in_dim, out_dim // heads, num_heads=heads, device=device)
    raise ValueError(f"unknown model type {model_type!r}")


class HomoGNN(nn.Module):
    """Multi-layer homogeneous GNN (HomoGNNModel analog,
    gnn_model.py:191-261) of SAGE, GCN or GAT convs, with relu and dropout
    between layers; the last layer of a GAT has one head.

    Sampled mode: ``forward(x, sample)`` with ``x`` = features of the
    deepest unique node set and ``sample`` = the :class:`MultilayerSample`;
    hops run deepest first (SAGE only). Full-graph mode: ``forward(x,
    graph=fg)`` with ``x`` = every node's features; the stack runs over the
    one :class:`FullGraph`.

    Dropout follows the JAX package's explicit ``train`` flag, not
    ``nn.Module.training``, and draws from the ``generator`` it is given."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, num_classes: int = 40,
                 num_layers: int = 2, dropout: float = 0.5, aggregator: str = "mean",
                 model_type: str = "sage", num_heads: int = 4, device: DeviceLike = "cuda"):
        super().__init__()
        mt = model_type.lower()
        check_input(mt in MODEL_TYPES, f"model_type {model_type!r} is not ported yet "
                                       f"(one of {MODEL_TYPES})")
        if mt == "gat":
            check_input(hidden_dim % max(num_heads, 1) == 0,
                        f"hidden_dim {hidden_dim} must divide num_heads {num_heads}")
        dev = resolve_device(device)
        self.model_type = mt
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            make_conv(mt, dims[i], dims[i + 1], aggregator=aggregator, device=dev,
                      num_heads=num_heads if i < num_layers - 1 else 1)
            for i in range(num_layers)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Every parameter drawn from ``generator``, conv by conv: dense
        kernels ~ normal with std 1/sqrt(fan_in) (flax ``Dense``'s
        lecun_normal without its truncation), GAT's ``attn_src`` and
        ``attn_dst`` [H, D] ~ uniform within ±sqrt(6 / (H + D)) (flax's
        glorot_uniform), biases 0. A CPU generator gives the same weights on
        any device."""
        for conv in self.convs:
            w = conv.proj.weight
            vals = torch.randn(w.shape, generator=generator, device=generator.device)
            w.copy_(vals / math.sqrt(w.shape[1]))
            for name in ("attn_src", "attn_dst"):
                p = getattr(conv, name, None)
                if p is not None:
                    limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                    u = torch.rand(p.shape, generator=generator, device=generator.device)
                    p.copy_((2.0 * u - 1.0) * limit)
            bias = conv.bias if isinstance(conv, GCNConv) else conv.proj.bias
            if bias is not None:
                bias.zero_()

    def forward(self, x: torch.Tensor, sample: Optional[MultilayerSample] = None,
                graph: Optional[FullGraph] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if sample is not None:
            check_input(len(sample.hops) == self.num_layers, "fanouts must match num_layers")
            adjs = list(reversed(sample.hops))  # deepest hop first
        else:
            check_input(graph is not None, "need sample= or graph=")
            adjs = [graph] * self.num_layers
        for i, adj in enumerate(adjs):
            x = self.convs[i](x, adj)
            if i < self.num_layers - 1:
                x = F.relu(x)
                if train and self.dropout > 0:
                    check_input(generator is not None, "train=True needs a dropout generator")
                    keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
                    x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return x


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
