"""End-to-end GNN for node classification on sampled blocks.

Port of ``HomoGNN`` with ``model_type="sage"``, ``cross_entropy_loss`` and
``accuracy`` (``wholegraph_tpu/models/gnn.py:59-141``).
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
from .conv import SAGEConv


class HomoGNN(nn.Module):
    """Multi-layer homogeneous SAGE GNN (HomoGNNModel analog,
    gnn_model.py:191-261). Call with ``x`` = features of the deepest unique
    node set and ``sample`` = the :class:`MultilayerSample`; hops run
    deepest first, with relu and dropout between layers.

    Dropout follows the JAX package's explicit ``train`` flag, not
    ``nn.Module.training``, and draws from the ``generator`` it is given."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, num_classes: int = 40,
                 num_layers: int = 2, dropout: float = 0.5, aggregator: str = "mean",
                 model_type: str = "sage", device: DeviceLike = "cuda"):
        super().__init__()
        check_input(model_type.lower() in ("sage", "graphsage"),
                    f"model_type {model_type!r} is not ported yet (only 'sage')")
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], aggregator=aggregator, device=dev)
            for i in range(num_layers)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights ~ normal with std 1/sqrt(fan_in) (flax ``Dense``'s
        lecun_normal without its truncation), biases 0, drawn from
        ``generator``; a CPU generator gives the same weights on any device."""
        for conv in self.convs:
            w = conv.proj.weight
            vals = torch.randn(w.shape, generator=generator, device=generator.device)
            w.copy_(vals / math.sqrt(w.shape[1]))
            if conv.proj.bias is not None:
                conv.proj.bias.zero_()

    def forward(self, x: torch.Tensor, sample: MultilayerSample, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        check_input(len(sample.hops) == self.num_layers, "fanouts must match num_layers")
        for i, hop in enumerate(reversed(sample.hops)):  # deepest hop first
            x = self.convs[i](x, hop)
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
