"""Graph convolutions on sampled blocks.

Port of ``SAGEConv``'s sampled branch (``wholegraph_tpu/models/conv.py:
189-240``). The full-graph branch and the other convs (GCN, GAT, RGCN) are
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..graph.structure import HopSubgraph
from ..ops import spmm as S


class SAGEConv(nn.Module):
    """GraphSAGE conv: ``concat[x_self, agg(x_neigh)] @ W + b``
    (CuGraphSAGEConv analog, sage_conv.py:73-95: agg_concat_n2n + linear).

    ``x`` holds the next level's unique nodes; the block's targets are its
    first ``g.num_targets`` rows. The concat order matches the JAX package's
    so that a bridged flax ``proj`` kernel loads 1:1."""

    def __init__(self, in_dim: int, out_dim: int, aggregator: str = "mean",
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.aggregator = aggregator
        self.proj = nn.Linear(2 * in_dim, out_dim, bias=bias, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, g: HopSubgraph) -> torch.Tensor:
        xs = x[: g.num_targets]
        xn = S.padded_reduce(x, g.nbr_idx, g.mask, self.aggregator)
        return self.proj(torch.cat([xs, xn], dim=-1))
