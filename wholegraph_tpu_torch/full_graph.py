"""Full-graph message passing on one device: the full-graph entry points.

The counterparts of the JAX package's full-graph evaluation
(``examples/node_classification.py:308-334``, ``--full_graph_eval``) and of
the gradients ``bench.py``'s full-graph benchmarks take
(``bench_gat_layer(grad=True)``, ``bench.py:580-586``):

* :func:`clustered_csr` is the locality-ordered CSR of
  ``bench_spmm_clustered`` (``bench.py:406-412``), bit for bit;
* :class:`FullGraphConfig` and :func:`build_full_graph` give a graph,
  a feature embedding, a model and labels at those shapes;
* :func:`eval_full_graph` gathers every node's row (kernel A) and runs the
  model over the :class:`~.models.conv.FullGraph` (kernel G);
* :func:`full_graph_value_and_grad` is the loss and its gradients with
  respect to every parameter and the features (G forward, G on the
  transposed CSR, and H for GAT's attention).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .embedding import Embedding
from .graph import GraphStructure
from .models import HomoGNN, accuracy, cross_entropy_loss
from .models.conv import FullGraph
from .utils.device import DeviceLike, resolve_device


def clustered_csr(n: int, deg: int, width: int, seed: int = 0,
                  device: DeviceLike = "cuda") -> GraphStructure:
    """A locality-ordered CSR on ``device``: degrees uniform in ``[max(deg
    // 2, 1), 2 deg)`` and each edge of row d to ``d + offset``, the offset
    uniform in ``[-width // 2, width // 2]``, clipped to ``[0, n)``. The
    numpy draws are ``bench_spmm_clustered``'s, so the graph is the JAX
    bench's, bit for bit."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    counts = rs.randint(max(deg // 2, 1), deg * 2, n)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = (
        np.repeat(np.arange(n), counts)
        + rs.randint(-width // 2, width // 2 + 1, int(row_ptr[-1]))
    ).clip(0, n - 1).astype(np.int32)
    return GraphStructure(torch.from_numpy(row_ptr).to(dev), torch.from_numpy(col).to(dev), n,
                          max_degree=int(counts.max()) if n else 0)


@dataclasses.dataclass(frozen=True)
class FullGraphConfig:
    """Shapes of the full-graph path. The defaults are
    ``bench_spmm_clustered``'s graph (2^20 nodes, degrees in [8, 32),
    neighbours within ±96 rows: 20,441,541 edges) and features of dim 256,
    under a 2-layer SAGE with mean aggregation, hidden 256, 16 classes.
    ``num_heads`` is GAT's."""

    n_nodes: int = 1 << 20
    deg: int = 16
    width: int = 192
    dim: int = 256
    hidden: int = 256
    num_classes: int = 16
    num_layers: int = 2
    model_type: str = "sage"
    aggregator: str = "mean"
    num_heads: int = 4


@dataclasses.dataclass
class FullGraphState:
    config: FullGraphConfig
    graph: GraphStructure
    fg: FullGraph
    embedding: Embedding  # the node features, [n_nodes, dim]
    model: HomoGNN
    labels: torch.Tensor  # [n_nodes] int32


def build_full_graph(config: FullGraphConfig = FullGraphConfig(), device: DeviceLike = "cuda",
                     seed: int = 0) -> FullGraphState:
    """:func:`clustered_csr` at ``config``'s shapes (from ``seed``) and its
    :class:`FullGraph` with the JAX package's tile plan recorded
    (``to_full_graph(windowed=True)``, as the evaluation builds it), a
    scaled-normal feature embedding in device memory, the model and random
    labels, drawn on ``device`` from one generator seeded by ``seed``."""
    dev = resolve_device(device)
    graph = clustered_csr(config.n_nodes, config.deg, config.width, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    embedding = Embedding.create(config.n_nodes, config.dim, device=dev).init(gen)
    model = HomoGNN(config.dim, config.hidden, config.num_classes,
                    num_layers=config.num_layers, aggregator=config.aggregator,
                    model_type=config.model_type, num_heads=config.num_heads, device=dev)
    model.reset_parameters(gen)
    labels = torch.randint(0, config.num_classes, (config.n_nodes,), generator=gen, device=dev,
                           dtype=torch.int32)
    return FullGraphState(config, graph, graph.to_full_graph(windowed=True), embedding, model,
                          labels)


@torch.no_grad()
def eval_full_graph(model: HomoGNN, embedding: Embedding, fg: FullGraph,
                    centers: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-graph evaluation: every node's row through
    ``embedding.gather`` (kernel A), the model over ``fg`` without dropout,
    and the loss and accuracy of the logits at ``centers`` against
    ``labels`` (0-dim tensors)."""
    ids = torch.arange(fg.num_nodes, dtype=torch.int32, device=embedding.device)
    logits = model(embedding.gather(ids), graph=fg)[centers.long()]
    return cross_entropy_loss(logits, labels), accuracy(logits, labels)


def full_graph_value_and_grad(
        model: HomoGNN, x: torch.Tensor, fg: FullGraph, centers: torch.Tensor,
        labels: torch.Tensor) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """The cross-entropy at ``centers`` of the model over ``fg`` from the
    features ``x`` [num_nodes, dim], and its gradients with respect to
    every parameter and to ``x``: ``(loss, ({name: grad}, dx))``, as
    ``jax.value_and_grad(loss, argnums=(0, 1))`` returns them. Leaves the
    parameters' ``.grad`` alone."""
    params = dict(model.named_parameters())
    x = x.detach().requires_grad_()
    loss = cross_entropy_loss(model(x, graph=fg)[centers.long()], labels)
    grads = torch.autograd.grad(loss, [*params.values(), x])
    return loss.detach(), (dict(zip(params, grads[:-1])), grads[-1])
