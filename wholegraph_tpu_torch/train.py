"""The sampled GraphSAGE training step on one device: the port's main path.

:func:`train_step` is ``bench.py``'s ``bench_train_step`` body
(``bench.py:660-679``) and ``examples/node_classification.py``'s
``_train_body`` without cache or dropout: uniform ``multilayer_sample``
(kernel C per hop, ``append_unique``), the embedding gather of the unique
ids (kernel A), the 2-layer SAGE forward (kernel D per layer) and backward,
dense Adam, and the sparse LazyAdam apply on the touched rows (kernel A
reads, kernel B writes).

With ``build_synthetic(..., host_cache_ratio=r)`` the embedding is a
:class:`~.embedding.HostEmbedding`: the table and LazyAdam's m and v live
in pinned host memory behind a cache of the top-degree rows on the card,
and the gather and the apply reach the host rows with kernels E and F.
:func:`train_step` runs unchanged on either embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .embedding import Embedding, HostEmbedding, LazyAdam, hot_ids_by_degree
from .graph import GraphStructure
from .models import HomoGNN, cross_entropy_loss
from .utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SageTrainConfig:
    """Shapes of the training step. The defaults are ``bench_train_step``'s:
    2M nodes with degrees uniform in ``[deg//2, deg + deg//2]`` (8..24),
    dim 256, a 2-layer SAGE of width 256 over 16 classes, batch 1024,
    fanouts (10, 15), an f32 table trained by LazyAdam, dense Adam; ``lr``
    is both optimizers' rate."""

    n_nodes: int = 2_000_000
    deg: int = 16
    dim: int = 256
    hidden: int = 256
    num_classes: int = 16
    batch: int = 1024
    fanouts: Tuple[int, ...] = (10, 15)
    dtype: str = "float32"
    lr: float = 1e-3


@dataclasses.dataclass
class SageTrainState:
    """What a training step reads and updates in place."""

    config: SageTrainConfig
    graph: GraphStructure
    embedding: Union[Embedding, HostEmbedding]
    model: HomoGNN
    dense_opt: torch.optim.Optimizer
    labels: torch.Tensor  # [n_nodes] int32 class of every node


def build_synthetic(config: SageTrainConfig = SageTrainConfig(), device: DeviceLike = "cuda",
                    seed: int = 0, host_cache_ratio: Optional[float] = None) -> SageTrainState:
    """The synthetic graph, embedding and model of ``bench_train_step``:
    degrees from ``numpy.random.RandomState(seed + 1)`` (as the bench draws
    them), uniform random neighbours, a scaled-normal table, random labels
    and weights, all drawn on ``device`` from one generator seeded by
    ``seed``.

    ``host_cache_ratio`` None keeps the embedding in device memory. A ratio
    puts it in the host tier (:class:`HostEmbedding`, ``cache_ratio`` of it)
    with the ``hot_ids_by_degree(row_ptr, ratio)`` rows cached; the draws,
    and so the table, graph, labels and weights, are the same either way."""
    dev = resolve_device(device)
    n, deg = config.n_nodes, config.deg
    degs = np.random.RandomState(seed + 1).randint(deg // 2, deg + deg // 2 + 1, n)
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    col = torch.randint(0, n, (int(row_ptr[-1]),), generator=gen, device=dev, dtype=torch.int32)
    graph = GraphStructure(torch.from_numpy(row_ptr).to(dev), col, n,
                           max_degree=int(degs.max()))
    if host_cache_ratio is None:
        embedding = Embedding.create(n, config.dim, optimizer=LazyAdam(), dtype=config.dtype,
                                     device=dev).init(gen)
    else:
        embedding = HostEmbedding.create(
            n, config.dim, optimizer=LazyAdam(), dtype=config.dtype,
            cache_ratio=host_cache_ratio, device=dev,
        ).init(gen, hot_ids=hot_ids_by_degree(row_ptr, host_cache_ratio))
    model = HomoGNN(config.dim, config.hidden, config.num_classes,
                    num_layers=len(config.fanouts), device=dev)
    model.reset_parameters(gen)
    labels = torch.randint(0, config.num_classes, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    return SageTrainState(config, graph, embedding, model,
                          torch.optim.Adam(model.parameters(), lr=config.lr), labels)


STAGES = ("sample", "gather", "forward_backward", "dense_adam", "sparse_apply")


def train_step(state: SageTrainState, centers: torch.Tensor, labels: torch.Tensor,
               seed: int, mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """One step on ``centers`` [B] with their ``labels`` [B]; ``seed`` keys
    the sampler. Updates the model, its Adam state and the embedding in
    place and returns the loss (a 0-dim tensor; reading it waits for the
    device). ``mark``, when given, is called with each name of
    :data:`STAGES` as that stage has been enqueued (a timer records a CUDA
    event there)."""
    mark = mark or (lambda stage: None)
    cfg = state.config
    ml = state.graph.multilayer_sample(centers, cfg.fanouts, seed=seed)
    mark("sample")
    ids = ml.unique_gids
    rows = (state.embedding.gather(ids) * ml.unique_mask[:, None]).requires_grad_()
    mark("gather")
    loss = cross_entropy_loss(state.model(rows, ml), labels)
    state.dense_opt.zero_grad(set_to_none=True)
    loss.backward()
    mark("forward_backward")
    state.dense_opt.step()
    mark("dense_adam")
    if isinstance(state.embedding, HostEmbedding):  # the host apply always dedups
        state.embedding.apply_gradients(ids, rows.grad, cfg.lr, mask=ml.unique_mask)
    else:
        state.embedding.apply_gradients(ids, rows.grad, cfg.lr, mask=ml.unique_mask,
                                        assume_unique=True)
    mark("sparse_apply")
    return loss.detach()
