"""The sampled training steps on one device: the port's main path.

:func:`train_step` is ``bench.py``'s ``bench_train_step`` body
(``bench.py:660-679``) and ``examples/node_classification.py``'s
``_train_body`` without cache or dropout: ``multilayer_sample`` (kernel C
per hop, or kernel K per hop with ``sample_method="weighted"``;
``append_unique``), the embedding gather of the unique
ids (kernel A), the 2-layer forward and backward (SAGE and GCN: kernel D
per layer; GAT and RGCN: kernel A for the neighbour rows), dense Adam, and
the sparse LazyAdam apply on the touched rows (kernel A reads, kernel B
writes). ``SageTrainConfig.model_type`` is the example's ``--model``.

:func:`hetero_train_step` is ``examples/hetero_node_classification.py``'s
loop body (``:119-140``) without dropout unless asked: the sample over the
typed-edge graph, the typed gather (kernel A a type), the
:class:`~.models.HeteroGNN` (TypedProjection, then RGCN), dense Adam, and
each type's LazyAdam apply at a tenth of the dense rate.

With ``build_synthetic(..., host_cache_ratio=r)`` the embedding is a
:class:`~.embedding.HostEmbedding`: the table and LazyAdam's m and v live
in pinned host memory behind a cache of the top-degree rows on the card,
and the gather and the apply reach the host rows with kernels E and F.
:func:`train_step` runs unchanged on either embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .embedding import Embedding, HostEmbedding, LazyAdam, hot_ids_by_degree
from .graph import GraphStructure, HeteroFeatureStore, synthetic_hetero_dataset
from .models import HeteroGNN, HomoGNN, cross_entropy_loss
from .ops.spmm_kernels import csr_edge_dst
from .utils.device import DeviceLike, resolve_device
from .utils.error import check_input


@dataclasses.dataclass(frozen=True)
class SageTrainConfig:
    """Shapes of the training step. The defaults are ``bench_train_step``'s:
    2M nodes with degrees uniform in ``[deg//2, deg + deg//2]`` (8..24),
    dim 256, a 2-layer SAGE of width 256 over 16 classes, batch 1024,
    fanouts (10, 15), an f32 table trained by LazyAdam, dense Adam; ``lr``
    is both optimizers' rate. ``sample_method`` is the example's
    ``--sample-method``: ``"unweighted"`` or ``"weighted"`` (A-Res over
    edge weights, ``config.py:66``). ``model_type`` is its ``--model``
    (``"sage"``, ``"gcn"``, ``"gat"`` or ``"rgcn"``, ``config.py:50``),
    ``num_heads`` its ``--heads`` (GAT; the last layer has one),
    ``degree_mode`` the sampled GCN's (``"auto"``, ``"block"`` or
    ``"true"``), ``num_relations`` RGCN's."""

    n_nodes: int = 2_000_000
    deg: int = 16
    dim: int = 256
    hidden: int = 256
    num_classes: int = 16
    batch: int = 1024
    fanouts: Tuple[int, ...] = (10, 15)
    dtype: str = "float32"
    lr: float = 1e-3
    sample_method: str = "unweighted"
    model_type: str = "sage"
    num_heads: int = 4
    degree_mode: str = "auto"
    num_relations: int = 2


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
    and so the table, graph, labels and weights, are the same either way.

    With ``sample_method="weighted"`` the graph also gets edge weights
    ``U[0, 1) + 0.1`` (``bench_sampling``'s, ``bench.py:345-348``), drawn
    from the same generator after everything else, and its pair table
    (``with_weighted_fastpath``), built once here.

    An RGCN run gets the example's pseudo-relations ``(src + col) %
    num_relations`` (``examples/node_classification.py:107-115``), drawn
    from nothing; the model's weights come from the generator as any
    model's do."""
    check_input(config.sample_method in ("unweighted", "weighted"),
                f"sample_method {config.sample_method!r} is 'unweighted' or 'weighted'")
    dev = resolve_device(device)
    n, deg = config.n_nodes, config.deg
    degs = np.random.RandomState(seed + 1).randint(deg // 2, deg + deg // 2 + 1, n)
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    col = torch.randint(0, n, (int(row_ptr[-1]),), generator=gen, device=dev, dtype=torch.int32)
    rp = torch.from_numpy(row_ptr).to(dev)
    edge_type = None
    if config.model_type == "rgcn":
        src = csr_edge_dst(rp, col.shape[0])  # each edge's row
        edge_type = ((src + col) % config.num_relations).to(torch.int32)
    graph = GraphStructure(rp, col, n, max_degree=int(degs.max()), edge_type=edge_type,
                           num_relations=config.num_relations if edge_type is not None else 0)
    if host_cache_ratio is None:
        embedding = Embedding.create(n, config.dim, optimizer=LazyAdam(), dtype=config.dtype,
                                     device=dev).init(gen)
    else:
        embedding = HostEmbedding.create(
            n, config.dim, optimizer=LazyAdam(), dtype=config.dtype,
            cache_ratio=host_cache_ratio, device=dev,
        ).init(gen, hot_ids=hot_ids_by_degree(row_ptr, host_cache_ratio))
    model = HomoGNN(config.dim, config.hidden, config.num_classes,
                    num_layers=len(config.fanouts), model_type=config.model_type,
                    num_heads=config.num_heads, num_relations=config.num_relations,
                    degree_mode=config.degree_mode, device=dev)
    model.reset_parameters(gen)
    labels = torch.randint(0, config.num_classes, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    if config.sample_method == "weighted":
        weight = torch.rand(col.shape, generator=gen, device=dev) + 0.1
        graph = GraphStructure(graph.row_ptr, graph.col, n, max_degree=graph.max_degree,
                               edge_weight=weight, edge_type=graph.edge_type,
                               num_relations=graph.num_relations).with_weighted_fastpath()
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
    ml = state.graph.multilayer_sample(centers, cfg.fanouts, seed=seed,
                                       weighted=cfg.sample_method == "weighted",
                                       with_degrees=cfg.degree_mode == "true")
    mark("sample")
    ids = ml.unique_gids
    # the sampler's ids are unique, in ascending runs: the host tier reads
    # its misses as they come, with no sort
    kw = {"_sort": False} if isinstance(state.embedding, HostEmbedding) else {}
    rows = (state.embedding.gather(ids, **kw) * ml.unique_mask[:, None]).requires_grad_()
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


# ---------------------------------------------------------------------------
# the typed-node (hetero) step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeteroTrainConfig:
    """Shapes of the hetero step. The defaults are
    ``examples/hetero_node_classification.py``'s widths (feature dims 48,
    32 and 16, hidden 256, 40 classes, batch 1024, fanouts (30, 30), RGCN
    over the six typed relations, dropout 0.5, lr 0.003, LazyAdam on the
    store at a tenth of it) with its counts times 250: 1,000,000 papers,
    375,000 authors and 50,000 institutions, about 20M edges.
    ``train_embedding`` is its ``--train-embedding``."""

    n_paper: int = 1_000_000
    n_author: int = 375_000
    n_inst: int = 50_000
    num_classes: int = 40
    hidden: int = 256
    batch: int = 1024
    fanouts: Tuple[int, ...] = (30, 30)
    dropout: float = 0.5
    lr: float = 3e-3
    train_embedding: bool = True


@dataclasses.dataclass
class HeteroTrainState:
    """What a hetero step reads and updates in place."""

    config: HeteroTrainConfig
    graph: GraphStructure
    store: HeteroFeatureStore
    model: HeteroGNN
    dense_opt: torch.optim.Optimizer
    labels: torch.Tensor  # [n_paper] int32; papers are global ids 0..n_paper-1
    train_ids: torch.Tensor  # paper ids of the training split, int32


def build_hetero(config: HeteroTrainConfig = HeteroTrainConfig(), device: DeviceLike = "cuda",
                 seed: int = 0) -> HeteroTrainState:
    """``synthetic_hetero_dataset`` at the config's counts (numpy, seeded by
    ``seed``), its features in a :class:`HeteroFeatureStore` under LazyAdam,
    and a :class:`HeteroGNN` whose weights come from a generator seeded by
    ``seed``."""
    dev = resolve_device(device)
    ds = synthetic_hetero_dataset(config.n_paper, config.n_author, config.n_inst,
                                  num_classes=config.num_classes, seed=seed, device=dev)
    space, graph = ds["space"], ds["graph"]
    store = HeteroFeatureStore.create(space, optimizer=LazyAdam(), device=dev)
    store.from_arrays(ds["features"])
    model = HeteroGNN(dict(zip(space.names, space.dims)), config.hidden, config.num_classes,
                      num_layers=len(config.fanouts), num_relations=graph.num_relations,
                      dropout=config.dropout, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return HeteroTrainState(
        config, graph, store, model, torch.optim.Adam(model.parameters(), lr=config.lr),
        torch.from_numpy(ds["labels"].astype(np.int32)).to(dev),
        torch.from_numpy(ds["train"].astype(np.int32)).to(dev))


def hetero_train_step(state: HeteroTrainState, centers: torch.Tensor, labels: torch.Tensor,
                      seed: int, mark: Optional[Callable[[str], None]] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One hetero step on paper ids ``centers`` [B] with their ``labels``;
    ``seed`` keys the sampler, ``generator`` (when given) draws the dropout
    masks. Updates the model, its Adam state and, with
    ``train_embedding``, each type's table in place; returns the loss.
    ``mark`` as in :func:`train_step`."""
    mark = mark or (lambda stage: None)
    cfg = state.config
    ml = state.graph.multilayer_sample(centers, cfg.fanouts, seed=seed)
    mark("sample")
    rows, masks = state.store.gather_typed(ml.unique_gids)
    rows: Dict[str, torch.Tensor] = {n: r.requires_grad_() for n, r in rows.items()}
    mark("gather")
    logits = state.model(rows, masks, sample=ml, train=generator is not None, generator=generator)
    loss = cross_entropy_loss(logits, labels)
    state.dense_opt.zero_grad(set_to_none=True)
    loss.backward()
    mark("forward_backward")
    state.dense_opt.step()
    mark("dense_adam")
    if cfg.train_embedding:  # the sampler's ids are unique
        state.store.apply_gradients(ml.unique_gids, {n: r.grad for n, r in rows.items()},
                                    cfg.lr * 0.1, mask=ml.unique_mask, assume_unique=True)
    mark("sparse_apply")
    return loss.detach()
