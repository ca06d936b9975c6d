"""The sampled training steps on one device: the port's main path.

:func:`train_step` is ``bench.py``'s ``bench_train_step`` body
(``bench.py:660-679``) and ``examples/node_classification.py``'s
``_train_body``: ``multilayer_sample`` (kernel C per hop, or kernel K per
hop with ``sample_method="weighted"``; ``append_unique``), the embedding
gather of the unique ids (kernel A; through the hot cache's
``gather_with_cache`` when the state has one), the 2-layer forward and
backward (SAGE and GCN: kernel D per layer; GAT and RGCN: kernel A for the
neighbour rows; dropout only with a generator), dense Adam, and the sparse
apply on the touched rows (kernel A reads, kernel B writes), after which
the cache's touched lines are invalidated. ``SageTrainConfig.model_type``
is the example's ``--model``; the port's node-classification example runs
this step.

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

At world W (``build_synthetic(..., mesh=)``, one process a rank) every rank
holds the whole graph and its shard of the embedding, in device memory or
in the host tier; :func:`train_step` samples the rank's own centres (kernel
C; a centre draws the same neighbours at any world, since ``ops/rng.py``
keys by centre id, and so over a graph whose CSR is sharded), gathers
their features through the exchange (with a hot cache, its hits from the
replica and its misses in waves), runs the forward and backward, averages
the dense gradients over the ranks (one ``all_reduce``, in the
``dense_adam`` stage) and applies the row gradients of the ranks' mean
loss, ``1/W`` of its own, through ``exchange_grads_exact``: the step of
JAX's loss over the global batch (``__graft_entry__.py:77-92``).
:func:`build_hetero` with a ``mesh`` shards each type's table, and
:func:`hetero_train_step` runs at world W the same way.

:func:`train_epoch` is JAX's scanned epoch: at world 1 on a card one CUDA
graph of the step, replayed once a batch; at world W each rank runs the
step once a batch on its share of the stacked batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .embedding import (Embedding, HostEmbedding, HotCache, LazyAdam, create_optimizer,
                        gather_with_cache, hot_ids_by_degree, invalidate_touched_)
from .graph import GraphStructure, HeteroFeatureStore, synthetic_hetero_dataset
from .models import HeteroGNN, HomoGNN, cross_entropy_loss
from .ops.sampling import SeedLike
from .ops.spmm_kernels import csr_edge_dst
from .parallel.mesh import Mesh
from .utils import perf
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
    ``"true"``), ``num_relations`` RGCN's. ``train_embedding`` False keeps
    the table fixed (the example's default); ``embedding_lr`` is the sparse
    apply's rate, ``lr`` when None (the example's is a tenth of it);
    ``embedding_optimizer`` the table's sparse optimizer by name
    (``create_optimizer``), in device memory or in the host tier.
    ``capacity_factor`` is the example's ``--capacity-factor``: the
    exchange's bucket headroom in the gather and the apply at world W."""

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
    train_embedding: bool = True
    embedding_lr: Optional[float] = None
    embedding_optimizer: str = "lazy_adam"
    capacity_factor: float = 2.0


@dataclasses.dataclass
class SageTrainState:
    """What a training step reads and updates in place. ``cache``, when
    set, is a hot cache over a device-memory ``embedding``: the step gathers
    through it and replaces it by one whose trained lines are invalid (under
    :func:`train_epoch`, clears those lines in place). ``epoch_graph`` is
    :func:`train_epoch`'s captured step, kept for the next epoch."""

    config: SageTrainConfig
    graph: GraphStructure
    embedding: Union[Embedding, HostEmbedding]
    model: HomoGNN
    dense_opt: torch.optim.Optimizer
    labels: torch.Tensor  # [n_nodes] int32 class of every node
    cache: Optional[HotCache] = None
    epoch_graph: Optional["EpochGraph"] = None


def build_synthetic(config: SageTrainConfig = SageTrainConfig(), device: DeviceLike = "cuda",
                    seed: int = 0, host_cache_ratio: Optional[float] = None,
                    mesh: Optional[Mesh] = None) -> SageTrainState:
    """The synthetic graph, embedding and model of ``bench_train_step``:
    degrees from ``numpy.random.RandomState(seed + 1)`` (as the bench draws
    them), uniform random neighbours, a scaled-normal table, random labels
    and weights, all drawn on ``device`` from one generator seeded by
    ``seed``.

    ``host_cache_ratio`` None keeps the embedding in device memory. A ratio
    puts it and its optimizer's state in the host tier (:class:`HostEmbedding`,
    ``cache_ratio`` of it)
    with the ``hot_ids_by_degree(row_ptr, ratio)`` rows cached; the draws,
    and so the table, graph, labels and weights, are the same either way.

    With ``sample_method="weighted"`` the graph also gets edge weights
    ``U[0, 1) + 0.1`` (``bench_sampling``'s, ``bench.py:345-348``), drawn
    from the same generator after everything else, and its pair table
    (``with_weighted_fastpath``), built once here.

    An RGCN run gets the example's pseudo-relations ``(src + col) %
    num_relations`` (``examples/node_classification.py:107-115``), drawn
    from nothing; the model's weights come from the generator as any
    model's do.

    With a ``mesh`` of W ranks (every rank calls it, with the same seed)
    each rank draws everything alike and keeps the graph whole and its
    shard of the embedding: the logical table is the world-1 one. In the
    host tier each rank pins its shard and caches the hot rows it owns."""
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
        embedding = Embedding.create(n, config.dim,
                                     optimizer=create_optimizer(config.embedding_optimizer),
                                     dtype=config.dtype, device=dev, mesh=mesh).init(gen)
    else:
        embedding = HostEmbedding.create(
            n, config.dim, optimizer=create_optimizer(config.embedding_optimizer),
            dtype=config.dtype,
            cache_ratio=host_cache_ratio, device=dev, mesh=mesh,
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


# the spans of a step inside its ``step`` span, in order (``utils.perf.span``): ``sample``
# (``multilayer_sample``), ``gather`` (:func:`gather_features`), ``forward_backward``,
# ``dense_adam`` and ``sparse_apply`` (the embedding's ``apply_gradients``)
STAGES = ("sample", "gather", "forward_backward", "dense_adam", "sparse_apply")


def _world(state: SageTrainState) -> int:
    return getattr(state.embedding, "world", 1)


def average_dense_grads(model: torch.nn.Module, loss: torch.Tensor, mesh: Mesh, *,
                        mean: bool = True) -> torch.Tensor:
    """Every parameter's gradient, and the loss, averaged over the ranks in
    one ``all_reduce`` of a flat buffer (summed with ``mean=False``, where
    each rank's gradient is its part of one loss's); returns the mean (or
    summed) loss. A parameter
    without a gradient on some rank counts as zero there, and one without a
    gradient on every rank keeps none, so the optimizer skips it as at world
    1. Each parameter's count of ranks with a gradient rides in the buffer;
    a rank reads it on the host only when it lacks a gradient itself."""
    from .parallel.collectives import all_reduce

    params = list(model.parameters())
    missing = [p.grad is None for p in params]
    has = torch.tensor([0.0 if m else 1.0 for m in missing], device=loss.device)
    flat = torch.cat([(torch.zeros_like(p) if m else p.grad).reshape(-1)
                      for p, m in zip(params, missing)]
                     + [has, loss.detach().reshape(1).float()])
    all_reduce(flat, mesh)
    counts = flat[-1 - len(params):-1].tolist() if any(missing) else [1.0] * len(params)
    if mean:
        flat.div_(mesh.size)
    off = 0
    for p, m, c in zip(params, missing, counts):
        g = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
        if not m:
            p.grad.copy_(g)
        elif c > 0:
            p.grad = g.clone()
    return flat[-1]


def gather_features(state: SageTrainState, ids: torch.Tensor, **kw) -> torch.Tensor:
    """The embedding's rows at ``ids``, through ``state.cache`` when there is
    one (``kw`` goes to the embedding's own gather; of it the cached gather
    takes ``capacity_factor``, its exchange's bucket headroom). Its span is
    ``gather``."""
    with perf.span("gather"):
        if state.cache is None:
            return state.embedding.gather(ids, **kw)
        check_input(isinstance(state.embedding, Embedding),
                    "a hot cache serves a device-memory Embedding")
        cf = {k: v for k, v in kw.items() if k == "capacity_factor"}
        return gather_with_cache(state.embedding.as_sharded_table(), state.cache, ids, **cf)


def train_step(state: SageTrainState, centers: torch.Tensor, labels: torch.Tensor,
               seed: SeedLike, generator: Optional[torch.Generator] = None, *,
               corrections: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step on ``centers`` [B] with their ``labels`` [B]; ``seed`` keys
    the sampler, ``generator`` (when given) draws the dropout masks. Updates
    the model, its Adam state, the embedding (with ``train_embedding``) and
    the cache in place and returns the loss (a 0-dim tensor; reading it
    waits for the device). The step is the span ``step``, and its stages
    the spans of :data:`STAGES` inside it (``utils.perf``: a
    ``perf.Timeline`` entered around the call times each on the card).

    At world W each rank passes its own centres and labels; the loss
    returned is the ranks' mean, the same on every rank.

    ``seed`` may be a 0-dim integer tensor on the device (the sampler reads
    it there). ``corrections`` is :func:`train_epoch`'s route: this step's
    row of the sparse optimizer's ``step_table`` on the device; with it the
    apply reads its step there and leaves ``Embedding.step`` to the caller,
    so that a CUDA graph of the step replays every step. The cache's
    touched lines are cleared in its own ``valid`` (``invalidate_touched_``),
    which such a graph reads."""
    with perf.span("step"):
        return _step_body(state, centers, labels, seed, generator, corrections)


def _step_body(state: SageTrainState, centers: torch.Tensor, labels: torch.Tensor,
               seed: SeedLike, generator: Optional[torch.Generator],
               corrections: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`train_step` inside its ``step`` span."""
    cfg = state.config
    world = _world(state)
    ml = state.graph.multilayer_sample(centers, cfg.fanouts, seed=seed,
                                       weighted=cfg.sample_method == "weighted",
                                       with_degrees=cfg.degree_mode == "true")
    ids = ml.unique_gids
    # the sampler's ids are unique, in ascending runs: the host tier reads
    # its misses as they come, with no sort
    host = isinstance(state.embedding, HostEmbedding)
    kw = {"capacity_factor": cfg.capacity_factor, **({"_sort": False} if host else {})}
    rows = gather_features(state, ids, **kw) * ml.unique_mask[:, None]
    if cfg.train_embedding:
        rows.requires_grad_()
    with perf.span("forward_backward"):
        logits = state.model(rows, ml, train=generator is not None, generator=generator)
        loss = cross_entropy_loss(logits, labels)
        state.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
    with perf.span("dense_adam"):
        if world > 1:  # the mean over the ranks' batches: JAX's loss over the global batch
            loss = average_dense_grads(state.model, loss, state.embedding.mesh)
        state.dense_opt.step()
    if cfg.train_embedding:
        lr = cfg.lr if cfg.embedding_lr is None else cfg.embedding_lr
        grads = rows.grad if world == 1 else rows.grad / world
        kw = {} if host else {"assume_unique": True}  # the host apply always dedups
        if corrections is not None:
            kw["corrections"] = corrections
        state.embedding.apply_gradients(ids, grads, lr, mask=ml.unique_mask,
                                        capacity_factor=cfg.capacity_factor, **kw)
        if state.cache is not None:  # trained lines are stale until the next refresh
            invalidate_touched_(state.cache, torch.where(ml.unique_mask, ids, -1))
    return loss.detach()


# ---------------------------------------------------------------------------
# the scanned epoch: one CUDA graph of the step, replayed once a batch
# ---------------------------------------------------------------------------

WARMUP_STEPS = 2  # the epoch's first steps, run eagerly on a side stream before the capture
SCAN_ITEM = "ROADMAP Queue 4 item 15"  # the epoch over the host tier, and its graph beyond world 1


@dataclasses.dataclass
class EpochGraph:
    """:func:`train_epoch`'s captured step and the buffers it reads: the
    step reads row ``step`` of the inputs, writes that row of ``losses`` and
    then adds one to ``step``, all on the card. ``reads`` are the addresses
    and objects it was captured over (:func:`_reads`)."""

    graph: Optional["torch.cuda.CUDAGraph"]
    centers: torch.Tensor  # [S, B] int32
    labels: torch.Tensor  # [S, B]
    seeds: torch.Tensor  # [S] int64
    corrections: torch.Tensor  # [S, k] float32: the sparse optimizer's step_table
    step: torch.Tensor  # [1] int64: the row the step reads next
    losses: torch.Tensor  # [S] float32
    reads: tuple = ()


def _reads(state: SageTrainState, generator: Optional[torch.Generator]) -> tuple:
    """What a captured step is bound to: the objects it was captured with,
    the dense optimizer's rates, the address of every tensor of the state
    it reads or writes and the active ``perf.Timeline`` (a graph captured
    inside one writes its stamps into it). A graph is replayed only while
    they stay the same; a replaced table, cache, parameter or optimizer
    state, or another Timeline or none, means a new capture."""
    emb, opt, g = state.embedding, state.dense_opt, state.graph
    tensors = [emb.table, *emb.slots.values(), *state.model.parameters(),
               *(t for st in opt.state.values() for t in st.values()
                 if isinstance(t, torch.Tensor)),
               *(t for t in (g.row_ptr, g.col, g.edge_weight, g.cw_blocks, g.edge_type)
                 if isinstance(t, torch.Tensor))]
    if state.cache is not None:
        tensors += [state.cache.hot_ids, state.cache.values, state.cache.valid]
    return (state.config, id(emb), id(opt), id(state.model), id(state.cache), id(generator),
            tuple(float(gr["lr"]) for gr in opt.param_groups),
            tuple(t.data_ptr() for t in tensors), perf.active_timeline())


def check_scannable(state: SageTrainState, graphed: bool = True) -> None:
    """Raise unless :func:`train_epoch` can run ``state``: the table in
    device memory and, for a CUDA graph (``graphed``), a dense optimizer
    built with ``capturable=True``."""
    check_input(isinstance(state.embedding, Embedding),
                "train_epoch runs over a table in device memory; the host tier (HostEmbedding), "
                f"which the JAX scan never runs, is {SCAN_ITEM}")
    if graphed:
        check_input(all(gr.get("capturable", False) for gr in state.dense_opt.param_groups),
                    "a CUDA graph replays the dense optimizer only when it is capturable: build it "
                    "as torch.optim.Adam(..., capturable=True)")


def _epoch_step(state: SageTrainState, rec: EpochGraph,
                generator: Optional[torch.Generator]) -> None:
    """One step of the epoch, as the graph captures it: row ``rec.step`` of
    the inputs, read on the device, its loss into ``rec.losses``; all of it
    the span ``step``."""
    with perf.span("step"):
        i = rec.step
        loss = _step_body(state, rec.centers.index_select(0, i)[0],
                          rec.labels.index_select(0, i)[0], rec.seeds.index_select(0, i)[0],
                          generator, rec.corrections.index_select(0, i)[0])
        rec.losses.index_copy_(0, i, loss.reshape(1).to(rec.losses.dtype))
        i.add_(1)


def train_epoch(state: SageTrainState, centers_s: torch.Tensor, labels_s: torch.Tensor,
                seeds, *, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """S training steps on the stacked centres ``centers_s`` [S, B] and
    labels ``labels_s`` [S, B], step s sampled with ``seeds[s]`` (JAX's
    ``train_epoch_scan``, ``examples/node_classification.py:258-275``, with
    ``seeds = global_step + arange(S)``); returns the ``[S]`` losses on the
    device. Table, optimizer states and cache carry from step to step, and
    ``Embedding.step`` advances by S. ``generator`` draws the dropout masks.

    Where the state lives chooses the route; no route stands in for
    another when something fails:

    - On a card at world 1 the host reads nothing until it returns: the
      epoch's first :data:`WARMUP_STEPS` steps run eagerly on a side
      stream, one step is captured in a CUDA graph (the dropout generator
      registered with it) that reads its row of the inputs, seed and
      LazyAdam corrections at a step counter on the card, and the graph is
      replayed for every step left. The graph is kept on
      ``state.epoch_graph`` and replayed for all S steps of a later epoch of
      the same S and B, unless a tensor it reads has been replaced
      (:func:`_reads`), when it is captured again. A failed capture raises.
      The dense optimizer must be capturable (:func:`check_scannable`).
    - At world > 1 (each rank passes its share of every step, ``[S, B/W]``),
      on a card or on the CPU, the same step runs S times on the same
      buffers, each reading its row, seed and corrections on the device;
      nothing is captured and ``state.epoch_graph`` stays None. The exact
      exchange reads its undelivered count on the host every round, the
      dense-gradient average reads counts on the host and gloo synchronises
      the card, so a graph of the step would need a fixed number of rounds
      (:data:`SCAN_ITEM`). The losses are the ranks' mean, the same on every
      rank, as :func:`train_step` returns them.
    - On the CPU at world 1 the same step runs S times, eagerly."""
    dev = state.embedding.device
    graphed = dev.type == "cuda" and _world(state) == 1
    check_scannable(state, graphed=graphed)
    check_input(centers_s.dim() == 2 and labels_s.shape == centers_s.shape,
                f"centers_s and labels_s must be [S, B] alike, got {tuple(centers_s.shape)} and "
                f"{tuple(labels_s.shape)}")
    S, B = centers_s.shape
    seeds = torch.as_tensor(seeds, dtype=torch.int64).to(dev)
    check_input(tuple(seeds.shape) == (S,), f"seeds must be [{S}], got {tuple(seeds.shape)}")
    emb = state.embedding
    corr = emb.optimizer.step_table(range(emb.step + 1, emb.step + S + 1), dev)
    rec = state.epoch_graph
    if rec is not None and (rec.centers.shape != centers_s.shape
                            or rec.reads != _reads(state, generator)):
        state.epoch_graph = rec = None  # the buffers it read were replaced: capture again
    if rec is not None:
        for buf, new in ((rec.centers, centers_s), (rec.labels, labels_s), (rec.seeds, seeds),
                         (rec.corrections, corr)):
            buf.copy_(new)
        rec.step.zero_()
        for _ in range(S):
            rec.graph.replay()
    else:
        rec = EpochGraph(None, centers_s.to(dev, torch.int32).clone(), labels_s.to(dev).clone(),
                         seeds.clone(), corr, torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.zeros(S, dtype=torch.float32, device=dev))
        if graphed:
            _capture_epoch(state, rec, generator, S)
        else:
            for _ in range(S):
                _epoch_step(state, rec, generator)
    emb.step += S
    return rec.losses.clone()  # the next epoch's replays write rec.losses


def _capture_epoch(state: SageTrainState, rec: EpochGraph, generator: Optional[torch.Generator],
                   S: int) -> None:
    """The first epoch on a card: warm-up steps on a side stream, the
    capture, the replays; the graph goes on ``state.epoch_graph``."""
    warm = min(WARMUP_STEPS, S)
    side = torch.cuda.Stream(rec.step.device)
    side.wait_stream(torch.cuda.current_stream(rec.step.device))
    with torch.cuda.stream(side):
        for _ in range(warm):
            _epoch_step(state, rec, generator)
    torch.cuda.current_stream(rec.step.device).wait_stream(side)
    if warm == S:
        return
    g = torch.cuda.CUDAGraph()
    if generator is not None:
        g.register_generator_state(generator)
    with torch.cuda.graph(g):
        _epoch_step(state, rec, generator)
    rec.graph, rec.reads = g, _reads(state, generator)
    state.epoch_graph = rec
    for _ in range(S - warm):
        g.replay()


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
                 seed: int = 0, mesh: Optional[Mesh] = None) -> HeteroTrainState:
    """``synthetic_hetero_dataset`` at the config's counts (numpy, seeded by
    ``seed``), its features in a :class:`HeteroFeatureStore` under LazyAdam,
    and a :class:`HeteroGNN` whose weights come from a generator seeded by
    ``seed``. With a ``mesh`` of W ranks (every rank calls it alike) each
    rank holds the whole graph and its shard of every type's table."""
    dev = resolve_device(device)
    ds = synthetic_hetero_dataset(config.n_paper, config.n_author, config.n_inst,
                                  num_classes=config.num_classes, seed=seed, device=dev)
    space, graph = ds["space"], ds["graph"]
    store = HeteroFeatureStore.create(space, optimizer=LazyAdam(), device=dev, mesh=mesh)
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
                      seed: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One hetero step on paper ids ``centers`` [B] with their ``labels``;
    ``seed`` keys the sampler, ``generator`` (when given) draws the dropout
    masks. Updates the model, its Adam state and, with
    ``train_embedding``, each type's table in place; returns the loss.
    Its spans are :func:`train_step`'s (``sparse_apply`` once a type). At
    world W (a store built with a mesh) each rank passes its own centres
    and the step is that of the ranks' mean loss, as in :func:`train_step`."""
    with perf.span("step"):
        cfg = state.config
        emb0 = next(iter(state.store.embeddings.values()))
        world = emb0.world
        ml = state.graph.multilayer_sample(centers, cfg.fanouts, seed=seed)
        with perf.span("gather"):
            rows, masks = state.store.gather_typed(ml.unique_gids)
        rows: Dict[str, torch.Tensor] = {n: r.requires_grad_() for n, r in rows.items()}
        with perf.span("forward_backward"):
            logits = state.model(rows, masks, sample=ml, train=generator is not None,
                                 generator=generator)
            loss = cross_entropy_loss(logits, labels)
            state.dense_opt.zero_grad(set_to_none=True)
            loss.backward()
        with perf.span("dense_adam"):
            if world > 1:  # the mean over the ranks' batches
                loss = average_dense_grads(state.model, loss, emb0.mesh)
            state.dense_opt.step()
        if cfg.train_embedding:  # the sampler's ids are unique
            state.store.apply_gradients(ml.unique_gids,
                                        {n: r.grad / world for n, r in rows.items()},
                                        cfg.lr * 0.1, mask=ml.unique_mask, assume_unique=True)
        return loss.detach()
