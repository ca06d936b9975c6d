"""End-to-end node-classification training, on one card or over ranks.

The port of ``examples/node_classification.py`` (the reference's flagship
example, python/pylibwholegraph/examples/node_classfication.py:72-242):
sampled mini-batch training of SAGE, GCN, GAT or RGCN over a feature table
that may be trained by a sparse optimizer and served through a hot cache,
with the contract lines ``[EPOCH_TIME]``, ``[TRAIN_TIME]`` and ``[TEST] loss
... accuracy ...%``. Run::

  python -m wholegraph_tpu_torch.examples.node_classification --smoke --epochs 2
  python -m wholegraph_tpu_torch.examples.node_classification --smoke --device cpu
  python -m wholegraph_tpu_torch.launch --nproc 4 --device cpu \
      -m wholegraph_tpu_torch.examples.node_classification -- --smoke

What it runs: the dataset (synthetic, or a converted one under
``--root-dir/--graph-name`` with its features read by ``from_filelist``),
``multilayer_sample`` (kernel C a hop, or K with ``--sample-method
weighted``), the feature gather (kernel A; with ``--cache-type`` the hot
cache's ``gather_with_cache``), the model (kernel D for SAGE and GCN), dense
Adam, and with ``--train-embedding`` the sparse apply (A and B) at a tenth
of ``--lr``, the touched hot lines invalidated after each apply and the
cache refilled after each epoch. ``--full-graph-eval`` evaluates over the
whole graph (every row gathered onto each rank, then kernel G);
``--halo-eval`` over the halo-partitioned graph
(:func:`~wholegraph_tpu_torch.graph.eval_full_graph_partitioned`: one
gather of the halo rows a layer, kernel G over each rank's local CSR,
printing the ``[HALO]`` wire line) and ``--sharded-eval`` per edge
(:func:`~wholegraph_tpu_torch.models.sharded_eval.eval_full_graph_sharded`),
both with the features, activations and logits row-sharded and each
batch's logits gathered from the logits table; ``--save-dir`` checkpoints
the feature table every ``--ckpt-every`` epochs through
:class:`~wholegraph_tpu_torch.io.AsyncCheckpointer`.

Where it differs from the JAX example: the JAX graph has no edge weights,
so there ``--sample-method weighted`` exits; here a synthetic graph gets
weights ``U[0, 1) + 0.1`` from ``--seed`` (``bench_sampling``'s,
``bench.py:345-348``) and a converted one without weights exits as in JAX.
Weights and dropout masks come from ``torch.Generator``s. The step is the
port's :func:`~wholegraph_tpu_torch.train.train_step`.

Under the launcher (:mod:`wholegraph_tpu_torch.launch`) each rank is a
process (JAX ``examples/node_classification.py:82-91, 159, 193-200``): the
graph on every rank, the feature table sharded over the ranks
(``--embedding-memory-type distributed``, or ``hierarchy`` over a
``("node", "device")`` mesh; a converted dataset's files read with
``--round-robin-size`` blocks, each rank its own rows), each global batch
split among the ranks, and the ``gather_overflow`` probe printed when a
probe batch overflows the per-round buckets (``--capacity-factor``, the
headroom of every exchange: the step's gather and apply and the
evaluation's gather).
With ``--cache-type`` every rank holds the whole hot replica, and the
misses go to their owners in waves (``gather_with_cache``). Rank 0 prints.
The ranks' backend is ``nccl`` on cards (a card a rank) and ``gloo`` on the
CPU, or on cards shared by several ranks with the launcher's ``--backend
gloo``.

``--scan-epoch`` runs each epoch as JAX's ``lax.scan`` does
(``examples/node_classification.py:376-391``): the epoch's batches are
stacked ``[S, B]``, each rank keeps its columns of every step
(:func:`rank_share`, JAX's ``P(None, AXIS)``), and :func:`~wholegraph_tpu_torch.
train.train_epoch` runs them with seeds ``global_step + arange(S)``. On one
card its first steps warm up, one step is captured in a CUDA graph and the
graph is replayed once a batch, with no host round trip between steps
(dense Adam is built ``capturable`` there); under the launcher each rank
runs the step once a batch, eagerly, so an epoch's losses are those of the
run without the flag. The cache is refilled in place after the epoch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import make_parser, parse_fanouts
from ..embedding import (Embedding, build_hot_cache, create_optimizer, hot_ids_by_degree,
                         refresh_hot_cache_)
from ..graph import (GraphStructure, batch_iterator, eval_full_graph_partitioned, halo_stats,
                     load_converted_dataset, partition_graph, synthetic_dataset)
from ..io import AsyncCheckpointer
from ..models import HomoGNN, accuracy, cross_entropy_loss, resolve_framework
from ..models.sharded_eval import eval_full_graph_sharded
from ..ops.gather import gather_overflow
from ..parallel import init
from ..parallel.collectives import all_reduce
from ..train import SageTrainConfig, SageTrainState, gather_features, train_epoch, train_step


def make_args(argv=None):
    ap = make_parser("node classification (wholegraph_tpu_torch)")
    ap.add_argument("--full-graph-eval", action="store_true",
                    help="evaluate with exact full-graph message passing")
    ap.add_argument("--sharded-eval", action="store_true",
                    help="full-graph eval with row-sharded activations, per-edge exchange")
    ap.add_argument("--halo-eval", action="store_true",
                    help="full-graph eval over the edge-partitioned halo layout")
    ap.add_argument("--scan-epoch", action="store_true",
                    help="run each epoch as one scan over its stacked batches: on one card "
                         "a CUDA graph of the step, replayed once a batch; under the launcher "
                         "the step once a batch on each rank")
    ap.add_argument("--save-dir", default="",
                    help="checkpoint directory; saves the feature table asynchronously every "
                         "--ckpt-every epochs")
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--synthetic-nodes", type=int, default=10_000,
                    help="node count for --graph-name synthetic")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast preset (small graph, model and batches)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.synthetic_nodes = min(args.synthetic_nodes, 2000)
        args.feat_dim = 32
        args.classnum = 8
        args.hiddensize = 32
        args.batchsize = 256
        args.valid_batchsize = 512
        args.neighbors = ",".join(["5"] * args.layernum)
    return args


def rank_share(a, world: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s share of a global batch: the last axis split into
    ``world`` equal parts, part ``rank`` kept. For a batch ``[B]`` that is
    the block ``rank*B/W .. (rank+1)*B/W - 1``; for stacked batches
    ``[S, B]`` it is those columns of every step (JAX's ``P(None, AXIS)``),
    not whole steps."""
    a = np.asarray(a)
    return a.reshape(*a.shape[:-1], world, -1)[..., rank, :]


def build_graph(ds, args, dev) -> GraphStructure:
    """The dataset's CSR on ``dev``, with the example's RGCN pseudo-relations
    and, for weighted sampling, edge weights and their pair table."""
    edge_type, num_rel = None, 0
    if args.model == "rgcn":
        # a homogeneous dataset: deterministic pseudo-relations, as the JAX example derives them
        num_rel = 2
        src = np.repeat(np.arange(ds.node_count), np.diff(ds.row_ptr))
        edge_type = torch.from_numpy(((src + ds.col) % num_rel).astype(np.int32)).to(dev)
    weight = None
    if args.sample_method == "weighted":
        if ds.name != "synthetic":
            raise SystemExit("--sample-method weighted needs a graph with edge weights")
        rs = np.random.RandomState(args.seed)
        weight = torch.from_numpy((rs.rand(ds.edge_count) + 0.1).astype(np.float32)).to(dev)
    g = GraphStructure(torch.from_numpy(ds.row_ptr.astype(np.int32)).to(dev),
                       torch.from_numpy(ds.col.astype(np.int32)).to(dev), ds.node_count,
                       max_degree=int(np.diff(ds.row_ptr).max()), edge_weight=weight,
                       edge_type=edge_type, num_relations=num_rel)
    return g.with_weighted_fastpath() if weight is not None else g


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _quiet(*args, **kw) -> None:
    pass


def main(argv=None):
    args = make_args(argv)
    use_hier = args.embedding_memory_type == "hierarchy"
    mesh = init(use_hier, device=args.device)
    dev, world, rank = mesh.device, mesh.size, mesh.axis_index()
    # on a hierarchy mesh the table is sharded over both axes; the exact
    # a2a runs over the pair (gather(method="hierarchy") routes in two stages)
    axis = ("node", "device") if use_hier else "data"
    say = print if rank == 0 else _quiet
    fanouts = parse_fanouts(args.neighbors)
    if len(fanouts) != args.layernum:
        raise SystemExit("--neighbors must match --layernum")
    resolve_framework(args.framework)
    if args.batchsize % world:
        raise SystemExit(f"--batchsize {args.batchsize} must divide among {world} ranks")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    say(f"device: {dev} ({name}), world {world}"
        + (f" (hierarchy {mesh.shape['node']} x {mesh.shape['device']})" if use_hier else ""))

    if args.graph_name == "synthetic":
        ds = synthetic_dataset(n=args.synthetic_nodes, feat_dim=args.feat_dim,
                               num_classes=args.classnum)
    else:
        ds = load_converted_dataset(args.root_dir, args.graph_name, args.feat_dim, args.classnum)
    say(f"dataset {ds.name}: {ds.node_count} nodes, {ds.edge_count} edges")
    g = build_graph(ds, args, dev)

    # the feature store: a table under a sparse optimizer (trained with
    # --train-embedding), sharded over the ranks at world > 1
    opt = create_optimizer(args.embed_optimizer)
    wmesh = mesh if world > 1 else None
    if ds.features is not None:
        emb = Embedding.create(ds.node_count, ds.feat_dim, optimizer=opt, device=dev,
                               mesh=wmesh, axis=axis).from_array(ds.features)
    elif ds.feature_files:
        emb = Embedding.from_filelist(ds.feature_files, ds.feat_dim, optimizer=opt,
                                      expected_rows=ds.node_count, device=dev,
                                      round_robin_size=args.round_robin_size, mesh=wmesh,
                                      axis=axis)
    else:
        emb = Embedding.create(ds.node_count, ds.feat_dim, optimizer=opt, device=dev,
                               mesh=wmesh, axis=axis)
        emb.init(torch.Generator().manual_seed(args.seed))

    # the hot cache (--cache-type / --cache-ratio); with --train-embedding each
    # apply invalidates the touched lines and each epoch refills them
    cache = None
    if args.cache_type != "none":
        cache = build_hot_cache(emb.as_sharded_table(),
                                hot_ids_by_degree(ds.row_ptr, args.cache_ratio))
        say(f"hot cache: {cache.size} rows ({args.cache_type})")

    model = HomoGNN(ds.feat_dim, args.hiddensize, ds.num_classes, num_layers=args.layernum,
                    dropout=args.dropout, aggregator=args.aggregator, model_type=args.model,
                    num_heads=args.heads, num_relations=g.num_relations, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    # a CUDA graph replays Adam only when it is capturable (--scan-epoch on one card,
    # the one route of train_epoch that captures)
    dense_opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 capturable=bool(args.scan_epoch) and dev.type == "cuda"
                                 and world == 1)
    dropout_gen = torch.Generator(device=dev).manual_seed(args.seed)

    def put(a):
        """This rank's share of a global batch ([B] or stacked [S, B]), on the device."""
        a = rank_share(np.asarray(a).astype(np.int32), world, rank)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    node_labels = np.full(ds.node_count, -1, np.int32)  # -1: in no split
    for split in (ds.train, ds.valid, ds.test):
        node_labels[split.idx] = split.label
    # the embedding is trained (--train-embedding) at a tenth of --lr
    config = SageTrainConfig(n_nodes=ds.node_count, dim=ds.feat_dim, hidden=args.hiddensize,
                             num_classes=ds.num_classes, batch=args.batchsize,
                             fanouts=tuple(fanouts), lr=args.lr,
                             sample_method=args.sample_method, model_type=args.model,
                             num_heads=args.heads, num_relations=g.num_relations,
                             train_embedding=bool(args.train_embedding),
                             embedding_lr=args.lr * 0.1, capacity_factor=args.capacity_factor)
    state = SageTrainState(config, g, emb, model, dense_opt,
                           torch.from_numpy(node_labels).to(dev), cache=cache)
    weighted = args.sample_method == "weighted"
    gkw = {"capacity_factor": args.capacity_factor}
    if use_hier:
        gkw["method"] = "hierarchy"

    if world > 1:  # the skew probe: ids of a probe batch past the per-round buckets
        c0, _ = next(batch_iterator(ds.train, args.batchsize, seed=args.seed))
        ml0 = g.multilayer_sample(put(c0), fanouts, seed=0, weighted=weighted)
        ov = int(gather_overflow(ml0.unique_gids, plan=emb.plan, mesh=mesh, axis=axis,
                                 capacity_factor=args.capacity_factor)[0])
        say(f"gather_overflow: {ov} ids of the probe batch over the per-round bucket capacity "
            f"(capacity_factor={args.capacity_factor})")
        if ov:
            say("[SKEW] the exact exchange will pay extra rounds; consider raising "
                "--capacity-factor")

    # the full-graph evaluations: halo-partitioned (with the table's plan, so
    # output shards align with table shards), per edge, or replicated
    pg = fg = None
    if args.halo_eval:
        pg = partition_graph(g, mesh, plan=emb.plan, axis=axis, device=dev)
        st = halo_stats(pg)
        say(f"[HALO] rows/layer {st['halo_rows']} vs per-edge {st['per_edge_rows']} "
            f"({st['savings_x']:.1f}x less wire)")
    elif args.full_graph_eval and not args.sharded_eval:
        fg = g.to_full_graph(windowed=True)

    @torch.no_grad()
    def run_eval(split, batchsize, seed):
        batchsize = min(batchsize, max(len(split.idx) // world, 1) * world)
        # every node's logits once, then each batch's: a row-sharded table, or on every rank
        logits_tab = logits_all = None
        if pg is not None:
            logits_tab = eval_full_graph_partitioned(model, pg, emb.as_sharded_table(),
                                                     capacity_factor=args.capacity_factor)
        elif args.sharded_eval:
            logits_tab = eval_full_graph_sharded(model, g, emb.as_sharded_table(),
                                                 capacity_factor=args.capacity_factor)
        elif fg is not None:
            ids = torch.arange(ds.node_count, dtype=torch.int32, device=dev)
            logits_all = model(emb.gather(ids, **gkw), graph=fg)
        losses, accs = [], []
        for centers, labels in batch_iterator(split, batchsize, shuffle=False, seed=seed):
            c, y = put(centers), put(labels)
            if logits_tab is not None:
                logits = logits_tab.gather(c, **gkw)
            elif logits_all is not None:
                logits = logits_all[c.long()]
            else:
                ml = g.multilayer_sample(c, fanouts, seed=0, weighted=weighted)
                rows = gather_features(state, ml.unique_gids, **gkw)
                logits = model(rows * ml.unique_mask[:, None], ml)
            losses.append(cross_entropy_loss(logits, y))
            accs.append(accuracy(logits, y))
        out = torch.stack([torch.stack(losses).mean(), torch.stack(accs).mean()]).float()
        if world > 1:  # the ranks' batches are equal: the mean of their means
            out = all_reduce(out, mesh) / world
        return float(out[0]), float(out[1])

    ckpt = AsyncCheckpointer() if args.save_dir else None
    try:
        sync(dev)
        train_start = time.perf_counter()
        global_step = 0
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            if args.scan_epoch:  # the whole epoch: no host round trip between steps
                batches = list(batch_iterator(ds.train, args.batchsize, seed=args.seed + epoch))
                S = len(batches)
                ep_losses = train_epoch(state, put(np.stack([b[0] for b in batches])),
                                        put(np.stack([b[1] for b in batches])),
                                        torch.arange(global_step, global_step + S),
                                        generator=dropout_gen)
                global_step += S
            else:
                ep_losses = []
                for centers, labels in batch_iterator(ds.train, args.batchsize,
                                                      seed=args.seed + epoch):
                    ep_losses.append(train_step(state, put(centers), put(labels), global_step,
                                                generator=dropout_gen))
                    global_step += 1
                ep_losses = torch.stack(ep_losses)
            if state.cache is not None and config.train_embedding:
                # in place: a captured step (--scan-epoch) reads these lines
                refresh_hot_cache_(emb.as_sharded_table(), state.cache)
            if ckpt is not None and (epoch + 1) % args.ckpt_every == 0:
                ckpt.save_embedding(emb, args.save_dir, "node_emb")
            sync(dev)
            epoch_time = time.perf_counter() - t0
            vloss, vacc = run_eval(ds.valid, args.valid_batchsize, epoch)
            say(f"[EPOCH_TIME] {epoch_time:.3f} s epoch {epoch}: "
                  f"train loss {float(ep_losses.mean()):.4f} "
                  f"valid loss {vloss:.4f} valid acc {vacc * 100:.2f}%", flush=True)
        train_time = time.perf_counter() - train_start
    finally:
        if ckpt is not None:
            ckpt.close()  # drain the pending checkpoint writes
    if ckpt is not None:
        say(f"checkpoints in {args.save_dir}")
    say(f"[TRAIN_TIME] {train_time:.3f} s")
    tloss, tacc = run_eval(ds.test, args.valid_batchsize, 0)
    say(f"[TEST] loss {tloss:.4f} accuracy {tacc * 100:.2f}%", flush=True)


if __name__ == "__main__":
    main()
