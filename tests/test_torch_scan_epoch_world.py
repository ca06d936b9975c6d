"""The scanned epoch at world 4 on the CPU: ``train.train_epoch`` over ranks
(the JAX example's ``train_epoch_scan`` on a mesh,
``examples/node_classification.py:258-275``, ``:376-391``) and the example's
``rank_share``, which gives each rank its columns of the stacked batches.

One world of 4 ranks (processes over gloo, a ``file://`` rendezvous) runs
every case once, in a module-scoped fixture; each test reads its case.

Bit for bit: at world 4 a ``train_epoch`` of S steps (two epochs) equals S
``train_step`` calls on a second state built alike, in the losses, the
table, LazyAdam's m and v and the dense parameters; uniform, weighted, a
hot cache under a trained table, and dropout drawn from a generator.
Within ``test_torch_sharded_embedding.py``'s ``STEP_TOL`` (rtol/atol
1e-5: f32 sums in another order over three Adam steps): the port's world-4
epoch against ``lax.scan`` over the example's body on JAX's ``mesh4``, the
centres placed ``P(None, "data")``, the table under SGD (LazyAdam's
``g / (sqrt(v) + eps)`` would hide a gradient's scale), no dropout, the
weights carried over by ``models/convert.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import wholegraph_tpu_torch as wt
from test_torch_sharded_embedding import CFG as SGD_CFG
from test_torch_sharded_embedding import STEP_TOL, _graph_data, _jax_params, _port_state
from wholegraph_tpu_torch import train as T
from wholegraph_tpu_torch.examples.node_classification import rank_share
from wholegraph_tpu_torch.parallel import multiprocess_run

torch.set_num_threads(1)

W, S, EPOCHS = 4, 3, 2
SEED0 = 40  # the first epoch's global step: seeds 40, 41, 42, then 43, 44, 45
CFG = wt.SageTrainConfig(n_nodes=300, deg=8, dim=16, hidden=16, num_classes=4, batch=8,
                         fanouts=(3, 4), lr=0.05)
CASES = {
    "uniform": dict(),
    "weighted": dict(sample_method="weighted"),
    "cache_train_embedding": dict(cache=True),
    "dropout": dict(dropout=True),
}


def _centers(seed):
    """EPOCHS x [S, W * B] stacked global batches of distinct centres (a
    shuffled epoch's: a centre repeated across ranks is keyed otherwise
    than within one rank's list)."""
    rs = np.random.RandomState(seed)
    return [np.stack([rs.permutation(CFG.n_nodes)[:W * CFG.batch] for _ in range(S)])
            .astype(np.int32) for _ in range(EPOCHS)]


def _state(cfg, mesh, cache):
    st = wt.build_synthetic(cfg, device="cpu", seed=5, mesh=mesh)
    if cache:
        st.cache = wt.embedding.build_hot_cache(
            st.embedding.as_sharded_table(),
            wt.embedding.hot_ids_by_degree(st.graph.row_ptr, 0.3))
    return st


def _snapshot(st):
    emb = st.embedding
    return {"table": emb.to_array(), **{s: emb.slot_to_array(s) for s in emb.slots},
            "dense": {k: v.detach().clone() for k, v in st.model.state_dict().items()},
            "valid": None if st.cache is None else st.cache.valid.clone(),
            "step": emb.step, "epoch_graph": st.epoch_graph}


def _rank_cases(rank, world, params_sd):
    from wholegraph_tpu_torch.parallel import get_global_mesh

    mesh = get_global_mesh()
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        cache, dropout = kw.pop("cache", False), kw.pop("dropout", False)
        cfg = dataclasses.replace(CFG, **kw)
        eager, scanned = _state(cfg, mesh, cache), _state(cfg, mesh, cache)
        ga, gb = ((torch.Generator().manual_seed(3) if dropout else None) for _ in range(2))
        want, got = [], []
        for e, stacked in enumerate(_centers(9)):
            c = torch.from_numpy(np.ascontiguousarray(rank_share(stacked, world, rank)))
            y = eager.labels[c.long()]
            seeds = SEED0 + e * S + torch.arange(S)
            want += [wt.train_step(eager, c[i], y[i], int(seeds[i]), generator=ga)
                     for i in range(S)]
            got.append(T.train_epoch(scanned, c, y, seeds, generator=gb))
        out[name] = {"want": torch.stack(want), "got": torch.cat(got),
                     "eager": _snapshot(eager), "scanned": _snapshot(scanned)}

    # against JAX: the table under SGD, JAX's initial weights
    st = _port_state(mesh, params_sd)
    centers = np.stack([c.reshape(-1) for c in _graph_data()[4]])  # [S, W * B]
    c = torch.from_numpy(np.ascontiguousarray(rank_share(centers, world, rank)))
    losses = T.train_epoch(st, c, st.labels[c.long()], SEED0 + torch.arange(len(centers)))
    out["jax"] = (losses, st.embedding.to_array(), st.embedding.step)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan_epoch_world")
    params, sd = _jax_params()
    res = multiprocess_run(W, _rank_cases, (sd,), backend="gloo", device="cpu",
                           init_method=f"file://{d}/rendezvous", timeout=240)
    return res, params


@pytest.mark.parametrize("what", ("losses", "table", "slots", "dense"))
@pytest.mark.parametrize("case", list(CASES))
def test_epoch_at_world4_is_its_steps_bit_for_bit(world, case, what):
    """Two world-4 epochs of S steps each (the step run once a batch on the
    rank's columns, its row, seed and LazyAdam corrections read on the
    device) equal 2 S ``train_step`` calls with int seeds, bit for bit; no
    graph is captured, the step counter moves by S an epoch, and the
    losses are the ranks' mean, the same on every rank."""
    res = world[0]
    for out in res:
        r = out[case]
        a, b = r["eager"], r["scanned"]
        if what == "losses":
            assert r["got"].shape == (EPOCHS * S,) and torch.equal(r["got"], r["want"])
            assert torch.equal(r["got"], res[0][case]["got"])
            assert b["epoch_graph"] is None and a["step"] == b["step"] == EPOCHS * S
        elif what == "table":
            np.testing.assert_array_equal(b["table"], a["table"])
            np.testing.assert_array_equal(b["table"], res[0][case]["scanned"]["table"])
            if a["valid"] is not None:  # the cache cleared in place as the eager step clears it
                assert torch.equal(a["valid"], b["valid"]) and not b["valid"].all()
        elif what == "slots":
            for s in ("m", "v"):
                np.testing.assert_array_equal(b[s], a[s])
                assert (b[s] != 0).any()
        else:
            for k, v in a["dense"].items():
                assert torch.equal(b["dense"][k], v), k


def test_epoch_at_world4_matches_a_jax_scan_on_mesh4(world, mesh4):
    """The port's world-4 epoch against a jitted ``lax.scan`` over the JAX
    example's ``_train_body`` (multilayer_sample, the exchange gather x
    unique_mask, SAGE forward and backward, optax.adam, the SGD apply) on
    ``mesh4``, its stacked centres and labels placed ``P(None, "data")``:
    the same losses and the same moves of the table."""
    import jax
    import jax.numpy as jnp
    import optax
    import wholegraph_tpu.embedding as jemb
    from jax.sharding import NamedSharding, PartitionSpec as P
    from wholegraph_tpu.graph import GraphStructure as JaxGraph
    from wholegraph_tpu.models import HomoGNN as JaxGNN
    from wholegraph_tpu.models import cross_entropy_loss as jax_ce

    res, params = world
    cfg = SGD_CFG
    row_ptr, col, table, labels_tab, centers = _graph_data()
    g = JaxGraph(row_ptr=jnp.asarray(row_ptr), col=jnp.asarray(col), node_count=cfg.n_nodes,
                 edge_count=len(col), max_degree=int(np.diff(row_ptr).max()))
    emb = jemb.Embedding.create(mesh4, cfg.n_nodes, cfg.dim, optimizer=jemb.SGD())
    estate = emb.from_array(table)
    model = JaxGNN(model_type="sage", hidden_dim=cfg.hidden, num_classes=cfg.num_classes,
                   num_layers=2)
    params = jax.tree.map(jnp.asarray, params)
    dense_opt = optax.adam(cfg.lr)

    def body(carry, batch):
        params, estate, opt_state = carry
        c, y, seed = batch
        ml = g.multilayer_sample(c, cfg.fanouts, seed=seed)
        ids = ml.unique_gids
        rows = emb.gather(estate, ids, capacity_factor=cfg.capacity_factor) \
            * ml.unique_mask[:, None]

        def loss_fn(p, r):
            return jax_ce(model.apply(p, r, sample=ml), y)

        loss, (dp, dr) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, rows)
        updates, opt_state = dense_opt.update(dp, opt_state, params)
        params = optax.apply_updates(params, updates)
        estate = emb.apply_gradients(estate, ids, dr, cfg.lr, mask=ml.unique_mask,
                                     capacity_factor=cfg.capacity_factor)
        return (params, estate, opt_state), loss

    @jax.jit
    def epoch(params, estate, opt_state, centers_s, labels_s, seeds):
        (params, estate, opt_state), losses = jax.lax.scan(
            body, (params, estate, opt_state), (centers_s, labels_s, seeds))
        return estate, losses

    stacked = np.stack([c.reshape(-1) for c in centers])  # [S, W * B]
    place = NamedSharding(mesh4, P(None, "data"))
    cs = jax.device_put(jnp.asarray(stacked), place)
    ys = jax.device_put(jnp.asarray(labels_tab[stacked]), place)
    seeds = jnp.arange(len(stacked), dtype=jnp.int32) + SEED0
    jstate, jlosses = epoch(params, estate, dense_opt.init(params), cs, ys, seeds)
    jtable = emb.to_array(jstate)
    for out in res:
        losses, tab, step = out["jax"]
        assert step == len(stacked)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **STEP_TOL)
        np.testing.assert_allclose((tab - table) / cfg.lr, (jtable - table) / cfg.lr,
                                   **STEP_TOL)
        assert (tab != table).any()


@pytest.mark.parametrize("world_size", (2, 4))
def test_rank_share_of_stacked_batches(world_size):
    """``rank_share`` of a ``[B]`` batch is the rank's block; of stacked
    ``[S, B]`` batches it is that block of every step (JAX's ``P(None,
    AXIS)``), which a split of the flattened array into whole steps is not."""
    rs = np.random.RandomState(1)
    B = 8 * world_size
    stacked = rs.randint(0, 1000, (S + 1, B)).astype(np.int32)
    shares = [rank_share(stacked, world_size, r) for r in range(world_size)]
    for r, share in enumerate(shares):
        assert share.shape == (S + 1, B // world_size)
        for s in range(S + 1):
            np.testing.assert_array_equal(share[s], rank_share(stacked[s], world_size, r))
            np.testing.assert_array_equal(share[s], stacked[s].reshape(world_size, -1)[r])
        assert not np.array_equal(share, stacked.reshape(world_size, -1)[r].reshape(share.shape))
    np.testing.assert_array_equal(np.concatenate(shares, axis=1), stacked)
    np.testing.assert_array_equal(rank_share(stacked, 1, 0), stacked)
