"""Port parity for the slice as a whole: three training steps of
wholegraph_tpu_torch.train_step against the same loop written with the JAX
package (bench.py's bench_train_step body: multilayer_sample, gather x
unique_mask, SAGE forward/backward, optax.adam, LazyAdam apply with
assume_unique), from the same graph, table, weights and batches.

Sampling is bit-exact, so both sides see the same ids. Tolerance: losses
and the touched embedding rows rtol/atol 1e-5 (f32 sums in another order,
compounded over three Adam steps). The host-tier variant runs the same loop
with a HostEmbedding on both sides (JAX: apply_gradients without
assume_unique, as HostEmbedding has none), same tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from wholegraph_tpu.embedding import Embedding as JaxEmbedding
from wholegraph_tpu.embedding import HostEmbedding as JaxHostEmbedding
from wholegraph_tpu.embedding import LazyAdam as JaxLazyAdam
from wholegraph_tpu.embedding.cache import hot_ids_by_degree as jax_hot_ids_by_degree
from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.models import HomoGNN as JaxGNN
from wholegraph_tpu.models import cross_entropy_loss as jax_ce
from wholegraph_tpu_torch import SageTrainConfig, SageTrainState, build_synthetic, train_step
from wholegraph_tpu_torch.train import STAGES
from wholegraph_tpu_torch.embedding import Embedding, HostEmbedding, LazyAdam, hot_ids_by_degree
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN, params_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = SageTrainConfig(n_nodes=300, deg=8, dim=16, hidden=16, num_classes=4, batch=16,
                      fanouts=(3, 4))


HOST_RATIO = 0.25


def _jax_loop(row_ptr, col, table, labels_tab, batches, host=False):
    cfg = CFG
    g = JaxGraph(row_ptr=jnp.asarray(row_ptr), col=jnp.asarray(col), node_count=cfg.n_nodes,
                 edge_count=len(col), max_degree=int(np.diff(row_ptr).max()))
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    if host:
        emb = JaxHostEmbedding.create(mesh1, cfg.n_nodes, cfg.dim, optimizer=JaxLazyAdam(),
                                      cache_ratio=HOST_RATIO)
        estate = emb.from_array(table, hot_ids=jax_hot_ids_by_degree(row_ptr, HOST_RATIO))
    else:
        emb = JaxEmbedding.create(mesh1, cfg.n_nodes, cfg.dim, optimizer=JaxLazyAdam())
        estate = emb.from_array(table)
    model = JaxGNN(model_type="sage", hidden_dim=cfg.hidden, num_classes=cfg.num_classes,
                   num_layers=2)
    ml0 = g.multilayer_sample(jnp.asarray(batches[0]), cfg.fanouts, seed=0)
    params = model.init(jax.random.PRNGKey(0), emb.gather(estate, ml0.unique_gids), sample=ml0)
    init_params = jax.tree.map(np.asarray, params)
    dense_opt = optax.adam(cfg.lr)
    opt_state = dense_opt.init(params)
    losses, touched = [], []
    for i, centers in enumerate(batches):
        ml = g.multilayer_sample(jnp.asarray(centers), cfg.fanouts, seed=i)
        ids = ml.unique_gids
        labels = jnp.take(jnp.asarray(labels_tab), jnp.asarray(centers), mode="clip")
        rows = emb.gather(estate, ids) * ml.unique_mask[:, None]

        def loss_fn(p, r):
            return jax_ce(model.apply(p, r, sample=ml), labels)

        loss, (dp, dr) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, rows)
        updates, opt_state = dense_opt.update(dp, opt_state, params)
        params = optax.apply_updates(params, updates)
        if host:
            estate = emb.apply_gradients(estate, ids, dr, cfg.lr, mask=ml.unique_mask)
        else:
            estate = emb.apply_gradients(estate, ids, dr, cfg.lr, mask=ml.unique_mask,
                                         assume_unique=True)
        losses.append(float(loss))
        touched.append(np.asarray(ids)[np.asarray(ml.unique_mask)])
    m = (np.asarray(estate.host_slots["m"]).reshape(cfg.n_nodes, cfg.dim) if host
         else emb.slot_to_array(estate, "m"))
    return init_params, losses, touched, emb.to_array(estate), m


def _data():
    cfg = CFG
    rs = np.random.RandomState(0)
    degs = rs.randint(cfg.deg // 2, cfg.deg + cfg.deg // 2 + 1, cfg.n_nodes)
    degs[:5] = 0
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, cfg.n_nodes, row_ptr[-1]).astype(np.int32)
    table = (rs.randn(cfg.n_nodes, cfg.dim) / 4).astype(np.float32)
    labels_tab = rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32)
    batches = [rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32) for _ in range(3)]
    return row_ptr, col, table, labels_tab, batches


def _three_steps_match_jax(host):
    cfg = CFG
    row_ptr, col, table, labels_tab, batches = _data()
    params, jlosses, jtouched, jtable, jm = _jax_loop(row_ptr, col, table, labels_tab, batches,
                                                      host=host)

    model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, num_layers=2, device="cpu")
    model.load_state_dict(params_from_jax(params))
    if host:
        emb = HostEmbedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(),
                                   cache_ratio=HOST_RATIO, device="cpu")
        emb.from_array(table, hot_ids=hot_ids_by_degree(row_ptr, HOST_RATIO))
    else:
        emb = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device="cpu")
        emb.from_array(table)
    state = SageTrainState(
        cfg, GraphStructure(torch.from_numpy(row_ptr), torch.from_numpy(col), cfg.n_nodes),
        emb, model, torch.optim.Adam(model.parameters(), lr=cfg.lr), torch.from_numpy(labels_tab))
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        loss = train_step(state, c, state.labels[c.long()], seed=i)
        np.testing.assert_allclose(float(loss), jlosses[i], **TOL)
    rows = np.unique(np.concatenate(jtouched))
    np.testing.assert_allclose(state.embedding.to_array()[rows], jtable[rows], **TOL)
    np.testing.assert_allclose(state.embedding.slot_to_array("m")[rows], jm[rows], **TOL)
    untouched = np.setdiff1d(np.arange(cfg.n_nodes), rows)
    np.testing.assert_array_equal(state.embedding.to_array()[untouched], table[untouched])
    assert state.embedding.step == 3
    if host:  # every cached row still equals its host row
        cached = emb.cache_map >= 0
        assert torch.equal(emb.cache_rows[emb.cache_map[cached].long()], emb.host_table[cached])


def test_three_steps_match_jax():
    _three_steps_match_jax(host=False)


def test_three_host_tier_steps_match_jax():
    _three_steps_match_jax(host=True)


def test_build_synthetic_host_tier_is_the_hbm_state_in_the_host_tier():
    hbm = build_synthetic(CFG, device="cpu", seed=3)
    host = build_synthetic(CFG, device="cpu", seed=3, host_cache_ratio=HOST_RATIO)
    emb = host.embedding
    assert isinstance(emb, HostEmbedding) and emb.hot_cap == int(CFG.n_nodes * HOST_RATIO)
    assert torch.equal(emb.host_table, hbm.embedding.table)
    assert torch.equal(host.graph.col, hbm.graph.col) and torch.equal(host.labels, hbm.labels)
    hot = hot_ids_by_degree(host.graph.row_ptr, HOST_RATIO)
    assert (emb.cache_map[torch.from_numpy(hot)] >= 0).all()
    assert int((emb.cache_map >= 0).sum()) == len(hot)
    for i in range(3):
        c = torch.arange(CFG.batch, dtype=torch.int32) * 7 + i
        a = train_step(hbm, c, hbm.labels[c.long()], seed=i)
        b = train_step(host, c, host.labels[c.long()], seed=i)
        torch.testing.assert_close(b, a, **TOL)
    np.testing.assert_allclose(emb.to_array(), hbm.embedding.to_array(), **TOL)
    np.testing.assert_allclose(emb.slot_to_array("v"), hbm.embedding.slot_to_array("v"), **TOL)


def test_build_synthetic_is_seeded_and_trains():
    a = build_synthetic(CFG, device="cpu", seed=1)
    b = build_synthetic(CFG, device="cpu", seed=1)
    degs = np.diff(a.graph.row_ptr.numpy())
    assert degs.min() >= CFG.deg // 2 and degs.max() <= CFG.deg + CFG.deg // 2
    assert torch.equal(a.graph.col, b.graph.col) and torch.equal(a.embedding.table, b.embedding.table)
    assert a.embedding.table.shape == (CFG.n_nodes, CFG.dim)
    assert a.model.convs[0].proj.weight.shape == (CFG.hidden, 2 * CFG.dim)
    c = torch.arange(CFG.batch, dtype=torch.int32)
    losses = [float(train_step(a, c, a.labels[c.long()], seed=0)) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]  # same batch: loss falls


def test_default_config_is_bench_train_step():
    cfg = SageTrainConfig()
    assert (cfg.n_nodes, cfg.deg, cfg.dim, cfg.hidden, cfg.num_classes, cfg.batch,
            cfg.fanouts, cfg.dtype, cfg.lr) == (2_000_000, 16, 256, 256, 16, 1024, (10, 15),
                                                 "float32", 1e-3)


def test_train_step_marks_each_stage_once_in_order():
    state = build_synthetic(CFG, device="cpu", seed=2)
    seen = []
    c = torch.arange(CFG.batch, dtype=torch.int32)
    train_step(state, c, state.labels[c.long()], seed=0, mark=seen.append)
    assert tuple(seen) == STAGES
