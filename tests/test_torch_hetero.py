"""Port parity for the typed-node slice: NodeTypeSpace, build_hetero_graph
and synthetic_hetero_dataset bit-equal to the JAX package's;
HeteroFeatureStore's gather_typed and apply_gradients against JAX's on a
one-device mesh (tables and LazyAdam slots, the row-0/mask contract);
TypedProjection and HeteroGNN through params_from_jax; and three hetero
training steps against the same loop written with the JAX package.

Tolerances: the index math, the graph and the dataset bit-equal; gathered
rows bit-equal; the store after an apply rtol/atol 1e-5 (the same f32
optimizer arithmetic, other kernels); logits and losses rtol/atol 1e-5,
gradients 1e-4 (those of tests/test_torch_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wholegraph_tpu.embedding import LazyAdam as JaxLazyAdam
from wholegraph_tpu.graph import HeteroFeatureStore as JaxStore
from wholegraph_tpu.graph import NodeTypeSpace as JaxSpace
from wholegraph_tpu.graph import build_hetero_graph as jax_build
from wholegraph_tpu.graph import synthetic_hetero_dataset as jax_dataset
from wholegraph_tpu.models import HeteroGNN as JaxHeteroGNN
from wholegraph_tpu.models import TypedProjection as JaxTypedProjection
from wholegraph_tpu.models import cross_entropy_loss as jax_ce
from wholegraph_tpu_torch import HeteroTrainConfig, HeteroTrainState, build_hetero, hetero_train_step
from wholegraph_tpu_torch.embedding import LazyAdam
from wholegraph_tpu_torch.graph import (HeteroFeatureStore, NodeTypeSpace, build_hetero_graph,
                                        synthetic_hetero_dataset)
from wholegraph_tpu_torch.models import (HeteroGNN, TypedProjection, cross_entropy_loss,
                                         params_from_jax)
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
COUNTS = {"paper": 70, "author": 40, "inst": 9}
DIMS = {"paper": 12, "author": 8, "inst": 4}
SMALL = dict(n_paper=300, n_author=120, n_inst=20, num_classes=5)


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _gids(space, seed=0, B=64):
    """Ids of every type, padding (the sentinel ``total``) and -1."""
    rs = np.random.RandomState(seed)
    g = rs.permutation(space.total)[:B].astype(np.int32)
    g[::9] = space.total
    g[5] = -1
    return g


def test_node_type_space_matches_jax():
    js, ts = JaxSpace.create(COUNTS, DIMS), NodeTypeSpace.create(COUNTS, DIMS)
    assert (ts.names, ts.counts, ts.dims, ts.total) == (js.names, js.counts, js.dims, js.total)
    assert np.array_equal(ts.offsets, js.offsets)
    g = np.concatenate([np.arange(-3, ts.total + 3), [69, 70, 109, 110, 118]]).astype(np.int32)
    for fn in ("type_of", "local_of"):
        a, b = getattr(ts, fn)(torch.from_numpy(g)), getattr(js, fn)(jnp.asarray(g))
        assert np.array_equal(a.numpy(), np.asarray(b)), fn
    loc = np.arange(7, dtype=np.int32)
    for n in ts.names:
        assert np.array_equal(ts.global_of(n, torch.from_numpy(loc)).numpy(),
                              np.asarray(js.global_of(n, jnp.asarray(loc))))
    with pytest.raises(InvalidInput):
        NodeTypeSpace.create(COUNTS, {"paper": 1})


def test_build_hetero_graph_matches_jax():
    rs = np.random.RandomState(1)
    edges = {("paper", "cites", "paper"): (rs.randint(0, 70, 200), rs.randint(0, 70, 200)),
             ("author", "writes", "paper"): (rs.randint(0, 40, 90), rs.randint(0, 70, 90)),
             ("author", "affiliated", "inst"): (np.arange(40), rs.randint(0, 9, 40))}
    for rev in (False, True):
        jg, jn = jax_build(JaxSpace.create(COUNTS, DIMS), edges, add_reverse_relations=rev)
        tg, tn = build_hetero_graph(NodeTypeSpace.create(COUNTS, DIMS), edges,
                                    add_reverse_relations=rev, device="cpu")
        assert tn == jn and tg.num_relations == jg.num_relations == len(jn)
        for name in ("row_ptr", "col", "edge_type"):
            assert np.array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name))), name
    bad = {("paper", "cites", "paper"): (np.array([70]), np.array([0]))}
    with pytest.raises(InvalidInput):
        build_hetero_graph(NodeTypeSpace.create(COUNTS, DIMS), bad, device="cpu")


def test_synthetic_hetero_dataset_matches_jax():
    j = jax_dataset(**SMALL, seed=3)
    t = synthetic_hetero_dataset(**SMALL, seed=3, device="cpu")
    assert t["relations"] == j["relations"] and t["space"].names == j["space"].names
    for k in ("labels", "train", "valid", "test"):
        assert np.array_equal(t[k], j[k]), k
    for n in t["features"]:
        assert t["features"][n].dtype == np.float32
        assert np.array_equal(t["features"][n], j["features"][n]), n
    for name in ("row_ptr", "col", "edge_type"):
        assert np.array_equal(getattr(t["graph"], name).numpy(),
                              np.asarray(getattr(j["graph"], name))), name
    assert t["graph"].num_relations == j["graph"].num_relations == 6


def _stores(seed=0):
    rs = np.random.RandomState(seed)
    arrays = {n: rs.randn(COUNTS[n], DIMS[n]).astype(np.float32) for n in COUNTS}
    jstore = JaxStore.create(_mesh1(), JaxSpace.create(COUNTS, DIMS), optimizer=JaxLazyAdam())
    tstore = HeteroFeatureStore.create(NodeTypeSpace.create(COUNTS, DIMS), optimizer=LazyAdam(),
                                       device="cpu")
    return arrays, jstore, jstore.from_arrays(arrays), tstore.from_arrays(arrays)


def test_store_gather_typed_matches_jax():
    arrays, jstore, states, tstore = _stores()
    g = _gids(tstore.space)
    jrows, jmasks = jstore.gather_typed(states, jnp.asarray(g))
    rows, masks = tstore.gather_typed(torch.from_numpy(g))
    for n in COUNTS:
        assert np.array_equal(masks[n].numpy(), np.asarray(jmasks[n])), n
        assert np.array_equal(rows[n].numpy(), np.asarray(jrows[n])), n
        assert (rows[n][~masks[n]] == 0).all()


def test_store_apply_gradients_matches_jax_and_spares_row_zero():
    """Two applies (the second under a mask) on ids of every type, padding
    and -1: each type's table and LazyAdam m and v as JAX's; rows no valid
    slot names, row 0 of every type included, keep their table row and
    zero optimizer state."""
    arrays, jstore, states, tstore = _stores(1)
    space = tstore.space
    rs = np.random.RandomState(2)
    g = _gids(space, seed=3)
    local = space.local_of(torch.from_numpy(g)).numpy()
    g = g[(g < 0) | (g >= space.total) | (local != 0)]  # no valid id names a row 0
    mask = rs.rand(g.shape[0]) < 0.7
    grads = {n: rs.randn(g.shape[0], DIMS[n]).astype(np.float32) for n in COUNTS}
    for m in (None, mask):
        states = jstore.apply_gradients(states, jnp.asarray(g), {k: jnp.asarray(v) for k, v in
                                                                 grads.items()}, 0.1,
                                        mask=None if m is None else jnp.asarray(m))
        tstore.apply_gradients(torch.from_numpy(g), {k: torch.from_numpy(v)
                                                     for k, v in grads.items()}, 0.1,
                               mask=None if m is None else torch.from_numpy(m))
    for n in COUNTS:
        je, te = jstore.embeddings[n], tstore.embeddings[n]
        np.testing.assert_allclose(te.to_array(), je.to_array(states[n]), **FWD)
        for s in ("m", "v"):
            np.testing.assert_allclose(te.slot_to_array(s), je.slot_to_array(states[n], s), **FWD)
        assert np.array_equal(te.to_array()[0], arrays[n][0]), n
        assert not te.slot_to_array("m")[0].any() and not te.slot_to_array("v")[0].any()
        assert te.step == 2


def _typed_rows(seed, B=40):
    rs = np.random.RandomState(seed)
    t = rs.randint(0, 3, B)
    masks = {n: t == i for i, n in enumerate(COUNTS)}
    rows = {n: (rs.randn(B, DIMS[n]) * masks[n][:, None]).astype(np.float32) for n in COUNTS}
    return rows, masks


def test_typed_projection_matches_jax():
    rows, masks = _typed_rows(4)
    jm = JaxTypedProjection(16)
    jr = {k: jnp.asarray(v) for k, v in rows.items()}
    jmk = {k: jnp.asarray(v) for k, v in masks.items()}
    params = jm.init(jax.random.PRNGKey(1), jr, jmk)
    w = np.random.RandomState(5).randn(40, 16).astype(np.float32)
    jout, (jdp, jdr) = jax.value_and_grad(
        lambda p, r: jnp.sum(jm.apply(p, r, jmk) * w), argnums=(0, 1))(params, jr)
    tm = TypedProjection(DIMS, 16)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tr = {k: torch.from_numpy(v).requires_grad_() for k, v in rows.items()}
    out = tm(tr, {k: torch.from_numpy(v) for k, v in masks.items()})
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply(params, jr, jmk)), **FWD)
    jg = params_from_jax(jax.tree.map(np.asarray, jdp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), err_msg=name, **GRAD)
    for n in COUNTS:
        np.testing.assert_allclose(tr[n].grad.numpy(), np.asarray(jdr[n]), **GRAD)
    assert sorted(k.split(".")[0] for k in tm.state_dict()) == sorted(
        f"proj_{n}" for n in COUNTS for _ in ("weight", "bias"))


def _hetero_sample(seed=5, fanouts=(4, 3)):
    j = jax_dataset(**SMALL, seed=seed)
    t = synthetic_hetero_dataset(**SMALL, seed=seed, device="cpu")
    centers = t["train"][:24].astype(np.int32)
    jml = j["graph"].multilayer_sample(jnp.asarray(centers), fanouts, seed=2)
    tml = t["graph"].multilayer_sample(torch.from_numpy(centers), fanouts, seed=2)
    return j, t, centers, jml, tml


def test_hetero_gnn_matches_jax():
    """The typed gather, TypedProjection, relu and a 2-layer RGCN over the
    typed hops: logits, loss, and the gradient of every weight and of each
    type's rows."""
    j, t, centers, jml, tml = _hetero_sample()
    arrays = j["features"]
    jstore = JaxStore.create(_mesh1(), j["space"])
    jrows, jmasks = jstore.gather_typed(jstore.from_arrays(arrays), jml.unique_gids)
    tstore = HeteroFeatureStore.create(t["space"], device="cpu").from_arrays(arrays)
    rows, masks = tstore.gather_typed(tml.unique_gids)
    labels = t["labels"][centers].astype(np.int32)
    jmodel = JaxHeteroGNN(hidden_dim=16, num_classes=SMALL["num_classes"], num_layers=2,
                          num_relations=6)
    params = jmodel.init(jax.random.PRNGKey(3), jrows, jmasks, sample=jml)
    jl, (jdp, jdr) = jax.value_and_grad(
        lambda p, r: jax_ce(jmodel.apply(p, r, jmasks, sample=jml), jnp.asarray(labels)),
        argnums=(0, 1))(params, jrows)
    model = HeteroGNN(dict(zip(t["space"].names, t["space"].dims)), 16, SMALL["num_classes"],
                      num_layers=2, num_relations=6, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rows = {k: v.requires_grad_() for k, v in rows.items()}
    logits = model(rows, masks, sample=tml)
    loss = cross_entropy_loss(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jmodel.apply(params, jrows, jmasks, sample=jml)), **FWD)
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    jg = params_from_jax(jax.tree.map(np.asarray, jdp))
    assert set(jg) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), err_msg=name, **GRAD)
    for n in rows:
        np.testing.assert_allclose(rows[n].grad.numpy(), np.asarray(jdr[n]), **GRAD)


@pytest.mark.parametrize("fanouts", [(4, 3), (8, 8)])
def test_store_at_the_example_widths_on_a_sampled_batch_matches_jax(fanouts):
    """The typed gather and two LazyAdam typed applies at the example's
    widths (48, 32, 16) on a sampled batch's slots, as the hetero step hands
    them over: the unique ids, then padding, so most of each type's slots
    are off-type. Gathered rows exact; each type's table, m and v within
    FWD of JAX's ``HeteroFeatureStore``."""
    j, t, centers, jml, tml = _hetero_sample(seed=6, fanouts=fanouts)
    assert t["space"].dims == (48, 32, 16)
    gids, umask = tml.unique_gids, tml.unique_mask
    assert np.array_equal(gids.numpy(), np.asarray(jml.unique_gids))
    # each level's unique ids, then its padding (the sentinel ``total``)
    assert (~umask).any() and (gids[~umask] == t["space"].total).all()
    arrays = t["features"]
    jstore = JaxStore.create(_mesh1(), j["space"], optimizer=JaxLazyAdam())
    states = jstore.from_arrays(arrays)
    tstore = HeteroFeatureStore.create(t["space"], optimizer=LazyAdam(),
                                       device="cpu").from_arrays(arrays)
    jrows, jmasks = jstore.gather_typed(states, jnp.asarray(gids.numpy()))
    rows, masks = tstore.gather_typed(gids)
    for n in t["space"].names:
        assert masks[n].float().mean() < 0.9, n  # most of a type's slots are not its own
        assert np.array_equal(masks[n].numpy(), np.asarray(jmasks[n])), n
        assert np.array_equal(rows[n].numpy(), np.asarray(jrows[n])), n
    rs = np.random.RandomState(7)
    for _ in range(2):
        grads = {n: rs.randn(gids.shape[0], d).astype(np.float32)
                 for n, d in zip(t["space"].names, t["space"].dims)}
        states = jstore.apply_gradients(states, jnp.asarray(gids.numpy()),
                                        {k: jnp.asarray(v) for k, v in grads.items()}, 0.01,
                                        mask=jnp.asarray(umask.numpy()), assume_unique=True)
        tstore.apply_gradients(gids, {k: torch.from_numpy(v) for k, v in grads.items()}, 0.01,
                               mask=umask, assume_unique=True)
    for n in t["space"].names:
        je, te = jstore.embeddings[n], tstore.embeddings[n]
        np.testing.assert_allclose(te.to_array(), je.to_array(states[n]), **FWD)
        for s in ("m", "v"):
            np.testing.assert_allclose(te.slot_to_array(s), je.slot_to_array(states[n], s), **FWD)


def test_params_from_jax_hetero_layout():
    tree = {"params": {"typed_proj": {"proj_a": {"kernel": np.ones((3, 2), np.float32),
                                                 "bias": np.zeros(2, np.float32)}},
                       "gnn": {"RGCNConv_0": {"w_rel": np.zeros((2, 2, 4), np.float32),
                                              "self": {"kernel": np.ones((2, 4), np.float32)},
                                              "bias": np.zeros(4, np.float32)}}}}
    sd = params_from_jax(tree)
    assert set(sd) == {"typed_proj.proj_a.weight", "typed_proj.proj_a.bias", "gnn.convs.0.w_rel",
                       "gnn.convs.0.self.weight", "gnn.convs.0.bias"}
    assert sd["typed_proj.proj_a.weight"].shape == (2, 3)
    assert sd["gnn.convs.0.self.weight"].shape == (4, 2)
    with pytest.raises(InvalidInput):
        params_from_jax({"typed_proj": {}, "gnn": {}, "extra": {}})
    with pytest.raises(InvalidInput):
        params_from_jax({"RGCNConv_0": {"w_rel": np.zeros((1, 1, 1))}})  # no self


def test_three_hetero_steps_match_jax():
    """hetero_train_step (no dropout, the store trained at a tenth of the
    dense rate) against the example's loop body written with the JAX
    package: losses within 1e-5, each type's table within 1e-5."""
    cfg = HeteroTrainConfig(**SMALL, hidden=16, batch=24, fanouts=(4, 3))
    st = build_hetero(cfg, device="cpu", seed=6)
    j = jax_dataset(**SMALL, seed=6)
    jstore = JaxStore.create(_mesh1(), j["space"], optimizer=JaxLazyAdam())
    states = jstore.from_arrays(j["features"])
    g = j["graph"]
    jmodel = JaxHeteroGNN(hidden_dim=cfg.hidden, num_classes=cfg.num_classes, num_layers=2,
                          num_relations=g.num_relations)
    rs = np.random.RandomState(7)
    batches = [rs.choice(j["train"], cfg.batch, replace=False).astype(np.int32) for _ in range(3)]
    ml0 = g.multilayer_sample(jnp.asarray(batches[0]), cfg.fanouts, seed=0)
    r0, m0 = jstore.gather_typed(states, ml0.unique_gids)
    params = jmodel.init(jax.random.PRNGKey(0), r0, m0, sample=ml0)
    st.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=cfg.lr)
    dense_opt = optax.adam(cfg.lr)
    opt_state = dense_opt.init(params)
    for i, centers in enumerate(batches):
        ml = g.multilayer_sample(jnp.asarray(centers), cfg.fanouts, seed=i)
        rows, masks = jstore.gather_typed(states, ml.unique_gids)
        y = jnp.asarray(j["labels"][centers].astype(np.int32))
        loss, (dp, dr) = jax.value_and_grad(
            lambda p, r: jax_ce(jmodel.apply(p, r, masks, sample=ml), y),
            argnums=(0, 1))(params, rows)
        updates, opt_state = dense_opt.update(dp, opt_state, params)
        params = optax.apply_updates(params, updates)
        states = jstore.apply_gradients(states, ml.unique_gids, dr, cfg.lr * 0.1,
                                        mask=ml.unique_mask)
        c = torch.from_numpy(centers)
        tloss = hetero_train_step(st, c, st.labels[c.long()], seed=i)
        np.testing.assert_allclose(float(tloss), float(loss), **FWD)
    for n in j["space"].names:
        np.testing.assert_allclose(st.store.embeddings[n].to_array(),
                                   jstore.embeddings[n].to_array(states[n]), **FWD)
    assert isinstance(st, HeteroTrainState) and st.graph.num_relations == 6


def test_hetero_config_defaults_are_the_example_times_250():
    cfg = HeteroTrainConfig()
    assert (cfg.n_paper, cfg.n_author, cfg.n_inst) == (4000 * 250, 1500 * 250, 200 * 250)
    assert (cfg.num_classes, cfg.hidden, cfg.batch, cfg.fanouts, cfg.lr, cfg.dropout) == (
        40, 256, 1024, (30, 30), 3e-3, 0.5)
