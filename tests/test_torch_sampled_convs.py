"""Port parity: the sampled GCN (block, true and auto degree modes), the
sampled GAT (with and without a self loop, heads concatenated or averaged)
and RGCN (on sampled hops and on a FullGraph) of wholegraph_tpu_torch,
loaded from the JAX package's flax parameters through params_from_jax, give
the same logits, loss and gradients (w.r.t. the input rows and every
weight); the sampler's edge types and true degrees, and the typed CSR
build, are bit-equal; three training steps of each model type match the
same loop written with the JAX package.

Tolerances, those of tests/test_torch_models.py: f32 forward (logits,
losses) rtol/atol 1e-5 (other summation orders in the aggregations and
matmuls), gradients 1e-4; sampling, edge types, degrees and the CSR
bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wholegraph_tpu.embedding import Embedding as JaxEmbedding
from wholegraph_tpu.embedding import LazyAdam as JaxLazyAdam
from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.models import GATConv as JaxGATConv
from wholegraph_tpu.models import HomoGNN as JaxGNN
from wholegraph_tpu.models import RGCNConv as JaxRGCNConv
from wholegraph_tpu.models import cross_entropy_loss as jax_ce
from wholegraph_tpu.models import resolve_framework as jax_resolve_framework
from wholegraph_tpu_torch import SageTrainConfig, SageTrainState, build_synthetic, train_step
from wholegraph_tpu_torch.embedding import Embedding, LazyAdam
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import (GATConv, GCNConv, HomoGNN, RGCNConv, cross_entropy_loss,
                                         params_from_jax, resolve_framework)
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
N, D, H, C, R = 150, 24, 16, 5, 3


def _coo(seed):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, N, N * 5), rs.randint(0, N, N * 5)
    et = rs.randint(0, R, N * 5)
    return rs, src, dst, et


def _graphs(seed=0, add_reverse=False):
    rs, src, dst, et = _coo(seed)
    jg = JaxGraph.from_coo(src, dst, N, edge_type=et, add_reverse=add_reverse)
    tg = GraphStructure.from_coo(src, dst, N, edge_type=et, add_reverse=add_reverse, device="cpu")
    return rs, jg, tg


def _sampled(seed=0, fanouts=(3, 4), B=16, with_degrees=False):
    rs, jg, tg = _graphs(seed)
    centers = rs.choice(N, B, replace=False).astype(np.int32)
    jm = jg.multilayer_sample(jnp.asarray(centers), fanouts, seed=1, with_degrees=with_degrees)
    tm = tg.multilayer_sample(torch.from_numpy(centers), fanouts, seed=1,
                              with_degrees=with_degrees)
    x = rs.randn(tm.unique_gids.shape[0], D).astype(np.float32) * tm.unique_mask.numpy()[:, None]
    labels = rs.randint(0, C, B).astype(np.int32)
    return jm, tm, x, labels


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# the sampler's edge types and degrees, the typed CSR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("add_reverse", [False, True])
def test_from_coo_and_to_full_graph_with_edge_types_match_jax(add_reverse):
    _, jg, tg = _graphs(1, add_reverse)
    for name in ("row_ptr", "col", "edge_type"):
        a, b = getattr(tg, name), np.asarray(getattr(jg, name))
        assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b), name
    assert (tg.num_relations, tg.edge_count, tg.max_degree) == (jg.num_relations, jg.edge_count,
                                                                jg.max_degree) == (
        R, jg.edge_count, jg.max_degree)
    jf, tf = jg.to_full_graph(), tg.to_full_graph()
    for name in ("edge_src", "edge_dst", "edge_type"):
        assert np.array_equal(_np(getattr(tf, name)), np.asarray(getattr(jf, name))), name
    # an explicit count is kept, as JAX keeps it
    assert GraphStructure.from_coo(np.array([0]), np.array([1]), 2, edge_type=np.array([0]),
                                   num_relations=4, device="cpu").num_relations == 4


@pytest.mark.parametrize("fanouts", [(3, 4), (12, 12)])
def test_multilayer_sample_edge_types_and_degrees_match_jax(fanouts):
    jm, tm, _, _ = _sampled(2, fanouts, with_degrees=True)
    assert np.array_equal(tm.unique_gids.numpy(), np.asarray(jm.unique_gids))
    for a, b in zip(tm.hops, jm.hops):
        for name in ("nbr_idx", "mask", "center_mask", "edge_type", "node_degree"):
            x, y = getattr(a, name), np.asarray(getattr(b, name))
            assert np.array_equal(x.numpy(), y), name
        assert a.edge_type.dtype == a.node_degree.dtype == torch.int32
        assert (a.edge_type[~a.mask] == 0).all()
    # the degrees are the graph's, 0 on padding
    _, _, tg = _graphs(2)
    deg = (tg.row_ptr[1:] - tg.row_ptr[:-1]).numpy()
    for li, hop in enumerate(tm.hops):
        lg, lm = tm.level_gids[li + 1].numpy(), tm.level_masks[li + 1].numpy()
        assert np.array_equal(hop.node_degree.numpy()[lm], deg[lg[lm]])
        assert (hop.node_degree.numpy()[~lm] == 0).all()
    # without edge types or with_degrees the hop carries neither
    plain = GraphStructure(tg.row_ptr, tg.col, N).multilayer_sample(
        torch.arange(8, dtype=torch.int32), fanouts)
    assert all(h.edge_type is None and h.node_degree is None for h in plain.hops)


# ---------------------------------------------------------------------------
# models: logits, loss and gradients against JAX
# ---------------------------------------------------------------------------


def _check_against_jax(jmodel, model, x, labels, jkw, tkw, init_kw=None):
    """Init the flax model, load its weights into the port's, and compare
    logits, loss, the input rows' gradient and every weight's gradient."""
    jx = jnp.asarray(x)
    params = jmodel.init(jax.random.PRNGKey(0), jx, **(init_kw or jkw))
    jl, (jdp, jdx) = jax.value_and_grad(
        lambda p, r: jax_ce(jmodel.apply(p, r, **jkw), jnp.asarray(labels)),
        argnums=(0, 1))(params, jx)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tx = torch.from_numpy(x).requires_grad_()
    logits = model(tx, **tkw)
    loss = cross_entropy_loss(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(_np(logits), np.asarray(jmodel.apply(params, jx, **jkw)), **FWD)
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jdp))
    assert set(jgrads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD)
    return logits


@pytest.mark.parametrize("degree_mode,with_degrees", [("block", False), ("block", True),
                                                      ("true", True), ("auto", False),
                                                      ("auto", True)])
def test_sampled_gcn_matches_jax(degree_mode, with_degrees):
    jm, tm, x, labels = _sampled(3, with_degrees=with_degrees)
    jmodel = JaxGNN(model_type="gcn", hidden_dim=H, num_classes=C, num_layers=2,
                    degree_mode=degree_mode)
    model = HomoGNN(D, H, C, num_layers=2, model_type="gcn", degree_mode=degree_mode,
                    device="cpu")
    _check_against_jax(jmodel, model, x, labels, {"sample": jm}, {"sample": tm})


def test_sampled_gcn_true_mode_needs_degrees():
    _, tm, x, _ = _sampled(3)
    model = HomoGNN(D, H, C, model_type="gcn", degree_mode="true", device="cpu")
    with pytest.raises(InvalidInput, match="with_degrees"):
        model(torch.from_numpy(x), tm)
    with pytest.raises(InvalidInput):
        GCNConv(D, H, degree_mode="exact")


@pytest.mark.parametrize("self_loop", [True, False])
@pytest.mark.parametrize("concat", [True, False])
def test_sampled_gat_conv_matches_jax(self_loop, concat):
    """One GATConv (3 heads of 4) on the deepest hop, both self-loop and
    head modes."""
    jm, tm, x, _ = _sampled(4)
    jconv = JaxGATConv(out_dim=4, num_heads=3, add_self_loop=self_loop, concat_heads=concat)
    conv = GATConv(D, 4, num_heads=3, add_self_loop=self_loop, concat_heads=concat)
    jx = jnp.asarray(x)
    params = jconv.init(jax.random.PRNGKey(2), jx, jm.hops[1])
    sd = params_from_jax({"GATConv_0": jax.tree.map(np.asarray, params["params"])})
    conv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    w = np.random.RandomState(5).randn(jm.hops[1].num_targets, 12 if concat else 4)
    w = w.astype(np.float32)
    jout, (jdp, jdx) = jax.value_and_grad(
        lambda p, r: jnp.sum(jconv.apply(p, r, jm.hops[1]) * w), argnums=(0, 1))(params, jx)
    tx = torch.from_numpy(x).requires_grad_()
    out = conv(tx, tm.hops[1])
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(jconv.apply(params, jx, jm.hops[1])), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    jg = params_from_jax({"GATConv_0": jax.tree.map(np.asarray, jdp["params"])})
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[f"convs.0.{name}"].numpy(), err_msg=name,
                                   **GRAD)


def test_sampled_gat_model_matches_jax():
    jm, tm, x, labels = _sampled(5)
    jmodel = JaxGNN(model_type="gat", hidden_dim=H, num_classes=C, num_layers=2, num_heads=4)
    model = HomoGNN(D, H, C, num_layers=2, model_type="gat", num_heads=4, device="cpu")
    _check_against_jax(jmodel, model, x, labels, {"sample": jm}, {"sample": tm})


def test_sampled_rgcn_matches_jax():
    """Edge types from the hops, then the same given explicitly."""
    jm, tm, x, labels = _sampled(6)
    jmodel = JaxGNN(model_type="rgcn", hidden_dim=H, num_classes=C, num_layers=2,
                    num_relations=R)
    model = HomoGNN(D, H, C, num_layers=2, model_type="rgcn", num_relations=R, device="cpu")
    logits = _check_against_jax(jmodel, model, x, labels, {"sample": jm}, {"sample": tm})
    with torch.no_grad():
        ets = [h.edge_type for h in tm.hops]
        assert torch.equal(model(torch.from_numpy(x), tm, edge_types=ets), logits)
        flipped = [(R - 1) - e for e in ets]  # other relations, other logits
        assert not torch.allclose(model(torch.from_numpy(x), tm, edge_types=flipped), logits)


def test_rgcn_conv_on_a_full_graph_matches_jax():
    rs, jg, tg = _graphs(7, add_reverse=True)
    x = rs.randn(N, D).astype(np.float32)
    labels = rs.randint(0, C, N).astype(np.int32)
    jfg, tfg = jg.to_full_graph(), tg.to_full_graph()
    jmodel = JaxGNN(model_type="rgcn", hidden_dim=H, num_classes=C, num_layers=2,
                    num_relations=R)
    model = HomoGNN(D, H, C, num_layers=2, model_type="rgcn", num_relations=R, device="cpu")
    _check_against_jax(jmodel, model, x, labels, {"graph": jfg}, {"graph": tfg})
    # one conv, the edge types given explicitly
    jconv, conv = JaxRGCNConv(out_dim=H, num_relations=R), RGCNConv(D, H, R)
    params = jconv.init(jax.random.PRNGKey(3), jnp.asarray(x), jfg)
    sd = params_from_jax({"RGCNConv_0": jax.tree.map(np.asarray, params["params"])})
    conv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    et = (R - 1) - tfg.edge_type
    out = conv(torch.from_numpy(x), tfg, et)
    np.testing.assert_allclose(
        _np(out), np.asarray(jconv.apply(params, jnp.asarray(x), jfg, jnp.asarray(et.numpy()))),
        **FWD)


@pytest.mark.parametrize("model_type", ["gcn", "gat", "rgcn"])
def test_full_graph_models_match_jax(model_type):
    """The sampled models' full-graph branches, GCN and GAT through kernel G's
    plain version and RGCN's segment mean."""
    rs, jg, tg = _graphs(8)
    x = rs.randn(N, D).astype(np.float32)
    labels = rs.randint(0, C, N).astype(np.int32)
    kw = dict(num_heads=2) if model_type == "gat" else dict(num_relations=R)
    jmodel = JaxGNN(model_type=model_type, hidden_dim=H, num_classes=C, num_layers=2, **kw)
    model = HomoGNN(D, H, C, num_layers=2, model_type=model_type, device="cpu", **kw)
    _check_against_jax(jmodel, model, x, labels, {"graph": jg.to_full_graph()},
                       {"graph": tg.to_full_graph()})


def test_gcn_true_degrees_with_full_fanout_equal_the_full_graph():
    """The port alone (as tests/test_models.py:253 for JAX): the sampled GCN
    in true mode with fanout >= the largest degree equals the port's
    full-graph GCN at the centres; block degrees do not."""
    rs, _, tg = _graphs(9)
    K = tg.max_degree
    feats = torch.from_numpy(rs.randn(N, D).astype(np.float32))
    model = HomoGNN(D, H, C, num_layers=2, model_type="gcn", degree_mode="true", device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    ml = tg.multilayer_sample(torch.arange(N, dtype=torch.int32), (K, K), seed=0,
                              with_degrees=True)
    x = feats[ml.unique_gids.long().clamp(max=N - 1)] * ml.unique_mask[:, None]
    with torch.no_grad():
        full = model(feats, graph=tg.to_full_graph())
        torch.testing.assert_close(model(x, ml), full, rtol=2e-5, atol=2e-5)
        for conv in model.convs:
            conv.degree_mode = "block"
        assert not torch.allclose(model(x, ml), full, atol=1e-3)


def test_rgcn_init_is_glorot_over_its_fans():
    model = HomoGNN(D, H, C, model_type="rgcn", num_relations=R, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(1))
    w = model.convs[0].w_rel
    limit = np.sqrt(6.0 / (R * D + R * H))
    w = w.detach()
    assert w.shape == (R, D, H) and float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit and float(model.convs[0].bias.abs().sum()) == 0.0
    with pytest.raises(InvalidInput):
        HomoGNN(D, H, C, model_type="rgcn", device="cpu")  # no relations


def test_resolve_framework_matches_jax():
    for name in ("wg", "native", "tpu", "dgl", "pyg", "cugraph"):
        assert resolve_framework(name) == jax_resolve_framework(name) == "native"


# ---------------------------------------------------------------------------
# the slice as a whole: three training steps of each model against JAX
# ---------------------------------------------------------------------------

CFG = SageTrainConfig(n_nodes=300, deg=8, dim=16, hidden=16, num_classes=4, batch=16,
                      fanouts=(3, 4))


@pytest.mark.parametrize("model_type,degree_mode", [("gcn", "block"), ("gcn", "true"),
                                                    ("gat", "auto"), ("rgcn", "auto")])
def test_three_steps_match_jax(model_type, degree_mode):
    """train_step of each model (the pseudo-relations of an RGCN run, the
    true degrees of GCN's true mode) against the same loop with the JAX
    package: losses and touched rows within 1e-5, untouched rows equal."""
    cfg = dataclasses.replace(CFG, model_type=model_type, degree_mode=degree_mode, num_heads=2)
    rs = np.random.RandomState(0)
    degs = rs.randint(cfg.deg // 2, cfg.deg + cfg.deg // 2 + 1, cfg.n_nodes)
    degs[:5] = 0
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, cfg.n_nodes, row_ptr[-1]).astype(np.int32)
    et = ((np.repeat(np.arange(cfg.n_nodes), degs) + col) % cfg.num_relations).astype(np.int32)
    table = (rs.randn(cfg.n_nodes, cfg.dim) / 4).astype(np.float32)
    labels_tab = rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32)
    batches = [rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32) for _ in range(3)]
    rgcn = model_type == "rgcn"
    with_deg = degree_mode == "true"

    g = JaxGraph(row_ptr=jnp.asarray(row_ptr), col=jnp.asarray(col), node_count=cfg.n_nodes,
                 edge_count=len(col), max_degree=int(degs.max()),
                 edge_type=jnp.asarray(et) if rgcn else None,
                 num_relations=cfg.num_relations if rgcn else 0)
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    emb = JaxEmbedding.create(mesh1, cfg.n_nodes, cfg.dim, optimizer=JaxLazyAdam())
    estate = emb.from_array(table)
    jmodel = JaxGNN(model_type=model_type, hidden_dim=cfg.hidden, num_classes=cfg.num_classes,
                    num_layers=2, num_heads=2, num_relations=cfg.num_relations,
                    degree_mode=degree_mode)
    ml0 = g.multilayer_sample(jnp.asarray(batches[0]), cfg.fanouts, seed=0, with_degrees=with_deg)
    params = jmodel.init(jax.random.PRNGKey(0), emb.gather(estate, ml0.unique_gids), sample=ml0)
    init_params = jax.tree.map(np.asarray, params)
    dense_opt = optax.adam(cfg.lr)
    opt_state = dense_opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, r, ml, y: jax_ce(jmodel.apply(p, r, sample=ml), y), argnums=(0, 1)))
    jlosses, touched = [], []
    for i, centers in enumerate(batches):
        ml = g.multilayer_sample(jnp.asarray(centers), cfg.fanouts, seed=i, with_degrees=with_deg)
        ids = ml.unique_gids
        rows = emb.gather(estate, ids) * ml.unique_mask[:, None]
        loss, (dp, dr) = grad_fn(params, rows, ml, jnp.asarray(labels_tab[centers]))
        updates, opt_state = dense_opt.update(dp, opt_state, params)
        params = optax.apply_updates(params, updates)
        estate = emb.apply_gradients(estate, ids, dr, cfg.lr, mask=ml.unique_mask,
                                     assume_unique=True)
        jlosses.append(float(loss))
        touched.append(np.asarray(ids)[np.asarray(ml.unique_mask)])

    model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, num_layers=2, model_type=model_type,
                    num_heads=2, num_relations=cfg.num_relations, degree_mode=degree_mode,
                    device="cpu")
    model.load_state_dict(params_from_jax(init_params))
    graph = GraphStructure(torch.from_numpy(row_ptr), torch.from_numpy(col), cfg.n_nodes,
                           edge_type=torch.from_numpy(et) if rgcn else None,
                           num_relations=cfg.num_relations if rgcn else 0)
    state = SageTrainState(cfg, graph, Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(),
                                                        device="cpu").from_array(table),
                           model, torch.optim.Adam(model.parameters(), lr=cfg.lr),
                           torch.from_numpy(labels_tab))
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        loss = train_step(state, c, state.labels[c.long()], seed=i)
        np.testing.assert_allclose(float(loss), jlosses[i], **FWD)
    rows = np.unique(np.concatenate(touched))
    np.testing.assert_allclose(state.embedding.to_array()[rows], emb.to_array(estate)[rows], **FWD)
    untouched = np.setdiff1d(np.arange(cfg.n_nodes), rows)
    np.testing.assert_array_equal(state.embedding.to_array()[untouched], table[untouched])


def test_build_synthetic_models():
    """Each model type builds and trains from the SAGE state's draws: the
    same graph and table; an RGCN run's pseudo-relations are (src + col) % R;
    the SAGE defaults are unchanged."""
    sage = build_synthetic(CFG, device="cpu", seed=1)
    c = torch.arange(CFG.batch, dtype=torch.int32)
    for mt in ("gcn", "gat", "rgcn"):
        st = build_synthetic(dataclasses.replace(CFG, model_type=mt), device="cpu", seed=1)
        assert torch.equal(st.graph.col, sage.graph.col)
        assert torch.equal(st.embedding.table, sage.embedding.table)
        assert st.model.model_type == mt
        if mt == "rgcn":
            src = torch.repeat_interleave(torch.arange(CFG.n_nodes),
                                          (st.graph.row_ptr[1:] - st.graph.row_ptr[:-1]).long())
            assert torch.equal(st.graph.edge_type, ((src + st.graph.col) % 2).to(torch.int32))
            assert st.graph.num_relations == 2
        else:
            assert st.graph.edge_type is None
        losses = [float(train_step(st, c, st.labels[c.long()], seed=0)) for _ in range(4)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert sage.graph.edge_type is None and sage.model.model_type == "sage"
