"""Port parity: full-graph message passing of wholegraph_tpu_torch (on the
CPU, where kernels G and H run their plain versions) against the JAX
package, from the same numpy-made graphs, features and weights.

Tolerances:
- COO ops (spmm, sddmm, edge_softmax) and the per-edge GAT path: f32 sums
  in another order, forward rtol/atol 1e-5, gradients 1e-4 (FWD, GRAD).
- spmm_window / sddmm_window and their VJPs against the JAX windowed
  kernels in interpret mode: 2e-4 (the JAX tests' own tolerance for these
  kernels; their f32-HIGHEST MXU passes round differently), WIN.
- SAGE and GCN models against the JAX windowed path
  (``to_full_graph(windowed=True)``): 2e-4 forward, 5e-4 gradients, the
  JAX tests' own (``test_models.py:571-579``), WIN_FWD / WIN_GRAD.
- GAT against the JAX per-edge path (``windowed=False``) at 1e-5 (FWD for
  both values and gradients); against the JAX windowed path, whose
  attention weights go through ``split2`` (about 2^-16 relative, quirk
  R3), at 3e-4 forward and 1e-3 gradients (GAT_FWD / GAT_GRAD).
- tile plans, graph attributes and ``clustered_csr``: exact.
- SAGE's project-first route against its concat route computed plainly:
  WIN_FWD forward, WIN_GRAD gradients (products and sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import host_sampler as hs
from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.models import HomoGNN as JaxGNN
from wholegraph_tpu.models import accuracy as jax_accuracy
from wholegraph_tpu.models import cross_entropy_loss as jax_ce
from wholegraph_tpu.models.conv import GATConv as JaxGAT
from wholegraph_tpu.ops import spmm as js
from wholegraph_tpu.ops import spmm_pallas as jp
import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import FullGraph, GATConv, HomoGNN, params_from_jax
from wholegraph_tpu_torch.models.conv import SAGEConv
from wholegraph_tpu_torch.ops import spmm as ts
from wholegraph_tpu_torch.ops import spmm_kernels as tk
from wholegraph_tpu_torch.utils import perf
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
WIN = dict(rtol=2e-4, atol=2e-4)
WIN_FWD, WIN_GRAD = dict(rtol=2e-4, atol=2e-4), dict(rtol=5e-4, atol=5e-4)
GAT_FWD, GAT_GRAD = dict(rtol=3e-4, atol=3e-4), dict(rtol=1e-3, atol=1e-3)


def _clustered(n, width, seed, lo=0, hi=8):
    """A locality-ordered CSR (degrees in [lo, hi), so rows may be empty)."""
    rs = np.random.RandomState(seed)
    counts = rs.randint(lo, hi, n)
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = (np.repeat(np.arange(n), counts)
           + rs.randint(-width // 2, width // 2 + 1, int(rp[-1]))).clip(0, n - 1).astype(np.int32)
    return rp, col, rs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coo(seed=2, E=300, N=40, D=8):
    rs = np.random.RandomState(seed)
    dst = np.sort(rs.randint(0, N, E)).astype(np.int32)
    src = rs.randint(0, N, E).astype(np.int32)
    return rs, src, dst, rs.randn(N, D).astype(np.float32)


# ---------------------------------------------------------------------------
# COO regime: spmm, sddmm, sddmm_chunked, edge_softmax, plan_spmm_tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce,weighted", [("sum", False), ("mean", False), ("max", False),
                                             ("sum", True), ("mean", True)])
def test_coo_spmm_and_grads_match_jax(reduce, weighted):
    rs, src, dst, x = _coo()
    N = x.shape[0]
    dst[dst == 5] = 6  # a destination with no edge
    dst.sort()
    w = rs.rand(len(src)).astype(np.float32) if weighted else None
    ct = rs.randn(N, x.shape[1]).astype(np.float32)

    def jf(x, w):
        return js.spmm(jnp.asarray(src), jnp.asarray(dst), x, N, reduce, edge_weight=w)

    args = (jnp.asarray(x), None if w is None else jnp.asarray(w))
    jout, vjp = jax.vjp(jf, *args)
    jgrads = vjp(jnp.asarray(np.where(np.isfinite(np.asarray(jout)), ct, 0.0)))
    tx = _t(x).requires_grad_()
    tw = None if w is None else _t(w).requires_grad_()
    out = ts.spmm(_t(src), _t(dst), tx, N, reduce, edge_weight=tw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    assert (out[5] == (-np.inf if reduce == "max" else 0)).all()
    finite = torch.isfinite(out)
    out.backward(torch.where(finite, _t(ct), 0.0))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[0]), **GRAD)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads[1]), **GRAD)


def test_coo_sddmm_and_chunked_match_jax():
    rs, src, dst, x = _coo(seed=3)
    b = rs.randn(*x.shape).astype(np.float32)
    ref = np.asarray(js.sddmm(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), jnp.asarray(b)))
    chunked = np.asarray(js.sddmm_chunked(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x),
                                          jnp.asarray(b), chunk=64))
    np.testing.assert_allclose(ts.sddmm(_t(src), _t(dst), _t(x), _t(b)).numpy(), ref, **FWD)
    for chunk in (64, 37, 1 << 20):
        got = ts.sddmm_chunked(_t(src), _t(dst), _t(x), _t(b), chunk=chunk).numpy()
        assert got.shape == (len(src),)
        np.testing.assert_allclose(got, chunked, **FWD)


@pytest.mark.parametrize("heads", [0, 3])  # [E] logits, and [E, H] (vmapped in JAX)
def test_edge_softmax_and_grad_match_jax(heads):
    rs, _, dst, _ = _coo(seed=4)
    N = 40
    shape = (len(dst),) + ((heads,) if heads else ())
    logits = (3 * rs.randn(*shape)).astype(np.float32)
    ct = rs.randn(*shape).astype(np.float32)

    def jf(lg):
        if not heads:
            return js.edge_softmax(jnp.asarray(dst), lg, N)
        return jax.vmap(lambda c: js.edge_softmax(jnp.asarray(dst), c, N), 1, 1)(lg)

    jout, vjp = jax.vjp(jf, jnp.asarray(logits))
    (jd,) = vjp(jnp.asarray(ct))
    tl = _t(logits).requires_grad_()
    out = ts.edge_softmax(_t(dst), tl, N)
    out.backward(_t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jd), **GRAD)


@pytest.mark.parametrize("case", ["clustered", "empty_tiles", "random_infeasible", "bench_like"])
def test_plan_spmm_tiles_matches_jax(case):
    if case == "clustered":
        rp, col, _ = _clustered(2000, 96, seed=1)
        tile = 256
    elif case == "empty_tiles":  # rows 300-899 empty: whole tiles without edges
        rs = np.random.RandomState(2)
        counts = rs.randint(0, 3, 1500)
        counts[300:900] = 0
        rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        col = (np.repeat(np.arange(1500), counts)
               + rs.randint(-30, 31, int(rp[-1]))).clip(0, 1499).astype(np.int32)
        tile = 128
    elif case == "random_infeasible":
        rp, col = hs.random_csr(20_000, avg_deg=6, seed=8)
        tile = 256
    else:
        g = wt.clustered_csr(1 << 14, 16, 192, device="cpu")
        rp, col = g.row_ptr.numpy(), g.col.numpy()
        tile = 256
    want = js.plan_spmm_tiles(rp, col, tile=tile)
    got = ts.plan_spmm_tiles(rp, col, tile=tile)
    assert got == want and isinstance(got[2], bool)
    assert got[2] == (case != "random_infeasible")


# ---------------------------------------------------------------------------
# spmm_window / sddmm_window (kernels G and H) against the JAX custom VJPs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window_graph():
    """A feasible clustered CSR with empty rows, features and cotangents."""
    rp, col, rs = _clustered(600, 80, seed=5, lo=0, hi=8)
    assert (np.diff(rp) == 0).any()
    n, dim = 600, 128
    window, edge_cap, feasible = js.plan_spmm_tiles(rp, col, tile=256)
    assert feasible
    x = rs.randn(n, dim).astype(np.float32)
    b = rs.randn(n, dim).astype(np.float32)
    w = rs.rand(len(col)).astype(np.float32)
    ct = rs.randn(n, dim).astype(np.float32)
    ct_e = rs.randn(len(col)).astype(np.float32)
    return dict(rp=rp, col=col, x=x, b=b, w=w, ct=ct, ct_e=ct_e, window=window, edge_cap=edge_cap)


@pytest.mark.parametrize("reduce,weighted", [("sum", False), ("mean", False), ("sum", True)])
def test_spmm_window_and_vjp_match_jax(window_graph, reduce, weighted):
    g = window_graph
    plan = dict(window=g["window"], edge_cap=g["edge_cap"])
    args = [jnp.asarray(g["x"])] + ([jnp.asarray(g["w"])] if weighted else [])

    def jf(x, w=None):
        return jp.spmm_window(jnp.asarray(g["rp"]), jnp.asarray(g["col"]), x, reduce=reduce,
                              edge_weight=w, **plan)

    jout, vjp = jax.vjp(jf, *args)
    jgrads = vjp(jnp.asarray(g["ct"]))
    tx = _t(g["x"]).requires_grad_()
    tw = _t(g["w"]).requires_grad_() if weighted else None
    out = tk.spmm_window(_t(g["rp"]), _t(g["col"]), tx, reduce=reduce, edge_weight=tw, **plan)
    assert out.dtype == torch.float32 and out.shape == tx.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **WIN)
    assert not out.detach()[np.diff(g["rp"]) == 0].any()  # empty rows give zero
    out.backward(_t(g["ct"]))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[0]), **WIN)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads[1]), **WIN)


def test_spmm_window_weight_grad_off_gives_zeros(window_graph):
    g = window_graph
    tw = _t(g["w"]).requires_grad_()
    tk.spmm_window(_t(g["rp"]), _t(g["col"]), _t(g["x"]), window=g["window"],
                   edge_cap=g["edge_cap"], edge_weight=tw, weight_grad=False).sum().backward()
    assert tw.grad is not None and not tw.grad.any()


def test_sddmm_window_and_vjp_match_jax(window_graph):
    g = window_graph
    plan = dict(window=g["window"], edge_cap=g["edge_cap"])
    jout, vjp = jax.vjp(lambda a, b: jp.sddmm_window(jnp.asarray(g["rp"]), jnp.asarray(g["col"]),
                                                      a, b, **plan),
                        jnp.asarray(g["x"]), jnp.asarray(g["b"]))
    jda, jdb = vjp(jnp.asarray(g["ct_e"]))
    ta, tb = _t(g["x"]).requires_grad_(), _t(g["b"]).requires_grad_()
    out = tk.sddmm_window(_t(g["rp"]), _t(g["col"]), ta, tb, **plan)
    assert out.shape == (len(g["col"]),) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **WIN)
    out.backward(_t(g["ct_e"]))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), **WIN)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **WIN)


def test_window_entry_points_reject_what_jax_rejects(window_graph):
    g = window_graph
    rp, col, x, w = _t(g["rp"]), _t(g["col"]), _t(g["x"]), _t(g["w"])
    plan = dict(window=g["window"], edge_cap=g["edge_cap"])
    with pytest.raises(InvalidInput, match="weighted mean"):
        tk.spmm_window(rp, col, x, reduce="mean", edge_weight=w, **plan)
    with pytest.raises(InvalidInput):
        tk.spmm_window(rp, col, x, reduce="max", **plan)
    with pytest.raises(InvalidInput):
        tk.spmm_window(rp, col, x, weight_precision="fp8", **plan)
    with pytest.raises(InvalidInput, match="dim mismatch"):
        tk.sddmm_window(rp, col, x, x[:, :64], **plan)
    with pytest.raises(InvalidInput, match="num_dst"):
        tk.sddmm_window(rp, col, x[:-1], x, **plan)
    with pytest.raises(InvalidInput):
        tk.sddmm_window(rp, col, x, x, select_mode="bf16", **plan)
    # no dim % 128 rule: a 48-wide x runs
    assert tk.spmm_window(rp, col, x[:, :48].contiguous(), **plan).shape == (600, 48)


# ---------------------------------------------------------------------------
# to_full_graph, FullGraph, clustered_csr
# ---------------------------------------------------------------------------


def _graphs(rp, col, n):
    jg = JaxGraph(row_ptr=jnp.asarray(rp), col=jnp.asarray(col), node_count=n,
                  edge_count=len(col), max_degree=int(np.diff(rp).max()))
    return jg, GraphStructure(_t(rp), _t(col), n)


@pytest.mark.parametrize("windowed", [False, True])
def test_to_full_graph_matches_jax(windowed):
    rp, col, _ = _clustered(700, 70, seed=6)
    jg, tg = _graphs(rp, col, 700)
    jfg, tfg = jg.to_full_graph(windowed=windowed), tg.to_full_graph(windowed=windowed)
    assert tfg.num_nodes == jfg.num_nodes == 700
    assert tfg.edge_src.dtype == tfg.edge_dst.dtype == torch.int32
    np.testing.assert_array_equal(tfg.edge_src.numpy(), np.asarray(jfg.edge_src))
    np.testing.assert_array_equal(tfg.edge_dst.numpy(), np.asarray(jfg.edge_dst))
    np.testing.assert_array_equal(tfg.row_ptr.numpy(), rp)  # the port always carries the CSR
    assert (tfg.window, tfg.edge_cap) == (jfg.window, jfg.edge_cap)
    assert (tfg.window is not None) == windowed
    t_rp, t_col, perm = tfg.transposed()
    assert tfg.transposed()[0] is t_rp  # built once


def test_to_full_graph_infeasible_plan_records_none():
    n = 20_000
    rp, col = hs.random_csr(n, avg_deg=6, seed=8)
    jfg = _graphs(rp, col, n)[0].to_full_graph(windowed=True)
    tfg = GraphStructure(_t(rp.astype(np.int32)), _t(col.astype(np.int32)), n).to_full_graph(
        windowed=True)
    assert jfg.window is None and tfg.window is None and tfg.edge_cap is None
    assert tfg.row_ptr is not None


def test_full_graph_from_a_coo_builds_its_csr():
    rs, src, dst, x = _coo(seed=7)
    fg = FullGraph(_t(src), _t(dst), 40)
    assert fg.row_ptr.dtype == torch.int32
    np.testing.assert_array_equal(fg.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=40))]))
    with pytest.raises(InvalidInput, match="sorted"):
        FullGraph(_t(src), _t(dst[::-1].copy()), 40)
    with pytest.raises(InvalidInput, match="sorted"):
        FullGraph(_t(src), _t(dst), 10)  # ids past num_nodes


def test_clustered_csr_is_the_bench_graph():
    n, deg, width = 5000, 16, 192
    # the numpy lines of bench_spmm_clustered (bench.py:406-412)
    rs = np.random.RandomState(0)
    counts = rs.randint(max(deg // 2, 1), deg * 2, n)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = (np.repeat(np.arange(n), counts)
           + rs.randint(-width // 2, width // 2 + 1, int(row_ptr[-1]))).clip(0, n - 1).astype(np.int32)
    g = wt.clustered_csr(n, deg, width, device="cpu")
    assert g.row_ptr.dtype == g.col.dtype == torch.int32
    np.testing.assert_array_equal(g.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(g.col.numpy(), col)
    assert g.node_count == n and g.edge_count == len(col)
    assert not np.array_equal(wt.clustered_csr(n, deg, width, seed=1, device="cpu").col.numpy(),
                              col)


# ---------------------------------------------------------------------------
# SAGE, GCN and GAT HomoGNN over a FullGraph, through params_from_jax
# ---------------------------------------------------------------------------


def _model_case(model_type, n=600, D=128, C=4, hidden=128):
    rp, col, rs = _clustered(n, 80, seed=7, lo=0, hi=9)
    jg, tg = _graphs(rp, col, n)
    feats = rs.randn(n, D).astype(np.float32)
    centers = rs.choice(n, 64, replace=False).astype(np.int32)
    labels = rs.randint(0, C, 64).astype(np.int32)
    jmodel = JaxGNN(model_type=model_type, hidden_dim=hidden, num_classes=C, num_layers=2)
    jfg_plain = jg.to_full_graph()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats), graph=jfg_plain)
    model = HomoGNN(D, hidden, C, num_layers=2, model_type=model_type, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jg, tg, jmodel, params, model, feats, centers, labels


def _jax_value_and_grad(jmodel, params, feats, fg, centers, labels):
    def loss(p, x):
        return jax_ce(jmodel.apply(p, x, graph=fg)[centers], jnp.asarray(labels))

    logits = jmodel.apply(params, jnp.asarray(feats), graph=fg)
    l, (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1))(params, jnp.asarray(feats))
    return np.asarray(logits), float(l), params_from_jax(jax.tree.map(np.asarray, dp)), np.asarray(dx)


def _assert_model(got, want, fwd, grad):
    logits, loss, grads, dx = got
    jlogits, jl, jgrads, jdx = want
    np.testing.assert_allclose(logits, jlogits, **fwd)
    np.testing.assert_allclose(loss, jl, **fwd)
    np.testing.assert_allclose(dx, jdx, **grad)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name].numpy(), err_msg=name, **grad)


@pytest.mark.parametrize("model_type", ["sage", "gcn", "gat"])
def test_full_graph_model_matches_jax(model_type):
    jg, tg, jmodel, params, model, feats, centers, labels = _model_case(model_type)
    tfg = tg.to_full_graph(windowed=True)
    with torch.no_grad():
        logits = model(_t(feats), graph=tfg).numpy()
    loss, (grads, dx) = wt.full_graph_value_and_grad(model, _t(feats), tfg, _t(centers),
                                                     _t(labels))
    got = (logits, float(loss), {k: v.numpy() for k, v in grads.items()}, dx.numpy())
    assert all(p.grad is None for p in model.parameters())
    jfg_win = jg.to_full_graph(windowed=True)
    assert jfg_win.window is not None
    if model_type == "gat":
        # GAT first against the JAX per-edge path, then against its windowed one
        _assert_model(got, _jax_value_and_grad(jmodel, params, feats, jg.to_full_graph(),
                                               centers, labels), FWD, FWD)
        _assert_model(got, _jax_value_and_grad(jmodel, params, feats, jfg_win, centers, labels),
                      GAT_FWD, GAT_GRAD)
        assert np.abs(got[2]["convs.0.attn_src"]).max() > 0
    else:
        _assert_model(got, _jax_value_and_grad(jmodel, params, feats, jfg_win, centers, labels),
                      WIN_FWD, WIN_GRAD)


@pytest.mark.parametrize("add_self_loop", [True, False])
def test_gat_layer_matches_jax_per_edge_path(add_self_loop):
    """GATConv (edge softmax + kernel G per head; attention gradients
    through kernel H) against the JAX per-edge path, with empty rows, 4
    heads of 64 and the heads averaged."""
    rp, col, rs = _clustered(500, 60, seed=8, lo=0, hi=7)
    jg, tg = _graphs(rp, col, 500)
    feats = rs.randn(500, 48).astype(np.float32)
    ct = rs.randn(500, 64).astype(np.float32)
    jlayer = JaxGAT(out_dim=64, num_heads=4, add_self_loop=add_self_loop, concat_heads=False)
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(feats), jg.to_full_graph())
    jout, vjp = jax.vjp(lambda p, x: jlayer.apply(p, x, jg.to_full_graph()), params,
                        jnp.asarray(feats))
    jdp, jdx = vjp(jnp.asarray(ct))
    layer = GATConv(48, 64, num_heads=4, add_self_loop=add_self_loop, concat_heads=False)
    sd = params_from_jax({"GATConv_0": jax.tree.map(np.asarray, params["params"])})
    layer.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    tx = _t(feats).requires_grad_()
    out = layer(tx, tg.to_full_graph())
    out.backward(_t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    jgrads = jax.tree.map(np.asarray, jdp["params"])
    for name in ("attn_src", "attn_dst"):
        np.testing.assert_allclose(getattr(layer, name).grad.numpy(), jgrads[name], **GRAD)
    np.testing.assert_allclose(layer.proj.weight.grad.numpy(), jgrads["proj"]["kernel"].T, **GRAD)


def test_eval_full_graph_matches_jax():
    jg, tg, jmodel, params, model, feats, centers, labels = _model_case("sage")
    emb = wt.embedding.Embedding.create(600, 128, device="cpu").from_array(feats)
    loss, acc = wt.eval_full_graph(model, emb, tg.to_full_graph(windowed=True), _t(centers),
                                   _t(labels))
    logits = jmodel.apply(params, jnp.asarray(feats), graph=jg.to_full_graph(windowed=True))
    np.testing.assert_allclose(float(loss), float(jax_ce(logits[centers], jnp.asarray(labels))),
                               **WIN_FWD)
    assert float(acc) == float(jax_accuracy(logits[centers], jnp.asarray(labels)))


def test_full_graph_config_defaults_are_the_bench_shapes():
    cfg = wt.FullGraphConfig()
    assert (cfg.n_nodes, cfg.deg, cfg.width, cfg.dim) == (1 << 20, 16, 192, 256)
    assert (cfg.model_type, cfg.aggregator, cfg.hidden, cfg.num_classes, cfg.num_layers) == (
        "sage", "mean", 256, 16, 2)
    small = dataclasses.replace(cfg, n_nodes=300, dim=16, hidden=16, model_type="gcn")
    st = wt.build_full_graph(small, device="cpu", seed=3)
    assert st.fg.num_nodes == 300 and st.fg.window is not None
    assert st.embedding.table.shape == (300, 16) and st.labels.shape == (300,)


# ---------------------------------------------------------------------------
# SAGE on a full graph: project first where the layer narrows
# ---------------------------------------------------------------------------


def _project_first_spans(fn):
    """``fn()``'s result and its count of ``sage.project_first`` spans."""
    with perf.Timeline(device="cpu") as tl:
        out = fn()
    return out, sum(s.name == "sage.project_first" for s in tl.spans())


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
@pytest.mark.parametrize("din,dout", [(100, 47), (64, 8), (32, 32), (16, 40)])
def test_sage_full_graph_routes_match_the_concat_route(din, dout, aggregator):
    """SAGEConv on a FullGraph against ``proj(cat[x, agg(x)])`` with the
    COO aggregation of plain PyTorch: forward and the gradients of x,
    ``proj.weight`` and ``proj.bias``. It projects first (one span) where
    the aggregation is a sum or mean and ``round_up(dout, 4) < din``; empty
    rows give zeros there (the max, whose empty rows are -inf, runs on a
    graph without them)."""
    n = 300
    rp, col, rs = _clustered(n, 40, seed=11, lo=0 if aggregator != "max" else 1, hi=9)
    fg = GraphStructure(_t(rp), _t(col), n).to_full_graph(windowed=True)
    conv = SAGEConv(din, dout, aggregator=aggregator, device="cpu")
    with torch.no_grad():
        conv.proj.bias.copy_(torch.from_numpy(rs.randn(dout).astype(np.float32)))
    x = _t(rs.randn(n, din).astype(np.float32)).requires_grad_()
    ct = _t(rs.randn(n, dout).astype(np.float32))
    out, spans = _project_first_spans(lambda: conv(x, fg))
    assert out.shape == (n, dout)
    assert spans == int(aggregator != "max" and -(-dout // 4) * 4 < din)
    out.backward(ct)
    got = [t.grad.clone() for t in (x, conv.proj.weight, conv.proj.bias)]

    for t in (x, conv.proj.weight, conv.proj.bias):
        t.grad = None
    xn = ts.spmm(fg.edge_src, fg.edge_dst, x, n, aggregator)
    want = conv.proj(torch.cat([x, xn], dim=-1))
    want.backward(ct)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), **WIN_FWD)
    for name, g, t in zip(("x", "proj.weight", "proj.bias"), got,
                          (x, conv.proj.weight, conv.proj.bias)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=name, **WIN_GRAD)


def test_sage_stack_projects_first_once_in_a_full_graph_pass():
    """The benchmark's SAGE stack, 100 -> 256 -> 256 -> 47 (mean): a
    full-graph forward has one ``sage.project_first`` span (the last layer)
    and three ``fg_spmm``; a sampled forward has none."""
    n = 400
    rp, col, rs = _clustered(n, 60, seed=12, lo=1, hi=9)
    tg = GraphStructure(_t(rp), _t(col), n)
    model = HomoGNN(100, 256, 47, num_layers=3, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    feats = _t(rs.randn(n, 100).astype(np.float32))
    with perf.Timeline(device="cpu") as tl, torch.no_grad():
        model(feats, graph=tg.to_full_graph(windowed=True))
    names = [s.name for s in tl.spans()]
    assert names.count("sage.project_first") == 1 and names.count("fg_spmm") == 3
    ml = tg.multilayer_sample(torch.arange(64, dtype=torch.int32), (5, 4, 3), seed=0)
    x = feats[ml.unique_gids.long().clamp(max=n - 1)] * ml.unique_mask[:, None]
    with torch.no_grad():
        _, spans = _project_first_spans(lambda: model(x, ml))
    assert spans == 0
