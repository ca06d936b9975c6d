"""The scanned epoch, on the CPU: ``train.train_epoch`` (the port of the JAX
example's ``train_epoch_scan``, ``examples/node_classification.py:258-275``)
and what it stands on: the tensor seed of the sampler, LazyAdam's
corrections as tensors, and the cache's in-place forms.

Bit for bit: ``train_epoch`` over S steps against S ``train_step`` calls
(losses, table, m, v, dense parameters, the cache's valid bits), with and
without a hot cache, uniform and weighted, with and without dropout; a
tensor seed against the int seed; LazyAdam with a ``step_table`` row
against the int step; the in-place cache functions against the functional
ones. Within ``test_torch_train.py``'s tolerances (rtol/atol 1e-5): a
3-step port epoch against a JAX ``lax.scan`` over the same body as that
file's ``_jax_loop``, weights carried across by ``models/convert.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import CFG, TOL, _data
from wholegraph_tpu.embedding import Embedding as JaxEmbedding
from wholegraph_tpu.embedding import LazyAdam as JaxLazyAdam
from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.models import HomoGNN as JaxGNN
from wholegraph_tpu.models import cross_entropy_loss as jax_ce
from wholegraph_tpu_torch import build_synthetic, train_step
from wholegraph_tpu_torch import train as T
from wholegraph_tpu_torch.embedding import (AdaGrad, Embedding, LazyAdam, RMSProp, SGD,
                                            build_hot_cache, hot_ids_by_degree,
                                            invalidate_touched, invalidate_touched_,
                                            refresh_hot_cache, refresh_hot_cache_)
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN, params_from_jax
from wholegraph_tpu_torch.ops.sampling import csr_sample_neighbors
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

S = 3
SEED0 = 40  # the epoch's global step: seeds 40, 41, 42


def _cfg(**kw):
    return dataclasses.replace(CFG, n_nodes=400, **kw)


def _state(cfg, cache):
    st = build_synthetic(cfg, device="cpu", seed=5)
    if cache:
        st.cache = build_hot_cache(st.embedding.as_sharded_table(),
                                   hot_ids_by_degree(st.graph.row_ptr, 0.3))
    return st


def _batches(cfg, st):
    rs = np.random.RandomState(9)
    c = torch.from_numpy(rs.randint(0, cfg.n_nodes, (S, cfg.batch)).astype(np.int32))
    return c, st.labels[c.long()]


def _gen(dropout):
    return torch.Generator().manual_seed(3) if dropout else None


def _same_state(a, b):
    assert torch.equal(a.embedding.table, b.embedding.table)
    for s in a.embedding.slots:
        assert torch.equal(a.embedding.slots[s], b.embedding.slots[s]), s
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert a.embedding.step == b.embedding.step
    if a.cache is not None:
        assert torch.equal(a.cache.valid, b.cache.valid)
        assert torch.equal(a.cache.values, b.cache.values)


CASES = {
    "uniform": dict(),
    "weighted": dict(sample_method="weighted"),
    "uniform_cache": dict(cache=True),
    "weighted_cache": dict(sample_method="weighted", cache=True),
    "uniform_dropout": dict(dropout=True),
    "weighted_cache_dropout": dict(sample_method="weighted", cache=True, dropout=True),
    "gcn_dropout": dict(model_type="gcn", dropout=True),
    "gat": dict(model_type="gat"),
    "rgcn_cache": dict(model_type="rgcn", cache=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_epoch_is_its_steps_bit_for_bit(case):
    """S steps of train_epoch (the step a CUDA graph captures: inputs, seed
    and corrections read at a step counter on the device, the cache
    cleared in place) equal S train_step calls with int seeds, bit for bit;
    a second epoch carries on from the first."""
    kw = dict(CASES[case])
    cache, dropout = kw.pop("cache", False), kw.pop("dropout", False)
    cfg = _cfg(**kw)
    eager, scanned = _state(cfg, cache), _state(cfg, cache)
    c, y = _batches(cfg, eager)
    ga, gb = _gen(dropout), _gen(dropout)
    for epoch in range(2):
        want = torch.stack([train_step(eager, c[i], y[i], SEED0 + epoch * S + i, generator=ga)
                            for i in range(S)])
        got = T.train_epoch(scanned, c, y, torch.arange(S) + SEED0 + epoch * S, generator=gb)
        assert got.shape == (S,) and torch.equal(got, want), (got, want)
        _same_state(eager, scanned)
    assert scanned.embedding.step == 2 * S
    if cache:  # the epoch's cache is the one it started with, cleared in place
        assert not scanned.cache.valid.all()


def test_epoch_matches_a_jax_scan():
    """A 3-step port epoch against ``lax.scan`` over ``_jax_loop``'s body
    (multilayer_sample, gather x unique_mask, SAGE forward/backward,
    optax.adam, LazyAdam apply with assume_unique) from the same graph,
    table, weights and batches."""
    cfg = CFG
    row_ptr, col, table, labels_tab, batches = _data()
    g = JaxGraph(row_ptr=jnp.asarray(row_ptr), col=jnp.asarray(col), node_count=cfg.n_nodes,
                 edge_count=len(col), max_degree=int(np.diff(row_ptr).max()))
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    emb = JaxEmbedding.create(mesh1, cfg.n_nodes, cfg.dim, optimizer=JaxLazyAdam())
    estate = emb.from_array(table)
    model = JaxGNN(model_type="sage", hidden_dim=cfg.hidden, num_classes=cfg.num_classes,
                   num_layers=2)
    ml0 = g.multilayer_sample(jnp.asarray(batches[0]), cfg.fanouts, seed=0)
    params = model.init(jax.random.PRNGKey(0), emb.gather(estate, ml0.unique_gids), sample=ml0)
    init_params = jax.tree.map(np.asarray, params)
    dense_opt = optax.adam(cfg.lr)
    labels_j = jnp.asarray(labels_tab)

    @jax.jit
    def epoch(params, estate, opt_state, centers_s, seeds):
        def body(carry, batch):
            params, estate, opt_state = carry
            centers, seed = batch
            ml = g.multilayer_sample(centers, cfg.fanouts, seed=seed)
            ids = ml.unique_gids
            labels = jnp.take(labels_j, centers, mode="clip")
            rows = emb.gather(estate, ids) * ml.unique_mask[:, None]

            def loss_fn(p, r):
                return jax_ce(model.apply(p, r, sample=ml), labels)

            loss, (dp, dr) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, rows)
            updates, opt_state = dense_opt.update(dp, opt_state, params)
            params = optax.apply_updates(params, updates)
            estate = emb.apply_gradients(estate, ids, dr, cfg.lr, mask=ml.unique_mask,
                                         assume_unique=True)
            return (params, estate, opt_state), loss

        (params, estate, opt_state), losses = jax.lax.scan(
            body, (params, estate, opt_state), (centers_s, seeds))
        return params, estate, losses

    centers_s = np.stack(batches)
    seeds = np.arange(S, dtype=np.int32) + SEED0
    _, jstate, jlosses = epoch(params, estate, dense_opt.init(params), jnp.asarray(centers_s),
                               jnp.asarray(seeds))
    touched = np.unique(np.concatenate([
        np.asarray(m.unique_gids)[np.asarray(m.unique_mask)]
        for m in (g.multilayer_sample(jnp.asarray(c), cfg.fanouts, seed=int(s))
                  for c, s in zip(batches, seeds))]))

    tmodel = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, num_layers=2, device="cpu")
    tmodel.load_state_dict(params_from_jax(init_params))
    temb = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device="cpu")
    temb.from_array(table)
    state = T.SageTrainState(
        cfg, GraphStructure(torch.from_numpy(row_ptr), torch.from_numpy(col), cfg.n_nodes),
        temb, tmodel, torch.optim.Adam(tmodel.parameters(), lr=cfg.lr),
        torch.from_numpy(labels_tab))
    c = torch.from_numpy(centers_s)
    losses = T.train_epoch(state, c, state.labels[c.long()], torch.from_numpy(seeds))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    jtable, jm = emb.to_array(jstate), emb.slot_to_array(jstate, "m")
    np.testing.assert_allclose(temb.to_array()[touched], jtable[touched], **TOL)
    np.testing.assert_allclose(temb.slot_to_array("m")[touched], jm[touched], **TOL)
    untouched = np.setdiff1d(np.arange(cfg.n_nodes), touched)
    np.testing.assert_array_equal(temb.to_array()[untouched], table[untouched])
    assert temb.step == S


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 2**31, 2**32 + 5, -1, -(2**40) + 3])
def test_tensor_seed_is_the_int_seed(seed, weighted):
    """A 0-dim integer tensor seed samples as the int does, bit for bit,
    the uint32 wrap of seeds of 2^31 and more and of negative seeds
    included (int64 and int32 tensors where the value fits)."""
    rs = np.random.RandomState(2)
    degs = rs.randint(0, 30, 200)
    rp = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32))
    col = torch.from_numpy(rs.randint(0, 200, int(rp[-1])).astype(np.int32))
    w = torch.from_numpy(rs.rand(int(rp[-1])).astype(np.float32) + 0.1) if weighted else None
    centers = torch.from_numpy(rs.randint(-3, 203, 64).astype(np.int32))
    kw = dict(weights=w, max_degree=int(degs.max()))
    for hop in (0, 1):
        want = csr_sample_neighbors(rp, col, centers, 12, seed=seed, hop=hop, **kw)
        dtypes = [torch.int64] + ([torch.int32] if -2**31 <= seed < 2**31 else [])
        for dt in dtypes:
            got = csr_sample_neighbors(rp, col, centers, 12, seed=torch.tensor(seed, dtype=dt),
                                       hop=hop, **kw)
            for f in ("neighbors", "mask", "positions", "edge_ids", "degree"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (f, dt, hop)
    g = GraphStructure(rp, col, 200, edge_weight=w)
    a = g.multilayer_sample(centers.clamp(0, 199), (4, 3), seed=seed, weighted=weighted)
    b = g.multilayer_sample(centers.clamp(0, 199), (4, 3), seed=torch.tensor(seed),
                            weighted=weighted)
    assert torch.equal(a.unique_gids, b.unique_gids) and torch.equal(a.unique_mask, b.unique_mask)
    for ha, hb in zip(a.hops, b.hops):
        assert torch.equal(ha.nbr_idx, hb.nbr_idx) and torch.equal(ha.mask, hb.mask)


@pytest.mark.parametrize("opt", [LazyAdam(), LazyAdam(adam_w=True, weight_decay=0.01),
                                 LazyAdam(weight_decay=0.1, beta1=0.8), SGD(weight_decay=0.1),
                                 AdaGrad(), RMSProp()], ids=lambda o: repr(o))
def test_step_table_row_is_the_int_step(opt):
    """``update`` with a row of ``step_table`` equals the update at the int
    step bit for bit (LazyAdam's corrections; the others do not depend on
    the step and have an empty row); through ``apply_gradients`` the table
    and slots agree too, and ``step`` is left to the caller."""
    rs = np.random.RandomState(4)
    rows = torch.from_numpy(rs.randn(50, 8).astype(np.float32))
    grads = torch.from_numpy(rs.randn(50, 8).astype(np.float32) * 1e-2)
    slots = {s: torch.from_numpy(np.abs(rs.randn(50, 8)).astype(np.float32) * 1e-3)
             for s in opt.slot_names}
    steps = [1, 2, 3, 999, 123456]
    table = opt.step_table(steps, "cpu")
    assert table.shape == (len(steps), 2 if isinstance(opt, LazyAdam) else 0)
    for i, t in enumerate(steps):
        want = opt.update(rows, grads, slots, t, 0.01)
        got = opt.update(rows, grads, slots, table[i], 0.01)
        assert torch.equal(got[0], want[0])
        for s in slots:
            assert torch.equal(got[1][s], want[1][s])
    a = Embedding.create(50, 8, optimizer=opt, device="cpu").from_array(rows.numpy())
    b = Embedding.create(50, 8, optimizer=opt, device="cpu").from_array(rows.numpy())
    ids = torch.from_numpy(rs.permutation(50)[:30].astype(np.int64))
    for i in range(3):
        a.apply_gradients(ids, grads[:30], 0.01, assume_unique=True)
        b.apply_gradients(ids, grads[:30], 0.01, assume_unique=True, corrections=table[i])
    assert a.step == 3 and b.step == 0
    assert torch.equal(a.table, b.table)
    for s in a.slots:
        assert torch.equal(a.slots[s], b.slots[s])


def test_corrections_refuse_unique_chunk():
    """The apply of a replayed step refuses ``unique_chunk``, whose last
    valid id is read on the host, naming its ROADMAP item."""
    e = Embedding.create(10, 4, optimizer=LazyAdam(), device="cpu")
    with pytest.raises(InvalidInput, match="Queue 4 item 15"):
        e.apply_gradients(torch.arange(10), torch.zeros(10, 4), 0.1, unique_chunk=1024,
                          corrections=e.optimizer.step_table([1], "cpu")[0])


def test_in_place_cache_forms_are_the_functional_ones():
    rs = np.random.RandomState(6)
    st = build_synthetic(_cfg(), device="cpu", seed=1)
    tab = st.embedding.as_sharded_table()
    hot = hot_ids_by_degree(st.graph.row_ptr, 0.4)
    cache = build_hot_cache(tab, hot)
    ids = torch.from_numpy(np.concatenate([rs.randint(-2, 402, 300), hot[:5]]).astype(np.int32))
    want = invalidate_touched(cache, ids)
    assert not torch.equal(want.valid, cache.valid)
    valid0 = cache.valid
    got = invalidate_touched_(cache, ids)
    assert got is cache and cache.valid is valid0 and torch.equal(cache.valid, want.valid)
    st.embedding.table.add_(1.0)  # the table moves on: a refill reads it anew
    want = refresh_hot_cache(tab, cache)
    values0 = cache.values
    got = refresh_hot_cache_(tab, cache)
    assert got is cache and cache.values is values0 and cache.valid is valid0
    assert torch.equal(cache.values, want.values) and torch.equal(cache.valid, want.valid)
    assert cache.valid.all()


def test_epoch_refusals(monkeypatch):
    """The host tier raises naming its ROADMAP item (the apply refuses
    ``unique_chunk`` beside corrections: above); a CUDA graph needs a
    capturable dense Adam. World > 1 is refused no more: there the epoch
    runs the step once a batch, its row, seed and corrections read on the
    device, with a dense Adam that is not capturable and no graph kept
    (the real world-4 runs are in ``test_torch_scan_epoch_world.py``)."""
    cfg = _cfg()
    host = build_synthetic(cfg, device="cpu", seed=0, host_cache_ratio=0.25)
    c = torch.zeros((S, cfg.batch), dtype=torch.int32)
    with pytest.raises(InvalidInput, match="host tier.*Queue 4 item 15"):
        T.train_epoch(host, c, c, range(S))
    st = build_synthetic(cfg, device="cpu")
    with pytest.raises(InvalidInput, match="capturable"):
        T.check_scannable(st, graphed=True)
    T.check_scannable(st, graphed=False)
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=cfg.lr, capturable=True)
    T.check_scannable(st, graphed=True)
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=cfg.lr)
    monkeypatch.setattr(Embedding, "world", property(lambda self: 4))
    calls = []

    def step(state, centers, labels, seed, generator, corrections):
        calls.append((centers.clone(), int(seed), corrections.clone()))
        return torch.tensor(float(len(calls)))

    monkeypatch.setattr(T, "_step_body", step)  # train_step's body, inside the epoch's step span
    c = torch.arange(S * cfg.batch, dtype=torch.int32).view(S, -1)
    losses = T.train_epoch(st, c, c, torch.arange(S) + SEED0)
    assert torch.equal(losses, torch.arange(1.0, S + 1))
    assert [s for _, s, _ in calls] == list(range(SEED0, SEED0 + S))
    assert all(torch.equal(ci, c[i]) for i, (ci, _, _) in enumerate(calls))
    want = st.embedding.optimizer.step_table(range(1, S + 1), "cpu")
    assert all(torch.equal(k, want[i]) for i, (_, _, k) in enumerate(calls))
    assert st.epoch_graph is None and st.embedding.step == S


def test_a_replaced_buffer_changes_what_the_graph_reads():
    """``_reads`` (what decides a new capture) moves when the cache, the
    table or a parameter is replaced, and stays under the in-place forms."""
    st = _state(_cfg(), cache=True)
    c, y = _batches(st.config, st)
    T.train_epoch(st, c, y, range(S))
    gen = None
    r0 = T._reads(st, gen)
    invalidate_touched_(st.cache, c[0])
    refresh_hot_cache_(st.embedding.as_sharded_table(), st.cache)
    assert T._reads(st, gen) == r0
    st.cache = refresh_hot_cache(st.embedding.as_sharded_table(), st.cache)
    r1 = T._reads(st, gen)
    assert r1 != r0
    st.embedding.table = st.embedding.table.clone()
    assert T._reads(st, gen) != r1
    assert T._reads(st, torch.Generator()) != T._reads(st, gen)


@pytest.mark.slow
def test_scan_epoch_example_under_the_launcher():
    """``node_classification --scan-epoch`` at world 4 under the launcher
    (``--device cpu``: gloo), the table trained: each rank keeps its
    columns of the stacked batches, so rank 0 prints the epoch losses and
    the ``[TEST]`` line of the run without the flag."""
    import os
    import re
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = {}
    for extra in ([], ["--scan-epoch"]):
        proc = subprocess.run(
            [sys.executable, "-m", "wholegraph_tpu_torch.launch", "--nproc", "4", "--device",
             "cpu", "-m", "wholegraph_tpu_torch.examples.node_classification", "--", "--smoke",
             "--epochs", "2", "--train-embedding", *extra], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=300)
        out = proc.stdout
        assert proc.returncode == 0, out + proc.stderr
        assert "world 4" in out, out
        # an epoch's line without its time, and the test line
        lines[bool(extra)] = (re.findall(r"\[EPOCH_TIME\] [0-9.]+ s (epoch .*)", out)
                              + re.findall(r"\[TEST\].*", out))
        assert len(lines[bool(extra)]) == 3, out
    assert lines[True] == lines[False]
