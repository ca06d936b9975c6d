"""Port parity: the host-memory tier of wholegraph_tpu_torch (HostEmbedding,
its cache selection and its training step) on the CPU against the JAX
package's HostEmbedding on a one-device mesh, from numpy-made data; and the
host tier against the port's own device-memory Embedding.

Tolerances: gathers and cache contents move bits and are exact; optimizer
rows, slots and losses rtol/atol 1e-6, the JAX host tests' own (f32
elementwise math; the bias corrections are f32 powers taken by numpy
instead of XLA). Ids are compared in ``[0, n]``: for an id < 0 the JAX CPU
path returns row 0 through its clip and the port a zero row (quirk R6,
pinned on its own below)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wholegraph_tpu.embedding as jemb
import wholegraph_tpu.embedding.cache as jcache
import wholegraph_tpu_torch.embedding as temb
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
N, DIM, B = 64, 8, 48

JAX_OPTS = [
    jemb.SGD(weight_decay=0.01),
    jemb.LazyAdam(),
    jemb.LazyAdam(adam_w=True, weight_decay=0.01),
    jemb.RMSProp(),
    jemb.AdaGrad(),
]


def _port_opt(jopt):
    hyper = {k: v for k, v in dataclasses.asdict(jopt).items() if k != "name"}
    return temb.create_optimizer(jopt.name, **hyper)


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _pair(init, hot, jopt=jemb.SGD(), ratio=0.25):
    je = jemb.HostEmbedding.create(_mesh1(), N, DIM, optimizer=jopt, cache_ratio=ratio)
    te = temb.HostEmbedding.create(N, DIM, optimizer=_port_opt(jopt), cache_ratio=ratio,
                                   device="cpu")
    return je, je.from_array(init, hot_ids=hot), te.from_array(init, hot_ids=hot)


def _init(seed=0):
    return np.random.RandomState(seed).randn(N, DIM).astype(np.float32)


def _assert_cache_equal(te, jstate):
    np.testing.assert_array_equal(te.cache_map.numpy(), np.asarray(jstate.cache_map))
    np.testing.assert_array_equal(te.cache_rows.numpy(), np.asarray(jstate.cache_rows))


def _assert_coherent(te):
    """cache == host for every cached row (host_embedding.py:24-27)."""
    cached = te.cache_map >= 0
    assert torch.equal(te.cache_rows[te.cache_map[cached].long()], te.host_table[cached])


def test_gather_hits_misses_and_n_match_jax():
    init = _init()
    hot = np.arange(0, N, 4)
    je, jstate, te = _pair(init, hot)
    assert te.hot_cap == je.hot_cap == 16
    _assert_cache_equal(te, jstate)
    ids = np.random.RandomState(1).randint(0, N + 1, 200).astype(np.int32)
    ids[:3] = [N, 0, N - 1]
    out = te.gather(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(out, np.asarray(je.gather(jstate, jnp.asarray(ids))))
    np.testing.assert_array_equal(out[ids < N], init[ids[ids < N]])
    assert not out[ids == N].any()


def test_negative_ids_give_zero_rows():
    """Quirk R6: the JAX CPU path clips an id < 0 to row 0; the port treats
    it like any id outside [0, n) and returns a zero row."""
    init = _init() + 1.0
    je, jstate, te = _pair(init, np.arange(0, N, 2))
    ids = np.array([-1, -5, 3], np.int32)
    out = te.gather(torch.from_numpy(ids)).numpy()
    assert not out[:2].any()
    np.testing.assert_array_equal(out[2], init[3])
    jout = np.asarray(je.gather(jstate, jnp.asarray(ids)))
    np.testing.assert_array_equal(jout[:2], init[[0, 0]])


def _batch(rs):
    ids = rs.randint(1, N, B).astype(np.int32)  # duplicates; row 0 only as padding
    mask = rs.rand(B) < 0.8
    ids[~mask] = 0           # padding points at row 0 ...
    ids[0], mask[0] = 0, False
    ids[1] = -1              # ... or outside the table
    ids[2] = N + 2
    return ids, rs.randn(B, DIM).astype(np.float32), mask


@pytest.mark.parametrize("jopt", JAX_OPTS,
                         ids=lambda o: o.name + ("_w" if getattr(o, "adam_w", False) else ""))
def test_apply_gradients_matches_jax(jopt):
    rs = np.random.RandomState(0)
    init = _init()
    je, jstate, te = _pair(init, np.arange(1, N, 3), jopt)
    touched = set()
    for _ in range(3):
        ids, grads, mask = _batch(rs)
        touched |= set(ids[mask & (ids >= 0) & (ids < N)].tolist())
        jstate = je.apply_gradients(jstate, jnp.asarray(ids), jnp.asarray(grads), 0.1,
                                    mask=jnp.asarray(mask))
        te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(grads), 0.1,
                           mask=torch.from_numpy(mask))
    assert te.step == int(jstate.step) == 3
    np.testing.assert_allclose(te.to_array(), je.to_array(jstate), **TOL)
    for s in jopt.slot_names:
        jslot = np.asarray(jstate.host_slots[s]).reshape(N, DIM)
        np.testing.assert_allclose(te.slot_to_array(s), jslot, **TOL)
    np.testing.assert_array_equal(te.cache_map.numpy(), np.asarray(jstate.cache_map))
    np.testing.assert_allclose(te.cache_rows.numpy(), np.asarray(jstate.cache_rows), **TOL)
    _assert_coherent(te)
    untouched = np.setdiff1d(np.arange(N), sorted(touched))
    assert 0 in untouched  # padding at id 0 left row 0 and its slots alone
    np.testing.assert_array_equal(te.to_array()[untouched], init[untouched])
    for s in jopt.slot_names:
        assert not te.slot_to_array(s)[untouched].any()


def test_make_train_step_losses_match_jax():
    target = np.random.RandomState(3).randn(N, DIM).astype(np.float32)
    je, jstate, te = _pair(np.zeros((N, DIM), np.float32), np.arange(0, N, 2), jemb.LazyAdam(),
                           ratio=0.5)
    ids = np.arange(N, dtype=np.int32)
    mask = np.arange(N) % 5 != 0
    jstep = je.make_train_step(lambda rows, t: jnp.mean((rows - t) ** 2), lr=0.05, donate=False)
    tstep = te.make_train_step(lambda rows, t: torch.mean((rows - t) ** 2), lr=0.05)
    jl, tl = [], []
    for _ in range(8):
        jstate, loss = jstep(jstate, jnp.asarray(ids), jnp.asarray(target), mask=jnp.asarray(mask))
        jl.append(float(loss))
        tl.append(float(tstep(torch.from_numpy(ids), torch.from_numpy(target),
                              mask=torch.from_numpy(mask))))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(te.to_array(), je.to_array(jstate), **TOL)
    assert not te.to_array()[~mask].any()  # masked rows were never trained


def test_cache_coherent_after_training():
    """update_cache_direct analog: after sparse updates a gather of every
    row, hot rows from the cache and cold rows from the host, equals the
    host table and the JAX tier's gather."""
    rs = np.random.RandomState(6)
    je, jstate, te = _pair(_init(6), np.arange(0, N, 2), ratio=0.3)
    for _ in range(2):
        ids = rs.randint(0, N, B).astype(np.int32)
        grads = rs.randn(B, DIM).astype(np.float32)
        jstate = je.apply_gradients(jstate, jnp.asarray(ids), jnp.asarray(grads), 0.1)
        te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(grads), 0.1)
    _assert_coherent(te)
    all_ids = np.arange(N, dtype=np.int32)
    out = te.gather(torch.from_numpy(all_ids)).numpy()
    np.testing.assert_array_equal(out, te.to_array())
    np.testing.assert_allclose(out, np.asarray(je.gather(jstate, jnp.asarray(all_ids))), **TOL)


def test_rebuild_cache_with_hot_ids_by_count_matches_jax():
    rs = np.random.RandomState(7)
    je, jstate, te = _pair(_init(7), np.arange(0, 16))
    jc, tc = jcache.make_touch_counter(N), temb.make_touch_counter(N, device="cpu")
    for i in range(4):
        ids = (rs.zipf(1.5, B) % N).astype(np.int32)
        mask = rs.rand(B) < 0.9
        jc = jcache.touch(jc, jnp.asarray(ids), jnp.asarray(mask))
        assert temb.touch(tc, torch.from_numpy(ids), torch.from_numpy(mask)) is tc
        if i == 1:
            jc, tc = jcache.decay(jc), temb.decay(tc)
        grads = rs.randn(B, DIM).astype(np.float32)
        jstate = je.apply_gradients(jstate, jnp.asarray(ids), jnp.asarray(grads), 0.1,
                                    mask=jnp.asarray(mask))
        te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(grads), 0.1,
                           mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.counts.numpy(), np.asarray(jc.counts))
    hot = temb.hot_ids_by_count(tc, te.hot_cap)
    np.testing.assert_array_equal(hot, jcache.hot_ids_by_count(jc, je.hot_cap))
    jstate = je.rebuild_cache(jstate, hot)
    assert te.rebuild_cache(hot) is te
    np.testing.assert_array_equal(te.cache_map.numpy(), np.asarray(jstate.cache_map))
    np.testing.assert_allclose(te.cache_rows.numpy(), np.asarray(jstate.cache_rows), **TOL)
    _assert_coherent(te)
    assert te.cache_hit_fraction(hot) == 1.0


def test_touch_skips_ids_outside_the_table():
    tc = temb.make_touch_counter(5, device="cpu")
    temb.touch(tc, torch.tensor([0, 4, 5, -1, 4]), torch.tensor([True, True, True, True, False]))
    assert tc.counts.tolist() == [1, 0, 0, 0, 1]


def test_cache_hit_fraction_matches_jax():
    hot = np.arange(0, N, 4)
    je, jstate, te = _pair(_init(), hot)
    ids = np.random.RandomState(8).randint(0, N, 300).astype(np.int32)
    frac = te.cache_hit_fraction(torch.from_numpy(ids))
    assert abs(frac - je.cache_hit_fraction(jstate, ids)) < 1e-6
    assert abs(frac - np.isin(ids, hot).mean()) < 1e-6
    assert te.cache_hit_fraction(np.array([N, -1, 0])) == pytest.approx(1 / 3)


@pytest.mark.parametrize("ratio", [0.01, 0.25, 0.4])
def test_hot_ids_by_degree_matches_jax(ratio):
    degs = np.random.RandomState(9).randint(0, 30, 500)
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    ref = jcache.hot_ids_by_degree(row_ptr, ratio)
    np.testing.assert_array_equal(temb.hot_ids_by_degree(row_ptr, ratio), ref)
    np.testing.assert_array_equal(temb.hot_ids_by_degree(torch.from_numpy(row_ptr), ratio), ref)
    assert set(temb.hot_ids_by_degree(np.array([0, 10, 11, 20, 22, 40]), 0.4)) == {0, 4}


@pytest.mark.parametrize("opt", [temb.SGD(weight_decay=0.01), temb.LazyAdam()],
                         ids=["sgd", "adam"])
def test_host_training_matches_device_embedding(opt):
    """The host tier runs the same optimizer math as the device-memory
    embedding: training gives equal tables and slots (the port's copy of
    tests/test_host_embedding.py:61-83)."""
    init = _init(4)
    dev = temb.Embedding.create(N, DIM, optimizer=opt, device="cpu").from_array(init)
    host = temb.HostEmbedding.create(N, DIM, optimizer=opt, cache_ratio=0.2,
                                     device="cpu").from_array(init, hot_ids=np.arange(0, N, 3))
    rs = np.random.RandomState(5)
    for _ in range(3):
        ids = torch.from_numpy(rs.randint(0, N, B).astype(np.int64))
        grads = torch.from_numpy(rs.randn(B, DIM).astype(np.float32))
        dev.apply_gradients(ids, grads, 0.1)
        host.apply_gradients(ids, grads, 0.1)
    np.testing.assert_allclose(host.to_array(), dev.to_array(), **TOL)
    for s in opt.slot_names:
        np.testing.assert_allclose(host.slot_to_array(s), dev.slot_to_array(s), **TOL)
    _assert_coherent(host)


def test_bf16_host_table_matches_device_embedding():
    """A bf16 host table is updated in f32 and rounded back, as the device
    embedding does; the optimizer slots stay f32."""
    init = _init(10)
    kw = dict(optimizer=temb.LazyAdam(), dtype="bfloat16", device="cpu")
    dev = temb.Embedding.create(N, DIM, **kw).from_array(init)
    host = temb.HostEmbedding.create(N, DIM, cache_ratio=0.3, **kw).from_array(
        init, hot_ids=np.arange(0, N, 2))
    assert host.host_table.dtype == host.cache_rows.dtype == torch.bfloat16
    assert host.host_slots["m"].dtype == torch.float32
    rs = np.random.RandomState(11)
    for _ in range(2):
        ids = torch.from_numpy(rs.randint(0, N, B).astype(np.int32))
        grads = torch.from_numpy(rs.randn(B, DIM).astype(np.float32))
        dev.apply_gradients(ids, grads, 0.1)
        host.apply_gradients(ids, grads, 0.1)
    assert torch.equal(host.host_table, dev.table)
    _assert_coherent(host)
    all_ids = torch.arange(N)
    assert torch.equal(host.gather(all_ids), dev.gather(all_ids))


def test_init_draws_the_device_embedding_table():
    host = temb.HostEmbedding.create(N, DIM, optimizer=temb.LazyAdam(), device="cpu")
    host.init(torch.Generator().manual_seed(3), hot_ids=[5, 1, 5, 9])
    dev = temb.Embedding.create(N, DIM, device="cpu").init(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(host.to_array(), dev.to_array())
    assert host.step == 0 and not host.slot_to_array("v").any()
    assert host.cache_map[[1, 5, 9]].tolist() == [0, 1, 2]
    assert int((host.cache_map >= 0).sum()) == 3
    _assert_coherent(host)


def test_input_checks():
    host = temb.HostEmbedding.create(N, DIM, device="cpu")
    with pytest.raises(InvalidInput):
        host.from_array(np.zeros((N + 1, DIM), np.float32))
    with pytest.raises(InvalidInput):
        host.rebuild_cache(np.array([0, N]))
    with pytest.raises(InvalidInput):
        host.apply_gradients(torch.zeros(3, dtype=torch.int32), torch.zeros(3, DIM + 1), 0.1)
    with pytest.raises(InvalidInput):
        temb.HostEmbedding.create(0, DIM, device="cpu")
    assert temb.HostEmbedding.create(N, DIM, cache_ratio=1e-9, device="cpu").hot_cap == 1
