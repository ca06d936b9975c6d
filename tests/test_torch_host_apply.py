"""The host tier's apply on the CPU: ``HostEmbedding.apply_gradients``
through ``ops/optim_kernels.py``'s ``apply_rows_host`` (kernel L's host
route on a card) against the JAX package's ``HostEmbedding`` apply
(``_host_apply_shard``) on a one-device mesh, for the registry's optimizers
with f32 and bf16 tables; ``apply_rows_host_plain`` against the composition
``HostEmbedding.apply_gradients`` ran before the host route (kernel E's,
the update, kernel F's and kernel B's plain versions) bit for bit; and the
route choice and the kernel's arguments, with the launch replaced by a
recorder.

Tolerances against JAX: f32 tables, and every optimizer slot, rtol/atol
1e-6, the JAX host tests' own (f32 elementwise math in another order; the
bias corrections are f32 powers taken by numpy instead of XLA; duplicates
summed in another order, which LazyAdam amplifies near a zero gradient,
ROADMAP queue 3 "To watch"). bf16 tables: rtol 2^-7, one bf16 ulp, with
atol 1e-6: a 1-ulp f32 difference before the rounding to bf16 can move a
value by one bf16 ulp. Ids are compared in ``[0, n]`` and beyond: the
apply skips an id outside ``[0, n)`` in both packages (quirk R6 is the
gather's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sparse_apply import (APPLY_DIMS, APPLY_KINDS, APPLY_LR, APPLY_OPTS, APPLY_ROWS,
                                     APPLY_STEP, ScaledSGD, apply_case, copies, same_bits)

import wholegraph_tpu.embedding as jemb
import wholegraph_tpu_torch.embedding as temb
from wholegraph_tpu_torch import kernels
from wholegraph_tpu_torch.embedding import host_embedding as host_mod
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.ops import optim_kernels as L
from wholegraph_tpu_torch.utils.error import CudaError, InvalidInput

torch.set_num_threads(1)

N, DIM, B = 96, 8, 64
F32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
HOT = np.arange(1, N, 3)  # cached rows; the others are not

JAX_OPTS = [
    jemb.SGD(weight_decay=0.01),
    jemb.LazyAdam(),
    jemb.LazyAdam(adam_w=True, weight_decay=0.01),
    jemb.RMSProp(),
    jemb.AdaGrad(),
]


def _name(o):
    return o.name + ("_w" if getattr(o, "adam_w", False) else "")


def _port_opt(jopt):
    hyper = {k: v for k, v in dataclasses.asdict(jopt).items() if k != "name"}
    return temb.create_optimizer(jopt.name, **hyper)


def _batch(rs):
    """Duplicates, masked slots, and ids -1, n and n + 2."""
    ids = rs.randint(0, N, B).astype(np.int32)
    ids[B // 2:] = ids[:B // 2][rs.permutation(B // 2)]  # every id at least twice
    mask = rs.rand(B) < 0.8
    ids[[1, 2, 3]] = [-1, N, N + 2]
    return ids, rs.randn(B, DIM).astype(np.float32), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jopt", JAX_OPTS, ids=_name)
def test_host_apply_matches_jax(jopt, dtype):
    """Three applies on the port's host tier and JAX's, from one numpy
    table: tables, slots, cache maps and cached lines agree, the cache
    stays coherent, and rows never touched keep their values and zero
    slots."""
    rs = np.random.RandomState(0)
    init = rs.randn(N, DIM).astype(np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    je = jemb.HostEmbedding.create(mesh, N, DIM, optimizer=jopt, cache_ratio=0.4,
                                   dtype=getattr(jnp, dtype))
    jstate = je.from_array(init, hot_ids=HOT)
    te = temb.HostEmbedding.create(N, DIM, optimizer=_port_opt(jopt), cache_ratio=0.4,
                                   dtype=dtype, device="cpu").from_array(init, hot_ids=HOT)
    touched = set()
    for _ in range(3):
        ids, grads, mask = _batch(rs)
        touched |= set(ids[mask & (ids >= 0) & (ids < N)].tolist())
        jstate = je.apply_gradients(jstate, jnp.asarray(ids), jnp.asarray(grads), 0.1,
                                    mask=jnp.asarray(mask))
        te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(grads), 0.1,
                           mask=torch.from_numpy(mask))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = te.to_array().astype(np.float32)
    np.testing.assert_allclose(got, np.asarray(je.to_array(jstate)).astype(np.float32), **tol)
    for s in jopt.slot_names:
        jslot = np.asarray(jstate.host_slots[s]).reshape(N, DIM)
        np.testing.assert_allclose(te.slot_to_array(s), jslot, **F32_TOL)
    np.testing.assert_array_equal(te.cache_map.numpy(), np.asarray(jstate.cache_map))
    np.testing.assert_allclose(te.cache_rows.float().numpy(),
                               np.asarray(jstate.cache_rows).astype(np.float32), **tol)
    cached = te.cache_map >= 0
    assert int(cached.sum()) == len(HOT)
    assert same_bits(te.cache_rows[te.cache_map[cached].long()], te.host_table[cached])
    untouched = np.setdiff1d(np.arange(N), sorted(touched))
    assert len(untouched) and len(np.intersect1d(untouched, HOT))
    before = torch.from_numpy(init).to(te.dtype).float().numpy()
    np.testing.assert_array_equal(got[untouched], before[untouched])
    for s in jopt.slot_names:
        assert not te.slot_to_array(s)[untouched].any()


def _lines(rs, n, ids, hot_cap=37):
    """A cache map of ``hot_cap`` random rows of ``n`` and each slot's line
    under it (-1 for a slot outside the table or a row not cached)."""
    cache_map = torch.full((n,), -1, dtype=torch.int32)
    cache_map[torch.from_numpy(rs.permutation(n)[:hot_cap])] = torch.arange(hot_cap,
                                                                            dtype=torch.int32)
    valid = (ids >= 0) & (ids < n)
    lines = torch.where(valid, cache_map[torch.where(valid, ids, 0).long()], -1)
    return cache_map, lines


def parent_host_apply(table, slots, ids, grads, opt, step, lr, cache_map, cache_rows):
    """What ``HostEmbedding.apply_gradients`` ran on the CPU before kernel
    L's host route, from its slots on: kernel E's plain gather of the table
    (widened) and of each slot, the update, kernel F's plain scatter of
    each, then kernel B's plain scatter of the new table rows into the
    cached lines."""
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    slot = torch.where(valid, ids, -1)
    names = tuple(sorted(slots))
    rows = H.host_gather_rows_plain(table, slot).float()
    srows = {s: H.host_gather_rows_plain(slots[s], slot) for s in names}
    new_rows, new_srows = opt.update(rows, grads, srows, step, lr)
    new_rows = new_rows.to(table.dtype).contiguous()
    H.host_scatter_rows_plain(table, slot, new_rows)
    for s in names:
        H.host_scatter_rows_plain(slots[s], slot, new_srows[s].contiguous())
    line = cache_map[torch.where(valid, slot, 0).long()]
    G.scatter_rows_plain(cache_rows, torch.where(valid & (line >= 0), line, -1), new_rows)


def host_case(name, dtype, D, kind, seed=0):
    """:func:`apply_case` with a cache: ``(table, slots, ids, grads,
    cache_map, lines, cache_rows)``, the cache rows equal to their table
    rows."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads = apply_case(opt, dtype, D, kind, seed=seed)
    cache_map, lines = _lines(np.random.RandomState(seed + 100), APPLY_ROWS, ids)
    cache_rows = torch.zeros((37, D), dtype=dtype)
    cached = cache_map >= 0
    cache_rows[cache_map[cached].long()] = table[cached]
    return table, slots, ids, grads, cache_map, lines, cache_rows


@pytest.mark.parametrize("kind", APPLY_KINDS)
@pytest.mark.parametrize("D", APPLY_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_host_apply_plain_is_the_parent_composition(name, dtype, D, kind):
    """The plain host route gives the parent composition's bits in the
    table, the slots and the cache; rows not touched, and lines of rows
    not touched, stay as they were."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads, cache_map, lines, cache_rows = host_case(name, dtype, D, kind)
    t1, s1 = copies(table, slots)
    t2, s2 = copies(table, slots)
    c1, c2 = cache_rows.clone(), cache_rows.clone()
    L.apply_rows_host_plain(t1, s1, ids, grads, opt, APPLY_STEP, APPLY_LR, lines=lines,
                            cache_rows=c1)
    parent_host_apply(t2, s2, ids, grads, opt, APPLY_STEP, APPLY_LR, cache_map, c2)
    assert same_bits(t1, t2) and all(same_bits(s1[k], s2[k]) for k in slots)
    assert same_bits(c1, c2)
    valid = ((ids >= 0) & (ids < APPLY_ROWS)).numpy()
    untouched = np.ones(APPLY_ROWS, bool)
    untouched[ids.numpy()[valid]] = False
    assert same_bits(t1[untouched], table[untouched])
    cached = (cache_map >= 0).numpy()
    assert same_bits(c1[cache_map[cached].long()], t1[cached])  # coherent after the step
    if valid.any():
        assert not torch.equal(t1[ids[valid]], table[ids[valid]])


@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_host_apply_on_the_cpu_is_its_plain_version(name, monkeypatch):
    """On CPU tensors the wrapper runs the plain version, whatever the
    route; without lines it writes no cache."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads, _, lines, cache_rows = host_case(name, torch.float32, 16, "mixed",
                                                               seed=2)
    seen = []
    plain = L.apply_rows_host_plain
    monkeypatch.setattr(L, "apply_rows_host_plain",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    t1, s1 = copies(table, slots)
    t2, s2 = copies(table, slots)
    c1, c2 = cache_rows.clone(), cache_rows.clone()
    L.apply_rows_host(t1, s1, ids, grads, opt, APPLY_STEP, APPLY_LR, lines=lines, cache_rows=c1)
    plain(t2, s2, ids, grads, opt, APPLY_STEP, APPLY_LR, lines=lines, cache_rows=c2)
    assert seen == [1]
    assert same_bits(t1, t2) and all(same_bits(s1[k], s2[k]) for k in slots)
    assert same_bits(c1, c2)
    t3, s3 = copies(table, slots)
    L.apply_rows_host(t3, s3, ids, grads, opt, APPLY_STEP, APPLY_LR)
    assert same_bits(t3, t1) and all(same_bits(s3[k], s1[k]) for k in slots)


class _Recorder:
    """Stands in for a kernel: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, route=None):
        self.calls.append(args)


def _as_on_card(monkeypatch):
    """The wrapper's card route on CPU tensors: every tensor counts as on
    the card, no kernel launches (kernel L's host route records its
    arguments), and E, F and B run their plain versions, recorded."""
    rec = {"L": _Recorder(), "E": [], "F": [], "B": []}
    monkeypatch.setattr(L, "_on_card", lambda t, *others: True)
    monkeypatch.setattr(kernels, "cuda_stream", lambda device: 0)
    monkeypatch.setattr(L, "SPARSE_APPLY_HOST", rec["L"])
    for key, name, fn in (("E", "host_gather_rows", H.host_gather_rows_plain),
                          ("F", "host_scatter_rows", H.host_scatter_rows_plain),
                          ("B", "scatter_rows", G.scatter_rows_plain)):
        def wrapped(*a, _fn=fn, _key=key, **kw):
            rec[_key].append(a)
            return _fn(*a)
        monkeypatch.setattr(L, name, wrapped)
    return rec


@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_registry_optimizers_take_the_fused_route(name, monkeypatch):
    """A registry optimizer's step on the card is one launch of kernel L's
    host route and nothing else; the launch gets each host tensor as its
    allocation's base and its byte offset (a table 10 rows into a larger
    allocation), the state tables in ``slot_names``' order, int32 lines,
    the host tile and the scalars of :func:`kernel_params`."""
    rec = _as_on_card(monkeypatch)
    opt = APPLY_OPTS[name]
    table, slots, ids, grads, _, lines, cache_rows = host_case(name, torch.float32, 16, "mixed",
                                                               seed=3)
    big = torch.zeros((APPLY_ROWS + 10, 16))
    big[10:] = table
    view = big[10:]
    L.apply_rows_host(view, slots, ids, grads, opt, APPLY_STEP, APPLY_LR,
                      lines=lines.long(), cache_rows=cache_rows)
    assert len(rec["L"].calls) == 1 and not (rec["E"] or rec["F"] or rec["B"])
    a = rec["L"].calls[0]
    code, floats, _ = L.kernel_params(opt, APPLY_STEP, APPLY_LR)
    assert a[0] == code and a[3] == 0
    assert a[1] == big.untyped_storage().data_ptr() and a[2] == 10 * 16 * 4
    state = [slots[s] for s in opt.slot_names]
    for k in range(2):
        base, off = a[4 + 2 * k], a[5 + 2 * k]
        if k < len(state):
            assert base + off == state[k].data_ptr()
        else:
            assert base is None and off == 0
    assert a[8] == ids.data_ptr() and a[9] == 1 and a[10] == grads.data_ptr()
    assert a[12] == cache_rows.data_ptr() and a[11] != lines.data_ptr()  # int32 copy
    assert a[13:18] == (APPLY_ROWS, ids.numel(), 16, 4, L.apply_tile(64, L.APPLY_HOST_TILE_BYTES))
    assert tuple(a[18:27]) == floats and a[27] is None and a[28] == 0


class _MyAdam(temb.LazyAdam):
    """LazyAdam from outside the registry's types."""


@pytest.mark.parametrize("name,opt,launches", [("sgd", ScaledSGD(), (1, 1, 1)),
                                               ("lazy_adam", _MyAdam(), (3, 3, 1))])
def test_a_foreign_optimizer_takes_the_composed_route(name, opt, launches, monkeypatch):
    """A subclass from outside the registry runs E on the table and each
    slot, its own update, F on each and B on the lines, and gives the plain
    route's bits; kernel L's host route is not launched."""
    rec = _as_on_card(monkeypatch)
    table, slots, ids, grads, _, lines, cache_rows = host_case(name, torch.float32, 8, "mixed",
                                                               seed=4)
    t1, s1 = copies(table, slots)
    t2, s2 = copies(table, slots)
    c1, c2 = cache_rows.clone(), cache_rows.clone()
    L.apply_rows_host(t1, s1, ids, grads, opt, 2, 0.5, lines=lines, cache_rows=c1)
    assert L.apply_route(opt) == "composed" and not rec["L"].calls
    assert (len(rec["E"]), len(rec["F"]), len(rec["B"])) == launches
    L.apply_rows_host_plain(t2, s2, ids, grads, opt, 2, 0.5, lines=lines, cache_rows=c2)
    assert same_bits(t1, t2) and same_bits(c1, c2) and all(same_bits(s1[k], s2[k]) for k in s1)
    if name == "sgd":
        valid = (ids >= 0) & (ids < APPLY_ROWS)
        assert torch.equal(t1[ids[valid]], table[ids[valid]] - 2.0 * 0.5 * grads[valid])


def test_host_apply_input_checks():
    table, slots, ids, grads, _, lines, cache_rows = host_case("lazy_adam", torch.float32, 8,
                                                               "mixed", seed=6)
    opt = APPLY_OPTS["lazy_adam"]
    with pytest.raises(InvalidInput):  # lines without cache rows
        L.apply_rows_host(table, slots, ids, grads, opt, 1, 0.1, lines=lines)
    with pytest.raises(InvalidInput):  # cache rows of another type
        L.apply_rows_host(table, slots, ids, grads, opt, 1, 0.1, lines=lines,
                          cache_rows=cache_rows.double())
    with pytest.raises(InvalidInput):
        L.apply_rows_host(table, slots, ids, grads, opt, 1, 0.1, lines=lines[:-1],
                          cache_rows=cache_rows)
    meta = ids.to("meta")
    with pytest.raises(CudaError):  # slots off the CPU beside a host table
        L.apply_rows_host(table, slots, meta, grads.to("meta"), opt, 1, 0.1)


def test_host_embedding_applies_through_the_host_route_once(monkeypatch):
    """``HostEmbedding.apply_gradients`` reaches ``apply_rows_host`` once
    an apply, with the valid slots ascending and unique, -1 for the rest,
    and each slot's cache line (-1 for a row not cached)."""
    seen = []
    real = host_mod.apply_rows_host

    def rec(table, slots, ids, grads, opt, step, lr, *, lines, cache_rows):
        seen.append((ids.clone(), lines.clone(), step))
        return real(table, slots, ids, grads, opt, step, lr, lines=lines, cache_rows=cache_rows)

    monkeypatch.setattr(host_mod, "apply_rows_host", rec)
    rs = np.random.RandomState(7)
    te = temb.HostEmbedding.create(N, DIM, optimizer=temb.LazyAdam(), cache_ratio=0.4,
                                   device="cpu").from_array(rs.randn(N, DIM), hot_ids=HOT)
    for _ in range(2):
        ids, grads, mask = _batch(rs)
        te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(grads), 0.1,
                           mask=torch.from_numpy(mask))
    assert [s for *_, s in seen] == [1, 2]
    for slot, lines, _ in seen:
        valid = slot >= 0
        v = slot[valid]
        assert torch.equal(v, torch.unique(v)) and bool((v < N).all())
        assert torch.equal(lines[valid], te.cache_map[v.long()])
        assert bool((lines[~valid] == -1).all())
    assert te.cache_hit_fraction(HOT) == 1.0


def test_foreign_optimizer_on_the_host_tier():
    """A host tier under a subclass from outside the registry steps with
    its own update on the CPU, and the cache follows."""
    te = temb.HostEmbedding.create(N, DIM, optimizer=ScaledSGD(), cache_ratio=0.4,
                                   device="cpu").from_array(np.ones((N, DIM), np.float32),
                                                            hot_ids=HOT)
    ids = torch.tensor([1, 2, 4, 4, N])
    te.apply_gradients(ids, torch.ones(5, DIM), 0.25)
    t = te.to_array()
    assert (t[[1, 2]] == 0.5).all() and (t[4] == 0.0).all() and (t[[0, 3, 5]] == 1.0).all()
    cached = te.cache_map >= 0
    assert torch.equal(te.cache_rows[te.cache_map[cached].long()], te.host_table[cached])


@pytest.mark.parametrize("tier", ["host", "device"])
def test_bf16_table_to_array_at_world_1_is_widened_exactly(tier):
    """A bf16 table comes back from ``to_array`` at world 1 as float32 with
    the bf16 values, as at world W and as JAX's bf16 array widened; before,
    ``numpy()`` refused bf16 and ``to_array`` raised."""
    init = np.random.RandomState(8).randn(N, DIM).astype(np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    if tier == "host":
        je = jemb.HostEmbedding.create(mesh, N, DIM, dtype=jnp.bfloat16)
        te = temb.HostEmbedding.create(N, DIM, dtype="bfloat16", device="cpu").from_array(init)
    else:
        je = jemb.Embedding.create(mesh, N, DIM, dtype=jnp.bfloat16)
        te = temb.Embedding.create(N, DIM, dtype="bfloat16", device="cpu").from_array(init)
    got = te.to_array()
    assert got.dtype == np.float32
    want = np.asarray(je.to_array(je.from_array(init))).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, init)  # the values are bf16's
