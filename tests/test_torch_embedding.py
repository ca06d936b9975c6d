"""Port parity: the one-device Embedding of wholegraph_tpu_torch (gather and
the sparse apply of all five optimizers) against the JAX package's Embedding
on a one-device mesh, including the mask contract: padding never touches
row 0's table row or optimizer state.

Tolerance: optimizer rows rtol/atol 1e-6 (f32 elementwise math; duplicate
gradients are summed in the same sorted order, the bias corrections are
f32 powers computed by numpy instead of XLA)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wholegraph_tpu.embedding as jemb
import wholegraph_tpu_torch.embedding as temb
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

ROWS = dict(rtol=1e-6, atol=1e-6)
N, DIM, B = 60, 8, 40

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


def _batch(rs, unique):
    if unique:
        ids = rs.permutation(N)[:B].astype(np.int32)
    else:
        ids = rs.randint(0, N, B).astype(np.int32)  # duplicates
    mask = rs.rand(B) < 0.8
    ids[~mask] = 0          # padding points at row 0 ...
    ids[0], mask[0] = 0, False
    ids[1] = -1             # ... or out of range
    ids[2] = N + 2
    grads = rs.randn(B, DIM).astype(np.float32)
    return ids, grads, mask


@pytest.mark.parametrize("jopt", JAX_OPTS,
                         ids=lambda o: o.name + ("_w" if getattr(o, "adam_w", False) else ""))
@pytest.mark.parametrize("unique", [False, True])
def test_apply_gradients_matches_jax(jopt, unique):
    rs = np.random.RandomState(0)
    init = rs.randn(N, DIM).astype(np.float32)
    je = jemb.Embedding.create(_mesh1(), N, DIM, optimizer=jopt)
    jstate = je.from_array(init)
    te = temb.Embedding.create(N, DIM, optimizer=_port_opt(jopt), device="cpu").from_array(init)
    touched = set()
    for _ in range(3):
        ids, grads, mask = _batch(rs, unique)
        if unique:  # row 0 never touched by a valid slot in this variant
            mask &= ids != 0
        touched |= set(ids[mask & (ids >= 0) & (ids < N)].tolist())
        jstate = je.apply_gradients(jstate, jnp.asarray(ids), jnp.asarray(grads), 0.1,
                                    mask=jnp.asarray(mask), assume_unique=unique)
        te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(grads), 0.1,
                           mask=torch.from_numpy(mask), assume_unique=unique)
    assert te.step == int(jstate.step) == 3
    np.testing.assert_allclose(te.to_array(), je.to_array(jstate), **ROWS)
    for s in jopt.slot_names:
        np.testing.assert_allclose(te.slot_to_array(s), je.slot_to_array(jstate, s), **ROWS)
    untouched = np.setdiff1d(np.arange(N), sorted(touched))
    np.testing.assert_array_equal(te.to_array()[untouched], init[untouched])
    for s in jopt.slot_names:
        assert not te.slot_to_array(s)[untouched].any()
    if unique:
        assert 0 in untouched  # padding at id 0 left row 0 and its slots alone


def test_gather_clips_like_jax():
    init = np.arange(N * DIM, dtype=np.float32).reshape(N, DIM)
    je = jemb.Embedding.create(_mesh1(), N, DIM)
    te = temb.Embedding.create(N, DIM, device="cpu").from_array(init)
    ids = np.array([0, N - 1, N, N + 7, -1, 5], np.int32)
    np.testing.assert_array_equal(te.gather(torch.from_numpy(ids)).numpy(),
                                  np.asarray(je.gather(je.from_array(init), jnp.asarray(ids))))


def test_state_from_numpy_and_init():
    rs = np.random.RandomState(1)
    table = rs.randn(N, DIM).astype(np.float32)
    m, v = rs.rand(N, DIM).astype(np.float32), rs.rand(N, DIM).astype(np.float32)
    te = temb.Embedding.create(N, DIM, optimizer=temb.LazyAdam(), device="cpu")
    te.state_from_numpy(table, {"m": m, "v": v}, 7)
    assert te.step == 7
    np.testing.assert_array_equal(te.slot_to_array("v"), v)
    with pytest.raises(InvalidInput):
        te.state_from_numpy(table, {"m": m}, 0)   # a slot missing
    te.init(torch.Generator().manual_seed(3))
    a = te.to_array()
    assert te.step == 0 and not te.slot_to_array("m").any()
    assert abs(a.std() - 1 / np.sqrt(DIM)) < 0.05
    te.init(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(te.to_array(), a)


def test_bf16_table_apply():
    """A bf16 table is updated in f32 and rounded back; slots stay f32."""
    rs = np.random.RandomState(2)
    init = rs.randn(N, DIM).astype(np.float32)
    te = temb.Embedding.create(N, DIM, optimizer=temb.SGD(), dtype="bfloat16",
                               device="cpu").from_array(init)
    ids = np.array([3, 4], np.int32)
    g = np.ones((2, DIM), np.float32)
    te.apply_gradients(torch.from_numpy(ids), torch.from_numpy(g), 0.5)
    ref = torch.from_numpy(init).to(torch.bfloat16).float()
    ref[[3, 4]] = (ref[[3, 4]] - 0.5).to(torch.bfloat16).float()
    assert te.table.dtype == torch.bfloat16
    np.testing.assert_array_equal(te.table.float().numpy(), ref.numpy())
