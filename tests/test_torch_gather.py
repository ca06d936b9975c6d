"""Port parity: the row gather / scatter / sampled-column fetch wrappers
(kernels A, B, C) on the CPU, where they run their plain versions, and
local_take / local_write / local_add against the JAX package — bit-exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu_torch.ops import gather as tg

# wholegraph_tpu.ops binds the name ``gather`` to a function; take the module
jg = importlib.import_module("wholegraph_tpu.ops.gather")
from wholegraph_tpu_torch.ops import gather_kernels as K
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

N, D = 40, 12


def _data(seed, B=64):
    rs = np.random.RandomState(seed)
    table = rs.randn(N, D).astype(np.float32)
    ids = rs.randint(-3, N + 3, B).astype(np.int32)  # includes out-of-range ids
    rows = rs.randn(B, D).astype(np.float32)
    mask = rs.rand(B) < 0.75
    return table, ids, rows, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_gather_rows_clips(dtype, id_dtype):
    table, ids, _, _ = _data(0)
    t = torch.from_numpy(table).to(dtype)
    out = K.gather_rows(t, torch.from_numpy(ids.astype(id_dtype)))
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.float().numpy(), t.float().numpy()[np.clip(ids, 0, N - 1)])


def test_scatter_rows_skips_out_of_range_and_is_in_place():
    table, _, rows, _ = _data(1, B=20)
    ids = np.random.RandomState(1).permutation(N)[:20].astype(np.int32)
    ids[::4] = -1
    ids[1] = N + 5
    t = torch.from_numpy(table.copy())
    ret = K.scatter_rows(t, torch.from_numpy(ids), torch.from_numpy(rows))
    assert ret is t
    ref = table.copy()
    ok = (ids >= 0) & (ids < N)
    ref[ids[ok]] = rows[ok]
    np.testing.assert_array_equal(t.numpy(), ref)


@pytest.mark.parametrize("Kf", [3, 200])
def test_sample_cols_any_fanout(Kf):
    rs = np.random.RandomState(Kf)
    col = rs.randint(0, 1000, 5000).astype(np.int32)
    start = rs.randint(0, 4800, 16).astype(np.int32)
    pos = rs.randint(0, 300, (16, Kf)).astype(np.int32)
    mask = rs.rand(16, Kf) < 0.6
    out = K.sample_cols(torch.from_numpy(col), torch.from_numpy(start), torch.from_numpy(pos),
                        torch.from_numpy(mask)).numpy()
    ref = np.where(mask, col[np.clip(start[:, None] + pos, 0, len(col) - 1)], -1)
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32


def test_wrappers_reject_bad_input():
    t = torch.zeros(4, 8)
    with pytest.raises(InvalidInput):
        K.gather_rows(t, torch.zeros(3))                        # float ids
    with pytest.raises(InvalidInput):
        K.scatter_rows(t, torch.zeros(3, dtype=torch.int32), torch.zeros(3, 8, dtype=torch.float64))
    with pytest.raises(InvalidInput):
        K.sample_cols(torch.zeros(5, dtype=torch.int64), torch.zeros(2, dtype=torch.int32),
                      torch.zeros(2, 3, dtype=torch.int32), torch.ones(2, 3, dtype=torch.bool))


def test_local_take_and_grad_match_jax():
    table, ids, _, _ = _data(2)
    ct = np.random.RandomState(3).randn(len(ids), D).astype(np.float32)
    jout, vjp = jax.vjp(lambda t: jg.local_take(t, jnp.asarray(ids)), jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(ct))
    t = torch.from_numpy(table).requires_grad_()
    out = tg.local_take(t, torch.from_numpy(ids))
    out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    # duplicates add up in another order: f32 rounding only
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True])
def test_local_write_and_add_match_jax(with_mask):
    table, ids, rows, mask = _data(4, B=30)
    # non-negative ids only: the JAX package wraps negative ids NumPy-style
    # here (-1 writes row N-1), where the port drops them (see below)
    ids = np.where(np.arange(30) < 15, np.random.RandomState(5).permutation(N)[:30], np.abs(ids))
    ids = ids.astype(np.int32)
    m = mask if with_mask else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    # write: only unique in-range ids, since the winner of duplicates is unspecified
    uniq = np.where(np.arange(30) < 15, ids, N + 1).astype(np.int32)
    jw = jg.local_write(jnp.asarray(table), jnp.asarray(uniq), jnp.asarray(rows), jm)
    tw = tg.local_write(torch.from_numpy(table), torch.from_numpy(uniq), torch.from_numpy(rows), tm)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    ja = jg.local_add(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows), jm)
    src = torch.from_numpy(table.copy())
    ta = tg.local_add(src, torch.from_numpy(ids), torch.from_numpy(rows), tm)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(src.numpy(), table)  # a copy, not in place


def test_local_write_and_add_drop_negative_ids():
    table = torch.zeros(4, 2)
    ids = torch.tensor([-1, 5, 1], dtype=torch.int32)
    expect = torch.tensor([[0.0, 0], [1, 1], [0, 0], [0, 0]])
    assert torch.equal(tg.local_write(table, ids, torch.ones(3, 2)), expect)
    assert torch.equal(tg.local_add(table, ids, torch.ones(3, 2)), expect)
