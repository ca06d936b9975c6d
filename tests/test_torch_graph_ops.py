"""Port parity: append_unique of wholegraph_tpu_torch is bit-equal to the
JAX package's, with masked slots, duplicates and dummy padding targets; so
are padded_to_csr, csr_add_self_loop and add_self_loop_padded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.ops import graph_ops as jax_graph_ops
from wholegraph_tpu.ops.graph_ops import append_unique as jax_append_unique
from wholegraph_tpu_torch.ops.graph_ops import (add_self_loop_padded, append_unique,
                                                csr_add_self_loop, padded_to_csr)

torch.set_num_threads(1)


def _case(seed, T, M, n, dummy_targets):
    rs = np.random.RandomState(seed)
    targets = rs.choice(n, T, replace=False).astype(np.int32)
    if dummy_targets:
        # padding targets carry the distinct dummy ids n + arange, as
        # multilayer_sample gives them
        pad = rs.rand(T) < 0.3
        targets = np.where(pad, n + np.arange(T), targets).astype(np.int32)
    nbrs = rs.randint(0, n, M).astype(np.int32)
    nbrs[: M // 4] = targets[rs.randint(0, T, M // 4)] % n  # hits on targets
    mask = rs.rand(M) < 0.7
    return targets, nbrs, mask


@pytest.mark.parametrize("seed,T,M,n,dummy", [
    (0, 16, 64, 50, False),
    (1, 32, 200, 1000, True),
    (2, 8, 40, 12, True),   # many duplicates
    (3, 5, 0, 20, False),   # no neighbours
])
def test_append_unique_bit_exact(seed, T, M, n, dummy):
    targets, nbrs, mask = _case(seed, T, M, n, dummy)
    ju, jc, jm = jax_append_unique(jnp.asarray(targets), jnp.asarray(nbrs), jnp.asarray(mask))
    tu, tc, tm = append_unique(torch.from_numpy(targets), torch.from_numpy(nbrs),
                               torch.from_numpy(mask))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tu.dtype == torch.int32 and tm.dtype == torch.int32


def test_append_unique_contract():
    targets, nbrs, mask = _case(4, 10, 60, 40, True)
    uids, count, nmap = append_unique(torch.from_numpy(targets), torch.from_numpy(nbrs),
                                      torch.from_numpy(mask))
    uids, count, nmap = uids.numpy(), int(count), nmap.numpy()
    np.testing.assert_array_equal(uids[:10], targets)          # targets first
    new = uids[10:count]
    assert (np.diff(new) > 0).all()                             # then ascending
    assert (uids[count:] == -1).all()                           # padding -1
    assert (nmap[~mask] == -1).all()                            # -1 where masked
    np.testing.assert_array_equal(uids[nmap[mask]], nbrs[mask])  # map is right


@pytest.mark.parametrize("seed,B,K,p", [(0, 7, 5, 0.6), (1, 1, 3, 0.0), (2, 12, 1, 1.0),
                                        (3, 30, 16, 0.3)])
def test_padded_to_csr_and_self_loops_bit_exact(seed, B, K, p):
    """``padded_to_csr``, ``csr_add_self_loop`` (the -1 fill past
    ``row_ptr[B]`` and the static E + B output) and
    ``add_self_loop_padded`` bit-equal to the JAX ops
    (``graph_ops.py:102-140``), dtypes included."""
    rs = np.random.RandomState(seed)
    nbrs = rs.randint(0, B, (B, K)).astype(np.int32)
    mask = rs.rand(B, K) < p
    j = jax_graph_ops.padded_to_csr(jnp.asarray(nbrs), jnp.asarray(mask))
    t = padded_to_csr(torch.from_numpy(nbrs), torch.from_numpy(mask))
    for a, b in zip(j, t):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (t[1][int(t[2]):] == -1).all()
    # self loops on the compacted CSR, padding included (local ids 0..B-1)
    rp, col = np.array(j[0]), np.where(np.asarray(j[1]) < 0, 0, np.asarray(j[1]))
    for row_ptr, c in ((rp, col), (rp.astype(np.int64), col.astype(np.int64))):
        jr, jc = jax_graph_ops.csr_add_self_loop(jnp.asarray(row_ptr), jnp.asarray(c))
        tr, tc = csr_add_self_loop(torch.from_numpy(row_ptr), torch.from_numpy(c))
        assert tc.shape == (B * K + B,)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        # the input's dtypes (JAX, with x64 off, holds int64 inputs as int32)
        assert tr.dtype == torch.from_numpy(row_ptr).dtype and tc.numpy().dtype == c.dtype
    self_ids = rs.randint(0, 99, B).astype(np.int32)
    jn, jm = jax_graph_ops.add_self_loop_padded(jnp.asarray(nbrs), jnp.asarray(mask),
                                                jnp.asarray(self_ids))
    tn, tm = add_self_loop_padded(torch.from_numpy(nbrs), torch.from_numpy(mask),
                                  torch.from_numpy(self_ids))
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    assert tm[:, 0].all() and tn.shape == (B, K + 1)


def test_csr_add_self_loop_empty_rows_and_padding():
    """Rows with no edge still get their self loop at their head; edge
    slots past row_ptr[B] are dropped."""
    row_ptr = np.array([0, 0, 2, 2, 3], np.int32)
    col = np.array([3, 0, 1, 9, 9], np.int32)  # two padding slots
    jr, jc = jax_graph_ops.csr_add_self_loop(jnp.asarray(row_ptr), jnp.asarray(col))
    tr, tc = csr_add_self_loop(torch.from_numpy(row_ptr), torch.from_numpy(col))
    assert tr.tolist() == [0, 1, 4, 5, 7] and tc.tolist() == [0, 1, 3, 0, 2, 3, 1, -1, -1]
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
