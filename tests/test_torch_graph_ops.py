"""Port parity: append_unique of wholegraph_tpu_torch is bit-equal to the
JAX package's, with masked slots, duplicates and dummy padding targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.ops.graph_ops import append_unique as jax_append_unique
from wholegraph_tpu_torch.ops.graph_ops import append_unique

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
