"""Port parity: uniform CSR sampling and multilayer_sample of
wholegraph_tpu_torch are bit-equal to the JAX package and to its numpy
replay ``wholegraph_tpu.testing.host_sample_uniform``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.ops.sampling import csr_sample_neighbors as jax_sample
from wholegraph_tpu.testing import host_sample_uniform, random_csr
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.ops.sampling import csr_sample_neighbors

torch.set_num_threads(1)


def _csr_with_extremes(n, avg_deg, seed, big_deg):
    """random_csr plus forced degree-0 rows and one row of degree big_deg."""
    row_ptr, col = random_csr(n, avg_deg, seed=seed)
    degs = np.diff(row_ptr)
    degs[:3] = 0
    degs[5] = big_deg
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    col = np.random.RandomState(seed + 1).randint(0, n, row_ptr[-1]).astype(np.int32)
    return row_ptr, col


@pytest.mark.parametrize("K,big", [(4, 30), (15, 40), (200, 450)])
def test_uniform_bit_exact_vs_host_and_jax(K, big):
    row_ptr, col = _csr_with_extremes(120, 10, seed=K, big_deg=big)
    centers = np.concatenate([[0, 1, 2, 5, 5], np.random.RandomState(K).randint(0, 120, 40)])
    res = csr_sample_neighbors(torch.from_numpy(row_ptr.astype(np.int32)), torch.from_numpy(col),
                               torch.from_numpy(centers.astype(np.int32)), K, seed=3, hop=1)
    h_nbrs, h_mask, h_pos = host_sample_uniform(row_ptr, col, centers, K, seed=3, hop=1)
    mask = res.mask.numpy()
    np.testing.assert_array_equal(mask, h_mask)
    np.testing.assert_array_equal(res.positions.numpy(), h_pos)
    np.testing.assert_array_equal(res.neighbors.numpy(), h_nbrs)
    j = jax_sample(jnp.asarray(row_ptr.astype(np.int32)), jnp.asarray(col),
                   jnp.asarray(centers.astype(np.int32)), K, seed=3, hop=1)
    for name in ("neighbors", "mask", "positions", "edge_ids", "degree"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert not mask[:3].any()              # degree 0
    assert mask[3].sum() == min(big, K)    # the big row: all K slots, or all its edges


@pytest.mark.parametrize("fanouts", [(3, 4), (2, 3, 2)])
def test_multilayer_sample_bit_exact(fanouts):
    n = 300
    rs = np.random.RandomState(11)
    src, dst = rs.randint(0, n, n * 6), rs.randint(0, n, n * 6)
    src[:20] = 7  # one high-degree node
    centers = rs.choice(n, 24, replace=False).astype(np.int32)
    cmask = rs.rand(24) < 0.9
    jg = JaxGraph.from_coo(src, dst, n)
    tg = GraphStructure.from_coo(src, dst, n, device="cpu")
    jm = jg.multilayer_sample(jnp.asarray(centers), fanouts, seed=4, center_mask=jnp.asarray(cmask))
    tm = tg.multilayer_sample(torch.from_numpy(centers), fanouts, seed=4,
                              center_mask=torch.from_numpy(cmask))
    np.testing.assert_array_equal(tm.unique_gids.numpy(), np.asarray(jm.unique_gids))
    np.testing.assert_array_equal(tm.unique_mask.numpy(), np.asarray(jm.unique_mask))
    assert len(tm.hops) == len(jm.hops) == len(fanouts)
    for th, jh in zip(tm.hops, jm.hops):
        np.testing.assert_array_equal(th.nbr_idx.numpy(), np.asarray(jh.nbr_idx))
        np.testing.assert_array_equal(th.mask.numpy(), np.asarray(jh.mask))
        np.testing.assert_array_equal(th.center_mask.numpy(), np.asarray(jh.center_mask))
    for tl, jl in zip(tm.level_gids, jm.level_gids):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # padding conventions: sentinel n for padded uniques, nbr_idx 0 where masked
    assert (tm.unique_gids.numpy()[~tm.unique_mask.numpy()] == n).all()
    for th in tm.hops:
        assert (th.nbr_idx.numpy()[~th.mask.numpy()] == 0).all()


def test_graph_direct_constructor_matches_from_coo():
    n = 50
    rs = np.random.RandomState(0)
    src, dst = rs.randint(0, n, 300), rs.randint(0, n, 300)
    a = GraphStructure.from_coo(src, dst, n, device="cpu")
    b = GraphStructure(a.row_ptr.clone(), a.col.clone(), n)
    assert b.edge_count == a.edge_count == 300 and a.max_degree == np.bincount(src).max()
    c = torch.arange(10, dtype=torch.int32)
    ra, rb = a.sample_one_hop(c, 5, seed=2), b.sample_one_hop(c, 5, seed=2)
    assert torch.equal(ra.neighbors, rb.neighbors) and torch.equal(ra.mask, rb.mask)
