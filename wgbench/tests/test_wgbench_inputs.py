"""The graph generator's counts and degrees, and the inputs' determinism."""

import torch

from wgbench import inputs as I

CFG = {"nodes": 20000, "undirected_edges": 300000, "feat_dim": 4, "num_classes": 3,
       "splits": {"train": 1000, "valid": 500, "test": 18500},
       "graph": {"model": "chung_lu", "degree_exponent": 2.5, "max_expected_degree": 2000},
       "model": "sage", "num_layers": 2, "hidden": 8}


def test_graph_counts_and_degrees():
    row_ptr, col = I.make_graph(CFG, 11, "cpu")
    n, e = CFG["nodes"], CFG["undirected_edges"]
    assert row_ptr.dtype == col.dtype == torch.int32
    assert row_ptr.shape == (n + 1,) and col.shape == (2 * e,)
    assert int(row_ptr[0]) == 0 and int(row_ptr[-1]) == 2 * e
    assert bool((row_ptr[1:] >= row_ptr[:-1]).all())
    assert int(col.min()) >= 0 and int(col.max()) < n
    deg = (row_ptr[1:] - row_ptr[:-1]).double()
    assert float(deg.mean()) == 2 * e / n
    # heavy-tailed: the largest degree near the expected largest, far above the median
    assert 0.8 * 2000 < float(deg.max()) < 1.2 * 2000
    assert float(deg.max()) > 20 * float(deg.median())
    # stored both ways: the multiset of (row, col) pairs is symmetric
    rows = torch.repeat_interleave(torch.arange(n), deg.long())
    fwd = torch.sort(rows.long() * n + col.long()).values
    bwd = torch.sort(col.long() * n + rows.long()).values
    assert torch.equal(fwd, bwd)


def test_expected_degrees_follow_the_offset():
    i0 = I.chung_lu_offset(20000, 300000, 2.5, 2000)
    d = I.expected_degrees(20000, 300000, 2.5, i0)
    assert abs(float(d[0]) - 2000) < 1e-6 * 2000
    assert abs(float(d.sum()) - 600000) < 1e-6 * 600000


def test_same_seed_same_inputs_other_seed_other_inputs():
    a, b, c = (I.make_graph(CFG, s, "cpu") for s in (3, 3, 2**31 + 7))
    assert torch.equal(a[1], b[1]) and torch.equal(a[1], c[1])  # the graph is the dataset
    la, sa = I.make_labels_and_splits(CFG, 3, "cpu")
    lb, sb = I.make_labels_and_splits(CFG, 3, "cpu")
    lc, _ = I.make_labels_and_splits(CFG, 4, "cpu")
    assert torch.equal(la, lb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(la, lc)
    assert not torch.equal(I.make_features(CFG, 3, "cpu"), I.make_features(CFG, 4, "cpu"))
    ids = torch.cat(list(sa.values()))
    assert torch.equal(torch.sort(ids).values, torch.arange(CFG["nodes"], dtype=torch.int32))
    assert [v.shape[0] for v in sa.values()] == [1000, 500, 18500]
    assert torch.equal(I.make_features(CFG, 3, "cpu"), I.make_features(CFG, 3, "cpu"))
    wa, wb = I.make_weights(CFG, 3, "cpu"), I.make_weights(CFG, 3, "cpu")
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(wa, wb))
    assert [tuple(w["w"].shape) for w in wa] == [(8, 8), (16, 3)]


def test_derived_seeds_differ_by_stream_and_take_large_seeds():
    s = {I.derive(2**40 + 1, k) for k in range(5)}
    assert len(s) == 5 and all(0 <= x < 2**63 for x in s)
