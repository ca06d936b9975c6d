"""The yardstick's arithmetic against counts made by hand at tiny shapes."""

import pytest

from wgbench.metrics import counts as C


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert C.bound_s(3.35e12) == pytest.approx(1.0)
    assert C.bound_s(0, 67e12) == pytest.approx(1.0)
    assert C.bound_s(3.35e12, 134e12) == pytest.approx(2.0)
    assert C.share_pct(1.0, 4.0) == 25.0
    assert C.share_pct(1.0, None) is None and C.share_pct(1.0, 0.0) is None


def test_gather_and_apply_bytes():
    # 10 ids (4 bytes each), 6 valid rows of 400 bytes read and written
    assert C.gather_bytes(10, 6, 400) == 40 + 2 * 6 * 400
    # LazyAdam: 10 slots of id and mask, 6 rows: table, m, v, grad read; table, m, v written
    assert C.lazy_adam_apply_bytes(10, 6, 400) == 10 * 5 + 7 * 6 * 400


def test_aggregation_bytes_and_operations():
    # B = 4 padded targets (3 valid), K = 2, 5 distinct valid neighbours, rows of 8 floats
    fwd = C.agg_forward_bytes(3, 4, 2, 5, 32)
    assert fwd == 4 * 2 * (4 + 1) + (5 + 3) * 32
    assert C.agg_backward_bytes(3, 4, 2, 5, 32) == fwd
    assert C.agg_flops(7, 8) == 56


def test_spmm_bytes():
    # 3 rows, 5 edges, width 2: row_ptr 4 ints, col 5 ints, x and out 3 x 2 floats each
    assert C.spmm_bytes(3, 5, 2) == 4 * 4 + 5 * 4 + 2 * 3 * 2 * 4


def test_padded_levels():
    assert C.padded_levels(4, [2, 3]) == [4, 12, 48]


def _counts():
    # levels: 2 centres, 5, 9 nodes; hop slots 3 and 6
    return C.SampleCounts(padded=[2, 6, 24], levels=[2, 5, 9], slots=[3, 6], distinct=[3, 5],
                          fanouts=[2, 3])


def test_sage_flops_by_hand():
    c = _counts()
    dims = [(4, 8), (8, 3)]
    # layer 0 over hop 1: 5 targets, [5, 8] @ [8, 8] and 6 slots of width 4
    l0 = 2 * 5 * 8 * 8 + 6 * 4
    # layer 1 over hop 0: 2 targets, [2, 16] @ [16, 3] and 3 slots of width 8
    l1 = 2 * 2 * 16 * 3 + 3 * 8
    assert C.sage_flops(c, dims, backward=False, input_grad=False) == l0 + l1
    # backward: every layer's weight gradient; the input gradient of layer 1 only
    bwd = 2 * 5 * 8 * 8 + 2 * 2 * 16 * 3 + (2 * 2 * 16 * 3 + 3 * 8)
    assert C.sage_flops(c, dims, backward=True, input_grad=False) == l0 + l1 + bwd
    assert C.sage_flops(c, dims, backward=True, input_grad=True) == l0 + l1 + bwd + l0


def test_gat_flops_by_hand():
    c = _counts()
    dims, heads = [(4, 8), (8, 3)], [2, 1]
    # layer 0: 9 sources projected [9, 4] @ [4, 8]; 5 targets, 6 slots
    p0, a0 = 2 * 9 * 4 * 8, 2 * 5 * 8 + 2 * (6 + 5) * 8 * 2
    p1, a1 = 2 * 5 * 8 * 3, 2 * 2 * 3 + 2 * (3 + 2) * 3 * 2
    assert C.gat_flops(c, dims, heads, backward=False, input_grad=False) == p0 + a0 + p1 + a1
    full = p0 + a0 + p1 + a1 + (p0 + 2 * a0) + (p1 + 2 * a1) + p1
    assert C.gat_flops(c, dims, heads, backward=True, input_grad=False) == full


def test_full_graph_flops():
    assert C.full_graph_sage_flops(3, 5, [(2, 4)]) == 2 * 3 * 4 * 4 + 5 * 2
