"""The plain contracts of kernels G (CSR SpMM) and H (CSR SDDMM), the
versions their wrappers run on the CPU and that the card's kernels are held
against, checked against float64 numpy loops: empty rows, the mean by edge
count, clipped columns, row strides, the stable transposed CSR, and the
autograd Functions' backward against numpy.

Tolerance: f32 sums against float64 references, rtol/atol 1e-5."""

import numpy as np
import pytest
import torch

from wholegraph_tpu_torch.ops import spmm_kernels as K
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _csr(seed=0, n=50, n_src=40, hi=9):
    rs = np.random.RandomState(seed)
    deg = rs.randint(0, hi, n)
    deg[[0, 7, n - 1]] = 0  # empty rows, the last one too
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rs.randint(0, n_src, int(rp[-1])).astype(np.int32)
    return rs, rp, col


def _ref_spmm(rp, col, x, w=None, mean=False):
    out = np.zeros((len(rp) - 1, x.shape[1]))
    for d in range(len(rp) - 1):
        for e in range(rp[d], rp[d + 1]):
            c = min(max(int(col[e]), 0), len(x) - 1)
            out[d] += (1.0 if w is None else float(w[e])) * x[c].astype(np.float64)
        if mean:
            out[d] /= max(rp[d + 1] - rp[d], 1)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("reduce,weighted", [("sum", False), ("mean", False), ("sum", True),
                                             ("mean", True)])
def test_csr_spmm_plain_contract(reduce, weighted):
    rs, rp, col = _csr()
    col[3] = 99  # out of range: clipped to the last row, as the kernel clips
    x = rs.randn(40, 6).astype(np.float32)
    w = rs.rand(len(col)).astype(np.float32) if weighted else None
    args = (_t(rp), _t(col), _t(x))
    kw = dict(reduce=reduce, edge_weight=None if w is None else _t(w))
    out = K.csr_spmm_plain(*args, **kw)
    assert out.dtype == torch.float32 and out.shape == (50, 6)
    np.testing.assert_allclose(out.numpy(), _ref_spmm(rp, col, x, w, reduce == "mean"), **TOL)
    assert not out[[0, 7, 49]].any()  # empty rows give zero
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = K.CSR_SPMM.launches
    assert torch.equal(K.csr_spmm(*args, **kw), out)
    assert K.CSR_SPMM.launches == before


def test_csr_spmm_mean_divides_by_edge_count_not_weight_sum():
    rp = np.array([0, 2, 3], np.int32)
    col = np.array([0, 1, 1], np.int32)
    x = np.array([[2.0], [4.0]], np.float32)
    w = np.array([0.5, 0.25, 3.0], np.float32)
    out = K.csr_spmm(_t(rp), _t(col), _t(x), reduce="mean", edge_weight=_t(w))
    np.testing.assert_allclose(out.numpy(), [[(0.5 * 2 + 0.25 * 4) / 2], [3.0 * 4]], **TOL)


def test_csr_spmm_plain_bf16_accumulates_in_f32():
    rs, rp, col = _csr(seed=1)
    x = torch.randn(40, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = K.csr_spmm(_t(rp), _t(col), x, reduce="sum")
    assert out.dtype == torch.bfloat16
    ref = _ref_spmm(rp, col, x.float().numpy())
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -7)


def test_csr_spmm_and_sddmm_take_row_strides():
    """One GAT head, ``featv[:, h, :]``, is a view with row stride H·D."""
    rs, rp, col = _csr(seed=2)
    featv = _t(rs.randn(40, 4, 16).astype(np.float32))
    head = featv[:, 2, :]
    assert head.stride() == (64, 1)
    np.testing.assert_allclose(K.csr_spmm(_t(rp), _t(col), head, reduce="mean").numpy(),
                               _ref_spmm(rp, col, head.contiguous().numpy(), mean=True), **TOL)
    a = _t(rs.randn(50, 4, 16).astype(np.float32))[:, 1, :]
    e = K.csr_sddmm(_t(rp), _t(col), a, head)
    np.testing.assert_array_equal(e.numpy(),
                                  K.csr_sddmm(_t(rp), _t(col), a.contiguous(),
                                              head.contiguous()).numpy())


def test_csr_sddmm_plain_contract():
    rs, rp, col = _csr(seed=3)
    a = rs.randn(50, 5).astype(np.float32)
    b = rs.randn(40, 5).astype(np.float32)
    out = K.csr_sddmm(_t(rp), _t(col), _t(a), _t(b))
    assert out.dtype == torch.float32 and out.shape == (len(col),)
    dst = np.repeat(np.arange(50), np.diff(rp))
    np.testing.assert_allclose(out.numpy(), (a[dst].astype(np.float64) * b[col]).sum(1), **TOL)
    with pytest.raises(InvalidInput, match="num_dst"):
        K.csr_sddmm(_t(rp), _t(col), _t(b), _t(b))
    with pytest.raises(InvalidInput, match="dim mismatch"):
        K.csr_sddmm(_t(rp), _t(col), _t(a), _t(b[:, :4]))


def test_plain_versions_chunk_the_edges(monkeypatch):
    rs, rp, col = _csr(seed=4, n=300, hi=20)
    x = _t(rs.randn(40, 3).astype(np.float32))
    a = _t(rs.randn(300, 3).astype(np.float32))
    w = _t(rs.rand(len(col)).astype(np.float32))
    whole = K.csr_spmm_plain(_t(rp), _t(col), x, edge_weight=w)
    e_whole = K.csr_sddmm_plain(_t(rp), _t(col), a, x)
    monkeypatch.setattr(K, "PLAIN_CHUNK", 37)
    assert len(col) > 37 * 10
    np.testing.assert_allclose(K.csr_spmm_plain(_t(rp), _t(col), x, edge_weight=w), whole, **TOL)
    np.testing.assert_array_equal(K.csr_sddmm_plain(_t(rp), _t(col), a, x), e_whole)


def test_transpose_csr_is_stable():
    rs, rp, col = _csr(seed=5)
    t_rp, t_col, perm = K.transpose_csr(_t(rp), _t(col), 40)
    assert t_rp.dtype == t_col.dtype == torch.int32 and perm.dtype == torch.int64
    dst = np.repeat(np.arange(50), np.diff(rp))
    order = np.argsort(col, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(t_col.numpy(), dst[order])
    np.testing.assert_array_equal(t_rp.numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(col, minlength=40))]))
    # within each source row, the destinations keep their CSR order
    for s in range(40):
        seg = t_col.numpy()[t_rp[s]:t_rp[s + 1]]
        assert (np.diff(seg) >= 0).all()
    np.testing.assert_array_equal(K.csr_edge_dst(_t(rp), len(col)).numpy(), dst)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_csr_spmm_autograd_matches_numpy(reduce):
    """dx = G on the transposed CSR (ct scaled by 1/deg for the mean); dw =
    H with the same scaled ct; both against float64 numpy."""
    rs, rp, col = _csr(seed=6)
    x = rs.randn(40, 4).astype(np.float32)
    w = rs.rand(len(col)).astype(np.float32)
    ct = rs.randn(50, 4).astype(np.float32)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    K.CsrSpmm.apply(_t(rp), _t(col), tx, tw, reduce).backward(_t(ct))
    deg = np.maximum(np.diff(rp), 1)[:, None]
    ctd = ct / deg if reduce == "mean" else ct.astype(np.float64)
    dst = np.repeat(np.arange(50), np.diff(rp))
    dx = np.zeros((40, 4))
    np.add.at(dx, col, w[:, None] * ctd[dst])
    np.testing.assert_allclose(tx.grad.numpy(), dx, **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), (ctd[dst] * x[col]).sum(1), **TOL)


def test_csr_sddmm_autograd_matches_numpy():
    rs, rp, col = _csr(seed=7)
    a = rs.randn(50, 4).astype(np.float32)
    b = rs.randn(40, 4).astype(np.float32)
    ct = rs.randn(len(col)).astype(np.float32)
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    K.CsrSddmm.apply(_t(rp), _t(col), ta, tb).backward(_t(ct))
    dst = np.repeat(np.arange(50), np.diff(rp))
    da, db = np.zeros_like(a, np.float64), np.zeros_like(b, np.float64)
    np.add.at(da, dst, ct[:, None] * b[col])
    np.add.at(db, col, ct[:, None] * a[dst])
    np.testing.assert_allclose(ta.grad.numpy(), da, **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), db, **TOL)


def _clustered(seed, n=700, width=96, long_row=None):
    rs = np.random.RandomState(seed)
    deg = rs.randint(0, 20, n)
    deg[[0, 9, n - 1]] = 0
    if long_row:
        deg[300] = long_row
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    dst = np.repeat(np.arange(n), deg)
    col = np.clip(dst + rs.randint(-width, width + 1, len(dst)), 0, n - 1).astype(np.int32)
    return rs, rp, col


@pytest.mark.parametrize("graph", ["clustered", "long_row", "random"])
def test_csr_sddmm_stats_are_inert_on_the_cpu(graph):
    """On the CPU, ``csr_sddmm`` with the internal ``_stats`` runs the plain
    version: the dots of a float64 numpy loop, and the counts untouched
    (only the kernel adds to them)."""
    if graph == "random":
        rs, rp, col = _csr(seed=9, n=400, n_src=400, hi=12)
    else:
        rs, rp, col = _clustered(10, long_row=2000 if graph == "long_row" else None)
    n, D = len(rp) - 1, 7
    a = rs.randn(n, D).astype(np.float32)
    b = rs.randn(n, D).astype(np.float32)
    stats = torch.full((4,), 5, dtype=torch.int64)
    out = K.csr_sddmm(_t(rp), _t(col), _t(a), _t(b), _stats=stats)
    dst = np.repeat(np.arange(n), np.diff(rp))
    ref = (a[dst].astype(np.float64) * b[np.clip(col, 0, n - 1)]).sum(1)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert stats.tolist() == [5, 5, 5, 5]


@pytest.mark.parametrize("graph", ["clustered", "long_row", "random"])
@pytest.mark.parametrize("stage", [True, False])
def test_csr_spmm_stats_are_inert_on_the_cpu(graph, stage):
    """On the CPU, ``csr_spmm`` with the internal ``_stats`` and ``_stage``
    runs the plain version: the sums of a float64 numpy loop, and the counts
    untouched (only the kernel adds to them)."""
    if graph == "random":
        rs, rp, col = _csr(seed=11, n=400, n_src=400, hi=12)
    else:
        rs, rp, col = _clustered(12, long_row=2000 if graph == "long_row" else None)
    n, D = len(rp) - 1, 5
    x = rs.randn(n, D).astype(np.float32)
    w = rs.rand(len(col)).astype(np.float32)
    stats = torch.full((4,), 7, dtype=torch.int64)
    out = K.csr_spmm(_t(rp), _t(col), _t(x), edge_weight=_t(w), _stats=stats, _stage=stage)
    np.testing.assert_allclose(out.numpy(), _ref_spmm(rp, col, x, w), **TOL)
    assert stats.tolist() == [7, 7, 7, 7]


def test_csr_spmm_checks_its_stats():
    """``_stats`` must be a contiguous int64 tensor of at least 4 on x's
    device; it is checked before the device is looked at."""
    _, rp, col = _csr(seed=13)
    x = torch.zeros(40, 4)
    for bad in (torch.zeros(4, dtype=torch.int32), torch.zeros(3, dtype=torch.int64),
                torch.zeros(8, dtype=torch.int64)[::2], torch.zeros(4, dtype=torch.int64,
                                                                   device="meta")):
        with pytest.raises(InvalidInput, match="_stats"):
            K.csr_spmm(_t(rp), _t(col), x, _stats=bad)
    ok = torch.zeros(4, dtype=torch.int64)
    assert torch.equal(K.csr_spmm(_t(rp), _t(col), x, _stats=ok), K.csr_spmm(_t(rp), _t(col), x))


def test_spmm_plan_fits_two_ctas_an_sm():
    """Kernel G's plan: a tile of the bench graph's rows (each edge of row d
    to d ± 96) spans fewer than SPMM_WINDOW source rows, and the staged
    kernel's shared memory (edges, row offsets and ranks, two 128-byte slabs
    of the window) lets two CTAs share an H100 SM's 228 KB."""
    assert K.SPMM_TILE - 1 + 192 < K.SPMM_WINDOW
    smem = K.SPMM_EDGE_CAP * 8 + -(-(2 * K.SPMM_TILE + 1) * 4 // 16) * 16 + 2 * K.SPMM_WINDOW * 128
    assert 2 * (smem + 1024) <= 228 * 1024


def test_wrappers_check_their_inputs():
    _, rp, col = _csr(seed=8)
    x = torch.zeros(40, 4)
    with pytest.raises(InvalidInput):
        K.csr_spmm(_t(rp), _t(col), x, reduce="max")
    with pytest.raises(InvalidInput):
        K.csr_spmm(_t(rp), _t(col), x.double())
    with pytest.raises(InvalidInput):
        K.csr_spmm(_t(rp), _t(col), x, edge_weight=torch.zeros(3))
    with pytest.raises(InvalidInput):
        K.csr_spmm(_t(rp), _t(col).float(), x)
    empty = K.csr_spmm(_t(np.zeros(4, np.int32)), torch.zeros(0, dtype=torch.int32), x)
    assert empty.shape == (3, 4) and not empty.any()
