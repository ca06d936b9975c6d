"""Kernels A-J on the card against their plain PyTorch versions, one tiny
training step on the card against the same step on the CPU, the same for
the host-memory tier (kernels E and F on pinned host tables), tiny
full-graph models (kernels G and H), and the sharded row store (kernels I
and J, and B's masked route) on the card against the CPU.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card every test
here skips. On a machine with an H100 run them with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.

Tolerances: A, B, C, E, F, I and J move bits and must be exact, NaN
payloads and -0 included. D and G sum up to
K f32 values in another order than their plain versions: K f32 ulps of the
largest output (K the longest row), plus one bf16 ulp when the output is
rounded to bf16. H's dot of D products: D f32 ulps of the largest value."""

import numpy as np
import pytest
import torch

import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch import kernels
from wholegraph_tpu_torch.embedding import Embedding, HostEmbedding, LazyAdam
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.ops import spmm_kernels as S
from wholegraph_tpu_torch.utils.error import CudaError

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)
BF16_EPS = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 100, 3])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_row_gather_matches_plain(dev, dtype, D, id_dtype):
    table = torch.randn(500, D, generator=_gen(D)).to(dtype)
    ids = torch.randint(-5, 505, (3000,), generator=_gen(1), dtype=id_dtype)
    before = G.ROW_GATHER.launches
    out = G.gather_rows(table.to(dev), ids.to(dev))
    assert G.ROW_GATHER.launches == before + 1
    assert torch.equal(out.cpu(), G.gather_rows_plain(table, ids))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 100, 3])
def test_row_scatter_matches_plain(dev, dtype, D):
    table = torch.randn(500, D, generator=_gen(D)).to(dtype)
    ids = torch.randperm(500, generator=_gen(2))[:300].to(torch.int32)
    ids[::7] = -1
    ids[1] = 505
    rows = torch.randn(300, D, generator=_gen(3)).to(dtype)
    on_card = table.to(dev)
    before = G.ROW_SCATTER.launches
    G.scatter_rows(on_card, ids.to(dev), rows.to(dev))
    assert G.ROW_SCATTER.launches == before + 1
    assert torch.equal(on_card.cpu(), G.scatter_rows_plain(table.clone(), ids, rows))


@pytest.mark.parametrize("K", [3, 15, 200])
def test_sample_cols_matches_plain(dev, K):
    col = torch.randint(0, 1000, (20000,), generator=_gen(K), dtype=torch.int32)
    start = torch.randint(0, 19000, (700,), generator=_gen(4), dtype=torch.int32)
    pos = torch.randint(0, 400, (700, K), generator=_gen(5), dtype=torch.int32)
    mask = torch.rand(700, K, generator=_gen(6)) < 0.7
    before = G.SAMPLE_COLS.launches
    out = G.sample_cols(*(t.to(dev) for t in (col, start, pos, mask)))
    assert G.SAMPLE_COLS.launches == before + 1
    assert torch.equal(out.cpu(), G.sample_cols_plain(col, start, pos, mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 7])
@pytest.mark.parametrize("mean", [False, True])
def test_neighbor_reduce_matches_plain(dev, dtype, D, mean):
    B, K, U = 900, 15, 4000
    x = torch.randn(U, D, generator=_gen(D)).to(dtype)
    nbr = torch.randint(0, U, (B, K), generator=_gen(7), dtype=torch.int32)
    mask = torch.rand(B, K, generator=_gen(8)) < 0.8
    mask[0] = False
    before = S.NEIGHBOR_AGG.launches
    out = S.neighbor_reduce(x.to(dev), nbr.to(dev), mask.to(dev), mean).cpu()
    assert S.NEIGHBOR_AGG.launches == before + 1
    ref = S.neighbor_reduce_plain(x, nbr, mask, mean)
    scale = max(1.0, ref.float().abs().max().item())
    tol = K * F32_EPS * scale + (BF16_EPS * scale if dtype == torch.bfloat16 else 0.0)
    assert out.dtype == dtype and (out.float() - ref.float()).abs().max().item() <= tol
    assert not out[0].any()


def test_neighbor_reduce_grad_matches_cpu(dev):
    x = torch.randn(300, 64, generator=_gen(9))
    nbr = torch.randint(0, 300, (80, 10), generator=_gen(10), dtype=torch.int32)
    mask = torch.rand(80, 10, generator=_gen(11)) < 0.6
    ct = torch.randn(80, 64, generator=_gen(12))
    grads = []
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_()
        S.NeighborReduce.apply(xd, nbr.to(d), mask.to(d), True).backward(ct.to(d))
        grads.append(xd.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def _tiny_states():
    """``state(device, host_ratio=None)``: a tiny training state from the
    same numpy data and weights on any device; ``host_ratio`` puts the
    embedding in the host tier."""
    cfg = wt.SageTrainConfig(n_nodes=300, deg=8, dim=32, hidden=32, num_classes=4, batch=16,
                             fanouts=(3, 4))
    rs = np.random.RandomState(0)
    degs = rs.randint(4, 13, cfg.n_nodes)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32))
    col = torch.from_numpy(rs.randint(0, cfg.n_nodes, int(row_ptr[-1])).astype(np.int32))
    table = rs.randn(cfg.n_nodes, cfg.dim).astype(np.float32)
    labels = torch.from_numpy(rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32))
    weights = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device="cpu").state_dict()

    def state(d, host_ratio=None):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=d)
        model.load_state_dict(weights)
        if host_ratio is None:
            emb = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=d)
            emb.from_array(table)
        else:
            emb = HostEmbedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(),
                                       cache_ratio=host_ratio, device=d)
            emb.from_array(table, hot_ids=wt.embedding.hot_ids_by_degree(row_ptr, host_ratio))
        return wt.SageTrainState(
            cfg, GraphStructure(row_ptr.to(d), col.to(d), cfg.n_nodes), emb,
            model, torch.optim.Adam(model.parameters(), lr=cfg.lr), labels.to(d))

    batches = [torch.from_numpy(rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32))
               for _ in range(3)]
    return state, batches


def test_train_step_on_card_matches_cpu(dev):
    state, batches = _tiny_states()
    on_card, on_cpu = state(dev), state("cpu")
    for i, c in enumerate(batches[:2]):
        a = wt.train_step(on_card, c.to(dev), on_card.labels[c.long().to(dev)], seed=i)
        b = wt.train_step(on_cpu, c, on_cpu.labels[c.long()], seed=i)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(on_card.embedding.table.cpu(), on_cpu.embedding.table,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernels E and F: rows of pinned host tables
# ---------------------------------------------------------------------------


def _pinned(t):
    p = H.pinned_empty(t.shape, t.dtype)
    p.copy_(t)
    assert p.is_pinned() and p.device.type == "cpu"
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 100, 3])  # 16-, 8- and 4-byte vectors in f32
@pytest.mark.parametrize("slot_dtype", [torch.int32, torch.int64])
def test_host_gather_matches_plain(dev, dtype, D, slot_dtype):
    table = _pinned(torch.randn(500, D, generator=_gen(D)).to(dtype))
    slots = torch.randint(-5, 505, (3000,), generator=_gen(13), dtype=slot_dtype)
    before = H.HOST_GATHER.launches
    out = H.host_gather_rows(table, slots.to(dev))
    assert H.HOST_GATHER.launches == before + 1
    assert out.device.type == "cuda" and out.dtype == dtype
    ref = H.host_gather_rows_plain(table, slots)
    assert torch.equal(out.cpu(), ref)
    assert not ref[(slots < 0) | (slots >= 500)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 100, 3])
def test_host_scatter_matches_plain(dev, dtype, D):
    init = torch.randn(500, D, generator=_gen(D)).to(dtype)
    table = _pinned(init)
    slots = torch.randperm(500, generator=_gen(14))[:300].to(torch.int32)
    slots[::7] = -1
    slots[1] = 505
    rows = torch.randn(300, D, generator=_gen(15)).to(dtype)
    before = H.HOST_SCATTER.launches
    assert H.host_scatter_rows(table, slots.to(dev), rows.to(dev)) is table
    assert H.HOST_SCATTER.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(table, H.host_scatter_rows_plain(init.clone(), slots, rows))


def test_host_rows_of_a_view_at_an_offset(dev):
    """The entry points resolve the allocation's base and add the view's
    byte offset: a view 100 rows into a pinned table reads and writes its
    own rows and leaves the rows before it alone."""
    full = _pinned(torch.randn(600, 64, generator=_gen(16)))
    view = full[100:]
    head = full[:100].clone()
    slots = torch.randint(0, 500, (1000,), generator=_gen(17), dtype=torch.int32)
    assert torch.equal(H.host_gather_rows(view, slots.to(dev)).cpu(),
                       H.host_gather_rows_plain(view, slots))
    wslots = torch.randperm(500, generator=_gen(18))[:200]
    rows = torch.randn(200, 64, generator=_gen(19))
    H.host_scatter_rows(view, wslots.to(dev), rows.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(view[wslots], rows) and torch.equal(full[:100], head)


def test_host_rows_empty_batch(dev):
    table = _pinned(torch.randn(50, 8, generator=_gen(20)))
    before = (H.HOST_GATHER.launches, H.HOST_SCATTER.launches)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    out = H.host_gather_rows(table, empty)
    assert out.shape == (0, 8) and out.device.type == "cuda"
    H.host_scatter_rows(table, empty, torch.zeros(0, 8, device=dev))
    assert (H.HOST_GATHER.launches, H.HOST_SCATTER.launches) == before


def test_host_rows_refuse_memory_that_is_not_pinned(dev):
    table = torch.randn(50, 8, generator=_gen(21))  # pageable
    slots = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(CudaError, match="not in pinned"):
        H.host_gather_rows(table, slots)
    with pytest.raises(CudaError, match="not in pinned"):
        H.host_scatter_rows(table, slots, torch.zeros(4, 8, device=dev))
    # the C entry itself refuses a pointer CUDA has not mapped, and launches
    # nothing ...
    out = torch.zeros(4, 8, device=dev)
    before = H.HOST_GATHER.launches
    with pytest.raises(CudaError, match="host_gather"):
        H.HOST_GATHER(table.data_ptr(), 0, slots.data_ptr(), 0, out.data_ptr(), 50, 4, 32, 16,
                      kernels.cuda_stream(dev))
    assert H.HOST_GATHER.launches == before
    # ... and the refusal does not linger into the next launch
    assert torch.equal(H.host_gather_rows(_pinned(table), slots).cpu(), table[:4])


def test_host_tier_steps_on_card_match_cpu_and_hbm(dev):
    """Three tiny steps with the host tier on the card, on the CPU, and with
    the device-memory embedding on the card; the cache stays coherent with
    the host over the steps (each step's E reads see the last one's F
    writes)."""
    state, batches = _tiny_states()
    on_card, on_cpu, hbm = state(dev, 0.25), state("cpu", 0.25), state(dev)
    launches = (H.HOST_GATHER.launches, H.HOST_SCATTER.launches)
    for i, c in enumerate(batches):
        a = wt.train_step(on_card, c.to(dev), on_card.labels[c.long().to(dev)], seed=i)
        b = wt.train_step(on_cpu, c, on_cpu.labels[c.long()], seed=i)
        h = wt.train_step(hbm, c.to(dev), hbm.labels[c.long().to(dev)], seed=i)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a, h, rtol=1e-5, atol=1e-5)
    # per step: E once in the gather and 3x in the apply, F 3x
    assert H.HOST_GATHER.launches - launches[0] == 12
    assert H.HOST_SCATTER.launches - launches[1] == 9
    emb = on_card.embedding
    torch.testing.assert_close(torch.from_numpy(emb.to_array()), on_cpu.embedding.host_table,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(emb.host_table.to(dev), hbm.embedding.table, rtol=1e-5, atol=1e-5)
    cached = emb.cache_map >= 0
    assert torch.equal(emb.cache_rows[emb.cache_map[cached].long()].cpu(),
                       emb.host_table[cached.cpu()])


# ---------------------------------------------------------------------------
# kernels G and H: CSR SpMM and SDDMM
# ---------------------------------------------------------------------------


def _csr(n=900, n_src=700, hi=24, long_row=None, seed=22):
    """A CSR with empty rows (0, 5 and the last) and, optionally, one row of
    ``long_row`` edges."""
    g = _gen(seed)
    deg = torch.randint(0, hi, (n,), generator=g)
    deg[[0, 5, n - 1]] = 0
    if long_row:
        deg[3] = long_row
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64), deg.cumsum(0)]).to(torch.int32)
    col = torch.randint(0, n_src, (int(row_ptr[-1]),), generator=g, dtype=torch.int32)
    return row_ptr, col, int(deg.max())


def _g_tol(ref, K, dtype):
    """G's tolerance against its plain version: K f32 ulps of the largest
    output (K the longest row), plus one bf16 ulp when rounded to bf16."""
    scale = max(1.0, ref.float().abs().max().item())
    return K * F32_EPS * scale + (BF16_EPS * scale if dtype == torch.bfloat16 else 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 64, 6, 3])  # 16-byte vectors, a half-warp row, 8 and 4 bytes
@pytest.mark.parametrize("reduce,weighted", [("sum", False), ("mean", False), ("sum", True)])
def test_csr_spmm_matches_plain(dev, dtype, D, reduce, weighted):
    row_ptr, col, K = _csr(long_row=5000)
    x = torch.randn(700, D, generator=_gen(D)).to(dtype)
    w = torch.rand(col.shape[0], generator=_gen(23)) if weighted else None
    before = S.CSR_SPMM.launches
    out = S.csr_spmm(row_ptr.to(dev), col.to(dev), x.to(dev), reduce=reduce,
                     edge_weight=None if w is None else w.to(dev)).cpu()
    assert S.CSR_SPMM.launches == before + 1 and out.dtype == dtype
    ref = S.csr_spmm_plain(row_ptr, col, x, reduce=reduce, edge_weight=w)
    assert (out.float() - ref.float()).abs().max().item() <= _g_tol(ref, K, dtype)
    assert not out[[0, 5, 899]].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 64, 6, 3])
def test_csr_sddmm_matches_plain(dev, dtype, D):
    row_ptr, col, _ = _csr(long_row=5000)
    a = torch.randn(900, D, generator=_gen(24)).to(dtype)
    b = torch.randn(700, D, generator=_gen(25)).to(dtype)
    before = S.CSR_SDDMM.launches
    out = S.csr_sddmm(row_ptr.to(dev), col.to(dev), a.to(dev), b.to(dev)).cpu()
    assert S.CSR_SDDMM.launches == before + 1 and out.dtype == torch.float32
    ref = S.csr_sddmm_plain(row_ptr, col, a, b)
    # a dot of D products in another order: D f32 ulps of the largest value
    assert (out - ref).abs().max().item() <= D * F32_EPS * max(1.0, ref.abs().max().item())


def test_csr_kernels_take_gat_head_views(dev):
    """D = 64 heads of a [N, 4, 64] tensor, row stride 256, no copy."""
    row_ptr, col, K = _csr(n=700)
    featv = torch.randn(700, 4, 64, generator=_gen(26))
    alpha = torch.rand(col.shape[0], 4, generator=_gen(27))
    fd, ad = featv.to(dev), alpha.to(dev)
    for h in range(4):
        assert fd[:, h, :].stride() == (256, 1)
        out = S.csr_spmm(row_ptr.to(dev), col.to(dev), fd[:, h, :], edge_weight=ad[:, h]).cpu()
        ref = S.csr_spmm_plain(row_ptr, col, featv[:, h, :], edge_weight=alpha[:, h])
        assert (out - ref).abs().max().item() <= _g_tol(ref, K, torch.float32)
        e = S.csr_sddmm(row_ptr.to(dev), col.to(dev), fd[:, h, :], fd[:, (h + 1) % 4, :]).cpu()
        eref = S.csr_sddmm_plain(row_ptr, col, featv[:, h, :], featv[:, (h + 1) % 4, :])
        assert (e - eref).abs().max().item() <= 64 * F32_EPS * max(1.0, eref.abs().max().item())


def test_csr_spmm_autograd_on_card_matches_cpu(dev):
    """CsrSpmm (mean, and weighted sum) and CsrSddmm: forward and every
    gradient on the card against the same on the CPU; the transposed
    launches are counted under their own route."""
    row_ptr, col, _ = _csr(n=700)
    x = torch.randn(700, 64, generator=_gen(28))
    w = torch.rand(col.shape[0], generator=_gen(29))
    ct = torch.randn(700, 64, generator=_gen(30))
    ct_e = torch.randn(col.shape[0], generator=_gen(31))
    runs = []
    t0 = S.CSR_SPMM.routes.get("transposed", 0)
    for d in (dev, torch.device("cpu")):
        def leaf(t):
            return t.detach().clone().to(d).requires_grad_()

        xd, wd = leaf(x), leaf(w)
        rp, cd = row_ptr.to(d), col.to(d)
        S.CsrSpmm.apply(rp, cd, xd, None, "mean").backward(ct.to(d))
        gx_mean = xd.grad.clone()
        xd.grad = None
        S.CsrSpmm.apply(rp, cd, xd, wd, "sum").backward(ct.to(d))
        ad, bd = leaf(x), leaf(2 * x)
        S.CsrSddmm.apply(rp, cd, ad, bd).backward(ct_e.to(d))
        runs.append([t.cpu() for t in (gx_mean, xd.grad, wd.grad, ad.grad, bd.grad)])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert S.CSR_SPMM.routes.get("transposed", 0) - t0 == 3


def test_csr_kernels_refuse_a_cpu_cuda_mix(dev):
    row_ptr, col, _ = _csr()
    x = torch.randn(700, 8)
    with pytest.raises(CudaError):
        S.csr_spmm(row_ptr.to(dev), col.to(dev), x)
    with pytest.raises(CudaError):
        S.csr_sddmm(row_ptr, col.to(dev), torch.zeros(900, 8, device=dev), x.to(dev))


def test_full_graph_models_on_card_match_cpu(dev):
    """Tiny SAGE, GCN and GAT full-graph models: loss and every gradient on
    the card against the CPU from the same numpy data and weights."""
    import dataclasses

    cfg = wt.FullGraphConfig(n_nodes=700, deg=6, width=40, dim=64, hidden=64, num_classes=4)
    for model_type in ("sage", "gcn", "gat"):
        c = dataclasses.replace(cfg, model_type=model_type)
        on_cpu = wt.build_full_graph(c, device="cpu", seed=1)
        fg = on_cpu.graph.to_full_graph()
        model = HomoGNN(c.dim, c.hidden, c.num_classes, model_type=model_type, device=dev)
        model.load_state_dict(on_cpu.model.state_dict())
        gfg = GraphStructure(on_cpu.graph.row_ptr.to(dev), on_cpu.graph.col.to(dev),
                             c.n_nodes).to_full_graph()
        x = on_cpu.embedding.table
        centers = torch.arange(0, 700, 7, dtype=torch.int32)
        y = on_cpu.labels[centers.long()]
        la, (ga, dxa) = wt.full_graph_value_and_grad(model, x.to(dev), gfg, centers.to(dev),
                                                     y.to(dev))
        lb, (gb, dxb) = wt.full_graph_value_and_grad(on_cpu.model, x, fg, centers, y)
        torch.testing.assert_close(la.cpu(), lb, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dxa.cpu(), dxb, rtol=1e-5, atol=1e-5)
        for k in gb:
            torch.testing.assert_close(ga[k].cpu(), gb[k], rtol=1e-4, atol=1e-5, msg=k)


# ---------------------------------------------------------------------------
# kernels I and J, and B's masked route: the sharded row store
# ---------------------------------------------------------------------------


def _store_slots(case, n, B, id_dtype):
    """Slots of one pattern: sorted and dense, shuffled, duplicated, or
    sorted with ids outside ``[0, n)`` at both ends."""
    g = _gen(B + n)
    if case == "sorted":
        base = int(torch.randint(0, n - (5 * B) // 4, (1,), generator=g))
        s = torch.sort(base + torch.randperm((5 * B) // 4, generator=g)[:B]).values
    elif case == "unsorted":
        s = torch.randint(0, n, (B,), generator=g)
    elif case == "duplicates":
        s = torch.sort(torch.randint(n // 3, n // 3 + B // 4, (B,), generator=g)).values
    else:
        s = torch.sort(torch.randint(-40, n + 40, (B,), generator=g)).values
        s[:3], s[-3:] = torch.tensor([-(2**31) + 5, -1, 0]), torch.tensor([n - 1, n, n + 7])
    return s.to(id_dtype)


def _bits(t):
    """The tensor's bits, so NaN payloads and -0 compare exactly."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _store_table(n, D, dtype, seed=0):
    """Random rows with NaN payloads, infinities, -0 and denormals among them."""
    t = torch.randn(n, D, generator=_gen(seed)).to(dtype)
    bits = _bits(t)
    bits[1::97, 0] = 0x7FC0_1234 if dtype == torch.float32 else 0x7FC3
    bits[2::89, -1] = -(2**31) if dtype == torch.float32 else -(2**15)  # -0.0
    bits[3::83, 0] = 7  # a denormal
    t[5::101, -1] = float("inf")
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 16, 3])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["sorted", "unsorted", "duplicates", "out_of_range"])
def test_sorted_gather_matches_plain(dev, dtype, D, id_dtype, case):
    n, B = 6000, 3001  # the last tile is partial whatever the plan
    table = _store_table(n, D, dtype)
    slots = _store_slots(case, n, B, id_dtype)
    on_card, s_card = table.to(dev), slots.to(dev)
    for zero_invalid, plain in ((False, G.gather_rows_plain), (True, G.gather_rows_masked_plain)):
        before = G.SORTED_GATHER.launches
        out = G.gather_rows_sorted(on_card, s_card, zero_invalid=zero_invalid, density=0.8)
        assert G.SORTED_GATHER.launches == before + 1
        assert out.dtype == dtype and torch.equal(_bits(out.cpu()), _bits(plain(table, slots)))


@pytest.mark.parametrize("tile,window", [(32, 0), (32, 40), (64, 8), (1, 1), (1024, 2000),
                                         (100, 150)])
def test_sorted_gather_any_plan(dev, tile, window):
    """Exact whatever the tile and window: a window of 0 reads every row
    directly, one smaller than a tile's span does so for that tile, a
    window larger than the table is never filled past its last row."""
    table = _store_table(1500, 40, torch.float32, seed=1)
    slots = _store_slots("sorted", 1500, 1000, torch.int32)
    slots[500:520] = torch.randint(0, 1500, (20,), generator=_gen(3), dtype=torch.int32)
    out = G.gather_rows_sorted(table.to(dev), slots.to(dev), tile=tile, window=window)
    assert torch.equal(_bits(out.cpu()), _bits(G.gather_rows_plain(table, slots)))


def test_sorted_gather_wide_window_above_48kb(dev):
    """A window above 48 KB of shared memory (the default limit) launches."""
    table = _store_table(4000, 256, torch.float32, seed=2)
    slots = _store_slots("sorted", 4000, 2048, torch.int64)
    tile, window = G.sorted_plan(1024, density=0.2)
    assert window * 1024 > 48 * 1024
    out = G.gather_rows_sorted(table.to(dev), slots.to(dev), density=0.2)
    assert torch.equal(_bits(out.cpu()), _bits(G.gather_rows_plain(table, slots)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 16, 3])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_masked_gather_matches_plain(dev, dtype, D, id_dtype):
    table = _store_table(700, D, dtype)
    slots = _store_slots("out_of_range", 700, 2500, id_dtype)[torch.randperm(2500, generator=_gen(4))]
    before = G.ROW_GATHER_MASKED.launches
    out = G.gather_rows_masked(table.to(dev), slots.to(dev)).cpu()
    assert G.ROW_GATHER_MASKED.launches == before + 1
    assert torch.equal(_bits(out), _bits(G.gather_rows_masked_plain(table, slots)))
    assert not out[(slots < 0) | (slots >= 700)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 16, 3])
def test_masked_scatter_matches_plain(dev, dtype, D):
    table = _store_table(600, D, dtype)
    slots = torch.randperm(700, generator=_gen(5))[:400].to(torch.int32) - 50  # -50..649
    rows = _store_table(400, D, dtype, seed=6)
    on_card = table.to(dev)
    before, masked = G.ROW_SCATTER.launches, G.ROW_SCATTER.routes.get("masked", 0)
    assert G.scatter_rows_masked(on_card, slots.to(dev), rows.to(dev)) is on_card
    assert G.ROW_SCATTER.launches == before + 1
    assert G.ROW_SCATTER.routes["masked"] == masked + 1
    assert torch.equal(_bits(on_card.cpu()),
                       _bits(G.scatter_rows_plain(table.clone(), slots, rows)))


def test_store_kernels_empty_batches(dev):
    table = torch.randn(50, 8, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    before = {k.name: k.launches for k in (G.SORTED_GATHER, G.ROW_GATHER_MASKED, G.ROW_SCATTER)}
    assert G.gather_rows_sorted(table, none).shape == (0, 8)
    assert G.gather_rows_masked(table, none).shape == (0, 8)
    assert G.scatter_rows_masked(table, none, torch.zeros(0, 8, device=dev)) is table
    assert not G.gather_rows_masked(table[:0], torch.arange(4, device=dev)).any()
    assert before == {k.name: k.launches for k in (G.SORTED_GATHER, G.ROW_GATHER_MASKED,
                                                   G.ROW_SCATTER)}


def test_store_on_card_matches_cpu(dev):
    """ShardedTable on the card and on the CPU from the same numpy data:
    gather on both routes, its gradient, scatter as a set and as an add."""
    rs = np.random.RandomState(9)
    arr = rs.randn(300, 24).astype(np.float32)
    ids = np.sort(rs.randint(-5, 305, 700)).astype(np.int32)
    rows = rs.randn(700, 24).astype(np.float32)
    uniq = np.where(np.arange(700) < 280, rs.permutation(700)[:700] - 200, -1).astype(np.int32)
    res = []
    for d in (dev, torch.device("cpu")):
        t = wt.ShardedTable.from_array(arr, device=d)
        i = torch.from_numpy(ids).to(d)
        out = [t.gather(i, local_kernel=lk) for lk in ("ring", "sorted")]
        data = t.data.clone().requires_grad_()
        wt.ops.gather.gather(data, i, plan=t.plan, local_kernel="sorted").backward(
            torch.from_numpy(rows).to(d))
        r = torch.from_numpy(rows).to(d)
        setv = t.scatter(torch.from_numpy(uniq).to(d), r).to_array()
        setv = np.concatenate([setv, t.scatter(i, r).to_array()])  # duplicates: the last row
        addv = t.scatter(i, r, accumulate=True).to_array()
        res.append([o.cpu() for o in out] + [data.grad.cpu(), torch.from_numpy(setv),
                                             torch.from_numpy(addv)])
    for k, (a, b) in enumerate(zip(*res)):
        if k < 2 or k == 3:  # gathers and the set move bits
            assert torch.equal(a, b)
        else:  # sums of duplicates in another order
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
