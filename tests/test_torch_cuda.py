"""Kernels A-D on the card against their plain PyTorch versions, and one
tiny training step on the card against the same step on the CPU.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card every test
here skips. On a machine with an H100 run them with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.

Tolerances: A, B and C move bits and must be exact. D sums up to K f32
values in another order than its plain version: K f32 ulps of the largest
output, plus one bf16 ulp when the output is rounded to bf16."""

import numpy as np
import pytest
import torch

import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch.embedding import Embedding, LazyAdam
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops import spmm_kernels as S

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


def test_train_step_on_card_matches_cpu(dev):
    cfg = wt.SageTrainConfig(n_nodes=300, deg=8, dim=32, hidden=32, num_classes=4, batch=16,
                             fanouts=(3, 4))
    rs = np.random.RandomState(0)
    degs = rs.randint(4, 13, cfg.n_nodes)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32))
    col = torch.from_numpy(rs.randint(0, cfg.n_nodes, int(row_ptr[-1])).astype(np.int32))
    table = rs.randn(cfg.n_nodes, cfg.dim).astype(np.float32)
    labels = torch.from_numpy(rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32))
    weights = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device="cpu").state_dict()

    def state(d):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=d)
        model.load_state_dict(weights)
        return wt.SageTrainState(
            cfg, GraphStructure(row_ptr.to(d), col.to(d), cfg.n_nodes),
            Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=d)
            .from_array(table),
            model, torch.optim.Adam(model.parameters(), lr=cfg.lr), labels.to(d))

    on_card, on_cpu = state(dev), state("cpu")
    for i in range(2):
        c = torch.from_numpy(rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32))
        a = wt.train_step(on_card, c.to(dev), on_card.labels[c.long().to(dev)], seed=i)
        b = wt.train_step(on_cpu, c, on_cpu.labels[c.long()], seed=i)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(on_card.embedding.table.cpu(), on_cpu.embedding.table,
                               rtol=1e-5, atol=1e-5)
