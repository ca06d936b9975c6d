"""Kernels A-L on the card against their plain PyTorch versions, one tiny
training step on the card against the same step on the CPU, the same for
the host-memory tier (kernels E and F on pinned host tables), tiny
full-graph models (kernels G and H), the sharded row store (kernels I
and J, and B's masked route), and the weighted sampler (kernel K, alone, in
a multilayer sample and in training steps) on the card against the CPU.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card every test
here skips. On a machine with an H100 run them with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.

Tolerances: A, B, C, E, F, I and J move bits and must be exact, NaN
payloads and -0 included; L takes each step of the optimizer's update in
its plain version's order and rounding and must be exact too. D and G sum up to
K f32 values in another order than their plain versions: K f32 ulps of the
largest output (K the longest row), plus one bf16 ulp when the output is
rounded to bf16. H's dot of D products: D f32 ulps of the largest value.
K: bit-equal on every centre without a near tie (``ops.sampling.
weighted_near_ties``: two keys within 4 ulps near its cut, where ``logf``
on the card and the plain version's ``log`` may order them apart)."""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from test_torch_sparse_apply import (APPLY_DIMS, APPLY_KINDS, APPLY_LR, APPLY_OPTS, APPLY_STEP,
                                     ScaledSGD, apply_case, same_bits)

import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch import kernels
from wholegraph_tpu_torch.embedding import SGD, Embedding, HostEmbedding, LazyAdam
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN
from wholegraph_tpu_torch.models.conv import SAGEConv, _fg_spmm
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.ops import optim_kernels as L
from wholegraph_tpu_torch.ops import sampling as SM
from wholegraph_tpu_torch.ops import spmm_kernels as S
from wholegraph_tpu_torch.utils import perf
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


# Kernels A and B at the widths the paths give them (the hetero store's 64-,
# 128- and 192-byte rows, the main step's 1 KB rows, rows of 4-byte vectors)
# and shares of invalid ids from none to all, bit for bit.
AB_ROW_BYTES = [4, 12, 64, 128, 192, 1024, 1028]
AB_INVALID = [0.0, 2 / 3, 1.0]


def _ab_table(n, row_bytes, dtype, seed):
    return _store_table(n, row_bytes // torch.empty(0, dtype=dtype).element_size(), dtype,
                        seed=seed)


def _ab_ids(n, B, invalid, id_dtype, seed, unique):
    """``B`` ids, a share ``invalid`` of them outside ``[0, n)`` (either
    side, the type's extremes among them) and scattered through the batch,
    the rest in range (distinct with ``unique``)."""
    g = _gen(seed)
    n_bad = round(B * invalid)
    good = (torch.randperm(n, generator=g)[:B - n_bad] if unique
            else torch.randint(0, n, (B - n_bad,), generator=g))
    bad = torch.randint(-n, n, (n_bad,), generator=g)
    bad = torch.where(bad < 0, bad, bad + n)
    big = 2**31 - 1 if id_dtype == torch.int32 else 2**40
    bad[:4] = torch.tensor([-1, n, big, -big])[:n_bad]
    return torch.cat([good, bad])[torch.randperm(B, generator=g)].to(id_dtype)


@pytest.mark.parametrize("row_bytes", AB_ROW_BYTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("invalid", AB_INVALID)
def test_row_gather_widths_and_invalid_shares(dev, row_bytes, dtype, id_dtype, invalid):
    n, B = 3000, 5001  # the last tile is partial at every width
    table = _ab_table(n, row_bytes, dtype, row_bytes)
    ids = _ab_ids(n, B, invalid, id_dtype, row_bytes + 1, unique=False)
    before = G.ROW_GATHER.launches
    out = G.gather_rows(table.to(dev), ids.to(dev)).cpu()
    assert G.ROW_GATHER.launches == before + 1
    assert torch.equal(_bits(out), _bits(G.gather_rows_plain(table, ids)))


@pytest.mark.parametrize("row_bytes", AB_ROW_BYTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("invalid", AB_INVALID)
def test_row_scatter_widths_and_invalid_shares(dev, row_bytes, dtype, id_dtype, invalid):
    """Both of B's wrappers, the masked one counted under its route."""
    n, B = 6000, 5001
    table = _ab_table(n, row_bytes, dtype, row_bytes)
    ids = _ab_ids(n, B, invalid, id_dtype, row_bytes + 2, unique=True)
    rows = _ab_table(B, row_bytes, dtype, row_bytes + 3)
    ref = G.scatter_rows_plain(table.clone(), ids, rows)
    before, masked = G.ROW_SCATTER.launches, G.ROW_SCATTER.routes.get("masked", 0)
    for fn in (G.scatter_rows, G.scatter_rows_masked):
        on_card = table.to(dev)
        assert fn(on_card, ids.to(dev), rows.to(dev)) is on_card
        assert torch.equal(_bits(on_card.cpu()), _bits(ref)), fn.__name__
    assert G.ROW_SCATTER.launches == before + 2
    assert G.ROW_SCATTER.routes["masked"] == masked + 1


@pytest.mark.parametrize("row_bytes", AB_ROW_BYTES)
def test_row_gather_invalid_ids_on_one_row(dev, row_bytes):
    """Two thirds of the ids -1, all clipped onto row 0, as the typed
    gather sends its off-type slots."""
    n, B = 3000, 6000
    table = _ab_table(n, row_bytes, torch.float32, row_bytes)
    g = _gen(row_bytes)
    ids = torch.randint(0, n, (B,), generator=g, dtype=torch.int32)
    ids[torch.randperm(B, generator=g)[:2 * B // 3]] = -1
    out = G.gather_rows(table.to(dev), ids.to(dev)).cpu()
    assert torch.equal(_bits(out), _bits(G.gather_rows_plain(table, ids)))
    assert torch.equal(_bits(out[ids < 0]), _bits(table[0].expand(int((ids < 0).sum()), -1)))


def test_row_gather_and_scatter_empty_batch(dev):
    table = torch.randn(50, 48, device=dev)
    before = (G.ROW_GATHER.launches, G.ROW_SCATTER.launches)
    for id_dtype in (torch.int32, torch.int64):
        none = torch.zeros(0, dtype=id_dtype, device=dev)
        assert G.gather_rows(table, none).shape == (0, 48)
        assert G.scatter_rows(table, none, torch.zeros(0, 48, device=dev)) is table
    assert (G.ROW_GATHER.launches, G.ROW_SCATTER.launches) == before


@pytest.mark.parametrize("offset_elems,vec", [(48, 16), (1, 4)])
def test_row_gather_and_scatter_of_a_view_at_an_offset(dev, offset_elems, vec):
    """A table that starts a row, or one element, into its storage: 16- or
    4-byte vectors."""
    n, D, B = 2000, 48, 3001
    base = _store_table(n + 1, D, torch.float32, seed=9).view(-1)
    table = base.to(dev)[offset_elems:offset_elems + n * D].view(n, D)
    out_card = torch.empty(B, D, device=dev)
    assert G.vector_bytes(D * 4, table.data_ptr(), out_card.data_ptr()) == vec
    cpu = base[offset_elems:offset_elems + n * D].view(n, D)
    ids = _ab_ids(n, B, 2 / 3, torch.int32, 10, unique=False)
    assert torch.equal(_bits(G.gather_rows(table, ids.to(dev)).cpu()),
                       _bits(G.gather_rows_plain(cpu, ids)))
    ids = _ab_ids(n, 1500, 2 / 3, torch.int64, 11, unique=True)
    rows = torch.randn(1500, D, generator=_gen(12))
    G.scatter_rows(table, ids.to(dev), rows.to(dev))
    assert torch.equal(_bits(table.cpu()), _bits(G.scatter_rows_plain(cpu.clone(), ids, rows)))


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


SAMPLE_FIELDS = ("neighbors", "mask", "positions", "edge_ids", "degree")


def _sampler_graph(K, seed, n=300):
    """Rows 0-2 of degree 0, row 3 of degree K, row 4 of K + 1, row 5 a hub
    of max(50 K, 5000), the rest uniform in [0, 2K + 3]; the centres: every
    row, the special ones again, and ids outside [0, n) of both signs."""
    rs = np.random.RandomState(seed)
    degs = rs.randint(0, 2 * K + 4, n)
    degs[:6] = [0, 0, 0, K, K + 1, max(50 * K, 5000)]
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32))
    col = torch.from_numpy(rs.randint(0, n, int(row_ptr[-1])).astype(np.int32))
    centers = torch.from_numpy(np.concatenate([
        np.arange(n), [5, 3, 4, 0, 5], [-1, -7, n, n + 9, -(2**31), 2**31 - 1],
        rs.randint(0, n, 2500)]).astype(np.int32))
    return row_ptr, col, centers


def _assert_same_sample(a, b, what):
    for f in SAMPLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"{what}: {f} differs"


@pytest.mark.parametrize("K", [1, 10, 15, 16, 17, 32, 33, 129, 200])
def test_sample_hop_matches_plain(dev, K):
    """Kernel C's hop, all five fields, against its plain version: both
    register templates (K <= 16, K <= 32) and the warp kernel, on degree-0
    rows, degrees K and K+1, a hub and out-of-range centres."""
    row_ptr, col, centers = _sampler_graph(K, K)
    before = (SM.SAMPLE_HOP.launches, G.SAMPLE_COLS.launches)
    got = SM.csr_sample_neighbors(row_ptr.to(dev), col.to(dev), centers.to(dev), K,
                                  seed=5, hop=1)
    assert (SM.SAMPLE_HOP.launches, G.SAMPLE_COLS.launches) == (before[0] + 1, before[1])
    _assert_same_sample(got, SM.csr_sample_neighbors_plain(row_ptr, col, centers, K, 5, 1),
                        f"K={K}")
    again = SM.csr_sample_neighbors(row_ptr.to(dev), col.to(dev), centers.to(dev), K,
                                    seed=5, hop=1)
    _assert_same_sample(got, again, f"K={K}, a second run")


def test_sample_hop_takes_int64_row_ptr(dev):
    """An int64 row_ptr on the card samples as on the CPU, where the plain
    version takes it as it is."""
    row_ptr, col, centers = _sampler_graph(15, 15)
    got = SM.csr_sample_neighbors(row_ptr.long().to(dev), col.to(dev), centers.to(dev), 15,
                                  seed=5, hop=1)
    _assert_same_sample(got, SM.csr_sample_neighbors(row_ptr.long(), col, centers, 15, seed=5,
                                                     hop=1), "int64 row_ptr")


def _host_uniform(row_ptr, col, centers, K, seed, hop):
    """The uniform sampler one centre at a time in Python (the fixpoint
    iterated to convergence over sorted picks), for fanouts whose plain
    version would take millions of launches."""
    import bisect

    def mix(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & 0xFFFFFFFF
        return x ^ (x >> 16)

    pos = np.zeros((len(centers), K), np.int32)
    for b, c in enumerate(int(c) for c in centers):
        deg = int(row_ptr[c + 1] - row_ptr[c])
        assert deg > K
        h = mix((c & 0xFFFFFFFF) ^ mix(seed ^ 0x9E3779B9))
        chosen = []
        for j in range(K):
            r = mix(((hop * SM.HOP_STRIDE + j) & 0xFFFFFFFF) ^ h) % (deg - j)
            p = r
            while r + bisect.bisect_right(chosen, p) != p:
                p = r + bisect.bisect_right(chosen, p)
            bisect.insort(chosen, p)
            pos[b, j] = p
    return pos


def test_sample_hop_picks_in_device_memory(dev):
    """K = 3100: four warps' picks exceed 48 KB, so each centre's picks live
    in its own row of edge_ids until the last pass rewrites it."""
    K = 3100
    row_ptr = torch.tensor([0, 40_000, 43_101, 43_200], dtype=torch.int32)
    col = torch.arange(43_200, dtype=torch.int32).flip(0).contiguous()
    centers = torch.tensor([0, 1, 2, 0, 1], dtype=torch.int32)
    got = SM.csr_sample_neighbors(row_ptr.to(dev), col.to(dev), centers.to(dev), K,
                                  seed=9, hop=2)
    keep = [0, 1, 3, 4]  # degree > K; centre 2 (degree 99) takes all
    pos = _host_uniform(row_ptr.numpy(), col.numpy(), centers[keep].numpy(), K, 9, 2)
    assert torch.equal(got.positions.cpu()[keep], torch.from_numpy(pos))
    start = row_ptr[centers.long()]
    assert torch.equal(got.edge_ids.cpu()[keep], (start[:, None] + got.positions.cpu())[keep])
    assert torch.equal(got.neighbors.cpu()[keep], col[got.edge_ids.cpu()[keep].long()])
    assert got.mask.cpu()[keep].all() and got.mask.cpu()[2].sum() == 99
    assert torch.equal(got.positions.cpu()[2, :99], torch.arange(99, dtype=torch.int32))


@pytest.mark.parametrize("fanouts", [(10, 15), (40, 3)])
def test_multilayer_sample_on_card_matches_cpu(dev, fanouts):
    rs = np.random.RandomState(sum(fanouts))
    n = 2000
    src, dst = rs.randint(0, n, n * 12), rs.randint(0, n, n * 12)
    src[:3000] = 7  # a hub
    centers = torch.from_numpy(rs.choice(n, 256, replace=False).astype(np.int32))
    cmask = torch.from_numpy(rs.rand(256) < 0.9)
    on_card = GraphStructure.from_coo(src, dst, n, device=dev)
    on_cpu = GraphStructure.from_coo(src, dst, n, device="cpu")
    a = on_card.multilayer_sample(centers.to(dev), fanouts, seed=3, center_mask=cmask.to(dev))
    b = on_cpu.multilayer_sample(centers, fanouts, seed=3, center_mask=cmask)
    assert torch.equal(a.unique_gids.cpu(), b.unique_gids)
    assert torch.equal(a.unique_mask.cpu(), b.unique_mask)
    for x, y in zip(a.hops, b.hops):
        for f in ("nbr_idx", "mask", "center_mask"):
            assert torch.equal(getattr(x, f).cpu(), getattr(y, f)), f
    for x, y in zip(a.level_gids, b.level_gids):
        assert torch.equal(x.cpu(), y)


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


def _agg_sequential(x, nbr, mask, mean):
    """Kernel D's arithmetic on the CPU: an f32 sum in ascending k, each
    masked slot adding +0 (the kernel skips it: the same bits, as its sum
    starts at +0 and never reaches -0), the mean a correctly rounded f32
    division, then x's dtype (round to nearest even)."""
    idx = nbr.long().clamp(0, x.shape[0] - 1)
    acc = torch.zeros(nbr.shape[0], x.shape[1])
    for k in range(nbr.shape[1]):
        acc = acc + torch.where(mask[:, k:k + 1], x[idx[:, k]].float(), 0.0)
    if mean:
        acc = acc / mask.sum(dim=1, keepdim=True).clamp(min=1).float()
    return acc.to(x.dtype)


def _agg_block(U, B, K, seed, valid=0.8):
    """ids over [-3, U + 3) (out of range clipped), a share ``valid`` of the
    slots valid, centre 0 with none and the last (where B > 1) with all."""
    g = _gen(seed)
    nbr = torch.randint(-3, U + 3, (B, K), generator=g, dtype=torch.int32)
    mask = torch.rand(B, K, generator=g) < valid
    mask[-1] = True
    mask[0] = False
    return nbr, mask


def _check_agg(dev, x, nbr, mask, mean, x_dev=None):
    """D on the card: one launch, bit-equal to :func:`_agg_sequential` and
    within K f32 ulps (plus one bf16 ulp) of the plain version."""
    before = S.NEIGHBOR_AGG.launches
    out = S.neighbor_reduce(x.to(dev) if x_dev is None else x_dev, nbr.to(dev), mask.to(dev),
                            mean).cpu()
    assert S.NEIGHBOR_AGG.launches == before + 1
    assert out.dtype == x.dtype and out.shape == (nbr.shape[0], x.shape[1])
    assert torch.equal(_bits(out), _bits(_agg_sequential(x, nbr, mask, mean)))
    ref = S.neighbor_reduce_plain(x, nbr, mask, mean)
    scale = max(1.0, ref.float().abs().max().item())
    tol = nbr.shape[1] * F32_EPS * scale + (BF16_EPS * scale if x.dtype == torch.bfloat16 else 0.0)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert not out[0].any()
    return out


AGG_ROW_BYTES = [4, 12, 28, 64, 128, 192, 512, 1024, 1028]


@pytest.mark.parametrize("row_bytes", AGG_ROW_BYTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 10, 15, 31, 32, 33, 64])
def test_neighbor_reduce_widths_and_fanouts(dev, row_bytes, dtype, K):
    """Rows of 4..1028 bytes (16-, 8-, 4- and 2-byte vectors), K either side
    of a pass of 32 slots, sum and mean, all-masked and full centres, ids
    out of range."""
    U, B = 500, 301
    D = row_bytes // torch.empty(0, dtype=dtype).element_size()
    x = torch.randn(U, D, generator=_gen(row_bytes + K)).to(dtype)
    nbr, mask = _agg_block(U, B, K, row_bytes * K)
    for mean in (False, True):
        _check_agg(dev, x, nbr, mask, mean)


@pytest.mark.parametrize("B", [1, 2, 3, 7, 33, 1000, 4097, 70000])
@pytest.mark.parametrize("D", [256, 16])
def test_neighbor_reduce_batch_sizes(dev, B, D):
    """B from 1 to 70,000: 1 KB rows in two 512-byte slices, 64-byte rows
    two centres a warp, the last warp partly past the batch."""
    U, K = 3000, 15
    x = torch.randn(U, D, generator=_gen(B))
    nbr, mask = _agg_block(U, B, K, B + 1)
    for mean in (True, False):
        out = _check_agg(dev, x, nbr, mask, mean)
    if B > 1:
        assert torch.equal(out[-1], _agg_sequential(x, nbr[-1:], mask[-1:], False)[0])


@pytest.mark.parametrize("offset_elems,vec", [(256, 16), (1, 4), (2, 8)])
def test_neighbor_reduce_of_a_view_at_an_offset(dev, offset_elems, vec):
    """x a row, one or two elements into its storage: 16-, 4- or 8-byte
    vectors."""
    U, D, B, K = 2000, 256, 5000, 15
    base = torch.randn(U + 1, D, generator=_gen(offset_elems)).view(-1)
    x_dev = base.to(dev)[offset_elems:offset_elems + U * D].view(U, D)
    out_dev = torch.empty(B, D, device=dev)
    assert G.vector_bytes(D * 4, x_dev.data_ptr(), out_dev.data_ptr()) == vec
    nbr, mask = _agg_block(U, B, K, 3)
    x = base[offset_elems:offset_elems + U * D].view(U, D)
    for mean in (False, True):
        _check_agg(dev, x, nbr, mask, mean, x_dev=x_dev)


@pytest.mark.parametrize("case,plan", [
    ("1 KB rows, 16 lanes a centre, 4 slices", (16, 4)),
    ("1 KB rows, 8 lanes a centre, 8 slices", (8, 8)),
    ("64-byte rows, 4 lanes a centre", (4, 1)),
    ("64-byte rows, 8 lanes a centre", (8, 1)),
    ("64-byte rows, a warp a centre", (32, 1)),
    ("64-byte rows, 2 lanes a centre, 2 slices", (2, 2)),
])
def test_neighbor_reduce_forced_routes(dev, monkeypatch, case, plan):
    """Each route forced on a call its rule would send elsewhere: the same
    bits as the chosen route (both add in ascending k), one launch."""
    U, B, K = 4000, 3000, 15
    D = 256 if case.startswith("1 KB") else 16
    x = torch.randn(U, D, generator=_gen(D))
    nbr, mask = _agg_block(U, B, K, 5)
    chosen = S.neighbor_reduce(x.to(dev), nbr.to(dev), mask.to(dev), True).cpu()
    assert S.agg_plan(K, D * 4, 16) != plan
    monkeypatch.setattr(S, "agg_plan", lambda *a: plan)
    forced = _check_agg(dev, x, nbr, mask, True)
    assert torch.equal(_bits(forced), _bits(chosen))


def test_neighbor_reduce_refuses_a_plan_that_misses_the_row(dev, monkeypatch):
    """A plan whose slices do not cover the row never launches."""
    x = torch.randn(100, 256, device=dev)
    nbr, mask = _agg_block(100, 10, 5, 6)
    monkeypatch.setattr(S, "agg_plan", lambda *a: (32, 1))  # 32 of 64 vectors
    before = S.NEIGHBOR_AGG.launches
    with pytest.raises(CudaError):
        S.neighbor_reduce(x, nbr.to(dev), mask.to(dev), True)
    assert S.NEIGHBOR_AGG.launches == before


def test_neighbor_reduce_is_deterministic(dev):
    """Two runs of the step's first-layer shape give the same bits."""
    U, B, K = 20000, 11264, 15
    x = torch.randn(U, 256, generator=_gen(13)).to(dev)
    nbr, mask = _agg_block(U, B, K, 14)
    nbr, mask = nbr.to(dev), mask.to(dev)
    a = S.neighbor_reduce(x, nbr, mask, True)
    assert torch.equal(_bits(a), _bits(S.neighbor_reduce(x, nbr, mask, True)))


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


def _host_slots(case, slot_dtype, n=500, B=3000):
    """Slots of a 3000-slot batch (many of E's tiles) over a 500-row table:
    uniform with invalid ones, the same sorted, few rows repeated (duplicate
    runs across tiles), runs of adjacent rows, isolated rows, one row for
    every slot, and ascending valid slots with a tail of -1 (the apply's)."""
    g = _gen(13)
    if case == "uniform":
        s = torch.randint(-5, n + 5, (B,), generator=g)
    elif case == "sorted":
        s = torch.randint(-5, n + 5, (B,), generator=g).sort().values
    elif case == "duplicates":
        s = torch.randint(0, 40, (B,), generator=g)
        s[::97] = -3
    elif case == "runs":
        s = (torch.arange(B) % 300 + 100)[torch.randperm(B, generator=g)]
    elif case == "isolated":  # rows 7 apart, never adjacent
        s = torch.randint(0, n // 7, (B,), generator=g) * 7
    elif case == "one_row":
        s = torch.full((B,), 17)
    else:  # "ascending": what the apply passes, sorted unique then -1
        s = torch.full((B,), -1)
        u = torch.randperm(n, generator=g)[:400].sort().values
        s[:400] = u
    return s.to(slot_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 100, 3])  # 16-, 8- and 4-byte vectors in f32
@pytest.mark.parametrize("slot_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["uniform", "sorted", "duplicates", "runs", "isolated",
                                  "one_row", "ascending"])
def test_host_gather_matches_plain(dev, dtype, D, slot_dtype, case):
    table = _pinned(torch.randn(500, D, generator=_gen(D)).to(dtype))
    slots = _host_slots(case, slot_dtype)
    before = H.HOST_GATHER.launches
    stats = torch.zeros(1, dtype=torch.int64, device=dev)
    out = H.host_gather_rows(table, slots.to(dev), _sort=case != "ascending", _stats=stats)
    assert H.HOST_GATHER.launches == before + 1
    assert out.device.type == "cuda" and out.dtype == dtype
    ref = H.host_gather_rows_plain(table, slots)
    assert torch.equal(out.cpu(), ref)
    assert not ref[(slots < 0) | (slots >= 500)].any()
    # the kernel's own count: each distinct valid row read once
    valid = slots[(slots >= 0) & (slots < 500)]
    assert stats.item() == torch.unique(valid).numel() * D * table.element_size()


def test_host_gather_unsorted_slots_without_the_sort_stay_exact(dev):
    """``_sort=False`` only skips the sort: slots in any order give the same
    rows; E then reads a row again where its slots are not adjacent."""
    table = _pinned(torch.randn(500, 64, generator=_gen(30)))
    slots = torch.randint(-5, 505, (3000,), generator=_gen(31), dtype=torch.int32)
    stats = torch.zeros(1, dtype=torch.int64, device=dev)
    out = H.host_gather_rows(table, slots.to(dev), _sort=False, _stats=stats)
    assert torch.equal(out.cpu(), H.host_gather_rows_plain(table, slots))
    valid = slots[(slots >= 0) & (slots < 500)]
    assert torch.unique(valid).numel() * 256 < stats.item() <= valid.numel() * 256


@pytest.mark.parametrize("D", [1024, 20000])  # 4 KB and 80 KB rows
def test_host_gather_wide_rows(dev, D):
    table = _pinned(torch.randn(300, D, generator=_gen(32)))
    slots = torch.randint(-2, 302, (200,), generator=_gen(33), dtype=torch.int64)
    out = H.host_gather_rows(table, slots.to(dev))
    assert torch.equal(out.cpu(), H.host_gather_rows_plain(table, slots))


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
        H.HOST_GATHER(table.data_ptr(), 0, slots.data_ptr(), 0, None, out.data_ptr(), 50, 4, 32,
                      16, None, kernels.cuda_stream(dev))
    assert H.HOST_GATHER.launches == before
    # ... and the refusal does not linger into the next launch
    assert torch.equal(H.host_gather_rows(_pinned(table), slots).cpu(), table[:4])


def test_host_tier_steps_on_card_match_cpu_and_hbm(dev):
    """Three tiny steps with the host tier on the card, on the CPU, and with
    the device-memory embedding on the card; the cache stays coherent with
    the host over the steps (each step's E reads see the last one's writes
    by kernel L's host route)."""
    state, batches = _tiny_states()
    on_card, on_cpu, hbm = state(dev, 0.25), state("cpu", 0.25), state(dev)
    launches = (H.HOST_GATHER.launches, H.HOST_SCATTER.launches, L.SPARSE_APPLY_HOST.launches,
                G.ROW_SCATTER.launches)
    for i, c in enumerate(batches):
        a = wt.train_step(on_card, c.to(dev), on_card.labels[c.long().to(dev)], seed=i)
        b = wt.train_step(on_cpu, c, on_cpu.labels[c.long()], seed=i)
        h = wt.train_step(hbm, c.to(dev), hbm.labels[c.long().to(dev)], seed=i)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a, h, rtol=1e-5, atol=1e-5)
    # per step: E once in the gather, L's host route once in the apply, no F and no B
    assert H.HOST_GATHER.launches - launches[0] == 3
    assert H.HOST_SCATTER.launches - launches[1] == 0
    assert L.SPARSE_APPLY_HOST.launches - launches[2] == 3
    assert G.ROW_SCATTER.launches - launches[3] == 0
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


def _clustered_csr(n=2000, long_row=None, seed=28):
    """A locality-ordered CSR (each edge of row d to d ± 96, as
    ``clustered_csr``) with empty rows and, optionally, one row of
    ``long_row`` edges: kernel H stages every tile's window but that row's."""
    g = _gen(seed)
    deg = torch.randint(0, 32, (n,), generator=g)
    deg[[0, 5, 300, n - 1]] = 0
    if long_row:
        deg[700] = long_row
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64), deg.cumsum(0)]).to(torch.int32)
    dst = torch.repeat_interleave(torch.arange(n), deg)
    col = (dst + torch.randint(-96, 97, dst.shape, generator=g)).clamp(0, n - 1).to(torch.int32)
    return row_ptr, col


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 64, 6, 3])
@pytest.mark.parametrize("graph", ["random", "clustered", "clustered_long_row"])
def test_csr_sddmm_matches_plain(dev, dtype, D, graph):
    """Random columns (no window fits: device-memory tiles, one row of 5000
    edges), a clustered CSR (every tile staged in shared memory) and the
    same with a row of 5000 edges (its tile, past the edge cap, reads device
    memory). Two runs are bit-identical."""
    if graph == "random":
        row_ptr, col, _ = _csr(long_row=5000)
    else:
        row_ptr, col = _clustered_csr(long_row=5000 if graph == "clustered_long_row" else None)
    n, n_src = row_ptr.shape[0] - 1, int(col.max()) + 1
    a = torch.randn(n, D, generator=_gen(24)).to(dtype)
    b = torch.randn(n_src, D, generator=_gen(25)).to(dtype)
    args = (row_ptr.to(dev), col.to(dev), a.to(dev), b.to(dev))
    before = S.CSR_SDDMM.launches
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    out = S.csr_sddmm(*args, _stats=stats)
    assert S.CSR_SDDMM.launches == before + 1 and out.dtype == torch.float32
    assert torch.equal(out, S.csr_sddmm(*args))
    # the kernel's own counts: every tile with edges staged or read device
    # memory; the long row's tile reads device memory, a clustered graph's
    # others stage, and no window fits the random graph's
    staged, staged_bytes, from_device, device_edges = stats.tolist()
    bounds = row_ptr[torch.arange(0, n + S.SDDMM_TILE, S.SDDMM_TILE).clamp(max=n)]
    tiles = int((bounds[1:] > bounds[:-1]).sum())
    assert staged + from_device == tiles
    assert (staged, from_device) == ((tiles, 0) if graph == "clustered" else
                                     (tiles - 1, 1) if graph == "clustered_long_row" else
                                     (0, tiles))
    assert staged_bytes % (D * a.element_size()) == 0 and (staged_bytes > 0) == (staged > 0)
    if graph == "random":
        assert device_edges == col.shape[0]
    else:
        assert device_edges == 0 if graph == "clustered" else device_edges >= 5000
    ref = S.csr_sddmm_plain(row_ptr, col, a, b)
    # a dot of D products in another order: D f32 ulps of the largest value
    assert (out.cpu() - ref).abs().max().item() <= D * F32_EPS * max(1.0, ref.abs().max().item())


def _g_tiles(row_ptr):
    """Kernel G's tiles (SPMM_TILE rows each) and their edge counts."""
    n = row_ptr.shape[0] - 1
    bounds = row_ptr[torch.arange(0, n + S.SPMM_TILE, S.SPMM_TILE).clamp(max=n)].long()
    return bounds[1:] - bounds[:-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 64, 6, 3])
@pytest.mark.parametrize("reduce,weighted", [("sum", False), ("mean", False), ("sum", True)])
@pytest.mark.parametrize("graph", ["clustered", "clustered_long_row", "uniform"])
def test_csr_spmm_stages_clustered_tiles(dev, dtype, D, reduce, weighted, graph):
    """A clustered CSR (every tile staged in shared memory, by G's own
    counts), the same with a row of 5000 edges (its tile, past the edge cap,
    computed from device memory) and uniform columns (every tile from device
    memory); empty rows in each. The staged route is bit-equal to the route
    through device memory alone (``_stage=False``), two runs are bit-identical,
    and both are within G's tolerance of the plain version."""
    if graph == "uniform":
        row_ptr, col, _ = _csr(long_row=5000)
    else:
        row_ptr, col = _clustered_csr(long_row=5000 if graph == "clustered_long_row" else None)
    K = int((row_ptr[1:] - row_ptr[:-1]).max())
    n, n_src = row_ptr.shape[0] - 1, int(col.max()) + 1
    x = torch.randn(n_src, D, generator=_gen(D + 1)).to(dtype)
    w = torch.rand(col.shape[0], generator=_gen(32)) if weighted else None
    args = (row_ptr.to(dev), col.to(dev), x.to(dev))
    kw = dict(reduce=reduce, edge_weight=None if w is None else w.to(dev))
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    before = S.CSR_SPMM.launches
    out = S.csr_spmm(*args, **kw, _stats=stats)
    assert S.CSR_SPMM.launches == before + 1 and out.dtype == dtype
    device_only = torch.zeros(4, dtype=torch.int64, device=dev)
    assert torch.equal(_bits(out), _bits(S.csr_spmm(*args, **kw, _stage=False, _stats=device_only)))
    assert torch.equal(_bits(out), _bits(S.csr_spmm(*args, **kw)))
    ref = S.csr_spmm_plain(row_ptr, col, x, reduce=reduce, edge_weight=w)
    assert (out.cpu().float() - ref.float()).abs().max().item() <= _g_tol(ref, K, dtype)
    empty = (row_ptr[1:] == row_ptr[:-1]).nonzero().flatten()
    assert empty.numel() >= 3 and not out[empty.to(dev)].any()
    # G's own counts: every tile staged or from device memory
    edges = _g_tiles(row_ptr)
    tiles = edges.numel()
    staged, staged_bytes, from_device, device_edges = stats.tolist()
    assert staged + from_device == tiles
    if graph == "clustered":
        assert (staged, from_device, device_edges) == (tiles, 0, 0)
    elif graph == "clustered_long_row":
        assert (staged, from_device) == (tiles - 1, 1) and device_edges == int(edges.max()) >= 5000
    else:
        assert (staged, device_edges) == (0, col.shape[0])
    assert staged_bytes % (D * x.element_size()) == 0 and (staged_bytes > 0) == (staged > 0)
    assert device_only.tolist() == [0, 0, tiles, col.shape[0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_stages_gat_head_views(dev, dtype):
    """Heads of a [N, 4, 64] tensor (row stride 256) over a clustered CSR
    with self loops, weighted by attention: staged, bit-equal to the device
    route, on the forward CSR and on its transpose."""
    row_ptr, col = _clustered_csr(n=1500)
    n = row_ptr.shape[0] - 1
    deg = row_ptr[1:] - row_ptr[:-1]
    dst = torch.repeat_interleave(torch.arange(n), deg)
    # a self loop after each row's edges, as the GAT layer's graph
    keys = torch.cat([dst * n + col.long(), torch.arange(n) * n + torch.arange(n)])
    order = torch.sort(torch.cat([dst, torch.arange(n)]), stable=True).indices
    col = (keys[order] % n).to(torch.int32)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64), (deg + 1).cumsum(0)]).to(torch.int32)
    featv = torch.randn(n, 4, 64, generator=_gen(33)).to(dtype)
    alpha = torch.rand(col.shape[0], 4, generator=_gen(34))
    t_rp, t_col, perm = S.transpose_csr(row_ptr, col, n)
    fd, ad = featv.to(dev), alpha.to(dev)
    for rp, cl, wt in ((row_ptr, col, alpha), (t_rp, t_col, alpha[perm])):
        K = int((rp[1:] - rp[:-1]).max())
        for h in range(4):
            head = fd[:, h, :]
            assert head.stride() == (256, 1)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            args = (rp.to(dev), cl.to(dev), head)
            out = S.csr_spmm(*args, edge_weight=wt[:, h].to(dev), _stats=stats)
            dev_route = S.csr_spmm(*args, edge_weight=wt[:, h].to(dev), _stage=False)
            assert torch.equal(_bits(out), _bits(dev_route))
            assert stats[0] == _g_tiles(rp).numel() and stats[2] == 0
            ref = S.csr_spmm_plain(rp, cl, featv[:, h, :], edge_weight=wt[:, h])
            assert (out.cpu().float() - ref.float()).abs().max().item() <= _g_tol(ref, K, dtype)


@pytest.mark.parametrize("graph", ["random", "clustered"])
def test_csr_kernels_take_gat_head_views(dev, graph):
    """D = 64 heads of a [N, 4, 64] tensor, row stride 256, no copy; on a
    clustered CSR H stages the strided head rows in shared memory."""
    if graph == "random":
        row_ptr, col, K = _csr(n=700)
    else:
        row_ptr, col = _clustered_csr(n=700)
        K = int((row_ptr[1:] - row_ptr[:-1]).max())
    featv = torch.randn(700, 4, 64, generator=_gen(26))
    alpha = torch.rand(col.shape[0], 4, generator=_gen(27))
    fd, ad = featv.to(dev), alpha.to(dev)
    for h in range(4):
        assert fd[:, h, :].stride() == (256, 1)
        out = S.csr_spmm(row_ptr.to(dev), col.to(dev), fd[:, h, :], edge_weight=ad[:, h]).cpu()
        ref = S.csr_spmm_plain(row_ptr, col, featv[:, h, :], edge_weight=alpha[:, h])
        assert (out - ref).abs().max().item() <= _g_tol(ref, K, torch.float32)
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        e = S.csr_sddmm(row_ptr.to(dev), col.to(dev), fd[:, h, :], fd[:, (h + 1) % 4, :],
                        _stats=stats).cpu()
        eref = S.csr_sddmm_plain(row_ptr, col, featv[:, h, :], featv[:, (h + 1) % 4, :])
        assert (e - eref).abs().max().item() <= 64 * F32_EPS * max(1.0, eref.abs().max().item())
        staged, _, from_device, _ = stats.tolist()
        assert (from_device == 0 and staged > 0) if graph == "clustered" else staged == 0


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


@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("graph", ["clustered", "uniform"])
def test_csr_spmm_over_a_projection_view_is_its_copy(dev, reduce, graph):
    """G over ``y[:, :48]`` of a [N, 96] f32 projection (row stride 96: the
    self and neighbour halves of SAGE's last layer in one GEMM's output) is
    bit-equal to G over its contiguous copy, staged (clustered) or from
    device memory (uniform)."""
    if graph == "uniform":
        row_ptr, col, _ = _csr(n=2000, n_src=2000)
    else:
        row_ptr, col = _clustered_csr()
    n = row_ptr.shape[0] - 1
    y = torch.randn(n, 96, generator=_gen(40)).to(dev)
    view = y[:, :48]
    assert view.stride() == (96, 1)
    args = (row_ptr.to(dev), col.to(dev))
    out = S.csr_spmm(*args, view, reduce=reduce)
    assert torch.equal(_bits(out), _bits(S.csr_spmm(*args, view.contiguous(), reduce=reduce)))


def test_sage_last_layer_projects_first_on_card_as_the_concat_route(dev):
    """The benchmark's last SAGE layer (256 -> 47, mean) over a small
    clustered graph: the project-first route (one ``sage.project_first``
    span, G over 48 columns) against ``proj(cat[x, mean(x)])`` on the card
    at 2e-4, forward and the gradients of x and ``proj``."""
    row_ptr, col = _clustered_csr(n=3000)
    n = row_ptr.shape[0] - 1
    fg = GraphStructure(row_ptr.to(dev), col.to(dev), n).to_full_graph(windowed=True)
    conv = SAGEConv(256, 47, device=dev)
    with torch.no_grad():
        conv.proj.bias.copy_(torch.randn(47, generator=_gen(41)).to(dev))
    x = torch.relu(torch.randn(n, 256, generator=_gen(42))).to(dev).requires_grad_()
    ct = torch.randn(n, 47, generator=_gen(43)).to(dev)
    with perf.Timeline(device=dev) as tl:
        out = conv(x, fg)
    assert [s.name for s in tl.spans()].count("sage.project_first") == 1
    out.backward(ct)
    got = [t.grad.clone() for t in (x, conv.proj.weight, conv.proj.bias)]
    for t in (x, conv.proj.weight, conv.proj.bias):
        t.grad = None
    want = conv.proj(torch.cat([x, _fg_spmm(fg, x, "mean")], dim=-1))
    want.backward(ct)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
    for name, g, t in zip(("x", "proj.weight", "proj.bias"), got,
                          (x, conv.proj.weight, conv.proj.bias)):
        torch.testing.assert_close(g, t.grad, rtol=2e-4, atol=2e-4, msg=name)


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
    """A window above 48 KB of shared memory (the default limit) launches:
    tiles of 64 ids of 1 KB rows may take spans of up to 66 rows, so a
    window of 66 rows is kept whole, and tiles of 64 consecutive ids fill it."""
    table = _store_table(4000, 256, torch.float32, seed=2)
    slots = torch.arange(100, 2148, dtype=torch.int64)  # consecutive: every tile windowed
    slots[::97] = _store_slots("sorted", 4000, slots[::97].numel(), torch.int64)
    tile, window = G.sorted_plan(1024, tile=64, window=66)
    assert window * 1024 > 48 * 1024
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    out = G.gather_rows_sorted(table.to(dev), slots.to(dev), tile=tile, window=window,
                               _stats=stats)
    assert torch.equal(_bits(out.cpu()), _bits(G.gather_rows_plain(table, slots)))
    assert stats[0] > 0


def _tile_mix_slots(n, tile, window, g):
    """Tiles of consecutive ids and of duplicates (the window moves fewer
    bytes), tiles of ids further apart than the window (read directly), a
    shuffled dense tile, a tile with ids outside [0, n), a partial last tile."""
    span = window + 1
    dense = int(torch.randint(0, n - tile, (1,), generator=g)) + torch.arange(tile)
    sparse = (int(torch.randint(0, n - span * tile, (1,), generator=g))
              + span * torch.arange(tile)) % n
    dup = int(torch.randint(0, n - tile, (1,), generator=g)) + torch.arange(tile) // 8
    oob = dense.clone()
    oob[::4] = torch.tensor([-1, n, -(2**31), n + 3]).repeat(tile)[: oob[::4].numel()]
    parts = [dense, sparse, dup, dense[torch.randperm(tile, generator=g)], sparse.flip(0), oob,
             dense[: tile // 2 + 1]]
    return torch.cat(parts).to(torch.int32)


@pytest.mark.parametrize("D,dtype", [(3, torch.float32), (5, torch.float32),
                                     (6, torch.bfloat16), (10, torch.bfloat16),
                                     (16, torch.float32), (256, torch.float32),
                                     (256, torch.bfloat16)])
def test_sorted_gather_tile_mix(dev, D, dtype):
    """Windowed and direct tiles in one call, rows of 12 and 20 bytes among
    them (no 16-byte vectors), clip and zero; the kernel's
    own counts add up to the tiles, and both kinds occur."""
    tile, window = G.sorted_plan(D * dtype.itemsize, density=0.8)
    n = (window + 1) * tile + 1000
    table = _store_table(n, D, dtype, seed=D)
    slots = _tile_mix_slots(n, tile, window, _gen(D))
    tiles = -(-slots.numel() // tile)
    for zero_invalid, plain in ((False, G.gather_rows_plain), (True, G.gather_rows_masked_plain)):
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        out = G.gather_rows_sorted(table.to(dev), slots.to(dev), density=0.8,
                                   zero_invalid=zero_invalid, _stats=stats)
        assert torch.equal(_bits(out.cpu()), _bits(plain(table, slots)))
        windowed, direct, nbytes = stats.tolist()
        assert windowed + direct == tiles and windowed > 0 and direct > 0, stats
        assert 0 < nbytes <= slots.numel() * (window + 1) * D * dtype.itemsize


@pytest.mark.parametrize("D", [256, 4, 3])
def test_sorted_gather_counts_match_the_tiles(dev, D):
    """Tiles of consecutive ids all take the window and read their spans;
    tiles of ids a window apart all read their rows directly."""
    tile, window = G.sorted_plan(D * 4, density=1.0)
    n = (window + 1) * tile * 4 + 10
    table = _store_table(n, D, torch.float32, seed=3)
    for case in ("dense", "sparse"):
        step = 1 if case == "dense" else window + 1
        slots = (torch.arange(4 * tile) * step).to(torch.int32)
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        out = G.gather_rows_sorted(table.to(dev), slots.to(dev), _stats=stats)
        assert torch.equal(_bits(out.cpu()), _bits(G.gather_rows_plain(table, slots)))
        span_rows = int((slots.view(4, tile).max(1).values - slots.view(4, tile).min(1).values
                         + 1).sum())
        want = [4, 0, span_rows * D * 4] if case == "dense" else [0, 4, 4 * tile * D * 4]
        assert stats.tolist() == want, (case, stats)


def test_sorted_gather_of_a_view_at_an_offset(dev):
    """A table whose base is 4 bytes past an allocation: spans are never
    16-byte aligned, so windows arrive by 4-byte copies."""
    flat = torch.randn(8 * 5000 + 1, generator=_gen(4))
    table = flat[1:].view(5000, 8)
    slots = torch.sort(torch.randperm(3300, generator=_gen(5))[:3000]).values.to(torch.int32)
    on_card = flat.to(dev)[1:].view(5000, 8)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    out = G.gather_rows_sorted(on_card, slots.to(dev), _stats=stats)
    assert torch.equal(out.cpu(), G.gather_rows_plain(table, slots)) and stats[0] > 0


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


@pytest.mark.parametrize("dtype,D,vec", [(torch.uint8, 3, 1), (torch.uint8, 6, 2),
                                         (torch.bfloat16, 1, 2), (torch.float32, 1, 4),
                                         (torch.float32, 2, 8), (torch.float32, 16, 16),
                                         (torch.float32, 256, 16), (torch.bfloat16, 520, 16),
                                         (torch.float32, 20000, 16)])
@pytest.mark.parametrize("case", ["duplicates", "partial_tile"])
def test_masked_gather_any_width(dev, dtype, D, vec, case):
    """Kernel J at every vector width (16-, 8-, 4-, 2- and 1-byte loads),
    4 loads in flight a thread (tiles of fewer than 8 vectors a thread: 8 KB
    tiles) and 8 (one id a tile of an 80 KB row); duplicated slots, and a
    batch whose last tile ends partway through a batch of loads."""
    n = 300 if D >= 20000 else 3000
    g = _gen(D + n)
    if dtype == torch.uint8:
        table = torch.randint(0, 256, (n, D), generator=g, dtype=torch.uint8)
    else:
        table = _store_table(n, D, dtype, seed=D)
    rb = D * table.element_size()
    tile = G.masked_tile(rb)
    B = 5 * tile + tile // 2 + 1 if case == "partial_tile" else 4 * tile
    slots = torch.randint(-3, n + 3, (B,), generator=g, dtype=torch.int64)
    if case == "duplicates":
        slots = slots[torch.randint(0, max(B // 8, 1), (B,), generator=g)]
    on_card = table.to(dev)
    out_card = torch.empty(B, D, dtype=dtype, device=dev)
    assert G.vector_bytes(rb, on_card.data_ptr(), out_card.data_ptr()) == vec
    before = G.ROW_GATHER_MASKED.launches
    out = G.gather_rows_masked(on_card, slots.to(dev)).cpu()
    assert G.ROW_GATHER_MASKED.launches == before + 1
    ref = G.gather_rows_masked_plain(table, slots)
    if dtype == torch.uint8:
        assert torch.equal(out, ref)
    else:
        assert torch.equal(_bits(out), _bits(ref))
    assert not out[(slots < 0) | (slots >= n)].any()


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


def _weighted_graph(K, seed):
    """Rows of degree 0, 1, K, K + 1, 256 and 257 (the registers' edge and
    the list mode's, on either side), a hub of 2^17 edges, and 31, 32, 33,
    63, 64, 65, 127, 128 and 129 (the register tiers' edges: one value a
    lane, two, the tier of 8, and its sort widths), then random rows;
    weights positive with 0, negative, NaN and +inf mixed in; out-of-range
    centres."""
    rs = np.random.RandomState(seed)
    n = 3000
    degs = rs.randint(0, 2 * K + 40, n)
    degs[:16] = [0, 1, K, K + 1, 256, 257, 1 << 17, 31, 32, 33, 63, 64, 65, 127, 128, 129]
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32))
    E = int(row_ptr[-1])
    col = torch.from_numpy(rs.randint(0, n, E).astype(np.int32))
    w = (rs.rand(E) + 0.01).astype(np.float32)
    pick = rs.rand(E)
    w[pick < 0.05] = 0.0
    w[(pick >= 0.05) & (pick < 0.07)] = -1.0
    w[(pick >= 0.07) & (pick < 0.08)] = np.nan
    w[(pick >= 0.08) & (pick < 0.09)] = np.inf
    centers = torch.from_numpy(np.concatenate([
        np.arange(n), [6, 6, 4, 5], [-1, -7, n, n + 9, -(2**31), 2**31 - 1],
        rs.randint(0, n, 2000)]).astype(np.int32))
    return row_ptr, col, torch.from_numpy(w), centers


def _weighted_check(got, row_ptr, col, w, centers, K, seed, hop, pairs=None):
    """K's sample against its plain version on the card by the equality
    rule (``ops.sampling.weighted_near_ties``); the counts printed."""
    ref = SM.csr_sample_neighbors_weighted_plain(row_ptr, col, w, centers, K, seed, hop,
                                                 pairs=pairs)
    near, inside = SM.weighted_near_ties(row_ptr, col, w, centers, K, seed, hop, pairs=pairs)
    fields = {f: getattr(got, f) for f in SAMPLE_FIELDS}
    n_near, n_differ, n_bad = SM.weighted_rule(fields, {f: getattr(ref, f) for f in SAMPLE_FIELDS},
                                               near, inside)
    print(f"K={K}: near-tie centres {n_near}, of them differing {n_differ}")
    assert n_bad == 0
    return n_near, n_differ


@pytest.mark.parametrize("K", [0, 1, 15, 40, 200])
@pytest.mark.parametrize("route", ["pairs", "separate"])
def test_sample_hop_weighted_matches_plain(dev, K, route):
    """Kernel K, all five fields, against its plain version on the card by
    the equality rule: its three selection modes (registers, 2 a lane to 64
    edges and 8 a lane to 256, the running list above), degrees 0, 1, K, K +
    1, either side of 32, 64, 128 and 256, and a hub, -inf keys inside
    rows, out-of-range centres; one launch a call, deterministic, and the
    two routes bit-equal."""
    row_ptr, col, w, centers = (t.to(dev) for t in _weighted_graph(K, K + 3))
    pairs = SM.interleave_col_weights(col, w)
    kw = dict(cw_blocks=pairs) if route == "pairs" else {}
    before = (SM.SAMPLE_HOP_WEIGHTED.launches, SM.SAMPLE_HOP.launches)
    got = SM.csr_sample_neighbors(row_ptr, col, centers, K, seed=7, hop=2, weights=w,
                                  max_degree=1 << 17, **kw)
    assert (SM.SAMPLE_HOP_WEIGHTED.launches, SM.SAMPLE_HOP.launches) == (before[0] + 1, before[1])
    _weighted_check(got, row_ptr, col, w, centers, K, 7, 2)
    other = SM.sample_hop_weighted(row_ptr, col, w, centers, K, 7, 2,
                                   pairs=None if route == "pairs" else pairs)
    _assert_same_sample(got, other, f"K={K}, the other route")
    _assert_same_sample(got, SM.csr_sample_neighbors(row_ptr, col, centers, K, seed=7, hop=2,
                                                     weights=w, max_degree=1 << 17, **kw),
                        f"K={K}, a second run")
    if K:
        m = got.mask.cpu()
        assert (m[:, 1:] <= m[:, :-1]).all()  # holes only at a row's end
        assert got.degree[6] == 1 << 17 and m[6].sum() == K


def test_sample_hop_weighted_list_in_device_memory(dev):
    """K = 800: eight warps' lists exceed the block's 48 KB of shared
    memory, so each hub's list lives in its own rows of pos and edge_ids
    until the last pass rewrites them."""
    K = 800
    row_ptr = torch.tensor([0, 40_000, 40_300, 41_200, 43_200], dtype=torch.int32)
    rs = np.random.RandomState(2)
    w = torch.from_numpy((rs.rand(43_200) + 0.1).astype(np.float32))
    col = torch.arange(43_200, dtype=torch.int32).flip(0).contiguous()
    centers = torch.tensor([0, 1, 2, 3, 0, 9], dtype=torch.int32)
    args = (t.to(dev) for t in (row_ptr, col, w, centers))
    row_ptr_d, col_d, w_d, centers_d = args
    got = SM.csr_sample_neighbors(row_ptr_d, col_d, centers_d, K, seed=3, hop=1, weights=w_d,
                                  max_degree=40_000)
    _weighted_check(got, row_ptr_d, col_d, w_d, centers_d, K, 3, 1)
    assert got.mask.cpu()[[0, 2, 3, 4]].all() and got.mask.cpu()[1].sum() == 300


def test_weighted_multilayer_and_step_on_card_match_cpu(dev):
    """A weighted multilayer sample through the pair table, and three
    weighted training steps, on the card against the CPU from the same
    numpy data (no near tie on these seeds, so the samples are bit-equal)."""
    rs = np.random.RandomState(11)
    n = 2000
    src, dst = rs.randint(0, n, n * 12), rs.randint(0, n, n * 12)
    w = (rs.rand(n * 12) + 0.1).astype(np.float32)
    centers = torch.from_numpy(rs.choice(n, 256, replace=False).astype(np.int32))
    a = GraphStructure.from_coo(src, dst, n, edge_weight=w, device=dev).with_weighted_fastpath()
    b = GraphStructure.from_coo(src, dst, n, edge_weight=w, device="cpu")
    before = SM.SAMPLE_HOP_WEIGHTED.launches
    ma = a.multilayer_sample(centers.to(dev), (10, 15), seed=3, weighted=True)
    mb = b.multilayer_sample(centers, (10, 15), seed=3, weighted=True)
    assert SM.SAMPLE_HOP_WEIGHTED.launches == before + 2
    for l, K in enumerate((10, 15)):  # the premise of bit-equality: no near tie
        hop_centres = torch.where(mb.level_masks[l], mb.level_gids[l], 0)
        assert not SM.weighted_near_ties(b.row_ptr, b.col, b.edge_weight, hop_centres, K, 3,
                                         l)[0].any()
    assert torch.equal(ma.unique_gids.cpu(), mb.unique_gids)
    for x, y in zip(ma.hops, mb.hops):
        assert torch.equal(x.nbr_idx.cpu(), y.nbr_idx) and torch.equal(x.mask.cpu(), y.mask)
    cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=64, hidden=64, num_classes=8, batch=32,
                             sample_method="weighted")
    states = [wt.build_synthetic(cfg, device=d, seed=1) for d in ("cpu", dev)]
    states[1].embedding.from_array(states[0].embedding.to_array())
    states[1].model.load_state_dict(states[0].model.state_dict())
    for s in states[1:]:
        s.graph = GraphStructure(*(t.to(dev) for t in (states[0].graph.row_ptr,
                                                        states[0].graph.col)), 400,
                                 max_degree=states[0].graph.max_degree,
                                 edge_weight=states[0].graph.edge_weight.to(dev)
                                 ).with_weighted_fastpath()
        s.labels = states[0].labels.to(dev)
    for i in range(3):
        c = torch.from_numpy(rs.randint(0, 400, 32).astype(np.int32))
        la, lb = (float(wt.train_step(s, c.to(s.labels.device), s.labels[c.long().to(
            s.labels.device)], seed=i)) for s in states)
        assert abs(la - lb) <= 1e-5 * max(1.0, abs(la)), (la, lb)


# ---------------------------------------------------------------------------
# the sampled GCN, GAT and RGCN, and the hetero step (kernels A-D)
# ---------------------------------------------------------------------------


def _on_card(cpu, dev):
    """A card copy of a CPU ``SageTrainState``: its graph (edge types
    included), table and sparse optimizer, labels and weights, a fresh
    Adam."""
    import dataclasses

    g = cpu.graph
    model = HomoGNN(cpu.config.dim, cpu.config.hidden, cpu.config.num_classes,
                    model_type=cpu.config.model_type, num_heads=cpu.config.num_heads,
                    num_relations=cpu.config.num_relations, degree_mode=cpu.config.degree_mode,
                    device=dev)
    model.load_state_dict(cpu.model.state_dict())
    graph = GraphStructure(g.row_ptr.to(dev), g.col.to(dev), g.node_count,
                           max_degree=g.max_degree,
                           edge_type=None if g.edge_type is None else g.edge_type.to(dev),
                           num_relations=g.num_relations)
    emb = Embedding.create(g.node_count, cpu.config.dim, optimizer=cpu.embedding.optimizer,
                           device=dev)
    emb.from_array(cpu.embedding.to_array())
    return dataclasses.replace(cpu, graph=graph, embedding=emb, model=model,
                               dense_opt=torch.optim.Adam(model.parameters(), lr=cpu.config.lr),
                               labels=cpu.labels.to(dev))


@pytest.mark.parametrize("model_type,degree_mode", [("gcn", "block"), ("gcn", "true"),
                                                    ("gat", "auto"), ("rgcn", "auto")])
def test_sampled_model_steps_on_card_match_cpu(dev, model_type, degree_mode):
    """Three steps of each new model on the card against the CPU from the
    same graph, table and weights: losses within 1e-5, and the table's
    change over the steps over the rate (the summed row gradients) within
    1e-4 of the largest. The table trains under SGD: LazyAdam's step
    g / (|g| + 1e-8) turns f32 noise of 1e-9 on an element whose gradient
    is near 0 into a difference of up to the rate. The card ran A, C, L
    and (GCN) D, and no B."""
    cfg = wt.SageTrainConfig(n_nodes=400, deg=12, dim=64, hidden=64, num_classes=8, batch=32,
                             fanouts=(5, 6), model_type=model_type, degree_mode=degree_mode)
    cpu = wt.build_synthetic(cfg, device="cpu", seed=2)
    table0 = cpu.embedding.table.clone()
    cpu.embedding = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=SGD(), device="cpu"
                                     ).from_array(table0.numpy())
    card = _on_card(cpu, dev)
    for k in (G.ROW_GATHER, G.ROW_SCATTER, SM.SAMPLE_HOP, S.NEIGHBOR_AGG, L.SPARSE_APPLY):
        k.launches = 0
    rs = np.random.RandomState(3)
    for i in range(3):
        c = torch.from_numpy(rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32))
        a = wt.train_step(card, c.to(dev), card.labels[c.long().to(dev)], seed=i)
        b = wt.train_step(cpu, c, cpu.labels[c.long()], seed=i)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    ga = (card.embedding.table.cpu() - table0) / cfg.lr
    gb = (cpu.embedding.table - table0) / cfg.lr
    assert (ga - gb).abs().max() <= 1e-4 * max(1.0, float(gb.abs().max()))
    # A: the gather a step, and GAT's and RGCN's neighbour rows; the apply is L, once a step
    a_per_step = 1 + (2 if model_type in ("gat", "rgcn") else 0)
    assert G.ROW_GATHER.launches == 3 * a_per_step and G.ROW_SCATTER.launches == 0
    assert L.SPARSE_APPLY.launches == 3
    assert SM.SAMPLE_HOP.launches == 6
    assert S.NEIGHBOR_AGG.launches == (6 if model_type == "gcn" else 0)


def test_rgcn_full_graph_on_card_matches_cpu(dev):
    rs = np.random.RandomState(4)
    n = 300
    g = GraphStructure.from_coo(rs.randint(0, n, 2000), rs.randint(0, n, 2000), n,
                                edge_type=rs.randint(0, 3, 2000), device="cpu")
    model = HomoGNN(32, 32, 4, model_type="rgcn", num_relations=3, device="cpu")
    model.reset_parameters(_gen(5))
    card = HomoGNN(32, 32, 4, model_type="rgcn", num_relations=3, device=dev)
    card.load_state_dict(model.state_dict())
    x = torch.randn(n, 32, generator=_gen(6))
    outs = []
    for m, d in ((card, dev), (model, torch.device("cpu"))):
        gd = GraphStructure(g.row_ptr.to(d), g.col.to(d), n, edge_type=g.edge_type.to(d),
                            num_relations=3).to_full_graph()
        xd = x.to(d).requires_grad_()
        out = m(xd, graph=gd)
        out.square().sum().backward()
        outs.append((out.detach().cpu(), xd.grad.cpu(), m.convs[0].w_rel.grad.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_hetero_steps_on_card_match_cpu(dev):
    """Three hetero steps (typed gather, HeteroGNN, typed apply) on the card
    against the CPU from the same dataset and weights: losses within 1e-5,
    and each type's summed row gradients (its change under SGD over the
    rate, as in the test above) within 1e-4 of the largest; A and L ran, B
    and D did not."""
    from wholegraph_tpu_torch.graph import HeteroFeatureStore

    cfg = wt.HeteroTrainConfig(n_paper=600, n_author=200, n_inst=30, num_classes=8, hidden=64,
                               batch=64, fanouts=(6, 5))
    cpu = wt.build_hetero(cfg, device="cpu", seed=1)
    card = wt.build_hetero(cfg, device=dev, seed=1)
    card.model.load_state_dict(cpu.model.state_dict())
    tables0 = {n: e.to_array() for n, e in cpu.store.embeddings.items()}
    for st in (cpu, card):
        st.store = HeteroFeatureStore.create(cpu.store.space, optimizer=SGD(),
                                             device=st.labels.device).from_arrays(tables0)
    for k in (G.ROW_GATHER, G.ROW_SCATTER, S.NEIGHBOR_AGG, L.SPARSE_APPLY):
        k.launches = 0
    rs = np.random.RandomState(2)
    for i in range(3):
        c = torch.from_numpy(rs.choice(cpu.train_ids.numpy(), cfg.batch, replace=False))
        a = wt.hetero_train_step(card, c.to(dev), card.labels[c.long().to(dev)], seed=i)
        b = wt.hetero_train_step(cpu, c, cpu.labels[c.long()], seed=i)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    lr = cfg.lr * 0.1
    for n in cpu.store.space.names:
        t0 = torch.from_numpy(tables0[n])
        ga = (card.store.embeddings[n].table.cpu() - t0) / lr
        gb = (cpu.store.embeddings[n].table - t0) / lr
        assert (ga - gb).abs().max() <= 1e-4 * max(1.0, float(gb.abs().max())), n
    # A: 3 typed gathers, 2 RGCN neighbour gathers; the apply: L once a type, no B
    assert G.ROW_GATHER.launches == 3 * 5 and G.ROW_SCATTER.launches == 0
    assert L.SPARSE_APPLY.launches == 3 * 3
    assert S.NEIGHBOR_AGG.launches == 0


# -- the eleventh slice: hot cache, file IO, checkpoints, sorted helpers ------


def test_hot_cache_on_card_matches_cpu(dev):
    """build, gather (kernel A: hits and misses), invalidate, refresh and the
    adaptive refresh on the card, bit-equal to the CPU."""
    from wholegraph_tpu_torch.embedding import cache as C

    rs = np.random.RandomState(0)
    arr = rs.randn(5000, 64).astype(np.float32)
    hot = rs.choice(5000, 800, replace=False)
    tabs = {d: wt.ShardedTable.from_array(arr, device=d) for d in ("cpu", dev)}
    caches = {d: C.build_hot_cache(t, hot) for d, t in tabs.items()}
    ids = rs.randint(0, 5000, 4096).astype(np.int32)
    touched = np.concatenate([hot[:300], [-1, 5000]]).astype(np.int32)
    rows = rs.randn(300, 64).astype(np.float32)
    for d in tabs:
        tabs[d] = tabs[d].scatter(torch.from_numpy(hot[:300].astype(np.int32)).to(d),
                                  torch.from_numpy(rows).to(d), donate=True)
        caches[d] = C.invalidate_touched(caches[d], torch.from_numpy(touched).to(d))
    before = G.ROW_GATHER.launches
    out = C.gather_with_cache(tabs[dev], caches[dev], torch.from_numpy(ids).to(dev))
    assert G.ROW_GATHER.launches == before + 2  # hits from the cache, misses from the table
    want = C.gather_with_cache(tabs["cpu"], caches["cpu"], torch.from_numpy(ids))
    assert torch.equal(out.cpu(), want)
    assert torch.equal(caches[dev].valid.cpu(), caches["cpu"].valid)
    assert C.cache_hit_fraction(caches[dev], ids) == C.cache_hit_fraction(caches["cpu"], ids)
    fresh = {d: C.refresh_hot_cache(tabs[d], caches[d]) for d in tabs}
    assert torch.equal(fresh[dev].values.cpu(), fresh["cpu"].values) and fresh[dev].valid.all()
    counters = {d: C.make_touch_counter(5000, device=d) for d in tabs}
    for d in tabs:
        C.touch(counters[d], torch.from_numpy(ids).to(d))
    adapt = {d: C.refresh_hot_cache_adaptive(tabs[d], fresh[d], counters[d])[0] for d in tabs}
    assert torch.equal(adapt[dev].hot_ids.cpu(), adapt["cpu"].hot_ids)
    assert torch.equal(adapt[dev].values.cpu(), adapt["cpu"].values)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_filelist_through_the_staging_ring(dev, tmp_path, monkeypatch, dtype):
    """Rows through the two pinned staging buffers onto the card, in chunks
    smaller than a file (STAGING_BYTES cut to 3 rows and a part), bit-equal
    to the CPU read; the host location stays in pinned memory."""
    from wholegraph_tpu_torch.io import file_io

    rs = np.random.RandomState(1)
    arrs = [rs.randn(37 + 5 * i, 24).astype(np.float32) for i in range(3)]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).bfloat16() for a in arrs]
    paths = []
    for i, a in enumerate(arrs):
        p = str(tmp_path / f"p{i}.bin")
        (a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) else a).tofile(p)
        paths.append(p)
    monkeypatch.setattr(file_io, "STAGING_BYTES", 3 * 24 * 4 + 10)
    cpu = wt.io.load_filelist(paths, 24, dtype, device="cpu")
    card = wt.io.load_filelist(paths, 24, dtype, device=dev, direct=True)
    assert card.data.device.type == "cuda" and torch.equal(card.data.cpu(), cpu.data)
    host = wt.ShardedTable.from_filelist(paths, 24, dtype, location="host", device=dev)
    assert host.data.is_pinned() and torch.equal(host.data, cpu.data)
    emb = Embedding.from_filelist(paths, 24, dtype=dtype, optimizer=LazyAdam(), device=dev)
    assert torch.equal(emb.table.cpu(), cpu.data) and emb.slots["m"].device.type == "cuda"


def test_checkpoints_on_card_round_trip(dev, tmp_path):
    """A LazyAdam embedding and a host-tier one trained on the card, saved
    through AsyncCheckpointer (snapshot before the next in-place apply),
    reloaded on the card and on the CPU: bit-equal, and the next step of
    the reloaded state equals the next step of the live one."""
    rs = np.random.RandomState(2)
    init = rs.randn(3000, 32).astype(np.float32)
    # unique ids, as a sampler's: the apply's sums are then exact in any order
    batches = [(torch.from_numpy(rs.choice(3000, 512, replace=False).astype(np.int32)).to(dev),
                torch.from_numpy(rs.randn(512, 32).astype(np.float32)).to(dev))
               for _ in range(4)]
    emb = Embedding.create(3000, 32, optimizer=LazyAdam(), device=dev).from_array(init)
    host = HostEmbedding.create(3000, 32, optimizer=LazyAdam(), cache_ratio=0.2,
                                device=dev).from_array(init, hot_ids=np.arange(0, 3000, 5))
    for ids, g in batches[:3]:
        emb.apply_gradients(ids, g, 0.01)
        host.apply_gradients(ids, g, 0.01)
    saved = (emb.table.clone(), emb.slots["v"].clone())
    with wt.io.AsyncCheckpointer() as ckpt:
        ckpt.save_embedding(emb, str(tmp_path), "e")
        ckpt.save_host_embedding(host, str(tmp_path), "h")
        ids, g = batches[3]
        emb.apply_gradients(ids, g, 0.01)  # in place, right after the snapshot
        host.apply_gradients(ids, g, 0.01)
    for d in (dev, "cpu"):
        back = wt.io.load_embedding(str(tmp_path), "e", device=d)
        assert back.step == 3 and torch.equal(back.table.cpu(), saved[0].cpu())
        assert torch.equal(back.slots["v"].cpu(), saved[1].cpu())
    back = wt.io.load_embedding(str(tmp_path), "e", device=dev)
    back.apply_gradients(ids, g, 0.01)
    assert torch.equal(back.table, emb.table) and torch.equal(back.slots["m"], emb.slots["m"])
    hback = wt.io.load_host_embedding(str(tmp_path), "h", device=dev)
    assert hback.step == 3 and hback.host_table.is_pinned()
    assert torch.equal(hback.cache_map >= 0, host.cache_map >= 0)
    hback.apply_gradients(ids, g, 0.01)
    assert np.array_equal(hback.to_array(), host.to_array())
    assert np.array_equal(hback.slot_to_array("v"), host.slot_to_array("v"))


@pytest.mark.parametrize("dtype,dim", [(torch.float32, 256), (torch.float32, 100),
                                       (torch.float32, 16), (torch.float32, 4),
                                       (torch.bfloat16, 2)])
def test_choose_gather_kernel_agrees_with_kernel_i(dev, dtype, dim):
    """choose_gather_kernel's answer is the route kernel I's own counts show
    on every tile of evenly spaced sorted ids at exactly that density."""
    for d in (1.0, 0.9, 0.6, 0.4, 0.2, 0.1):
        answer = G.choose_gather_kernel(d, dtype, dim)
        ids = (torch.arange(8192, dtype=torch.float64, device=dev) / d).floor()
        data = torch.zeros(int(ids[-1]) + 1, dim, dtype=dtype, device=dev)
        st = torch.zeros(3, dtype=torch.int64, device=dev)
        G.gather_rows_sorted(data, ids.to(torch.int32), density=d, _stats=st)
        windowed, direct, _ = st.tolist()
        assert (direct if answer == "window" else windowed) == 0, (d, answer, windowed, direct)


def test_gather_rows_window_and_make_train_step_on_card(dev):
    rs = np.random.RandomState(3)
    table = torch.from_numpy(rs.randn(50_000, 256).astype(np.float32))
    ids = torch.from_numpy(np.sort(rs.choice(20_000, 8192, replace=False)).astype(np.int32))
    before = G.SORTED_GATHER.launches
    out = G.gather_rows_window(table.to(dev), ids.to(dev))
    assert G.SORTED_GATHER.launches == before + 1 and torch.equal(out.cpu(), table[ids.long()])
    init = rs.randn(400, 16).astype(np.float32)
    tgt = torch.from_numpy(rs.randn(128, 16).astype(np.float32))
    embs = {d: Embedding.create(400, 16, optimizer=SGD(), device=d).from_array(init)
            for d in ("cpu", dev)}
    steps = {d: e.make_train_step(lambda r, t: torch.mean((r - t) ** 2), 0.1)
             for d, e in embs.items()}
    for _ in range(3):
        i = torch.from_numpy(rs.randint(0, 400, 128).astype(np.int32))
        m = torch.from_numpy(rs.rand(128) < 0.8)
        a = steps[dev](i.to(dev), tgt.to(dev), mask=m.to(dev))
        b = steps["cpu"](i, tgt, mask=m)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(embs[dev].table.cpu(), embs["cpu"].table, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# World 4 on one card: four ranks over gloo (NCCL refuses two ranks on one card)
# ---------------------------------------------------------------------------

WN, WD, WB = 5000, 64, 512


def _world_store_rank(rank, world):
    from wholegraph_tpu_torch.memory import PartitionPlan
    from wholegraph_tpu_torch.ops import KERNELS
    from wholegraph_tpu_torch.parallel import create_hierarchy_mesh, get_global_mesh

    mesh = get_global_mesh()
    dev = mesh.device
    arr = torch.randn(WN, WD, generator=_gen(0))
    ids = torch.randint(-3, WN + 3, (world, WB), generator=_gen(1))[rank].to(dev)
    skew = torch.randint(0, 50, (world, WB), generator=_gen(2))[rank].to(dev)
    for k in KERNELS:
        k.launches = 0
    out = {}
    for pname, plan in (("equal", PartitionPlan.equal(WN, world)),
                        ("round_robin", PartitionPlan.round_robin(WN, world, 64))):
        t = wt.ShardedTable.from_array(arr, plan=plan, device=dev, mesh=mesh)
        for m in ("a2a", "a2a_capped", "allgather", "ragged"):
            out[pname, m] = t.gather(ids, method=m).cpu()
        out[pname, "sorted"] = t.gather(ids, dedup=True, local_kernel="sorted").cpu()
        out[pname, "skew"] = t.gather(skew, capacity_factor=0.5).cpu()
        z = wt.ShardedTable.create(WN, WD, plan=plan, device=dev, mesh=mesh)
        out[pname, "add"] = torch.from_numpy(
            z.scatter(skew, torch.ones(WB, WD, device=dev), accumulate=True).to_array())
    h = wt.ShardedTable.from_array(arr, device=dev, mesh=create_hierarchy_mesh(2, 2),
                                   axis=("node", "device"))
    out["hierarchy"] = h.gather(ids, method="hierarchy").cpu()
    out["launches"] = {k.name: k.launches for k in KERNELS}
    return out


def test_world4_store_on_one_card(dev):
    """Every method of the exchange on four ranks sharing card 0 (gloo over
    CUDA tensors) gives the numpy rows, bit for bit; the serve ran kernels
    J and I and the un-permute B on every rank."""
    res = wt.parallel.multiprocess_run(4, _world_store_rank, backend="gloo", device="cuda:0",
                                       timeout=300)
    arr = torch.randn(WN, WD, generator=_gen(0))
    ids = torch.randint(-3, WN + 3, (4, WB), generator=_gen(1))
    skew = torch.randint(0, 50, (4, WB), generator=_gen(2))
    ok = (ids >= 0) & (ids < WN)
    want = torch.where(ok[..., None], arr[ids.clamp(0, WN - 1)], 0.0)
    counts = torch.bincount(skew.reshape(-1), minlength=WN).float()
    for r, out in enumerate(res):
        for key, got in out.items():
            if key == "launches":
                assert got["row_gather_masked"] > 0 and got["sorted_gather"] > 0, got
                assert got["row_scatter"] > 0, got
            elif key[-1] == "skew":
                assert torch.equal(got, arr[skew[r]])
            elif key[-1] == "add":
                assert torch.equal(got, counts[:, None].expand(WN, WD))
            elif key[-1] != "a2a_capped":
                assert torch.equal(got, want[r]), key


def _world_step_rank(rank, world, cfg, centers):
    from wholegraph_tpu_torch.parallel import get_global_mesh

    st = wt.build_synthetic(cfg, device=get_global_mesh().device, seed=0, mesh=get_global_mesh())
    losses = []
    for i, c in enumerate(centers):
        c = c[rank].to(st.labels.device)
        losses.append(float(wt.train_step(st, c, st.labels[c.long()], seed=i)))
    return losses, st.embedding.to_array(), {k: v.cpu() for k, v in st.model.state_dict().items()}


def test_world4_sampled_step_on_one_card_matches_world1(dev):
    """Three SAGE steps at world 4 (four ranks on card 0, table under SGD)
    against the world-1 step on the card on the concatenated batch: losses,
    dense parameters (Adam at lr 1e-3), and the table's change over its lr (the summed row
    gradients) within 1e-4 of their largest plus the f32 rounding of the
    table itself (4 ulps of its largest value, over lr)."""
    cfg = wt.SageTrainConfig(n_nodes=3000, dim=32, hidden=32, num_classes=5, batch=32,
                             fanouts=(4, 5), embedding_lr=0.05, embedding_optimizer="sgd")
    g = _gen(9)
    centers = [torch.randperm(cfg.n_nodes, generator=g)[:4 * cfg.batch].reshape(4, -1).int()
               for _ in range(3)]
    res = wt.parallel.multiprocess_run(4, _world_step_rank, (cfg, centers), backend="gloo",
                                       device="cuda:0", timeout=300)
    st = wt.build_synthetic(cfg, device=dev, seed=0)
    base = st.embedding.to_array().copy()
    losses = []
    for i, c in enumerate(centers):
        c = c.reshape(-1).to(dev)
        losses.append(float(wt.train_step(st, c, st.labels[c.long()], seed=i)))
    want = (st.embedding.to_array() - base) / cfg.embedding_lr
    for wl, table, sd in res:
        np.testing.assert_allclose(wl, losses, rtol=1e-5, atol=1e-5)
        got = (table - base) / cfg.embedding_lr
        tol = 1e-4 * np.abs(want).max() + 4 * F32_EPS * np.abs(base).max() / cfg.embedding_lr
        assert np.abs(got - want).max() <= tol and np.abs(want).max() > 0
        for k, v in st.model.state_dict().items():
            np.testing.assert_allclose(sd[k].numpy(), v.cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_dryrun_multichip_on_one_card(dev):
    loss = wt.entry.dryrun_multichip(4, backend="gloo", device="cuda:0", timeout=300)
    assert np.isfinite(loss)


# ---------------------------------------------------------------------------
# the halo-partitioned full graph: spmm_halo (kernel G over each rank's
# local CSR, the halo gather by J and B) and the halo evaluation
# ---------------------------------------------------------------------------

HN, HD, HC, HR = 1500, 32, 4, 3
HALO_REDUCES = (("sum", False), ("mean", False), ("max", False), ("sum", True))


def _halo_graph(device):
    """A clustered CSR with edge weights and types, built on the CPU and moved."""
    g = wt.clustered_csr(HN, 6, 48, seed=5, device="cpu")
    gen = _gen(6)
    w = torch.rand(g.edge_count, generator=gen) + 0.1
    et = torch.randint(0, HR, (g.edge_count,), generator=gen, dtype=torch.int32)
    return GraphStructure(g.row_ptr.to(device), g.col.to(device), HN, edge_weight=w.to(device),
                          edge_type=et.to(device), num_relations=HR)


def _halo_models(device):
    models = {}
    for mt in ("sage", "gcn", "gat", "rgcn"):
        m = HomoGNN(HD, 32, HC, model_type=mt, num_heads=4,
                    num_relations=HR if mt == "rgcn" else 0, device=device)
        m.reset_parameters(_gen(7))
        models[mt] = m
    return models


def _halo_cases(mesh, device):
    from wholegraph_tpu_torch.graph import eval_full_graph_partitioned, partition_graph, spmm_halo
    from wholegraph_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0
    g = _halo_graph(device)
    x = torch.randn(HN, HD, generator=_gen(8))
    pg = partition_graph(g, mesh, device=device)
    x_tab = wt.ShardedTable.from_array(x, device=device, mesh=mesh)
    out = {(r, w): spmm_halo(pg, x_tab, r, use_weights=w).to_array() for r, w in HALO_REDUCES}
    g_spmm = S.CSR_SPMM.launches
    for mt, m in _halo_models(device).items():
        out[mt] = eval_full_graph_partitioned(m, pg, x_tab).to_array()
    out["launches"] = {k.name: k.launches for k in KERNELS}
    out["launches_spmm_halo"] = g_spmm
    return out


def _halo_rank(rank, world):
    from wholegraph_tpu_torch.parallel import get_global_mesh

    mesh = get_global_mesh()
    return _halo_cases(mesh, mesh.device)


def test_halo_full_graph_on_card_matches_cpu(dev):
    """spmm_halo's sum, mean and weighted sum (kernel G on the local CSR),
    its max, and the SAGE, GCN, GAT and RGCN halo evaluations, at world 1
    on the card and at world 4 (four ranks on card 0 over gloo), against
    the CPU at world 1. G sums each destination's edges in CSR order over
    copies of the same rows, so world 4 equals world 1 on the card bit for
    bit; the card against the CPU is within G's K f32 ulps of the largest
    output (K the longest row), max exactly; the logits within 1e-4. G ran
    on every rank."""
    cpu = _halo_cases(None, torch.device("cpu"))
    card = _halo_cases(None, dev)
    ranks = wt.parallel.multiprocess_run(4, _halo_rank, backend="gloo", device="cuda:0",
                                         timeout=300)
    g = _halo_graph("cpu")
    K = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
    for key in HALO_REDUCES:
        want = cpu[key]
        if key[0] == "max":
            np.testing.assert_array_equal(card[key], want)
        else:
            tol = K * F32_EPS * np.abs(want).max()
            assert np.abs(card[key] - want).max() <= tol, key
        for out in ranks:
            np.testing.assert_array_equal(out[key], card[key], err_msg=str(key))
    for mt in ("sage", "gcn", "gat", "rgcn"):
        np.testing.assert_allclose(card[mt], cpu[mt], rtol=1e-4, atol=1e-4, err_msg=mt)
        for out in ranks:
            np.testing.assert_allclose(out[mt], card[mt], rtol=1e-4, atol=1e-4, err_msg=mt)
    for out in [card] + ranks:
        assert out["launches_spmm_halo"] == 3, out["launches"]  # sum, mean, weighted sum
        assert out["launches"]["csr_spmm"] > 3, out["launches"]
    for out in ranks:
        assert out["launches"]["row_gather_masked"] > 0 and out["launches"]["row_scatter"] > 0


# ---------------------------------------------------------------------------
# world 4 on card 0 (gloo): the sampler over a sharded CSR (kernel J on
# 4-byte rows), the host tier over ranks (E, F, A, B), the hot cache's waves
# and the typed store and link prediction over ranks
# ---------------------------------------------------------------------------

WT_CFG = wt.SageTrainConfig(n_nodes=3000, dim=32, hidden=32, num_classes=5, batch=32,
                            fanouts=(4, 5), embedding_lr=0.05, embedding_optimizer="sgd")
WT_HCFG = wt.HeteroTrainConfig(n_paper=600, n_author=240, n_inst=40, num_classes=5, hidden=16,
                               batch=16, fanouts=(4, 3))


def _wt_centers(cfg, steps=3, seed=9):
    g = _gen(seed)
    return [torch.randperm(cfg.n_nodes, generator=g)[:4 * cfg.batch].reshape(4, -1).int()
            for _ in range(steps)]


def _wt_sharded_graph(st, mesh):
    """``st.graph`` with its row_ptr, col and edge weights as ShardedTables."""
    g = st.graph
    sh = lambda t: wt.ShardedTable.from_array(t.cpu(), device=t.device, mesh=mesh)
    w = torch.rand(g.edge_count, generator=_gen(3)).to(g.device) + 0.1
    return (GraphStructure(g.row_ptr, g.col, g.node_count, edge_weight=w),
            GraphStructure(sh(g.row_ptr), sh(g.col), g.node_count, edge_weight=sh(w)))


def _wt_steps(st, centers, rank, step=None):
    losses = []
    for i, c in enumerate(centers):
        c = (c if rank is None else c[rank]).reshape(-1).to(st.labels.device)
        losses.append(float((step or wt.train_step)(st, c, st.labels[c.long()], seed=i)))
    return losses


def _world_tier_rank(rank, world):
    from wholegraph_tpu_torch.embedding import build_hot_cache, gather_with_cache
    from wholegraph_tpu_torch.embedding.cache import CACHE_STATS
    from wholegraph_tpu_torch.examples import link_prediction as lp
    from wholegraph_tpu_torch.ops import KERNELS
    from wholegraph_tpu_torch.parallel import get_global_mesh

    mesh = get_global_mesh()
    dev = mesh.device
    out = {}
    centers = _wt_centers(WT_CFG)
    st = wt.build_synthetic(WT_CFG, device=dev, seed=0, mesh=mesh)
    rep, sh = _wt_sharded_graph(st, mesh)
    for k in KERNELS:
        k.launches = 0
    c = centers[0][rank].to(dev)
    for weighted in (False, True):
        a = rep.multilayer_sample(c, WT_CFG.fanouts, seed=1, weighted=weighted)
        b = sh.multilayer_sample(c, WT_CFG.fanouts, seed=1, weighted=weighted)
        out["sample", weighted] = (
            torch.equal(a.unique_gids, b.unique_gids) and all(
                torch.equal(x.nbr_idx, y.nbr_idx) and torch.equal(x.mask, y.mask)
                for x, y in zip(a.hops, b.hops)),
            {f: getattr(sh.sample_one_hop(c, 5, seed=2, weighted=weighted), f).cpu()
             for f in ("neighbors", "mask", "positions", "edge_ids", "degree")})
    out["sample_launches"] = {k.name: k.launches for k in KERNELS}
    # a sharded row_ptr beside a whole col on the card: C's fetch reads the columns
    mixed = GraphStructure(sh.row_ptr, rep.col, rep.node_count)
    for k in KERNELS:
        k.launches = 0
    b = mixed.multilayer_sample(c, WT_CFG.fanouts, seed=1)
    a = rep.multilayer_sample(c, WT_CFG.fanouts, seed=1)
    out["mixed"] = (torch.equal(a.unique_gids, b.unique_gids) and all(
        torch.equal(x.nbr_idx, y.nbr_idx) and torch.equal(x.mask, y.mask)
        for x, y in zip(a.hops, b.hops)), {k.name: k.launches for k in KERNELS})
    # the host tier over the ranks against the device embedding over them
    n, dim = 4000, 32
    init = torch.randn(n, dim, generator=_gen(4)).numpy()
    hot = np.arange(0, n, 3)
    host = HostEmbedding.create(n, dim, optimizer=LazyAdam(), cache_ratio=0.2, device=dev,
                                mesh=mesh).from_array(init, hot_ids=hot)
    emb = Embedding.create(n, dim, optimizer=LazyAdam(), device=dev, mesh=mesh).from_array(init)
    for k in KERNELS:
        k.launches = 0
    g = _gen(5 + rank)
    for _ in range(3):
        ids = torch.randint(0, n, (512,), generator=g).to(dev)
        grads = torch.randint(-3, 4, (512, dim), generator=g).float().to(dev)
        host.apply_gradients(ids, grads, 0.1)
        emb.apply_gradients(ids, grads, 0.1)
    ids = torch.randint(-2, n + 2, (1024,), generator=g).to(dev)
    cached = host.cache_map >= 0
    out["host"] = (host.gather(ids).cpu(), emb.gather(ids).cpu(), host.to_array(), emb.to_array(),
                   torch.equal(host.cache_rows[host.cache_map[cached].long()].cpu(),
                               host.host_table[cached.cpu()]),
                   {k.name: k.launches for k in KERNELS})
    # the hot cache's waves against the store's gather
    tab = emb.as_sharded_table()
    cache = build_hot_cache(tab, hot)
    CACHE_STATS["waves"] = 0
    got = gather_with_cache(tab, cache, ids, cold_capacity_factor=0.05)
    out["cache"] = (torch.equal(got, tab.gather(ids)), CACHE_STATS["waves"])
    # the cached step against the uncached one
    runs = {}
    for with_cache in (False, True):
        st = wt.build_synthetic(WT_CFG, device=dev, seed=0, mesh=mesh)
        if with_cache:
            st.cache = build_hot_cache(st.embedding.as_sharded_table(),
                                       wt.embedding.hot_ids_by_degree(st.graph.row_ptr, 0.2))
        runs[with_cache] = _wt_steps(st, centers, rank)
    out["cached_steps"] = runs
    # the host-tier step, the hetero step and link prediction at world 4
    st = wt.build_synthetic(WT_CFG, device=dev, seed=0, host_cache_ratio=0.25, mesh=mesh)
    out["host_steps"] = _wt_steps(st, centers, rank)
    hs = wt.build_hetero(WT_HCFG, device=dev, seed=1, mesh=mesh)
    hc = [torch.from_numpy(np.random.RandomState(i).choice(hs.train_ids.cpu().numpy(), 64,
                                                           replace=False)).reshape(4, -1)
          for i in range(3)]
    out["hetero_steps"] = _wt_steps(hs, hc, rank, wt.hetero_train_step)
    run = lp.LinkPredictionRun(lp.make_args(["--smoke", "--device", str(dev)]), mesh)
    run.make_batch(run.train_e[:run.B])
    out["link_prediction"] = [float(run.train_step(run.make_batch(run.train_e[b * run.B:
                                                                             (b + 1) * run.B]),
                                                   b)[0]) for b in range(3)]
    return out


@pytest.fixture(scope="module")
def world_tier():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return wt.parallel.multiprocess_run(4, _world_tier_rank, backend="gloo", device="cuda:0",
                                        timeout=600)


def test_world4_sharded_csr_sample_on_one_card(dev, world_tier):
    """The sample over the sharded CSR on the card (J serves the 4-byte
    rows) equals the replicated graph's on the card (kernels C and K): the
    multilayer samples, and one hop bit for bit on every field (uniform) or
    by the near-tie rule (weighted: K's logf against the plain log). A
    sharded row_ptr beside a whole col reads the columns by C's fetch
    (``sample_cols``), a launch a hop, and samples the same."""
    st = wt.build_synthetic(WT_CFG, device=dev, seed=0)
    rep, _ = _wt_sharded_graph(st, None)
    centers = _wt_centers(WT_CFG)[0]
    for r, out in enumerate(world_tier):
        assert out["sample", False][0]
        assert out["sample_launches"]["row_gather_masked"] > 0
        same, launches = out["mixed"]  # a whole col beside the sharded row_ptr
        assert same and launches["sample_cols"] >= len(WT_CFG.fanouts), launches
        for weighted in (False, True):
            c = centers[r].to(dev)
            want = rep.sample_one_hop(c, 5, seed=2, weighted=weighted)
            got = out["sample", weighted][1]
            if not weighted:
                for f, v in got.items():
                    assert torch.equal(v, getattr(want, f).cpu()), f
                continue
            near, inside = SM.weighted_near_ties(rep.row_ptr.cpu(), rep.col.cpu(),
                                                 rep.edge_weight.cpu(), c.cpu(), 5, 2, 0)
            assert SM.weighted_rule(got, {f: getattr(want, f) for f in got}, near, inside)[2] == 0


def test_world4_host_tier_on_one_card(dev, world_tier):
    """The host tier over 4 ranks on card 0 (each rank's pinned shard, E and
    kernel L's host route through its mapped pointer, A on its cache lines,
    B in the exchange's un-permute) trains as the device embedding over
    them, bit for bit on integer gradients, gathers the same rows, and keeps
    its cache coherent on every rank; F is not launched."""
    for out in world_tier:
        hg, dg, ht, dt, coherent, launches = out["host"]
        assert torch.equal(hg, dg) and coherent
        np.testing.assert_array_equal(ht, dt)
        for k in ("host_gather", "sparse_apply_host", "row_gather", "row_scatter"):
            assert launches[k] > 0, launches
        assert launches["host_scatter"] == 0, launches


def test_world4_cached_gather_and_step_on_one_card(dev, world_tier):
    """The cached gather over 4 ranks is the store's gather bit for bit
    after several waves; the cached step gives the uncached losses."""
    for out in world_tier:
        same, waves = out["cache"]
        assert same and waves >= 3
        assert out["cached_steps"][True] == out["cached_steps"][False]


def test_world4_host_hetero_and_link_steps_on_one_card(dev, world_tier):
    """The host-tier step, the hetero step and link prediction at world 4
    on card 0 against world 1 on the card, losses within 1e-5."""
    centers = _wt_centers(WT_CFG)
    st = wt.build_synthetic(WT_CFG, device=dev, seed=0, host_cache_ratio=0.25)
    host = _wt_steps(st, centers, None)
    hs = wt.build_hetero(WT_HCFG, device=dev, seed=1)
    hc = [torch.from_numpy(np.random.RandomState(i).choice(hs.train_ids.cpu().numpy(), 64,
                                                           replace=False)) for i in range(3)]
    hetero = _wt_steps(hs, hc, None, wt.hetero_train_step)
    from wholegraph_tpu_torch.examples import link_prediction as lp

    run = lp.LinkPredictionRun(lp.make_args(["--smoke", "--device", "cuda"]), device=dev)
    run.make_batch(run.train_e[:run.B])
    link = [float(run.train_step(run.make_batch(run.train_e[b * run.B:(b + 1) * run.B]), b)[0])
            for b in range(3)]
    for out in world_tier:
        np.testing.assert_allclose(out["host_steps"], host, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["hetero_steps"], hetero, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["link_prediction"], link, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the scanned epoch: a CUDA graph of the step, and the seed it reads on the card
# ---------------------------------------------------------------------------

SCAN_CFG = wt.SageTrainConfig(n_nodes=3000, deg=8, dim=32, hidden=32, num_classes=8,
                              batch=128, fanouts=(5, 4))
SCAN_SEEDS = (0, 7, 2**31, 2**32 + 5, -1)


@pytest.mark.parametrize("seed", SCAN_SEEDS)
def test_device_seed_is_the_scalar_seed(dev, seed):
    """Kernels C and K with a 0-dim seed tensor on the card (read there)
    give the scalar seed's bits, the uint32 wrap included."""
    g = _gen(31)
    degs = torch.randint(0, 40, (2000,), generator=g)
    rp = torch.cat([torch.zeros(1, dtype=torch.int64), degs.cumsum(0)]).to(torch.int32).to(dev)
    col = torch.randint(0, 2000, (int(rp[-1]),), generator=g, dtype=torch.int32).to(dev)
    w = (torch.rand(col.shape, generator=g) + 0.1).to(dev)
    pairs = SM.interleave_col_weights(col, w)
    centers = torch.randint(-3, 2003, (700,), generator=g, dtype=torch.int32).to(dev)
    t = torch.tensor(seed, dtype=torch.int64, device=dev)
    for K in (10, 40):
        for hop in (0, 1):
            for fn in (lambda s: SM.sample_hop_uniform(rp, col, centers, K, s, hop),
                       lambda s: SM.sample_hop_weighted(rp, None, None, centers, K, s, hop,
                                                        pairs=pairs)):
                a, b = fn(seed), fn(t)
                for f in ("neighbors", "mask", "positions", "edge_ids", "degree"):
                    assert torch.equal(getattr(a, f), getattr(b, f)), (f, K, hop)
    ref = SM.csr_sample_neighbors_plain(rp.cpu(), col.cpu(), centers.cpu(), 10, seed=seed)
    got = SM.sample_hop_uniform(rp, col, centers, 10, t, 0)
    assert torch.equal(got.neighbors.cpu(), ref.neighbors)


def test_step_table_on_card_is_the_int_step(dev):
    """LazyAdam with a row of ``step_table`` on the card (reciprocals,
    multiplied) gives the int step's bits (a division by a host scalar,
    which ATen runs as a product with its f32 reciprocal)."""
    opt = LazyAdam()
    g = _gen(32)
    rows = torch.randn(300, 64, generator=g).to(dev)
    grads = torch.randn(300, 64, generator=g).to(dev)
    slots = {"m": torch.randn(300, 64, generator=g).to(dev) * 1e-3,
             "v": torch.rand(300, 64, generator=g).to(dev) * 1e-6}
    steps = [1, 2, 17, 1000]
    table = opt.step_table(steps, dev)
    for i, t in enumerate(steps):
        a = opt.update(rows, grads, slots, t, 1e-2)
        b = opt.update(rows, grads, slots, table[i], 1e-2)
        assert torch.equal(a[0], b[0]) and all(torch.equal(a[1][s], b[1][s]) for s in slots)


def _scan_state(dev, cfg, cache):
    st = wt.build_synthetic(cfg, device=dev, seed=2)
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=cfg.lr, capturable=True)
    if cache:
        st.cache = wt.embedding.build_hot_cache(st.embedding.as_sharded_table(),
                                               wt.embedding.hot_ids_by_degree(st.graph.row_ptr,
                                                                              0.2))
    return st


@pytest.mark.parametrize("case", ["sage", "weighted_cache", "gat_dropout"])
def test_graphed_epoch_matches_eager_epoch(dev, case):
    """Two epochs of 6 steps through ``train_epoch`` (2 warm-up steps, one
    captured step, 4 replays; then 6 replays of the same graph) against the
    same steps by ``train_step`` on the card: losses, the table and m within
    1e-5 (D's backward sums by atomics in either run)."""
    cfg = dataclasses.replace(
        SCAN_CFG, **{"sage": {}, "weighted_cache": {"sample_method": "weighted"},
                     "gat_dropout": {"model_type": "gat"}}[case])
    cache, dropout = case == "weighted_cache", case == "gat_dropout"
    eager, graphed = _scan_state(dev, cfg, cache), _scan_state(dev, cfg, cache)
    rs = np.random.RandomState(3)
    c = torch.from_numpy(rs.randint(0, cfg.n_nodes, (6, cfg.batch)).astype(np.int32)).to(dev)
    y = eager.labels[c.long()]
    ga = torch.Generator(device=dev).manual_seed(9) if dropout else None
    gb = torch.Generator(device=dev).manual_seed(9) if dropout else None
    for epoch in range(2):
        want = torch.stack([wt.train_step(eager, c[i], y[i], seed=6 * epoch + i, generator=ga)
                            for i in range(6)])
        got = wt.train.train_epoch(graphed, c, y, torch.arange(6) + 6 * epoch, generator=gb)
        rec = graphed.epoch_graph
        assert rec is not None and rec.graph is not None
        if epoch == 0:
            first = rec
        assert rec is first  # the second epoch replays the first one's graph
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(graphed.embedding.table, eager.embedding.table,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(graphed.embedding.slots["m"], eager.embedding.slots["m"],
                                   rtol=1e-5, atol=1e-5)
        if cache:
            assert torch.equal(graphed.cache.valid, eager.cache.valid)
    assert graphed.embedding.step == eager.embedding.step == 12


# -- the nineteenth slice: kernel L, the sparse apply's row update -----------


def _apply_both(dev, opt, table, slots, ids, grads, step=APPLY_STEP):
    """Kernel L and the plain route on card copies of one case: the tables
    and slots after each, and L's launches."""
    outs = []
    for fn in (L.apply_rows, L.apply_rows_plain):
        t = table.to(dev)
        s = {k: v.to(dev) for k, v in slots.items()}
        before = L.SPARSE_APPLY.launches
        fn(t, s, ids.to(dev), grads.to(dev), opt, step, APPLY_LR)
        outs.append((t.cpu(), {k: v.cpu() for k, v in s.items()},
                     L.SPARSE_APPLY.launches - before))
    return outs


def _same_state(a, b):
    return same_bits(a[0], b[0]) and all(same_bits(a[1][k], b[1][k]) for k in a[1])


@pytest.mark.parametrize("kind", APPLY_KINDS)
@pytest.mark.parametrize("D", APPLY_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_sparse_apply_matches_plain(dev, name, dtype, D, kind):
    """L against its plain version on the card, bit for bit, on the CPU
    tests' cases (padding, ids out of range on both sides, NaN gradients on
    skipped slots, no slot); one launch a call with a slot."""
    opt = APPLY_OPTS[name]
    got, ref = _apply_both(dev, opt, *apply_case(opt, dtype, D, kind))
    assert _same_state(got, ref)
    assert got[2] == (0 if kind == "empty" else 1) and ref[2] == 0


@pytest.mark.parametrize("name", ["lazy_adam", "adam_w", "rms_prop", "ada_grad", "sgd_wd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 3])
def test_sparse_apply_takes_the_table_types_gradients_and_int32_ids(dev, name, dtype, D):
    """Gradients of the table's own 16-bit type, and int32 ids."""
    opt = APPLY_OPTS[name]
    got, ref = _apply_both(dev, opt, *apply_case(opt, dtype, D, "mixed", seed=1,
                                                 grad_dtype=dtype, id_dtype=torch.int32))
    assert _same_state(got, ref) and got[2] == 1


@pytest.mark.parametrize("R", [1, 2, 31, 32, 33, 255, 256, 257, 511, 512, 513, 4097, 70000])
@pytest.mark.parametrize("D", [256, 48, 16])
def test_sparse_apply_batch_sizes(dev, R, D):
    """From one slot to 70,000 (tiles of 32 to 512 slots, their ragged
    ends), LazyAdam over a table of 100,000 rows, the last third padding."""
    opt = APPLY_OPTS["lazy_adam"]
    rs = np.random.RandomState(R)
    n = 100_000
    table = torch.from_numpy(rs.randn(n, D).astype(np.float32))
    slots = {"m": torch.from_numpy(rs.randn(n, D).astype(np.float32) * 1e-3),
             "v": torch.from_numpy(rs.rand(n, D).astype(np.float32) * 1e-6)}
    ids = torch.from_numpy(rs.permutation(n)[:R].astype(np.int64))
    ids[R - R // 3:] = n
    grads = torch.from_numpy(rs.randn(R, D).astype(np.float32))
    got, ref = _apply_both(dev, opt, table, slots, ids, grads)
    assert _same_state(got, ref) and got[2] == 1


@pytest.mark.parametrize("name", ["lazy_adam", "adam_w"])
def test_sparse_apply_step_row_is_the_int_step(dev, name):
    """L with an eager step's scalars and with that step's row of
    ``step_table`` on the card (a replayed graph's route) gives the same
    bits, and both the plain route's; the scalars are the row's bits."""
    opt = APPLY_OPTS[name]
    case = apply_case(opt, torch.float32, 64, "mixed", seed=6)
    steps = [1, 2, 17, 1000]
    table = opt.step_table(steps, dev)
    for i, t in enumerate(steps):
        eager, plain = _apply_both(dev, opt, *case, step=t)
        graphed, plain_row = _apply_both(dev, opt, *case, step=table[i])
        assert _same_state(eager, plain) and _same_state(graphed, plain_row)
        assert _same_state(eager, graphed)
        scalars = torch.tensor(L.kernel_params(opt, t, APPLY_LR)[1][7:], dtype=torch.float32)
        assert same_bits(scalars, table[i].cpu())


def test_sparse_apply_launches_once_a_step_rows(dev):
    """``Embedding.apply_gradients`` on the card: L once a ``_step_rows``
    (assume_unique, the dedup path, ``unique_chunk``), never A or B; the
    chunked call bit-equal to the whole one, with deterministic algorithms
    (the dedup path's ``index_add_`` sums duplicates by atomics otherwise)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _launches_once_a_step_rows(dev)
    finally:
        torch.use_deterministic_algorithms(False)


def _launches_once_a_step_rows(dev):
    rs = np.random.RandomState(7)
    n, D, B = 20_000, 64, 5000
    init = rs.randn(n, D).astype(np.float32)
    ids = torch.from_numpy(rs.randint(0, n, B).astype(np.int32)).to(dev)
    uids = torch.from_numpy(rs.permutation(n)[:B].astype(np.int32)).to(dev)
    mask = torch.from_numpy(rs.rand(B) < 0.8).to(dev)
    grads = torch.from_numpy(rs.randn(B, D).astype(np.float32)).to(dev)
    embs = [Embedding.create(n, D, optimizer=LazyAdam(), device=dev).from_array(init)
            for _ in range(2)]
    for k in (L.SPARSE_APPLY, G.ROW_GATHER, G.ROW_SCATTER):
        k.launches = 0
    embs[0].apply_gradients(uids, grads, 0.01, mask=mask, assume_unique=True)
    embs[0].apply_gradients(ids, grads, 0.01, mask=mask)
    assert (L.SPARSE_APPLY.launches, G.ROW_GATHER.launches, G.ROW_SCATTER.launches) == (2, 0, 0)
    embs[1].apply_gradients(uids, grads, 0.01, mask=mask, assume_unique=True, unique_chunk=1024)
    embs[1].apply_gradients(ids, grads, 0.01, mask=mask, unique_chunk=1024)
    chunks = L.SPARSE_APPLY.launches - 2
    assert chunks >= 6 and (G.ROW_GATHER.launches, G.ROW_SCATTER.launches) == (0, 0)
    assert np.array_equal(embs[0].to_array(), embs[1].to_array())
    assert all(np.array_equal(embs[0].slot_to_array(s), embs[1].slot_to_array(s))
               for s in ("m", "v"))


def test_sparse_apply_foreign_optimizer_runs_a_update_b(dev):
    """A subclass from outside the registry runs A x1, its update, B x1 (SGD
    has no slots), and gives the plain route's bits; L is not launched."""
    opt = ScaledSGD()
    case = apply_case(opt, torch.float32, 32, "mixed", seed=8)
    for k in (L.SPARSE_APPLY, G.ROW_GATHER, G.ROW_SCATTER):
        k.launches = 0
    got, ref = _apply_both(dev, opt, *case)
    assert _same_state(got, ref)
    assert (L.SPARSE_APPLY.launches, G.ROW_GATHER.launches, G.ROW_SCATTER.launches) == (0, 1, 1)


def test_captured_train_step_launches_sparse_apply(dev):
    """``train_epoch``'s captured step runs L: the warm-up steps launch it
    once each, the capture records one launch and the replays run it; no B
    on the path. The graphed table is the eager one within 1e-5."""
    eager, graphed = _scan_state(dev, SCAN_CFG, False), _scan_state(dev, SCAN_CFG, False)
    rs = np.random.RandomState(9)
    c = torch.from_numpy(rs.randint(0, SCAN_CFG.n_nodes, (5, SCAN_CFG.batch)).astype(
        np.int32)).to(dev)
    y = eager.labels[c.long()]
    for k in (L.SPARSE_APPLY, G.ROW_SCATTER):
        k.launches = 0
    got = wt.train.train_epoch(graphed, c, y, torch.arange(5))
    assert L.SPARSE_APPLY.launches == wt.train.WARMUP_STEPS + 1 and G.ROW_SCATTER.launches == 0
    want = torch.stack([wt.train_step(eager, c[i], y[i], seed=i) for i in range(5)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(graphed.embedding.table, eager.embedding.table, rtol=1e-5,
                               atol=1e-5)


def test_graphed_epoch_raises_when_capture_fails(dev, monkeypatch):
    """A step that reads the card on the host cannot be captured: the
    epoch raises and runs no step eagerly in its place."""
    st = _scan_state(dev, SCAN_CFG, False)
    c = torch.zeros((4, SCAN_CFG.batch), dtype=torch.int32, device=dev)
    real = wt.train.cross_entropy_loss

    def host_read(logits, labels):
        loss = real(logits, labels)
        float(loss)  # a device-to-host read: refused while the stream is captured
        return loss

    monkeypatch.setattr(wt.train, "cross_entropy_loss", host_read)
    with pytest.raises(RuntimeError):
        wt.train.train_epoch(st, c, c, torch.arange(4))
    assert st.epoch_graph is None and st.embedding.step == 0
    torch.cuda.synchronize()



# -- the twentieth slice: kernel L's host route, the host tier's apply -------


def _pinned_at(t, offset):
    """A pinned copy of ``t`` that starts ``offset`` rows into a larger
    pinned allocation (0: a tensor of its own)."""
    big = H.pinned_empty((t.shape[0] + offset, t.shape[1]), t.dtype)
    big.fill_(7)
    view = big[offset:]
    view.copy_(t)
    return view


def composed_host(table, slots, ids, grads, opt, step, lr, lines, cache_rows):
    """The host tier's apply before kernel L's host route: kernel E on the
    table and each slot, the optimizer's update on the card, kernel F on
    each, kernel B on the cache lines."""
    names = tuple(sorted(slots))
    rows = H.host_gather_rows(table, ids, _sort=False).float()
    srows = {s: H.host_gather_rows(slots[s], ids, _sort=False) for s in names}
    new_rows, new_srows = opt.update(rows, grads.float(), srows, step, lr)
    new_rows = new_rows.to(table.dtype).contiguous()
    H.host_scatter_rows(table, ids, new_rows)
    for s in names:
        H.host_scatter_rows(slots[s], ids, new_srows[s].contiguous())
    valid = (ids >= 0) & (ids < table.shape[0])
    G.scatter_rows(cache_rows, torch.where(valid & (lines >= 0), lines, -1), new_rows)


def _host_case(opt, dtype, D, kind, seed=0):
    """:func:`apply_case` with each slot's cache line (37 random rows
    cached, their lines holding their table rows) and the cache rows."""
    table, slots, ids, grads = apply_case(opt, dtype, D, kind, seed=seed)
    rs = np.random.RandomState(seed + 100)
    rows = table.shape[0]
    cache_map = torch.full((rows,), -1, dtype=torch.int32)
    hot = torch.from_numpy(rs.permutation(rows)[:37])
    cache_map[hot] = torch.arange(37, dtype=torch.int32)
    valid = (ids >= 0) & (ids < rows)
    lines = torch.where(valid, cache_map[torch.where(valid, ids, 0).long()], -1)
    cache_rows = torch.zeros((37, D), dtype=dtype)
    cache_rows[cache_map[hot].long()] = table[hot]
    return table, slots, ids, grads, lines, cache_rows


def _tier_at(dev, table, slots, names, offset=0):
    """Copies of ``table`` and its ``slots`` (``names``' order) as the host
    tier holds them, each in an allocation of its own from the kernels'
    library (``H.host_zeros``), ``offset`` rows into it, every other byte 7:
    ``([allocation of the table, then of each slot], table view, {slot:
    view})``."""
    mems, views = [], []
    for t in [table] + [slots[k] for k in names]:
        mem = H.host_zeros((t.shape[0] + offset, t.shape[1]), t.dtype, torch.device(dev))
        assert mem.is_pinned() and mem.untyped_storage().nbytes() == mem.nbytes
        mem.view(torch.uint8).fill_(7)
        mem[offset:].copy_(t)
        mems.append(mem)
        views.append(mem[offset:])
    return mems, views[0], dict(zip(names, views[1:]))


def _host_both(dev, opt, table, slots, ids, grads, lines, cache_rows, step=APPLY_STEP,
               offset=0, tier=False):
    """Kernel L's host route and the composed route, each on its own pinned
    copies of a case (the table ``offset`` rows into a larger allocation;
    with ``tier``, the table and slots as the host tier allocates them,
    :func:`_tier_at`): the table, slots and cache after each, and
    the launches of L's host route, E, F and B."""
    outs = []
    kerns = (L.SPARSE_APPLY_HOST, H.HOST_GATHER, H.HOST_SCATTER, G.ROW_SCATTER)
    for route in ("host", "composed"):
        if tier:
            _, t, s = _tier_at(dev, table, slots, opt.slot_names, offset)
        else:
            t = _pinned_at(table, offset)
            s = {k: _pinned(v) for k, v in slots.items()}
        c = cache_rows.to(dev)
        args = (t, s, ids.to(dev), grads.to(dev), opt, step, APPLY_LR)
        before = [k.launches for k in kerns]
        if route == "host":
            L.apply_rows_host(*args, lines=lines.to(dev), cache_rows=c)
        else:
            composed_host(*args, lines.to(dev), c)
        torch.cuda.synchronize()
        outs.append((t.clone(), {k: v.clone() for k, v in s.items()}, c.cpu(),
                     tuple(k.launches - b for k, b in zip(kerns, before))))
    return outs


def _host_checks(got, ref, table, ids, lines, cache_rows):
    """Bit-equal states and caches; untouched rows unchanged; every line of
    the cache equal to its host row after the step."""
    assert _same_state(got, ref) and same_bits(got[2], ref[2])
    n = table.shape[0]
    valid = ((ids >= 0) & (ids < n)).numpy()
    untouched = np.ones(n, bool)
    untouched[ids.numpy()[valid]] = False
    assert same_bits(got[0][untouched], table[untouched])
    lines = lines.numpy()
    hit = np.nonzero(valid & (lines >= 0))[0]
    for i in hit:  # a touched cached row: its line holds the new host row
        assert same_bits(got[2][lines[i]], got[0][ids[i]])
    kept = np.setdiff1d(np.arange(cache_rows.shape[0]), lines[hit])
    assert same_bits(got[2][kept], cache_rows[kept])  # an untouched line keeps its row


@pytest.mark.parametrize("kind", APPLY_KINDS)
@pytest.mark.parametrize("D", APPLY_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_sparse_apply_host_matches_composed(dev, name, dtype, D, kind):
    """L's host route against E, the update, F and B on the card, bit for
    bit, on the CPU tests' cases (padding, ids out of range on both sides,
    NaN gradients on skipped slots, no slot), with cached rows and rows not
    cached; one launch a call with a slot, and no E, F or B."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads, lines, cache_rows = _host_case(opt, dtype, D, kind)
    got, ref = _host_both(dev, opt, table, slots, ids, grads, lines, cache_rows)
    _host_checks(got, ref, table, ids, lines, cache_rows)
    assert got[3] == ((0 if kind == "empty" else 1), 0, 0, 0)


@pytest.mark.parametrize("R", [1, 2, 31, 32, 33, 255, 256, 257, 511, 512, 513, 4097, 70000])
@pytest.mark.parametrize("D", [256, 48, 16])
def test_sparse_apply_host_batch_sizes(dev, R, D):
    """From one slot to 70,000 over a table of 100,000 rows in a larger
    pinned allocation (an offset of 3 rows), LazyAdam, the last third
    padding, ascending slots as the apply gives them."""
    opt = APPLY_OPTS["lazy_adam"]
    rs = np.random.RandomState(R)
    n = 100_000
    table = torch.from_numpy(rs.randn(n, D).astype(np.float32))
    slots = {"m": torch.from_numpy(rs.randn(n, D).astype(np.float32) * 1e-3),
             "v": torch.from_numpy(rs.rand(n, D).astype(np.float32) * 1e-6)}
    ids = torch.from_numpy(np.sort(rs.permutation(n)[:R]).astype(np.int64))
    ids[R - R // 3:] = n
    grads = torch.from_numpy(rs.randn(R, D).astype(np.float32))
    hot = torch.from_numpy(rs.permutation(n)[:1000])
    cache_map = torch.full((n,), -1, dtype=torch.int32)
    cache_map[hot] = torch.arange(1000, dtype=torch.int32)
    valid = ids < n
    lines = torch.where(valid, cache_map[torch.where(valid, ids, 0)], -1)
    cache_rows = torch.zeros((1000, D))
    cache_rows[cache_map[hot].long()] = table[hot]
    got, ref = _host_both(dev, opt, table, slots, ids, grads, lines, cache_rows, offset=3)
    _host_checks(got, ref, table, ids, lines, cache_rows)
    assert got[3] == (1, 0, 0, 0)


@pytest.mark.parametrize("name", ["lazy_adam", "adam_w", "rms_prop", "sgd_wd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_sparse_apply_host_table_at_an_offset(dev, name, dtype):
    """A table 5 rows into a larger pinned allocation (its device address
    from the allocation's base and the table's offset), and state tables
    of their own: the host route's bits, and the rows before the table
    untouched."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads, lines, cache_rows = _host_case(opt, dtype, 64, "mixed", seed=9)
    got, ref = _host_both(dev, opt, table, slots, ids, grads, lines, cache_rows, offset=5)
    _host_checks(got, ref, table, ids, lines, cache_rows)
    assert got[3][0] == 1
    t = _pinned_at(table, 5)
    L.apply_rows_host(t, {k: _pinned(v) for k, v in slots.items()}, ids.to(dev), grads.to(dev),
                      opt, APPLY_STEP, APPLY_LR)
    torch.cuda.synchronize()
    assert bool((t._base[:5] == 7).all()) and same_bits(t, got[0])


@pytest.mark.parametrize("name", ["lazy_adam", "adam_w"])
def test_sparse_apply_host_step_row_is_the_int_step(dev, name):
    """The host route with an eager step's scalars and with that step's
    row of ``step_table`` on the card gives the same bits as the composed
    route."""
    opt = APPLY_OPTS[name]
    case = _host_case(opt, torch.float32, 64, "mixed", seed=6)
    table = opt.step_table([17], dev)
    eager, ref = _host_both(dev, opt, *case, step=17)
    graphed, _ = _host_both(dev, opt, *case, step=table[0])
    assert _same_state(eager, ref) and _same_state(graphed, ref)
    assert same_bits(eager[2], graphed[2])


def test_sparse_apply_host_refuses_memory_that_is_not_pinned(dev):
    """A table or a state table that is not pinned raises, and nothing is
    launched; a foreign optimizer takes the composed route on the card."""
    opt = APPLY_OPTS["lazy_adam"]
    table, slots, ids, grads, lines, cache_rows = _host_case(opt, torch.float32, 16, "mixed",
                                                             seed=10)
    before = L.SPARSE_APPLY_HOST.launches
    with pytest.raises(CudaError, match="not in pinned"):
        L.apply_rows_host(table, {k: _pinned(v) for k, v in slots.items()}, ids.to(dev),
                          grads.to(dev), opt, 1, 0.1)
    with pytest.raises(CudaError, match="not in pinned"):
        L.apply_rows_host(_pinned(table), slots, ids.to(dev), grads.to(dev), opt, 1, 0.1)
    assert L.SPARSE_APPLY_HOST.launches == before
    sgd = ScaledSGD()
    t1, t2 = _pinned(table), table.clone()
    c1, c2 = cache_rows.to(dev), cache_rows.clone()
    kerns = (L.SPARSE_APPLY_HOST, H.HOST_GATHER, H.HOST_SCATTER, G.ROW_SCATTER)
    counts = [k.launches for k in kerns]
    L.apply_rows_host(t1, {}, ids.to(dev), grads.to(dev), sgd, 1, 0.5, lines=lines.to(dev),
                      cache_rows=c1)
    assert [k.launches - c for k, c in zip(kerns, counts)] == [0, 1, 1, 1]
    L.apply_rows_host_plain(t2, {}, ids, grads, sgd, 1, 0.5, lines=lines, cache_rows=c2)
    torch.cuda.synchronize()
    assert same_bits(t1, t2) and same_bits(c1.cpu(), c2)


# -- the twenty-first slice: the host tier's tables in allocations of their own


@pytest.mark.parametrize("name", ["lazy_adam", "adam_w", "rms_prop", "sgd_wd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_sparse_apply_host_over_the_tier_memory(dev, name, dtype):
    """The table and its state tables 5 rows into allocations of the host
    tier's own (``H.host_zeros``): the host route's bits equal the composed
    route's, and every byte of each allocation outside the touched rows is
    untouched."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads, lines, cache_rows = _host_case(opt, dtype, 64, "mixed", seed=9)
    got, ref = _host_both(dev, opt, table, slots, ids, grads, lines, cache_rows, offset=5,
                          tier=True)
    _host_checks(got, ref, table, ids, lines, cache_rows)
    assert got[3][0] == 1
    mems, t, s = _tier_at(dev, table, slots, opt.slot_names, 5)
    L.apply_rows_host(t, s, ids.to(dev), grads.to(dev), opt, APPLY_STEP, APPLY_LR)
    torch.cuda.synchronize()
    want, _, _ = _tier_at(dev, got[0], got[1], opt.slot_names, 5)
    assert all(same_bits(m, w) for m, w in zip(mems, want))  # 7 in every other byte


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [256, 100, 3])
def test_host_rows_over_the_tier_memory(dev, D, dtype):
    """E reads a table of the tier's own allocation and F writes it: each
    against its plain version over the same table, and F leaves the rows
    before the table and every other allocation alone."""
    names = ("m", "v")
    table = torch.randn(500, D, generator=_gen(40)).to(dtype)
    slots = {k: torch.randn(500, D, generator=_gen(41 + i)) for i, k in enumerate(names)}
    mems, t, s = _tier_at(dev, table, slots, names, 2)
    for case in ("uniform", "duplicates", "ascending"):
        ids = _host_slots(case, torch.int64)
        stats = torch.zeros(1, dtype=torch.int64, device=dev)
        out = H.host_gather_rows(t, ids.to(dev), _sort=case != "ascending", _stats=stats)
        assert torch.equal(out.cpu(), H.host_gather_rows_plain(t, ids))
        valid = ids[(ids >= 0) & (ids < 500)]
        assert stats.item() == torch.unique(valid).numel() * D * table.element_size()
    wslots = torch.randperm(500, generator=_gen(44))[:300].to(torch.int32)
    wslots[::7] = -1
    rows = torch.randn(300, D, generator=_gen(45)).to(dtype)
    before = H.HOST_SCATTER.launches
    H.host_scatter_rows(t, wslots.to(dev), rows.to(dev))
    assert H.HOST_SCATTER.launches == before + 1
    torch.cuda.synchronize()
    want_t = H.host_scatter_rows_plain(table.clone(), wslots, rows)
    want, _, _ = _tier_at(dev, want_t, slots, names, 2)
    assert all(same_bits(m, w) for m, w in zip(mems, want))


def test_host_embedding_holds_exact_allocations(dev):
    """A LazyAdam host tier holds its table, m and v each in a pinned,
    mapped allocation of its own: a tensor of exactly rows x 1 KB, its
    request rounded up to HOST_ROUND, counted by ``host_alloc_bytes`` and
    freed with the embedding."""
    gc.collect()
    before = H.host_alloc_bytes()
    emb = HostEmbedding.create(10_000, 256, optimizer=LazyAdam(), cache_ratio=0.01, device=dev)
    tables = [emb.host_table, *emb.host_slots.values()]
    nbytes = 10_000 * 1024
    for v in tables:
        assert v.is_pinned() and v.nbytes == nbytes and v.untyped_storage().nbytes() == nbytes
    assert len({v.untyped_storage().data_ptr() for v in tables}) == 3
    now = H.host_alloc_bytes()
    assert now["current"] - before["current"] == 3 * (-(-nbytes // H.HOST_ROUND) * H.HOST_ROUND)
    assert now["allocations"] == before["allocations"] + 3
    emb.init(torch.Generator(device=dev).manual_seed(1), hot_ids=np.arange(0, 10_000, 97))
    ids = torch.randint(0, 10_000, (4096,), generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    rows = emb.gather(ids)
    assert torch.equal(rows.cpu(), emb.host_table[ids.cpu()])
    del emb, rows, v, tables
    gc.collect()
    assert H.host_alloc_bytes()["current"] == before["current"]


def test_host_embedding_dropped_during_a_capture(dev):
    """A host tier whose last reference dies while a CUDA graph is being
    captured is not freed then (the free synchronizes the device, which
    would invalidate the capture): the capture completes and replays, and
    the memory is freed once the capture has ended."""
    gc.collect()
    before = H.host_alloc_bytes()["current"]
    emb = HostEmbedding.create(1000, 64, optimizer=LazyAdam(), cache_ratio=0.1, device=dev)
    held = H.host_alloc_bytes()["current"]
    assert held > before
    x = torch.ones(1024, device=dev)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x * 2
        del emb
        gc.collect()
        y += 1
    assert H.host_alloc_bytes()["current"] == held  # waits for the capture's end
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 3))
    H.release_deferred_host_memory()
    assert H.host_alloc_bytes()["current"] == before
