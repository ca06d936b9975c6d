"""The plain reference against hand computations at tiny sizes, and its
sampler against the port's on the CPU."""

import itertools

import pytest
import torch

from wgbench.reference import models as M
from wgbench.reference import rng
from wgbench.reference.sampler import multilayer_sample, sample_hop

# a CSR of 5 nodes: 0 -> 1 2 3 4 4 (duplicate kept), 1 -> 0, 2 -> (none), 3 -> 3 0, 4 -> 0 1 2
ROW_PTR = torch.tensor([0, 5, 6, 6, 8, 11], dtype=torch.int32)
COL = torch.tensor([1, 2, 3, 4, 4, 0, 3, 0, 0, 1, 2], dtype=torch.int32)


def _hand_draw(seed, c, hop, deg, K):
    """Slot j takes the (r_j + 1)-th smallest position not yet taken."""
    if deg <= K:
        return list(range(deg))
    taken = []
    for j in range(K):
        r = int(rng.rand_u32(seed, c, hop * rng.HOP_STRIDE + j)) % (deg - j)
        free = [p for p in range(deg) if p not in taken]
        taken.append(free[r])
    return taken


@pytest.mark.parametrize("seed,K", list(itertools.product([0, 7, 2**33 + 5], [1, 2, 3, 6])))
def test_sample_hop_by_hand(seed, K):
    centres = torch.arange(5, dtype=torch.int32)
    hop = sample_hop(ROW_PTR, COL, centres, K, seed, 1)
    for c in range(5):
        lo, hi = int(ROW_PTR[c]), int(ROW_PTR[c + 1])
        pos = _hand_draw(seed, c, 1, hi - lo, K)
        want = [int(COL[lo + p]) for p in pos]
        got = hop.nbrs[c][hop.valid[c]].tolist()
        assert got == want
        assert int(hop.valid[c].sum()) == min(hi - lo, K)


def test_rng_by_hand():
    def mix(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & 0xFFFFFFFF
        return x ^ (x >> 16)

    for seed, a, b in [(0, 0, 0), (1, 2, 3), (2**32 + 9, -1, 5 << 20)]:
        h = mix((seed & 0xFFFFFFFF) ^ 0x9E3779B9)
        h = mix((a & 0xFFFFFFFF) ^ h)
        h = mix((b & 0xFFFFFFFF) ^ h)
        assert int(rng.rand_u32(seed, a, b)) == h


def test_sampler_matches_the_ports_plain_sampler():
    from wholegraph_tpu_torch.ops.sampling import csr_sample_neighbors_plain

    g = torch.Generator().manual_seed(0)
    n = 300
    deg = torch.randint(0, 40, (n,), generator=g)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64), deg.cumsum(0)]).to(torch.int32)
    col = torch.randint(0, n, (int(row_ptr[-1]),), generator=g, dtype=torch.int32)
    centres = torch.randperm(n, generator=g)[:100].to(torch.int32)
    for hop, K in enumerate((15, 10, 5)):
        mine = sample_hop(row_ptr, col, centres, K, 12345, hop)
        port = csr_sample_neighbors_plain(row_ptr, col, centres, K, seed=12345, hop=hop)
        assert torch.equal(mine.valid, port.mask)
        assert torch.equal(mine.nbrs[mine.valid], port.neighbors[port.mask].long())


def test_levels_nest_and_hold_the_neighbours():
    s = multilayer_sample(ROW_PTR, COL, torch.tensor([0, 3]), [2, 2], 5)
    for l, hop in enumerate(s.hops):
        assert set(s.levels[l].tolist()) <= set(s.levels[l + 1].tolist())
        assert set(hop.nbrs[hop.valid].tolist()) <= set(s.levels[l + 1].tolist())


def test_sage_layer_by_hand():
    x = torch.tensor([[1.0, 2.0], [3.0, 5.0], [-1.0, 4.0]])
    # target 0 (row 0) has neighbours rows 1, 2 and one invalid slot; target 1 (row 2) none
    nbr = torch.tensor([[1, 2, 0], [0, 0, 0]])
    valid = torch.tensor([[True, True, False], [False, False, False]])
    w = torch.arange(8, dtype=torch.float32).reshape(4, 2) / 8
    b = torch.tensor([0.5, -0.5])
    out = M.sage_layer(x, torch.tensor([0, 2]), nbr, valid, w, b, "float32")
    h0 = torch.tensor([1.0, 2.0, 1.0, 4.5])  # self, mean of (3, 5) and (-1, 4)
    h1 = torch.tensor([-1.0, 4.0, 0.0, 0.0])
    assert torch.allclose(out, torch.stack([h0 @ w + b, h1 @ w + b]))


def test_gat_layer_by_hand():
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    w = torch.tensor([[1.0, 2.0], [3.0, -1.0]])  # one head of width 2
    a_s, a_d = torch.tensor([[1.0, 0.5]]), torch.tensor([[-0.5, 1.0]])
    nbr = torch.tensor([[1, 2]])
    valid = torch.tensor([[True, False]])
    out = M.gat_layer(x, torch.tensor([0]), nbr, valid, w, a_s, a_d, "float32")
    f = x @ w
    e_d = float(f[0] @ a_d[0])
    logits = [float(f[i] @ a_s[0]) + e_d for i in (0, 1)]  # itself, then neighbour 1
    logits = [v if v > 0 else 0.2 * v for v in logits]
    z = torch.softmax(torch.tensor(logits), 0)
    assert torch.allclose(out[0], z[0] * f[0] + z[1] * f[1])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12, 2**-20])
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, -3.0, 2**-20])
    assert torch.equal(M.round_tf32(x), want)


def test_csr_mean_and_full_graph_by_hand():
    x = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    got = M.csr_mean(ROW_PTR, COL, x, edge_block=3)
    for d in range(5):
        lo, hi = int(ROW_PTR[d]), int(ROW_PTR[d + 1])
        want = x[COL[lo:hi].long()].mean(0) if hi > lo else torch.zeros(2)
        assert torch.allclose(got[d], want)
    w = [{"w": torch.eye(4, 3), "b": torch.zeros(3)}]
    out = M.full_graph_sage(ROW_PTR, COL, x, w, row_block=2)
    assert torch.allclose(out, torch.cat([x, got], 1)[:, :3])
