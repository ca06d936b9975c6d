"""Kernels C and I on the CPU, for what their redesign changed.

Kernel C (``csrc/sample_cols.cu``, ``wg_sample_hop_uniform``) runs a whole
uniform sampler hop in one launch: each centre keeps its chosen positions
sorted and finds slot j's position as ``r_j + #{k : s_k - k <= r_j}``
instead of iterating the fixpoint ``p <- r_j + #{chosen <= p}``. The kernel
cannot run here, so :func:`_kernel_model` replays that per-centre algorithm
in plain Python (uint32 hash, sorted picks, count, insert) and is held
bit-equal, with the plain sampler, to the JAX ``csr_sample_neighbors`` and
to ``wholegraph_tpu.testing.host_sample_uniform``, on degree-0 rows, rows of
degree K and K+1 and a hub, at K in {1, 10, 15, 129, 200}, across seeds and
hops; out-of-range and negative centres against the JAX sampler only
(``host_sample_uniform`` indexes ``row_ptr`` unclamped).

Kernel I (``csrc/sorted_gather.cu``) decides per tile between its window and
direct reads; its plain path is held against the JAX ``local_take_sorted``
on slots whose tiles mix both kinds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.ops import gather_pallas as jgp
from wholegraph_tpu.ops.sampling import csr_sample_neighbors as jax_sample
from wholegraph_tpu.testing import host_sample_uniform
from wholegraph_tpu_torch.ops import gather as tg
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops.sampling import HOP_STRIDE, csr_sample_neighbors
from wholegraph_tpu_torch.utils.error import CudaError, InvalidInput

torch.set_num_threads(1)

FIELDS = ("neighbors", "mask", "positions", "edge_ids", "degree")
KS = (1, 10, 15, 129, 200)
SEED_HOPS = ((0, 0), (7, 1), (123456789, 3))
M32 = 0xFFFFFFFF


def _mix(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _i32(x):
    """Python int wrapped to int32, as the kernel's int32 arithmetic wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _kernel_model(row_ptr, col, centers, K, seed, hop):
    """Kernel C's per-centre work, one centre at a time: the clamped row
    pair, the draws in uint32, the sorted picks with the count
    ``m = #{k : s_k - k <= r}`` and the insertion at m, then the outputs."""
    N, E, B = len(row_ptr) - 1, len(col), len(centers)
    out = {"neighbors": np.full((B, K), -1, np.int32), "mask": np.zeros((B, K), bool),
           "positions": np.zeros((B, K), np.int32), "edge_ids": np.zeros((B, K), np.int32),
           "degree": np.zeros(B, np.int32)}
    key0 = (hop * HOP_STRIDE) & M32
    for b, c in enumerate(int(c) for c in centers):
        lo = int(row_ptr[min(max(c, 0), N)])
        deg = _i32(int(row_ptr[min(max(c + 1, 0), N)]) - lo)
        out["degree"][b] = deg
        if deg <= K:
            pos = [j if j < deg else 0 for j in range(K)]
            valid = [j < deg for j in range(K)]
        else:
            hc = _mix((c & M32) ^ _mix((seed & M32) ^ 0x9E3779B9))
            picks, pos = [], []
            for j in range(K):
                r = _mix(((key0 + j) & M32) ^ hc) % max(deg - j, 1)
                m = sum(1 for k, s in enumerate(picks) if s - k <= r)
                picks.insert(m, r + m)
                pos.append(r + m)
            valid = [True] * K
        for j in range(K):
            out["positions"][b, j] = pos[j]
            out["mask"][b, j] = valid[j]
            out["edge_ids"][b, j] = _i32(lo + pos[j])
            if valid[j] and E > 0:
                out["neighbors"][b, j] = col[min(max(lo + pos[j], 0), E - 1)]
    return out


def _graph(K, seed):
    """40 nodes: rows 0-2 of degree 0, row 3 of degree K, row 4 of K + 1,
    row 5 a hub of max(20 K, 2000), the rest uniform in [0, 2K + 3]."""
    rs = np.random.RandomState(seed)
    degs = rs.randint(0, 2 * K + 4, 40)
    degs[:6] = [0, 0, 0, K, K + 1, max(20 * K, 2000)]
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, 40, int(row_ptr[-1])).astype(np.int32)
    centers = np.concatenate([np.arange(40), [5, 3, 4, 0]]).astype(np.int32)
    return row_ptr, col, centers


OUT_OF_RANGE = np.array([-1, -7, 40, 45, -(2**31), 39], np.int32)


def _jax(row_ptr, col, centers, K, seed, hop):
    j = jax_sample(jnp.asarray(row_ptr), jnp.asarray(col), jnp.asarray(centers), K,
                   seed=seed, hop=hop)
    return {f: np.asarray(getattr(j, f)) for f in FIELDS}


def _plain(row_ptr, col, centers, K, seed, hop):
    res = csr_sample_neighbors(torch.from_numpy(row_ptr), torch.from_numpy(col),
                               torch.from_numpy(centers), K, seed=seed, hop=hop)
    return {f: getattr(res, f).numpy() for f in FIELDS}


def _assert_against_references(sample, K, seed, hop):
    row_ptr, col, centers = _graph(K, seed + K)
    got = sample(row_ptr, col, centers, K, seed, hop)
    ref = _jax(row_ptr, col, centers, K, seed, hop)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    h_nbrs, h_mask, h_pos = host_sample_uniform(row_ptr, col, centers, K, seed=seed, hop=hop)
    np.testing.assert_array_equal(got["mask"], h_mask)
    np.testing.assert_array_equal(got["positions"], h_pos)
    np.testing.assert_array_equal(got["neighbors"], h_nbrs)
    # the degree cases: none, all of K and K + 1, the hub
    assert not got["mask"][:3].any() and got["mask"][3:6].all()
    assert sorted(got["positions"][3]) == list(range(K))
    # out-of-range and negative centres: clamped rows, as the JAX sampler
    got = sample(row_ptr, col, OUT_OF_RANGE, K, seed, hop)
    ref = _jax(row_ptr, col, OUT_OF_RANGE, K, seed, hop)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f"out of range: {f}")
    assert not got["mask"][:5].any()


@pytest.mark.parametrize("seed,hop", SEED_HOPS)
@pytest.mark.parametrize("K", KS)
def test_plain_sampler_bit_equal_to_jax_and_host(K, seed, hop):
    _assert_against_references(_plain, K, seed, hop)


@pytest.mark.parametrize("seed,hop", SEED_HOPS)
@pytest.mark.parametrize("K", KS)
def test_kernel_scan_model_bit_equal_to_jax_and_host(K, seed, hop):
    _assert_against_references(_kernel_model, K, seed, hop)


def test_kernel_scan_model_on_a_hub_many_draws():
    """The count-and-insert scan against the plain fixpoint where picks
    collide most: K close to the degree, and a hub of degree 10^5."""
    row_ptr = np.array([0, 300, 100_300], np.int32)
    col = np.arange(100_300, dtype=np.int32)
    centers = np.array([0, 1, 0, 1], np.int32)
    for K in (299, 256):
        got = _kernel_model(row_ptr, col, centers, K, 11, 2)
        ref = _plain(row_ptr, col, centers, K, 11, 2)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f"K={K} {f}")
        assert all(len(set(got["positions"][b])) == K for b in range(4))


def test_sampler_does_not_fall_back_off_the_cpu():
    row_ptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    col = torch.zeros(4, dtype=torch.int32)
    c = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(CudaError):
        csr_sample_neighbors(row_ptr.to("meta"), col.to("meta"), c.to("meta"), 2)
    with pytest.raises(CudaError):
        csr_sample_neighbors(row_ptr, col, c.to("meta"), 2)  # a CPU CSR with centres elsewhere


def test_sampler_takes_int64_row_ptr():
    """An int64 row_ptr samples as its int32 copy does; offsets of 2^31 or
    more are refused (the card's kernel takes int32 offsets)."""
    row_ptr, col, centers = _graph(10, 3)
    got = csr_sample_neighbors(torch.from_numpy(row_ptr).long(), torch.from_numpy(col),
                               torch.from_numpy(centers), 10, seed=3, hop=1)
    ref = _plain(row_ptr, col, centers, 10, 3, 1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)
    with pytest.raises(InvalidInput):
        csr_sample_neighbors(torch.tensor([0, 2**31], dtype=torch.int64), torch.from_numpy(col),
                             torch.zeros(1, dtype=torch.int32), 2)


def test_sampler_empty_inputs():
    row_ptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    col = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    none = csr_sample_neighbors(row_ptr, col, torch.zeros(0, dtype=torch.int32), 3)
    assert none.neighbors.shape == (0, 3) and none.degree.shape == (0,)
    zero_k = csr_sample_neighbors(row_ptr, col, torch.tensor([1, 0], dtype=torch.int32), 0)
    assert zero_k.positions.shape == (2, 0) and zero_k.degree.tolist() == [2, 2]


# ---------------------------------------------------------------------------
# kernel I: tiles that take the window and tiles that read directly
# ---------------------------------------------------------------------------


def tile_mix_slots(n, tile, window, rs):
    """Slots of 8 tiles of ``tile`` ids over an n-row table: consecutive ids
    and duplicates (a window serves them with fewer bytes than direct
    reads), ids further apart than the window (read directly), one shuffled
    dense tile, one tile with ids outside [0, n), and a partial last tile."""
    span = window + 1
    dense = rs.randint(0, n - tile) + np.arange(tile)
    sparse = (rs.randint(0, n - span * tile) + span * np.arange(tile)) % n
    dup = np.repeat(rs.randint(0, n, max(tile // 8, 1)), 8)[:tile]
    dup = np.concatenate([dup, np.full(tile - dup.size, dup[-1])])
    shuffled = rs.permutation(dense)
    oob = dense.copy()
    oob[:: max(tile // 4, 1)] = rs.choice([-1, -(2**31), n, n + 3], oob[:: max(tile // 4, 1)].size)
    parts = [dense, sparse, dup, shuffled, sparse[::-1], oob, dense[: tile // 2 + 1]]
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("D,dtype", [(3, np.float32), (5, np.float32), (256, np.float32),
                                     (6, "bfloat16")])
def test_sorted_gather_tile_mix_matches_jax(D, dtype):
    import ml_dtypes

    rs = np.random.RandomState(D)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tile, window = G.sorted_plan(D * tdt.itemsize, density=0.8)
    n = (window + 1) * tile + 1000  # room for a tile of ids a window apart
    arr = rs.randn(n, D).astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    t = torch.from_numpy(arr.astype(np.float32)).to(tdt)
    slots = tile_mix_slots(n, tile, window, rs)
    jout = np.asarray(jgp.local_take_sorted(jnp.asarray(arr), jnp.asarray(slots), density=0.8))
    got = tg.local_take_sorted(t, torch.from_numpy(slots), density=0.8)
    np.testing.assert_array_equal(got.float().numpy(), jout.astype(np.float32))
    zero = G.gather_rows_sorted(t, torch.from_numpy(slots), density=0.8, zero_invalid=True)
    bad = (slots < 0) | (slots >= n)
    np.testing.assert_array_equal(zero[torch.from_numpy(~bad)].float().numpy(),
                                  jout[~bad].astype(np.float32))
    assert bad.any() and not zero[torch.from_numpy(bad)].any()


def test_sorted_gather_stats_are_inert_on_the_cpu():
    """``_stats`` is the kernel's own count; the plain path leaves it be."""
    t = torch.randn(100, 4)
    stats = torch.full((3,), 7, dtype=torch.int64)
    out = G.gather_rows_sorted(t, torch.arange(10, dtype=torch.int32), _stats=stats)
    assert torch.equal(out, t[:10]) and stats.tolist() == [7, 7, 7]
