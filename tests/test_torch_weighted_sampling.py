"""Port parity: weighted (A-Res) CSR sampling of wholegraph_tpu_torch against
the JAX package's ``csr_sample_neighbors(weights=...)`` and its numpy replay
``wholegraph_tpu.testing.host_sample_weighted``, under the equality rule of
``ops.sampling.weighted_near_ties``; the pair table against JAX's
``interleave_col_weights``; a model of kernel K's two selection modes
against the plain version; the edge cases of degree, fanout, keys and ids.

Equality rule: the keys ``log(max(u, 1e-20)) / w`` of two implementations of
``log`` can differ by a few ulps, so a centre with two keys within 4 ulps
near its cut (a near tie) is counted, and every other centre must match
bit for bit. On these fixed seeds both counts are 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.ops.sampling import csr_sample_neighbors as jax_sample
from wholegraph_tpu.ops.sampling import interleave_col_weights as jax_interleave
from wholegraph_tpu.testing import host_sample_weighted, random_csr
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.ops import sampling as SM

torch.set_num_threads(1)

FIELDS = ("neighbors", "mask", "positions", "edge_ids", "degree")
HUB = 1 << 17  # a hub's edges


def _t(a):
    return torch.from_numpy(np.array(a))


def _sample(row_ptr, col, w, centers, K, seed, hop, pairs=None, max_degree=1 << 16):
    return SM.csr_sample_neighbors(_t(row_ptr), _t(col), _t(np.asarray(centers, np.int32)), K,
                                   seed=seed, hop=hop, weights=_t(w), max_degree=max_degree,
                                   cw_blocks=pairs)


def _rule(row_ptr, col, w, centers, K, seed, hop, got, ref, what):
    """Hold ``got`` (a dict of field -> array) to ``ref`` by the equality
    rule, with the near ties of the port's plain version; returns and
    prints (near-tie centres, near-tie centres that differ)."""
    near, inside = SM.weighted_near_ties(_t(row_ptr), _t(col), _t(w),
                                         _t(np.asarray(centers, np.int32)), K, seed, hop)
    n_near, n_differ, n_bad = SM.weighted_rule({f: _t(v) for f, v in got.items()},
                                               {f: _t(v) for f, v in ref.items()}, near, inside)
    print(f"{what}: near-tie centres {n_near}, of them differing {n_differ}")
    assert n_bad == 0, f"{what}: {n_bad} centres break the equality rule"
    return n_near, n_differ


def _fields(res):
    return {f: getattr(res, f).numpy() for f in FIELDS}


def _jax_fields(res):
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def test_weighted_parity_vs_jax_and_host():
    """tests/test_sampling.py:75-95, held to every field of the JAX sample
    and to the host replay's."""
    row_ptr, col = random_csr(150, avg_deg=20, seed=4, max_deg=600)
    w = (np.random.RandomState(5).rand(row_ptr[-1]) + 0.1).astype(np.float32)
    centers = np.random.RandomState(6).randint(0, 150, 32)
    K = 8
    got = _fields(_sample(row_ptr, col, w, centers, K, 11, 2, max_degree=600))
    j = jax_sample(jnp.asarray(row_ptr), jnp.asarray(col), jnp.asarray(centers), K, seed=11,
                   hop=2, weights=jnp.asarray(w), max_degree=600)
    assert _rule(row_ptr, col, w, centers, K, 11, 2, got, _jax_fields(j), "vs JAX") == (0, 0)
    h_nbrs, h_mask, h_pos = host_sample_weighted(row_ptr, col, w, centers, K, seed=11, hop=2)
    host = {"neighbors": h_nbrs, "mask": h_mask, "positions": h_pos}
    assert _rule(row_ptr, col, w, centers, K, 11, 2, got, host, "vs host") == (0, 0)


def test_weighted_degree_ladder_bit_equal():
    """tests/test_sampling.py:97: the declared max_degree changes nothing
    (the port has no ladder; JAX's runs a level of its own for each)."""
    row_ptr, col = random_csr(200, avg_deg=12, seed=9, max_deg=100)
    w = (np.random.RandomState(10).rand(row_ptr[-1]) + 0.05).astype(np.float32)
    centers = np.random.RandomState(11).randint(0, 200, 64)
    K = 6
    outs = [_fields(_sample(row_ptr, col, w, centers, K, 13, 1, max_degree=md))
            for md in (100, 4096, 65536)]
    for o in outs[1:]:
        for f in FIELDS:
            np.testing.assert_array_equal(o[f], outs[0][f], err_msg=f)
    for md in (100, 4096):
        j = jax_sample(jnp.asarray(row_ptr), jnp.asarray(col), jnp.asarray(centers), K, seed=13,
                       hop=1, weights=jnp.asarray(w), max_degree=md)
        assert _rule(row_ptr, col, w, centers, K, 13, 1, outs[0], _jax_fields(j),
                     f"vs JAX, max_degree {md}") == (0, 0)


def test_weighted_bias():
    """tests/test_sampling.py:154: heavier edges are sampled more often."""
    row_ptr = np.array([0, 10], np.int32)
    col = np.arange(10, dtype=np.int32)
    w = np.array([10.0] * 2 + [0.1] * 8, np.float32)
    hits = np.zeros(10)
    for seed in range(100):
        res = _sample(row_ptr, col, w, np.zeros(8, np.int32), 3, seed, 0, max_degree=16)
        hits[res.neighbors[0][res.mask[0]].numpy()] += 1
    assert hits[:2].mean() > 4 * hits[2:].mean(), hits


def test_interleave_col_weights_matches_jax_blocks():
    """The port's [E, 2] pair table holds, element by element, what JAX's
    [ceil(E/128), 256] blocks hold: 128 columns, then 128 weight bits."""
    rs = np.random.RandomState(3)
    for E in (1, 127, 128, 1000):
        col = rs.randint(0, 50, E).astype(np.int32)
        w = (rs.rand(E) - 0.2).astype(np.float32)
        w[::7] = np.nan
        pairs = SM.interleave_col_weights(_t(col), _t(w)).numpy()
        blocks = np.asarray(jax_interleave(jnp.asarray(col), jnp.asarray(w))).reshape(-1, 2, 128)
        assert pairs.shape == (E, 2) and pairs.dtype == np.int32
        np.testing.assert_array_equal(pairs[:, 0], blocks[:, 0, :].reshape(-1)[:E])
        np.testing.assert_array_equal(pairs[:, 1], blocks[:, 1, :].reshape(-1)[:E])
        np.testing.assert_array_equal(pairs[:, 1], w.view(np.int32))


@pytest.mark.parametrize("tag,lo,hi,nheavy", [("1blk", 4, 9, 0), ("2blk", 16, 49, 0),
                                              ("ladder", 16, 49, 20)])
def test_pair_table_route_bit_equal(tag, lo, hi, nheavy):
    """tests/test_sampling.py:342: the pair-table route gives the bits of
    the separate arrays, in JAX's three regimes, and matches JAX's fused
    path."""
    rs = np.random.RandomState(41)
    n, K, B = 4000, 6, 1024
    deg = rs.randint(lo, hi, n).astype(np.int32)
    if nheavy:
        deg[rs.choice(n, nheavy, replace=False)] = rs.randint(600, 1500, nheavy)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(row_ptr[-1])
    col = rs.randint(0, n, E).astype(np.int32)
    w = (rs.rand(E) + 0.05).astype(np.float32)
    centers = rs.randint(0, n, B).astype(np.int32)
    ref = _fields(_sample(row_ptr, col, w, centers, K, 9, 1, max_degree=2048))
    pairs = SM.interleave_col_weights(_t(col), _t(w))
    got = _fields(_sample(row_ptr, col, w, centers, K, 9, 1, pairs=pairs, max_degree=2048))
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f"{tag}: {f}")
    j = jax_sample(jnp.asarray(row_ptr), jnp.asarray(col), jnp.asarray(centers), K, seed=9,
                   hop=1, weights=jnp.asarray(w), max_degree=2048,
                   cw_blocks=jax_interleave(jnp.asarray(col), jnp.asarray(w)))
    assert _rule(row_ptr, col, w, centers, K, 9, 1, got, _jax_fields(j), f"{tag} vs JAX") == (0, 0)


def test_multilayer_weighted_fastpath_matches_jax():
    """tests/test_sampling.py:389: with_weighted_fastpath plumbs the pair
    table through multilayer_sample with the same sample, which is JAX's."""
    rs = np.random.RandomState(5)
    n, E = 600, 9000
    src, dst = rs.randint(0, n, E), rs.randint(0, n, E)
    w = rs.rand(E).astype(np.float32) + 0.1
    centers = rs.randint(0, n, 64).astype(np.int32)
    g = GraphStructure.from_coo(src, dst, n, edge_weight=w, device="cpu")
    gf = g.with_weighted_fastpath()
    assert gf.cw_blocks.shape == (E, 2) and g.cw_blocks is None
    jm = JaxGraph.from_coo(src, dst, n, edge_weight=w).multilayer_sample(
        jnp.asarray(centers), [4, 3], seed=3, weighted=True)
    a = g.multilayer_sample(_t(centers), [4, 3], seed=3, weighted=True)
    b = gf.multilayer_sample(_t(centers), [4, 3], seed=3, weighted=True)
    for l, gids in enumerate(a.level_gids[:-1]):
        near, _ = SM.weighted_near_ties(g.row_ptr, g.col, g.edge_weight, gids.clamp(max=n - 1),
                                        [4, 3][l], 3, l)
        print(f"hop {l}: near-tie centres {int(near.sum())}")
        assert not near.any()
    for m in (b, jm):
        np.testing.assert_array_equal(np.asarray(m.unique_gids), a.unique_gids.numpy())
        np.testing.assert_array_equal(np.asarray(m.unique_mask), a.unique_mask.numpy())
        for ha, hm in zip(a.hops, m.hops):
            np.testing.assert_array_equal(np.asarray(hm.nbr_idx), ha.nbr_idx.numpy())
            np.testing.assert_array_equal(np.asarray(hm.mask), ha.mask.numpy())
    # weights follow their edges through the sort and add_reverse
    gr = GraphStructure.from_coo(src, dst, n, edge_weight=w, add_reverse=True, device="cpu")
    jr = JaxGraph.from_coo(src, dst, n, edge_weight=w, add_reverse=True)
    np.testing.assert_array_equal(gr.edge_weight.numpy(), np.asarray(jr.edge_weight))
    np.testing.assert_array_equal(gr.col.numpy(), np.asarray(jr.col))


def _edge_case_graph(K, seed):
    """Rows of degree 0, 1, K, K + 1 and a hub of 2^17 edges, then random
    rows; weights positive, with 0, negative, NaN and +inf ones mixed in
    (keys of -inf inside a row, and exact ties of -0.0)."""
    rs = np.random.RandomState(seed)
    n = 300
    deg = rs.randint(0, 2 * K + 6, n)
    deg[:5] = [0, 1, K, K + 1, HUB]
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(row_ptr[-1])
    col = rs.randint(0, n, E).astype(np.int32)
    w = (rs.rand(E) + 0.01).astype(np.float32)
    pick = rs.rand(E)
    w[pick < 0.05] = 0.0
    w[(pick >= 0.05) & (pick < 0.08)] = -1.0
    w[(pick >= 0.08) & (pick < 0.1)] = np.nan
    w[(pick >= 0.1) & (pick < 0.12)] = np.inf
    centers = np.concatenate([np.arange(n), [4, 4, 3, -1, -7, n, n + 9, -(2**31), 2**31 - 1]])
    return row_ptr, col, w, centers.astype(np.int32)


@pytest.mark.parametrize("K", [0, 1, 15, 200])
def test_weighted_edge_cases_vs_host(K):
    """Degrees 0, 1, K, K + 1 and a hub; fanouts 0, 1, 15 and 200; -inf keys
    inside rows (weights 0, negative, NaN) never taken, so the mask has holes
    only at a row's end; centres outside [0, n) of either sign sample
    nothing; the two routes give the same bits."""
    row_ptr, col, w, centers = _edge_case_graph(K, seed=K + 1)
    res = _sample(row_ptr, col, w, centers, K, 21, 3)
    got = _fields(res)
    pairs = SM.interleave_col_weights(_t(col), _t(w))
    for f, v in _fields(_sample(row_ptr, col, w, centers, K, 21, 3, pairs=pairs)).items():
        np.testing.assert_array_equal(v, got[f], err_msg=f)
    inside = (centers >= 0) & (centers < len(row_ptr) - 1)
    h_nbrs, h_mask, h_pos = host_sample_weighted(row_ptr, col, w, centers[inside], K, seed=21,
                                                 hop=3)
    host = {"neighbors": h_nbrs, "mask": h_mask, "positions": h_pos}
    mine = {f: got[f][inside] for f in host}
    # the +inf weights key -0.0: exact ties, near ties by the rule, broken by
    # position on both sides, so none of them differs
    near, differ = _rule(row_ptr, col, w, centers[inside], K, 21, 3, mine, host, f"K={K} vs host")
    assert differ == 0
    mask = got["mask"]
    assert mask.shape == (len(centers), K)
    # holes only at a row's end; masked slots: position 0, neighbour -1, edge start
    assert (np.diff(mask.astype(np.int8), axis=1) <= 0).all()
    assert (got["positions"][~mask] == 0).all() and (got["neighbors"][~mask] == -1).all()
    start = row_ptr[np.clip(centers, 0, len(row_ptr) - 1)]
    np.testing.assert_array_equal(got["edge_ids"], start[:, None] + got["positions"])
    # every taken edge has a key above -inf: a positive weight
    taken_w = w[(start[:, None] + got["positions"])[mask]]
    assert (taken_w > 0).all()
    # the hub: min(deg, K) slots unless -inf keys cut it short; out-of-range centres: nothing
    deg = got["degree"]
    assert deg[4] == HUB and mask[4].sum() == K
    assert (deg[-6:] == 0).all() and not mask[-6:].any()
    assert (deg[-1:] == 0).all()


def test_weighted_u_zero_gives_a_finite_key():
    """u = 0 keys log(1e-20) / w, not -inf: the edge is still taken."""
    seed, c, hop, off = 9782848, 3, 1, 1  # rand_u32(seed, 3, 2^20 + 1) < 256
    assert int(SM.rng.rand_u32(seed, c, hop * SM.HOP_STRIDE + off)) >> 8 == 0
    row_ptr = np.array([0, 0, 0, 0, 3], np.int32)
    col = np.array([7, 8, 9], np.int32)
    w = np.ones(3, np.float32)
    res = _sample(row_ptr, col, w, [c], 3, seed, hop)
    assert res.mask.all() and res.positions[0, 2] == off  # the lowest key, last
    h_nbrs, h_mask, h_pos = host_sample_weighted(row_ptr, col, w, [c], 3, seed=seed, hop=hop)
    np.testing.assert_array_equal(res.positions.numpy(), h_pos)


def test_weighted_tiny_weight_follows_the_device_path_r8():
    """Quirk R8: ``host_sample_weighted`` divides by max(w, 1e-30), the JAX
    device path by w. The port divides by w, as the JAX device path does:
    pinned here on a row where the two orders differ."""
    row_ptr = np.array([0, 2], np.int32)
    col = np.array([5, 6], np.int32)
    w = np.array([1e-35, 1e-33], np.float32)
    for seed in range(200):
        u = SM.rng.rand_uniform(seed, 0, torch.arange(2)).numpy()
        if u[0] > u[1] > 0:  # the host's clamp makes both 1e-30: u decides
            break
    res = _sample(row_ptr, col, w, [0], 1, seed, 0, max_degree=2)
    j = jax_sample(jnp.asarray(row_ptr), jnp.asarray(col), jnp.zeros(1, jnp.int32), 1,
                   seed=seed, weights=jnp.asarray(w), max_degree=2)
    _, _, h_pos = host_sample_weighted(row_ptr, col, w, [0], 1, seed=seed)
    assert int(res.positions[0, 0]) == int(np.asarray(j.positions)[0, 0]) == 1
    assert h_pos[0, 0] == 0


def test_near_tie_rule_on_exact_ties():
    """Edges of weight +inf all key -0.0: exact ties, near ties by the rule,
    "inside" when the tie lies within the first min(deg, K) keys; the tie
    order is the position order."""
    row_ptr = np.array([0, 3, 6], np.int32)
    col = np.arange(6, dtype=np.int32)
    w = np.array([np.inf, 1.0, np.inf, 1.0, 1.0, 1.0], np.float32)
    near, inside = SM.weighted_near_ties(_t(row_ptr), _t(col), _t(w), _t(np.array([0, 1], np.int32)),
                                         2, 0, 0)
    assert near.tolist()[0] and inside.tolist()[0]
    near, inside = SM.weighted_near_ties(_t(row_ptr), _t(col), _t(w), _t(np.array([0], np.int32)),
                                         1, 0, 0)
    assert near.tolist() == [True] and inside.tolist() == [False]
    res = _sample(row_ptr, col, w, [0], 2, 0, 0)
    assert res.positions[0].tolist() == [0, 2]
    # the rule: a near tie inside the cut may swap slots, a centre without
    # one may not differ at all
    got = _sample(row_ptr, col, w, [0, 1], 2, 0, 0)
    near, inside = SM.weighted_near_ties(_t(row_ptr), _t(col), _t(w),
                                         _t(np.array([0, 1], np.int32)), 2, 0, 0)
    swapped = {f: getattr(got, f).clone() for f in FIELDS}
    swapped["positions"][0] = swapped["positions"][0].flip(0)
    assert SM.weighted_rule(swapped, _fields_t(got), near, inside) == (1, 1, 0)
    swapped["positions"][1, 0] += 1
    assert SM.weighted_rule(swapped, _fields_t(got), near, inside)[2] == 1


def _fields_t(res):
    return {f: getattr(res, f) for f in FIELDS}


STAGE = 8  # the model's stage: small, so a few dozen edges take the list mode
def _order_values(k):
    """The register path's 64-bit values ``(bits(key) & 0x7fffffff) << 32 |
    position`` of a row's keys, as Python ints."""
    bits = np.asarray(k, np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    return [(int(b) << 32) | e for e, b in enumerate(bits)]


def _lane_step(v, partner, lower):
    """One step of the kernel's network inside a register (``lane_step``):
    every lane takes its partner's value where the pair's lower lane keeps
    the smaller."""
    for r in range(len(v)):
        p = v[r][partner]
        v[r] = np.where((p < v[r]) == lower, p, v[r])


def _reg_step(v, rows, m):
    """``reg_step``: registers r and r ^ m of one lane, the lower register
    keeping the smaller value."""
    for r in range(rows):
        if r & m == 0:
            a, b = v[r].copy(), v[r | m].copy()
            v[r], v[r | m] = np.minimum(a, b), np.maximum(a, b)


def _mirror_step(v, rows, m, lanes):
    """``mirror_step``: a merge's first step across registers, element i =
    lane + lanes * r paired with its mirror, lane ^ (lanes - 1) of register
    r ^ m."""
    mirror = np.arange(lanes) ^ (lanes - 1)
    p = [v[r ^ m][mirror] for r in range(rows)]
    for r in range(rows):
        v[r] = np.where((p[r] < v[r]) == (r < (r ^ m)), p[r], v[r])


def _row_values(k, d, lanes, regs):
    """[regs, lanes]: element i = lane + lanes * r holds the 64-bit value of
    position i, 2^64 - 1 past the row."""
    v = np.full(lanes * regs, (1 << 64) - 1, np.uint64)
    v[:d] = _order_values(k)
    return v.reshape(regs, lanes)


def _warp_select_model(k, d, lanes, regs):
    """``warp_select`` of csrc/sample_weighted.cu for one row of ``d <= lanes
    * regs`` keys: each register of the row sorted ascending by itself, then
    merged one at a time into register 0 (the minimum with its mirror lane
    ^ (lanes - 1), then the half-cleaners). Returns register 0: the row's
    ``lanes`` smallest values in order."""
    v = _row_values(k, d, lanes, regs)
    rows = -(-d // lanes)
    lane = np.arange(lanes)
    k2 = 2
    while k2 <= lanes:
        _lane_step(v[:rows], lane ^ (k2 - 1), (lane & (k2 >> 1)) == 0)
        j = k2 >> 2
        while j > 0:
            _lane_step(v[:rows], lane ^ j, (lane & j) == 0)
            j >>= 1
        k2 <<= 1
    for r in range(1, rows):
        v[0] = np.minimum(v[0], v[r][lane ^ (lanes - 1)])
        j = lanes >> 1
        while j > 0:
            _lane_step(v[:1], lane ^ j, (lane & j) == 0)
            j >>= 1
    return v[0]


def _register_model(k, d, lanes, regs):
    """The register path of kernel K for one row of ``d <= lanes * regs``
    keys, as ``bitonic`` in csrc/sample_weighted.cu runs it for a warp of
    ``lanes`` lanes holding ``regs`` values each (the kernel: 32 and R):
    element i = lane + lanes * r holds the 64-bit value of position i (past
    the row 2^64 - 1); over the row's power-of-two width W every block is
    sorted ascending, a merge's first step pairing i with i ^ (k - 1): lane
    ^ (k - 1), or above ``lanes`` the mirror lane of register r ^ (k / lanes
    - 1); the half-cleaners pair lanes, or above ``lanes`` registers of one
    lane. Returns the values in order."""
    v = _row_values(k, d, lanes, regs)
    W = 1 << (0 if d <= 1 else (d - 1).bit_length())
    rows = W // lanes if W > lanes else 1
    lane = np.arange(lanes)
    k2 = 2
    while k2 <= W:
        if k2 <= lanes:
            _lane_step(v[:rows], lane ^ (k2 - 1), (lane & (k2 >> 1)) == 0)
        else:
            _mirror_step(v, rows, k2 // lanes - 1, lanes)
        j = k2 >> 2
        while j > 0:
            if j >= lanes:
                _reg_step(v, rows, j // lanes)
            else:
                _lane_step(v[:rows], lane ^ j, (lane & j) == 0)
            j >>= 1
        k2 <<= 1
    return v.reshape(-1)


def _kernel_model(keys, deg, K, stage=STAGE, lanes=32, tiers=()):
    """Kernel K's selection per centre, in Python: a row of d edges sorted
    in registers (:func:`_register_model`) by the first of ``tiers``
    (registers a lane; the kernel: R_SMALL and R_LARGE) with ``d <= lanes *
    regs``, in the last tier by WarpSelect's merge (:func:`_warp_select_model`)
    where it takes at most ``lanes`` slots; else a rank count over the staged keys up to ``stage`` edges
    (PR 8's design: no tiers, the stage to 256); else the running top-K
    list filled by chunks of 32 in position order. Returns (pos, valid)
    [B, K]."""
    B = len(deg)
    pos = np.zeros((B, K), np.int64)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        d = max(int(deg[b]), 0)
        k = keys[b][:d]
        regs = next((r for r in tiers if d <= lanes * r), 0)
        if regs:
            merge = regs == tiers[-1] and min(d, K) <= lanes
            v = (_warp_select_model if merge else _register_model)(k, d, lanes, regs)
            for j in range(min(d, K)):
                pos[b, j], valid[b, j] = v[j] & 0xFFFFFFFF, (v[j] >> 32) != 0x7F800000
            continue
        if d <= stage:
            for e in range(d):
                rank = sum(1 for f in range(d) if k[f] > k[e] or (k[f] == k[e] and f < e))
                if rank < K:
                    pos[b, rank], valid[b, rank] = e, k[e] > -np.inf
            continue
        lk, lp = [], []
        for base in range(0, d, 32):
            full = len(lk) == K
            thr = lk[K - 1] if full and K else -np.inf
            cand = [e for e in range(base, min(base + 32, d)) if not full or k[e] > thr]
            for e in cand:
                if len(lk) == K and not k[e] > lk[K - 1]:
                    continue
                m = sum(1 for x in lk if x >= k[e])
                lk.insert(m, k[e])
                lp.insert(m, e)
                del lk[K:], lp[K:]
        for j, (x, p) in enumerate(zip(lk, lp)):
            pos[b, j], valid[b, j] = p, x > -np.inf
    return np.where(valid, pos, 0), valid


# weights that key every way: +inf (-0.0, exact ties), 0, negative and NaN
# (-inf), denormal (-inf for most u, finite for u near 1), huge and tiny
SPECIAL_WEIGHTS = np.array([np.inf, 0.0, -1.0, np.nan, 1e-39, 3e38, 1e-30, 1.0], np.float32)
# the model's register paths: (lanes, tiers); a warp of 32 lanes holding 2
# or 8 values a lane as the kernel has it (registers to 64 and to 256 edges,
# the list above), and warps of 4 lanes: 2 or 8 (8 and 32 edges), 1 or 4 (4
# and 16), 4 or 8 (16 and 32)
REGISTER_MODELS = {"lanes32": (32, (2, 8)), "lanes4": (4, (2, 8)), "lanes4-r1-4": (4, (1, 4)),
                   "lanes4-r4-8": (4, (4, 8))}
REGISTER_DEGREES = [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 80, 81, 97,
                    127, 128, 129, 130, 255, 256, 257, 300]


def _close_keys(w, row_ptr, rows, seed, hop, rs):
    """Weights for ``rows`` whose keys all lie within a few ulps of one
    value, in random order of position: exact ties and neighbours that
    differ in the last bits of the 64-bit order values."""
    for c in rows:
        lo, hi = row_ptr[c], row_ptr[c + 1]
        u = SM.rng.rand_uniform(seed, c, hop * SM.HOP_STRIDE + torch.arange(hi - lo))
        target = -3.0 * (1.0 + 1e-7 * rs.randint(0, 4, hi - lo))
        w[lo:hi] = (torch.log(u.clamp(min=1e-20)) / torch.from_numpy(target).float()).numpy()


@pytest.mark.parametrize(
    "K,model", [(1, None), (3, None), (15, None), (40, None)]
    + [(K, m) for m in REGISTER_MODELS for K in (1, 3, 15, 40, 64)],
    ids=["1", "3", "15", "40"] + [f"{m}-{K}" for m in REGISTER_MODELS for K in (1, 3, 15, 40, 64)])
def test_kernel_model_matches_plain(K, model):
    """The selection that kernel K runs, in each of its modes, gives the
    plain version's positions and mask, with exact ties (+inf weights) and
    -inf keys in the rows. ``model`` None: the stage and the list mode
    (PR 8's design, the cases from before the register path); else the
    register tiers of REGISTER_MODELS and the list mode, at degrees either
    side of each mode's edge and of each sort width, with every weight of
    SPECIAL_WEIGHTS mixed in and rows of keys a few
    ulps apart."""
    rs = np.random.RandomState(K)
    if model is None:
        deg = rs.randint(0, 120, 60)
        deg[:4] = [0, STAGE, STAGE + 1, 97]
    else:
        deg = np.concatenate([REGISTER_DEGREES, rs.randint(0, 140, 40)])
    n = len(deg)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(row_ptr[-1])
    w = (rs.rand(E) + 0.1).astype(np.float32)
    w[rs.rand(E) < 0.1] = np.inf
    w[rs.rand(E) < 0.1] = 0.0
    if model is not None:
        pick = rs.rand(E) < 0.2
        w[pick] = SPECIAL_WEIGHTS[rs.randint(0, len(SPECIAL_WEIGHTS), int(pick.sum()))]
        _close_keys(w, row_ptr, [i for i, x in enumerate(REGISTER_DEGREES) if x >= 7], 5, 2, rs)
    centers = np.arange(n, dtype=np.int32)
    start, d = SM._centre_rows(_t(row_ptr), _t(centers))
    keys = SM._weighted_keys(start, d, _t(w), 5, _t(centers), 2, int(deg.max())).numpy()
    if model is None:
        pos, valid = _kernel_model(keys, deg, K)
    else:
        lanes, tiers = REGISTER_MODELS[model]
        pos, valid = _kernel_model(keys, deg, K, 0, lanes, tiers)
    res = _sample(row_ptr, np.zeros(E, np.int32), w, centers, K, 5, 2)
    np.testing.assert_array_equal(valid, res.mask.numpy())
    np.testing.assert_array_equal(pos, res.positions.numpy())


def test_register_order_is_the_plain_order():
    """The register path's invariant: every key of ``_weighted_keys``, -inf
    past a row included, has its sign bit set (so it lies in [-inf, -0.0]),
    over SPECIAL_WEIGHTS and random ones and with u = 0 among the draws; so
    the ascending order of ``(bits(key) & 0x7fffffff) << 32 | position`` is
    the plain version's stable sort by key descending."""
    seed, c, hop = 9782848, 3, 1  # rand_u32(seed, 3, 2^20 + 1) >> 8 == 0: u = 0 at offset 1
    assert int(SM.rng.rand_u32(seed, c, hop * SM.HOP_STRIDE + 1)) >> 8 == 0
    rs = np.random.RandomState(12)
    deg = np.array([0, 5, 40, 3 * len(SPECIAL_WEIGHTS), 64, 1, 70, 33])
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(row_ptr[-1])
    w = (rs.rand(E) + 0.1).astype(np.float32)
    pick = rs.rand(E) < 0.3
    w[pick] = SPECIAL_WEIGHTS[rs.randint(0, len(SPECIAL_WEIGHTS), int(pick.sum()))]
    lo3 = row_ptr[3]  # centre 3: each special weight three times
    w[lo3:lo3 + 3 * len(SPECIAL_WEIGHTS)] = np.repeat(SPECIAL_WEIGHTS, 3)
    centers = np.arange(len(deg), dtype=np.int32)
    start, d = SM._centre_rows(_t(row_ptr), _t(centers))
    width = int(deg.max())
    keys = SM._weighted_keys(start, d, _t(w), seed, _t(centers), hop, width)
    assert bool(torch.signbit(keys).all()), "a key without its sign bit"
    for x in SPECIAL_WEIGHTS:  # u = 0 (centre 3's offset 1) under every weight
        w1 = w.copy()
        w1[lo3 + 1] = x
        k3 = SM._weighted_keys(start[3:4], d[3:4], _t(w1), seed, _t(centers[3:4]), hop, width)
        assert bool(torch.signbit(k3).all()), f"u = 0, w = {x}: {float(k3[0, 1])}"
        if x == 1.0:  # u = 0 keys log(1e-20) / w, finite
            assert float(k3[0, 1]) == float(torch.log(torch.tensor(1e-20)))
    _, order = torch.sort(keys, dim=1, descending=True, stable=True)
    for b in range(len(deg)):
        vals = _order_values(keys[b].numpy())
        by_value = sorted(range(width), key=lambda e: vals[e])
        assert by_value == order[b].tolist(), f"centre {b}"


def test_weighted_errors_and_routes():
    """JAX's errors: ValueError without max_degree, NotImplementedError at
    2^31 edges; weights None samples uniformly whatever cw_blocks says."""
    row_ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    col = torch.tensor([1, 0, 0], dtype=torch.int32)
    w = torch.ones(3)
    c = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="max_degree"):
        SM.csr_sample_neighbors(row_ptr, col, c, 2, weights=w)
    with pytest.raises(NotImplementedError, match="2\\^31"):
        SM.csr_sample_neighbors(row_ptr, torch.empty(2**31, dtype=torch.int32, device="meta"),
                                c, 2, weights=w, max_degree=2)
    uni = SM.csr_sample_neighbors(row_ptr, col, c, 2, seed=3)
    also = SM.csr_sample_neighbors(row_ptr, col, c, 2, seed=3,
                                   cw_blocks=SM.interleave_col_weights(col, w))
    assert all(torch.equal(getattr(uni, f), getattr(also, f)) for f in FIELDS)
    with pytest.raises(Exception, match="CUDA tensors"):
        SM.sample_hop_weighted(row_ptr, col, w, c, 2, 0, 0)
