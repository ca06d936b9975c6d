"""Port parity: padded neighbourhood aggregation (kernel D's wrapper and
its autograd on the CPU, where it runs its plain version) against the JAX
package's padded_reduce / padded_softmax / padded_reduce_windowed, values
and gradients.

Tolerances: the port sums the K axis in f32 in another order than XLA, so
forward values agree to rtol/atol 1e-5 and gradients to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.ops import spmm as js
from wholegraph_tpu_torch.ops import spmm as ts
from wholegraph_tpu_torch.ops import spmm_kernels as tk
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _block(seed, U=30, B=12, K=7, D=16):
    rs = np.random.RandomState(seed)
    x = rs.randn(U, D).astype(np.float32)
    nbr = rs.randint(0, U, (B, K)).astype(np.int32)
    mask = rs.rand(B, K) < 0.7
    mask[0] = False  # a centre with no valid neighbour
    nbr[~mask] = 0
    ct = rs.randn(B, D).astype(np.float32)
    return x, nbr, mask, ct


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_padded_reduce_and_grad_match_jax(reduce):
    x, nbr, mask, ct = _block(0)
    jout, vjp = jax.vjp(lambda v: js.padded_reduce(v, jnp.asarray(nbr), jnp.asarray(mask), reduce),
                        jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    out = ts.padded_reduce(tx, torch.from_numpy(nbr), torch.from_numpy(mask), reduce)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    assert not out.detach()[0].any()  # no valid neighbour: 0 for every reduce


@pytest.mark.parametrize("mean", [False, True])
def test_neighbor_reduce_wrapper_is_plain_on_cpu(mean):
    x, nbr, mask, _ = _block(1)
    nbr[1, 0] = 99  # out of range: clipped, as the kernel clips
    mask[1, 0] = True
    args = (torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(mask))
    out = tk.neighbor_reduce(*args, mean)
    np.testing.assert_array_equal(out.numpy(), tk.neighbor_reduce_plain(*args, mean).numpy())
    m = mask.astype(np.float64)[..., None]
    ref = (x[np.clip(nbr, 0, len(x) - 1)].astype(np.float64) * m).sum(1)
    if mean:
        ref /= np.maximum(m.sum(1), 1)
    np.testing.assert_allclose(out.numpy(), ref, **FWD)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_grad_of_valid_ids_outside_range_follows_padded_reduce_r14(reduce):
    """Valid slots whose ids lie outside ``[0, U)`` (8 and -1 at U = 6) send
    their gradient to the clipped row, as JAX's ``padded_reduce`` does
    (``_fps_bwd`` would drop 8 and send -1 to row 5: quirk R14)."""
    rs = np.random.RandomState(7)
    x = rs.randn(6, 4).astype(np.float32)
    nbr = np.array([[0, 1, 2, 8], [-1, 1, 8, 0]], np.int32)
    mask = np.ones(nbr.shape, bool)
    ct = rs.randn(2, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda v: js.padded_reduce(v, jnp.asarray(nbr), jnp.asarray(mask), reduce),
                     jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    ts.padded_reduce(tx, torch.from_numpy(nbr), torch.from_numpy(mask), reduce).backward(
        torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    touched = (np.abs(tx.grad.numpy()).sum(1) > 0).astype(int)
    np.testing.assert_array_equal(touched, [1, 1, 1, 0, 0, 1])
    np.testing.assert_array_equal(touched, (np.abs(np.asarray(jdx)).sum(1) > 0).astype(int))


def test_neighbor_reduce_grad_ignores_non_finite_masked_cotangent():
    """A masked slot contributes nothing to dx, even against an inf row."""
    x, nbr, mask, ct = _block(2)
    ct[0] = np.inf  # centre 0 has no valid neighbour
    tx = torch.from_numpy(x).requires_grad_()
    tk.NeighborReduce.apply(tx, torch.from_numpy(nbr), torch.from_numpy(mask), True).backward(
        torch.from_numpy(ct))
    assert torch.isfinite(tx.grad).all()


def test_padded_gather_neighbors_and_softmax_match_jax():
    x, nbr, mask, _ = _block(3)
    np.testing.assert_array_equal(
        ts.padded_gather_neighbors(torch.from_numpy(x), torch.from_numpy(nbr)).numpy(),
        np.asarray(js.padded_gather_neighbors(jnp.asarray(x), jnp.asarray(nbr))))
    logits = np.random.RandomState(4).randn(*mask.shape).astype(np.float32)
    np.testing.assert_allclose(
        ts.padded_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).numpy(),
        np.asarray(js.padded_softmax(jnp.asarray(logits), jnp.asarray(mask))), **FWD)


def _windowed_block(seed, n=3000, B=64, fanouts=(5, 6), width=64):
    """A real two-hop sample over a locality-ordered CSR, as
    ``bench_spmm_sampled`` builds one (``bench.py:477-545``), small: the
    same sample in both packages, and the deepest hop's block."""
    from wholegraph_tpu.graph import GraphStructure as JaxGraph
    from wholegraph_tpu_torch.graph import GraphStructure

    rs = np.random.RandomState(seed)
    counts = rs.randint(4, 16, n)
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = (np.repeat(np.arange(n), counts)
           + rs.randint(-width // 2, width // 2 + 1, int(rp[-1]))).clip(0, n - 1).astype(np.int32)
    centers = np.sort(rs.choice(n, B, replace=False)).astype(np.int32)
    jg = JaxGraph(row_ptr=jnp.asarray(rp), col=jnp.asarray(col), node_count=n,
                  edge_count=int(rp[-1]), max_degree=int(counts.max()))
    tg = GraphStructure(torch.from_numpy(rp), torch.from_numpy(col), n)
    jm = jg.multilayer_sample(jnp.asarray(centers), list(fanouts), seed=1)
    tm = tg.multilayer_sample(torch.from_numpy(centers), list(fanouts), seed=1)
    return jm, tm


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("windows", [2048, 128])
def test_padded_reduce_windowed_and_grad_match_jax(reduce, windows):
    """``padded_reduce_windowed`` against the JAX one (its per-run
    ``spmm_window`` passes and edge residual, on the CPU) on a real sample's
    plan, forward and gradient; windows of 128 rows leave edges to the
    residual. Tolerance: f32 reassociation, 1e-5 relative to the largest
    output."""
    jm, tm = _windowed_block(0)
    L = 1
    rb = tm.run_bounds(L)
    assert rb == jm.run_bounds(L) and rb[-1] <= 4096  # JAX's CPU guard takes the windowed branch
    wins = tm.with_windowed_agg(windows).hops[L].windows
    assert wins == jm.with_windowed_agg(windows).hops[L].windows
    h = tm.hops[L]
    U = rb[-1]
    rs = np.random.RandomState(1)
    x = rs.randn(U, 128).astype(np.float32)
    ct = rs.randn(h.nbr_idx.shape[0], 128).astype(np.float32)
    jout, vjp = jax.vjp(lambda v: js.padded_reduce_windowed(
        v, jnp.asarray(h.nbr_idx.numpy()), jnp.asarray(h.mask.numpy()), reduce, run_bounds=rb,
        windows=wins), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    out = ts.padded_reduce_windowed(tx, h.nbr_idx, h.mask, reduce, run_bounds=rb, windows=wins)
    out.backward(torch.from_numpy(ct))
    for a, b in ((out.detach().numpy(), np.asarray(jout)), (tx.grad.numpy(), np.asarray(jdx))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    # the same function as the padded reduce: kernel D either way
    assert torch.equal(out.detach(), ts.padded_reduce(tx.detach(), h.nbr_idx, h.mask, reduce))


def test_padded_reduce_windowed_contract():
    """JAX's checks: sum or mean, run_bounds ascending from 0 to at most U,
    one window per run; D need not be a multiple of 128 (a TPU limit)."""
    x, nbr, mask, _ = _block(2, U=30, D=16)
    tx, tn, tm = torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(mask)
    out = ts.padded_reduce_windowed(tx, tn, tm, "mean", run_bounds=(0, 12, 30), windows=128)
    assert torch.equal(out, ts.padded_reduce(tx, tn, tm, "mean"))
    for kw in (dict(reduce="max"), dict(run_bounds=(1, 30)), dict(run_bounds=(0, 12, 12)),
               dict(run_bounds=(0, 31)), dict(windows=(128, 128, 128))):
        args = dict(reduce="sum", run_bounds=(0, 12, 30), windows=(128, 128))
        args.update(kw)
        reduce = args.pop("reduce")
        with pytest.raises(InvalidInput):
            ts.padded_reduce_windowed(tx, tn, tm, reduce, **args)


# kernel D's plan (ops.spmm_kernels.agg_plan): (lanes a centre, slices a row)
@pytest.mark.parametrize("K,row_bytes,vec_bytes,plan", [
    (15, 1024, 16, (32, 2)),   # the SAGE step's first layer: two 512-byte slices a row
    (10, 1024, 16, (32, 2)),   # its second
    (10, 64, 16, (16, 1)),     # GCN's last layer: 2 centres a warp, K's slots in one pass
    (16, 1024, 16, (32, 2)),   # bench_spmm
    (15, 512, 16, (32, 1)),    # a bf16 row of 256: one slice
    (15, 4096, 16, (32, 8)),
    (40, 64, 16, (32, 1)),     # K > 32: a warp a centre, passes of 32 slots
    (1, 4, 4, (1, 1)),         # one slot of 4 bytes: 32 centres a warp
    (3, 48, 16, (4, 1)),       # 3 vectors, 3 slots: 8 centres a warp
    (15, 28, 4, (16, 1)),      # D = 7 f32, 4-byte vectors
    (15, 2, 2, (16, 1)),       # D = 1 bf16
    (15, 1028, 4, (32, 9)),    # D = 257 f32: 257 vectors in 9 slices
])
def test_agg_plan_cases(K, row_bytes, vec_bytes, plan):
    assert tk.agg_plan(K, row_bytes, vec_bytes) == plan


@pytest.mark.parametrize("row_bytes", [2, 4, 8, 12, 28, 64, 100, 192, 256, 512, 1024, 1028, 2048,
                                       5000])
@pytest.mark.parametrize("K", [1, 10, 15, 32, 33, 64])
def test_agg_plan_covers_each_row_once(row_bytes, K):
    """Every plan is one the kernel takes (csrc/neighbor_agg.cu's entry): a
    power of two of lanes to 32, as many as the row's vectors or K's slots
    below 32, in one slice there, and slices that cover the row with none
    empty."""
    for vec in (16, 8, 4, 2):
        if row_bytes % vec:
            continue
        vpr = row_bytes // vec
        lanes, slices = tk.agg_plan(K, row_bytes, vec)
        assert lanes in (1, 2, 4, 8, 16, 32)
        if lanes < 32:
            assert slices == 1 and lanes >= vpr and lanes >= min(K, 32)
        assert (slices - 1) * lanes < vpr <= slices * lanes


def _agg_kernel_model(x, nbr, mask, mean, plan):
    """A Python model of kernel D's warp walk (csrc/neighbor_agg.cu) in f32:
    groups of ``lanes`` lanes over a warp's centres, slots loaded in passes
    of ``lanes``, the pass's valid slots taken lowest lane first from its
    ballot (in batches of a few neighbours, which keep that order), lane t
    of a group on vector ``slice * lanes + t``."""
    lanes, slices = plan
    B, K = nbr.shape
    vpr = x.shape[1]
    out = np.full((B, vpr), np.nan, np.float32)
    n_warps = -(-B // (32 // lanes)) * slices
    for w in range(n_warps):
        first, slc = (w // slices) * (32 // lanes), w % slices
        for g in range(32 // lanes):
            b = first + g
            if b >= B:
                continue
            cols = [c for c in range(slc * lanes, (slc + 1) * lanes) if c < vpr]
            acc = np.zeros(len(cols), np.float32)
            count = 0
            for k0 in range(0, K, lanes):
                ballot = [k for k in range(k0, min(k0 + lanes, K)) if mask[b, k]]
                count += len(ballot)
                for k in ballot:
                    acc = acc + x[min(max(nbr[b, k], 0), len(x) - 1), cols]
            if mean:
                acc = acc / np.float32(max(count, 1))
            assert np.isnan(out[b, cols]).all()  # no column written twice
            out[b, cols] = acc
    return out


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("D,K,B", [(4, 10, 37), (7, 3, 70), (16, 33, 9), (64, 15, 50),
                                   (100, 40, 5)])
def test_agg_kernel_model_is_the_ascending_sum(mean, D, K, B):
    """Under the plan the wrapper picks, and under every other the kernel
    takes, the model of the kernel's walk writes each output once and adds
    in ascending k: bit-equal to an f32 loop over k, and within K f32 ulps
    of the plain version."""
    rs = np.random.RandomState(D * K)
    U = 60
    x = rs.randn(U, D).astype(np.float32)
    nbr = rs.randint(-3, U + 3, (B, K)).astype(np.int32)  # some out of range: clipped
    mask = rs.rand(B, K) < 0.7
    mask[0] = False
    seq = np.zeros((B, D), np.float32)
    for k in range(K):
        seq = seq + np.where(mask[:, k:k + 1], x[np.clip(nbr[:, k], 0, U - 1)], np.float32(0))
    if mean:
        seq = seq / np.maximum(mask.sum(1, keepdims=True), 1).astype(np.float32)
    plans = {tk.agg_plan(K, D * 4, 4)}
    plans |= {(lanes, -(-D // lanes)) for lanes in (1, 2, 4, 8, 16, 32)}
    for plan in plans:
        np.testing.assert_array_equal(_agg_kernel_model(x, nbr, mask, mean, plan), seq, str(plan))
    ref = tk.neighbor_reduce_plain(torch.from_numpy(x), torch.from_numpy(nbr),
                                   torch.from_numpy(mask), mean).numpy()
    assert np.abs(seq - ref).max() <= K * np.finfo(np.float32).eps * max(1.0, np.abs(ref).max())
