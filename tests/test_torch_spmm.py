"""Port parity: padded neighbourhood aggregation (kernel D's wrapper and
its autograd on the CPU, where it runs its plain version) against the JAX
package's padded_reduce / padded_softmax, values and gradients.

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
