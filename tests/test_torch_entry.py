"""Port parity: ``wholegraph_tpu_torch.entry`` against ``__graft_entry__``:
the same tiny graph, sample and features from the same numpy draws, and,
with the JAX parameters converted by ``params_from_jax``, the same logits of
the sampled 2-layer GraphSAGE forward. Tolerance: f32 reassociation in the
aggregation and the matmuls, 1e-5 relative to the largest logit."""

import jax
import numpy as np
import torch

import __graft_entry__ as jax_entry
from wholegraph_tpu_torch import entry as port_entry
from wholegraph_tpu_torch.models import params_from_jax
from wholegraph_tpu_torch.utils.error import CudaError

torch.set_num_threads(1)


def test_entry_forward_matches_jax():
    jfn, (jparams, jx, jml) = jax_entry.entry()
    fn, (params, x, ml) = port_entry.entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ml.unique_gids.numpy(), np.asarray(jml.unique_gids))
    for th, jh in zip(ml.hops, jml.hops):
        np.testing.assert_array_equal(th.nbr_idx.numpy(), np.asarray(jh.nbr_idx))
        np.testing.assert_array_equal(th.mask.numpy(), np.asarray(jh.mask))
    converted = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert sorted(converted) == sorted(params)
    ref = np.asarray(jfn(jparams, jx, jml))
    out = fn(converted, x, ml).detach().numpy()
    assert out.shape == ref.shape == (32, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # the example args' own weights run too, and the forward is differentiable in them
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    fn(p, x, ml).sum().backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in p.values())


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        port_entry.entry()
    except CudaError as e:
        assert "CUDA is not available" in str(e)
    else:
        raise AssertionError("entry() ran without a card and without device='cpu'")
