"""Port parity: the sampled SAGE HomoGNN of wholegraph_tpu_torch, loaded from
the JAX package's flax parameters through params_from_jax, gives the same
logits, loss and gradients (w.r.t. the input rows and every weight).

Tolerances: f32 forward rtol/atol 1e-5 (another summation order in the
aggregation and matmuls), gradients 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.graph import GraphStructure as JaxGraph
from wholegraph_tpu.models import HomoGNN as JaxGNN
from wholegraph_tpu.models import accuracy as jax_accuracy
from wholegraph_tpu.models import cross_entropy_loss as jax_ce
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN, accuracy, cross_entropy_loss, params_from_jax
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
N, D, H, C = 150, 24, 16, 5


def _sampled(seed=0, fanouts=(3, 4), B=16):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, N, N * 5), rs.randint(0, N, N * 5)
    centers = rs.choice(N, B, replace=False).astype(np.int32)
    jm = JaxGraph.from_coo(src, dst, N).multilayer_sample(jnp.asarray(centers), fanouts, seed=1)
    tm = GraphStructure.from_coo(src, dst, N, device="cpu").multilayer_sample(
        torch.from_numpy(centers), fanouts, seed=1)
    U = tm.unique_gids.shape[0]
    x = rs.randn(U, D).astype(np.float32) * tm.unique_mask.numpy()[:, None]
    labels = rs.randint(0, C, B).astype(np.int32)
    return jm, tm, x, labels


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_sage_logits_and_grads_match_jax(aggregator):
    jm, tm, x, labels = _sampled()
    jmodel = JaxGNN(model_type="sage", hidden_dim=H, num_classes=C, num_layers=2,
                    aggregator=aggregator)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), sample=jm)

    def jloss(p, r):
        return jax_ce(jmodel.apply(p, r, sample=jm), jnp.asarray(labels))

    jlogits = jmodel.apply(params, jnp.asarray(x), sample=jm)
    jl, (jdp, jdx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    model = HomoGNN(D, H, C, num_layers=2, aggregator=aggregator, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tx = torch.from_numpy(x).requires_grad_()
    logits = model(tx, tm)
    loss = cross_entropy_loss(logits, torch.from_numpy(labels))
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD)
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jdp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD)


def test_params_from_jax_layout():
    tree = {"params": {"SAGEConv_0": {"proj": {"kernel": np.ones((6, 3), np.float32),
                                               "bias": np.zeros(3, np.float32)}},
                       "SAGEConv_1": {"proj": {"kernel": np.arange(8, dtype=np.float32)
                                               .reshape(4, 2)}}}}
    sd = params_from_jax(tree)
    assert sd["convs.0.proj.weight"].shape == (3, 6)     # flax [in, out] -> [out, in]
    assert torch.equal(sd["convs.1.proj.weight"], torch.arange(8.0).reshape(4, 2).T)
    assert "convs.1.proj.bias" not in sd
    with pytest.raises(InvalidInput):
        params_from_jax({"GATConv_0": {}})


def test_loss_and_accuracy_with_mask_match_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(20, C).astype(np.float32)
    labels = rs.randint(0, C, 20).astype(np.int32)
    mask = rs.rand(20) < 0.6
    for m in (None, mask):
        jmk = None if m is None else jnp.asarray(m)
        tmk = None if m is None else torch.from_numpy(m)
        np.testing.assert_allclose(
            float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), tmk)),
            float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), jmk)), **FWD)
        np.testing.assert_allclose(
            float(accuracy(torch.from_numpy(logits), torch.from_numpy(labels), tmk)),
            float(jax_accuracy(jnp.asarray(logits), jnp.asarray(labels), jmk)), **FWD)


def test_dropout_draws_from_the_given_generator():
    _, tm, x, _ = _sampled(seed=3)
    model = HomoGNN(D, H, C, num_layers=2, dropout=0.5, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    tx = torch.from_numpy(x)
    with pytest.raises(InvalidInput):
        model(tx, tm, train=True)
    a = model(tx, tm, train=True, generator=torch.Generator().manual_seed(5))
    b = model(tx, tm, train=True, generator=torch.Generator().manual_seed(5))
    c = model(tx, tm, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(tx, tm), model(tx, tm))  # eval: no dropout
