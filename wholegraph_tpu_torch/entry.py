"""Entry point for a compile-and-run check: the port's counterpart of
``__graft_entry__.py:6-34``.

:func:`entry` returns ``(fn, example_args)``: the forward of the flagship
model, a sampled 2-layer GraphSAGE, as a function of its parameters (a
``{name: tensor}`` dict, ``torch.func.functional_call``), the gathered
features and the :class:`~.graph.MultilayerSample`, with its arguments on a
tiny random graph. It mirrors the JAX ``entry()``'s ``fwd(params, x, ml)``,
so parameters converted with ``models.params_from_jax`` give the JAX
forward's logits. The multichip dry run waits for the exchange
(``ROADMAP.md`` queue 1 item 13).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from .graph import GraphStructure
from .models import HomoGNN
from .utils.device import DeviceLike, resolve_device


def _build_tiny(seed: int = 0, n: int = 256, dim: int = 16, num_classes: int = 4,
                device: DeviceLike = "cuda"):
    """The JAX entry's tiny problem from the same numpy draws: a random
    graph of ``n`` nodes and ``8 n`` edges, normal features, 32 centres
    sampled (4, 3) with seed 1, and a SAGE model of hidden width 32 with
    weights from ``seed``. Returns ``(model, x, ml)``; padded unique slots
    give zero rows of ``x``."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    src = rs.randint(0, n, n * 8)
    dst = rs.randint(0, n, n * 8)
    g = GraphStructure.from_coo(src, dst, n, device=dev)
    feats = torch.from_numpy(rs.randn(n, dim).astype(np.float32)).to(dev)
    model = HomoGNN(dim, 32, num_classes, num_layers=2, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    ml = g.multilayer_sample(torch.arange(32, dtype=torch.int32, device=dev), (4, 3), seed=1)
    x = feats[ml.unique_gids.long().clamp(max=n - 1)] * ml.unique_mask[:, None]
    return model, x, ml


def entry(device: DeviceLike = "cuda"):
    """``(fn, example_args)``: ``fn(params, x, ml)`` is the sampled 2-layer
    GraphSAGE forward (logits [32, 4]) and ``example_args`` its parameters,
    features and sample on ``device``."""
    model, x, ml = _build_tiny(device=device)

    def fwd(params, x, ml):
        return functional_call(model, params, (x,), {"sample": ml})

    return fwd, ({k: v.detach() for k, v in model.named_parameters()}, x, ml)
