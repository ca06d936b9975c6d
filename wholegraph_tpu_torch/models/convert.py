"""Weight bridge from the JAX package's flax parameters.

``params_from_jax`` takes the flax parameter tree of a ``HomoGNN`` of SAGE,
GCN or GAT convs with its leaves already converted to numpy arrays (the
caller does the ``np.asarray``; nothing here imports JAX) and returns the
port's ``state_dict``. A flax ``Dense`` kernel is ``[in, out]``;
``nn.Linear``'s weight is ``[out, in]``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..utils.error import check_input

_CONV = re.compile(r"^(SAGEConv|GCNConv|GATConv)_(\d+)$")
# parameters each conv holds beside its ``proj`` Dense, loaded as they are
_EXTRA = {"SAGEConv": (), "GCNConv": ("bias",), "GATConv": ("attn_src", "attn_dst")}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{'params': {'SAGEConv_i': {'proj': {'kernel', 'bias'}},
    'GCNConv_i': {'proj': {'kernel'}, 'bias'}, 'GATConv_i': {'proj':
    {'kernel'}, 'attn_src', 'attn_dst'}}}`` (the outer ``'params'`` level
    optional) → ``{'convs.i.proj.weight', 'convs.i.proj.bias',
    'convs.i.bias', 'convs.i.attn_src', ...}``."""
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = _CONV.match(name)
        check_input(m is not None,
                    f"unsupported flax module {name!r} (SAGEConv_i, GCNConv_i or GATConv_i)")
        kind, i = m.group(1), m.group(2)
        check_input("proj" in sub and all(k in sub for k in _EXTRA[kind]),
                    f"{name} lacks one of proj, {', '.join(_EXTRA[kind]) or 'nothing else'}")
        proj = sub["proj"]
        out[f"convs.{i}.proj.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(proj["kernel"]).T))
        if "bias" in proj:
            out[f"convs.{i}.proj.bias"] = _tensor(proj["bias"])
        for k in _EXTRA[kind]:
            out[f"convs.{i}.{k}"] = _tensor(sub[k])
    return out
