"""Weight bridge from the JAX package's flax parameters.

``params_from_jax`` takes the flax parameter tree of a ``HomoGNN`` of SAGE,
GCN, GAT or RGCN convs, of a ``TypedProjection`` or of a ``HeteroGNN``, with
its leaves already converted to numpy arrays (the caller does the
``np.asarray``; nothing here imports JAX) and returns the port's
``state_dict``. A flax ``Dense`` kernel is ``[in, out]``; ``nn.Linear``'s
weight is ``[out, in]``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..utils.error import check_input

_CONV = re.compile(r"^(SAGEConv|GCNConv|GATConv|RGCNConv)_(\d+)$")
_TYPED = re.compile(r"^proj_\w+$")
# each conv's Dense layers, and the parameters it holds beside them, loaded as they are
_DENSE = {"SAGEConv": ("proj",), "GCNConv": ("proj",), "GATConv": ("proj",),
          "RGCNConv": ("self",)}
_EXTRA = {"SAGEConv": (), "GCNConv": ("bias",), "GATConv": ("attn_src", "attn_dst"),
          "RGCNConv": ("w_rel", "bias")}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _dense(out: Dict[str, torch.Tensor], prefix: str, dense: Mapping) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(dense["kernel"]).T))
    if "bias" in dense:
        out[f"{prefix}.bias"] = _tensor(dense["bias"])


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameters (the outer ``'params'`` level optional) → the port's
    ``state_dict``:

    * a ``HomoGNN``'s ``{'SAGEConv_i': {'proj': {'kernel', 'bias'}},
      'GCNConv_i': {'proj': {'kernel'}, 'bias'}, 'GATConv_i': {'proj':
      {'kernel'}, 'attn_src', 'attn_dst'}, 'RGCNConv_i': {'w_rel', 'self':
      {'kernel'}, 'bias'}}`` → ``{'convs.i.proj.weight', 'convs.i.proj.bias',
      'convs.i.bias', 'convs.i.attn_src', 'convs.i.w_rel',
      'convs.i.self.weight', ...}``;
    * a ``TypedProjection``'s ``{'proj_{name}': {'kernel', 'bias'}}`` →
      ``{'proj_{name}.weight', 'proj_{name}.bias'}``;
    * a ``HeteroGNN``'s ``{'typed_proj': {...}, 'gnn': {...}}`` → the two
      above under ``typed_proj.`` and ``gnn.``."""
    params = tree.get("params", tree)
    if "typed_proj" in params or "gnn" in params:
        check_input(set(params) == {"typed_proj", "gnn"},
                    f"a HeteroGNN tree holds typed_proj and gnn, got {sorted(params)}")
        out = {f"typed_proj.{k}": v for k, v in params_from_jax(params["typed_proj"]).items()}
        out.update({f"gnn.{k}": v for k, v in params_from_jax(params["gnn"]).items()})
        return out
    out: Dict[str, torch.Tensor] = {}
    if params and all(_TYPED.match(name) for name in params):
        for name, sub in params.items():
            _dense(out, name, sub)
        return out
    for name, sub in params.items():
        m = _CONV.match(name)
        check_input(m is not None, f"unsupported flax module {name!r} (SAGEConv_i, GCNConv_i, "
                                   "GATConv_i, RGCNConv_i, proj_{name}, typed_proj or gnn)")
        kind, i = m.group(1), m.group(2)
        need = _DENSE[kind] + _EXTRA[kind]
        check_input(all(k in sub for k in need), f"{name} lacks one of {', '.join(need)}")
        for d in _DENSE[kind]:
            _dense(out, f"convs.{i}.{d}", sub[d])
        for k in _EXTRA[kind]:
            out[f"convs.{i}.{k}"] = _tensor(sub[k])
    return out
