"""Weight bridge from the JAX package's flax parameters.

``params_from_jax`` takes the flax parameter tree of a sampled SAGE
``HomoGNN`` with its leaves already converted to numpy arrays (the caller
does the ``np.asarray``; nothing here imports JAX) and returns the port's
``state_dict``. A flax ``Dense`` kernel is ``[in, out]``; ``nn.Linear``'s
weight is ``[out, in]``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..utils.error import check_input

_CONV = re.compile(r"^SAGEConv_(\d+)$")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{'params': {'SAGEConv_i': {'proj': {'kernel', 'bias'}}}}`` (the
    outer ``'params'`` level optional) → ``{'convs.i.proj.weight', ...}``."""
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = _CONV.match(name)
        check_input(m is not None, f"unsupported flax module {name!r} (only SAGEConv_i)")
        proj = sub["proj"]
        prefix = f"convs.{m.group(1)}.proj"
        out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(proj["kernel"]).T))
        if "bias" in proj:
            out[f"{prefix}.bias"] = torch.from_numpy(np.array(proj["bias"]))
    return out
