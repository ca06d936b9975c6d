"""How far apart the f32 ``log`` of numpy, XLA on the CPU and torch on the
CPU are over every value the weighted sampler's ``u`` takes.

The A-Res key is ``log(max(u, 1e-20)) / w`` with ``u = (hash >> 8) * 2^-24``,
so ``u`` takes 2^24 values. For each pair of implementations this prints how
many of them give another f32 bit pattern and the largest difference in
ulps. It is why the weighted sampler's keys are compared under the rule of
``wholegraph_tpu_torch.ops.sampling.weighted_near_ties`` and not bit for bit.

Run: ``JAX_PLATFORMS=cpu python scripts/log_ulps.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

u = np.maximum(np.arange(1 << 24, dtype=np.float32) * np.float32(2.0 ** -24), np.float32(1e-20))
logs = {
    "numpy": np.log(u),
    "xla-cpu": np.asarray(jax.jit(jnp.log)(jnp.asarray(u))),
    "torch-cpu": torch.log(torch.from_numpy(u)).numpy(),
}
print(f"jax {jax.__version__}, torch {torch.__version__}, numpy {np.__version__}, "
      f"backend {jax.default_backend()}")
for a, b in itertools.combinations(logs, 2):
    # every log here is <= 0: one sign, so the int32 patterns differ by the ulps
    d = np.abs(logs[a].view(np.int32).astype(np.int64) - logs[b].view(np.int32).astype(np.int64))
    print(f"{a} vs {b}: {int((d != 0).sum())} of {u.size} values differ, by up to {int(d.max())} ulp")
