"""Counter-based RNG, replayable on host — bit-exact with the JAX package.

Port of ``wholegraph_tpu/ops/rng.py:28-92``: ``rand_u32(seed, a, b)`` is a
pure function of its inputs (murmur3-finalizer mixing), so the sampler's
draws depend only on (seed, centre id, hop, slot) and tests compare them
bit-exactly against the JAX package and its numpy replica.

PyTorch has no full uint32 arithmetic, so the values are held in int64 in
``[0, 2^32)``. A 32-bit product is formed from two 16-bit halves so that no
intermediate leaves int64's range (a wrapping 64-bit multiply would keep the
right low bits too, but signed overflow is not something to lean on).
"""

from __future__ import annotations

from typing import Union

import torch

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike) -> IntLike:
    """Reinterpret as uint32 (two's complement wrap), held in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(x: IntLike, c: int) -> IntLike:
    """``(x * c) mod 2^32`` for x, c in [0, 2^32), without overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(x: IntLike) -> IntLike:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def rand_u32(seed: IntLike, a: IntLike, b: IntLike) -> torch.Tensor:
    """Counter hash → uint32 values as an int64 tensor. All args are ints or
    int tensors (broadcast together); negative values wrap as uint32."""
    h = _mix(_u32(seed) ^ _GOLD)
    h = _mix(_u32(a) ^ h)
    h = _mix(_u32(b) ^ h)
    return h if isinstance(h, torch.Tensor) else torch.tensor(h, dtype=torch.int64)


def randint(seed: IntLike, a: IntLike, b: IntLike, n: IntLike) -> torch.Tensor:
    """Uniform int32 in [0, n) by modulo reduction (the JAX package's exact
    reduction, so parity is bit-exact). ``n`` must be >= 1."""
    return (rand_u32(seed, a, b) % _u32(n)).to(torch.int32)


def rand_uniform(seed: IntLike, a: IntLike, b: IntLike) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the top 24 bits."""
    r = rand_u32(seed, a, b)
    return (r >> 8).to(torch.float32) * (1.0 / (1 << 24))
