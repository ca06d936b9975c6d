"""The counter-based RNG of the sampler, as arithmetic: a frozen copy.

``rand_u32(seed, a, b)`` mixes its three 32-bit inputs with the murmur3
finalizer; a draw depends only on (seed, centre id, hop * 2^20 + slot).
Values are held in int64 within ``[0, 2^32)``; a 32-bit product is formed
from 16-bit halves so that nothing leaves int64's range.
"""

from __future__ import annotations

import torch

C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLD = 0x9E3779B9
M32 = 0xFFFFFFFF
HOP_STRIDE = 1 << 20


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mul32(x, c: int):
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, C1)
    x = x ^ (x >> 13)
    x = _mul32(x, C2)
    return x ^ (x >> 16)


def rand_u32(seed, a, b) -> torch.Tensor:
    h = _mix(_u32(seed) ^ GOLD)
    h = _mix(_u32(a) ^ h)
    h = _mix(_u32(b) ^ h)
    return h if isinstance(h, torch.Tensor) else torch.tensor(h, dtype=torch.int64)


def randint(seed, a, b, n) -> torch.Tensor:
    """Uniform in ``[0, n)`` by modulo reduction, int64."""
    return rand_u32(seed, a, b) % _u32(n)
