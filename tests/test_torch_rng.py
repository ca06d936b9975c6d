"""Port parity: the counter RNG of wholegraph_tpu_torch.ops.rng is bit-equal
to the JAX package's device hash and to its numpy replica."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.ops import rng as jrng
from wholegraph_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

# keys that wrap: negative ints, values above int32 max, the uint32 extremes
WRAP = np.array([0, 1, -1, -2**31, 2**31 - 1, 2**31, 2**32 - 1, 123456789], np.int64)


def _keys(seed):
    rs = np.random.RandomState(seed)
    a = np.concatenate([WRAP, rs.randint(-2**31, 2**31, 500)])
    b = np.concatenate([WRAP[::-1], rs.randint(0, 2**32, 500)])
    return a, b


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1, -5])
def test_rand_u32_bit_exact(seed):
    a, b = _keys(1)
    host = jrng.rand_u32_np(np.uint32(seed & 0xFFFFFFFF), a.astype(np.uint32), b.astype(np.uint32))
    dev = np.asarray(jrng.rand_u32(np.uint32(seed & 0xFFFFFFFF), jnp.asarray(a.astype(np.uint32)),
                                   jnp.asarray(b.astype(np.uint32))))
    port = trng.rand_u32(seed, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(port, host.astype(np.int64))
    np.testing.assert_array_equal(port, dev.astype(np.int64))


def test_randint_and_uniform_bit_exact():
    a, b = _keys(2)
    n = np.random.RandomState(3).randint(1, 5000, a.shape[0])
    ua, ub = a.astype(np.uint32), b.astype(np.uint32)
    np.testing.assert_array_equal(
        trng.randint(9, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(n)).numpy(),
        jrng.randint_np(9, ua, ub, n))
    np.testing.assert_array_equal(
        trng.randint(9, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(n)).numpy(),
        np.asarray(jrng.randint(9, jnp.asarray(ua), jnp.asarray(ub), jnp.asarray(n))))
    np.testing.assert_array_equal(
        trng.rand_uniform(4, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        jrng.rand_uniform_np(4, ua, ub))


def test_scalar_and_broadcast_keys():
    """Python-int keys and broadcast shapes give the same bits as arrays."""
    col = torch.arange(6, dtype=torch.int32)[:, None]
    row = torch.arange(4, dtype=torch.int32)[None, :]
    out = trng.rand_u32(3, col, row)
    assert out.shape == (6, 4)
    ref = jrng.rand_u32_np(3, np.repeat(np.arange(6), 4).astype(np.uint32),
                           np.tile(np.arange(4), 6).astype(np.uint32)).reshape(6, 4)
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))
    assert int(trng.rand_u32(3, 5, 2)) == int(jrng.rand_u32_np(3, np.uint32(5), np.uint32(2)))
