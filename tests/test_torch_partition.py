"""Port parity: PartitionPlan of wholegraph_tpu_torch against the JAX
package's, bit-exact, for equal, custom and round-robin plans at worlds 1,
3 and 8, on ids that cover every row, the shard edges and ids outside
``[0, n)`` (whose slots the two packages compute alike, quirks included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.memory import PartitionPlan as JPlan
from wholegraph_tpu_torch.memory import PartitionPlan as TPlan
from wholegraph_tpu_torch.utils.error import InvalidInput

N = 50


def _plans(kind, world):
    if kind == "equal":
        return JPlan.equal(N, world), TPlan.equal(N, world)
    if kind == "custom":
        rs = np.random.RandomState(world)
        sizes = rs.multinomial(N, np.ones(world) / world)
        if world > 1:
            sizes[1] += sizes[0]  # an empty first shard
            sizes[0] = 0
        return JPlan.custom(tuple(int(x) for x in sizes)), TPlan.custom(sizes.tolist())
    return JPlan.round_robin(N, world, 4), TPlan.round_robin(N, world, 4)


def _ids():
    rs = np.random.RandomState(0)
    return np.concatenate([np.arange(-3, N + 4), rs.randint(-2 * N, 3 * N, 64)]).astype(np.int32)


CASES = [(k, w) for k in ("equal", "custom", "round_robin") for w in (1, 3, 8)]


@pytest.mark.parametrize("kind,world", CASES)
def test_plan_fields_match_jax(kind, world):
    jp, tp = _plans(kind, world)
    assert (tp.n, tp.world, tp.shard_rows, tp.capacity, tp.mode, tp.rr_block) == \
        (jp.n, jp.world, jp.shard_rows, jp.capacity, jp.mode, jp.rr_block)
    assert tp.is_equal_block == jp.is_equal_block
    assert tp.offsets == jp.offsets
    assert tp.total_physical_rows == jp.total_physical_rows
    for s in range(world):
        assert tp.shard_row_start(s) == jp.shard_row_start(s)
        np.testing.assert_array_equal(tp.shard_logical_ids(s), jp.shard_logical_ids(s))
        assert tp.shard_logical_ids(s).dtype == np.int64


@pytest.mark.parametrize("kind,world", CASES)
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_plan_maps_match_jax(kind, world, id_dtype):
    jp, tp = _plans(kind, world)
    ids = _ids()
    tids = torch.from_numpy(ids).to(id_dtype)
    j = jnp.asarray(ids)
    owner = tp.owner(tids)
    assert owner.dtype == torch.int32
    np.testing.assert_array_equal(owner.numpy(), np.asarray(jp.owner(j)))
    np.testing.assert_array_equal(tp.local_slot(tids).numpy(), np.asarray(jp.local_slot(j)))
    phys = tp.physical_index(tids)
    assert phys.dtype == id_dtype
    np.testing.assert_array_equal(phys.numpy(), np.asarray(jp.physical_index(j)))
    np.testing.assert_array_equal(tp.physical_index_np(ids), jp.physical_index_np(ids))
    # the logical rows land on distinct physical rows inside the table
    rows = tp.physical_index_np(np.arange(N))
    assert len(set(rows.tolist())) == N and rows.min() >= 0 and rows.max() < tp.total_physical_rows


def test_physical_index_widens_int32_for_tables_past_2_31_rows():
    """The JAX package refuses tables of 2^31 physical rows or more
    (ops/gather.py:72-81); the port indexes them in int64."""
    tp = TPlan.equal(2**31 + 10, 1)
    ids = torch.tensor([0, 2**31 - 1], dtype=torch.int32)
    out = tp.physical_index(ids)
    assert out.dtype == torch.int64 and out.tolist() == [0, 2**31 - 1]
    np.testing.assert_array_equal(tp.physical_index_np([2**31 + 9]), [2**31 + 9])


@pytest.mark.parametrize("bad", [lambda: TPlan.equal(-1, 2), lambda: TPlan.equal(4, 0),
                                 lambda: TPlan.custom([3, -1]),
                                 lambda: TPlan.round_robin(4, 2, 0)])
def test_bad_plans_raise(bad):
    with pytest.raises(InvalidInput):
        bad()
