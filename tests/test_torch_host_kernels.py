"""The plain contracts of kernels E and F (host row fetch and write-back) on
the CPU, their parity with the JAX package's host take and write
(``host_embedding._host_take`` / ``_host_write``, the CPU path of
``gather_pallas.host_gather_rows`` / ``host_scatter_rows``), and the
dispatch rules of their wrappers.

Everything here moves bits, so every comparison is exact. The JAX host take
returns row 0 for a skipped slot (a TPU garbage row, masked by its callers);
the port returns a zero row, so the parity compares valid slots and the
zero rows are pinned on their own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wholegraph_tpu.embedding.host_embedding import _host_take, _host_write
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.utils.error import CudaError, InvalidInput

torch.set_num_threads(1)

N, D = 50, 8


def _table(dtype=torch.float32, seed=0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(N, D).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("slot_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_skips_slots_outside_the_table(slot_dtype, dtype):
    table = _table(dtype)
    before = table.clone()
    slots = torch.tensor([3, -1, N, 0, N - 1, -7, N + 5, 3], dtype=slot_dtype)
    out = H.host_gather_rows(table, slots)
    assert out.dtype == dtype and out.shape == (8, D)
    ok = (slots >= 0) & (slots < N)
    assert torch.equal(out[ok], table[slots[ok].long()])
    assert not out[~ok].any()
    assert torch.equal(table, before)


def test_gather_matches_jax_host_take_on_valid_slots():
    table = _table()
    rs = np.random.RandomState(1)
    slots = rs.randint(-3, N + 3, 200).astype(np.int32)
    out = H.host_gather_rows(table, torch.from_numpy(slots)).numpy()
    ref = np.asarray(_host_take(jnp.asarray(table.numpy().reshape(-1)), jnp.asarray(slots), D))
    ok = (slots >= 0) & (slots < N)
    np.testing.assert_array_equal(out[ok], ref[ok])
    assert not out[~ok].any()


@pytest.mark.parametrize("slot_dtype", [torch.int32, torch.int64])
def test_scatter_writes_valid_slots_and_nothing_else(slot_dtype):
    table = _table()
    before = table.clone()
    slots = torch.tensor([4, -1, N, 9, N + 2, 0, -5], dtype=slot_dtype)
    rows = torch.arange(7 * D, dtype=torch.float32).reshape(7, D) + 100
    assert H.host_scatter_rows(table, slots, rows) is table
    ok = (slots >= 0) & (slots < N)
    assert torch.equal(table[slots[ok].long()], rows[ok])
    untouched = torch.ones(N, dtype=torch.bool)
    untouched[slots[ok].long()] = False
    assert torch.equal(table[untouched], before[untouched])


def test_scatter_matches_jax_host_write():
    table = _table()
    rs = np.random.RandomState(2)
    slots = rs.permutation(N + 10)[:30].astype(np.int32) - 5  # unique, some outside [0, N)
    rows = rs.randn(30, D).astype(np.float32)
    ref = np.asarray(_host_write(jnp.asarray(table.numpy().reshape(-1)), jnp.asarray(slots),
                                 jnp.asarray(rows), D)).reshape(N, D)
    H.host_scatter_rows(table, torch.from_numpy(slots), torch.from_numpy(rows))
    np.testing.assert_array_equal(table.numpy(), ref)


def test_empty_batch_and_empty_table():
    table = _table()
    out = H.host_gather_rows(table, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, D)
    before = table.clone()
    H.host_scatter_rows(table, torch.zeros(0, dtype=torch.int64), torch.zeros(0, D))
    assert torch.equal(table, before)
    empty = torch.zeros(0, D)
    out = H.host_gather_rows(empty, torch.tensor([0, -1, 2]))
    assert out.shape == (3, D) and not out.any()
    H.host_scatter_rows(empty, torch.tensor([0, 1]), torch.ones(2, D))
    assert empty.shape == (0, D)


def test_input_checks():
    table = _table()
    with pytest.raises(InvalidInput):
        H.host_gather_rows(table.reshape(-1), torch.tensor([0]))
    with pytest.raises(InvalidInput):
        H.host_gather_rows(table, torch.tensor([0.0]))
    with pytest.raises(InvalidInput):
        H.host_scatter_rows(table, torch.tensor([0, 1]), torch.ones(3, D))
    with pytest.raises(InvalidInput):
        H.host_scatter_rows(table, torch.tensor([0]), torch.ones(1, D, dtype=torch.float64))


def test_dispatch_never_falls_back_off_the_cpu():
    """Only a CPU table with CPU slots runs the plain version; any device
    other than the CPU raises rather than being served on the host."""
    table = _table()
    meta_slots = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(CudaError):
        H.host_gather_rows(table, meta_slots)
    with pytest.raises(CudaError):
        H.host_gather_rows(table.to("meta"), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(CudaError):
        H.host_scatter_rows(table, torch.zeros(2, dtype=torch.int32), torch.ones(2, D, device="meta"))
    with pytest.raises(CudaError):
        H.host_scatter_rows(table, meta_slots, torch.ones(4, D, device="meta"))


@pytest.mark.parametrize("slot_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["uniform", "duplicates", "one_row", "all_invalid"])
def test_host_gather_plan_replays_the_plain_gather(slot_dtype, case):
    """Kernel E's read order: replaying ``out[pos[i]] = table[keys[i]]`` for
    the valid keys gives the plain gather bit for bit; the keys ascend with
    the invalid slots last, and ``pos`` is a permutation."""
    rs = np.random.RandomState(3)
    table = _table()
    slots = {"uniform": rs.randint(-4, N + 4, 300), "duplicates": rs.randint(0, 6, 300),
             "one_row": np.full(300, 7), "all_invalid": rs.randint(N, 2 * N, 300) * -1}[case]
    slots = torch.from_numpy(slots).to(slot_dtype)
    keys, pos = H.host_gather_plan(slots, N)
    assert keys.dtype == torch.int32 and pos.dtype == torch.int64
    assert (keys[1:] >= keys[:-1]).all()
    assert torch.equal(pos.sort().values, torch.arange(300))
    valid = keys < N
    assert torch.equal(keys[valid], slots[(slots >= 0) & (slots < N)].sort().values.to(torch.int32))
    assert (keys[~valid] == N).all()
    out = torch.zeros(300, D)
    out[pos[valid]] = table[keys[valid].long()]
    assert torch.equal(out, H.host_gather_rows_plain(table, slots))
    # each distinct valid row is read once: E's link bytes
    assert int(valid.sum()) == 0 or torch.unique(keys[valid]).numel() == torch.unique(
        slots[(slots >= 0) & (slots < N)]).numel()


def test_host_gather_plan_keys_widen_for_tables_past_int32():
    slots = torch.tensor([5, -1, 2**31 + 3, 2**33], dtype=torch.int64)
    keys, pos = H.host_gather_plan(slots, 2**32)
    assert keys.dtype == torch.int64
    assert keys.tolist() == [5, 2**31 + 3, 2**32, 2**32] and pos[:2].tolist() == [0, 2]


def test_sorted_flag_is_inert_on_the_cpu():
    """``_sort=False`` and ``_stats`` change nothing on the CPU: the plain
    gather, and the count untouched (only kernel E adds to it)."""
    table = _table()
    slots = torch.tensor([4, 2, 2, -1, N], dtype=torch.int32)
    stats = torch.zeros(1, dtype=torch.int64)
    assert torch.equal(H.host_gather_rows(table, slots, _sort=False, _stats=stats),
                       H.host_gather_rows_plain(table, slots))
    assert stats.item() == 0


def test_kernels_name_the_tpu_kernels_they_replace():
    assert H.HOST_GATHER.source == H.HOST_SCATTER.source == "host_rows.cu"
    assert H.HOST_GATHER.replaces.endswith("gather_pallas.py:1168,1290")
    assert H.HOST_SCATTER.replaces.endswith("gather_pallas.py:1183")
