"""Port parity: the sharded row store of wholegraph_tpu_torch at world 1
(ShardedTable, ops.gather / ops.scatter, local_take_sorted and the
Embedding's sorted route) on the CPU against the JAX package's ShardedTable
on a one-device mesh, from numpy-made data.

Tolerances: gathers and sets move bits and are exact in range; sums of
duplicate rows and gradients add in another order, rtol/atol 1e-6. Gathers
are compared on ids in ``[0, n)``: for other ids the JAX world-1 branch
clips where its docstring promises zero rows, and the port gives zero rows
(quirk R7, pinned on its own below). The kernels I and J and B's masked
route run their plain versions here; ``tests/test_torch_cuda.py`` holds
the kernels against those on the card."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wholegraph_tpu.embedding as jemb
import wholegraph_tpu_torch.embedding as temb
from wholegraph_tpu.memory import PartitionPlan as JPlan, ShardedTable as JTable
from wholegraph_tpu_torch.ops import gather as tg
from wholegraph_tpu_torch.memory import PartitionPlan as TPlan, ShardedTable as TTable
from wholegraph_tpu_torch.ops import gather_kernels as K
from wholegraph_tpu_torch.utils.error import InvalidInput, NotSupported

# wholegraph_tpu.ops binds the name ``gather`` to a function; take the module
jg = importlib.import_module("wholegraph_tpu.ops.gather")
jgp = importlib.import_module("wholegraph_tpu.ops.gather_pallas")

torch.set_num_threads(1)

SUMS = dict(rtol=1e-6, atol=1e-6)
N, DIM, B = 45, 6, 64


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _arr(kind, seed=0):
    """(numpy array for both packages, its float32 values) of a table kind."""
    rs = np.random.RandomState(seed)
    if kind == "1d":
        a = rs.randn(N).astype(np.float32)
        return a, a
    a = rs.randn(N, DIM).astype(np.float32)
    if kind == "bf16":
        b = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))  # ml_dtypes bfloat16
        return b, b.astype(np.float32)
    return a, a


def _f32(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _plans(kind):
    if kind == "round_robin":  # 48 physical rows for 45 logical: the padding is never read
        return JPlan.round_robin(N, 1, 8), TPlan.round_robin(N, 1, 8)
    return JPlan.equal(N, 1), TPlan.equal(N, 1)


def _pair(kind="f32", plan="equal", seed=0):
    arr, ref = _arr(kind, seed)
    jp, tp = _plans(plan)
    return JTable.from_array(_mesh1(), arr, plan=jp), TTable.from_array(arr, plan=tp, device="cpu"), ref


def _ids(seed=1, sort=False):
    ids = np.random.RandomState(seed).randint(0, N, B).astype(np.int32)  # duplicates
    ids[:3] = [0, N - 1, N // 2]
    return np.sort(ids) if sort else ids


TABLES = ["f32", "bf16", "1d"]


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("plan", ["equal", "round_robin"])
def test_from_array_and_host_copies_match_jax(kind, plan):
    jt, tt, ref = _pair(kind, plan)
    assert tt.shape == jt.shape and tt.n == jt.n and tt.dim == jt.dim
    assert tuple(tt.data.shape) == jt.data.shape
    np.testing.assert_array_equal(_f32(tt.data), _f32(jt.data))  # the physical layout
    np.testing.assert_array_equal(tt.to_array(), ref)
    np.testing.assert_array_equal(tt.to_array(), _f32(jt.to_array()))
    assert tt.addressable_shard_ids() == jt.addressable_shard_ids() == [0]
    np.testing.assert_array_equal(tt.local_shard(0), _f32(jt.local_shard(0)))
    np.testing.assert_array_equal(tt.sub_rows(5, 17), _f32(jt.sub_rows(5, 17)))


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("local_kernel", ["ring", "sorted"])
@pytest.mark.parametrize("dedup", [False, True])
def test_gather_matches_jax(kind, local_kernel, dedup):
    jt, tt, ref = _pair(kind, "round_robin" if dedup else "equal")
    ids = _ids(sort=local_kernel == "sorted")
    tout = tt.gather(torch.from_numpy(ids), local_kernel=local_kernel, dedup=dedup)
    assert tout.dtype == tt.dtype and tuple(tout.shape) == ref[ids].shape
    np.testing.assert_array_equal(_f32(tout), ref[ids])
    if kind == "1d" and local_kernel == "sorted":
        return  # the JAX sorted take has no 1-D form (gather_pallas.py:943 unpacks [N, D])
    jout = jt.gather(jnp.asarray(ids), local_kernel=local_kernel, dedup=dedup)
    np.testing.assert_array_equal(_f32(tout), _f32(jout))


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("donate", [False, True])
def test_scatter_matches_jax(kind, accumulate, donate):
    jt, tt, ref = _pair(kind)
    rs = np.random.RandomState(2)
    if accumulate and kind == "f32":
        ids = rs.randint(-3, N + 3, B).astype(np.int32)  # duplicates add up
    else:  # the JAX set keeps an unspecified duplicate; bf16 adds round each partial sum
        ids = np.concatenate([rs.permutation(N)[:N - 9], [-1, N, N + 3, -5]]).astype(np.int32)
    rows = rs.randn(len(ids), *ref.shape[1:]).astype(np.float32)
    jrows = jnp.asarray(rows).astype(jt.dtype)
    trows = torch.from_numpy(rows).to(tt.dtype)
    before = tt.data.clone()
    j2 = jt.scatter(jnp.asarray(ids), jrows, accumulate=accumulate)
    t2 = tt.scatter(torch.from_numpy(ids), trows, accumulate=accumulate, donate=donate)
    if accumulate and kind == "f32":
        np.testing.assert_allclose(t2.to_array(), _f32(j2.to_array()), **SUMS)
    else:
        np.testing.assert_array_equal(t2.to_array(), _f32(j2.to_array()))
    if donate:
        assert t2.data.data_ptr() == tt.data.data_ptr()
    else:
        assert torch.equal(tt.data, before) and t2.data.data_ptr() != tt.data.data_ptr()


@pytest.mark.parametrize("kind", ["f32", "1d"])
def test_scatter_set_with_duplicates_writes_the_last_row(kind):
    """Kernel B writes rows in parallel, so the store keeps one writer per
    id, the last, as a sequential write would (the JAX package leaves the
    winner unspecified)."""
    _, tt, ref = _pair(kind)
    rs = np.random.RandomState(9)
    ids = rs.randint(-3, N + 3, 3 * N).astype(np.int32)
    rows = rs.randn(len(ids), *ref.shape[1:]).astype(np.float32)
    expect = ref.copy()
    for i, r in zip(ids, rows):
        if 0 <= i < N:
            expect[i] = r
    out = tt.scatter(torch.from_numpy(ids), torch.from_numpy(rows), donate=True)
    np.testing.assert_array_equal(out.to_array(), expect)


@pytest.mark.parametrize("local_kernel", ["ring", "sorted"])
def test_gather_grad_matches_jax(local_kernel):
    arr, _ = _arr("f32")
    jt = JTable.from_array(_mesh1(), arr)
    ids = _ids(3, sort=local_kernel == "sorted")
    ct = np.random.RandomState(4).randn(B, DIM).astype(np.float32)

    def loss(data):
        out = jg.gather(data, jnp.asarray(ids), plan=jt.plan, mesh=jt.mesh,
                        local_kernel=local_kernel)
        return (out * ct).sum()

    jgrad = jax.grad(loss)(jt.data)
    data = torch.from_numpy(arr.copy()).requires_grad_()
    out = tg.gather(data, torch.from_numpy(ids), plan=TPlan.equal(N, 1),
                      local_kernel=local_kernel)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(jgrad), **SUMS)


def test_local_take_sorted_and_grad_match_jax():
    """Clip semantics, as the JAX function (which on the CPU takes its XLA
    path), for unsorted, duplicated and out-of-range slots."""
    arr, _ = _arr("f32")
    slots = np.random.RandomState(5).randint(-4, N + 4, B).astype(np.int32)
    ct = np.random.RandomState(6).randn(B, DIM).astype(np.float32)
    jout, vjp = jax.vjp(lambda t: jgp.local_take_sorted(t, jnp.asarray(slots), density=0.5),
                        jnp.asarray(arr))
    (jgrad,) = vjp(jnp.asarray(ct))
    t = torch.from_numpy(arr.copy()).requires_grad_()
    out = tg.local_take_sorted(t, torch.from_numpy(slots), density=0.5)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **SUMS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gather_sorted_matches_jax(dtype):
    rs = np.random.RandomState(7)
    init = rs.randn(N, DIM).astype(np.float32)
    je = jemb.Embedding.create(_mesh1(), N, DIM, dtype=getattr(jnp, dtype))
    jstate = je.from_array(init)
    te = temb.Embedding.create(N, DIM, dtype=dtype, device="cpu").from_array(init)
    ids = np.sort(rs.randint(-2, N + 2, B)).astype(np.int32)  # clipped at both ends
    for lk in ("sorted", "ring"):
        jout = je.gather(jstate, jnp.asarray(ids), local_kernel=lk)
        np.testing.assert_array_equal(_f32(te.gather(torch.from_numpy(ids), local_kernel=lk)),
                                      _f32(jout))
    st = te.as_sharded_table()
    assert st.data.data_ptr() == te.table.data_ptr() and st.shape == (N, DIM)
    inr = ids[(ids >= 0) & (ids < N)]
    np.testing.assert_array_equal(_f32(st.gather(torch.from_numpy(inr))),
                                  _f32(je.as_sharded_table(jstate).gather(jnp.asarray(inr))))


@pytest.mark.parametrize("local_kernel", ["ring", "sorted"])
@pytest.mark.parametrize("kind", ["f32", "1d"])
def test_out_of_range_ids_give_zero_rows_and_no_gradient(local_kernel, kind):
    """Quirk R7: the JAX world-1 gather clips (id 10 and 12 of a 10-row
    table read row 9, id -1 row 0) though its docstring promises zero rows,
    as its world > 1 path gives; the port gives zero rows at every world
    and drops those ids' gradient."""
    n = 10
    arr = np.arange(1, n * 4 + 1, dtype=np.float32).reshape(n, 4)
    if kind == "1d":
        arr = arr[:, 0].copy()
    ids = np.array([0, 3, 9, 10, 12, -1], np.int32)
    jt = JTable.from_array(_mesh1(), arr)
    if not (kind == "1d" and local_kernel == "sorted"):  # no 1-D JAX sorted take
        jout = np.asarray(jt.gather(jnp.asarray(ids), local_kernel=local_kernel))
        np.testing.assert_array_equal(jout[3:], arr[[9, 9, 0]])  # the quirk the port does not copy
    data = torch.from_numpy(arr.copy()).requires_grad_()
    out = tg.gather(data, torch.from_numpy(ids), plan=TPlan.equal(n, 1),
                      local_kernel=local_kernel)
    np.testing.assert_array_equal(out.detach().numpy()[:3], arr[[0, 3, 9]])
    assert not out.detach().numpy()[3:].any()
    out.sum().backward()
    expect = np.zeros_like(arr)
    expect[[0, 3, 9]] = 1.0
    np.testing.assert_array_equal(data.grad.numpy(), expect)


def test_create_init_and_locations():
    tt = TTable.create(N, DIM, "bfloat16", device="cpu")
    assert tt.shape == (N, DIM) and tt.dtype == torch.bfloat16 and not tt.to_array().any()
    assert TTable.create(N, 0, device="cpu").shape == (N,)

    def init(gen, shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype)

    a = TTable.create(N, DIM, init=init, generator=torch.Generator().manual_seed(3), device="cpu")
    b = TTable.create(N, DIM, init=init, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a.data, b.data) and a.data.abs().sum() > 0
    h = a.to_location("host")
    assert h.location == "host" and torch.equal(h.data, a.data)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(NotSupported):
        h.gather(ids)
    with pytest.raises(NotSupported):
        h.scatter(ids, torch.zeros(2, DIM))
    assert torch.equal(h.to_location("device").gather(ids), a.gather(ids))
    hc = TTable.create(N, DIM, location="host", device="cpu")
    assert hc.location == "host" and not hc.to_array().any()
    with pytest.raises(InvalidInput):
        TTable.create(N, DIM, location="disk", device="cpu")


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        TTable.create(N, DIM, plan=TPlan.equal(N, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tg.gather(torch.zeros(N, DIM), torch.zeros(3, dtype=torch.int32), plan=TPlan.equal(N, 4))
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        TTable.from_filelist(["x.bin"], DIM, "float32")
    with pytest.raises(InvalidInput):
        tg.gather(torch.zeros(N, DIM), torch.zeros(3, dtype=torch.int32), plan=TPlan.equal(N, 1),
                    local_kernel="window")


def test_kernel_plain_contracts():
    """Kernels I and J and B's masked route on the CPU: the plain versions
    their wrappers run there, against numpy."""
    rs = np.random.RandomState(8)
    table = rs.randn(N, DIM).astype(np.float32)
    slots = rs.randint(-5, N + 5, B).astype(np.int32)
    t, s = torch.from_numpy(table), torch.from_numpy(slots)
    valid = (slots >= 0) & (slots < N)
    masked = np.where(valid[:, None], table[np.clip(slots, 0, N - 1)], 0.0)
    np.testing.assert_array_equal(K.gather_rows_masked(t, s).numpy(), masked)
    np.testing.assert_array_equal(K.gather_rows_sorted(t, s, zero_invalid=True).numpy(), masked)
    np.testing.assert_array_equal(K.gather_rows_sorted(t, s).numpy(),
                                  table[np.clip(slots, 0, N - 1)])
    assert not K.gather_rows_masked(torch.zeros(0, DIM), s).any()  # an empty table: zero rows
    rows = rs.randn(B, DIM).astype(np.float32)
    uniq = np.where(np.arange(B) % 3 == 0, -1, rs.permutation(B + N)[:B] - 3).astype(np.int32)
    dst = t.clone()
    assert K.scatter_rows_masked(dst, torch.from_numpy(uniq), torch.from_numpy(rows)) is dst
    ref = table.copy()
    ok = (uniq >= 0) & (uniq < N)
    ref[uniq[ok]] = rows[ok]
    np.testing.assert_array_equal(dst.numpy(), ref)


@pytest.mark.parametrize("row_bytes,density", [(1024, 1.0), (1024, 0.8), (512, 1.0), (64, 0.5),
                                               (4, 0.2)])
def test_sorted_plan_fits_shared_memory(row_bytes, density):
    tile, window = K.sorted_plan(row_bytes, density=density)
    assert 32 <= tile <= 256 and tile & (tile - 1) == 0
    assert window >= tile  # a dense sorted tile fits its window
    assert -(-tile * 8 // 16) * 16 + window * row_bytes <= K.SORTED_SMEM_BYTES
    # an explicit window is kept, up to what shared memory holds
    assert K.sorted_plan(row_bytes, tile=tile, window=tile)[1] == tile
    assert K.sorted_plan(row_bytes, tile=64, window=10**9)[1] * row_bytes <= K.SORTED_SMEM_BYTES
