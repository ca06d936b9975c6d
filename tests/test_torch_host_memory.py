"""The host tier's memory on the CPU: ``HostEmbedding`` keeps its table
and each optimizer state table in an allocation of its own bytes
(``ops.host_kernels.host_zeros``; on a card from the kernels' library, on
the CPU ordinary memory), and every caller sees the same tables as before:
``from_array``, ``to_array`` and ``slot_to_array`` round trips; a few
``HostEmbedding`` training steps against the JAX package's
``HostEmbedding``; a checkpoint whose files are the bytes that JAX's
``save_host_embedding`` writes for the same state.

Tolerances: the allocations, round trips and checkpoint files are exact.
The training steps run SGD (LazyAdam turns summation-order noise into
whole steps, ROADMAP queue 3 "To watch") and agree with JAX to rtol/atol
1e-6 in f32 (f32 elementwise math in another order), one bf16 ulp (rtol
2^-7, atol 1e-6) in bf16."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wholegraph_tpu.embedding as jemb
import wholegraph_tpu.io as jio
import wholegraph_tpu_torch.embedding as temb
import wholegraph_tpu_torch.io as tio
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.utils.error import InvalidInput

torch.set_num_threads(1)

N, DIM, B = 80, 8, 48
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
OPTS = {"sgd": temb.SGD(), "lazy_adam": temb.LazyAdam(),
        "adam_w": temb.LazyAdam(adam_w=True, weight_decay=0.01), "rms_prop": temb.RMSProp(),
        "ada_grad": temb.AdaGrad()}


@pytest.mark.parametrize("shape", [(5, 3), (1, 1), (80, 256)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_host_zeros_on_the_cpu(shape, dtype):
    """On the CPU a zero, dense tensor of the shape and dtype in ordinary
    memory of exactly its bytes; no size refused as nothing to allocate."""
    t = H.host_zeros(shape, DTYPES[dtype], torch.device("cpu"))
    assert t.shape == shape and t.dtype == DTYPES[dtype] and t.is_contiguous()
    assert t.untyped_storage().nbytes() == t.nbytes and not t.any()
    with pytest.raises(InvalidInput, match="positive size"):
        H.host_zeros((0, shape[1]), DTYPES[dtype], torch.device("cpu"))


@pytest.mark.parametrize("dim", [8, 3, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("opt", list(OPTS))
def test_tables_each_in_an_allocation_of_their_own(opt, dtype, dim):
    """``host_table`` and every ``host_slots`` entry (``slot_names`` order)
    are dense ``[rows, dim]`` tensors, each in storage of exactly its own
    bytes, shared with no other table, of the table's dtype and f32; all
    zero."""
    o = OPTS[opt]
    emb = temb.HostEmbedding.create(N, dim, optimizer=o, dtype=dtype, device="cpu")
    tables = [emb.host_table] + [emb.host_slots[s] for s in o.slot_names]
    assert list(emb.host_slots) == list(o.slot_names)
    assert emb.host_table.dtype == DTYPES[dtype]
    assert all(v.dtype == torch.float32 for v in tables[1:])
    for v in tables:
        assert v.shape == (N, dim) and v.is_contiguous() and not v.any()
        assert v.untyped_storage().nbytes() == v.nbytes
    assert len({v.untyped_storage().data_ptr() for v in tables}) == len(tables)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("opt", ["sgd", "lazy_adam", "ada_grad"])
def test_array_round_trips(opt, dtype):
    """``from_array`` writes the table and nothing else; ``to_array`` gives
    it back (bf16 widened exactly); ``slot_to_array`` gives each state
    table; writing a slot writes that table alone."""
    o = OPTS[opt]
    init = np.random.RandomState(1).randn(N, DIM).astype(np.float32)
    emb = temb.HostEmbedding.create(N, DIM, optimizer=o, dtype=dtype, device="cpu")
    emb.from_array(init.astype(np.float16) if dtype == "float16" else init)
    want = torch.from_numpy(init).to(DTYPES[dtype])
    got = emb.to_array()
    assert got.dtype == (np.float16 if dtype == "float16" else np.float32)
    np.testing.assert_array_equal(got, want.float().numpy().astype(got.dtype))
    for k, s in enumerate(o.slot_names):
        assert not emb.slot_to_array(s).any()
        emb.host_slots[s].copy_(torch.full((N, DIM), float(k + 2)))
    for k, s in enumerate(o.slot_names):
        np.testing.assert_array_equal(emb.slot_to_array(s), np.full((N, DIM), k + 2, np.float32))
    np.testing.assert_array_equal(emb.to_array(), got)


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-6, atol=1e-6)),
                                       ("bfloat16", dict(rtol=2.0 ** -7, atol=1e-6))])
def test_train_steps_match_jax(dtype, tol):
    """Four ``make_train_step`` steps (gather, a loss of the rows, its
    gradient, the SGD apply) on the port's host tier and JAX's, from one
    table: the losses, the tables and the cached lines agree."""
    rs = np.random.RandomState(3)
    init = rs.randn(N, DIM).astype(np.float32)
    hot = np.arange(0, N, 4)
    target = rs.randn(B, DIM).astype(np.float32)
    je = jemb.HostEmbedding.create(_mesh1(), N, DIM, optimizer=jemb.SGD(weight_decay=0.01),
                                   cache_ratio=0.3, dtype=getattr(jnp, dtype))
    jstate = je.from_array(init, hot_ids=hot)
    te = temb.HostEmbedding.create(N, DIM, optimizer=temb.SGD(weight_decay=0.01),
                                   cache_ratio=0.3, dtype=dtype, device="cpu").from_array(
        init, hot_ids=hot)

    def jloss(rows, tgt):
        return jnp.mean((rows.astype(jnp.float32) - tgt) ** 2)

    def tloss(rows, tgt):
        return ((rows.float() - tgt) ** 2).mean()

    jstep = je.make_train_step(jloss, 0.5)
    tstep = te.make_train_step(tloss, 0.5)
    for k in range(4):
        ids = rs.randint(0, N, B).astype(np.int32)
        jstate, jl = jstep(jstate, jnp.asarray(ids), jnp.asarray(target))
        tl = tstep(torch.from_numpy(ids), torch.from_numpy(target))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(te.to_array().astype(np.float32),
                               np.asarray(je.to_array(jstate)).astype(np.float32), **tol)
    np.testing.assert_allclose(te.cache_rows.float().numpy(),
                               np.asarray(jstate.cache_rows).astype(np.float32), **tol)


@pytest.mark.parametrize("jopt", [jemb.LazyAdam(), jemb.AdaGrad(), jemb.SGD()],
                         ids=lambda o: o.name)
def test_checkpoint_files_are_jax_bytes(tmp_path, jopt):
    """One host-tier state saved by JAX's ``save_host_embedding`` and by the
    port from its tables: the same files, byte for byte."""
    rs = np.random.RandomState(5)
    hot = np.arange(2, N, 5)
    je = jemb.HostEmbedding.create(_mesh1(), N, DIM, optimizer=jopt, cache_ratio=0.3)
    jstate = je.from_array(rs.randn(N, DIM).astype(np.float32), hot_ids=hot)
    ids, g = rs.randint(0, N, B).astype(np.int32), rs.randn(B, DIM).astype(np.float32)
    jstate = je.apply_gradients(jstate, jnp.asarray(ids), jnp.asarray(g), 0.1)
    jio.save_host_embedding(je, jstate, str(tmp_path / "j"), "h")
    hyper = {k: v for k, v in dataclasses.asdict(jopt).items() if k != "name"}
    te = temb.HostEmbedding.create(N, DIM, optimizer=temb.create_optimizer(jopt.name, **hyper),
                                   cache_ratio=0.3, device="cpu")
    te.from_array(je.to_array(jstate), hot_ids=hot)
    for s in jopt.slot_names:
        te.host_slots[s].copy_(torch.from_numpy(
            np.array(jstate.host_slots[s]).reshape(-1, DIM)[:N]))
    te.step = int(jstate.step)
    tio.save_host_embedding(te, str(tmp_path / "t"), "h")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert len(names) == 3 + len(jopt.slot_names)
    for f in names:
        assert open(tmp_path / "j" / f, "rb").read() == open(tmp_path / "t" / f, "rb").read(), f
