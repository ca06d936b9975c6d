"""The sparse apply's row update (``ops/optim_kernels.py``, kernel L's
wrapper) on the CPU: its plain version against the composition it replaced
(kernel A's plain gather, the optimizer's ``update``, kernel B's plain
scatter, as ``Embedding._step_rows`` ran them) bit for bit, for the four
optimizers of the registry and both table types; its tile rule, the
kernel's scalars, the route by optimizer type; and the plain update against
the JAX package's optimizers.

The cases here (:func:`apply_case`) are also the card's:
``tests/test_torch_cuda.py`` holds kernel L to :func:`apply_rows_plain` on
them, bit for bit."""

import numpy as np
import pytest
import torch

from wholegraph_tpu_torch.embedding import (AdaGrad, Embedding, LazyAdam, RMSProp, SGD,
                                            create_optimizer)
from wholegraph_tpu_torch.embedding import embedding as temb
from wholegraph_tpu_torch.ops import optim_kernels as L
from wholegraph_tpu_torch.ops.gather_kernels import gather_rows_plain, scatter_rows_plain

# the four optimizers of the registry, LazyAdam with and without adam_w, with weight decay
APPLY_OPTS = {
    "sgd": SGD(),
    "sgd_wd": SGD(weight_decay=0.01),
    "lazy_adam": LazyAdam(),
    "lazy_adam_wd": LazyAdam(weight_decay=0.01),
    "adam_w": LazyAdam(weight_decay=0.01, adam_w=True),
    "rms_prop": RMSProp(weight_decay=0.01),
    "ada_grad": AdaGrad(weight_decay=0.01),
}
APPLY_DIMS = (1, 2, 3, 4, 16, 100, 256, 257)  # rows of 1 to 257 elements
APPLY_KINDS = ("padded", "mixed", "empty")
APPLY_ROWS = 300  # table rows
APPLY_STEP, APPLY_LR = 3, 0.01


def apply_case(opt, dtype, D, kind, seed=0, R=None, grad_dtype=None, id_dtype=torch.int64):
    """``(table, slots, ids, grads)`` on the CPU, made from ``seed`` with
    numpy. ``padded``: the sampler's layout, unique valid ids first and
    padding equal to the table's rows after them; ``mixed``: unique valid ids
    among padding, -1, -7 and ids past the table, at random places (masked
    slots are padding by then); ``empty``: no slot. Gradients of slots that
    are not valid are NaN: the update must not read them. Slots of ``v`` and
    ``state_sum`` are non-negative."""
    rs = np.random.RandomState(seed)
    n = APPLY_ROWS
    R = {"padded": 200, "mixed": 240, "empty": 0}[kind] if R is None else R
    table = torch.from_numpy((rs.randn(n, D) / np.sqrt(D)).astype(np.float32)).to(dtype)
    slots = {}
    for s in opt.slot_names:
        arr = rs.randn(n, D).astype(np.float32) * 1e-3
        slots[s] = torch.from_numpy(np.abs(arr) * 1e-3 if s in ("v", "state_sum") else arr)
    n_valid = min(R, n, (R * 2) // 3 if kind == "mixed" else R * 3 // 4)
    ids = np.full(R, n, np.int64)
    ids[:n_valid] = rs.permutation(n)[:n_valid]
    if kind == "mixed":
        junk = np.array([n, -1, -7, n + 3, 10 * n])
        ids[n_valid:] = junk[rs.randint(0, junk.size, R - n_valid)]
        ids = ids[rs.permutation(R)]
    valid = (ids >= 0) & (ids < n)
    grads = rs.randn(R, D).astype(np.float32)
    grads[~valid] = np.nan
    grads = torch.from_numpy(grads).to(grad_dtype or torch.float32)
    return table, slots, torch.from_numpy(ids).to(id_dtype), grads


def parent_step_rows(table, slots, ids, grads, opt, step, lr):
    """The composition ``Embedding._step_rows`` ran before kernel L, on
    what ``apply_gradients`` handed it: invalid slots as padding ``n`` with
    zero gradients; kernel A's plain gather of the table (widened) and of
    each slot, ``update``, kernel B's plain scatter."""
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    uids = torch.where(valid, ids, n)
    ugrads = torch.where(valid[:, None], grads.float(), 0.0)
    valid = uids < n
    take_idx = torch.where(valid, uids, 0)
    names = tuple(sorted(slots))
    rows = gather_rows_plain(table, take_idx).float()
    srows = {s: gather_rows_plain(slots[s], take_idx) for s in names}
    new_rows, new_srows = opt.update(rows, ugrads, srows, step, lr)
    write_idx = torch.where(valid, uids, -1)
    scatter_rows_plain(table, write_idx, new_rows.to(table.dtype).contiguous())
    for s in names:
        scatter_rows_plain(slots[s], write_idx, new_srows[s].contiguous())


def bits(t):
    """The tensor's bits, NaN payloads and -0 included."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def copies(table, slots):
    return table.clone(), {k: v.clone() for k, v in slots.items()}


@pytest.mark.parametrize("kind", APPLY_KINDS)
@pytest.mark.parametrize("D", APPLY_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_apply_rows_plain_is_the_parent_composition(name, dtype, D, kind):
    opt = APPLY_OPTS[name]
    table, slots, ids, grads = apply_case(opt, dtype, D, kind)
    t1, s1 = copies(table, slots)
    t2, s2 = copies(table, slots)
    L.apply_rows_plain(t1, s1, ids, grads, opt, APPLY_STEP, APPLY_LR)
    parent_step_rows(t2, s2, ids, grads, opt, APPLY_STEP, APPLY_LR)
    assert same_bits(t1, t2) and all(same_bits(s1[k], s2[k]) for k in slots)
    valid = ((ids >= 0) & (ids < APPLY_ROWS)).numpy()
    untouched = np.ones(APPLY_ROWS, bool)
    untouched[ids.numpy()[valid]] = False
    assert same_bits(t1[untouched], table[untouched])  # row 0 and every other stay
    if valid.any():
        assert not torch.equal(t1[ids[valid]], table[ids[valid]])


@pytest.mark.parametrize("name", ["lazy_adam", "adam_w", "rms_prop"])
@pytest.mark.parametrize("grad_dtype,id_dtype", [(torch.bfloat16, torch.int32),
                                                 (torch.float32, torch.int32)])
def test_apply_rows_plain_takes_bf16_gradients_and_int32_ids(name, grad_dtype, id_dtype):
    """bf16 gradients (a bf16 table's rows' gradients) widen exactly, as
    ``.float()``; int32 ids are the sampler's."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads = apply_case(opt, torch.bfloat16, 64, "mixed", seed=1,
                                          grad_dtype=grad_dtype, id_dtype=id_dtype)
    t1, s1 = copies(table, slots)
    t2, s2 = copies(table, slots)
    L.apply_rows_plain(t1, s1, ids, grads, opt, 7, APPLY_LR)
    parent_step_rows(t2, s2, ids, grads, opt, 7, APPLY_LR)
    assert same_bits(t1, t2) and all(same_bits(s1[k], s2[k]) for k in slots)


@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_apply_rows_on_the_cpu_is_its_plain_version(name, monkeypatch):
    """On CPU tensors the wrapper runs the plain version, whatever the route."""
    opt = APPLY_OPTS[name]
    table, slots, ids, grads = apply_case(opt, torch.float32, 16, "mixed", seed=2)
    seen = []
    plain = L.apply_rows_plain
    monkeypatch.setattr(L, "apply_rows_plain", lambda *a: seen.append(1) or plain(*a))
    t1, s1 = copies(table, slots)
    t2, s2 = copies(table, slots)
    L.apply_rows(t1, s1, ids, grads, opt, APPLY_STEP, APPLY_LR)
    plain(t2, s2, ids, grads, opt, APPLY_STEP, APPLY_LR)
    assert seen == [1]
    assert same_bits(t1, t2) and all(same_bits(s1[k], s2[k]) for k in slots)


@pytest.mark.parametrize("row_bytes,tile", [
    (0, 512), (4, 512), (64, 512), (128, 256), (192, 170), (256, 128), (1024, 32),
    (1028, 31), (4096, 8), (32768, 1), (10 ** 6, 1)])
def test_apply_tile(row_bytes, tile):
    """32 KB of f32 rows a CTA were all its slots valid, 1 to 512 slots."""
    assert L.apply_tile(row_bytes) == tile


@pytest.mark.parametrize("step", [1, 2, 17, 1000, 10 ** 6])
def test_lazy_adam_kernel_scalars_are_its_card_step_table_row(step):
    """An eager step's two scalars are what ``step_table`` holds for that
    step on a card (``step_rows(card=True)``): the f32 reciprocals of the
    corrections, computed on the host, bit for bit; the CPU's table holds
    the corrections themselves."""
    for opt in (APPLY_OPTS["lazy_adam"], APPLY_OPTS["adam_w"], LazyAdam(beta1=0.8, beta2=0.95)):
        code, floats, row = L.kernel_params(opt, step, APPLY_LR)
        assert row is None
        assert code == (L.OPT_ADAMW if opt.adam_w else L.OPT_ADAM)
        card = opt.step_rows([step], card=True)[0]
        c1, c2 = (np.float32(x) for x in opt.corrections(step))
        assert np.float32(floats[7]).view(np.int32) == card[0].view(np.int32)
        assert np.float32(floats[8]).view(np.int32) == card[1].view(np.int32)
        assert card[0] == np.float32(1.0) / c1 and card[1] == np.float32(1.0) / c2
        cpu = opt.step_table([step], "cpu")[0].numpy()
        assert cpu[0] == c1 and cpu[1] == c2


def test_kernel_scalars_are_the_plain_route_f32_values():
    """Each hyperparameter as ATen takes a Python float beside an f32
    tensor (rounded to f32), ``1 - beta`` computed in Python first; a
    ``step_table`` row passes through to be read on the card."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    opt = LazyAdam(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01)
    _, floats, _ = L.kernel_params(opt, 5, 0.003)
    assert floats[:7] == (f32(0.003), f32(0.01), f32(0.9), f32(1.0 - 0.9), f32(0.999),
                          f32(1.0 - 0.999), f32(1e-8))
    row = torch.tensor([2.0, 3.0])
    _, floats, got = L.kernel_params(opt, row, 0.003)
    assert got is row and floats[7:] == (0.0, 0.0)
    code, floats, _ = L.kernel_params(RMSProp(alpha=0.95, weight_decay=0.1), 5, 0.1)
    assert code == L.OPT_RMSPROP
    assert floats[2:4] == (f32(0.95), f32(1.0 - 0.95)) and floats[1] == f32(0.1)
    assert L.kernel_params(AdaGrad(), 5, 0.1)[0] == L.OPT_ADAGRAD
    assert L.kernel_params(SGD(), 5, 0.1)[0] == L.OPT_SGD
    with pytest.raises(Exception):
        L.kernel_params(opt, torch.tensor([1.0, 2.0, 3.0]), 0.1)


class ScaledSGD(SGD):
    """A subclass from outside the registry with its own update."""

    def update(self, rows, grads, slots, step, lr):
        return rows - 2.0 * lr * grads, slots


def test_route_by_optimizer_type():
    """Each registry optimizer runs kernel L; a subclass from outside runs
    A, its own update, B; the type alone chooses."""
    for name in ("sgd", "lazy_adam", "adam", "rms_prop", "rmsprop", "ada_grad", "adagrad"):
        assert L.apply_route(create_optimizer(name)) == "fused", name
    assert L.apply_route(LazyAdam(adam_w=True)) == "fused"
    assert L.apply_route(ScaledSGD()) == "composed"
    with pytest.raises(ValueError):
        L.kernel_params(ScaledSGD(), 1, 0.1)


def test_a_foreign_optimizer_runs_its_own_update_on_the_cpu():
    table, slots, ids, grads = apply_case(SGD(), torch.float32, 8, "mixed", seed=3)
    t = table.clone()
    L.apply_rows(t, {}, ids, grads, ScaledSGD(), 1, 0.5)
    valid = (ids >= 0) & (ids < APPLY_ROWS)
    assert torch.equal(t[ids[valid]], table[ids[valid]] - 2.0 * 0.5 * grads[valid])


@pytest.mark.parametrize("unique", [False, True])
def test_embedding_apply_runs_the_plain_route_once_a_chunk(unique, monkeypatch):
    """``Embedding.apply_gradients`` on the CPU reaches ``apply_rows``'s
    plain version once a ``_step_rows``; with ``assume_unique`` the masked
    slots' gradients are never read (NaN there changes nothing)."""
    rs = np.random.RandomState(4)
    n, D, B = 5000, 16, 3000
    init = rs.randn(n, D).astype(np.float32)
    ids = torch.from_numpy(rs.permutation(n)[:B].astype(np.int32))
    mask = torch.from_numpy(rs.rand(B) < 0.7)
    grads = torch.from_numpy(rs.randn(B, D).astype(np.float32))
    seen = []
    plain = L.apply_rows_plain
    monkeypatch.setattr(L, "apply_rows_plain", lambda *a: seen.append(a[2].numel()) or plain(*a))
    ea = Embedding.create(n, D, optimizer=LazyAdam(), device="cpu").from_array(init)
    eb = Embedding.create(n, D, optimizer=LazyAdam(), device="cpu").from_array(init)
    ea.apply_gradients(ids, grads, 0.01, mask=mask, assume_unique=unique, unique_chunk=1024)
    assert len(seen) >= 2 and all(r <= 1024 for r in seen)
    noisy = torch.where(mask[:, None], grads, torch.nan)
    eb.apply_gradients(ids, noisy, 0.01, mask=mask, assume_unique=unique)
    assert np.array_equal(ea.to_array(), eb.to_array())
    assert all(np.array_equal(ea.slot_to_array(s), eb.slot_to_array(s)) for s in ("m", "v"))


def test_step_rows_reaches_apply_rows_with_padding_skipped():
    """``_step_rows`` hands its padding (ids equal to ``n``) to the apply,
    which skips it: row 0 and its m and v stay."""
    e = Embedding.create(10, 4, optimizer=LazyAdam(), device="cpu").from_array(
        np.ones((10, 4), np.float32))
    uids = torch.tensor([3, 10, 10, 7])
    e._step_rows(uids, torch.ones(4, 4), 0.1, 1)
    t = e.to_array()
    assert (t[[0, 1, 2, 4, 5, 6, 8, 9]] == 1.0).all() and (t[[3, 7]] < 1.0).all()
    assert (e.slot_to_array("m")[0] == 0.0).all()
    assert temb.apply_rows is L.apply_rows


@pytest.mark.parametrize("name", list(APPLY_OPTS))
def test_plain_update_matches_the_jax_optimizers(name):
    """The plain route's rows against the JAX package's optimizer ``update``
    on the same rows (numpy inputs): within 4 f32 ulps of the operands'
    size (the value before, the value after and the step's ``lr``): XLA may
    fuse and order the same f32 operations otherwise, and ``p - lr * u``
    cancels where the two are close."""
    import jax.numpy as jnp

    from wholegraph_tpu.embedding import optimizers as jopt

    opt = APPLY_OPTS[name]
    jo = {SGD: jopt.SGD, LazyAdam: jopt.LazyAdam, RMSProp: jopt.RMSProp,
          AdaGrad: jopt.AdaGrad}[type(opt)](**{k: v for k, v in vars(opt).items()
                                                if k != "name"})
    table, slots, ids, grads = apply_case(opt, torch.float32, 32, "padded", seed=5)
    t, s = copies(table, slots)
    L.apply_rows_plain(t, s, ids, grads, opt, APPLY_STEP, APPLY_LR)
    valid = (ids < APPLY_ROWS).numpy()
    rows = ids.numpy()[valid]
    g = grads.numpy()[valid]
    jr, js = jo.update(jnp.asarray(table.numpy()[rows]), jnp.asarray(g),
                       {k: jnp.asarray(v.numpy()[rows]) for k, v in slots.items()},
                       jnp.asarray(APPLY_STEP, jnp.int32), APPLY_LR)
    for got, want, before in [(t.numpy()[rows], np.asarray(jr), table.numpy()[rows])] + [
            (s[k].numpy()[rows], np.asarray(js[k]), slots[k].numpy()[rows]) for k in slots]:
        scale = np.abs(want) + np.abs(before) + APPLY_LR  # the operands' size, not the result's
        assert (np.abs(got - want) <= 4 * np.finfo(np.float32).eps * scale).all()
