"""The comparison that decides ``correct`` fails what it must: the control
(the reference with its products in TF32 in the port's place), and a run
whose timed path is broken underneath, once for each fault a cell can
have. The runs are the cells' own at a tiny size on the CPU: the look for
a card is skipped, the rest of a run is driven."""

import pytest
import torch

from wgbench import check
from wgbench.run import run_cell
from wgbench.tests.tiny import tiny_cell

CELLS = ["sage-products.train", "gat-products-emb.train", "sage-products.infer",
         "sage-products.fullgraph"]


def _run(tmp_path, name, seed=21):
    return run_cell(tiny_cell(str(tmp_path), name), seed, 0.2, False, device="cpu", t0=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(tmp_path, name):
    assert _run(tmp_path, name)["correct"]


def test_compared_batches_past_the_window_are_judged(tmp_path):
    """A window that closes after its first batch still judges every compared
    batch: those it did not reach run after it, untimed, and are late, not
    missing (a missing one would read an infinite gap)."""
    res = run_cell(tiny_cell(str(tmp_path), "sage-products.infer"), 21, 0.0, False,
                   device="cpu", t0=0.0)
    assert res["attempted"] == 1
    assert res["correct"] and res["checks"]["logit_gap"]["value"] < 1e-4


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tmp_path, name):
    cell = tiny_cell(str(tmp_path), name)
    mod, make, seed = cell.mode(), cell.build().make_inputs, 23
    dev = torch.device("cpu")
    steps = getattr(mod, "CHECKED", 0) + getattr(mod, "CAPTURED_COMPARED", 0)
    prog = {"losses": [0.0] * steps, "saved": {i: None for i in range(int(cell.mix.get(
        "compare_batches", 0)))}}
    f32 = mod.reference_record(cell.config, cell.mix, seed, make(cell.config, seed, dev), prog)
    tf32 = mod.reference_record(cell.config, cell.mix, seed, make(cell.config, seed, dev), prog,
                                "tf32")
    ok, _, _ = check.judge(mod.compare(tf32, f32)["numbers"], cell.limits["limits"])
    assert not ok


def _unchanged(monkeypatch):
    from wholegraph_tpu_torch.embedding import Embedding

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(Embedding, "apply_gradients", lambda self, *a, **k: self)


def _half_batch(monkeypatch):
    import wholegraph_tpu_torch.train as wt

    real = wt.cross_entropy_loss
    monkeypatch.setattr(wt, "cross_entropy_loss",
                        lambda logits, labels, mask=None: real(logits[: logits.shape[0] // 2],
                                                               labels[: labels.shape[0] // 2]))


def _altered(monkeypatch):
    from wholegraph_tpu_torch.models import HomoGNN

    real = HomoGNN.forward

    def forward(self, *a, **k):
        out = real(self, *a, **k)
        return out + torch.nn.functional.one_hot(torch.tensor(0), out.numel()).view_as(out)

    monkeypatch.setattr(HomoGNN, "forward", forward)


FAULTS = [("sage-products.train", _unchanged), ("gat-products-emb.train", _unchanged),
          ("sage-products.train", _half_batch), ("gat-products-emb.train", _half_batch),
          ("sage-products.train", _altered), ("gat-products-emb.train", _altered),
          ("sage-products.infer", _altered), ("sage-products.fullgraph", _altered)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    fault(monkeypatch)
    assert not _run(tmp_path, name)["correct"]
