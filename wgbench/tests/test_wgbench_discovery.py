"""The harness finds every cell's parts by name, and a cell, a mix, a mode,
a metric and a configuration with its build added as files alone run
without an edit to any file already there."""

import json
import os
import shutil

import pytest

from wgbench import spec
from wgbench.metrics import counts as C
from wgbench.tests.tiny import tiny_tree

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", spec.cells(BENCH))
def test_every_cell_finds_its_parts(name):
    cell = spec.Cell(BENCH, name)
    assert cell.config["name"] == cell.entry["config"]
    mod = cell.mode()
    assert callable(mod.Runner) and callable(mod.reference_record) and callable(mod.compare)
    build = cell.build()
    assert all(callable(getattr(build, f)) for f in ("make_inputs", "Built", "train_flops",
                                                     "infer_flops", "tiny"))
    assert set(cell.limits["limits"]) and all(v > 0 for v in cell.limits["limits"].values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_what_benchmark_json_says(entry):
    with open(os.path.join(spec.root_of(), entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["chips"] == 1


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends and set(m) <= {"name", "unit", "better", "source", "layer",
                                                 "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"] + BENCH["configs"])


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new mix (training in batches of 32), its cell, its limits and a new
    per-layer metric, each a file; a copy of BENCHMARK.json lists them."""
    here = tiny_tree(str(tmp_path))
    with open(os.path.join(here, "workloads", "train-b32.json"), "w") as f:
        json.dump({"mode": "train_epoch", "split": "train", "batch": 32, "shuffle": True,
                   "drop_last": True}, f)
    shutil.copy(os.path.join(here, "limits", "sage-products.train.json"),
                os.path.join(here, "limits", "sage-products.train-b32.json"))
    with open(os.path.join(here, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.window['steps']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sage-products.train-b32", "config": "sage-products",
                               "traffic": "train-b32", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_seeds_per_s":
            m["workloads"].append("sage-products.train-b32")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "train_seeds_per_s",
                               "workloads": ["sage-products.train-b32"]})
    cell = spec.Cell(bench, "sage-products.train-b32", here=here)
    from wgbench.run import run_cell

    res = run_cell(cell, 5, 0.2, True, device="cpu", t0=0.0)
    assert res["correct"]
    assert res["metrics"]["steps_seen"]["value"] == res["attempted"] > 0
    assert res["attempted"] % (640 // 32) == 0  # whole passes of 20 batches


def test_a_mode_added_as_a_file_alone_runs(tmp_path):
    """A new mode (the full-graph pass over a plan made without windows), a
    mix naming it, its cell and its limits, each a file."""
    here = tiny_tree(str(tmp_path))
    with open(os.path.join(here, "modes", "full_graph_infer.py")) as f:
        src = f.read()
    assert "to_full_graph(windowed=True)" in src
    with open(os.path.join(here, "modes", "full_graph_unplanned.py"), "w") as f:
        f.write(src.replace("to_full_graph(windowed=True)", "to_full_graph(windowed=False)"))
    with open(os.path.join(here, "workloads", "fullgraph-unplanned.json"), "w") as f:
        json.dump({"mode": "full_graph_unplanned"}, f)
    shutil.copy(os.path.join(here, "limits", "sage-products.fullgraph.json"),
                os.path.join(here, "limits", "sage-products.fullgraph-unplanned.json"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sage-products.fullgraph-unplanned",
                               "config": "sage-products", "traffic": "fullgraph-unplanned",
                               "chips": 1, "why": "test"})
    cell = spec.Cell(bench, "sage-products.fullgraph-unplanned", here=here)
    assert cell.mode().__file__.startswith(here)
    from wgbench.run import run_cell

    res = run_cell(cell, 5, 0.2, False, device="cpu", t0=0.0)
    assert res["correct"] and res["attempted"] > 0


# A build of the test's own: a linear classifier over rows of its own, none
# of the homogeneous build's graph, features or weights.
TOY_BUILD = """
import time

import torch

from wgbench.inputs import derive

COUNTED = {counted}
FLOPS = 123456789
SEEN = {{}}


def make_inputs(cfg, seed, device):
    dev = torch.device(device)
    n, d, k = int(cfg["rows"]), int(cfg["width"]), int(cfg["classes"])
    g = torch.Generator(device=dev)
    g.manual_seed(derive(seed, 0x70))
    rows = torch.randn((n, d), generator=g, device=dev)
    w0 = torch.randn((d, k), generator=g, device=dev) / d ** 0.5
    labels = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
    perm = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    return {{"rows": rows, "w0": w0, "labels": labels,
             "splits": {{"train": perm[: n // 2], "test": perm[n // 2:]}}}}


class Built:
    def __init__(self, cfg, mix, inputs, device):
        t0 = time.perf_counter()
        self.rows = inputs["rows"]
        self.w = inputs["w0"].clone().requires_grad_()
        self.opt = torch.optim.SGD([self.w], lr=float(cfg["lr"]))
        self.times = {{"model": time.perf_counter() - t0}}

    def leaves(self):
        return {{"w": self.w}}


def train_flops(ctx):
    if ctx.mode_name != "toy_sgd" or not COUNTED:
        return None
    SEEN["seconds_per_unit"] = ctx.seconds_per_unit()
    return FLOPS


def infer_flops(ctx):
    return None


def tiny(cfg):
    return dict(cfg)
"""

# Its mode: plain SGD steps on the build's objects, the losses of the first
# steps compared with a reference that takes the gradient by hand.
TOY_MODE = """
import time

import torch

from wgbench.program import Mode
from wgbench.traffic import Traffic

CHECKED = 4
FAULTS = {}


class Runner(Mode):
    UNIT = "step"

    def step(self, i):
        b = self.built
        c, y = self.traffic.batch_at(i)
        loss = torch.nn.functional.cross_entropy(b.rows[c.long()] @ b.w, y.long())
        b.opt.zero_grad()
        loss.backward()
        b.opt.step()
        return float(loss.detach())

    def setup(self):
        self.check = {"losses": [self.step(i) for i in range(CHECKED)]}
        self.next = CHECKED

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.step(self.next)
            self.next, n = self.next + 1, n + 1
        dt = time.perf_counter() - t0
        batch = self.traffic.batch
        return {"seconds": dt, "steps": n, "attempted": n, "units": n * batch,
                "train_seeds_per_s": n * batch / dt}


def reference_record(cfg, mix, seed, ref, check, precision="float32"):
    tr = Traffic(mix, seed, ref["splits"][mix["split"]], ref["labels"])
    w, losses = ref["w0"].clone(), []
    for i in range(len(check["losses"])):
        c, y = tr.batch_at(i)
        x = ref["rows"][c.long()]
        p = torch.softmax(x @ w, dim=1)
        at = torch.arange(y.shape[0])
        losses.append(float(-p[at, y.long()].log().mean()))
        p[at, y.long()] -= 1.0
        w -= float(cfg["lr"]) * (x.t() @ p) / y.shape[0]
    return {"losses": losses}


def compare(program, reference):
    gaps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])]
    return {"numbers": {"loss": max(gaps)}}
"""


@pytest.mark.parametrize("counted", [True, False], ids=["counted", "uncounted"])
def test_a_configuration_added_as_files_alone_runs(tmp_path, counted):
    """A new build, a configuration naming it, a mix and a mode that read the
    build's objects, and the cell's limits, each a new file; a copy of
    BENCHMARK.json lists them. ``train_mfu`` reads the build's own count, and
    nothing where the build counts nothing."""
    here = tiny_tree(str(tmp_path))
    files = {
        ("builds", "toy_linear.py"): TOY_BUILD.format(counted=counted),
        ("modes", "toy_sgd.py"): TOY_MODE,
        ("configs", "toy-linear.json"): json.dumps(
            {"name": "toy-linear", "build": "toy_linear", "source": "test", "reduced": [],
             "chips": 1, "rows": 512, "width": 6, "classes": 3, "lr": 0.5}),
        ("workloads", "toy-train.json"): json.dumps(
            {"mode": "toy_sgd", "split": "train", "batch": 32, "shuffle": True,
             "drop_last": True}),
        ("limits", "toy-linear.toy-train.json"): json.dumps({"limits": {"loss": 1e-5}}),
    }
    for (sub, name), text in files.items():
        path = os.path.join(here, sub, name)
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy-linear", "source": "test",
                             "file": "wgbench/configs/toy-linear.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "toy-linear.toy-train", "config": "toy-linear",
                               "traffic": "toy-train", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_seeds_per_s", "train_mfu"):
            m["workloads"].append("toy-linear.toy-train")
    cell = spec.Cell(bench, "toy-linear.toy-train", here=here)
    build = cell.build()
    assert build.__file__.startswith(here)
    inputs = build.make_inputs(cell.config, 5, "cpu")
    assert not {"row_ptr", "col", "features", "weights"} & set(inputs)
    from wgbench.run import run_cell

    res = run_cell(cell, 5, 0.2, True, device="cpu", t0=0.0)
    assert res["correct"] and res["attempted"] > 0
    assert res["checks"]["loss"]["value"] < 1e-5
    if counted:
        want = 100.0 * build.FLOPS / build.SEEN["seconds_per_unit"] / C.F32_FLOPS_PER_S
        assert res["metrics"]["train_mfu"]["value"] == pytest.approx(want, rel=1e-12)
    else:
        assert "train_mfu" not in res["metrics"] and not build.SEEN


def test_a_configuration_without_a_build_is_refused(tmp_path):
    here = tiny_tree(str(tmp_path))
    path = os.path.join(here, "configs", "sage-products.json")
    with open(path) as f:
        cfg = json.load(f)
    del cfg["build"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="'build'"):
        spec.Cell(BENCH, "sage-products.train", here=here)
