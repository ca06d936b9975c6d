"""The harness finds every cell's parts by name, and a cell, a mix, a mode
and a metric added as files alone run without an edit to any file already
there."""

import json
import os
import shutil

import pytest

from wgbench import spec
from wgbench.tests.tiny import tiny_tree

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", spec.cells(BENCH))
def test_every_cell_finds_its_parts(name):
    cell = spec.Cell(BENCH, name)
    assert cell.config["name"] == cell.entry["config"]
    mod = cell.mode()
    assert callable(mod.Runner) and callable(mod.reference_record) and callable(mod.compare)
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
