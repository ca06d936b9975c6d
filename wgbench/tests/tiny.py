"""A tiny copy of the benchmark's data files, for runs on the CPU."""

import json
import os
import shutil

from wgbench import spec

TINY = {
    "nodes": 3000, "undirected_edges": 24000, "feat_dim": 8, "num_classes": 5, "hidden": 16,
    "splits": {"train": 640, "valid": 160, "test": 2200},
    "graph": {"model": "chung_lu", "degree_exponent": 2.5, "max_expected_degree": 150},
}
TINY_FANOUTS = {"sage": [4, 3, 2], "gat": [3, 3]}
TINY_MIX = {"train": {"batch": 64}, "infer": {"batch": 128, "compare_batches": 3,
                                               "compare_from_first": 6}}


def tiny_tree(dst: str) -> str:
    """A copy of ``wgbench``'s data files and readers under ``dst`` with every
    configuration and mix shrunk; returns the copy's ``here``."""
    here = os.path.join(dst, "wgbench")
    for sub in ("configs", "workloads", "limits", "metrics", "modes"):
        shutil.copytree(os.path.join(spec.HERE, sub), os.path.join(here, sub))
    for sub, table in (("configs", None), ("workloads", TINY_MIX)):
        for f in os.listdir(os.path.join(here, sub)):
            path = os.path.join(here, sub, f)
            with open(path) as fh:
                d = json.load(fh)
            if sub == "configs":
                d.update(TINY)
                d["fanouts"] = TINY_FANOUTS[d["model"]]
            else:
                d.update(table.get(f[:-5], {}))
            with open(path, "w") as fh:
                json.dump(d, fh)
    return here


def tiny_cell(dst: str, name: str) -> "spec.Cell":
    return spec.Cell(spec.load_benchmark(), name, here=tiny_tree(dst))
