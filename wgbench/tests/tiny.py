"""A tiny copy of the benchmark's data files, for runs on the CPU."""

import json
import os
import shutil

from wgbench import spec
from wgbench.program import load_build

TINY_MIX = {"train": {"batch": 64}, "infer": {"batch": 128, "compare_batches": 3,
                                               "compare_from_first": 6}}


def tiny_tree(dst: str) -> str:
    """A copy of ``wgbench``'s data files, builds and readers under ``dst``
    with every configuration shrunk by its build's ``tiny`` and every mix
    by :data:`TINY_MIX`; returns the copy's ``here``."""
    here = os.path.join(dst, "wgbench")
    for sub in ("builds", "configs", "workloads", "limits", "metrics", "modes"):
        shutil.copytree(os.path.join(spec.HERE, sub), os.path.join(here, sub))
    for sub in ("configs", "workloads"):
        for f in os.listdir(os.path.join(here, sub)):
            path = os.path.join(here, sub, f)
            with open(path) as fh:
                d = json.load(fh)
            if sub == "configs":
                d = load_build(d["build"], here).tiny(d)
            else:
                d.update(TINY_MIX.get(f[:-5], {}))
            with open(path, "w") as fh:
                json.dump(d, fh)
    return here


def tiny_cell(dst: str, name: str) -> "spec.Cell":
    return spec.Cell(spec.load_benchmark(), name, here=tiny_tree(dst))
