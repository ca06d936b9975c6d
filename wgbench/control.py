"""Readings that set a cell's correctness limits, on the chip at the cell's
own size: the port's numbers on many seeds (the lower reading), the
control's (the reference with its products in TF32 in the port's place)
and, for training, a planted fault (the reference on half of each batch,
its mean over the rest) on some of them (the upper readings).

  python3 -m wgbench.control --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3

The port runs as a run does: its set-up (the checked first steps where it
trains) and what the mode's ``control_record`` adds (for sampled inference
the window's batches up to the last one a run compares); no measured
window. The faults are those the mode's ``FAULTS`` names. One JSON line a
seed.
"""

import argparse
import gc
import json
import sys
import time

import torch

from . import spec
from .run import Run, cache_dirs


def program_record(cell, seed: int, dev) -> dict:
    run = Run(cell, seed, dev)
    run.make()
    mode = cell.mode().Runner(run)
    mode.setup()
    rec = mode.control_record()
    del mode, run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _reading(found: dict) -> dict:
    """What a line keeps of a comparison: its numbers and a training mode's per-leaf look."""
    out = {"numbers": found["numbers"]}
    if isinstance(found.get("detail"), dict):
        out["detail"] = found["detail"]
    return out


def readings(cell, seed: int, with_control: bool, dev) -> dict:
    mod, make = cell.mode(), cell.build().make_inputs
    cfg, mix = cell.config, cell.mix
    t0 = time.perf_counter()
    prog = program_record(cell, seed, dev)
    f32 = mod.reference_record(cfg, mix, seed, make(cfg, seed, dev), prog)
    out = {"seed": seed, "program": _reading(mod.compare(prog, f32))}
    if with_control:
        tf32 = mod.reference_record(cfg, mix, seed, make(cfg, seed, dev), prog, "tf32")
        out["control_tf32"] = _reading(mod.compare(tf32, f32))
        for name, fault in mod.FAULTS.items():
            bad = mod.reference_record(cfg, mix, seed, make(cfg, seed, dev), prog, **fault)
            out["fault_" + name] = _reading(mod.compare(bad, f32))
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache_dirs(spec.root_of())
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    dev = torch.device(args.device)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(x) for x in args.seeds.split(",")]:
        print(json.dumps({"cell": cell.name, **readings(cell, s, s in ctrl, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
