"""The cost of the port's tracing when it is on: a cell's unit of work (the
one its ``timelines/<mode>.py`` traces: a training pass, the traced run of
evaluation batches, a full-graph pass) timed with and without a
``utils.perf.Timeline`` active, in turns on one card.

  python3 -m wgbench.timeline_cost --workload <cell> --seed <n> [--pairs 3]

Set-up is the benchmark's (``run.run_cell``'s inputs, build and the mode's
set-up). A training pass replays a CUDA graph of the step, and a graph
captured inside a Timeline is replayed only inside it, so each switch
between the two runs one untimed unit (for a training pass, the one that
captures the step again); the timed units that follow replay it. Turns go off, on, on, off, ... (one
pair is one of each). Each time is the host clock over the work, the card
synchronised before and after. Prints one JSON line with every turn's
seconds, the medians and the median's overhead in %, beside the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    from . import inputs as I, program, spec
    from .metrics import _timeline as T
    from .run import Run, cache_dirs, card_state

    cache_dirs(spec.root_of())
    import torch
    from wholegraph_tpu_torch.utils import perf

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    run = Run(cell, args.seed, "cuda")
    run.inputs = I.make_all(run.cfg, run.seed, run.device)
    run.built = program.Built(run.cfg, run.mix, run.inputs, run.device)
    mode = cell.mode().Runner(run)
    mode.setup()
    unit, what = T.unit_of(run.mix["mode"]).unit(mode)
    tl = perf.Timeline(1 << 20, run.device)
    turns = {"off": [], "on": []}
    last = None
    order = ["off", "on", "on", "off"] * ((args.pairs + 1) // 2)
    for side in order[:2 * args.pairs]:
        with tl if side == "on" else contextlib.nullcontext():
            if side != last:
                unit()  # untimed: a training pass captures the step again for this side
            turns[side].append(_timed(unit))
        last = side
    tl.read()
    med = {k: statistics.median(v) for k, v in turns.items()}
    out = {"cell": args.workload, "unit": what,
           "seconds": turns, "median_s": med,
           "overhead_pct": 100.0 * (med["on"] / med["off"] - 1.0),
           "stamps": int(tl.buf[0, 0]), "dropped": tl.dropped, "card": card_state()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
