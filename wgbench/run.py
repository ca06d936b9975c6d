"""Run one cell of ``BENCHMARK.json`` on this machine and print its result.

  python3 -m wgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start to the window's start) makes the inputs
on the card from the seed and builds the port's objects, both by the build
the cell's configuration names (``builds/<build>.py``), runs the mode's
checked first steps and warms up every shape the window uses. The window
then measures for ``--seconds``. With ``--trace 1`` a profiled window and
the per-layer readers follow. Then the port's state is freed and the plain
reference judges what the timed path produced. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit); the same numbers are
the last lines of standard error. The run exits non-zero without a result
when there is no card or too few, and when a module of JAX, flax or the
JAX package is loaded at its end.
"""

import time

T0 = time.perf_counter()  # set-up runs from here, before any heavy import

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wholegraph_tpu")
GIB = float(1 << 30)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``wholegraph_tpu_torch`` is the port, not the JAX package)."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed place inside the checkout (the
    port's kernels build into ``wholegraph_tpu_torch/_build/`` on their own)."""
    base = os.path.join(root, "wgbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def card_state() -> str:
    """The card's clocks, power, temperature and throttle reasons, as
    ``nvidia-smi`` reads them (outside the window; "not read" without it)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,"
                              "power.draw,temperature.gpu,clocks_throttle_reasons.active",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Run:
    """One run of one cell on one device, and the build the cell names."""

    def __init__(self, cell, seed: int, device):
        import torch
        self.cell, self.cfg, self.mix = cell, cell.config, cell.mix
        self.build = cell.build()
        self.seed = int(seed)
        self.device = torch.device(device)

    def make(self) -> None:
        """The inputs, then the port's objects, by the cell's build."""
        self.inputs = self.build.make_inputs(self.cfg, self.seed, self.device)
        self.built = self.build.Built(self.cfg, self.mix, self.inputs, self.device)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None) -> Dict:
    """The whole run; returns the result's fields and ``lines`` for standard
    error. On the CPU (tests) the same path runs with the port's plain
    versions, and device metrics are left out."""
    import torch

    from . import check
    from .metrics.context import ReadContext

    t0 = T0 if t0 is None else t0
    torch.backends.cuda.matmul.allow_tf32 = False  # the port's float32, as PyTorch's default
    run = Run(cell, seed, device)
    dev = run.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
    cfg, mix = run.cfg, run.mix
    marks = [("start", time.perf_counter())]
    run.inputs = run.build.make_inputs(cfg, run.seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("inputs", time.perf_counter()))
    run.built = run.build.Built(cfg, mix, run.inputs, dev)
    mode_mod = cell.mode()
    mode = mode_mod.Runner(run)
    marks.append(("build", time.perf_counter()))
    mode.setup()
    marks.append(("mode setup", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    parts = [f"{name} {b - a:.3f}" for (_, a), (name, b) in zip([("", t0)] + marks, marks)]
    _say(f"[setup] {setup_s:.3f} s ({', '.join(parts)} s), mode {mix['mode']}; build: "
         + ", ".join(f"{k} {v:.3f}" for k, v in run.built.times.items())
         + mode.notes)
    _say(f"[card before] {card_state()}")
    win = mode.window(seconds)
    _say(f"[card after] {card_state()}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    _say(f"[window] {json.dumps(win)}")
    result: Dict = {"metrics": {}, "device": {}}
    if cuda:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                            "count": 1, "memory_peak_bytes": int(peak)}
    values = {"setup_s": setup_s, "peak_device_gib": peak / GIB, **win}
    if trace:
        ctx = ReadContext(run, mode, win)
        if cuda:
            ctx.trace()
            prof = ctx.profile
            result["device"]["busy_s"] = prof["busy_s"] if prof else 0.0
            result["device"]["window_s"] = prof["window_s"] if prof else 0.0
            if prof:
                result["breakdown"] = {"device_ops": prof["device_ops"],
                                       "idle_gaps": prof["idle_gaps"]}
            _say(f"[kernels] a {ctx.unit_name}: {ctx.kernels_by_graph} by its CUDA graph's "
                 f"kernel nodes, {ctx.kernels_by_profiler} seen by the profiler")
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        ctx.close()
    else:
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                                "unit": m["unit"]}
    # the port's state goes before the reference runs
    chk = mode.check
    del mode, run.built, run.inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = check.reference_numbers(mode_mod, run.build, cfg, mix, run.seed, chk, dev)
    correct, checks, others = check.judge(ref["numbers"], cell.limits["limits"])
    result["correct"] = bool(correct)
    result["attempted"] = int(win["attempted"])
    result["failed"] = 0 if correct else 1
    result["checks"] = checks
    lines = [f"{k}: {v['value']:.6g} (limit {v['limit']})" for k, v in checks.items()]
    if others:
        lines.insert(0, "not compared: " + ", ".join(f"{k} {v:.6g}" for k, v in others.items()))
    for d in ref.get("rows", []):
        if d["rows"]:
            lines.insert(0, f"logit rows past 1e-4 of the rms: {d['rows']} of {d['of']}, "
                            f"first {d['first']}")
    if ref.get("left_out"):
        lines.insert(0, f"leaves left out (gradient under 1e-3 of the median leaf's): "
                        f"{ref['left_out']}")
    result["lines"] = lines
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import spec

    cache_dirs(spec.root_of())
    import torch

    bench = spec.load_benchmark()
    cell = spec.Cell(bench, args.workload)
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _say(f"this cell needs {need} CUDA device(s); {have} available")
        return 3
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        _say(f"modules loaded that the run must not load: {bad}")
        return 4
    lines = res.pop("lines")
    out = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    for line in lines:
        _say(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
