"""How fast the card reads rows of a pinned host table: ``python3 -m
wholegraph_tpu_torch.tools.host_read_probe [--out FILE]``.

At ``bench_host_gather``'s shapes (a 4,000,000 x 256 f32 pinned table,
2^19 slots, uniform over the table or drawn from a span of 1.25 x 2^19
rows), each slot set as drawn, sorted, and (clustered) sorted without
duplicates, it times by CUDA events:

* the read probes of ``host_read_probe.cu``: 1, 2 and 4 KB in flight per
  warp of lane loads (1 KB is kernel E's access before its redesign),
  rows staged in shared memory by 16-byte ``cp.async``, and rows fetched by
  ``cp.async.bulk`` one row or one run of adjacent rows per copy;
* kernel E as the tree has it (``host_gather_rows``);
* the yardstick: a 1 GiB pinned->card ``copy_``.

Each probe's output is held bit-equal to the rows it was asked for. Prints
one line per case (and, with ``--out``, the whole as JSON). Needs one CUDA card and
``nvcc``; the probe library is built into ``wholegraph_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from .. import kernels
from ..ops import host_kernels as H

SRC = os.path.join(os.path.dirname(__file__), "host_read_probe.cu")
MODES = {1: "lanes, 1 KB in flight per warp", 2: "lanes, 2 KB in flight per warp",
         4: "lanes, 4 KB in flight per warp", 20: "lanes, 1 KB, L2::256B prefetch size",
         10: "cp.async 16 B into shared memory",
         11: "cp.async.bulk, one row per copy", 12: "cp.async.bulk, one run per copy"}


def build() -> ctypes.CDLL:
    nvcc = kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("host_read_probe: nvcc not found")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    lib = os.path.join(kernels.BUILD_DIR, "libhost_read_probe.so")
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-o", lib, SRC], check=True)
    so = ctypes.CDLL(lib)
    so.probe_host_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    so.probe_host_read.restype = ctypes.c_int
    return so


def cuda_ms(fn, iters=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results here, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_read_probe: needs a CUDA device", file=sys.stderr)
        return 1
    so = build()
    n, dim, batch = 4_000_000, 256, 1 << 19
    rb = dim * 4
    gen = torch.Generator(device="cuda").manual_seed(11)
    table = H.pinned_empty((n, dim), torch.float32)
    table.copy_(torch.randn(n, dim, generator=gen, device="cuda"))  # rows worth comparing
    dev = torch.empty((1 << 30,), dtype=torch.uint8, device="cuda")
    host = H.pinned_empty((1 << 30,), torch.uint8).fill_(1)
    copy_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True))
    copy_gbps = (1 << 30) / copy_ms / 1e6
    del dev, host
    name = torch.cuda.get_device_name(0)
    print(f"[probe] {name}; 1 GiB pinned->card copy_ {copy_ms} ms = {copy_gbps} GB/s", flush=True)

    span = int(batch * 1.25)
    base = int(torch.randint(0, n - span, (1,), generator=gen, device="cuda"))
    uniform = torch.randint(0, n, (batch,), generator=gen, device="cuda", dtype=torch.int32)
    clustered = base + torch.randint(0, span, (batch,), generator=gen, device="cuda",
                                     dtype=torch.int32)
    sets = {"uniform": uniform, "uniform sorted": torch.sort(uniform).values,
            "clustered": clustered, "clustered sorted": torch.sort(clustered).values,
            "clustered sorted unique": torch.unique(clustered).to(torch.int32)}
    stream = torch.cuda.current_stream().cuda_stream
    tbase = table.untyped_storage().data_ptr()
    results = {"device": name, "copy_ms": copy_ms, "copy_GBps": copy_gbps, "cases": []}
    for sname, slots in sets.items():
        m = slots.numel()
        out = torch.empty((m, dim), device="cuda")
        ref = H.host_gather_rows(table, slots)
        cases = {"kernel E of the tree": lambda: H.host_gather_rows(table, slots)}
        for mode in MODES:
            def run(mode=mode):
                rc = so.probe_host_read(tbase, table.data_ptr() - tbase, slots.data_ptr(),
                                        out.data_ptr(), m, mode, stream)
                if rc:
                    raise RuntimeError(f"probe mode {mode}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"probe mode {mode} on {sname}: rows differ")
            cases[MODES[mode]] = run
        for cname, fn in cases.items():
            ms = cuda_ms(fn)
            gbps = m * rb / ms / 1e6
            r = {"slots": sname, "case": cname, "rows": m, "ms": ms, "GBps": gbps,
                 "copy_share": gbps / copy_gbps}
            results["cases"].append(r)
            print(f"[probe] {sname:24s} {cname:34s} {ms:9.4f} ms {gbps:7.2f} GB/s "
                  f"({gbps / copy_gbps:.3f} of copy_)", flush=True)
        del out, ref
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
