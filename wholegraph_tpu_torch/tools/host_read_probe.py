"""How fast the card reads rows of a pinned host table: ``python3 -m
wholegraph_tpu_torch.tools.host_read_probe [--parts lanes records] [--out FILE]``.

Part ``lanes``: at ``bench_host_gather``'s shapes (a 4,000,000 x 256 f32 pinned table,
2^19 slots, uniform over the table or drawn from a span of 1.25 x 2^19
rows), each slot set as drawn, sorted, and (clustered) sorted without
duplicates, it times by CUDA events:

* the read probes of ``host_read_probe.cu``: 1, 2 and 4 KB in flight per
  warp of lane loads (1 KB is kernel E's access before its redesign),
  rows staged in shared memory by 16-byte ``cp.async``, and rows fetched by
  ``cp.async.bulk`` one row or one run of adjacent rows per copy;
* kernel E as the tree has it (``host_gather_rows``);
* the yardstick: a 1 GiB pinned->card ``copy_``.

Part ``records`` asks whether the host tier's apply would read faster if a
row's table, m and v rows lay side by side. At the host tier's own shapes
(2,000,000 rows, 1 KB f32 parts; about 144,000 sorted unique slots, drawn
with replacement and deduplicated as the step's are) and at
``bench_host_gather``'s uniform 2^19 of 4,000,000 (its sorted unique slots),
it times by device time (:func:`~..utils.perf.measure_chain`, three rounds
in turns) the record probes of ``host_read_probe.cu``:

* (a) three 1 KB lane-load runs a slot, from three allocations;
* (b) one 3 KB run a slot, from one allocation of 3 KB records;
* (c) (a) and (b) over memory this process maps itself (anonymous ``mmap``,
  ``madvise(MADV_HUGEPAGE)``, touched, ``cudaHostRegister``ed mapped) in
  place of ``cudaHostAlloc``; it prints what
  ``/sys/kernel/mm/transparent_hugepage/enabled`` reads and the huge pages
  the process holds (``AnonHugePages`` of ``/proc/self/smaps_rollup``),
  reading both only;
* (d) the write-back alone, and the read plus write-back, of (a) and (b);

beside a 1 GiB pinned->card and card->pinned ``copy_``. The rows read are
held bit-equal to the host rows at the slots, and the rows written are
read back and compared.

Part ``tier`` replays the host-tier step's own apply call (kernel L's host
route) and gather of the misses (kernel E) over copies of its table, m and
v in ``HostEmbedding``'s own allocations (``ops.host_kernels.host_zeros``),
in ``cudaHostAlloc`` and registered memory, one allocation a table or one
for all three, of exactly their size or rounded up to 2 MiB
(TIER_MEMORIES), and in PyTorch's pinned tensors, in turns by device
time, and holds the apply's rows bit-equal across them.

Prints one line per case (and, with ``--out``, the whole as JSON). Needs one
CUDA card and ``nvcc``; the probe library is built into
``wholegraph_tpu_torch/_build/``. ``--parts`` names the parts to run (all
by default; ``records`` takes about four minutes and up to 50 GB of host
memory at once, ``tier`` about two minutes and 50 GB).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import statistics

import torch

from .. import kernels
from ..ops import host_kernels as H
from ..utils.perf import measure_chain

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
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-o", lib, SRC, "-lpthread"], check=True)
    so = ctypes.CDLL(lib)
    so.probe_host_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    so.probe_host_read.restype = ctypes.c_int
    so.probe_records.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_uint, ctypes.c_void_p]
    so.probe_alloc.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_void_p)]
    so.probe_free.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    for f in (so.probe_records, so.probe_alloc, so.probe_free):
        f.restype = ctypes.c_int
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


def copy_rates():
    """GB/s of a 1 GiB pinned->card and card->pinned ``copy_``."""
    dev = torch.empty((1 << 30,), dtype=torch.uint8, device="cuda")
    host = H.pinned_empty((1 << 30,), torch.uint8).fill_(1)
    h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True))
    d2h = cuda_ms(lambda: host.copy_(dev, non_blocking=True))
    del dev, host
    return {"h2d_ms": h2d, "h2d_GBps": (1 << 30) / h2d / 1e6,
            "d2h_ms": d2h, "d2h_GBps": (1 << 30) / d2h / 1e6}


def lanes_part(so, copy_gbps, results) -> None:
    n, dim, batch = 4_000_000, 256, 1 << 19
    rb = dim * 4
    gen = torch.Generator(device="cuda").manual_seed(11)
    table = H.pinned_empty((n, dim), torch.float32)
    table.copy_(torch.randn(n, dim, generator=gen, device="cuda"))  # rows worth comparing

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
    del table
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    getattr(torch._C, "_host_emptyCache", lambda: None)()


# ---------------------------------------------------------------------------
# records: three 1 KB parts a slot, from three allocations or one of records
# ---------------------------------------------------------------------------

PART = 1024  # bytes of one part: 256 f32
BACKINGS = {0: "cudaHostAlloc", 1: "mmap + MADV_HUGEPAGE + cudaHostRegister"}
RECORD_MODES = {0: "read", 1: "write-back alone", 2: "read + write-back"}
ROUNDS = 3  # measure_chain rounds of each case, the layouts in turns
CHAIN = 5   # calls a chain


def read_only(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable ({e})"


def huge_pages_held() -> str:
    """``AnonHugePages`` of this process (``/proc/self/smaps_rollup``)."""
    text = read_only("/proc/self/smaps_rollup")
    return next((ln.split(":", 1)[1].strip() for ln in text.splitlines()
                 if ln.startswith("AnonHugePages")), "not reported")


class HostBuffer:
    """``nbytes`` of pinned, mapped host memory from the probe library,
    as a uint8 CPU tensor (``.t``); freed by :meth:`free`."""

    def __init__(self, so, nbytes: int, backing: int):
        self.so, self.nbytes, self.backing = so, nbytes, backing
        ptr = ctypes.c_void_p()
        rc = so.probe_alloc(nbytes, backing, min(os.cpu_count() or 8, 16), ctypes.byref(ptr))
        if rc:
            raise RuntimeError(f"probe_alloc({nbytes}, {BACKINGS[backing]}): CUDA error {rc}")
        self.ptr = ptr.value
        self.t = torch.frombuffer((ctypes.c_uint8 * nbytes).from_address(self.ptr),
                                  dtype=torch.uint8)

    def free(self) -> None:
        torch.cuda.synchronize()
        del self.t
        rc = self.so.probe_free(self.ptr, self.nbytes, self.backing)
        if rc:
            raise RuntimeError(f"probe_free: CUDA error {rc}")


def fill_random(buf: torch.Tensor, gen: torch.Generator, chunk: int = 1 << 28) -> None:
    """Random bits into a uint8 host buffer, chunk by chunk from the card."""
    for lo in range(0, buf.numel(), chunk):
        hi = min(lo + chunk, buf.numel())
        bits = torch.randint(-2**31, 2**31 - 1, ((hi - lo) // 4,), generator=gen,
                             device="cuda", dtype=torch.int32)
        buf[lo:hi].copy_(bits.view(torch.uint8))
    torch.cuda.synchronize()


def record_sets(gen):
    """(name, rows, sorted unique int32 slots on the card)."""
    n_step = 2_000_000
    step = torch.unique(torch.randint(0, n_step, (149_600,), generator=gen, device="cuda"))
    n_bench = 4_000_000
    bench = torch.unique(torch.randint(0, n_bench, (1 << 19,), generator=gen, device="cuda"))
    return [("host-tier step apply", n_step, step.to(torch.int32)),
            ("bench_host_gather uniform 2^19", n_bench, bench.to(torch.int32))]


def records_part(so, link, results) -> None:
    """Cases (a)-(d) at each slot set, every layout over both backings held
    at once and timed in turns (the order rotating each round)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    thp = read_only("/sys/kernel/mm/transparent_hugepage/enabled")
    print(f"[records] /sys/kernel/mm/transparent_hugepage/enabled: {thp}; defrag: "
          f"{read_only('/sys/kernel/mm/transparent_hugepage/defrag')}", flush=True)
    results["thp_enabled"] = thp
    results["records"] = []
    for set_name, rows, slots in record_sets(gen):
        m = slots.numel()
        nbytes = m * 3 * PART  # read, and written, a call
        slots_cpu = slots.long().cpu()
        layouts, bufs = {}, []
        for backing, bname in BACKINGS.items():
            t0 = time.perf_counter()
            sep = [HostBuffer(so, rows * PART, backing) for _ in range(3)]
            rec = HostBuffer(so, rows * 3 * PART, backing)
            alloc_s = time.perf_counter() - t0
            for b in sep + [rec]:
                fill_random(b.t, gen)
            bufs += sep + [rec]
            print(f"[records] {set_name}: {m} slots of {rows} rows, {bname}: 3 x {rows * PART} "
                  f"+ {rows * 3 * PART} bytes in {alloc_s:.2f} s; AnonHugePages "
                  f"{huge_pages_held()}", flush=True)
            layouts[f"{bname} | (a) three 1 KB runs, three allocations"] = (
                [b.t.data_ptr() for b in sep], [0, 0, 0], PART,
                lambda sep=sep: torch.cat([b.t.view(rows, PART)[slots_cpu] for b in sep], 1))
            layouts[f"{bname} | (b) one 3 KB run, one allocation of records"] = (
                [rec.t.data_ptr(), None, None], [0, PART, 2 * PART], 3 * PART,
                lambda rec=rec: rec.t.view(rows, 3 * PART)[slots_cpu])
        out = torch.empty((m, 3 * PART), dtype=torch.uint8, device="cuda")

        def launch(layout, mode, mask=0, layouts=layouts, out=out, m=m, slots=slots):
            bases, offs, stride, _ = layouts[layout]
            rc = so.probe_records((ctypes.c_void_p * 3)(*bases), (ctypes.c_int64 * 3)(*offs),
                                  stride, slots.data_ptr(), out.data_ptr(), m, mode, mask,
                                  torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"probe_records {layout} mode {mode}: CUDA error {rc}")

        for layout, (_, _, _, host_rows) in layouts.items():  # bits first
            ref = host_rows().cuda()
            launch(layout, 0)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"{set_name} {layout}: read rows differ")
            launch(layout, 2, 0x80000000)  # read, write back with the sign bits flipped
            torch.cuda.synchronize()
            flipped = ref.view(torch.int32) ^ torch.tensor(-2**31, dtype=torch.int32,
                                                            device="cuda")
            if not (torch.equal(out, ref) and torch.equal(
                    host_rows().cuda().view(torch.int32), flipped)):
                raise RuntimeError(f"{set_name} {layout}: read + write-back differs")
            out.copy_(ref)
            launch(layout, 1)  # the write-back alone restores them
            torch.cuda.synchronize()
            if not torch.equal(host_rows().cuda(), ref):
                raise RuntimeError(f"{set_name} {layout}: write-back differs")
            del ref, flipped
        for mode, mname in RECORD_MODES.items():
            turns = {k: [] for k in layouts}
            order = list(layouts)
            for r in range(ROUNDS):
                for layout in order[r % len(order):] + order[:r % len(order)]:
                    turns[layout].append(measure_chain(
                        lambda i, layout=layout, mode=mode: launch(layout, mode), CHAIN) * 1e3)
            for layout, ms in turns.items():
                med = statistics.median(ms)
                gbps = nbytes / med / 1e6
                rate = link["h2d_GBps"] if mode == 0 else link["d2h_GBps"]
                r = {"slots": set_name, "rows": rows, "n_slots": m, "case": layout,
                     "mode": mname, "bytes_each_way": nbytes, "ms": med, "ms_turns": ms,
                     "spread_ms": max(ms) - min(ms), "GBps": gbps, "copy_share": gbps / rate}
                results["records"].append(r)
                print(f"[records] {set_name} | {layout} | {mname}: {med:.4f} ms "
                      f"(turns {', '.join(f'{x:.4f}' for x in ms)}), {gbps:.2f} GB/s each way "
                      f"({gbps / rate:.3f} of the copy_ rate)", flush=True)
        del out, layouts
        for b in bufs:
            b.free()


# ---------------------------------------------------------------------------
# tier: the host-tier step's own calls over each layout and backing
# ---------------------------------------------------------------------------


# (name, backing of probe_alloc, request rounded up to a multiple of this, each table's start
# aligned to this, one allocation a table or one for all) that the tier part holds at once
# beside HostEmbedding's own tables and PyTorch's pinned tensors
MIB2 = 2 << 20
TIER_MEMORIES = (("cudaHostAlloc, one a table, exact", 0, 1, 16, True),
                 ("cudaHostAlloc, one for all, exact", 0, 1, 16, False),
                 ("cudaHostAlloc, one for all, rounded to 2 MiB", 0, MIB2, 16, False),
                 ("cudaHostAlloc, one for all, rounded to 2 MiB, each table 2 MiB-aligned", 0,
                  MIB2, MIB2, False),
                 ("mmap + MADV_HUGEPAGE + cudaHostRegister, one for all, rounded to 2 MiB", 1,
                  MIB2, 16, False))


def tier_part(so, link, results) -> None:
    """The host-tier SAGE step's apply call (kernel L's host route) and its
    gather of the misses (kernel E), captured from one step of
    ``SageTrainConfig()``'s host tier (cache ratio 0.25), replayed over
    copies of its table, m and v in each of: ``HostEmbedding``'s own
    allocations (``ops.host_kernels.host_zeros``: ``cudaHostAlloc``, one a
    table, rounded up to 2 MiB), the TIER_MEMORIES (one a table or one for
    all three, exact or rounded, registered memory), and PyTorch's pinned
    tensors (one each, as the parent allocated them); timed by device time in turns (every copy held at
    once); every copy's touched rows bit-equal after the apply."""
    from ..embedding import host_embedding as host_mod
    from ..ops import optim_kernels as OK
    from ..train import SageTrainConfig, build_synthetic, train_step

    st = build_synthetic(SageTrainConfig(), device="cuda", seed=0, host_cache_ratio=0.25)
    emb = st.embedding
    rec_l, rec_e = [], []
    real_l, real_e = host_mod.apply_rows_host, host_mod.host_gather_rows
    host_mod.apply_rows_host = lambda *a, **kw: rec_l.append((a, kw)) or real_l(*a, **kw)
    host_mod.host_gather_rows = lambda *a, **kw: rec_e.append((a, kw)) or real_e(*a, **kw)
    try:
        gen = torch.Generator(device="cuda").manual_seed(5)
        c = torch.randint(0, st.config.n_nodes, (st.config.batch,), generator=gen,
                          device="cuda", dtype=torch.int32)
        train_step(st, c, st.labels[c.long()], seed=0)
    finally:
        host_mod.apply_rows_host, host_mod.host_gather_rows = real_l, real_e
    torch.cuda.synchronize()
    (table, slots, ids, grads, opt, step, lr), kw = rec_l[0]
    (_, miss_slots), ekw = rec_e[0]
    names = opt.slot_names
    valid = (ids >= 0) & (ids < table.shape[0])
    vids = ids[valid].long().cpu()
    hits = kw["lines"][valid & (kw["lines"] >= 0)].long()
    rows, dim = table.shape
    assert table.dtype == torch.float32, "the tier part takes the f32 tier"
    configs, buffers = {}, []
    t0 = time.perf_counter()
    own = [H.host_zeros((rows, dim), torch.float32, torch.device("cuda"))
           for _ in range(1 + len(names))]
    configs["HostEmbedding's (host_zeros: cudaHostAlloc, one a table, rounded to 2 MiB)"] = (
        own[0], dict(zip(names, own[1:])))
    print(f"[tier] host_zeros: {len(own)} tables of {own[0].nbytes} bytes in "
          f"{time.perf_counter() - t0:.2f} s; held by the kernels' library "
          f"{H.host_alloc_bytes()['current']}", flush=True)
    del own
    for name, backing, step_bytes, align, separate in TIER_MEMORIES:
        part = rows * dim * 4
        if separate:  # one allocation a table
            bufs = [HostBuffer(so, -(-part // step_bytes) * step_bytes, backing)
                    for _ in range(1 + len(names))]
            buffers += bufs
            views = [b.t[:part].view(torch.float32).view(rows, dim) for b in bufs]
        else:
            up = -(-part // align) * align
            offs = [k * up for k in range(1 + len(names))]
            size = offs[-1] + part
            buffers.append(HostBuffer(so, -(-size // step_bytes) * step_bytes, backing))
            views = [buffers[-1].t[o:o + part].view(torch.float32).view(rows, dim) for o in offs]
        configs[name] = (views[0], dict(zip(names, views[1:])))
    configs["PyTorch's pinned tensors, one each (the parent's)"] = (
        H.pinned_empty((rows, dim), table.dtype),
        {k: H.pinned_empty((rows, dim), torch.float32) for k in names})
    print(f"[tier] transparent huge pages: "
          f"{read_only('/sys/kernel/mm/transparent_hugepage/enabled')}; held "
          f"{huge_pages_held()}", flush=True)
    for tv, sv in configs.values():
        tv.copy_(table)
        for k in names:
            sv[k].copy_(slots[k])
    cache0 = kw["cache_rows"][hits].clone()
    outs = {}
    for name, (tv, sv) in configs.items():  # one apply each from the same rows: bits
        kw["cache_rows"][hits] = cache0
        OK.apply_rows_host(tv, sv, ids, grads, opt, step, lr, **kw)
        torch.cuda.synchronize()
        outs[name] = [tv[vids]] + [sv[k][vids] for k in names] + [kw["cache_rows"][hits]]
    first = next(iter(outs.values()))
    for name, o in outs.items():
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(o, first)):
            raise RuntimeError(f"tier {name}: the apply's rows differ from the first memory's")
    n_valid = vids.numel()
    link_bytes = n_valid * dim * (table.element_size() + 4 * len(names))
    miss = int(((miss_slots >= 0) & (miss_slots < rows)).sum())
    order = list(configs)
    turns = {k: {"apply": [], "gather": []} for k in order}
    for r in range(ROUNDS):
        for name in order[r % len(order):] + order[:r % len(order)]:
            tv, sv = configs[name]
            turns[name]["apply"].append(measure_chain(
                lambda i, tv=tv, sv=sv: OK.apply_rows_host(tv, sv, ids, grads, opt, step, lr,
                                                           **kw), CHAIN) * 1e3)
            turns[name]["gather"].append(measure_chain(
                lambda i, tv=tv: H.host_gather_rows(tv, miss_slots, **ekw), CHAIN) * 1e3)
    results["tier"] = {"slots": ids.numel(), "valid": n_valid, "cached": hits.numel(),
                       "link_bytes_each_way": link_bytes,
                       "duplex_bound_ms": link_bytes / 64e9 * 1e3,
                       "gather_slots": miss_slots.numel(), "gather_misses": miss, "cases": {}}
    for name, t in turns.items():
        a, g = statistics.median(t["apply"]), statistics.median(t["gather"])
        results["tier"]["cases"][name] = {"apply_ms": a, "apply_turns": t["apply"],
                                          "gather_ms": g, "gather_turns": t["gather"]}
        print(f"[tier] {name}: apply {a:.4f} ms (turns "
              f"{', '.join(f'{x:.4f}' for x in t['apply'])}; {link_bytes / a / 1e6:.2f} GB/s "
              f"each way, {link_bytes / 64e9 * 1e3 / a:.3f} of the duplex bound at 64 GB/s each way); "
              f"miss gather ({miss} rows) {g:.4f} ms (turns "
              f"{', '.join(f'{x:.4f}' for x in t['gather'])})", flush=True)
    del configs, outs, first, st, emb, table, slots
    for b in buffers:
        b.free()
    torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="+", choices=("lanes", "records", "tier"),
                    default=["lanes", "records", "tier"])
    ap.add_argument("--out", help="also write the results here, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_read_probe: needs a CUDA device", file=sys.stderr)
        return 1
    so = build()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    link = copy_rates()
    print(f"[probe] {name} ({smi}); 1 GiB copy_ pinned->card {link['h2d_ms']} ms = "
          f"{link['h2d_GBps']} GB/s, card->pinned {link['d2h_ms']} ms = {link['d2h_GBps']} GB/s",
          flush=True)
    results = {"device": name, "nvidia_smi": smi, "copy_ms": link["h2d_ms"],
               "copy_GBps": link["h2d_GBps"], "link": link, "cases": []}
    if "lanes" in args.parts:
        lanes_part(so, link["h2d_GBps"], results)
    if "records" in args.parts:
        records_part(so, link, results)
    if "tier" in args.parts:
        tier_part(so, link, results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
