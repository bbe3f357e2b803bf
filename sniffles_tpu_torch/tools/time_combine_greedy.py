#!/usr/bin/env python3
"""Where the time of the combine mode's device greedy goes, for whichever
`sniffles_tpu_torch` comes first on the import path:

    python3 sniffles_tpu_torch/tools/time_combine_greedy.py [--dir DIR]
        [--cohorts combine256,combine256-bam] [--samples 256] [--jobs 8]
        [--json-out FILE] [--dispatches FILE] [--split] [--no-loop]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_combine_greedy.py ...

Cohorts (built under --dir, and reused when they are there):
  - combine256: chip_smoke.py phase 3's (sim.write_cohort, 256 samples,
    seed 2024, 2 contigs of 1 Mb);
  - combine256-bam: the bench's combine leg (tools/bench_combine.py's
    cohort: 256 samples of 2 x 600 kb at 12x, a site every 2,000-3,500 bp,
    each SNF called by the host path in a process pool of --jobs).
For each, the combine runs on the device path in this process
(--threads 0, once to warm up, then once measured) with every whole-task
greedy dispatch kept (`captured_dispatches`: its payload, meta, result,
the padded shapes the package handed _greedy_grid_loop, and its wall from
start to result on the host clock). Then:
  - each dispatch's shape (`dispatch_row`): S and L, their padded Sp and
    Lp, the counts' max (the torch loop's steps), the candidates, the ED
    table's heads and width and whether limit > 0;
  - on the card, each dispatch's torch loop (the plain version on CUDA
    tensors; the package's _greedy_grid_loop where it has no plain
    version) and, where the package has the kernel, its wrapper's one
    launch: ms between CUDA events, host ms to the result, and launches a
    call (the loop's by torch.profiler, the kernel's by its wrapper's
    count), each result == the plain version's on the CPU;
    the bound (`bound`: the bytes the kernel must move at 3.35 TB/s, the
    live slots' operations);
  - the share of the measured combine's wall in its greedy dispatches.
--dispatches FILE keeps every cohort's captured dispatches (payload, meta,
result, padded shapes, wall) in FILE, a pickle, and reads them from FILE
when it is there instead of building the cohorts and running their
combines (no wall split then): a CPU dry run captures them once, and each
later run on the card times the same dispatches.
--no-loop times the kernel alone (the torch loop is still held).
--cohorts "group counts" (SIM_COHORTS) takes sim.greedy_task_payloads'
payloads of that label in place of a cohort's dispatches: rows of many
groups, where a step probes several trips.
--split (on the card) also runs each cohort's largest dispatch (the most
candidates) through a build of the kernel with ops/combine_greedy.
STEP_CLOCKS and prints the cycles of a step by part (STEP_PARTS: the
candidate's load, the probe trips, the warp reductions, the update),
summed over the rows' steps.
The card's nvidia-smi name and power limit close the output. `--device
cpu` is a dry run on the CPU (the plain version, SNIFFLES_TPU_FORCE_CPU):
the capture, the shapes and the split, no device time.
"""
import argparse
import contextlib
import glob
import io
import json
import os
import pickle
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

COHORTS = ("combine256", "combine256-bam")
SIM_COHORTS = ("group counts",)           # sim.greedy_task_payloads' labels (sim_dispatches)
COHORT_SEED = 2024                        # chip_smoke.py's COHORT_SEED
BAM_COHORT = dict(ref_len=600_000, depth=12, site_gap=(2_000, 3_500))  # bench.py's leg
REPS = 3
SLEEP_CYCLES = 2_000_000                  # about 1 ms of device sleep ahead of a kernel
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, 700 W
INT32_OPS_PER_S = 64 * 132 * 1.98e9
FP32_OPS_PER_S = 67e12
# operations of one live slot's probe in csrc/combine_greedy.cu's step,
# counted from the source: int32 (D's two products, differences, absolute
# values and sum; the cap's product and compare; the length and identity
# tests; the key's two divisions, three products, difference and sum; the
# first-minimum compare) and float32 (four conversions, three divisions,
# four min/max, the root, two products, two differences, five compares)
INT32_OPS_PER_PROBE = 24
FP32_OPS_PER_PROBE = 21


def build_cohort(name: str, workdir: str, samples: int, jobs: int) -> list:
    """The SNF paths of cohort `name` under workdir, written when missing."""
    out = os.path.join(workdir, name)
    if name == "combine256":
        snfs = sorted(glob.glob(os.path.join(out, "s*.snf")))
        if len(snfs) == samples:
            return snfs
        from sniffles_tpu_torch.sim import write_cohort
        return write_cohort(out, samples, COHORT_SEED)
    from sniffles_tpu_torch.tools.bench_combine import build_sample
    os.makedirs(out, exist_ok=True)
    work = [(out, i, BAM_COHORT["ref_len"], BAM_COHORT["depth"], BAM_COHORT["site_gap"])
            for i in range(samples)]
    with ProcessPoolExecutor(max_workers=jobs, mp_context=get_context("spawn")) as ex:
        return list(ex.map(build_sample, work))


@contextlib.contextmanager
def captured_dispatches():
    """Keeps every whole-task greedy dispatch of this process while open
    (ops/combine_greedy.start_combine_greedy_task wrapped): a list of
    {"payload", "meta", "result", "padded", "wall"}, the payload's arrays
    copied, "padded" the shapes of the c_pos grid and the ED table that
    the package's own padding handed _greedy_grid_loop, the wall from the
    start to the result on the host clock."""
    from sniffles_tpu_torch.ops import combine_greedy as cg
    real, kept = cg.start_combine_greedy_task, []

    def start(payload, meta, device):
        t0 = time.perf_counter()
        loop, padded = cg._greedy_grid_loop, {}

        def shapes(*args, **kw):
            padded.update(grid=tuple(args[0].shape), ed=tuple(args[5].shape))
            return loop(*args, **kw)
        cg._greedy_grid_loop = shapes
        try:
            fetch = real(payload, meta, device)
        finally:
            cg._greedy_grid_loop = loop

        def finish():
            result = fetch()
            kept.append({"payload": {k: np.array(v) for k, v in payload.items()},
                         "meta": dict(meta), "result": result, "padded": padded,
                         "wall": time.perf_counter() - t0})
            return result
        return finish
    cg.start_combine_greedy_task = start
    try:
        yield kept
    finally:
        cg.start_combine_greedy_task = real


def run_device_combine(snfs: list, vcf: str) -> tuple:
    """The combine of `snfs` on the device path in this process
    (--threads 0); returns (its dispatches as captured_dispatches keeps
    them, its wall in s). Raises SystemExit when the CLI fails."""
    from sniffles_tpu_torch import cli
    log = io.StringIO()
    with captured_dispatches() as kept:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(["--input", *snfs, "--vcf", vcf, "--threads", "0",
                           "--allow-overwrite"])
        if torch.cuda.is_available() and not os.environ.get("SNIFFLES_TPU_FORCE_CPU"):
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-4000:])
        raise SystemExit(f"time_combine_greedy: the combine exited {rc}")
    return kept, wall


def dispatch_row(d: dict) -> dict:
    """The shape of a kept dispatch: S, L, Sp, Lp (the padded grid that
    start_combine_greedy_task made), max_count (the torch loop's steps),
    candidates, the ED table's heads and width and whether limit > 0."""
    S, L = d["payload"]["c_pos"].shape
    Sp, Lp = d["padded"]["grid"]
    counts = np.asarray(d["payload"]["counts"])
    return {"S": S, "L": L, "Sp": Sp, "Lp": Lp,
            "max_count": int(counts.max()) if S else 0, "candidates": int(counts.sum()),
            "ed_heads": d["padded"]["ed"][1], "ed_width": d["padded"]["ed"][2],
            "limit_on": float(d["meta"]["limit"]) > 0}


def split(kept: list, wall: float) -> dict:
    """The combine's wall in its greedy dispatches and the rest."""
    greedy = sum(d["wall"] for d in kept)
    return {"wall_s": wall, "greedy_s": greedy, "rest_s": wall - greedy,
            "greedy_share": greedy / wall if wall > 0 else 0.0, "dispatches": len(kept)}


def bound(d: dict) -> dict:
    """The least time of a dispatch's greedy on the card: the bytes the
    function must move at HBM_BYTES_PER_S, against the operations of every
    step's probes of its live slots (each row's groups founded before the
    step, from the result's assign). The bytes, int32 each: read once, each
    live candidate's four values (pos, len, alt, head row), where limit > 0
    the ED table's distinct entries that the steps read (the column of
    each of the K head rows a step of a row, min(count, W) columns a row:
    one where the table is one column wide) and the padded rows' counts;
    written once, the padded assign grid and segflags."""
    r = dispatch_row(d)
    counts = np.asarray(d["payload"]["counts"], dtype=np.int64)
    cells = int(counts.sum())
    ed_cells = r["ed_heads"] * int(np.minimum(counts, r["ed_width"]).sum()) if r["limit_on"] \
        else 0
    nbytes = 4 * (4 * cells + ed_cells + r["Sp"] * r["Lp"] + 2 * r["Sp"])
    assign = np.asarray(d["result"]["assign"], dtype=np.int64)
    steps = np.arange(assign.shape[1])[None, :] < counts[:, None]
    before = np.maximum.accumulate(np.where(steps, assign, -1), axis=1) + 1
    probes = int(np.concatenate([np.zeros((len(counts), 1), np.int64), before[:, :-1]],
                                axis=1)[steps].sum())
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * probes * (INT32_OPS_PER_PROBE / INT32_OPS_PER_S
                             + FP32_OPS_PER_PROBE / FP32_OPS_PER_S)
    return {"bytes": nbytes, "probes": probes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def device_inputs(cg, d: dict) -> tuple:
    """The tensors the dispatch hands _greedy_grid_loop on the card (its
    args and keywords, kept from one run_combine_greedy_task) and that
    run's result."""
    real, got = cg._greedy_grid_loop, []

    def keep(*args, **kw):
        got.append((args, kw))
        return real(*args, **kw)
    cg._greedy_grid_loop = keep
    try:
        result = cg.run_combine_greedy_task(d["payload"], d["meta"], "cuda")
    finally:
        cg._greedy_grid_loop = real
    return got[0][0], got[0][1], result


def timed(fn, sleep: bool, profiled: bool = True) -> dict:
    """fn() on the card, after one call that warms up: ms between CUDA
    events (the mean of REPS calls; with `sleep`, the card asleep ahead of
    each start event, so that a single launch's host work stays out), host
    ms to its end with no sleep (the mean of REPS calls), and, where
    `profiled`, the device events of one call by torch.profiler (kernels,
    and copies and fills apart). The profiler drops a few of the loop's
    events and most single launches through ctypes: a kernel's launches are
    its wrapper's count."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dev = host = 0.0
    for _ in range(REPS):
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        dev += start.elapsed_time(stop)
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host += time.perf_counter() - t0
    out = {"ms": dev / REPS, "host_ms": 1e3 * host / REPS}
    if profiled:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kinds = Counter()
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name != "Activity Buffer Request"):
                kinds["copies" if e.name.startswith(("Memcpy", "Memset")) else "kernels"] += 1
        out.update(launches=kinds["kernels"], copies=kinds["copies"])
    return out


def held(out, want: dict, what: str) -> None:
    assign, segflags = (t.cpu().numpy() for t in out)
    S, L = want["assign"].shape
    if not (np.array_equal(assign[:S, :L], want["assign"])
            and np.array_equal(segflags[:S], want["seg_flags"])):
        raise SystemExit(f"time_combine_greedy: {what} differs from the plain version")


def time_cohort(cg, name: str, kept: list, has_kernel: bool, loop_too: bool = True) -> list:
    """Per dispatch of a cohort: its shape, bound, the torch loop's (where
    `loop_too`) and the kernel's times (each held to the CPU's result),
    printed and returned."""
    loop = getattr(cg, "greedy_grid_plain", cg._greedy_grid_loop)
    rows = []
    for j, d in enumerate(kept):
        want = cg.run_combine_greedy_task(d["payload"], d["meta"], "cpu")
        args, kw, result = device_inputs(cg, d)
        for key in ("assign", "seg_flags"):
            if not np.array_equal(result[key], want[key]):
                raise SystemExit(f"time_combine_greedy: {name} dispatch {j}: {key} on the card "
                                 "differs from the plain version on the CPU")
        row = {**dispatch_row(d), **bound(d), "cli_wall_ms": 1e3 * d["wall"]}
        held(loop(*args, **kw), want, f"{name} dispatch {j}, the torch loop")
        row["loop"] = (timed(lambda: loop(*args, **kw), sleep=False) if loop_too
                       else {"ms": float("nan"), "host_ms": float("nan"),
                             "launches": float("nan")})
        if has_kernel:
            launches = cg.COUNTS["launches"]
            held(cg._greedy_grid_loop(*args, **kw), want, f"{name} dispatch {j}, the kernel")
            counted = cg.COUNTS["launches"] - launches
            row["kernel"] = timed(lambda: cg._greedy_grid_loop(*args, **kw), sleep=True,
                                  profiled=False)
            row["kernel"]["launches"] = counted
        rows.append(row)
        k = row.get("kernel")
        print(f"  [{name}] dispatch {j}: S {row['S']} (Sp {row['Sp']}), L {row['L']} "
              f"(Lp {row['Lp']}), max count {row['max_count']}, {row['candidates']} "
              f"candidates, ED width {row['ed_width']}, limit > 0 {row['limit_on']}; "
              f"in the combine {row['cli_wall_ms']:.2f} ms; torch loop {row['loop']['ms']:.3f} "
              f"ms between events, {row['loop']['host_ms']:.3f} ms host, "
              f"{row['loop']['launches']:g} launches (torch.profiler)"
              + (f"; kernel {k['ms']:.4f} ms, {k['host_ms']:.3f} ms host, {k['launches']} "
                 f"launch (the wrapper's count), "
                 f"{1e3 * k['ms'] / max(row['max_count'], 1):.3f} us a step"
                 if k else "")
              + f"; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: {row['bytes']} bytes "
              f"{row['bytes_ms']:.6f} ms, {row['probes']} probes {row['ops_ms']:.6f} ms); "
              "== plain", flush=True)
    return rows


def step_split(cg, d: dict) -> dict | None:
    """A dispatch's steps by part: its grid run once through the kernel's
    STEP_CLOCKS build (held to the plain version), then {part: cycles a
    step} (ops/combine_greedy.STEP_PARTS; a step's cycles averaged over
    every row's steps), "cycles" (their sum) and "steps"; None where the
    package has no such build."""
    if not hasattr(cg, "STEP_CLOCKS"):
        return None
    import ctypes
    from sniffles_tpu_torch.ops import _build
    fn = _build.load("combine_greedy", (cg.STEP_CLOCKS,)).greedy_step_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_uint64 * (len(cg.STEP_PARTS) + 1))()
    args, kw, _ = device_inputs(cg, d)
    gates = {k: kw[k] for k in ("cm", "cmm", "limit")}
    want = cg.run_combine_greedy_task(d["payload"], d["meta"], "cpu")
    run = lambda: cg.launch_grid(cg.grid_inputs(*args), clocks=True, **gates)  # noqa: E731
    run()
    torch.cuda.synchronize()
    if fn(out) != 0:                    # zeroes the sums after the warm-up launch
        raise SystemExit("time_combine_greedy: reading the step clocks failed")
    held(run(), want, "the STEP_CLOCKS build")
    torch.cuda.synchronize()
    if fn(out) != 0:
        raise SystemExit("time_combine_greedy: reading the step clocks failed")
    cycles, steps = [int(v) for v in out[:-1]], int(out[-1])
    per = {p: c / max(steps, 1) for p, c in zip(cg.STEP_PARTS, cycles)}
    return {**per, "cycles": sum(per.values()), "steps": steps}


def captured(args, names: list, cpu: bool) -> dict:
    """{cohort: (kept dispatches, the combine's wall in s or None)}: read
    from --dispatches FILE where it is there, else each cohort built under
    --dir and its device combine run in this process (on the card once to
    warm up, then measured), the dispatches then kept in FILE where one is
    named."""
    if args.dispatches and os.path.exists(args.dispatches):
        with open(args.dispatches, "rb") as f:
            saved = pickle.load(f)
        missing = [n for n in names if n not in saved]
        if missing:
            raise SystemExit(f"time_combine_greedy: {args.dispatches} holds no "
                             f"{', '.join(missing)}")
        print(f"  the dispatches of {', '.join(names)} read from {args.dispatches}", flush=True)
        return {n: (saved[n], None) for n in names}
    from sniffles_tpu_torch.ops import combine_greedy as cg
    out = {n: (sim_dispatches(cg, [n]), None) for n in names if n in SIM_COHORTS}
    t0 = time.perf_counter()
    cohorts = {n: build_cohort(n, args.dir, args.samples, args.jobs) for n in names
               if n not in SIM_COHORTS}
    if cohorts:
        print(f"  cohorts {', '.join(f'{n} ({len(s)} SNFs)' for n, s in cohorts.items())} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not cpu and cohorts:
        from sniffles_tpu_torch.ops import _build
        _build.build_all()
    for name, snfs in cohorts.items():
        vcf = os.path.join(args.dir, f"{name}.vcf")
        if not cpu:
            run_device_combine(snfs, vcf)      # warm: the context and the kernels' modules
        out[name] = run_device_combine(snfs, vcf)
    if args.dispatches:
        os.makedirs(os.path.dirname(os.path.abspath(args.dispatches)), exist_ok=True)
        with open(args.dispatches, "wb") as f:
            pickle.dump({n: kept for n, (kept, _) in out.items()}, f)
    return out


def sim_dispatches(cg, labels: list) -> list:
    """sim.greedy_task_payloads' payloads under `labels`, kept as
    captured_dispatches keeps a dispatch (its result the plain version's
    on the CPU, no wall): rows of many groups ("group counts": 67, 122 and
    258 at limit 0.5), where a step probes several trips."""
    from sniffles_tpu_torch.sim import greedy_task_payloads
    out = []
    for label, payload, meta in greedy_task_payloads():
        if label in labels:
            grids = cg.task_grids(payload)
            out.append({"payload": payload, "meta": meta, "wall": 0.0,
                        "result": cg.run_combine_greedy_task(payload, meta, "cpu"),
                        "padded": {"grid": grids["c_pos"].shape, "ed": grids["ed"].shape}})
    if not out:
        raise SystemExit(f"time_combine_greedy: no sim payload {', '.join(labels)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(REPO, "build", "time_combine_greedy"))
    ap.add_argument("--cohorts", default=",".join(COHORTS))
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--dispatches", default="",
                    help="a pickle of the captured dispatches: written, or read when there")
    ap.add_argument("--split", action="store_true",
                    help="a step's cycles by part on each cohort's largest dispatch")
    ap.add_argument("--no-loop", action="store_true",
                    help="the kernel alone: the torch loop held, not timed")
    args = ap.parse_args(argv)
    names = [n for n in args.cohorts.split(",") if n]
    if any(n not in COHORTS + SIM_COHORTS for n in names) and not (
            args.dispatches and os.path.exists(args.dispatches)):
        ap.error(f"--cohorts: choose from {', '.join(COHORTS + SIM_COHORTS)}")
    cpu = args.device == "cpu"
    if cpu:
        os.environ["SNIFFLES_TPU_FORCE_CPU"] = "1"
    elif not torch.cuda.is_available():
        print("time_combine_greedy: no CUDA device is visible", file=sys.stderr)
        return 2
    else:
        os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import combine_greedy as cg
    has_kernel = hasattr(cg, "greedy_grid_plain")
    print(f"time_combine_greedy: the package at "
          f"{os.path.dirname(os.path.dirname(cg.__file__))}, "
          f"{'with' if has_kernel else 'without'} the greedy kernel", flush=True)
    report = {}
    for name, (kept, wall) in captured(args, names, cpu).items():
        parts = split(kept, wall) if wall is not None else None
        if parts is not None:
            print(f"  [{name}] the device combine in process: {wall:.3f} s, of which "
                  f"{parts['greedy_s']:.3f} s in {parts['dispatches']} greedy dispatches "
                  f"({100 * parts['greedy_share']:.1f} %), the rest {parts['rest_s']:.3f} s",
                  flush=True)
        if cpu:
            for j, d in enumerate(kept):
                print(f"  [{name}] dispatch {j}: {dispatch_row(d)} (CPU dry run: no device "
                      "time)", flush=True)
            report[name] = {"split": parts, "dispatches": [dispatch_row(d) for d in kept]}
            continue
        report[name] = {"split": parts,
                        "dispatches": time_cohort(cg, name, kept, has_kernel, not args.no_loop)}
        rows = report[name]["dispatches"]
        print(f"  [{name}] all dispatches: torch loop "
              f"{sum(r['loop']['ms'] for r in rows):.3f} ms, "
              f"{sum(r['loop']['launches'] for r in rows):g} launches (torch.profiler)"
              + (f"; kernel {sum(r['kernel']['ms'] for r in rows):.4f} ms, "
                 f"{sum(r['kernel']['launches'] for r in rows)} launches (the wrapper's count)"
                 if has_kernel else ""),
              flush=True)
        if args.split:
            d = max(kept, key=lambda d: int(np.asarray(d["payload"]["counts"]).sum()))
            sp = step_split(cg, d)
            report[name]["step_split"] = sp
            print(f"  [{name}] the largest dispatch's steps by part (the STEP_CLOCKS build): "
                  + ("no step clocks in this package" if sp is None else
                     f"{sp['cycles']:.1f} cycles a step over {sp['steps']} row steps; "
                     + ", ".join(f"{p} {sp[p]:.1f} ({100 * sp[p] / sp['cycles']:.1f} %)"
                                 for p in cg.STEP_PARTS)), flush=True)
    if not cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        report["device"] = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
        print(report["device"], flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
