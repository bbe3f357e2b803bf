#!/usr/bin/env python3
"""Device time of the call statistics (`ops/call_stats.py`, the kernels of
csrc/call_stats.cu) by how the n slots are filled, for whichever
`sniffles_tpu_torch` comes first on the import path:

    python3 sniffles_tpu_torch/tools/time_call_stats.py [--n 2097152]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_call_stats.py

Cases of n slots (`populations`):
  - "engine": the engine step's clustered batch at chip_smoke.py phase
    10d's inputs (`signatures.synthetic_batch`, n/40 sites, seed 42, a
    genome span of 900 kb), n/40 live slots of 22 to 60 elements;
  - "all invalid": the same with no valid element, every slot empty;
  - "singletons": every slot a cluster of one element;
  - "K a slot" for K in 8, 40, 256, 4096 and 32768: slot k holds elements
    kK..kK+K-1 of the engine's columns; 8 is the thread tier's largest
    cluster, 40 the engine's count of live slots, 256 the warp tier's
    largest, 4096 a block's, 32768 past a block's shared memory.
For each it holds the kernels against the plain version on CPU copies
(every key and slot bit for bit), then prints the device time of the
wrapper (the sort and the kernels) and of the kernels alone (CUDA events,
the card asleep ahead of the start event so that the host's launch work
stays out, the mean of 10 calls after one that warms up), and the
wrapper's device time by kernel (torch.profiler over 10 calls: each
kernel's device us and launches a call). Then, where the package builds
its tier thresholds into the kernels (ops/call_stats.TIERS: TINY_MAX,
PAIR_MAX, WARP_MAX, BLOCK_MAX), the kernels alone at each threshold's
population through the tier on either side of it, each side a build of
its own (all built at once first): the engine's and 40 a slot through a
warp's registers and through its shared memory; then ptxas's registers
and spills of the kernels and the card's nvidia-smi name and power limit.
Needs a CUDA card; `--device cpu` builds the populations and holds
nothing (a dry run).
"""
import argparse
import os
import subprocess
import sys
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

REPS = 10
SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of each call
SLOT_SIZES = (8, 40, 256, 4096, 32768)


def populations(n: int, device: str) -> dict:
    """{case: clustered batch on `device`} (see the module's docstring)."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = {k: torch.as_tensor(v).to(device) for k, v in synthetic_batch(
        n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict().items()}
    engine = tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                   cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                   cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
    engine.pop("merge_rounds")
    ids = torch.arange(n, dtype=torch.int32, device=device)
    every = torch.ones_like(engine["valid"])

    def slots_of(k):
        return dict(engine, valid=every, cluster_id=ids // k,
                    n_clusters=torch.tensor(-(-n // k), dtype=torch.int32, device=device))
    cases = {"engine": engine,
             "all invalid": dict(engine, valid=torch.zeros_like(engine["valid"])),
             "singletons": slots_of(1)}
    cases.update((f"{k} a slot", slots_of(k)) for k in SLOT_SIZES)
    return cases


def queued_ms(fn) -> float:
    """Device ms of fn() between two CUDA events, the mean of REPS calls
    after one that warms up, the card asleep ahead of the start event."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(REPS + 1):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    return total / REPS


def by_kernel(fn) -> dict:
    """{kernel name: (device us a call, launches a call)} of fn() under
    torch.profiler over REPS calls, after one that warms up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0.0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "Activity Buffer Request":
            out[e.name][0] += e.time_range.elapsed_us() / REPS
            out[e.name][1] += 1 / REPS
    return dict(out)


def short(name: str) -> str:
    """A kernel's name without its template arguments and namespaces."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return base[-1].split("::")[-1][:40] if base else name[:40]


def held(got: dict, want: dict, case: str) -> None:
    for k, v in want.items():
        a, b = got[k].cpu(), v
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise SystemExit(f"time_call_stats: {case}: {k} differs from the plain version")


def threshold_cases(cs) -> list:
    """(case, [(label, tiers)]): each tier threshold's population through
    the tier on either side of it (tiers as ops/call_stats.TIERS)."""
    t, p, w, b = cs.TIERS
    return [("8 a slot", [(f"thread tier (tiny {t})", (t, p, w, b)),
                          ("warp tier (tiny 7)", (min(t, 7), p, w, b))]),
            ("engine", [(f"warp registers (pair {p})", (t, p, w, b)),
                        ("warp shared memory (pair 0)", (t, 0, w, b))]),
            ("40 a slot", [(f"warp registers (pair {p})", (t, p, w, b)),
                           ("warp shared memory (pair 0)", (t, 0, w, b)),
                           ("block tier (warp 39)", (t, p, 39, b))]),
            ("256 a slot", [(f"warp tier (warp {w})", (t, p, w, b)),
                            ("block tier (warp 255)", (t, p, 255, b))]),
            ("4096 a slot", [(f"block in shared memory (block {b})", (t, p, w, b)),
                             ("one block an SM (block 11264)", (t, p, w, 11264)),
                             ("block over global scratch (block 4095)", (t, p, w, 4095))])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cpu":
        for case, c in populations(args.n, "cpu").items():
            live = int(torch.unique(c["cluster_id"][c["valid"]]).numel())
            print(f"{case}: {args.n} slots, {live} live")
        return 0
    if not torch.cuda.is_available():
        print("time_call_stats: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import call_stats as cs
    print(f"time_call_stats: the package at {os.path.dirname(os.path.dirname(cs.__file__))}")
    cases = populations(args.n, "cuda")
    for case, c in cases.items():
        want = cs.call_statistics_plain({k: v.cpu() for k, v in c.items()}, True)
        held(cs.launch_call_statistics(c, True), want, case)
        inputs = cs.kernel_inputs(c)
        ms = queued_ms(lambda: cs.launch_call_statistics(c, True))
        kernels_ms = queued_ms(lambda: cs.launch_kernels(inputs, c["n_clusters"], True))
        split = by_kernel(lambda: cs.launch_call_statistics(c, True))
        live = int((want["lead_count"] > 0).sum())
        print(f"{case}: {args.n} slots, {live} live; == plain (bit-exact); the wrapper "
              f"{ms:.4f} ms, the kernels alone {kernels_ms:.4f} ms; by kernel (us, launches "
              f"a call): " + "; ".join(
                  f"{short(k)} {us:.1f} x{n:.0f}"
                  for k, (us, n) in sorted(split.items(), key=lambda kv: -kv[1][0])),
              flush=True)
    if hasattr(cs, "TIERS"):
        variants = {tiers for _, sides in threshold_cases(cs) for _, tiers in sides}
        started = [_build.start_build("call_stats", defines=cs.nvcc_defines(v))
                   for v in variants]
        for s in started:
            _build.finish_build(s)
        for case, sides in threshold_cases(cs):
            c = cases[case]
            want = cs.call_statistics_plain({k: v.cpu() for k, v in c.items()}, True)
            inputs = cs.kernel_inputs(c)
            times = []
            for label, tiers in sides:
                held(cs.launch_kernels(inputs, c["n_clusters"], True, tiers), want, case)
                t_ms = queued_ms(lambda: cs.launch_kernels(inputs, c["n_clusters"], True, tiers))
                times.append(f"{label} {t_ms:.4f} ms")
            print(f"threshold, {case}: the kernels alone (== plain): {'; '.join(times)}",
                  flush=True)
    log = _build.finish_build(_build.start_build("call_stats", ptxas_verbose=True))
    kernel = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = next((k for k in ("stat_runs", "stat_slots", "stat_warps", "stat_blocks",
                                       "call_stats_kernel") if k in line), "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.split('info    :', 1)[-1].strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
