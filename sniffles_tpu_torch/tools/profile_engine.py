#!/usr/bin/env python3
"""Where the device time of the fused engine's step goes, by stage.

    python3 sniffles_tpu_torch/tools/profile_engine.py [--n 2097152] [--steps 3] [--trace PATH]

Runs `parallel/engine.call_pipeline_step` on chip_smoke.py phase 10d's
inputs (`signatures.synthetic_batch`, n/40 sites, seed 42, a genome span
of 900 kb; 1 Mb of coverage at 30; default_params), from tensors on the
card: two steps to warm up, then STEPS steps under torch.profiler (CPU
and CUDA activities). Each stage of the step runs inside a
record_function range of its own for the run (the module functions are
wrapped, never edited):
  sort and seed  ops/clustering.sort_and_seed (3 stable sorts, the seeds)
  relaxation     ops/merge_relax.merge_relax (csrc/merge_relax.cu)
  resplit        ops/clustering._resplit (2 stable sorts, the child ids)
  statistics     ops/clustering.call_statistics (the step's statistics)
  support_sa     the split-read support sum (ops/segments.seg_sum)
  tail           ops/candidate_tail.candidate_tail (csrc/candidate_tail.cu)
Prints, a step: the device time of each stage's kernels (the profiler's
kernels under the stage's range), its launches and its three largest
kernels; the device interval of each stage between two CUDA events
recorded around it (idle gaps included, a cross-check that needs no
profiler); the device time of kernels under no stage; tail_runs (the
tail's run pass) beside its byte bound (the cluster ids read, a run start
a cluster written); the step's time between CUDA events outside the
profiler; and the card's nvidia-smi name and power limit. With --trace, writes the chrome trace there. Needs a
CUDA card, unless --device cpu (a dry run of the stages on the CPU).
"""
import argparse
import bisect
import contextlib
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

PREFIX = "stage: "
HBM_BYTES_PER_S = 3.35e12    # the H100's device memory rate (the tail_runs bound)


def stage_targets() -> list:
    """(stage, module, attribute) of each stage: the attribute the step
    looks up at each call."""
    from sniffles_tpu_torch.ops import clustering as tc, merge_relax as tmr
    from sniffles_tpu_torch.parallel import engine
    return [("sort and seed", tc, "sort_and_seed"), ("relaxation", tmr, "merge_relax"),
            ("resplit", tc, "_resplit"), ("statistics", engine, "call_statistics"),
            ("support_sa", engine, "seg_sum"), ("tail", engine, "candidate_tail")]


@contextlib.contextmanager
def staged(marks: list | None = None):
    """Wraps every stage in a record_function range named PREFIX + stage
    for the duration of the block; with `marks`, also appends (stage,
    start event, end event) of each call on the card."""
    saved = []

    def wrap(label, fn):
        def run(*args, **kwargs):
            timed = marks is not None and torch.cuda.is_available()
            with torch.profiler.record_function(PREFIX + label):
                if timed:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = fn(*args, **kwargs)
                if timed:
                    ev[1].record()
                    marks.append((label, *ev))
            return out
        return run

    try:
        for label, mod, attr in stage_targets():
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(label, getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def stage_split(events, steps: int) -> dict:
    """{stage: (device us a step, launches a step, {kernel: us a step},
    calls a step)}, and under None the device kernels of no stage, from the
    profiler's events of `steps` steps run inside staged(). A kernel
    belongs to the stage whose range on the device timeline (the
    profiler's device annotation of the record_function range) holds its
    start, so kernels launched outside torch (ctypes) count too."""
    cuda = torch.autograd.DeviceType.CUDA
    on_dev = [e for e in events if e.device_type == cuda
              and not e.name.startswith("Activity Buffer")]
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
                   for e in on_dev if e.name.startswith(PREFIX))
    starts = [sp[0] for sp in spans]
    out = {}
    for e in events:
        if e.device_type != cuda and e.name.startswith(PREFIX):
            label = e.name[len(PREFIX):]
            us, n, by, calls = out.get(label, (0.0, 0.0, defaultdict(float), 0.0))
            out[label] = (us, n, by, calls + 1 / steps)
    for e in on_dev:
        if e.name.startswith(PREFIX):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        label = spans[i][2] if i >= 0 and e.time_range.start < spans[i][1] else None
        us, n, by, calls = out.get(label, (0.0, 0.0, defaultdict(float), 0.0))
        by[e.name] += e.time_range.elapsed_us() / steps
        out[label] = (us + e.time_range.elapsed_us() / steps, n + 1 / steps, by, calls)
    return out


def engine_inputs(n: int, device: str):
    from sniffles_tpu_torch.parallel.engine import default_params, to_device
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = synthetic_batch(n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict()
    sig, coverage = to_device(sig, np.full(1_000_000, 30, dtype=np.int32), device)
    return sig, coverage, default_params()


def profile(n: int, steps: int, device: str, trace: str | None = None) -> dict:
    """Runs the profile and returns its figures: split (stage_split),
    interval_ms {stage: device ms a step between its CUDA events, on the
    card}, device_us (all device kernels a step), step_ms (CUDA events,
    on the card)."""
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step
    sig, coverage, params = engine_inputs(n, device)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for _ in range(2):
        call_pipeline_step(sig, coverage, params)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    marks = []
    with staged(marks), torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            last = call_pipeline_step(sig, coverage, params)
        sync()
    if trace:
        prof.export_chrome_trace(trace)
    split = stage_split(prof.events(), steps)
    out = {"split": split, "device_us": sum(v[0] for v in split.values()),
           "interval_ms": defaultdict(float), "step_ms": None,
           "n_clusters": int(last["n_clusters"])}
    for label, start, stop in marks:
        out["interval_ms"][label] += start.elapsed_time(stop) / steps
    if on_card:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call_pipeline_step(sig, coverage, params)
        stop.record()
        sync()
        out["step_ms"] = start.elapsed_time(stop) / 10
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    args = ap.parse_args()
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("profile_engine: no CUDA device is visible", file=sys.stderr)
            return 2
        os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    fig = profile(args.n, args.steps, args.device, args.trace)
    split = fig["split"]
    print(f"engine step n={args.n} on {args.device}, {args.steps} profiled steps; a step:")
    for label in [t[0] for t in stage_targets()] + [None]:
        us, n, by, calls = split.get(label, (0.0, 0.0, {}, 0.0))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
        interval = fig["interval_ms"].get(label)
        print(f"  {label or 'under no stage':14s} {us / 1e3:9.4f} ms of kernels, {n:5.0f} "
              f"launches" + (f", {calls:.0f} calls" if label else "")
              + (f", {interval:9.4f} ms between its events" if interval is not None else "")
              + "".join(f"; {v / 1e3:.4f} ms {k[:60]}" for k, v in top))
    print(f"  all kernels {fig['device_us'] / 1e3:.4f} ms")
    runs_us = sum(us for name, us in split.get("tail", (0, 0, {}, 0))[2].items()
                  if "tail_runs" in name)
    runs_bytes = 4 * args.n + 4 * (fig["n_clusters"] + 1)
    bound_ms = runs_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  tail_runs {runs_us / 1e3:.4f} ms of the tail stage; its bound {bound_ms:.5f} ms "
          f"({runs_bytes} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: the {args.n} cluster ids "
          f"read, the {fig['n_clusters'] + 1} run starts written)"
          + (f", {bound_ms * 1e3 / runs_us:.1%} of it" if runs_us else ""))
    if fig["step_ms"] is not None:
        print(f"  the step between CUDA events (10 steps, no profiler): {fig['step_ms']:.4f} ms")
    if args.device != "cpu" and fig["device_us"] == 0:
        print("  device time by kernel: not measured (the profiler recorded no device events); "
              "the intervals between CUDA events above stand")
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
