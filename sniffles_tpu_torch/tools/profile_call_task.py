#!/usr/bin/env python3
"""Where the device time of a call task (`ops/clustering.call_task_packed`,
the call path's device step) goes, by stage, for whichever
`sniffles_tpu_torch` comes first on the import path:

    python3 sniffles_tpu_torch/tools/profile_call_task.py [--dense DIR] [--reps 3]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/profile_call_task.py --dense DIR2

Inputs, each a packed (15, n) batch on the card:
  - "dense3 largest": the widest task (n = 32,768) of call_sample on
    bench.py's dense leg (3 contigs of 2 Mb, depth 60, seed 17,
    sim.dense_layout; chip_smoke.py phase 4's dense3), written to DIR (or
    read from it when it holds sim.bam) and run in process on the device
    path (--threads 0) with every task's packed batch kept;
  - "fuzz 2^15" and "fuzz 2^21": sim.fuzz_call_batch(1, n), whose seeds
    merge;
  - "chain 2^21": sim.relax_chain_batch(2^21) (568 tiled 36-link chains)
    packed as a call task.
Each stage of the task runs inside a record_function range of its own (the
module functions are wrapped, never edited: staged; profile_engine.py's
stage_split with these stages):
  sort and seed      ops/clustering.sort_and_seed
  sweep_inputs       ops/clustering.sweep_inputs (the seeds' slot state)
  sweep              ops/clustering.merge_sweep (csrc/merge_sweep.cu)
  boundaries         ops/clustering._sweep_boundaries
  fold               ops/clustering.merge_inner_fold
  resplit_child_ids  ops/clustering.resplit_child_ids
  statistics         ops/clustering.call_statistics (csrc/call_stats.cu)
  phase_tallies      ops/clustering.phase_tallies
and the rest of the task is "under no stage". Prints, for each input and
stage, the device ms and the launches of one task (the profiler's kernels
under the stage's range over REPS tasks, after one that warms up), the
task's device time between CUDA events outside the profiler (the card
asleep ahead of the start event, the mean of 10; a task of more than a
second, chain 2^21's, is profiled and timed once), and the card's
nvidia-smi name and power limit. Needs a CUDA card, unless --device cpu
(a dry run of the stages at n = 2^15 on the CPU).
"""
import argparse
import contextlib
import io
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of a timed task
PREFIX = "stage: "
# bench.py's dense leg (chip_smoke.py DENSE_*)
DENSE = dict(ref_len=2_000_000, depth=60, read_len=12_000, seed=17, n_contigs=3)


def stage_targets() -> list:
    """(stage, module, attribute) of each stage of a call task: the
    attribute _call_tasks and _task_statistics look up at each call."""
    from sniffles_tpu_torch.ops import clustering as tc
    return [("sort and seed", tc, "sort_and_seed"), ("sweep_inputs", tc, "sweep_inputs"),
            ("sweep", tc, "merge_sweep"), ("boundaries", tc, "_sweep_boundaries"),
            ("fold", tc, "merge_inner_fold"), ("resplit_child_ids", tc, "resplit_child_ids"),
            ("statistics", tc, "call_statistics"), ("phase_tallies", tc, "phase_tallies")]


@contextlib.contextmanager
def staged():
    """Wraps every stage of stage_targets in a record_function range named
    PREFIX + stage for the duration of the block."""
    saved = []

    def wrap(label, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + label):
                return fn(*args, **kwargs)
        return run

    try:
        for label, mod, attr in stage_targets():
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(label, getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def call_meta() -> dict:
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.parallel.device_call import standard_call_meta
    return standard_call_meta(SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf"))


def dense_largest(dense_dir: str, device: str) -> np.ndarray:
    """The widest packed task of call_sample on the dense leg at DIR (written
    there first when DIR holds no sim.bam), on the device path in
    process."""
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    bam = os.path.join(dense_dir, "sim.bam")
    if not os.path.exists(bam):
        os.makedirs(dense_dir, exist_ok=True)
        bam, _ = write_dataset(dense_dir, svs=dense_layout(DENSE["ref_len"]), **DENSE)
    kept, step = [], tc.call_task_packed

    def keep(packed, **meta):
        kept.append(packed.cpu().numpy())
        return step(packed, **meta)
    tc.call_task_packed = keep
    try:
        args = ["--input", bam, "--vcf", os.path.join(dense_dir, "profile.vcf"), "--threads",
                "0", "--allow-overwrite"] + (["--no-tpu"] if device == "cpu" else [])
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(args)
    finally:
        tc.call_task_packed = step
    if rc != 0 or not kept:
        raise SystemExit(f"profile_call_task: call_sample on {bam} exited {rc}, "
                         f"{len(kept)} tasks kept")
    return max(kept, key=lambda p: p.shape[1])


def chain_task(n: int) -> np.ndarray:
    """sim.relax_chain_batch(n) as a packed call task (rows as
    parallel/device_call.pack_task_batch: orig_idx the slot, no phase tag)."""
    from sniffles_tpu_torch.sim import relax_chain_batch
    sig = relax_chain_batch(n)
    packed = np.zeros((15, n), dtype=np.int32)
    for row, key in ((0, "pos"), (1, "svlen"), (2, "svtype"), (4, "repeat"), (5, "valid"),
                     (6, "strand"), (7, "mapq"), (8, "read_id"), (9, "sa")):
        packed[row] = np.asarray(sig[key]).astype(np.int32)
    packed[3] = np.arange(n)
    packed[10] = packed[0] + np.abs(packed[1])
    packed[14] = -1
    return packed


def inputs(dense_dir: str | None, device: str) -> dict:
    from sniffles_tpu_torch.sim import fuzz_call_batch
    if device == "cpu":
        return {"fuzz 2^15": fuzz_call_batch(1, 1 << 15)}
    out = {}
    if dense_dir:
        out["dense3 largest"] = dense_largest(dense_dir, device)
    out.update({"fuzz 2^15": fuzz_call_batch(1, 1 << 15),
                "fuzz 2^21": fuzz_call_batch(1, 1 << 21), "chain 2^21": chain_task(1 << 21)})
    return out


def task_ms(fn, reps: int = 10) -> float:
    """Device ms of fn() between two CUDA events, the mean of `reps` after
    one that warms up, the card asleep ahead of the start event."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(reps + 1):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    return total / reps


def profile(packed: np.ndarray, meta: dict, device: str, reps: int) -> dict:
    """{"split": profile_engine.stage_split of REPS tasks, "task_ms": the
    task between CUDA events (on the card)}. A task that takes more than a
    second on the card (chain 2^21: its exact sweep walks each chain in one
    thread) is profiled and timed once."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.tools import profile_engine as pe
    x = torch.as_tensor(packed).to(device)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    tc.call_task_packed(x, **meta)
    sync()
    timed = 10
    if on_card and time.perf_counter() - t0 > 1.0:
        reps = timed = 1
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with staged(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            tc.call_task_packed(x, **meta)
        sync()
    stages = [PREFIX + label for label, _, _ in stage_targets()]
    return {"split": pe.stage_split(prof.events(), reps, stages),
            "task_ms": task_ms(lambda: tc.call_task_packed(x, **meta), timed) if on_card else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dense", default=None, help="directory of the dense leg's BAM")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("profile_call_task: no CUDA device is visible", file=sys.stderr)
            return 2
        os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import clustering as tc
    print(f"profile_call_task: the package at {os.path.dirname(os.path.dirname(tc.__file__))}")
    meta = call_meta()
    for label, packed in inputs(args.dense, args.device).items():
        fig = profile(packed, meta, args.device, args.reps)
        split = fig["split"]
        valid = int((packed[5] > 0).sum())
        print(f"{label}: n = {packed.shape[1]}, {valid} valid; a task"
              + (f" {fig['task_ms']:.4f} ms between CUDA events" if fig["task_ms"] else "")
              + f", {sum(v[0] for v in split.values()) / 1e3:.4f} ms of kernels, "
              f"{sum(v[1] for v in split.values()):.0f} launches", flush=True)
        for stage in [t[0] for t in stage_targets()] + [None]:
            us, n, by, _ = split.get(stage and PREFIX + stage, (0.0, 0.0, {}, 0.0))
            top = sorted(by.items(), key=lambda kv: -kv[1])[:2]
            print(f"  {stage or 'under no stage':18s} {us / 1e3:9.4f} ms {n:6.0f} launches"
                  + "".join(f"; {v / 1e3:.4f} ms {k[:50]}" for k, v in top), flush=True)
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
