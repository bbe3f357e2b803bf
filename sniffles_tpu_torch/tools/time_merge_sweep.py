#!/usr/bin/env python3
"""Device time of the exact merge sweep (`ops/clustering.merge_sweep` on
the card) on fixed cases, for whichever `sniffles_tpu_torch` comes first
on the import path, so that two versions of the sweep can be timed in
turns in one run on one card:

    python3 sniffles_tpu_torch/tools/time_merge_sweep.py                 # this checkout
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_merge_sweep.py  # the package in DIR

DIR is another checkout of the repo, for instance a commit unpacked with
`git archive` into a directory that .gitignore lists; its kernels are
built there at first use. The cases are made from seeds by the timed
package's own `sim` module, so every version gets the same inputs:
  - "dense3 largest task": the sweep with the most seeds that
    call_sample's device path runs on the dense bench leg (3 contigs of
    2 Mb, depth 60, reads of 12 kb, seed 17; `sim.dense_layout`);
  - the merge-heavy batches of chip_smoke.py phase 2b
    (`sim.fuzz_call_batch`): n = 32,768 seeds 1 and 2, n = 65,536 seed 5,
    and a chain of one svtype (DEL) at n = 4,096, seed 99.
For each it prints the seeds, the merges, the counts tensor the sweep
returned (`SWEEP_COUNTS` names its entries where the package has them)
and the sweep's device time: CUDA events around the wrapper's launches,
the card asleep ahead of the start event so that the host's launch work
stays out, the mean of 10 sweeps, each from a fresh copy of the initial
state, after one that warms up; and the partition's alone
(launch_sweep_cuts, timed the same way). Then the card's nvidia-smi name
and power limit. Needs a CUDA card.

    python3 sniffles_tpu_torch/tools/time_merge_sweep.py --split

first builds the package's ops/clustering.CUTS_CLOCKS variant (where it
has one) and prints, for each case, the partition's cycles a task by part
(ops/clustering.CUTS_CLOCK_PARTS: the initial cuts, the passes' block
scans and their walks, also a pass, the final copy, the heads; `cuts_split`)
over 10 launches, and once the time of an empty kernel of the partition's
block, launched and timed as the partition is: the floor that no design of
one launch goes under. `--device cpu` builds the fuzz cases on the CPU and
prints the plain partition's counts (a dry run; no dense3 case).
"""
import argparse
import contextlib
import ctypes
import io
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

DENSE = dict(ref_len=2_000_000, depth=60, read_len=12_000, seed=17, n_contigs=3)
# (label, seed, n, svtypes) of the fuzz batches
FUZZ = (("fuzz n=32768 seed 1", 1, 32768, (0, 1, 2, 3, 4)),
        ("fuzz n=32768 seed 2", 2, 32768, (0, 1, 2, 3, 4)),
        ("fuzz n=65536 seed 5", 5, 65536, (0, 1, 2, 3, 4)),
        ("single-svtype chain n=4096", 99, 4096, (1,)))
SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of each sweep
REPS = 10


def dense_largest(tmp: str, meta: dict):
    """The inputs and initial state of the sweep with the most seeds in
    call_sample's device path over the dense bench leg."""
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    bam, fa = write_dataset(tmp, svs=dense_layout(DENSE["ref_len"]), **DENSE)
    sweep, kept = tc.merge_sweep, []

    def keep(inputs, state, **params):
        kept.append(({k: v.clone() for k, v in inputs.items()},
                     {k: v.clone() for k, v in state.items()}))
        return sweep(inputs, state, **params)

    tc.merge_sweep = keep     # call_task_packed looks the wrapper up at each call
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--input", bam, "--reference", fa, "--threads", "0",
                           "--vcf", os.path.join(tmp, "calls.vcf")])
    finally:
        tc.merge_sweep = sweep
    if rc != 0 or not kept:
        raise SystemExit(f"time_merge_sweep: call_sample exited {rc} after {len(kept)} sweeps")
    return max(kept, key=lambda case: int(case[0]["nseeds"][0]))


def fuzz_case(seed: int, n: int, svtypes, meta: dict, device: str = "cuda"):
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import fuzz_call_batch
    packed = torch.from_numpy(fuzz_call_batch(seed, n, svtypes=svtypes)).to(device)
    sig = tc.packed_signatures(packed)
    return tc.sweep_inputs(*tc.sort_and_seed(sig, meta["binsize"]), meta["binsize"])


def cuts_params(meta: dict) -> dict:
    return {k: meta[k] for k in ("cluster_r", "cluster_repeat_h_max", "cluster_merge_bnd")}


def queued_ms(fn, prepare=lambda: None) -> float:
    """Device ms of fn() between two CUDA events, the mean of REPS runs
    after one that warms up; prepare() runs ahead of the card's sleep and
    the start event each time."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(REPS + 1):
        prepare()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    return total / REPS, out


def time_sweep(label: str, inputs: dict, state: dict, meta: dict) -> None:
    from sniffles_tpu_torch.ops import clustering as tc
    params = {k: meta[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                                   "cluster_merge_bnd", "global_repeat")}
    st = {k: torch.empty_like(v) for k, v in state.items()}

    def fresh():
        for k, v in state.items():
            st[k].copy_(v)
    ms, counts = queued_ms(lambda: tc.merge_sweep(inputs, st, **params), fresh)
    nseeds = int(inputs["nseeds"][0])
    merged = nseeds - int(st["alive"].sum())
    n = inputs["seed_type"].shape[-1]
    cuts_ms, _ = queued_ms(lambda: tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta)))
    print(f"  {label}: {nseeds} seeds, {merged} merges, counts {counts.tolist()}; "
          f"sweep {ms:.4f} ms; sweep_cuts alone {cuts_ms:.4f} ms", flush=True)


def parse_cuts_clocks(words, parts) -> dict:
    """cuts_clocks' words (the parts' cycles, then the tasks) as {"tasks":
    k, part: cycles a task, "total": their sum}; {"tasks": 0} for none."""
    w = [int(x) for x in words[:len(parts) + 1]]
    k = w[-1]
    if not k:
        return {"tasks": 0}
    out = {"tasks": k, **{p: w[i] / k for i, p in enumerate(parts)}}
    out["total"] = sum(out[p] for p in parts)
    return out


def cuts_split_text(split: dict, passes: int) -> str:
    """A cuts_split as text: cycles a task, each part's share, and a
    pass's scans and walk."""
    if not split["tasks"]:
        return "no task"
    parts = [p for p in split if p not in ("tasks", "total")]
    shares = ", ".join(f"{p} {split[p]:.0f} ({split[p] / split['total']:.1%})" for p in parts)
    each = (f"; a pass: scans {split['scans'] / passes:.0f}, walk {split['walk'] / passes:.0f}"
            if passes else "")
    return f"{split['total']:.0f} cycles a task: {shares}{each}"


def cuts_split(inputs: dict, state: dict, meta: dict) -> dict:
    """parse_cuts_clocks of REPS launches of the CUTS_CLOCKS build's
    partition on a case, after one that is held against the default
    build's flags and counts."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[-1]
    fn = _build.load("merge_sweep", (tc.CUTS_CLOCKS,)).cuts_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_uint64 * (len(tc.CUTS_CLOCK_PARTS) + 1))()
    cut, _, counts = tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta))
    got, _, got_counts = tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta),
                                              clocks=True)
    nseeds = int(inputs["nseeds"][0])
    if (not torch.equal(cut[:nseeds], got[:nseeds])
            or not torch.equal(counts, got_counts)):
        raise SystemExit("time_merge_sweep: the clocks build's partition differs")
    torch.cuda.synchronize()
    if fn(out) != 0:
        raise SystemExit("time_merge_sweep: reading the clocks failed")
    for _ in range(REPS):
        tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta), clocks=True)
    torch.cuda.synchronize()
    if fn(out) != 0:
        raise SystemExit("time_merge_sweep: reading the clocks failed")
    return parse_cuts_clocks(out, tc.CUTS_CLOCK_PARTS)


def empty_ms() -> float:
    """Device ms of one block of the CUTS_CLOCKS build's empty kernel,
    launched and timed as the partition is."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import clustering as tc
    fn = _build.load("merge_sweep", (tc.CUTS_CLOCKS,)).cuts_empty
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]

    def launch():
        if fn(1, torch.cuda.current_stream().cuda_stream) != 0:
            raise SystemExit("time_merge_sweep: the empty launch failed")
    return queued_ms(launch)[0]


def dry_run(meta: dict) -> int:
    """The fuzz cases built on the CPU, each with its plain partition."""
    from sniffles_tpu_torch.ops import clustering as tc
    for label, seed, n, svtypes in FUZZ:
        inputs, state = fuzz_case(seed, n, svtypes, meta, "cpu")
        _, _, counts = tc.sweep_cuts_plain(inputs, state, **cuts_params(meta))
        print(f"  {label}: {int(inputs['nseeds'][0])} seeds; plain partition "
              + ", ".join(f"{k} {v}" for k, v in zip(tc.SWEEP_COUNTS, counts.tolist())),
              flush=True)
    print(f"  split parts: {', '.join(getattr(tc, 'CUTS_CLOCK_PARTS', ()))}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--split", action="store_true",
                    help="the partition's cycles by part and the empty launch's time")
    args = ap.parse_args()
    import sniffles_tpu_torch
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.parallel.device_call import standard_call_meta
    meta = standard_call_meta(SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf"))
    if args.device == "cpu":
        return dry_run(meta)
    if not torch.cuda.is_available():
        print("time_merge_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import clustering as tc
    print(f"package {os.path.dirname(os.path.abspath(sniffles_tpu_torch.__file__))}",
          flush=True)
    split = args.split and hasattr(tc, "CUTS_CLOCKS")
    if split:
        from sniffles_tpu_torch.ops import _build
        _build.load("merge_sweep", (tc.CUTS_CLOCKS,))
    with tempfile.TemporaryDirectory(prefix="time_merge_sweep_") as tmp:
        cases = [("dense3 largest task", *dense_largest(tmp, meta))]
    cases += [(label, *fuzz_case(seed, n, svtypes, meta)) for label, seed, n, svtypes in FUZZ]
    for label, inputs, state in cases:
        time_sweep(label, inputs, state, meta)
    if split:
        for label, inputs, state in cases:
            n = inputs["seed_type"].shape[-1]
            passes = int(tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta))[2][3])
            print(f"  split, {label}: {passes} passes; "
                  f"{cuts_split_text(cuts_split(inputs, state, meta), passes)}", flush=True)
        print(f"  an empty kernel of the partition's block (1 block of 1024 threads), "
              f"timed as the partition: {empty_ms():.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
