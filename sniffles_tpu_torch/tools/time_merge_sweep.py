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
state, after one that warms up. Then the card's nvidia-smi name and
power limit. Needs a CUDA card.
"""
import contextlib
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


def fuzz_case(seed: int, n: int, svtypes, meta: dict):
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import fuzz_call_batch
    packed = torch.from_numpy(fuzz_call_batch(seed, n, svtypes=svtypes)).cuda()
    sig = tc.packed_signatures(packed)
    return tc.sweep_inputs(*tc.sort_and_seed(sig, meta["binsize"]), meta["binsize"])


def time_sweep(label: str, inputs: dict, state: dict, meta: dict) -> None:
    from sniffles_tpu_torch.ops import clustering as tc
    params = {k: meta[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                                   "cluster_merge_bnd", "global_repeat")}
    st = {k: torch.empty_like(v) for k, v in state.items()}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(REPS + 1):
        for k, v in state.items():
            st[k].copy_(v)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        counts = tc.merge_sweep(inputs, st, **params)
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    nseeds = int(inputs["nseeds"][0])
    merged = nseeds - int(st["alive"].sum())
    print(f"  {label}: {nseeds} seeds, {merged} merges, counts {counts.tolist()}; "
          f"sweep {total / REPS:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_merge_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    import sniffles_tpu_torch
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.parallel.device_call import standard_call_meta
    meta = standard_call_meta(SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf"))
    print(f"package {os.path.dirname(os.path.abspath(sniffles_tpu_torch.__file__))}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="time_merge_sweep_") as tmp:
        time_sweep("dense3 largest task", *dense_largest(tmp, meta), meta)
    for label, seed, n, svtypes in FUZZ:
        time_sweep(label, *fuzz_case(seed, n, svtypes, meta), meta)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
