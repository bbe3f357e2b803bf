#!/usr/bin/env python3
"""Device time of the call statistics (`ops/call_stats.py`, the kernels of
csrc/call_stats.cu) by how the n slots are filled, for whichever
`sniffles_tpu_torch` comes first on the import path:

    python3 sniffles_tpu_torch/tools/time_call_stats.py [--n 2097152]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_call_stats.py

Cases of n slots (`populations`):
  - "engine": the engine step's clustered batch at chip_smoke.py phase
    10d's inputs (`signatures.synthetic_batch`, n/40 sites, seed 42, a
    genome span of 900 kb), n/40 live slots of about 40 elements;
  - "all invalid": the same with no valid element, every slot empty;
  - "singletons": every slot a cluster of one element;
  - "40 a slot": slot k holds elements 40k..40k+39, the engine's count of
    live slots in array order.
For each it holds the kernels against the plain version on CPU copies
(every key and slot bit for bit), then prints the device time of the
wrapper (the sorts and the kernels) and of the kernels alone (CUDA
events, the card asleep ahead of the start event so that the host's
launch work stays out, the mean of 10 calls after one that warms up);
then ptxas's registers and spills of the two kernels and the card's
nvidia-smi name and power limit. Needs a CUDA card; `--device cpu` builds
the populations and holds nothing (a dry run).
"""
import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

REPS = 10
SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of each call


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
    return {"engine": engine,
            "all invalid": dict(engine, valid=torch.zeros_like(engine["valid"])),
            "singletons": dict(engine, valid=every, cluster_id=ids,
                               n_clusters=torch.tensor(n, dtype=torch.int32, device=device)),
            "40 a slot": dict(engine, valid=every, cluster_id=ids // 40,
                              n_clusters=torch.tensor(-(-n // 40), dtype=torch.int32,
                                                      device=device))}


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


def held(got: dict, want: dict, case: str) -> None:
    for k, v in want.items():
        a, b = got[k].cpu(), v
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise SystemExit(f"time_call_stats: {case}: {k} differs from the plain version")


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
    for case, c in populations(args.n, "cuda").items():
        want = cs.call_statistics_plain({k: v.cpu() for k, v in c.items()}, True)
        held(cs.launch_call_statistics(c, True), want, case)
        inputs = cs.kernel_inputs(c)
        ms = queued_ms(lambda: cs.launch_call_statistics(c, True))
        kernels_ms = queued_ms(lambda: cs.launch_kernels(inputs, c["n_clusters"], True))
        live = int((want["lead_count"] > 0).sum())
        print(f"{case}: {args.n} slots, {live} live; == plain (bit-exact); the wrapper "
              f"{ms:.4f} ms, the kernels alone {kernels_ms:.4f} ms", flush=True)
    log = _build.finish_build(_build.start_build("call_stats", ptxas_verbose=True))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.split('info    :', 1)[-1].strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
