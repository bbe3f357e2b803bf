#!/usr/bin/env python3
"""Device time of the fused engine's relaxation (`ops/merge_relax.py`, the
kernel of csrc/merge_relax.cu) split by round, for whichever
`sniffles_tpu_torch` comes first on the import path, so that two versions
can be timed in turns in one run on one card:

    python3 sniffles_tpu_torch/tools/time_merge_relax.py                 # this checkout
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_merge_relax.py  # the package in DIR

Cases, each of 2^21 slots:
  - "engine 2^21": the inputs of chip_smoke.py phase 10d
    (`signatures.synthetic_batch`, n/40 sites, seed 42, a genome span of
    900 kb), sorted and seeded as the engine's step does them;
  - "tiled chain 2^21": `sim.relax_chain_batch`, copies of the 36-link
    chain of `sim.relax_chain_positions` 1.1 Mb apart, on which the 32-round
    cap binds (left out for a package that lacks the helper).
For each it checks the kernel against its plain version (boundaries and
rounds), then prints the kernel's device time (CUDA events, the card
asleep ahead of the start event so that the host's launch work stays
out, the mean of 10 relaxations after one that warms up) and the time of
each round: from the device time stamps the kernel writes after each of
its grid barriers where the package's wrapper takes `stamps=`, else from
torch.profiler's record of each round's two kernels. Then ptxas's
registers, spills and shared memory for both engine kernels
(csrc/merge_relax.cu, csrc/candidate_tail.cu, built with -Xptxas -v), and
the card's nvidia-smi name and power limit. Needs a CUDA card.
"""
import inspect
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

N = 1 << 21
REPS = 10
SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of each relaxation


def relax_params() -> dict:
    from sniffles_tpu_torch.parallel.engine import default_params
    p = default_params()
    out = {k: p[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                             "cluster_merge_bnd")}
    out.update(global_repeat=False, binsize=100)
    return out


def sorted_inputs(sig: dict):
    """(sorted batch, seed boundaries, bins) of a signature batch on the card."""
    from sniffles_tpu_torch.ops import clustering as tc
    sig = {k: torch.as_tensor(v).cuda() for k, v in sig.items()}
    return tc.sort_and_seed(sig, 100)


def cases() -> list:
    from sniffles_tpu_torch import sim
    from sniffles_tpu_torch.signatures import synthetic_batch
    out = [("engine 2^21", synthetic_batch(N, N // 40, seed=42, genome_span=900_000,
                                            batch_size=N).as_dict())]
    if hasattr(sim, "relax_chain_batch"):
        out.append(("tiled chain 2^21", sim.relax_chain_batch(N)))
    else:
        print("  tiled chain 2^21: not in this version (no sim.relax_chain_batch)", flush=True)
    return out


def queued_ms(fn) -> float:
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


def rounds_from_stamps(stamps: list, rounds: int) -> tuple:
    """(head-list ms, [(metrics ms, merge ms) of each round that ran]) from
    the kernel's device time stamps in ns: stamps[0] as block 0 starts,
    stamps[1] after the head list's grid barrier, stamps[2r + 2] after
    round r's metrics phase and stamps[2r + 3] after its merge phase."""
    return ((stamps[1] - stamps[0]) / 1e6,
            [((stamps[2 * r + 2] - stamps[2 * r + 1]) / 1e6,
              (stamps[2 * r + 3] - stamps[2 * r + 2]) / 1e6) for r in range(rounds)])


def rounds_from_kernels(kernels: list) -> list:
    """(metrics ms, merge ms, gap ms before the next round) of each round,
    from the device kernels (name, start us, end us) of one relaxation in
    launch order: a relax_metrics launch, then a relax_merge launch, a
    round."""
    metrics = [k for k in kernels if "relax_metrics" in k[0]]
    merges = [k for k in kernels if "relax_merge" in k[0]]
    out = []
    for r, (m, g) in enumerate(zip(metrics, merges)):
        nxt = metrics[r + 1][1] if r + 1 < len(metrics) else g[2]
        out.append(((m[2] - m[1]) / 1e3, (g[2] - g[1]) / 1e3, (nxt - g[2]) / 1e3))
    return out


def profiled_kernels(fn) -> list:
    """The device kernels of one fn() under torch.profiler, in start order."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda), key=lambda k: k[1])


def time_case(label: str, sig: dict, params: dict) -> None:
    from sniffles_tpu_torch.ops import merge_relax as tmr
    s, boundary, bin_ = sorted_inputs(sig)
    want, want_rounds = tmr.merge_relax_plain(s, boundary, bin_, **params)
    got, rounds = tmr.launch_merge_relax(s, boundary, bin_, **params)
    if not torch.equal(got, want) or int(rounds) != want_rounds:
        raise SystemExit(f"time_merge_relax: {label}: the kernel differs from its plain version")
    heads = int(boundary.sum())
    ms = queued_ms(lambda: tmr.launch_merge_relax(s, boundary, bin_, **params))
    print(f"  {label}: {heads} seed heads, {int(want.sum())} after the relaxation, "
          f"{want_rounds} rounds, == plain; kernel {ms:.4f} ms", flush=True)
    if "stamps" in inspect.signature(tmr.launch_merge_relax).parameters:
        stamps = torch.zeros(2 * tmr.MERGE_ITERS_MAX + 2, dtype=torch.int64, device="cuda")
        tmr.launch_merge_relax(s, boundary, bin_, stamps=stamps, **params)
        setup, split = rounds_from_stamps(stamps.tolist(), want_rounds)
        print(f"    from the kernel's stamps: head list {setup:.4f} ms; " + "; ".join(
            f"round {r + 1} metrics {a:.4f} merge {b:.4f} ms" for r, (a, b) in enumerate(split)),
            flush=True)
        return
    split = rounds_from_kernels(profiled_kernels(
        lambda: tmr.launch_merge_relax(s, boundary, bin_, **params)))
    if not split:
        print("    by round: not measured (the profiler recorded no relax_metrics or "
              "relax_merge kernel)", flush=True)
        return
    work, idle = split[:want_rounds], split[want_rounds:]
    print(f"    from the profiler ({len(split)} rounds enqueued): " + "; ".join(
        f"round {r + 1} metrics {a:.4f} merge {b:.4f} gap {c:.4f} ms"
        for r, (a, b, c) in enumerate(work)), flush=True)
    if idle:
        total = sum(a + b + c for a, b, c in idle)
        print(f"    the {len(idle)} rounds after the fixed point: {total:.4f} ms in all "
              f"(kernels and gaps), {total / len(idle):.4f} ms a round", flush=True)


def ptxas_report() -> None:
    from sniffles_tpu_torch.ops import _build
    started = {name: _build.start_build(name, ptxas_verbose=True)
               for name in ("merge_relax", "candidate_tail")}
    for name, st in started.items():
        for line in _build.finish_build(st).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_merge_relax: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    import sniffles_tpu_torch
    print(f"package {os.path.dirname(os.path.abspath(sniffles_tpu_torch.__file__))}",
          flush=True)
    ptxas_report()
    params = relax_params()
    for label, sig in cases():
        time_case(label, sig, params)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
