#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's combine device path.

    python3 tools/profile_torch_combine.py [--samples 256] [--seed 2024] [--trace PATH]

Writes a cohort with sniffles_tpu_torch.sim, runs the port's combine
once on the device path to warm up (kernel build, CUDA context), then
times it by host clock (ending in torch.cuda.synchronize()), and runs it
again under torch.profiler. Prints the wall time, the device-busy share
(the union of the device activity intervals, kernels and copies, over
the profiled wall time), the top device activities by time, and the
card's name and power limit; with --trace, writes the chrome trace
there. Needs a CUDA card.
"""
import argparse
import contextlib
import glob
import io
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def combine(snfs, vcf):
    from sniffles_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--input", *snfs, "--vcf", vcf, "--threads", "0",
                       "--allow-overwrite"])
        torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"combine exited {rc}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.sim import write_cohort

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        write_cohort(tmp, args.samples, args.seed)
        snfs = sorted(glob.glob(os.path.join(tmp, "s*.snf")))
        vcf = os.path.join(tmp, "out.vcf")
        combine(snfs, vcf)                       # warm-up
        t0 = time.perf_counter()
        combine(snfs, vcf)
        wall = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            combine(snfs, vcf)
            prof_wall = time.perf_counter() - t0

    # device-side activities only: a CPU op's device time repeats that of
    # the kernels it launched, and CUPTI's buffer requests are the
    # profiler's own overhead
    cuda = torch.autograd.DeviceType.CUDA

    def on_device(e):
        return e.device_type == cuda and not e.key.startswith("Activity Buffer")

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if on_device(e))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    totals = [e for e in prof.key_averages() if on_device(e)]
    print(f"card: {smi}")
    print(f"samples {args.samples}: device path wall {wall:.3f} s "
          f"(profiled run {prof_wall:.3f} s)")
    if not spans:
        print("device time: not measured (the profiler recorded no device events)")
    else:
        print(f"device busy {busy_us / 1e3:.1f} ms in {len(spans)} activities, "
              f"device-busy share {busy_us / 1e6 / prof_wall:.4f} of the profiled wall time")
        for e in sorted(totals, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d} calls  "
                  f"{e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
