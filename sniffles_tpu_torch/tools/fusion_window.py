#!/usr/bin/env python3
"""Whether call tasks of one padded width meet in the device service's
fusion window (`parallel/device_service.py`, SNIFFLES_TPU_FUSION_WINDOW_MS),
and at which window, on call_sample with many contigs of one size at the
default --threads 4:

    python3 sniffles_tpu_torch/tools/fusion_window.py [--windows 0,12,50,100]
        [--contigs 8] [--ref-len 3000000] [--depth 24] [--out DIR]

It writes a BAM with `sim.write_dataset` (`sim.dense_layout` on every
contig, reads of 12 kb, seed 23), so that every task has about the same
number of signatures and one padded width; at the default size a task's
decode outlasts the service's warmup on the H100, so requests arrive
after it and the window decides what fuses. Then, for each window W in
ms, it runs the CLI in a child process (as `python -m sniffles_tpu_torch`
does, with SNIFFLES_TPU_FUSION_WINDOW_MS=W) and prints: the child's wall
from its start to its end, its analysis time, the service's counters
(requests, fused batches and the requests in them, window waits) and the
gaps between the arrivals of consecutive call_task requests of one
padded width at the parent (ms, in arrival order; the child records each
arrival's time in DeviceServer.submit), and how many of them arrived
before the service's warmup ended (those wait in its queue and fuse
whatever the window). Every window's records must equal the first
window's, else it exits 1. Last, the card's nvidia-smi name and power
limit.

It runs on the card; SNIFFLES_TPU_FORCE_CPU=1 runs the device path on
the CPU (a trial at small sizes).

    python3 sniffles_tpu_torch/tools/fusion_window.py --child ARRIVALS ARGS...

is one such child: the CLI with ARGS, the arrivals saved to ARRIVALS
(JSON) when it ends.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)

SEED = 23
READ_LEN = 12_000


def child(arrivals_path, cli_args):
    """The CLI in this process, every DeviceServer.submit's time, kind and
    padded width recorded."""
    import runpy
    from sniffles_tpu_torch.parallel.device_service import DeviceServer
    submit, warm, arrivals = DeviceServer.submit, DeviceServer._warm, []

    def record(server, request, reply):
        width = server._padded(request) if request.kind == "call_task" else 0
        arrivals.append((time.monotonic(), request.kind, width))
        return submit(server, request, reply)

    def record_warm(server):
        warm(server)
        arrivals.append((time.monotonic(), "warmup ended", 0))

    DeviceServer.submit, DeviceServer._warm = record, record_warm
    sys.argv = ["sniffles_tpu_torch", *cli_args]
    try:
        runpy.run_module("sniffles_tpu_torch", run_name="__main__", alter_sys=True)
    finally:
        with open(arrivals_path, "w") as f:
            json.dump(arrivals, f)


def queued_behind_warmup(arrivals):
    """call_task requests that arrived before the warmup ended (they wait
    in the queue and may fuse whatever the window)."""
    ended = [t for t, kind, _ in arrivals if kind == "warmup ended"]
    return sum(1 for t, kind, _ in arrivals
               if kind == "call_task" and (not ended or t < ended[0]))


def width_gaps(arrivals):
    """ms between consecutive call_task arrivals of one padded width."""
    last, gaps = {}, []
    for t, kind, width in arrivals:
        if kind != "call_task":
            continue
        if width in last:
            gaps.append(round((t - last[width]) * 1000.0, 3))
        last[width] = t
    return gaps


def records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def run_window(window_ms, bam, fasta, out):
    vcf = os.path.join(out, f"w{window_ms}.vcf")
    counters = os.path.join(out, f"w{window_ms}.counters.json")
    arrivals = os.path.join(out, f"w{window_ms}.arrivals.json")
    env = dict(os.environ, SNIFFLES_TPU_FUSION_WINDOW_MS=str(window_ms),
               SNIFFLES_TPU_COUNTERS_JSON=counters,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, os.path.abspath(__file__), "--child", arrivals,
           "--input", bam, "--reference", fasta, "--vcf", vcf, "--allow-overwrite"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          env=env, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:])
        raise SystemExit(f"the CLI with a {window_ms} ms window exited {proc.returncode}")
    analysis = [line.split("Analysis took ", 1)[-1] for line in proc.stdout.splitlines()
                if "Analysis took" in line]
    with open(counters) as f:
        service = {k: v for k, v in json.load(f).items() if k.startswith("service_")}
    with open(arrivals) as f:
        arrived = json.load(f)
    print(f"window {window_ms} ms: wall {wall:.3f} s, analysis {' '.join(analysis)}, "
          f"{json.dumps(service, sort_keys=True)}, {queued_behind_warmup(arrived)} call_task "
          f"requests before the warmup's end, same-width arrival gaps (ms) "
          f"{width_gaps(arrived)}", flush=True)
    return records(vcf)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", default="0,12,50,100")
    ap.add_argument("--contigs", type=int, default=8)
    ap.add_argument("--ref-len", type=int, default=3_000_000)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--out", default=None, help="directory for the BAM and VCFs "
                    "(default: a temporary one)")
    args = ap.parse_args()
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    with tempfile.TemporaryDirectory(prefix="fusion_window_") as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        t0 = time.perf_counter()
        bam, fasta = write_dataset(out, ref_len=args.ref_len, svs=dense_layout(args.ref_len),
                                   depth=args.depth, read_len=READ_LEN, seed=SEED,
                                   n_contigs=args.contigs)
        print(f"{args.contigs} contigs of {args.ref_len} bp at depth {args.depth}, seed "
              f"{SEED}, written in {time.perf_counter() - t0:.1f} s", flush=True)
        first = None
        for window_ms in (int(w) for w in args.windows.split(",")):
            got = run_window(window_ms, bam, fasta, out)
            if first is None:
                first = got
            elif got != first:
                raise SystemExit(f"the records with a {window_ms} ms window differ")
        print(f"{len(first)} records, the same at every window", flush=True)
    if not os.environ.get("SNIFFLES_TPU_FORCE_CPU"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3:])
    else:
        main()
