#!/usr/bin/env python3
"""--tpu-mesh over distinct cards of one host: the mesh's shards on
cuda:0 ... cuda:N-1 (the default placement, parallel/mesh.py
mesh_devices), so that every halo crosses between cards:

    python3 sniffles_tpu_torch/tools/mesh_cards.py [--cards 4]
        [--contigs 3] [--ref-len 2000000] [--depth 60] [--out DIR]

It writes the dense call_sample leg (sim.dense_layout on every contig,
reads of 12 kb, seed 17: chip_smoke.py's dense3 at the default sizes)
and runs the CLI in child processes, as `python -m sniffles_tpu_torch`
does: without the mesh at --threads 0, then at --tpu-mesh N (N = --cards)
at --threads 0 and 4; each mesh VCF must equal the run without the mesh,
every task must go through the mesh (mesh_tasks = contigs, no seam
route). Then, in this process, the mesh call step on the largest task's
payload on the N cards against the same step on N CPU shards (rows and
overflow flags bit for bit), and a run at --tpu-mesh 2N, which must be
refused before any task (exit 1) since only N cards are visible. It
prints each child's wall and counters, the step's time on the cards and
on the CPU (host clock, the second call of each: the first loads the
kernels on each card), and last the cards' nvidia-smi names and power
limits. Any failed check exits 1.

It runs on a host with N cards; SNIFFLES_TPU_FORCE_CPU=1 puts every
shard on the CPU (a trial at small sizes, where the refusal check is
skipped).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)

SEED = 17
READ_LEN = 12_000


def fail(msg):
    raise SystemExit(f"mesh_cards FAILED: {msg}")


def records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def run_cli(args, out_dir, label, code=0, script=None):
    """The CLI in a child process (`python -m sniffles_tpu_torch`, or
    `python -c script` that runs it); returns (wall, counters, log)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    counters = os.path.join(out_dir, f"{label}.json")
    env["SNIFFLES_TPU_COUNTERS_JSON"] = counters
    t0 = time.perf_counter()
    cmd = ["-c", script] if script else ["-m", "sniffles_tpu_torch"]
    r = subprocess.run([sys.executable, *cmd, *args, "--allow-overwrite"],
                       capture_output=True, text=True, env=env, timeout=900)
    wall = time.perf_counter() - t0
    log = r.stdout + r.stderr
    if r.returncode != code:
        print(log[-6000:])
        fail(f"{label} exited {r.returncode}, not {code}")
    c = {}
    if os.path.exists(counters):
        with open(counters) as f:
            c = json.load(f)
    return wall, c, log


def payload_keeper(out_dir):
    """A child that runs the CLI and pickles every mesh call step's payload."""
    return ("import pickle, runpy, sys\n"
            "from sniffles_tpu_torch.parallel import device_call\n"
            "step, kept = device_call.run_mesh_assign, []\n"
            "def keep(payload, meta):\n"
            "    kept.append((payload, meta))\n"
            "    return step(payload, meta)\n"
            "device_call.run_mesh_assign = keep\n"
            "sys.argv = ['sniffles_tpu_torch', *sys.argv[1:]]\n"
            "try:\n"
            "    runpy.run_module('sniffles_tpu_torch', run_name='__main__', alter_sys=True)\n"
            "finally:\n"
            f"    pickle.dump(kept, open({os.path.join(out_dir, 'payloads.pkl')!r}, 'wb'))\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--contigs", type=int, default=3)
    ap.add_argument("--ref-len", type=int, default=2_000_000)
    ap.add_argument("--depth", type=int, default=60)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    on_cpu = bool(os.environ.get("SNIFFLES_TPU_FORCE_CPU"))
    if not on_cpu and torch.cuda.device_count() < args.cards:
        fail(f"{args.cards} cards wanted, {torch.cuda.device_count()} visible")
    os.environ.pop("SNIFFLES_TPU_MESH_DEVICES", None)   # the default placement
    from sniffles_tpu_torch.parallel import mesh as tmesh
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    out = args.out or tempfile.mkdtemp(prefix="mesh_cards_")
    os.makedirs(out, exist_ok=True)
    devices = tmesh.mesh_devices(args.cards)
    print(f"mesh of {args.cards} shards on {devices}", flush=True)

    t0 = time.perf_counter()
    bam, fa = write_dataset(out, ref_len=args.ref_len, svs=dense_layout(args.ref_len),
                            depth=args.depth, read_len=READ_LEN, seed=SEED,
                            n_contigs=args.contigs)
    print(f"wrote {args.contigs} contigs of {args.ref_len} bp at depth {args.depth} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    common = ["--input", bam, "--reference", fa]
    plain = os.path.join(out, "plain.vcf")
    wall, c, _ = run_cli([*common, "--vcf", plain, "--threads", "0"], out, "plain")
    print(f"without the mesh, --threads 0: {wall:.2f} s, {len(records(plain))} records",
          flush=True)
    mesh = ["--tpu-mesh", str(args.cards)]
    for threads in ("0", "4"):
        vcf = os.path.join(out, f"mesh_t{threads}.vcf")
        # the --threads 0 child keeps the mesh step's payloads
        wall, c, _ = run_cli([*common, "--vcf", vcf, "--threads", threads, *mesh], out,
                             f"mesh_t{threads}",
                             script=payload_keeper(out) if threads == "0" else None)
        if records(vcf) != records(plain):
            fail(f"--tpu-mesh {args.cards} --threads {threads}: records differ from the run "
                 f"without the mesh")
        if c.get("mesh_tasks") != args.contigs or c.get("mesh_seam_host", 0):
            fail(f"--tpu-mesh {args.cards} --threads {threads}: counters {c}")
        print(f"--tpu-mesh {args.cards} --threads {threads}: {wall:.2f} s; records == the "
              f"run without the mesh; counters " + json.dumps(
                  {k: v for k, v in sorted(c.items())
                   if k.startswith(("mesh", "kernel_", "service_requests", "device_tasks"))}),
              flush=True)

    import pickle
    with open(os.path.join(out, "payloads.pkl"), "rb") as f:
        payloads = pickle.load(f)   # this tool's own child wrote it
    payload, meta = max(payloads, key=lambda p: int((p[0]["shards"][:, 5] > 0).sum()))
    from sniffles_tpu_torch.parallel.device_call import MESH_HALO_BP
    halo_w = np.full((args.cards, 1), MESH_HALO_BP, dtype=np.int32)
    step_args = (payload["shards"], payload["offsets"], payload["window_len"], halo_w)
    timed = {}
    for where, devs in (("cards", devices), ("cpu", ["cpu"] * args.cards)):
        step = tmesh.build_sharded_assign(devs, **meta)
        step(*step_args)   # the first call loads the kernels on each card
        t0 = time.perf_counter()
        timed[where] = (step(*step_args), time.perf_counter() - t0)
    (ours, card_s), (cpu, cpu_s) = timed["cards"], timed["cpu"]
    if (not np.array_equal(ours["rows"], cpu["rows"])
            or not np.array_equal(ours["halo_overflow"], cpu["halo_overflow"])):
        fail("the mesh call step on the cards differs from the CPU's")
    print(f"the mesh call step on the largest task ({int((payload['shards'][:, 5] > 0).sum())} "
          f"signatures, {args.cards} shards of width {payload['shards'].shape[2]}): rows and "
          f"overflow flags == the CPU's, bit for bit; {card_s:.4f} s on {devices}, "
          f"{cpu_s:.4f} s on the CPU (host clock, the second call of each)", flush=True)

    if not on_cpu:
        _, _, log = run_cli([*common, "--vcf", os.path.join(out, "refused.vcf"), "--threads",
                             "0", "--tpu-mesh", str(2 * args.cards)], out, "refused", code=1)
        if f"--tpu-mesh {2 * args.cards}" not in log or os.path.exists(
                os.path.join(out, "refused.vcf")):
            fail("the run at twice the cards was not refused before any task")
        print(f"--tpu-mesh {2 * args.cards} with {args.cards} cards visible: refused before "
              f"any task (exit 1)", flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())


if __name__ == "__main__":
    main()
