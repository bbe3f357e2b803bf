#!/usr/bin/env python3
"""Population-scale combine benchmark of the port: N simulated samples ->
N SNFs -> a multi-sample combine, the host path against the device path
(the device greedy, and the edit-distance kernel for a batch of at least
ops/edit_distance_batch.DEVICE_MIN_CELLS cells) through the port's device
daemon, in alternating pairs. Carriers of a site share its INS allele,
and equal alleles make no edit-distance pair: the edit distance of this
cohort is never computed.

    python -m sniffles_tpu_torch.tools.bench_combine [--dir DIR] [--samples N]
        [--ref-len BP] [--depth D] [--threads T] [--pairs N] [--mesh N]
        [--site-gap MIN,MAX] [--json-out FILE]

Each sample is an independent simulation over a shared reference with a
shared population SV layout: every sample draws its genotype per site
(hom/het/absent), so the combine path exercises real cross-sample
grouping, genotype merging, and non-included-sample coverage lookup.

A port of tools/bench_combine.py (plant_population, build_sample, main).
What differs:
* Each sample's SNF is built by the port's CLI on the host path
  (--no-tpu --threads 0): the builds open no CUDA context, and an SNF is
  the same from either path. They are untimed.
* The host-against-device pairs (tools/bench_combine.py's --tpu leg) are
  the tool's one mode: the host runs pass --no-tpu, the device runs are
  clients of the port's daemon (sniffles_tpu_torch/bench.py's Daemon and
  timed_pairs), with no card visible to them. The host-only timing and
  the reference Sniffles2 leg are not ported.
* A failure is not swallowed: device records that differ from the host
  records (or the mesh's from the host's) end the run non-zero after the
  JSON line is printed.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sniffles_tpu_torch.bench import (HOST_ENV, Daemon, child_env,  # noqa: E402
                                      device_command, host_command, timed_pairs,
                                      timed_run, vcf_records)


def plant_population(rng, ref_len, site_gap=(30_000, 52_000)):
    """Population SV sites (pos/type/len AND the inserted sequence fixed
    across samples — carriers of one allele share its sequence, as in a
    real cohort; only genotypes vary per sample)."""
    from sniffles_tpu_torch.sim import PlantedSV, random_seq
    sites = []
    pos = 20_000
    i = 0
    while pos < ref_len - 25_000:
        kind = ("INS", "DEL", "INS", "DEL", "DUP", "INV")[i % 6]
        svlen = int(rng.choice((60, 120, 300, 800, 2500)))
        if kind in ("DUP", "INV"):
            svlen = max(svlen, 600)
        seq = random_seq(rng, svlen) if kind == "INS" else ""
        sites.append(PlantedSV(pos=pos, svtype=kind, svlen=svlen, seq=seq))
        pos += int(rng.integers(site_gap[0], site_gap[1]))
        i += 1
    return sites


def sample_svs(idx, ref_len, site_gap):
    """The planted SVs of sample `idx`: the shared layout, each site absent,
    heterozygous or homozygous by the sample's own draw."""
    import numpy as np
    from sniffles_tpu_torch.sim import PlantedSV
    sites = plant_population(np.random.default_rng(7), ref_len, site_gap)
    gt_rng = np.random.default_rng(1000 + idx)
    svs = []
    for s in sites:
        draw = gt_rng.random()
        if draw < 0.25:
            continue  # absent in this sample
        vaf = 1.0 if draw < 0.6 else 0.55
        if s.svtype in ("DUP", "INV"):
            vaf = 1.0
        svs.append(PlantedSV(pos=s.pos, svtype=s.svtype, svlen=s.svlen,
                             seq=s.seq, vaf=vaf))
    return svs


def build_sample(args_tuple):
    """Simulate one sample and call it to SNF on the host path (run in a
    process pool); returns the SNF's path."""
    (dirpath, idx, ref_len, depth) = args_tuple[:4]
    site_gap = args_tuple[4] if len(args_tuple) > 4 else (30_000, 52_000)
    from sniffles_tpu_torch.sim import write_dataset

    name = f"s{idx:03d}"
    snf = os.path.join(dirpath, f"{name}.snf")
    if os.path.exists(snf):
        return snf
    sampledir = os.path.join(dirpath, name)
    os.makedirs(sampledir, exist_ok=True)
    bam, _fa = write_dataset(sampledir, ref_len=ref_len, svs=sample_svs(idx, ref_len, site_gap),
                             depth=depth, read_len=12_000, seed=100 + idx, n_contigs=2)
    p = subprocess.run(host_command(["--input", bam, "--snf", snf, "--sample-id", name,
                                     "--threads", "0", "--allow-overwrite"]),
                       capture_output=True, text=True, env=child_env())
    if p.returncode != 0:
        raise SystemExit(f"SNF build failed for {name}:\n{p.stderr[-2000:]}")
    # the per-sample BAM is large and no longer needed
    shutil.rmtree(sampledir, ignore_errors=True)
    return snf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "sniffles_tpu_torch_bench_combine"))
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--ref-len", type=int, default=1_200_000)
    ap.add_argument("--depth", type=int, default=15)
    ap.add_argument("--threads", type=int, default=max(2, os.cpu_count() or 2))
    ap.add_argument("--mesh", type=int, default=0,
                    help="also run --tpu-mesh N (its records must equal the host's)")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--site-gap", default="30000,52000",
                    help="population site spacing MIN,MAX bp")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    site_gap = tuple(int(x) for x in args.site_gap.split(","))

    os.makedirs(args.dir, exist_ok=True)
    t0 = time.perf_counter()
    work = [(args.dir, i, args.ref_len, args.depth, site_gap)
            for i in range(args.samples)]
    with ProcessPoolExecutor(max_workers=args.threads, mp_context=get_context("spawn")) as ex:
        snfs = list(ex.map(build_sample, work))
    total_mb = sum(os.path.getsize(s) for s in snfs) / 1e6
    print(f"# {len(snfs)} sample SNFs ({total_mb:.1f} MB total, "
          f"{time.perf_counter()-t0:.0f}s to build)", flush=True)

    result = {"samples": len(snfs), "snf_mb": round(total_mb, 1),
              "threads": args.threads, "site_gap": list(site_gap)}
    ours = os.path.join(args.dir, "ours.vcf")
    common = ["--input", *snfs, "--threads", str(args.threads), "--allow-overwrite"]
    host_cmd = host_command([*common, "--vcf", ours])
    differ = []

    daemon = Daemon(rundir=args.dir)
    tpu_vcf = os.path.join(args.dir, "tpu.vcf")
    counters_path = os.path.join(args.dir, "combine_counters.json")
    tpu_cmd = device_command([*common, "--vcf", tpu_vcf], "--tpu-combine")
    try:
        daemon.start()
        p = timed_pairs(host_cmd, tpu_cmd, HOST_ENV, daemon.env(counters_path),
                        pairs=args.pairs)
    finally:
        daemon.stop()
    r_ours = vcf_records(ours)
    identical = vcf_records(tpu_vcf) == r_ours
    result["combine_pairs"] = p
    result["combine_seconds_host"] = p["host_median"]
    result["combine_seconds_tpu"] = p["tpu_median"]
    result["tpu_records_identical"] = identical
    with open(counters_path) as f:
        result["combine_counters"] = json.load(f)
    if not identical:
        differ.append("device")
    print(f"ours      --threads {args.threads}: host {p['host_median']}s "
          f"vs device {p['tpu_median']}s over {p['pairs']} pairs "
          f"(device wins {p['tpu_wins']}); {len(r_ours)} SVs "
          f"[{'byte-identical' if identical else 'DIVERGED'}]", flush=True)

    if args.mesh:
        mesh_vcf = os.path.join(args.dir, "mesh.vcf")
        t_mesh = timed_run([sys.executable, "-m", "sniffles_tpu_torch", *common,
                            "--vcf", mesh_vcf, "--tpu-mesh", str(args.mesh)], side="mesh")
        identical = vcf_records(mesh_vcf) == r_ours
        result["mesh_seconds"] = round(t_mesh, 2)
        result["mesh_records_identical"] = identical
        if not identical:
            differ.append("mesh")
        print(f"ours mesh --tpu-mesh {args.mesh}: {t_mesh:6.1f}s  "
              f"[{'byte-identical' if identical else 'DIVERGED'} vs host]", flush=True)

    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    if differ:
        print(f"records differ from the host path's: {', '.join(differ)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
