"""The port's call_sample CLI (python -m sniffles_tpu_torch, .bam -> VCF)
against the JAX package's (python -m sniffles_tpu.cli), each with and
without its device path: the port's device path (on by default; on the
CPU through SNIFFLES_TPU_FORCE_CPU, where the merge-sweep wrapper takes
its plain version) and --no-tpu, the JAX package's --tpu-call and its
host path. Two datasets from the port's BAM simulator: six SVs on
200 kb at depth 24, and a phased one (HP/PS tags, --phase) with a
--tandem-repeats BED over two of its sites. All four VCFs must have
identical record lines; both device paths must consume the device
statistics of every child, with equal engine counters.

The worker pool: the port's default command line (--threads 4, the
device path through the parent's device service) and --threads 2 must
give the records of its --threads 0, of its --no-tpu and of the JAX
package's --threads 2 --tpu-call, each consuming every child's device
statistics; a device that fails its warmup (the kernel build, or the
device step itself) makes a --threads 2 run exit non-zero with the
error in its log.

Each run is its own subprocess: both packages register the same
"sniffles.sv" pickle alias, and in one process the second package's
pickles would resolve to the first package's classes.

The port's simulator itself must write the JAX package's bytes (BAM,
index and reference FASTA) for one seed."""
import filecmp
import json
import os
import subprocess
import sys

import pytest

from sniffles_tpu_torch.sim import PlantedSV, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATASETS = {
    "six-svs": dict(ref_len=200_000, depth=24, seed=11, phased=False, tr=None, svs=[
        (30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 1.0), (90_000, "DEL", 500, 1.0),
        (120_000, "INS", 80, 1.0), (150_000, "DEL", 2000, 1.0), (175_000, "DUP", 900, 1.0)]),
    "phased-tandem-repeats": dict(ref_len=160_000, depth=24, seed=7, phased=True,
                                  tr=[(59_000, 61_500), (119_000, 121_500)], svs=[
        (30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 0.5), (90_000, "DEL", 500, 0.5),
        (120_000, "INV", 800, 1.0), (140_000, "INS", 80, 1.0)]),
}

RUNS = {
    "port-device": ("sniffles_tpu_torch", []),
    "port-host": ("sniffles_tpu_torch", ["--no-tpu"]),
    "jax-device": ("sniffles_tpu.cli", ["--tpu-call"]),
    "jax-host": ("sniffles_tpu.cli", []),
}


def planted(layout):
    return [PlantedSV(pos=p, svtype=t, svlen=ln, vaf=v) for p, t, ln, v in layout]


def run(module, args, cwd, counters):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["SNIFFLES_TPU_COUNTERS_JSON"] = str(counters)
    if os.path.exists(counters):
        os.unlink(counters)
    r = subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                       text=True, env=env, cwd=str(cwd), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    if not os.path.exists(counters):
        return None
    with open(counters) as f:
        return json.load(f)


def records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


@pytest.mark.parametrize("name", list(DATASETS))
def test_call_sample_four_way_records(name, tmp_path):
    spec = DATASETS[name]
    bam, fasta = write_dataset(str(tmp_path), ref_len=spec["ref_len"], depth=spec["depth"],
                               read_len=12_000, seed=spec["seed"], phased=spec["phased"],
                               svs=planted(spec["svs"]))
    args = ["--input", bam, "--reference", fasta, "--threads", "0"]
    if spec["phased"]:
        args.append("--phase")
    if spec["tr"]:
        bed = tmp_path / "tr.bed"
        bed.write_text("".join(f"chr1\t{lo}\t{hi}\n" for lo, hi in spec["tr"]))
        args += ["--tandem-repeats", str(bed)]

    outs, counters = {}, {}
    for label, (module, extra) in RUNS.items():
        vcf = tmp_path / f"{label}.vcf"
        counters[label] = run(module, args + ["--vcf", str(vcf)] + extra, tmp_path,
                              tmp_path / f"{label}.json")
        outs[label] = records(vcf)

    assert len(outs["jax-host"]) == len(spec["svs"])
    for label in RUNS:
        assert outs[label] == outs["jax-host"], label

    port, jax = counters["port-device"], counters["jax-device"]
    assert port.pop("device_tasks") == 1
    assert port == jax
    assert port["engine_consumed"] == port["children_total"] > 0
    assert counters["port-host"] is None


THREADED_RUNS = {
    "port-default": ("sniffles_tpu_torch", []),
    "port-threads-2": ("sniffles_tpu_torch", ["--threads", "2"]),
    "port-threads-0": ("sniffles_tpu_torch", ["--threads", "0"]),
    "port-host": ("sniffles_tpu_torch", ["--threads", "2", "--no-tpu"]),
    "jax-threads-2": ("sniffles_tpu.cli", ["--threads", "2", "--tpu-call"]),
}


@pytest.fixture(scope="module")
def two_contig_bam(tmp_path_factory):
    """Two contigs, so that the pool runs two call tasks."""
    tmp = tmp_path_factory.mktemp("twocontig")
    return write_dataset(str(tmp), ref_len=160_000, depth=20, read_len=12_000, seed=23,
                         n_contigs=2, svs=planted([
                             (30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 1.0),
                             (90_000, "DEL", 500, 1.0), (120_000, "DUP", 900, 1.0)]))


def test_call_sample_worker_pool_records(two_contig_bam, tmp_path):
    bam, fasta = two_contig_bam
    outs, counters = {}, {}
    for label, (module, extra) in THREADED_RUNS.items():
        vcf = tmp_path / f"{label}.vcf"
        counters[label] = run(module, ["--input", bam, "--reference", fasta,
                                       "--vcf", str(vcf)] + extra, tmp_path,
                              tmp_path / f"{label}.json")
        outs[label] = records(vcf)
    assert len(outs["port-threads-0"]) >= 6
    for label in THREADED_RUNS:
        assert outs[label] == outs["port-threads-0"], label
    for label in ("port-default", "port-threads-2"):
        port = counters[label]
        assert port["device_tasks"] == 2
        assert port["engine_consumed"] == port["children_total"] > 0
        # every task went through the parent's service; no kernel on the CPU
        assert port["service_requests"] == 2
        assert port["kernel_sweep_cuts"] == port["kernel_merge_sweep"] == 0
    assert counters["port-host"] is None


BROKEN_DEVICE = {
    # the kernel build fails, as on a machine without nvcc
    "kernel-build": """
import torch
torch.cuda.is_available = lambda: True
from sniffles_tpu_torch.ops import _build
def broken(*args, **kwargs):
    raise RuntimeError("nvcc not found (broken for the test)")
_build.build_all = broken
""",
    # the device step itself fails on the CPU device
    "device-step": """
import os
os.environ["SNIFFLES_TPU_FORCE_CPU"] = "1"
from sniffles_tpu_torch.ops import clustering
def broken(*args, **kwargs):
    raise RuntimeError("the device step is broken for the test")
clustering.call_task_packed = broken
""",
}


@pytest.mark.parametrize("how", list(BROKEN_DEVICE))
def test_device_failure_fails_a_threaded_run(how, two_contig_bam, tmp_path):
    """No device error is rerouted to the host: the warmup's error answers
    every request, each task ends as an ErrorResult, and the run exits 1
    with the error in its log."""
    bam, fasta = two_contig_bam
    code = BROKEN_DEVICE[how] + """
import sys
from sniffles_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SNIFFLES_TPU_FORCE_CPU", None)
    r = subprocess.run([sys.executable, "-c", code, "--input", bam, "--reference", fasta,
                        "--vcf", str(tmp_path / "o.vcf"), "--threads", "2"],
                       capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    log = r.stdout + r.stderr
    assert r.returncode == 1, log[-3000:]
    assert "device warmup failed" in log and "broken" in log
    assert "2 task(s) failed" in log
    assert records(tmp_path / "o.vcf") == []


def test_write_dataset_writes_the_jax_packages_bytes(tmp_path):
    code = """
import sys
from sniffles_tpu.sim import PlantedSV, write_dataset
svs = [PlantedSV(pos=p, svtype=t, svlen=ln, vaf=v) for p, t, ln, v in
       [(20_000, "INS", 150, 0.6), (45_000, "DEL", 300, 1.0), (70_000, "DUP", 700, 1.0),
        (95_000, "INV", 650, 1.0)]]
write_dataset(sys.argv[1], ref_len=120_000, depth=20, read_len=10_000, seed=5, svs=svs,
              phased=True, n_contigs=2)
"""
    (tmp_path / "jax").mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "jax")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    (tmp_path / "port").mkdir()
    svs = planted([(20_000, "INS", 150, 0.6), (45_000, "DEL", 300, 1.0),
                   (70_000, "DUP", 700, 1.0), (95_000, "INV", 650, 1.0)])
    write_dataset(str(tmp_path / "port"), ref_len=120_000, depth=20, read_len=10_000,
                  seed=5, svs=svs, phased=True, n_contigs=2)
    for name in ("sim.bam", "sim.bam.bai", "ref.fa"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name


def test_dense_layout_is_the_bench_legs():
    """sim.dense_layout is a copy of bench.py::_dense_layout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_module", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from sniffles_tpu_torch.sim import dense_layout
    ours = [vars(sv) for sv in dense_layout(300_000)]
    theirs = [vars(sv) for sv in bench._dense_layout(300_000)]
    assert ours == theirs and len(ours) > 100


def test_task_past_the_stats_capacity_takes_the_host_sweep():
    """More resplit children than the stats block's max(1024, N // 8)
    slots: device_clusters reports the task (None, fb_capacity) and the
    task's clusters come from the exact host sweep, as the JAX package's
    capacity fallback gives them."""
    from sniffles_tpu_torch import cluster
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import Lead, LeadProvider
    from sniffles_tpu_torch.parallel.device_call import device_clusters
    from sniffles_tpu_torch.pipeline.tasks import CallTask

    config = SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf")
    config.device = "cpu"
    provider = LeadProvider(config, 0, "chr1")
    for k in range(1100):               # 1,100 one-child clusters, 2,200 leads
        for r in range(2):
            pos = 10_000 + 5_000 * k + r
            provider.record_lead(Lead(read_id=2 * k + r, read_qname=f"r{k}.{r}",
                                      contig="chr1", ref_start=pos, ref_end=pos,
                                      qry_start=0, qry_end=0, strand="+", mapq=60,
                                      nm=0.0, source="INLINE", svtype="INS", svlen=300),
                                 pos // 100 * 100)
    provider.start, provider.end = 0, 10_000_000
    counters = {}
    assert device_clusters(provider, config, None, counters=counters) is None
    assert counters == {"device_tasks": 1, "fb_capacity": 1}

    task = CallTask(contig="chr1", start=0, end=10_000_000, id=0, sv_id=0, config=config)
    task.lead_provider = provider
    ids = [c.id for c in task._iter_clusters(config)]
    assert task.engine_counters["fb_capacity"] == 1
    assert ids == [c.id for t in ("INS",) for c in cluster.resolve(t, provider, config, None)]
    assert len(ids) == 1100


# two contigs whose reads differ in their mismatch rate, so that each
# call task has a regional NM statistic of its own (mosaic QC reads it)
NM_LAYOUT = [(30_000, "DEL", 120, 0.08), (70_000, "INS", 150, 0.15),
             (110_000, "DEL", 500, 0.3), (150_000, "DUP", 900, 0.5),
             (190_000, "INS", 80, 1.0), (230_000, "DEL", 2000, 0.12),
             (270_000, "INV", 800, 0.5), (310_000, "INS", 300, 0.25),
             (350_000, "DEL", 250, 1.0), (380_000, "INS", 600, 0.1)]

NM_RUNS = {
    "port-threads-0": ("sniffles_tpu_torch", ["--threads", "0"]),
    "port-threads-2": ("sniffles_tpu_torch", ["--threads", "2"]),
    "port-host-threads-0": ("sniffles_tpu_torch", ["--threads", "0", "--no-tpu"]),
    "port-host-threads-2": ("sniffles_tpu_torch", ["--threads", "2", "--no-tpu"]),
    # one task a worker: the JAX package's shared-config NM statistic is
    # then its own task's (at --threads 0 its decode-ahead makes the
    # output depend on timing)
    "jax-threads-2": ("sniffles_tpu.cli", ["--threads", "2", "--tpu-call"]),
}


def test_contigs_of_different_nm_match_jax(tmp_path):
    """--mosaic on two contigs of different mismatch rates: the port on
    both paths at --threads 0 and 2 gives the JAX package's records at
    --threads 2, chr2's included."""
    bam, fasta = write_dataset(str(tmp_path), ref_len=400_000, depth=30, read_len=12_000,
                               seed=41, n_contigs=2, nm_rates=(0.002, 0.02),
                               svs=planted(NM_LAYOUT))
    outs = {}
    for label, (module, extra) in NM_RUNS.items():
        vcf = tmp_path / f"{label}.vcf"
        run(module, ["--input", bam, "--reference", fasta, "--vcf", str(vcf), "--mosaic",
                     *extra], tmp_path, tmp_path / f"{label}.json")
        outs[label] = records(vcf)
    reference = outs["jax-threads-2"]
    assert {line.split("\t")[0] for line in reference} == {"chr1", "chr2"}
    for label in NM_RUNS:
        assert outs[label] == reference, label
