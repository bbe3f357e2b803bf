"""The port's force calling (--genotype-vcf, the genotype_vcf mode)
against the JAX package's, on the cases of the JAX package's own test
(tests/test_modes_e2e.py::test_genotype_vcf_force_calling): the planted
SVs of a call_sample VCF re-genotype to 1/1, and a target with nothing
in the BAM gives 0/0 with its depth. Targets plain and gzipped, the
device and host paths, --threads 0 and 2: the port's records equal the
JAX package's in every case, and its header too apart from the lines
that stamp the run (the input VCF's own header lines pass through).

Each run is its own subprocess (both packages register the same
"sniffles.sv" pickle alias)."""
import gzip
import os
import subprocess
import sys

import pytest

from sniffles_tpu_torch.sim import PlantedSV, write_dataset
from tests.test_torch_snf_e2e import REPO, run, split_vcf

RUN_STAMPS = ("##command=", "##fileDate=", "##genotypeCommand=", "##genotypeFileDate=")

FAKE_TARGET = ("chr1\t20000\tfake1\tN\t<DEL>\t60\tPASS\t"
               "SVTYPE=DEL;SVLEN=-500;END=20500\tGT:GQ:DR:DV\t1/1:60:0:30\n")


@pytest.fixture(scope="module")
def targets(tmp_path_factory):
    """The BAM of the JAX test, its call_sample VCF (the port's, device
    path) plain and gzipped, and a VCF whose one target has nothing in
    the BAM."""
    tmp = tmp_path_factory.mktemp("genotype")
    bam, fasta = write_dataset(str(tmp), ref_len=150_000, depth=24, read_len=10_000, seed=6,
                               svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=150),
                                    PlantedSV(pos=90_000, svtype="INS", svlen=120)])
    calls = tmp / "calls.vcf"
    run("sniffles_tpu_torch", ["--input", bam, "--vcf", str(calls), "--threads", "0"], tmp)
    assert len(split_vcf(calls)[1]) == 2
    text = calls.read_text()
    (tmp / "calls.vcf.gz").write_bytes(gzip.compress(text.encode()))
    header = "".join(line for line in text.splitlines(True) if line.startswith("#"))
    (tmp / "fake.vcf").write_text(header + FAKE_TARGET)
    return {"bam": bam, "plain": str(calls), "gz": str(tmp / "calls.vcf.gz"),
            "fake": str(tmp / "fake.vcf")}


RUNS = {
    "port-device": ("sniffles_tpu_torch", ["--threads", "0"]),
    "port-host": ("sniffles_tpu_torch", ["--threads", "0", "--no-tpu"]),
    "port-threads-2": ("sniffles_tpu_torch", ["--threads", "2"]),
    "port-host-threads-2": ("sniffles_tpu_torch", ["--threads", "2", "--no-tpu"]),
    "jax-device": ("sniffles_tpu.cli", ["--threads", "0", "--tpu-call"]),
    "jax-host": ("sniffles_tpu.cli", ["--threads", "0"]),
    "jax-threads-2": ("sniffles_tpu.cli", ["--threads", "2", "--tpu-call"]),
}


@pytest.mark.parametrize("target", ["plain", "gz"])
def test_planted_svs_regenotype_as_jax(target, targets, tmp_path):
    outs = {}
    for label, (module, extra) in RUNS.items():
        vcf = tmp_path / f"{label}.vcf"
        counters = run(module, ["--input", targets["bam"], "--genotype-vcf", targets[target],
                                "--vcf", str(vcf), *extra], tmp_path)
        if label in ("port-device", "port-threads-2"):
            # the device path ran: every child consumed its device statistics
            assert counters["engine_consumed"] == counters["children_total"] > 0
            assert counters["device_tasks"] == 1
        outs[label] = split_vcf(vcf, RUN_STAMPS)
    header, records = outs["jax-device"]
    assert len(records) == 2
    assert all(line.split("\t")[-1].startswith("1/1") for line in records), records
    for label, parts in outs.items():
        assert parts == (header, records), label


@pytest.mark.parametrize("label", ["port-device", "port-host", "port-threads-2",
                                   "jax-device", "jax-host"])
def test_unmatched_target_gives_0_0_with_depth(label, targets, tmp_path):
    module, extra = RUNS[label]
    vcf = tmp_path / "out.vcf"
    run(module, ["--input", targets["bam"], "--genotype-vcf", targets["fake"], "--vcf",
                 str(vcf), *extra], tmp_path)
    records = split_vcf(vcf)[1]
    assert len(records) == 1
    gt, gq, dr, dv = records[0].rstrip("\n").split("\t")[-1].split(":")[:4]
    assert gt == "0/0" and int(dr) > 0 and dv == "0", records
    assert records[0].split("\t")[:3] == ["chr1", "20000", "fake1"]


def test_unmatched_target_same_record_in_both_packages(targets, tmp_path):
    outs = []
    for module, extra in (RUNS["port-device"], RUNS["jax-device"]):
        vcf = tmp_path / f"{module}.vcf"
        run(module, ["--input", targets["bam"], "--genotype-vcf", targets["fake"], "--vcf",
                     str(vcf), *extra], tmp_path)
        outs.append(split_vcf(vcf, RUN_STAMPS))
    assert outs[0] == outs[1] and len(outs[0][1]) == 1


def test_genotyped_vcf_gz_has_the_plain_records(targets, tmp_path):
    run("sniffles_tpu_torch", ["--input", targets["bam"], "--genotype-vcf", targets["plain"],
                               "--vcf", str(tmp_path / "plain.vcf"), "--threads", "0"],
        tmp_path)
    run("sniffles_tpu_torch", ["--input", targets["bam"], "--genotype-vcf", targets["plain"],
                               "--vcf", str(tmp_path / "g.vcf.gz"), "--threads", "0"],
        tmp_path)
    assert (tmp_path / "g.vcf.gz.tbi").exists()
    assert not (tmp_path / "g.vcf").exists()
    assert split_vcf(tmp_path / "g.vcf.gz", RUN_STAMPS) == split_vcf(tmp_path / "plain.vcf",
                                                                     RUN_STAMPS)


@pytest.mark.parametrize("threads", ["0", "2"])
def test_task_without_result_fails_the_run(threads, targets, tmp_path):
    """A GenotypeTask that returns no result (its bailout on a target
    without depth values) ends as a failed task, and the run exits 1:
    inline and in the worker pool, where the JAX package's worker sends
    nothing and its parent waits for the task."""
    code = """
import sys
from sniffles_tpu_torch.pipeline import tasks
tasks.GenotypeTask.execute = lambda self, worker=None: None
from sniffles_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, "--input", targets["bam"],
                        "--genotype-vcf", targets["plain"], "--vcf", str(tmp_path / "o.vcf"),
                        "--threads", threads], capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    log = r.stdout + r.stderr
    assert r.returncode == 1, log[-3000:]
    assert "returned no result" in log and "1 task(s) failed" in log
