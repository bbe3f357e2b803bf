"""CRAM input end to end: the port's call_sample (python -m
sniffles_tpu_torch) on a reference-based CRAM written by its simulator
(sim.write_cram), writing --vcf and --snf, on the device path (plain
versions on the CPU) and on the host path, at --threads 0 and 2, against
the JAX package's runs on the same CRAM and the port's own run on the BAM
it came from.

Every VCF's records equal; every SNF from the CRAM equals the JAX
package's device run's in the sense of snf_compare, with input_is_cram
compared like any other key; the BAM run's SNF equals them apart from
the keys that name the input file and its format."""
import os
import shutil

import pytest

from sniffles_tpu_torch.io.snf_compare import snf_differences
from sniffles_tpu_torch.sim import PlantedSV, write_cram, write_dataset
from tests.test_torch_snf_e2e import (SNF_CONFIG_KEYS_THAT_DIFFER, assert_snfs_equal, run,
                                      run_dir, split_vcf)

# what a run on the BAM records differently from a run on its CRAM
INPUT_KEYS = {
    "input": "the input file's name",
    "input_mode": "'rb' for a BAM, 'rc' for a CRAM",
    "input_is_cram": "False for a BAM, True for a CRAM",
}

RUNS = {
    "port-device": ("sniffles_tpu_torch", "sim.cram", []),
    "port-host": ("sniffles_tpu_torch", "sim.cram", ["--no-tpu"]),
    "jax-device": ("sniffles_tpu.cli", "sim.cram", ["--tpu-call"]),
    "jax-host": ("sniffles_tpu.cli", "sim.cram", []),
    "port-bam": ("sniffles_tpu_torch", "sim.bam", []),
}


@pytest.fixture(scope="module")
def cram_sample(tmp_path_factory):
    """Two contigs (a task each), SVs of every kind the simulator plants,
    as a BAM and as the CRAM of the same reads."""
    if shutil.which(os.environ.get("CXX") or "c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native host library is built at first use")
    d = tmp_path_factory.mktemp("cramsample")
    svs = [PlantedSV(pos=p, svtype=t, svlen=ln, vaf=v) for p, t, ln, v in (
        (30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 1.0), (95_000, "DUP", 900, 1.0),
        (125_000, "DEL", 500, 0.5), (140_000, "INV", 800, 1.0))]
    bam, fasta = write_dataset(str(d), ref_len=150_000, depth=18, read_len=10_000, seed=61,
                               n_contigs=2, svs=svs)
    cram = write_cram(bam, fasta)
    return [bam, bam + ".bai", cram, cram + ".crai", fasta, fasta + ".fai"]


@pytest.mark.parametrize("threads", ["0", "2"])
def test_cram_call_matches_jax_and_bam(threads, cram_sample, tmp_path):
    outs = {}
    for label, (module, inp, extra) in RUNS.items():
        d = run_dir(tmp_path, label, cram_sample)
        counters = run(module, ["--input", inp, "--reference", "ref.fa", "--vcf", "a.vcf",
                                "--snf", "a.snf", "--sample-id", "A", "--threads", threads,
                                *extra], d)
        if label in ("port-device", "port-bam"):
            assert counters["engine_consumed"] == counters["children_total"] > 0
            assert counters["device_tasks"] == 2
        outs[label] = d
    records = split_vcf(outs["jax-host"] / "a.vcf")[1]
    assert len(records) >= 5
    for label, d in outs.items():
        assert split_vcf(d / "a.vcf")[1] == records, label
    reference = outs["jax-device"] / "a.snf"
    for label in ("port-device", "port-host", "jax-host"):
        assert_snfs_equal(outs[label] / "a.snf", reference)
    found, differ, _ = snf_differences(outs["port-bam"] / "a.snf", outs["port-device"] / "a.snf",
                                       {**SNF_CONFIG_KEYS_THAT_DIFFER, **INPUT_KEYS})
    assert not found, found
    assert set(INPUT_KEYS) <= differ
