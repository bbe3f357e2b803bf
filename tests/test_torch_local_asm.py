"""The local-assembly rescue (--dev-locasm-do: local_asm.py, ops/poa.py
with the graph POA of the port's native library, ops/align.py) and the
leadtab cache (--dev-cache) of the port against the JAX package's.

- LocalAsm.assembly of both packages on the datasets of
  tests/test_local_asm_rescue.py: the same calls rescued to the same
  positions.
- The CLI with --dev-locasm-do on a sample whose INS and DEL are filtered
  (--minsupport above the depth), so that the gate of
  pipeline/tasks.py::_try_local_assembly assembles both: the port's
  device path and host path at --threads 0 and 2, and its run on the
  sample's CRAM, write the JAX package's records, each rescued (LASM).
- --dev-cache: a second run loads each task's leadtab from the cache
  (its log says so) and writes the first run's records, which equal the
  JAX package's.
- A BAM under a directory whose name holds "cram": the JAX package opens
  it as a CRAM for the rescue (local_asm.py:146) and fails; the port
  decides by the .cram extension and rescues both calls.

Each CLI run is its own subprocess (tests/test_torch_snf_e2e.py::run)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from sniffles_tpu_torch.sim import PlantedSV, random_seq, write_cram, write_dataset
from tests.test_torch_snf_e2e import REPO, run, run_dir, split_vcf


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native host library is built at first use")


def rescue_dataset(d, seed, layout, ref_len):
    rng = np.random.default_rng(seed)
    svs = [PlantedSV(pos=pos, svtype=t, svlen=ln, seq=random_seq(rng, ln) if t == "INS" else "")
           for pos, t, ln in layout]
    return write_dataset(str(d), ref_len=ref_len, depth=18, read_len=10_000, seed=seed, svs=svs)


@pytest.mark.parametrize("svtype,svlen,seed,shift,scale", [
    ("INS", 220, 31, 25, 0.9), ("DEL", 300, 31, 25, 0.9), ("INS", 400, 32, 15, 0.95)])
def test_assembly_matches_jax(tmp_path, svtype, svlen, seed, shift, scale):
    """tests/test_local_asm_rescue.py's imprecise filtered call, rescued by
    both packages to the same call."""
    from sniffles_tpu.config import SnifflesConfig as JaxConfig
    from sniffles_tpu.local_asm import LocalAsm as JaxLocalAsm
    from sniffles_tpu.svcall import SVCall as JaxSVCall
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.io.bam import AlignmentFile
    from sniffles_tpu_torch.local_asm import LocalAsm
    from sniffles_tpu_torch.svcall import SVCall

    true_pos = 60_000 if seed == 31 else 55_000
    bam, fasta = rescue_dataset(tmp_path, seed, [(true_pos, svtype, svlen)],
                                120_000 if seed == 31 else 110_000)
    rnames = [r.query_name for r in AlignmentFile(bam, require_index=True).fetch(
        region=f"chr1:{true_pos - 2000}-{true_pos + 2000}")]
    calls = []
    for config_cls, call_cls, asm_cls in ((SnifflesConfig, SVCall, LocalAsm),
                                          (JaxConfig, JaxSVCall, JaxLocalAsm)):
        config = config_cls("--input", bam, "--vcf", str(tmp_path / "o.vcf"),
                            "--reference", fasta)
        config.input = bam
        length = int(svlen * scale)
        pos = true_pos + shift
        call = call_cls(contig="chr1", pos=pos, id=f"{svtype}.test", ref="N",
                        alt=f"<{svtype}>", qual=50, filter="SUPPORT_MIN", info={},
                        svtype=svtype, svlen=length if svtype == "INS" else -length,
                        end=pos + 1 if svtype == "INS" else pos + length, genotypes={},
                        precise=False, support=len(rnames), rnames=rnames, postprocess=None,
                        qc=False, nm=0.0, fwd=len(rnames), rev=0)
        rescued = asm_cls(call).assembly(config)
        calls.append((rescued, call.pos, call.end, call.filter, call.qc, dict(call.info)))
    assert calls[0] == calls[1]
    assert calls[0][0] and abs(calls[0][1] - true_pos) <= 25


@pytest.fixture(scope="module")
def filtered_sample(tmp_path_factory):
    """An INS and a DEL at depth 18: with --minsupport 30 both fail the
    support screen and pass the rescue gate."""
    d = tmp_path_factory.mktemp("locasm")
    bam, fasta = rescue_dataset(d, 31, [(40_000, "INS", 220), (80_000, "DEL", 300)], 120_000)
    cram = write_cram(bam, fasta)
    return [bam, bam + ".bai", cram, cram + ".crai", fasta, fasta + ".fai"]


LOCASM = ["--reference", "ref.fa", "--vcf", "a.vcf", "--minsupport", "30", "--dev-locasm-do"]


def test_locasm_cli_matches_jax(filtered_sample, tmp_path):
    runs = {
        "jax-host": ("sniffles_tpu.cli", "sim.bam", ["--threads", "0"]),
        "port-device": ("sniffles_tpu_torch", "sim.bam", ["--threads", "0"]),
        "port-host": ("sniffles_tpu_torch", "sim.bam", ["--threads", "0", "--no-tpu"]),
        "port-threads-2": ("sniffles_tpu_torch", "sim.bam", ["--threads", "2"]),
        "port-cram": ("sniffles_tpu_torch", "sim.cram", ["--threads", "0"]),
    }
    outs = {}
    for label, (module, inp, extra) in runs.items():
        d = run_dir(tmp_path, label, filtered_sample)
        run(module, ["--input", inp, *LOCASM, *extra], d)
        outs[label] = split_vcf(d / "a.vcf")[1]
    reference = outs["jax-host"]
    assert len(reference) == 2
    assert all("LASM" in line.split("\t")[7] and line.split("\t")[6] == "PASS"
               for line in reference)
    for label, records in outs.items():
        assert records == reference, label


def test_dev_cache_second_run_loads_and_matches(filtered_sample, tmp_path):
    """--dev-cache twice in one cache directory: the first run writes each
    task's leadtab, the second loads it, and both write the JAX package's
    records (its own cache, its own directory)."""
    outs, logs = {}, {}
    for label, module in (("first", "sniffles_tpu_torch"), ("second", "sniffles_tpu_torch"),
                          ("jax", "sniffles_tpu.cli")):
        d = run_dir(tmp_path, label, filtered_sample)
        cache = tmp_path / ("jax-cache" if label == "jax" else "cache")
        logs[label] = run_logged(module, ["--input", "sim.bam", "--reference", "ref.fa",
                                          "--vcf", "a.vcf", "--threads", "0", "--dev-cache",
                                          "--dev-cache-dir", str(cache)], d)
        outs[label] = split_vcf(d / "a.vcf")[1]
    assert sorted(os.listdir(tmp_path / "cache")) == ["sim.bam_chr1_0_999999.pickle"]
    assert "leadtab loaded from the cache" not in logs["first"]
    assert "leadtab loaded from the cache" in logs["second"]
    assert outs["first"] == outs["second"] == outs["jax"]
    assert len(outs["first"]) == 2


def run_logged(module, args, cwd, expect_rc=0):
    """A CLI run in a process of its own on the CPU; returns its output
    and log."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu", SNIFFLES_TPU_FORCE_CPU="1")
    r = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                       env=env, cwd=str(cwd), timeout=600)
    out = r.stdout + r.stderr
    assert (r.returncode == 0) == (expect_rc == 0), out[-3000:]
    return out


def test_bam_under_a_cram_directory(filtered_sample, tmp_path):
    """Found in the JAX package and not inherited: its rescue opens any
    input whose path holds "cram" as a CRAM (local_asm.py:146), so a BAM in
    a directory named cram_inputs fails there; the port reads it as the
    BAM it is and rescues both calls (test_locasm_cli_matches_jax holds
    these records against the JAX package's)."""
    d = tmp_path / "cram_inputs"
    d.mkdir()
    for path in filtered_sample:
        os.symlink(path, d / os.path.basename(path))
    args = ["--input", "cram_inputs/sim.bam", "--reference", "cram_inputs/ref.fa", "--vcf",
            "a.vcf", "--minsupport", "30", "--dev-locasm-do", "--threads", "0"]
    run("sniffles_tpu_torch", args, tmp_path)
    records = split_vcf(tmp_path / "a.vcf")[1]
    assert len(records) == 2 and all("LASM" in line for line in records)

    out = run_logged("sniffles_tpu.cli", [*args[:5], "jax.vcf", *args[6:]], tmp_path,
                     expect_rc=1)
    assert "cram_inputs/sim.bam is not a CRAM file" in out
