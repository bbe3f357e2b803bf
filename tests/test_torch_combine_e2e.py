"""The port's combine CLI (python -m sniffles_tpu_torch) against the JAX
package's (python -m sniffles_tpu.cli), host path and device path
(--tpu-combine; the port's device path on the CPU through
SNIFFLES_TPU_FORCE_CPU), on two cohorts: SNFs written by the JAX
package's call_sample from simulated BAMs, and SNFs written by the
port's cohort writer (so the JAX package reads the port's SNFs too).
Record lines must be identical, and the header identical apart from the
command and date lines.

The worker pool: the port's default command line (--threads 4) and
--threads 2, whose workers post their greedy and edit-distance work to
the parent's device service, must give the VCF of the port's --threads 0
and of the JAX package's --threads 2 --tpu-combine; with the device
threshold lowered, the workers' edit-distance batches go to the service.

Each run is its own subprocess: both packages register the same
"sniffles.sv" pickle alias, and in one process the second package's
pickles would resolve to the first package's classes."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(module, args, cwd, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                       text=True, env=env, cwd=str(cwd), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def split_vcf(path):
    header, records = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                if not line.startswith(("##command=", "##fileDate=")):
                    header.append(line)
            else:
                records.append(line)
    return header, records


@pytest.fixture(scope="module")
def jax_call_sample_cohort(tmp_path_factory):
    """Three samples called by the JAX package from simulated BAMs: per
    INS site, samples carry a shared or a divergent allele, with
    jittered breakpoints, plus a DEL and a DUP site (after the JAX
    package's own device-combine CLI test)."""
    from sniffles_tpu.sim import PlantedSV, random_seq, write_dataset
    tmp = tmp_path_factory.mktemp("jaxcohort")
    site_rng = np.random.default_rng(500)
    sites = []
    pos = 20_000
    while pos < 200_000:
        ln = int(site_rng.choice((80, 150, 400)))
        sites.append((pos, ln, random_seq(site_rng, ln), random_seq(site_rng, ln)))
        pos += int(site_rng.integers(9_000, 16_000))
    snfs = []
    for i in range(3):
        rng = np.random.default_rng(501 + i)
        svs = []
        for pos, ln, shared, divergent in sites:
            draw = rng.random()
            if draw < 0.15:
                continue
            svs.append(PlantedSV(pos=pos + int(rng.integers(-25, 26)), svtype="INS",
                                 svlen=ln, seq=shared if draw < 0.75 else divergent))
        svs.append(PlantedSV(pos=205_000, svtype="DEL", svlen=300))
        svs.append(PlantedSV(pos=215_000, svtype="DUP", svlen=700))
        sampledir = tmp / f"c{i}"
        sampledir.mkdir()
        bam, _ = write_dataset(str(sampledir), ref_len=230_000, depth=18,
                               read_len=12_000, seed=540 + i, svs=svs)
        snf = str(tmp / f"c{i}.snf")
        run("sniffles_tpu.cli", ["--input", bam, "--snf", snf, "--sample-id", f"c{i}",
                                 "--threads", "0"], tmp)
        snfs.append(snf)
    return snfs


def write_port_cohort(dirpath, n_samples=4, seed=31):
    code = ("import sys; from sniffles_tpu_torch.sim import write_cohort; "
            f"write_cohort(sys.argv[1], {n_samples}, {seed}, "
            "contigs=(('chr1', 260_000), ('chr2', 200_000)), "
            "lengths=(60, 120, 300, 800))")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-c", code, str(dirpath)], check=True, env=env,
                   timeout=300)
    return [str(dirpath / f"s{i:03d}.snf") for i in range(n_samples)]


@pytest.fixture(scope="module")
def port_sim_cohort(tmp_path_factory):
    return write_port_cohort(tmp_path_factory.mktemp("portcohort"))


@pytest.mark.parametrize("cohort", ["jax_call_sample_cohort", "port_sim_cohort"])
@pytest.mark.parametrize("device", [False, True])
def test_combine_vcf_matches_jax(request, tmp_path, cohort, device):
    snfs = request.getfixturevalue(cohort)
    jax_args = ["--tpu-combine"] if device else []
    port_args = [] if device else ["--no-tpu"]
    ours, theirs = tmp_path / "port.vcf", tmp_path / "jax.vcf"
    counters = tmp_path / "counters.json"
    run("sniffles_tpu_torch", ["--input", *snfs, "--vcf", str(ours), "--threads", "0",
                               *port_args], tmp_path,
        {"SNIFFLES_TPU_COUNTERS_JSON": str(counters)})
    run("sniffles_tpu.cli", ["--input", *snfs, "--vcf", str(theirs), "--threads", "0",
                             *jax_args], tmp_path)
    our_header, our_records = split_vcf(ours)
    their_header, their_records = split_vcf(theirs)
    assert our_header == their_header
    assert our_records == their_records
    assert len(our_records) >= 8
    if device:
        # the device greedy really ran (no silent host path)
        assert json.loads(counters.read_text())["combine_greedy_dispatches"] >= 1


def test_lowered_threshold_takes_device_ed_route(monkeypatch, tmp_path, port_sim_cohort):
    """With DEVICE_MIN_CELLS lowered, the task ED tables go through the
    port's device route (its plain version on the CPU), and the VCF is
    the host path's."""
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.ops import edit_distance_batch as ted

    host = tmp_path / "host.vcf"
    run("sniffles_tpu_torch", ["--input", *port_sim_cohort, "--vcf", str(host),
                               "--no-tpu"], tmp_path)
    monkeypatch.setattr(ted, "DEVICE_MIN_CELLS", 1)
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")
    counters = tmp_path / "counters.json"
    monkeypatch.setenv("SNIFFLES_TPU_COUNTERS_JSON", str(counters))
    dev = tmp_path / "dev.vcf"
    assert cli.main(["--input", *port_sim_cohort, "--vcf", str(dev),
                     "--threads", "0"]) == 0
    totals = json.loads(counters.read_text())
    assert totals.get("ed_device_batches", 0) >= 1
    assert totals.get("ed_host_batches", 0) == 0
    assert split_vcf(dev) == split_vcf(host)


def test_combine_worker_pool_matches(tmp_path, port_sim_cohort):
    outs = {}
    runs = {"port-default": ("sniffles_tpu_torch", []),
            "port-threads-2": ("sniffles_tpu_torch", ["--threads", "2"]),
            "port-threads-0": ("sniffles_tpu_torch", ["--threads", "0"]),
            "jax-threads-2": ("sniffles_tpu.cli", ["--threads", "2", "--tpu-combine"])}
    for label, (module, extra) in runs.items():
        vcf, counters = tmp_path / f"{label}.vcf", tmp_path / f"{label}.json"
        run(module, ["--input", *port_sim_cohort, "--vcf", str(vcf), *extra], tmp_path,
            {"SNIFFLES_TPU_COUNTERS_JSON": str(counters)})
        outs[label] = split_vcf(vcf)
        if label.startswith("port-threads-2") or label == "port-default":
            totals = json.loads(counters.read_text())
            # every greedy went through the parent's service
            assert totals["combine_greedy_dispatches"] >= 2
            assert totals["service_requests"] >= totals["combine_greedy_dispatches"]
            assert totals["kernel_ed_myers"] == 0          # no kernel on the CPU
    assert len(outs["port-threads-0"][1]) >= 8
    for label in runs:
        assert outs[label] == outs["port-threads-0"], label


def test_worker_pool_sends_edit_distance_batches_to_the_service(tmp_path, port_sim_cohort):
    """With DEVICE_MIN_CELLS lowered (in the parent, inherited by the forked
    workers), the workers' ED tables go to the parent's service as ed_batch
    requests, and the VCF is the host path's."""
    host = tmp_path / "host.vcf"
    run("sniffles_tpu_torch", ["--input", *port_sim_cohort, "--vcf", str(host),
                               "--no-tpu"], tmp_path)
    code = """
import sys
from sniffles_tpu_torch.ops import edit_distance_batch
edit_distance_batch.DEVICE_MIN_CELLS = 1
from sniffles_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""
    counters, dev = tmp_path / "counters.json", tmp_path / "dev.vcf"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["SNIFFLES_TPU_COUNTERS_JSON"] = str(counters)
    r = subprocess.run([sys.executable, "-c", code, "--input", *port_sim_cohort,
                        "--vcf", str(dev), "--threads", "2"], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    totals = json.loads(counters.read_text())
    assert totals.get("ed_device_batches", 0) >= 1
    assert totals.get("ed_host_batches", 0) == 0
    assert totals["service_requests"] >= (totals["ed_device_batches"]
                                          + totals["combine_greedy_dispatches"])
    assert split_vcf(dev) == split_vcf(host)


def test_combine_consensus_crashes_in_jax_and_is_refused_by_the_port(tmp_path,
                                                                      port_sim_cohort):
    """--combine-consensus: the JAX package's consensus genotype merge
    unpacks combine's 7-field genotypes into 5 names and exits 1 with a
    ValueError, so there is no reference output to port; the port refuses
    the flag with a usage error and writes no VCF."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    outs = {}
    for module in ("sniffles_tpu.cli", "sniffles_tpu_torch"):
        vcf = tmp_path / f"{module}.vcf"
        r = subprocess.run([sys.executable, "-m", module, "--input", *port_sim_cohort,
                            "--vcf", str(vcf), "--threads", "0", "--combine-consensus"],
                           capture_output=True, text=True, env=env, cwd=str(tmp_path),
                           timeout=600)
        outs[module] = (r.returncode, r.stdout + r.stderr, vcf)
    code, log, _ = outs["sniffles_tpu.cli"]
    assert code != 0
    assert "ValueError: too many values to unpack (expected 5)" in log, log[-3000:]
    code, log, vcf = outs["sniffles_tpu_torch"]
    assert code == 1, log[-3000:]
    assert "--combine-consensus is not supported by sniffles_tpu_torch" in log
    assert not vcf.exists()
