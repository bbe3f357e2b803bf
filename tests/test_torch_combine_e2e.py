"""The port's combine CLI (python -m sniffles_tpu_torch) against the JAX
package's (python -m sniffles_tpu.cli), host path and device path
(--tpu-combine; the port's device path on the CPU through
SNIFFLES_TPU_FORCE_CPU), on two cohorts: SNFs written by the JAX
package's call_sample from simulated BAMs, and SNFs written by the
port's cohort writer (so the JAX package reads the port's SNFs too).
Record lines must be identical, and the header identical apart from the
command and date lines.

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
