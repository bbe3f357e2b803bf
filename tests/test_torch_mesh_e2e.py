"""--tpu-mesh N through the port's entry points (python -m
sniffles_tpu_torch) against the JAX package's CLI (python -m
sniffles_tpu.cli --tpu-call --tpu-mesh 8, on its 8 virtual CPU devices,
with its sequential sweep: SNIFFLES_TPU_SEQ_SWEEP=1) and the host path,
on the CPU (SNIFFLES_TPU_FORCE_CPU: the port's 8 shards on the CPU):

  * call_sample on tests/test_tpu_mesh.py's dataset at --threads 0 and 2,
    and with --cluster-binsize 400: every VCF's records equal, the mesh
    taken for the task (mesh_tasks) and no seam route; force calling
    (--genotype-vcf) through the mesh;
  * the forced-overflow hook (SNIFFLES_TPU_MESH_FORCE_OVERFLOW): the task
    takes the counted host route (mesh_seam_host = tasks) and the records
    stay the host's; any other error of the mesh step ends the run with
    exit 1;
  * combine on tests/test_mesh_combine_cli.py's cohort (written by the
    port): the mesh segmentation ran (its debug line, combine_mesh_flushes)
    and the records equal the host's and the JAX package's --tpu-mesh 8
    (whose mesh segmentation never runs beside --tpu-combine);
  * a served --tpu-mesh 8 run through a device daemon on the CPU;
  * the multi-host run: two processes joined by SNIFFLES_TPU_COORDINATOR,
    whose VCF equals the single process's, written by process 0 alone.

Each run is its own subprocess (both packages register the "sniffles.sv"
pickle alias)."""
import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from sniffles_tpu_torch.parallel import device_daemon as dd
from sniffles_tpu_torch.sim import PlantedSV, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = "sniffles_tpu_torch", "sniffles_tpu.cli"
TIMEOUT = 300


def env_for(module, extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    # small tensors: one torch thread a process, beside the test's others
    env["OMP_NUM_THREADS"] = "1"
    if module == JAX:
        flags = env.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
        # the JAX sequential sweep: its grid sweep keeps unsound cuts
        # (ROADMAP C) and its mesh rows are held to the sequential one
        env["SNIFFLES_TPU_SEQ_SWEEP"] = "1"
    env.update(extra or {})
    return env


def start(module, args, cwd, counters=None, extra=None):
    """A CLI run in a process of its own, started; `counters` names its
    counters JSON."""
    env = env_for(module, extra)
    if counters:
        env["SNIFFLES_TPU_COUNTERS_JSON"] = str(counters)
    return subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(cwd))


def finish(proc, code=0):
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == code, out[-4000:]
    return out


def run_all(runs):
    """Start every (module, args, cwd, counters, extra) run, three at a
    time; return their outputs in order."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        return list(pool.map(lambda r: finish(start(*r)), runs))


def records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def counters_of(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# call_sample: tests/test_tpu_mesh.py's dataset


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_sample")
    svs = [PlantedSV(pos=p, svtype=t, svlen=ln)
           for p, t, ln in [(30_000, "DEL", 120), (60_000, "INS", 150), (90_000, "DEL", 500),
                            (120_000, "INS", 80), (150_000, "DEL", 2000),
                            (180_000, "DUP", 900)]]
    bam, _ = write_dataset(str(d), ref_len=230_000, depth=24, read_len=12_000, seed=11,
                           svs=svs)
    return d, bam


CALL_RUNS = {
    # label: (module, extra arguments, extra environment)
    "port-host": (PORT, ["--threads", "0", "--no-tpu"], None),
    "port-mesh-t0": (PORT, ["--threads", "0", "--tpu-mesh", "8"], None),
    "port-mesh-t2": (PORT, ["--threads", "2", "--tpu-mesh", "8"], None),
    "port-overflow-t2": (PORT, ["--threads", "2", "--tpu-mesh", "8"],
                         {"SNIFFLES_TPU_MESH_FORCE_OVERFLOW": "1"}),
    "port-host-bin400": (PORT, ["--threads", "0", "--no-tpu", "--cluster-binsize", "400"],
                         None),
    "port-mesh-bin400": (PORT, ["--threads", "0", "--tpu-mesh", "8", "--cluster-binsize",
                                "400"], None),
    "jax-host": (JAX, ["--threads", "0"], None),
    "jax-mesh-t0": (JAX, ["--threads", "0", "--tpu-call", "--tpu-mesh", "8"],
                    {"SNIFFLES_TPU_REQUIRE_DEVICE": "1"}),
    "jax-host-bin400": (JAX, ["--threads", "0", "--cluster-binsize", "400"], None),
}


@pytest.fixture(scope="module")
def call_runs(sample):
    d, bam = sample
    logs = run_all([(module, ["--input", bam, "--vcf", str(d / f"{label}.vcf"), *args], d,
                     d / f"{label}.json", extra)
                    for label, (module, args, extra) in CALL_RUNS.items()])
    return {label: (records(d / f"{label}.vcf"),
                    counters_of(d / f"{label}.json") if (d / f"{label}.json").exists()
                    else None, log)
            for label, log in zip(CALL_RUNS, logs)}


@pytest.mark.parametrize("label", ["port-mesh-t0", "port-mesh-t2"])
def test_mesh_call_sample_matches_jax_and_host(call_runs, label):
    host = call_runs["jax-host"][0]
    assert len(host) == 6
    assert call_runs[label][0] == call_runs["jax-mesh-t0"][0] == host
    assert call_runs["port-host"][0] == host
    c = call_runs[label][1]
    assert c["mesh_tasks"] == c["device_tasks"] == 1 and "mesh_seam_host" not in c
    assert c["clusters_total"] > 0
    if label == "port-mesh-t2":
        # the worker posted its mesh payload to the parent's service
        assert c["service_requests"] == 1
    assert "falling back" not in call_runs["jax-mesh-t0"][2]


def test_mesh_nondefault_binsize_matches_host(call_runs):
    want = call_runs["jax-host-bin400"][0]
    assert want and call_runs["port-mesh-bin400"][0] == call_runs["port-host-bin400"][0] == want
    assert call_runs["port-mesh-bin400"][1]["mesh_tasks"] == 1


def test_forced_overflow_takes_the_counted_host_route(call_runs):
    """Every task's halo overflows: each takes the host sweep, counted as
    mesh_seam_host (the service answered the overflow as a result)."""
    records_, c, log = call_runs["port-overflow-t2"]
    assert records_ == call_runs["port-host"][0]
    assert c["mesh_seam_host"] == 1 and "mesh_tasks" not in c and "device_tasks" not in c
    assert "forced by SNIFFLES_TPU_MESH_FORCE_OVERFLOW" in log


def test_mesh_force_calling_matches(sample, call_runs, tmp_path):
    """genotype_vcf at --tpu-mesh 8 re-calls the sample's own records
    through the mesh, with the records of the run without it."""
    d, bam = sample
    target = str(d / "port-host.vcf")
    runs = {"mesh": ["--tpu-mesh", "8"], "plain": []}
    run_all([(PORT, ["--input", bam, "--genotype-vcf", target, "--vcf",
                     str(tmp_path / f"{k}.vcf"), "--threads", "0", *args], tmp_path,
              tmp_path / f"{k}.json", None) for k, args in runs.items()])
    assert records(tmp_path / "mesh.vcf") == records(tmp_path / "plain.vcf")
    assert len(records(tmp_path / "mesh.vcf")) == len(call_runs["port-host"][0])
    assert counters_of(tmp_path / "mesh.json")["mesh_tasks"] == 1


@pytest.mark.parametrize("threads", ["0", "2"])
def test_other_mesh_errors_end_the_run(sample, tmp_path, threads):
    """An error of the mesh step other than the halo's is no seam: at
    --threads 0 it ends the run, at --threads 2 (the parent's service runs
    the step) the task fails; either way the run exits 1 with no record."""
    _, bam = sample
    code = """
import sys
from sniffles_tpu_torch.parallel import device_call
def broken(payload, meta):
    raise RuntimeError("the mesh step is broken for the test")
device_call.run_mesh_assign = broken
from sniffles_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""
    proc = subprocess.Popen([sys.executable, "-c", code, "--input", bam, "--vcf",
                             str(tmp_path / "o.vcf"), "--threads", threads, "--tpu-mesh", "8"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env_for(PORT), cwd=str(tmp_path))
    out = finish(proc, code=1)
    assert "broken for the test" in out
    if threads == "2":
        assert "1 task(s) failed" in out
    assert records(tmp_path / "o.vcf") == []


def test_served_mesh_run(sample, call_runs, tmp_path):
    """--tpu-mesh 8 served by a device daemon on the CPU: the client has no
    card and no CPU request; the daemon places the 8 shards."""
    _, bam = sample
    sock = str(tmp_path / "d.sock")
    daemon = subprocess.Popen([sys.executable, "-m", "sniffles_tpu_torch.parallel.device_daemon",
                               "--socket", sock, "--no-warm-compile", "--idle-timeout", "120"],
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                              env=env_for(PORT))
    try:
        deadline = time.monotonic() + 60
        while not dd.answers(sock) and time.monotonic() < deadline and daemon.poll() is None:
            time.sleep(0.05)
        extra = {"SNIFFLES_TPU_FORCE_CPU": "", "CUDA_VISIBLE_DEVICES": "", dd.ENV_SOCKET: sock}
        finish(start(PORT, ["--input", bam, "--vcf", str(tmp_path / "served.vcf"), "--threads",
                            "2", "--tpu-mesh", "8"], tmp_path, tmp_path / "c.json", extra))
    finally:
        daemon.terminate()
        daemon.wait(10)
    assert records(tmp_path / "served.vcf") == call_runs["port-host"][0]
    c = counters_of(tmp_path / "c.json")
    assert c["mesh_tasks"] == 1 and c["service_requests"] == 1


# ---------------------------------------------------------------------------
# combine: tests/test_mesh_combine_cli.py's cohort


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Three samples sharing sites at slightly different breakpoints, plus
    near-adjacent site pairs on either side of combine_match_max, called
    to .snf by the port's host path."""
    import numpy as np
    d = tmp_path_factory.mktemp("mesh_cohort")
    runs = []
    for i in range(3):
        rng = np.random.default_rng(100 + i)
        svs = []
        for base in (20_000, 50_000, 80_000, 110_000, 140_000, 170_000):
            svtype = ("INS", "DEL", "DUP", "INV")[base // 30_000 % 4]
            svs.append(PlantedSV(pos=base + int(rng.integers(-30, 31)), svtype=svtype,
                                 svlen=150 + 40 * (base // 30_000)))
        svs += [PlantedSV(pos=200_000, svtype="DEL", svlen=120),
                PlantedSV(pos=200_900, svtype="DEL", svlen=130),
                PlantedSV(pos=230_000, svtype="INS", svlen=90),
                PlantedSV(pos=231_140, svtype="INS", svlen=95)]
        svs.sort(key=lambda s: s.pos)
        (d / f"s{i}").mkdir()
        bam, _ = write_dataset(str(d / f"s{i}"), ref_len=260_000, depth=18, read_len=12_000,
                               seed=13 + i, svs=svs)
        runs.append((PORT, ["--input", bam, "--snf", str(d / f"s{i}.snf"), "--sample-id",
                            f"s{i}", "--threads", "0", "--no-tpu"], d, None, None))
    run_all(runs)
    return d, [str(d / f"s{i}.snf") for i in range(3)]


def test_mesh_combine_matches_host_and_jax(cohort):
    d, snfs = cohort
    runs = {"port-host": (PORT, ["--no-tpu", "--threads", "0"]),
            "port-mesh-t0": (PORT, ["--tpu-mesh", "8", "--threads", "0", "--dev-debug-log"]),
            "port-mesh-t2": (PORT, ["--tpu-mesh", "8", "--threads", "2"]),
            "jax-mesh": (JAX, ["--tpu-mesh", "8", "--threads", "0"]),
            "jax-mesh-tpu-combine": (JAX, ["--tpu-mesh", "8", "--tpu-combine", "--threads",
                                           "0", "--dev-debug-log"])}
    logs = dict(zip(runs, run_all([(module, ["--input", *snfs, "--vcf", str(d / f"{k}.vcf"),
                                             *args], d, d / f"{k}.json", None)
                                   for k, (module, args) in runs.items()])))
    want = records(d / "port-host.vcf")
    assert len(want) >= 8
    for k in runs:
        assert records(d / f"{k}.vcf") == want, k
    # not vacuous: the mesh segmentation ran
    assert "mesh combine segmentation" in logs["port-mesh-t0"]
    # found in the JAX package (ROADMAP C): with --tpu-combine its
    # whole-task preplan takes every non-BND flush and BND never meshes, so
    # --tpu-mesh never reaches the mesh segmentation in combine
    assert "mesh combine segmentation" not in logs["jax-mesh-tpu-combine"]
    for k in ("port-mesh-t0", "port-mesh-t2"):
        c = counters_of(d / f"{k}.json")
        assert c["combine_mesh_flushes"] > 0 and "combine_mesh_seam" not in c, c
    assert counters_of(d / "port-mesh-t2.json")["service_requests"] >= \
        counters_of(d / "port-mesh-t2.json")["combine_mesh_flushes"]


# ---------------------------------------------------------------------------
# the multi-host run


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_split_the_tasks_and_process_0_writes(tmp_path):
    bam, _ = write_dataset(str(tmp_path), ref_len=120_000, depth=16, read_len=10_000, seed=5,
                           n_contigs=2, svs=[PlantedSV(pos=30_000, svtype="DEL", svlen=300),
                                             PlantedSV(pos=70_000, svtype="INS", svlen=150)])
    common = ["--input", bam, "--threads", "0", "--tpu-mesh", "2"]
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [start(PORT, [*common, "--vcf", str(tmp_path / f"p{rank}.vcf")], tmp_path,
                   tmp_path / f"p{rank}.json",
                   {"SNIFFLES_TPU_COORDINATOR": coordinator, "SNIFFLES_TPU_NUM_PROCESSES": "2",
                    "SNIFFLES_TPU_PROCESS_ID": str(rank)})
             for rank in (0, 1)]
    single = start(PORT, [*common, "--vcf", str(tmp_path / "single.vcf")], tmp_path,
                   tmp_path / "single.json")
    logs = [finish(p) for p in procs]
    finish(single)
    want = records(tmp_path / "single.vcf")
    assert len(want) == 4 and records(tmp_path / "p0.vcf") == want
    assert not (tmp_path / "p1.vcf").exists()
    # each process ran one of the two tasks through the mesh
    for rank in (0, 1):
        assert counters_of(tmp_path / f"p{rank}.json")["mesh_tasks"] == 1
        assert "Multi-host runtime: process" in logs[rank]
    assert counters_of(tmp_path / "single.json")["mesh_tasks"] == 2


def test_a_peer_that_never_arrives_ends_the_run_within_the_rendezvous_bound(tmp_path):
    """Process 1 exits at once (its input does not exist): process 0 stops
    at the rendezvous, within its timeout, with exit 1 and no output."""
    bam, _ = write_dataset(str(tmp_path), ref_len=60_000, depth=8, read_len=8_000, seed=6,
                           svs=[PlantedSV(pos=30_000, svtype="DEL", svlen=300)])
    env = {"SNIFFLES_TPU_COORDINATOR": f"127.0.0.1:{free_port()}",
           "SNIFFLES_TPU_NUM_PROCESSES": "2", "SNIFFLES_TPU_RENDEZVOUS_TIMEOUT_S": "10"}
    t0 = time.perf_counter()
    p1 = start(PORT, ["--input", str(tmp_path / "missing.bam"), "--vcf",
                      str(tmp_path / "p1.vcf"), "--tpu-mesh", "2"], tmp_path,
               extra={**env, "SNIFFLES_TPU_PROCESS_ID": "1"})
    p0 = start(PORT, ["--input", bam, "--vcf", str(tmp_path / "p0.vcf"), "--threads", "0",
                      "--tpu-mesh", "2"], tmp_path,
               extra={**env, "SNIFFLES_TPU_PROCESS_ID": "0"})
    finish(p1, code=1)
    log = finish(p0, code=1)
    assert time.perf_counter() - t0 < 90
    assert "not every one of the 2 processes reached" in log, log[-2000:]
    assert not (tmp_path / "p0.vcf").exists()
