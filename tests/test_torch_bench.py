"""The port's benchmark (sniffles_tpu_torch/bench.py and
tools/bench_combine.py) against the JAX package's (bench.py,
tools/bench_combine.py): the same workloads field for field, the bench
end to end on the CPU at a tiny size with bench.py::main's keys, and no
failure swallowed."""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as jax_bench  # noqa: E402  (the JAX package's bench.py)
from sniffles_tpu_torch import bench as port_bench  # noqa: E402
from sniffles_tpu_torch import sim as port_sim  # noqa: E402
from sniffles_tpu_torch.tools import bench_combine as port_combine  # noqa: E402


def load_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_combine = load_path("jax_bench_combine", os.path.join(REPO, "tools", "bench_combine.py"))

# the keys bench.py writes only where the port's bench has no such path:
# a caught failure (the port catches none), a run without a daemon (the
# port's device legs always have one), and the JAX daemon's log split
NOT_WRITTEN = {
    "tpu_error", "scale_tpu_error", "scale_inline_error", "dense_error", "scale_error",
    "device_stats_error", "combine256_error", "device_error",
    "e2e_ours_runs", "e2e_dense_ours_runs", "e2e_scale_ours_runs",
    "tpu_fixed_claim_s", "tpu_fixed_compile_s",
}
REFERENCE_KEYS = {"e2e_seconds_reference": "reference_error",
                  "e2e_dense_seconds_reference": "dense_reference_error",
                  "e2e_scale_seconds_reference": "scale_reference_error"}

# the tiny size of the end-to-end run on the CPU: 1 contig of 150 kb for
# every call leg, 1 pair, the combine leg at 4 samples of 100 kb, the
# engine legs at 4,096 signatures; the daemon and the engine on the CPU
TINY = {"BENCH_CONTIGS": "1", "BENCH_REF_LEN": "150000", "BENCH_PAIRS": "1",
        "BENCH_INLINE_PAIRS": "1", "BENCH_DENSE_REF_LEN": "150000",
        "BENCH_DENSE_CONTIGS": "1", "BENCH_SCALE_CONTIGS": "1",
        "BENCH_SCALE_REF_LEN": "150000", "BENCH_COMBINE_SAMPLES": "4",
        "BENCH_COMBINE_REF_LEN": "100000", "BENCH_COMBINE_PAIRS": "1",
        "BENCH_SIGNATURES": "4096", "BENCH_SIGNATURES_EQUAL": "4096",
        "SNIFFLES_TPU_FORCE_CPU": "1", "OMP_NUM_THREADS": "1"}


def fields(svs):
    return [dataclasses.asdict(sv) for sv in svs]


@pytest.mark.parametrize("ref_len", [150_000, 1_200_000, 12_000_000])
def test_sv_layout_equals_bench_py(ref_len):
    """The quick and scale legs' layouts (_sv_layout) equal bench.py's."""
    port, jax = fields(port_bench._sv_layout(ref_len)), fields(jax_bench._sv_layout(ref_len))
    assert port == jax and len(port) >= 3


@pytest.mark.parametrize("ref_len", [150_000, 2_000_000])
def test_dense_layout_equals_bench_py(ref_len):
    port, jax = fields(port_sim.dense_layout(ref_len)), fields(jax_bench._dense_layout(ref_len))
    assert port == jax and len(port) >= 40


@pytest.mark.parametrize("ref_len,site_gap", [(600_000, (2000, 3500)), (100_000, (2000, 3500)),
                                              (1_200_000, (30_000, 52_000))])
def test_population_equals_bench_combine(ref_len, site_gap):
    """plant_population, the combine leg's shared sites with their INS
    sequences, equals tools/bench_combine.py's from the same generator."""
    port = port_combine.plant_population(np.random.default_rng(7), ref_len, site_gap)
    jax = jax_combine.plant_population(np.random.default_rng(7), ref_len, site_gap)
    assert fields(port) == fields(jax) and len(port) >= 3


def bench_keys() -> set:
    """Every key bench.py writes into its result, less NOT_WRITTEN, and its
    JSON line's four."""
    with open(os.path.join(REPO, "bench.py")) as f:
        source = f.read()
    written = set(re.findall(r'(?:out|result)\["(\w+)"\]', source))
    assert {"e2e_pairs", "combine256", "device_sig_per_sec_peak"} <= written
    return (written - NOT_WRITTEN) | {"metric", "value", "unit", "vs_baseline"}


def run_bench(tmp_path, env_extra, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "sniffles_tpu_torch.bench"],
                          capture_output=True, text=True, env=env, timeout=timeout,
                          cwd=str(tmp_path))


def test_bench_end_to_end_on_the_cpu(tmp_path):
    """Every leg at the tiny size on the CPU: exit 0, one JSON line with
    bench.py::main's keys and the device, every *_records_identical true,
    the reference legs null with their reason; every host run passed
    --no-tpu, every device run was served by the daemon."""
    r = run_bench(tmp_path, TINY)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    assert bench_keys() <= set(out), bench_keys() - set(out)
    assert out["device"] == "cpu (SNIFFLES_TPU_FORCE_CPU=1)"
    assert port_bench.records_differ(out) == []
    identical = [k for k in out if k.endswith("records_identical")]
    assert len(identical) == 4 and out["combine256"]["tpu_records_identical"] is True
    for key, reason in REFERENCE_KEYS.items():
        assert out[key] is None and out[reason].startswith("not run: ")
    assert out["vs_baseline"] is None
    for leg in ("e2e_pairs", "e2e_dense_pairs", "e2e_scale_pairs", "e2e_scale_inline_pairs"):
        p = out[leg]
        assert p["pairs"] == 1 and len(p["host_runs"]) == len(p["tpu_runs"]) == 1
        assert len(p["warmup_runs"]) >= 3
    for leg in ("quick", "dense", "scale"):
        assert out[f"engine_counters_{leg}"]["device_tasks"] >= 1
    assert out["device_service_stats"]["device"] == "cpu"
    assert out["combine256"]["samples"] == 4
    assert out["combine256"]["combine_counters"]["combine_greedy_dispatches"] >= 1
    assert out["equal_workload_signatures"] == 4096
    assert min(out["device_sig_per_sec_equal"], out["device_sig_per_sec_peak"],
               out["host_sig_per_sec_equal"]) > 0

    runs = [line for line in r.stderr.splitlines() if line.startswith("[bench] ")]
    host = [line for line in runs if line.startswith(("[bench] host ", "[bench] host warmup"))]
    device = [line for line in runs if line.startswith("[bench] device")]
    # 4 call legs and the combine leg, each a host warmup and a pair at least
    assert len(host) >= 10 and len(device) >= 15 and len(host) + len(device) == len(runs)
    for line in host:
        assert line.endswith(" --no-tpu") and "SNIFFLES_TPU_DEVICE_SOCKET" not in line, line
    for line in device:
        assert "--no-tpu" not in line and "SNIFFLES_TPU_DEVICE_SOCKET=" in line, line
        assert "CUDA_VISIBLE_DEVICES=''" in line and "SNIFFLES_TPU_FORCE_CPU=<unset>" in line


def test_a_failed_run_ends_the_bench(tmp_path):
    """A quick-leg dataset that cannot be read: the first host run fails,
    the bench exits non-zero without a JSON line, and its daemon is gone."""
    bench_dir = tmp_path / "sniffles_tpu_torch_bench"
    bench_dir.mkdir()
    (bench_dir / "sim.bam").write_bytes(b"not a BAM")
    (bench_dir / "ref.fa").write_text(">chr1\nACGT\n")
    r = run_bench(tmp_path, {**TINY, "BENCH_SKIP_DENSE": "1", "BENCH_SKIP_SCALE": "1",
                             "BENCH_SKIP_COMBINE": "1"})
    assert r.returncode != 0 and r.stdout == ""
    assert "bench leg failed" in r.stderr, r.stderr[-3000:]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".sock")]


def test_a_leg_with_a_missing_input_raises(tmp_path):
    """call_leg given a BAM path that does not exist raises."""
    with pytest.raises(RuntimeError, match="bench leg failed"):
        port_bench.call_leg({}, port_bench.Daemon(str(tmp_path)), "",
                            str(tmp_path / "absent.bam"), str(tmp_path / "absent.fa"),
                            str(tmp_path))


def test_a_device_run_without_an_answering_daemon_raises(tmp_path):
    """The device runs of a leg name a socket nobody answers on: the host
    warmup passes, the first device run exits 1, and the leg raises."""
    bam, fa = port_sim.write_dataset(str(tmp_path), ref_len=60_000, depth=10, read_len=8_000,
                                     seed=4, svs=[port_sim.PlantedSV(30_000, "DEL", 200)])
    daemon = port_bench.Daemon(str(tmp_path))     # never started: nothing listens
    with pytest.raises(RuntimeError, match="does not answer"):
        port_bench.call_leg({}, daemon, "", bam, fa, str(tmp_path))
    assert os.path.exists(tmp_path / "host.vcf") and not os.path.exists(tmp_path / "tpu.vcf")


FAKE_DAEMON = """
import sys, time
from multiprocessing.connection import Listener
listener = Listener(sys.argv[1], family="AF_UNIX")
held = []
while True:
    held.append(listener.accept())    # accepts, never answers
"""


def test_a_daemon_that_does_not_answer_raises(tmp_path):
    """Daemon.start against a process that opens the socket but never
    answers a ping: it raises after its timeout and kills the process."""
    fake = tmp_path / "fake_daemon.py"
    fake.write_text(FAKE_DAEMON)
    daemon = port_bench.Daemon(str(tmp_path))
    daemon.command = [sys.executable, str(fake), daemon.sock]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not answer a ping"):
        daemon.start(timeout=2)
    assert daemon.proc.poll() is not None and time.monotonic() - t0 < 60


def test_bench_runs_with_jax_blocked(tmp_path):
    """The bench's own process (the quick leg and the engine legs at the
    tiny size) and its tools' imports, where jax and sniffles_tpu cannot
    be imported: nothing of either is loaded."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch import bench
from sniffles_tpu_torch.tools import bench_combine, diff_fuzz
assert bench.main([]) == 0
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    env.update({**TINY, "BENCH_SKIP_DENSE": "1", "BENCH_SKIP_SCALE": "1",
                "BENCH_SKIP_COMBINE": "1"})
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")
    assert json.loads(r.stdout.splitlines()[0])["tpu_records_identical"] is True
