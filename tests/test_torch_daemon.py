"""The port's device daemon (sniffles_tpu_torch/parallel/device_daemon.py)
on the CPU: the daemon runs as a process of its own with
SNIFFLES_TPU_FORCE_CPU=1 and --no-warm-compile, and the CLI runs it
serves see no card (CUDA_VISIBLE_DEVICES="") and are not asked onto the
CPU, so a CLI that looked for a device of its own would raise. Mirrors
tests/test_device_daemon.py: a call step through the socket, served CLI
runs of call_sample and combine (with torch blocked from import, too:
a served run needs none), other clustering flags, two clients at once, the idle timeout, the shutdown request, a second daemon on a live
socket and a stale socket file; and, unlike the JAX package, no fallback:
a socket that does not answer, or a connection lost during a run, ends
the run with exit 1. Every VCF is held against the JAX package's on the
same input.

There is no per-test timeout plugin here: each test's time limit is the
sum of the timeouts its subprocesses and waits carry (at most 120 s)."""
import json
import os
import socket
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Listener

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jc  # noqa: E402
from sniffles_tpu.parallel import device_call as jdc  # noqa: E402
from sniffles_tpu_torch.parallel import device_daemon as dd  # noqa: E402
from sniffles_tpu_torch.parallel.device_call import run_call_task  # noqa: E402
from sniffles_tpu_torch.parallel.device_service import DeviceResponse  # noqa: E402
from sniffles_tpu_torch.sim import PlantedSV, fuzz_call_batch, write_dataset  # noqa: E402
from tests.test_torch_combine_e2e import write_port_cohort  # noqa: E402
from tests.test_torch_snf_e2e import REPO, run, split_vcf  # noqa: E402

# the default configuration's call_task_packed parameters
META = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
            cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50,
            cluster_merge_pos=150, global_repeat=False, binsize=100,
            resplit_binsize=20)

CLI_TIMEOUT = 120


def daemon_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    return env


def start_daemon(sock, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "sniffles_tpu_torch.parallel.device_daemon", "--socket", sock,
         "--no-warm-compile", *extra],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=daemon_env())
    deadline = time.monotonic() + 60
    while not dd.answers(sock) and time.monotonic() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert dd.answers(sock), "the daemon never answered on its socket"
    return proc


def stop(proc):
    if proc.poll() is None:
        proc.terminate()
        proc.wait(10)


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("daemon") / "d.sock")
    proc = start_daemon(sock, "--idle-timeout", "300")
    yield sock
    stop(proc)


def served(args, sock, cwd, counters=None):
    """The port's CLI through the daemon: no card visible, no request for
    the CPU. Returns the finished process."""
    env = {k: v for k, v in os.environ.items() if k != "SNIFFLES_TPU_FORCE_CPU"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env[dd.ENV_SOCKET] = sock
    if counters:
        env["SNIFFLES_TPU_COUNTERS_JSON"] = str(counters)
    return subprocess.Popen([sys.executable, "-m", "sniffles_tpu_torch", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=str(cwd))


def finished(proc):
    out, _ = proc.communicate(timeout=CLI_TIMEOUT)
    return proc.returncode, out


def run_served(args, sock, cwd, counters=None):
    rc, out = finished(served(args, sock, cwd, counters))
    assert rc == 0, out[-3000:]
    if counters is None:
        return None
    with open(counters) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A BAM of two contigs, and the JAX package's VCF of it at
    --threads 2 with its device path."""
    d = tmp_path_factory.mktemp("sample")
    bam, fa = write_dataset(str(d), ref_len=120_000, depth=20, read_len=10_000, seed=5,
                            n_contigs=2,
                            svs=[PlantedSV(pos=30_000, svtype="DEL", svlen=300),
                                 PlantedSV(pos=60_000, svtype="INS", svlen=150),
                                 PlantedSV(pos=90_000, svtype="DEL", svlen=900)])
    run("sniffles_tpu.cli", ["--input", bam, "--reference", fa, "--vcf", "jax.vcf",
                             "--threads", "2", "--tpu-call"], d)
    return bam, fa, split_vcf(d / "jax.vcf")


def test_daemon_ping_and_call_step(daemon):
    """A call_task through the socket equals the port's in-process step and
    the JAX package's call_task_packed + compress_call_response on the same
    fuzz batch; concurrent posts from one client resolve by req_id."""
    client = dd.DaemonClient(daemon)
    try:
        assert client.ping(timeout=60)
        batches = [fuzz_call_batch(seed, size) for seed, size in ((11, 512), (13, 2048),
                                                                  (18, 8192))]
        for packed in batches:
            got = client.call_task(packed, META)
            ours = run_call_task(packed, META, "cpu")
            padded = jdc.pad_packed(packed)
            theirs = jdc.compress_call_response(
                np.asarray(jc.call_task_packed(jnp.asarray(padded), **META)), padded.shape[1])
            for want in (ours, theirs):
                assert got["nc"] == want["nc"] and got["slots"] == want["slots"]
                assert got["elems"].tolist() == np.asarray(want["elems"]).tolist()
                assert got["stats"].tolist() == np.asarray(want["stats"]).tolist()
        ids = [client.post("call_task", packed, META) for packed in batches]
        for rid, packed in reversed(list(zip(ids, batches))):
            got = client.wait(rid, timeout=60)
            assert got["elems"].tolist() == run_call_task(packed, META, "cpu")["elems"].tolist()
        stats = dd.daemon_stats(daemon)
        assert stats["device"] == "cpu" and stats["kernel_merge_sweep"] == 0
    finally:
        client.close()


@pytest.mark.parametrize("threads", ["0", "2"])
def test_served_call_sample_matches_jax(daemon, sample, tmp_path, threads):
    bam, fa, theirs = sample
    counters = run_served(["--input", bam, "--reference", fa, "--vcf", "d.vcf", "--threads",
                           threads], daemon, tmp_path, tmp_path / "c.json")
    assert split_vcf(tmp_path / "d.vcf") == theirs and len(theirs[1]) == 6
    # one call step a contig went through the daemon, on its CPU
    assert counters["device_tasks"] == 2 and counters["engine_consumed"] > 0
    assert counters["service_requests"] >= 2
    assert counters["kernel_merge_sweep"] == counters["kernel_ed_myers"] == 0


def test_served_run_with_other_clustering_flags_matches_jax(daemon, sample, tmp_path):
    """Non-default clustering flags against a daemon started with the
    defaults: the parameters travel with each request."""
    bam, fa, _ = sample
    flags = ["--cluster-binsize", "50", "--cluster-r", "1.5", "--minsupport", "4",
             "--threads", "2"]
    run("sniffles_tpu.cli", ["--input", bam, "--reference", fa, "--vcf", "jax.vcf",
                             "--tpu-call", *flags], tmp_path)
    run_served(["--input", bam, "--reference", fa, "--vcf", "d.vcf", *flags], daemon,
               tmp_path)
    assert split_vcf(tmp_path / "d.vcf") == split_vcf(tmp_path / "jax.vcf")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Three SNFs of the port's writer, and the JAX package's combine of
    them with its device path."""
    d = tmp_path_factory.mktemp("cohort")
    snfs = write_port_cohort(d, n_samples=3, seed=41)
    run("sniffles_tpu.cli", ["--input", *snfs, "--vcf", "jax.vcf", "--threads", "0",
                             "--tpu-combine"], d)
    return snfs, split_vcf(d / "jax.vcf")


def test_served_combine_matches_jax(daemon, cohort, tmp_path):
    snfs, theirs = cohort
    counters = run_served(["--input", *snfs, "--vcf", "d.vcf", "--threads", "2"], daemon,
                          tmp_path, tmp_path / "c.json")
    assert split_vcf(tmp_path / "d.vcf") == theirs
    assert counters["combine_greedy_dispatches"] >= 1
    assert counters["service_requests"] >= counters["combine_greedy_dispatches"]


def test_served_runs_import_no_torch(daemon, sample, cohort, tmp_path):
    """A served run packs and decodes but launches nothing: with torch
    blocked from import (the forked workers inherit the block),
    call_sample at --threads 2 and 0 and a combine give the JAX package's
    VCFs."""
    bam, fa, theirs = sample
    snfs, combined = cohort
    code = f"""
import sys
sys.modules["torch"] = None        # any import of torch now raises
from sniffles_tpu_torch.cli import main
for threads in ("2", "0"):
    assert main(["--input", {bam!r}, "--reference", {fa!r}, "--vcf", "call%s.vcf" % threads,
                 "--threads", threads]) == 0
assert main(["--input", *{snfs!r}, "--vcf", "combine.vcf", "--threads", "0"]) == 0
assert sys.modules["torch"] is None
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "SNIFFLES_TPU_FORCE_CPU"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env[dd.ENV_SOCKET] = daemon
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=CLI_TIMEOUT)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), (r.stdout[-3000:]
                                                                    + r.stderr[-3000:])
    for threads in ("2", "0"):
        assert split_vcf(tmp_path / f"call{threads}.vcf") == theirs
    assert split_vcf(tmp_path / "combine.vcf") == combined


def test_two_clients_at_once(daemon, sample, tmp_path):
    """Two runs served at once, of two inputs: each writes its own VCF,
    the one the JAX package writes for it."""
    bam, fa, theirs = sample
    other = tmp_path / "other"
    other.mkdir()
    bam2, fa2 = write_dataset(str(other), ref_len=100_000, depth=18, read_len=10_000,
                              seed=8, svs=[PlantedSV(pos=50_000, svtype="INS", svlen=400)])
    run("sniffles_tpu.cli", ["--input", bam2, "--reference", fa2, "--vcf", "jax.vcf",
                             "--threads", "2", "--tpu-call"], other)
    procs = [served(["--input", bam, "--reference", fa, "--vcf", "a.vcf", "--threads", "2"],
                    daemon, tmp_path),
             served(["--input", bam2, "--reference", fa2, "--vcf", "b.vcf", "--threads", "0"],
                    daemon, tmp_path)]
    for proc in procs:
        rc, out = finished(proc)
        assert rc == 0, out[-3000:]
    assert split_vcf(tmp_path / "a.vcf") == theirs
    assert split_vcf(tmp_path / "b.vcf") == split_vcf(other / "jax.vcf")
    assert split_vcf(tmp_path / "a.vcf")[1] != split_vcf(tmp_path / "b.vcf")[1]


def test_idle_timeout_ends_the_daemon(tmp_path):
    sock = str(tmp_path / "idle.sock")
    proc = start_daemon(sock, "--idle-timeout", "1")
    try:
        assert proc.wait(60) == 0
        assert not os.path.exists(sock), "socket not removed on the idle exit"
    finally:
        stop(proc)


def test_shutdown_request_and_a_second_daemon(tmp_path):
    """A second daemon on a live socket exits 1 and leaves the first one
    serving; a shutdown request then ends the first."""
    sock = str(tmp_path / "shut.sock")
    proc = start_daemon(sock, "--idle-timeout", "300")
    try:
        client = dd.DaemonClient(sock)
        assert client.ping(timeout=60)
        second = subprocess.run(
            [sys.executable, "-m", "sniffles_tpu_torch.parallel.device_daemon", "--socket",
             sock, "--no-warm-compile"], capture_output=True, text=True, env=daemon_env(),
            timeout=60)
        assert second.returncode == 1
        assert "a live device daemon already answers on " + sock in second.stderr
        assert client.ping(timeout=60)
        client.shutdown()
        assert proc.wait(60) == 0
        assert not os.path.exists(sock)
        client.close()
    finally:
        stop(proc)


def test_stale_socket_file_is_replaced(tmp_path):
    """A socket file nobody listens on (a daemon that died) is unlinked and
    the new daemon serves on it."""
    sock = str(tmp_path / "stale.sock")
    dead = socket.socket(socket.AF_UNIX)
    dead.bind(sock)
    dead.close()
    assert os.path.exists(sock)
    proc = start_daemon(sock, "--idle-timeout", "300")
    try:
        client = dd.DaemonClient(sock)
        assert client.ping(timeout=60)
        client.shutdown()
        assert proc.wait(60) == 0
        client.close()
    finally:
        stop(proc)


def test_socket_that_does_not_answer_ends_the_run(sample, tmp_path):
    """No fallback: a socket path with no daemon behind it ends the run
    with exit 1 and a message that names the path; --no-tpu never
    connects."""
    bam, fa, theirs = sample
    sock = str(tmp_path / "nobody.sock")
    rc, out = finished(served(["--input", bam, "--reference", fa, "--vcf", "d.vcf",
                               "--threads", "0"], sock, tmp_path))
    assert rc == 1 and f"the device daemon socket {sock}" in out
    assert not (tmp_path / "d.vcf").exists()
    run_served(["--input", bam, "--reference", fa, "--vcf", "h.vcf", "--threads", "0",
                "--no-tpu"], sock, tmp_path)
    assert split_vcf(tmp_path / "h.vcf") == theirs


class DroppingDaemon:
    """A stand-in for the daemon that answers stats requests and drops
    the connection on any other request: a daemon lost during a run."""

    def __init__(self, sock):
        self.listener = Listener(sock, family="AF_UNIX")
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn = self.listener.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()

    @staticmethod
    def _client(conn):
        try:
            while True:
                request = conn.recv()
                if request.kind != "stats":
                    break
                conn.send(DeviceResponse(payload={"requests": 0, "device": "cpu"},
                                         req_id=request.req_id))
        except (EOFError, OSError):
            pass
        conn.close()

    def close(self):
        self.listener.close()


@pytest.mark.parametrize("threads", ["0", "2"])
def test_connection_lost_during_a_run_ends_it(sample, tmp_path, threads):
    bam, fa, _ = sample
    sock = str(tmp_path / "drop.sock")
    stand_in = DroppingDaemon(sock)
    try:
        rc, out = finished(served(["--input", bam, "--reference", fa, "--vcf", "d.vcf",
                                   "--threads", threads], sock, tmp_path))
    finally:
        stand_in.close()
    assert rc == 1, out[-3000:]
    assert f"the device daemon connection on {sock} was lost" in out
