"""The port's benchmark: bench.py's legs on the port's daemon and engine.

    python -m sniffles_tpu_torch.bench

A port of the JAX package's bench.py, with its legs, its protocol and
its JSON line:

1. End-to-end BAM -> VCF wall clock of the port's CLI (`python -m
   sniffles_tpu_torch`), the host path against the device path through
   the port's device daemon, in the alternating-pairs protocol
   (timed_pairs: discarded warmups, then BENCH_PAIRS host/device pairs;
   medians, per-pair deltas and the device's wins). Legs, in bench.py's
   order, each on a dataset of the port's simulator (sim.py, whose BAMs
   equal the JAX package's byte for byte), built once and reused:
     quick   BENCH_CONTIGS contigs of BENCH_REF_LEN bp at BENCH_DEPTH
             (10 x 1.2 Mb at 30x; _sv_layout, seed 11, reads of 12 kb)
     dense   BENCH_DENSE_CONTIGS x BENCH_DENSE_REF_LEN at BENCH_DENSE_DEPTH
             (3 x 2 Mb at 60x; sim.dense_layout, seed 17)  BENCH_SKIP_DENSE
     scale   BENCH_SCALE_CONTIGS x BENCH_SCALE_REF_LEN at BENCH_DEPTH
             (24 x 12 Mb at 30x, ~960 MB of BAM)           BENCH_SKIP_SCALE
             and its --threads 0 pairs (BENCH_INLINE_PAIRS) BENCH_SKIP_INLINE
   then the daemon's stats, and the daemon is stopped; then
     combine256  tools/bench_combine.py, 256 samples of 600 kb at 12x,
             site gap 2,000-3,500, BENCH_COMBINE_PAIRS pairs, its own
             daemon                                         BENCH_SKIP_COMBINE
2. The fused engine (parallel/engine.py, call_pipeline_step) on the
   device at BENCH_SIGNATURES_EQUAL and BENCH_SIGNATURES signatures
   (2^16, 2^21; synthetic_batch with n/40 sites, seed 42, 1 Mb of
   coverage at 30), the mean of 3 rates over 10 steps, and the host chain
   (cluster.resolve, svcall.call_from, postprocess) at the first size.

Prints ONE JSON line on stdout, with bench.py::main's keys and names (the
"..._tpu" keys are the device path's) and one more, "device": the card's
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` line, or
the CPU when SNIFFLES_TPU_FORCE_CPU asks for it. Every run the bench
starts is logged on stderr as "[bench] <side> <seconds> s: <command>".
Its "value" is bench.py's headline, the lesser of the quick leg's host
and device medians: it is not a device metric, and it does not move when
the device path slows while the host path stays faster. The device path
is read from the "..._ours_tpu" keys and the legs' pairs.

Where it differs from bench.py:
* The host legs pass --no-tpu. The port's device path is the default,
  and SNIFFLES_TPU_FORCE_CPU runs that device path on the CPU, so
  bench.py's host command would time the device path.
* The device legs are clients of the port's daemon
  (`python -m sniffles_tpu_torch.parallel.device_daemon`,
  SNIFFLES_TPU_DEVICE_SOCKET), with no card visible
  (CUDA_VISIBLE_DEVICES empty) and SNIFFLES_TPU_FORCE_CPU removed from
  their environment: the daemon is the only process that holds the
  device. tpu_daemon_warm_s is the daemon's start-to-ping seconds; the
  port's daemon reports no claim or compile split, so
  tpu_fixed_claim_s and tpu_fixed_compile_s are not written.
* No failure is caught. A failed run, a daemon that does not answer or
  a failed build ends the bench with a non-zero exit; a device VCF whose
  records differ from its host VCF's ends it non-zero after the JSON
  line is printed.
* The reference Sniffles2 legs (tools/run_reference.py) are not run:
  their keys are null, "reference_error" (and the dense and scale legs'
  alike) gives the reason, and vs_baseline is null.
* The engine legs build the kernels and run one step before the timed
  window, which ends in torch.cuda.synchronize().
* The datasets and VCFs lie under the temporary directory (TMPDIR), in
  directories of the port's own (sniffles_tpu_torch_bench...), so this
  bench and bench.py never share a file.
* One variable bench.py does not read: BENCH_COMBINE_REF_LEN, the
  combine leg's contig length (600,000 bp, bench.py's fixed value).

Processes: the bench's own process creates its CUDA context only in the
engine legs, after every child it started has ended (the fork rule,
parallel/device_service.py).
"""
import argparse
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "sniffles_tpu_torch"
_TMP = tempfile.gettempdir()

BENCH_DIR = os.environ.get("BENCH_DIR", os.path.join(_TMP, "sniffles_tpu_torch_bench"))
SCALE_DIR = os.environ.get("BENCH_SCALE_DIR",
                           os.path.join(_TMP, "sniffles_tpu_torch_bench_scale"))
DENSE_DIR = os.environ.get("BENCH_DENSE_DIR",
                           os.path.join(_TMP, "sniffles_tpu_torch_bench_dense"))
COMBINE_DIR = os.path.join(_TMP, "sniffles_tpu_torch_bench_combine256")
CONTIGS = int(os.environ.get("BENCH_CONTIGS", 10))
REF_LEN = int(os.environ.get("BENCH_REF_LEN", 1_200_000))
SCALE_CONTIGS = int(os.environ.get("BENCH_SCALE_CONTIGS", 24))
SCALE_REF_LEN = int(os.environ.get("BENCH_SCALE_REF_LEN", 12_000_000))
DEPTH = int(os.environ.get("BENCH_DEPTH", 30))
THREADS = os.environ.get("BENCH_THREADS", "4")
DENSE_REF_LEN = int(os.environ.get("BENCH_DENSE_REF_LEN", 2_000_000))
DENSE_CONTIGS = int(os.environ.get("BENCH_DENSE_CONTIGS", 3))
DENSE_DEPTH = int(os.environ.get("BENCH_DENSE_DEPTH", 60))
PAIRS = int(os.environ.get("BENCH_PAIRS", 7))

# the environment of a host leg (bench.py's): the host path never
# reaches a card
HOST_ENV = {"SNIFFLES_TPU_FORCE_CPU": "1"}
REFERENCE_NOT_RUN = ("not run: the reference Sniffles2 legs (tools/run_reference.py) "
                     "need the reference checkout, and the port's bench leaves them out")


def _sv_layout(ref_len):
    """The quick and scale legs' planted SVs (bench.py::_sv_layout)."""
    from sniffles_tpu_torch.sim import PlantedSV
    rng = np.random.default_rng(7)
    svs = []
    pos = 20_000
    i = 0
    while pos < ref_len - 25_000:
        kind = ("INS", "DEL", "INS", "DEL", "DUP", "INV")[i % 6]
        svlen = int(rng.choice((60, 120, 300, 800, 2500, 6000)))
        vaf = float(rng.choice((1.0, 1.0, 0.55, 0.55, 0.3)))
        if kind in ("DUP", "INV"):
            svlen, vaf = max(svlen, 600), 1.0
        svs.append(PlantedSV(pos=pos, svtype=kind, svlen=svlen, vaf=vaf))
        pos += int(rng.integers(30_000, 52_000))
        i += 1
    return svs


def build_dataset(bench_dir, ref_len, contigs):
    """(BAM, FASTA) of the quick or scale leg, written once into bench_dir."""
    from sniffles_tpu_torch.sim import write_dataset
    bam = os.path.join(bench_dir, "sim.bam")
    fa = os.path.join(bench_dir, "ref.fa")
    if os.path.exists(bam) and os.path.exists(fa):
        return bam, fa
    os.makedirs(bench_dir, exist_ok=True)
    return write_dataset(bench_dir, ref_len=ref_len, svs=_sv_layout(ref_len),
                         depth=DEPTH, read_len=12_000, seed=11,
                         n_contigs=contigs)


def child_env(env_extra=None) -> dict:
    """This process's environment with the checkout first on PYTHONPATH and
    `env_extra` applied (a value of None removes the variable)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for key, value in (env_extra or {}).items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    return env


def timed_run(cmd, env_extra=None, timeout=3600, side="run"):
    """Wall seconds of one run of `cmd`; raises RuntimeError when it fails.
    Logs the run on stderr."""
    env = child_env(env_extra)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)
    dt = time.perf_counter() - t0
    shown = " ".join(f"{k}={'<unset>' if v is None else shlex.quote(v)}"
                     for k, v in (env_extra or {}).items())
    print(f"[bench] {side} {dt:.2f} s: {shown} {shlex.join(cmd)}", file=sys.stderr,
          flush=True)
    if p.returncode != 0:
        raise RuntimeError(f"bench leg failed (exit {p.returncode}): {' '.join(cmd)}\n"
                           f"{p.stderr[-2000:]}")
    return dt


def timed_pairs(host_cmd, tpu_cmd, host_env, tpu_env, pairs=None, timeout=3600):
    """Alternating host/device measurement protocol (bench.py::timed_pairs):
    discarded warmup runs (one host, then device runs until two in a row
    are in the host's ballpark, at most 8), then `pairs` alternating
    (host, device) runs. Medians and per-pair deltas carry the ordering
    evidence; every warmup lands in the result."""
    pairs = pairs or PAIRS
    warm_host = timed_run(host_cmd, host_env, timeout, "host warmup")
    tpu_warms = [timed_run(tpu_cmd, tpu_env, timeout, "device warmup")]
    while (len(tpu_warms) < 8
           and (len(tpu_warms) < 2
                or max(tpu_warms[-2:]) > 1.5 * warm_host + 1.0)):
        tpu_warms.append(timed_run(tpu_cmd, tpu_env, timeout, "device warmup"))
    host_runs, tpu_runs = [], []
    for _ in range(pairs):
        host_runs.append(timed_run(host_cmd, host_env, timeout, "host"))
        tpu_runs.append(timed_run(tpu_cmd, tpu_env, timeout, "device"))
    deltas = [h - t for h, t in zip(host_runs, tpu_runs)]
    return {
        "host_median": round(float(np.median(host_runs)), 2),
        "tpu_median": round(float(np.median(tpu_runs)), 2),
        "host_runs": [round(r, 2) for r in host_runs],
        "tpu_runs": [round(r, 2) for r in tpu_runs],
        "pair_deltas": [round(d, 2) for d in deltas],
        "tpu_wins": sum(1 for d in deltas if d > 0),
        "pairs": pairs,
        "warmup_runs": [round(warm_host, 2)] + [round(w, 2) for w in tpu_warms],
    }


def load_json(path):
    with open(path) as f:
        return json.load(f)


def vcf_records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def host_command(args):
    """The port's CLI on the host path."""
    return [sys.executable, "-m", PKG, *args, "--no-tpu"]


def device_command(args, flag):
    """The port's CLI on the device path (`flag`: bench.py's --tpu-call or
    --tpu-combine, the port's default either way)."""
    return [sys.executable, "-m", PKG, *args, flag]


class Daemon:
    """The port's device daemon for the device legs: one process that holds
    the device and serves every device run of a leg over its socket."""

    def __init__(self, rundir=None):
        rundir = rundir or BENCH_DIR
        # in the temporary directory itself: a Unix socket's path has at
        # most 107 bytes, and a run directory may be deep
        self.sock = os.path.join(_TMP, f"stb{os.getpid()}-{id(self):x}.sock")
        self.log_path = os.path.join(rundir, "daemon.log")
        self.rundir = rundir
        self.command = [sys.executable, "-m", f"{PKG}.parallel.device_daemon",
                        "--socket", self.sock, "--idle-timeout", "900"]
        self.proc = None
        self.warm_s = None

    def start(self, timeout=900) -> None:
        """Starts the daemon and waits for its warmup (a ping answered);
        raises RuntimeError, with the end of its log, when it does not
        answer."""
        os.makedirs(self.rundir, exist_ok=True)
        if os.path.exists(self.sock):
            os.unlink(self.sock)
        t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(self.command, stdout=log, stderr=subprocess.STDOUT,
                                         env=child_env())
        from sniffles_tpu_torch.parallel.device_daemon import daemon_ping
        deadline = time.monotonic() + 60
        while not os.path.exists(self.sock):
            if time.monotonic() > deadline or self.proc.poll() is not None:
                self._refused("did not open its socket")
            time.sleep(0.2)
        try:
            daemon_ping(self.sock, timeout)
        except (RuntimeError, TimeoutError) as e:
            self._refused(f"did not answer a ping ({e})")
        self.warm_s = round(time.perf_counter() - t0, 2)

    def _refused(self, what):
        self.stop()
        with open(self.log_path) as f:
            tail = f.read()[-2000:]
        raise RuntimeError(f"the device daemon {what}:\n{tail}")

    def env(self, counters_path=None) -> dict:
        """The environment of a run it serves: its socket, no card visible
        and no SNIFFLES_TPU_FORCE_CPU (a served run makes no device check
        and creates no CUDA context)."""
        env = {"SNIFFLES_TPU_DEVICE_SOCKET": self.sock, "CUDA_VISIBLE_DEVICES": "",
               "SNIFFLES_TPU_FORCE_CPU": None}
        if counters_path:
            env["SNIFFLES_TPU_COUNTERS_JSON"] = counters_path
        return env

    def stats(self) -> dict:
        from sniffles_tpu_torch.parallel.device_daemon import daemon_stats
        return daemon_stats(self.sock)

    def stop(self):
        """Asks the daemon to exit (it is killed after 10 s)."""
        if self.proc is None or self.proc.poll() is not None:
            return
        from sniffles_tpu_torch.parallel.device_daemon import daemon_shutdown
        try:
            daemon_shutdown(self.sock, timeout=10)
        except (RuntimeError, TimeoutError):
            pass    # killed below
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def call_leg(out, daemon, key, bam, fa, rundir, threads=THREADS, pairs=None):
    """One call_sample leg in pairs: host path against served device path;
    returns the pairs' result and writes the records' equality into
    out[key + "records_identical"]."""
    base = ["--input", bam, "--reference", fa, "--allow-overwrite", "--threads", threads]
    host_vcf = os.path.join(rundir, f"{key}host.vcf")
    tpu_vcf = os.path.join(rundir, f"{key}tpu.vcf")
    counters_path = os.path.join(rundir, f"{key}counters.json")
    p = timed_pairs(host_command([*base, "--vcf", host_vcf]),
                    device_command([*base, "--vcf", tpu_vcf], "--tpu-call"),
                    HOST_ENV, daemon.env(counters_path), pairs=pairs)
    out[f"{key}tpu_records_identical"] = vcf_records(tpu_vcf) == vcf_records(host_vcf)
    return p, load_json(counters_path)


def bench_scale(out, daemon):
    """Decode-bound leg: ~960 MB multi-contig 30x sim (one-time build,
    reused across runs), then its inline (--threads 0) pairs."""
    bam, fa = build_dataset(SCALE_DIR, SCALE_REF_LEN, SCALE_CONTIGS)
    p, counters = call_leg(out, daemon, "scale_", bam, fa, SCALE_DIR)
    out["e2e_scale_seconds_ours"] = p["host_median"]
    out["e2e_scale_seconds_ours_tpu"] = p["tpu_median"]
    out["e2e_scale_pairs"] = p
    out["engine_counters_scale"] = counters
    if not os.environ.get("BENCH_SKIP_INLINE"):
        p, _ = call_leg(out, daemon, "scale_inline_", bam, fa, SCALE_DIR, threads="0",
                        pairs=int(os.environ.get("BENCH_INLINE_PAIRS", 5)))
        out["e2e_scale_inline_pairs"] = p
    out["e2e_scale_seconds_reference"] = None
    out["scale_reference_error"] = REFERENCE_NOT_RUN
    out["e2e_scale_bam_mb"] = round(os.path.getsize(bam) / 1e6, 1)


def bench_dense(out, daemon):
    """Compute-dense leg: SV sites every 1.5-3 kb at 60x (sim.dense_layout),
    where clustering and the calling statistics outweigh decode."""
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    bam = os.path.join(DENSE_DIR, "sim.bam")
    fa = os.path.join(DENSE_DIR, "ref.fa")
    if not (os.path.exists(bam) and os.path.exists(fa)):
        os.makedirs(DENSE_DIR, exist_ok=True)
        bam, fa = write_dataset(DENSE_DIR, ref_len=DENSE_REF_LEN,
                                svs=dense_layout(DENSE_REF_LEN),
                                depth=DENSE_DEPTH, read_len=12_000, seed=17,
                                n_contigs=DENSE_CONTIGS)
    p, counters = call_leg(out, daemon, "dense_", bam, fa, DENSE_DIR)
    out["e2e_dense_seconds_ours"] = p["host_median"]
    out["e2e_dense_seconds_ours_tpu"] = p["tpu_median"]
    out["e2e_dense_pairs"] = p
    out["engine_counters_dense"] = counters
    out["e2e_dense_seconds_reference"] = None
    out["dense_reference_error"] = REFERENCE_NOT_RUN
    out["e2e_dense_bam_mb"] = round(os.path.getsize(bam) / 1e6, 1)


def bench_combine256(out):
    """Population combine leg: a 256-sample cohort at population-call-set
    site density, host against the device greedy (--tpu-combine), through
    tools/bench_combine.py's pairs. Its carriers share each INS allele, and
    equal alleles make no edit-distance pair, so no batch reaches the
    edit-distance kernel. The child runs a daemon of its own, so this runs
    after the main daemon has stopped."""
    json_out = os.path.join(COMBINE_DIR, "combine.json")
    cmd = [sys.executable, "-m", f"{PKG}.tools.bench_combine",
           "--dir", COMBINE_DIR,
           "--samples", os.environ.get("BENCH_COMBINE_SAMPLES", "256"),
           "--ref-len", os.environ.get("BENCH_COMBINE_REF_LEN", "600000"),
           "--depth", "12", "--site-gap", "2000,3500",
           "--pairs", os.environ.get("BENCH_COMBINE_PAIRS", "5"),
           "--json-out", json_out]
    p = subprocess.run(cmd, capture_output=True, text=True, env=child_env(), timeout=3600)
    sys.stderr.write(p.stderr)
    if p.returncode != 0:
        raise RuntimeError(f"combine leg failed (exit {p.returncode}):\n{p.stdout[-2000:]}")
    out["combine256"] = load_json(json_out)


def bench_e2e():
    bam, fa = build_dataset(BENCH_DIR, REF_LEN, CONTIGS)
    out = {}
    daemon = Daemon()
    try:
        daemon.start()
        out["tpu_daemon_warm_s"] = daemon.warm_s
        p, counters = call_leg(out, daemon, "", bam, fa, BENCH_DIR)
        out["e2e_seconds_ours"] = p["host_median"]
        out["e2e_seconds_ours_tpu"] = p["tpu_median"]
        out["e2e_pairs"] = p
        out["engine_counters_quick"] = counters
        out["e2e_seconds_reference"] = None
        out["reference_error"] = REFERENCE_NOT_RUN
        out["e2e_bam_mb"] = round(os.path.getsize(bam) / 1e6, 1)
        if not os.environ.get("BENCH_SKIP_DENSE"):
            bench_dense(out, daemon)
        if not os.environ.get("BENCH_SKIP_SCALE"):
            bench_scale(out, daemon)
        out["device_service_stats"] = daemon.stats()
    finally:
        daemon.stop()
    if not os.environ.get("BENCH_SKIP_COMBINE"):
        bench_combine256(out)
    return out


def bench_device(n_signatures: int, iters: int = 10, repeats: int = 3) -> float:
    """Fused device step throughput (signatures a second), mean over
    repeats; the kernels are built and one step runs before the window."""
    import torch
    from sniffles_tpu_torch.config import torch_device
    from sniffles_tpu_torch.parallel.engine import (call_pipeline_step, default_params,
                                                    to_device)
    from sniffles_tpu_torch.signatures import synthetic_batch

    device = torch_device()
    if device == "cuda":
        from sniffles_tpu_torch.ops import _build
        _build.build_all()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    n_clusters = max(64, n_signatures // 40)
    batch = synthetic_batch(n_signatures, n_clusters, seed=42,
                            genome_span=900_000, batch_size=n_signatures)
    sig, coverage = to_device(batch.as_dict(), np.full(1_000_000, 30, dtype=np.int32),
                              device)
    params = default_params()

    call_pipeline_step(sig, coverage, params)
    sync()
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            call_pipeline_step(sig, coverage, params)
        sync()
        rates.append(n_signatures / ((time.perf_counter() - t0) / iters))
    return float(np.mean(rates))


def bench_host(n_signatures: int) -> float:
    """Host-exact pipeline throughput on the same workload size (the
    reference architecture's per-core speed class)."""
    from sniffles_tpu_torch import cluster as cl, postprocess as pp, svcall as sv
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import Lead, LeadProvider
    from sniffles_tpu_torch.ops._call_consts import SVTYPE_NAMES
    from sniffles_tpu_torch.signatures import synthetic_batch

    config = SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf")
    batch = synthetic_batch(n_signatures, max(16, n_signatures // 40), seed=42,
                            genome_span=900_000, batch_size=n_signatures)

    provider = LeadProvider(config, 0, "chr1")
    binsize = config.cluster_binsize
    for i in range(batch.count):
        svtype = SVTYPE_NAMES[batch.svtype[i]]
        ld = Lead(read_id=int(batch.read_id[i]), read_qname=str(batch.read_id[i]),
                  contig="chr1", ref_start=int(batch.pos[i]), ref_end=int(batch.pos[i]),
                  qry_start=0, qry_end=0, strand="+" if batch.strand[i] > 0 else "-",
                  mapq=int(batch.mapq[i]), nm=float(batch.nm[i]), source="INLINE",
                  svtype=svtype, svlen=int(batch.svlen[i]))
        provider.record_lead(ld, int(ld.ref_start / binsize) * binsize)
    provider.start = 0
    provider.end = 1_000_000
    provider.coverage = np.full(1_000_000, 30, dtype=np.uint16)

    class T:
        sv_id = 0
        id = 0

    t0 = time.perf_counter()
    task = T()
    calls = []
    for svtype in sv.ALL_TYPES:
        for svcluster in cl.resolve(svtype, provider, config, None):
            svcluster.get_sa_count()
            for svc in sv.call_from(svcluster, config, True, task):
                calls.append(svc)
    pp.coverage(calls, provider)
    for svc in calls:
        pp.qc_sv(svc, config)
        pp.genotype_sv(svc, config)
    dt = time.perf_counter() - t0
    return n_signatures / dt


def device_line(device: str) -> str:
    """The device every number of the run was taken on: the card's
    nvidia-smi name and power limit, or the CPU."""
    if device != "cuda":
        return "cpu (SNIFFLES_TPU_FORCE_CPU=1)"
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def records_differ(result, prefix="") -> list:
    """The *records_identical keys of `result` (nested ones too) that are
    not true."""
    found = []
    for key, value in result.items():
        if isinstance(value, dict):
            found += records_differ(value, f"{prefix}{key}.")
        elif key.endswith("records_identical") and value is not True:
            found.append(prefix + key)
    return found


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog=f"python -m {PKG}.bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    from sniffles_tpu_torch.config import torch_device
    device = torch_device()     # raises with no card unless the CPU was asked for
    result = {"device": device_line(device)}
    result.update(bench_e2e())

    # equal-workload kernel comparison + device peak
    equal_n = int(os.environ.get("BENCH_SIGNATURES_EQUAL", 1 << 16))
    peak_n = int(os.environ.get("BENCH_SIGNATURES", 1 << 21))
    result["device_sig_per_sec_equal"] = round(bench_device(equal_n), 1)
    result["device_sig_per_sec_peak"] = round(bench_device(peak_n), 1)
    result["host_sig_per_sec_equal"] = round(bench_host(equal_n), 1)
    result["equal_workload_signatures"] = equal_n

    ours = result.get("e2e_seconds_ours_tpu") or result.get("e2e_seconds_ours")
    # bench.py's headline, the faster of host/device configurations: not a
    # device metric (the module's docstring)
    if result.get("e2e_seconds_ours") and ours:
        ours = min(ours, result["e2e_seconds_ours"])

    print(json.dumps({
        "metric": "e2e_bam_to_vcf_seconds",
        "value": round(ours, 2) if ours else None,
        "unit": "s",
        "vs_baseline": None,
        **{k: (round(v, 2) if isinstance(v, float) else v)
           for k, v in result.items()},
    }), flush=True)
    differ = records_differ(result)
    if differ:
        print(f"[bench] device records differ from host records: {', '.join(differ)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
