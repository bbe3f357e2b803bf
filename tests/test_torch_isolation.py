"""The port (sniffles_tpu_torch/ and chip_smoke.py) stands alone: it imports
neither JAX nor anything of the JAX package sniffles_tpu, its combine and
call_sample run with both blocked from import (inline and with the worker
pool), it loads its own build of the native host library and never the
JAX package's native/libbamcore.so, and without a card it raises unless
the CPU was asked for. Its device daemon serves with both blocked too,
and so does --tpu-mesh (parallel/mesh.py, distributed.py and the modules
under them), and the fused engine's step and its sharded step
(parallel/engine.py, build_sharded_step); the benchmark's own process
(bench.py) is held so in tests/test_torch_bench.py. Every module of the
JAX package has its copy.
Options refused before their slices were ported (--threads N
with the device path, --dev-cache, --dev-locasm-do, .cram input,
--tpu-mesh) now run."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sniffles_tpu_torch")

# import statements of jax or of the JAX package (sniffles_tpu_torch is
# the port itself: "sniffles_tpu" followed by "_" is not a match)
_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|sniffles_tpu)(\.|\s|$|,)", re.M)
_DYNAMIC = re.compile(r"""import_module\(\s*["'](jax|sniffles_tpu)(["'.])""")


def port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh", ".cc"))]
    return paths


# appended to the scripts below: the process loaded the port's own build
# of the native library (build/torch_kernels/libbamcore-<hash>.so) and
# nothing from the JAX package's native/ directory
NATIVE_CHECK = """
with open("/proc/self/maps") as f:
    maps = f.read()
assert "/native/libbamcore" not in maps, "the JAX package's native library is loaded"
assert "/build/torch_kernels/libbamcore-" in maps, "the port's native library is not loaded"
"""


def test_port_sources_import_no_jax():
    sources = port_sources()
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "import jax" not in text, path
        assert "sniffles_tpu." not in text, path
        assert "from sniffles_tpu " not in text, path
        assert not _IMPORT.search(text), path
        assert not _DYNAMIC.search(text), path


def test_source_scan_covers_the_engine_modules():
    scanned = {os.path.relpath(p, PORT) for p in port_sources()}
    assert {"signatures.py", "parallel/engine.py", "parallel/mesh.py", "ops/coverage.py",
            "ops/genotype_batch.py", "ops/qc_batch.py", "ops/merge_relax.py",
            "ops/candidate_tail.py", "csrc/merge_relax.cu", "csrc/candidate_tail.cu",
            "csrc/range_metrics.cuh"} <= scanned


def test_source_scan_covers_the_call_statistics():
    scanned = {os.path.relpath(p, PORT) for p in port_sources()}
    assert {"ops/call_stats.py", "csrc/call_stats.cu"} <= scanned


def test_source_scan_covers_the_combine_greedy():
    scanned = {os.path.relpath(p, PORT) for p in port_sources()}
    assert {"ops/combine_greedy.py", "csrc/combine_greedy.cu",
            "tools/time_combine_greedy.py"} <= scanned


def test_source_scan_covers_the_bench_and_the_fuzz():
    scanned = {os.path.relpath(p, PORT) for p in port_sources()}
    assert {"bench.py", "tools/bench_combine.py", "tools/diff_fuzz.py",
            "term_colors.py"} <= scanned


def test_every_module_of_the_jax_package_has_a_copy():
    """Each module of sniffles_tpu/ has one of the same relative path in the
    port, but ops/edit_distance_jax.py (the Pallas kernel), whose port is
    ops/edit_distance_batch.py; the last copy, term_colors.py, has the JAX
    package's TermColors."""
    from sniffles_tpu.term_colors import TermColors as JaxColors
    from sniffles_tpu_torch.term_colors import TermColors

    def modules(root):
        return {os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root)
                for f in files if f.endswith(".py")}

    port = modules(PORT) | {"ops/edit_distance_jax.py"}
    assert modules(os.path.join(REPO, "sniffles_tpu")) <= port
    assert "ops/edit_distance_batch.py" in port

    def colors(cls):
        return {k: v for k, v in vars(cls).items() if not k.startswith("_")}
    assert colors(TermColors) == colors(JaxColors) and len(colors(TermColors)) == 9


def test_engine_and_sharded_step_run_with_jax_blocked():
    """call_pipeline_step and build_sharded_step (4 shards) on the CPU in a
    process where jax and sniffles_tpu cannot be imported."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
import numpy as np
from sniffles_tpu_torch.signatures import synthetic_batch
from sniffles_tpu_torch.parallel.engine import call_pipeline_step, default_params
from sniffles_tpu_torch.parallel.mesh import build_sharded_step, shard_batch
b = synthetic_batch(3000, 50, seed=5, genome_span=400_000, batch_size=4096)
out = call_pipeline_step(b.as_dict(), np.full(500_000, 30, np.int32), default_params())
assert int(out["n_clusters"]) >= 50 and int(out["cluster_valid"].sum()) >= 50
sig = shard_batch(b.as_dict(), 4)
step = build_sharded_step(["cpu"] * 4, default_params(), halo_bp=5000, halo_slots=256)
meshed = step(sig, np.full(4 * 131072, 30, np.int32), np.arange(4, dtype=np.int32) * 131072)
assert meshed["halo_overflow"].shape == (4,) and int(meshed["cluster_valid"].sum()) > 0
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_combine_runs_with_jax_blocked(tmp_path):
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch.sim import write_cohort
from sniffles_tpu_torch.cli import main
snfs = write_cohort(sys.argv[1], 3, 5, contigs=(("chr1", 200_000),),
                    lengths=(60, 120, 300))
for extra in ([], ["--no-tpu"]):
    out = sys.argv[1] + "/out%d.vcf" % len(extra)
    assert main(["--input", *snfs, "--vcf", out, "--threads", "0", *extra]) == 0
    records = [l for l in open(out) if not l.startswith("#")]
    assert records, out
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
""" + NATIVE_CHECK + """
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_call_sample_runs_with_jax_blocked(tmp_path):
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch.sim import PlantedSV, write_dataset
from sniffles_tpu_torch.cli import main
bam, fa = write_dataset(sys.argv[1], ref_len=120_000, depth=20, read_len=10_000, seed=3,
                        svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                             PlantedSV(pos=80_000, svtype="INS", svlen=200)])
outs = []
for extra in ([], ["--no-tpu"]):
    out = sys.argv[1] + "/out%d.vcf" % len(extra)
    assert main(["--input", bam, "--reference", fa, "--vcf", out, "--threads", "0",
                 *extra]) == 0
    outs.append([l for l in open(out) if not l.startswith("#")])
assert len(outs[0]) == 2 and outs[0] == outs[1], outs
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
""" + NATIVE_CHECK + """
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_bam_input_without_card_raises(monkeypatch, tmp_path):
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset

    bam, fa = write_dataset(str(tmp_path), ref_len=60_000, depth=10, read_len=8_000,
                            seed=4, svs=[PlantedSV(pos=30_000, svtype="DEL", svlen=200)])
    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.vcf"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", bam, "--reference", fa, "--vcf", str(out), "--threads", "0"])
    # the host path needs no device
    assert cli.main(["--input", bam, "--reference", fa, "--vcf", str(out), "--threads", "0",
                     "--no-tpu", "--allow-overwrite"]) == 0


def run_port(args, cwd):
    """The port's CLI in a process of its own, on the CPU device."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-m", "sniffles_tpu_torch", *args],
                       capture_output=True, text=True, env=env, cwd=str(cwd), timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


def records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def runs_like_threads_0(inputs, extra, tmp_path):
    """`extra` (a --threads N command line with the device path, or an
    output option) exits 0 and writes the records of --threads 0; returns
    the --threads 0 VCF."""
    threads0, threaded = tmp_path / "t0.vcf", tmp_path / "o.vcf"
    run_port([*inputs, "--vcf", str(threads0), "--threads", "0"], tmp_path)
    run_port([*inputs, "--vcf", str(threaded), *extra], tmp_path)
    assert records(threaded) and records(threaded) == records(threads0)
    return threads0


@pytest.mark.parametrize("extra", [
    pytest.param(["--threads", "4"], id="threads-with-device-path"),
    pytest.param(["--threads", "0", "--genotype-vcf", "t0.vcf"], id="genotype-vcf"),
    pytest.param(["--threads", "0", "--snf", "x.snf"], id="snf-output"),
    pytest.param(["--threads", "0", "--dev-cache", "--dev-cache-dir", "cache"],
                 id="dev-cache"),
    pytest.param(["--threads", "0", "--dev-locasm-do"], id="local-assembly"),
    pytest.param(["--threads", "0", "--tpu-mesh", "2"], id="tpu-mesh"),
])
def test_formerly_refused_call_sample_options_run(extra, tmp_path):
    """--threads N with the device path, --genotype-vcf, --snf, --dev-cache,
    --dev-locasm-do and --tpu-mesh were refused before their slices were
    ported; none is refused now, and each case checks that its command
    line runs: --threads 4, --snf, --dev-cache
    (which writes the task's leadtab to its cache directory),
    --dev-locasm-do (no call of this sample is filtered, so nothing is
    assembled) and --tpu-mesh 2 give the records of --threads 0, and force
    calling against those records re-emits each of them as 1/1."""
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset
    bam, fa = write_dataset(str(tmp_path), ref_len=60_000, depth=10, read_len=8_000,
                            seed=4, svs=[PlantedSV(pos=30_000, svtype="DEL", svlen=200)])
    inputs = ["--input", bam, "--reference", fa]
    if "--genotype-vcf" in extra:
        run_port([*inputs, "--vcf", str(tmp_path / "t0.vcf"), "--threads", "0"], tmp_path)
        run_port([*inputs, "--vcf", str(tmp_path / "g.vcf"), *extra], tmp_path)
        called, genotyped = records(tmp_path / "t0.vcf"), records(tmp_path / "g.vcf")
        assert len(genotyped) == len(called) == 1
        assert genotyped[0].split("\t")[:8] == called[0].split("\t")[:8]
        assert genotyped[0].split("\t")[-1].startswith("1/1")
        return
    runs_like_threads_0(inputs, extra, tmp_path)
    if "--snf" in extra:
        with open(tmp_path / "x.snf", "rb") as f:
            header = json.loads(f.readline())
        assert header["snf_candidate_count"] >= 1 and list(header["index"]) == ["chr1"]
    if "--dev-cache" in extra:
        assert os.listdir(tmp_path / "cache") == ["sim.bam_chr1_0_999999.pickle"]


def test_cram_input_gives_the_records_of_its_bam(tmp_path):
    """.cram input, refused before its slice was ported: the port's CLI
    calls a reference-based CRAM written by the port's simulator from its
    BAM, and writes the BAM's records."""
    from sniffles_tpu_torch.sim import PlantedSV, write_cram, write_dataset
    bam, fa = write_dataset(str(tmp_path), ref_len=60_000, depth=10, read_len=8_000,
                            seed=4, svs=[PlantedSV(pos=30_000, svtype="DEL", svlen=200),
                                         PlantedSV(pos=45_000, svtype="INS", svlen=150)])
    cram = write_cram(bam, fa)
    run_port(["--input", bam, "--reference", fa, "--vcf", str(tmp_path / "bam.vcf"),
              "--threads", "0"], tmp_path)
    run_port(["--input", cram, "--reference", fa, "--vcf", str(tmp_path / "cram.vcf"),
              "--threads", "0"], tmp_path)
    assert len(records(tmp_path / "bam.vcf")) == 2
    assert records(tmp_path / "cram.vcf") == records(tmp_path / "bam.vcf")


def test_no_card_without_cpu_request_raises(monkeypatch, tmp_path):
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.config import torch_device

    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_device()
    snf = tmp_path / "a.snf"
    snf.write_text("")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", str(snf), "--vcf", str(tmp_path / "o.vcf"),
                  "--threads", "0"])
    # the host path needs no device
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")
    assert torch_device() == "cpu"


def test_threads_with_device_path_runs(tmp_path):
    """Refused before the worker pool was ported; now --threads 4 on .snf
    inputs runs the device path through the parent's device service."""
    # the cohort is written in a process of its own: in this one the JAX
    # package may hold the "sniffles.sv" pickle alias
    code = ("import sys; from sniffles_tpu_torch.sim import write_cohort; "
            "print(' '.join(write_cohort(sys.argv[1], 3, 5, contigs=(('chr1', 200_000),), "
            "lengths=(60, 120, 300))))")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "cohort")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    runs_like_threads_0(["--input", *r.stdout.split()], ["--threads", "4"], tmp_path)


def test_worker_pool_runs_with_jax_blocked(tmp_path):
    """--threads 2, device path and host path, combine and call_sample, in
    a process where jax and sniffles_tpu cannot be imported: the forked
    workers inherit the block, and nothing of either is loaded."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch.sim import PlantedSV, write_cohort, write_dataset
from sniffles_tpu_torch.cli import main
snfs = write_cohort(sys.argv[1] + "/cohort", 3, 5, contigs=(("chr1", 200_000),),
                    lengths=(60, 120, 300))
bam, fa = write_dataset(sys.argv[1], ref_len=120_000, depth=20, read_len=10_000, seed=3,
                        svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                             PlantedSV(pos=80_000, svtype="INS", svlen=200)])
for inputs in (snfs, [bam, "--reference", fa]):
    outs = []
    for extra in ([], ["--no-tpu"]):
        out = sys.argv[1] + "/out%d.vcf" % len(extra)
        assert main(["--input", *inputs, "--vcf", out, "--threads", "2",
                     "--allow-overwrite", *extra]) == 0
        outs.append([l for l in open(out) if not l.startswith("#")])
    assert outs[0] and outs[0] == outs[1], outs
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
""" + NATIVE_CHECK + """
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_all_run_modes_run_with_jax_blocked(tmp_path):
    """The four run modes at --threads 2 in a process where jax and
    sniffles_tpu cannot be imported: --snf from call_sample for two
    samples, their combine to .vcf.gz with --dev-population-snf, a combine
    annotated with that population SNF, and --genotype-vcf against the
    cohort VCF; nothing of either package is loaded."""
    code = """
import gzip, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch.sim import PlantedSV, write_dataset
from sniffles_tpu_torch.cli import main
d = sys.argv[1]
bam, fa = write_dataset(d, ref_len=120_000, depth=20, read_len=10_000, seed=3, n_contigs=2,
                        svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                             PlantedSV(pos=80_000, svtype="INS", svlen=200)])
common = ["--threads", "2", "--allow-overwrite"]
for name in ("A", "B"):
    assert main(["--input", bam, "--snf", f"{d}/{name}.snf", "--sample-id", name,
                 *common]) == 0
snfs = [f"{d}/A.snf", f"{d}/B.snf"]
assert main(["--input", *snfs, "--vcf", f"{d}/cohort.vcf.gz", "--dev-population-snf",
             f"{d}/pop.snf", *common]) == 0
cohort = [l for l in gzip.open(f"{d}/cohort.vcf.gz", "rt") if not l.startswith("#")]
assert len(cohort) == 4, cohort
assert main(["--input", *snfs, "--vcf", f"{d}/annotated.vcf", "--combine-population",
             f"{d}/pop.snf", *common]) == 0
annotated = [l for l in open(f"{d}/annotated.vcf") if not l.startswith("#")]
assert len(annotated) == 4 and all("POPULATION_AF=1.000" in l for l in annotated)
assert main(["--input", bam, "--genotype-vcf", f"{d}/cohort.vcf.gz", "--vcf",
             f"{d}/genotyped.vcf", *common]) == 0
genotyped = [l for l in open(f"{d}/genotyped.vcf") if not l.startswith("#")]
assert len(genotyped) == 4 and all(l.split("\\t")[9].startswith("1/1") for l in genotyped)
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
""" + NATIVE_CHECK + """
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_mesh_runs_with_jax_blocked(tmp_path):
    """--tpu-mesh 2 in a process where jax and sniffles_tpu cannot be
    imported: call_sample at --threads 0 and 2 through the mesh (its
    counters say so) and a combine of two samples, each with the records
    of its run without the mesh; nothing of either package is loaded."""
    code = """
import json, os, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch.sim import PlantedSV, write_dataset
from sniffles_tpu_torch.cli import main
d = sys.argv[1]
bam, fa = write_dataset(d, ref_len=120_000, depth=20, read_len=10_000, seed=3,
                        svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                             PlantedSV(pos=80_000, svtype="INS", svlen=200)])
def run(args, mesh):
    os.environ["SNIFFLES_TPU_COUNTERS_JSON"] = f"{d}/c.json"
    assert main([*args, "--allow-overwrite", *(["--tpu-mesh", "2"] if mesh else [])]) == 0
    return json.load(open(f"{d}/c.json"))
def recs(path):
    return [l for l in open(path) if not l.startswith("#")]
for threads in ("0", "2"):
    c = run(["--input", bam, "--vcf", f"{d}/m{threads}.vcf", "--threads", threads], True)
    assert c["mesh_tasks"] == 1, c
run(["--input", bam, "--vcf", f"{d}/plain.vcf", "--threads", "0"], False)
assert len(recs(f"{d}/plain.vcf")) == 2
assert recs(f"{d}/m0.vcf") == recs(f"{d}/m2.vcf") == recs(f"{d}/plain.vcf")
for name in ("A", "B"):
    run(["--input", bam, "--snf", f"{d}/{name}.snf", "--sample-id", name, "--threads", "0"],
        False)
snfs = [f"{d}/A.snf", f"{d}/B.snf"]
run(["--input", *snfs, "--vcf", f"{d}/cm.vcf", "--threads", "0"], True)
run(["--input", *snfs, "--vcf", f"{d}/cp.vcf", "--threads", "0"], False)
assert len(recs(f"{d}/cm.vcf")) == 2 and recs(f"{d}/cm.vcf") == recs(f"{d}/cp.vcf")
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
assert "sniffles_tpu_torch.parallel.mesh" in sys.modules
""" + NATIVE_CHECK + """
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["OMP_NUM_THREADS"] = "1"   # small tensors: one torch thread
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_device_daemon_serves_with_jax_blocked(tmp_path):
    """The device daemon (parallel/device_daemon.py) in a process where jax
    and sniffles_tpu cannot be imported, on the CPU, with its full warmup
    (the call steps at 1, 2, 4 and 8 times the floor width and the fused
    k = 2 and 4 steps): it answers a ping, a call_task, a cluster_assign
    and a combine_greedy request and serves a CLI run at --threads 0,
    whose records equal the in-process run's, then shuts down on
    request; nothing of either package is loaded."""
    code = """
import os, sys, threading
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["sniffles_tpu"] = None
from sniffles_tpu_torch.parallel import device_daemon as dd
from sniffles_tpu_torch.sim import PlantedSV, fuzz_call_batch, write_dataset
from sniffles_tpu_torch.cli import main
d = sys.argv[1]
sock = d + "/d.sock"
served = threading.Thread(target=dd.serve, args=(sock,), kwargs={"device": "cpu"})
served.start()
while not dd.answers(sock):
    pass
client = dd.DaemonClient(sock)
assert client.ping(timeout=120)
meta = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
            cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50, binsize=100,
            resplit_binsize=20)
packed = fuzz_call_batch(11, 512)
assert client.call_task(packed, dict(meta, cluster_merge_pos=150, global_repeat=False))["nc"] > 0
assert client.cluster_assign(packed[[0, 1, 2, 8, 4, 5]], meta).shape == (3, 512)
import numpy as np
z = np.zeros(0, np.int32)
greedy = client.request("combine_greedy", {"c_pos": np.array([0, 5], np.int32),
    "c_len": np.array([100, 100], np.int32), "c_alt": np.zeros(2, np.int32), "g_psum": z,
    "g_lsum": z, "g_n": z, "g_head": z, "n_alts": 1, "ed_rows": z, "ed_cols": z,
    "ed_vals": z}, {"cm": 250, "cmm": 1000, "limit": 0.0})
assert greedy["assign"].tolist() == [0, 0], greedy
stats = dd.daemon_stats(sock)
assert stats["device"] == "cpu" and stats["requests"] >= 5, stats
bam, fa = write_dataset(d, ref_len=120_000, depth=20, read_len=10_000, seed=3,
                        svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                             PlantedSV(pos=80_000, svtype="INS", svlen=200)])
outs = []
for socket_env in (sock, None):
    if socket_env:
        os.environ[dd.ENV_SOCKET] = socket_env
    else:
        os.environ.pop(dd.ENV_SOCKET)
    out = d + "/out%d.vcf" % len(outs)
    assert main(["--input", bam, "--reference", fa, "--vcf", out, "--threads", "0"]) == 0
    outs.append([l for l in open(out) if not l.startswith("#")])
assert len(outs[0]) == 2 and outs[0] == outs[1], outs
assert dd.daemon_stats(sock)["requests"] > stats["requests"] + 1
client.shutdown()
served.join(60)
assert not served.is_alive() and not os.path.exists(sock)
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m == "sniffles_tpu" or m.startswith("sniffles_tpu.")]
assert loaded == ["sniffles_tpu"], loaded
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")
