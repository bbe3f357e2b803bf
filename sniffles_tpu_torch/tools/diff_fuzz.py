#!/usr/bin/env python3
"""Randomized differential check of the port: simulated datasets with
adversarial SV layouts and random flag sets, run through the port's device
path, its host path and, optionally, another CLI module, whose VCF records
and SNFs must all be equal.

    python -m sniffles_tpu_torch.tools.diff_fuzz [N_SEEDS] [START_SEED]
        [--against MODULE] [--jobs J]

N_SEEDS (default 10) seeds from START_SEED (default 1000). Each seed draws
(gen_dataset, in the order of tools/diff_fuzz.py's gen_dataset, whose
layouts the same seed reproduces):
  - a layout of 200 kb contigs: INS/DEL/DUP/INV of 50-2,000 bp, a quarter
    of them 600-1,500 bp from the last, VAFs 0.15-1; depth 12-45, reads of
    8-20 kb, phased or not, 1 or 2 contigs; then, drawn after those:
  - two NM rates, one a contig (half the two-contig seeds);
  - a reference-based CRAM in place of the BAM (sim.write_cram);
  - a flag set: --minsvlen, --mosaic, --phase, --no-qc, --output-rnames,
    --tandem-repeats, --reference (tools/diff_fuzz.py's), and --qc-nm,
    --minsupport, --detect-large-ins False, --dev-no-resplit,
    --cluster-binsize;
  - --tpu-mesh 2 for the port's device path (both shards on cuda:0);
  - --threads 0 or 2 for the port's two paths;
  - two more samples (the layouts of seeds + 100,000 and + 200,000, the
    same input kind), and the combine's flags (--combine-output-filtered,
    --combine-pctseq 0).
Three modes, each through every path:
  call      call_sample of sample 0 with the flag set;
  genotype  force calling of sample 0 (--genotype-vcf) against the host
            path's call VCF, with the flag set;
  combine   the three samples called to .snf (no flag set beyond
            --reference for a CRAM), then combined.
Paths, each in a directory of its own, with the same relative file names:
  device    `python -m sniffles_tpu_torch`, the device path (on the card;
            on the CPU with SNIFFLES_TPU_FORCE_CPU=1);
  host      the same with --no-tpu;
  against   `python -m MODULE` at --threads 2, its default path, when
            --against names a module. --threads 2: the JAX package's NM
            race (ROADMAP C, "The NM race") changes its records from run to
            run at --threads 0.
Compared with the host path: each VCF's records, byte for byte, and each
sample's SNF (io/snf_compare.snf_differences: the index, each block's
decompressed bytes, the header's config). The only exceptions to "equal":
  - the device path's SNF of a sample whose input is a phased CRAM may
    differ from the host path's only in which of its equal strings are
    one object (snf_equal_but_string_identity: the same contigs, blocks
    and count, and every block, unpickled with each string interned,
    pickles again to the same bytes), and the seed's line says so. The
    host path votes a call's phase set from its leads' own PS strings,
    which a CRAM's reads share, so the pickle writes a back-reference;
    the device path builds the strings anew from its integer tallies
    (postprocess.phase_sv). The JAX package does the same (its --tpu-call
    writes the port's device bytes, its host path the port's host bytes):
    ROADMAP C, "Phase strings pickled by reference". Any other sample, and
    any other difference, fails the seed;
and these config keys of the SNF header:
  - RUN_KEYS_THAT_DIFFER (io/snf_compare.py): run stamps and device flags,
    between any two runs;
  - "tpu_mesh": the device path's --tpu-mesh, which --no-tpu resets to 0;
  - against another package, AGAINST_KEYS_THAT_DIFFER: its command line
    and device flags, and the regional NM statistic that the JAX package
    writes onto the shared config (ROADMAP C, "The NM race"; the port
    keeps it on the task's lead provider).
Prints one line per seed; exits non-zero when a run fails or anything
differs, and then keeps the files of each seed that did (the last line
names their directory).
"""
import argparse
import io
import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sniffles_tpu_torch.bench import child_env, vcf_records  # noqa: E402
from sniffles_tpu_torch.io.snf_compare import (RUN_KEYS_THAT_DIFFER, snf_differences,  # noqa: E402
                                               snf_parts)

PORT = "sniffles_tpu_torch"
SAMPLES = 3
# the shards of --tpu-mesh 2 on the card (the CPU's with SNIFFLES_TPU_FORCE_CPU)
MESH_DEVICES = "cuda:0,cuda:0"
MESH_KEYS_THAT_DIFFER = {"tpu_mesh": "the device path's --tpu-mesh; --no-tpu resets it to 0"}
AGAINST_KEYS_THAT_DIFFER = {
    "command": "the command line, sys.argv: another module path",
    "device": "only the port has it",
    "tpu_combine": "a device flag the port's device path sets with tpu_call",
    "qc_nm_threshold": "the JAX package writes a task's regional NM statistic onto the "
                       "shared config (ROADMAP C, the NM race); the port keeps it on the "
                       "task's lead provider",
    "average_regional_nm": "as qc_nm_threshold",
}


def gen_dataset(dirpath, seed, cram=None):
    """Writes sample `seed`'s dataset into dirpath; returns (input path,
    FASTA path, call flags, whether the input is a CRAM, whether its reads
    are phased). `cram` forces the input kind (the combine's other samples
    take sample 0's)."""
    import numpy as np
    from sniffles_tpu_torch.sim import PlantedSV, write_cram, write_dataset
    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)
    svs = []
    pos = 6000
    while pos < 180_000:
        svtype = rnd.choice(["INS", "DEL", "DUP", "INV"])
        svlen = int(rng.integers(50, 2000))
        vaf = rnd.choice([1.0, 1.0, 0.5, 0.5, 0.3, 0.15])
        svs.append(PlantedSV(pos=pos, svtype=svtype, svlen=svlen, vaf=vaf))
        # sometimes nearly-adjacent SVs (clustering stress)
        pos += (rnd.choice([600, 900, 1500]) if rnd.random() < 0.25
                else int(rng.integers(2500, 6000)))
    depth = rnd.choice([12, 20, 30, 45])
    read_len = rnd.choice([8000, 12000, 20000])
    phased = rnd.random() < 0.4
    n_contigs = rnd.choice([1, 2])
    flags = []
    if rnd.random() < 0.3:
        flags += ["--minsvlen", str(rnd.choice([35, 80, 150]))]
    if rnd.random() < 0.3:
        flags += ["--mosaic"]
    if rnd.random() < 0.3:
        flags += ["--phase"]
    if rnd.random() < 0.25:
        flags += ["--no-qc"]
    if rnd.random() < 0.25:
        flags += ["--output-rnames"]
    if rnd.random() < 0.3:
        with open(os.path.join(dirpath, "tr.bed"), "w") as f:
            f.write("chr1\t10000\t60000\nchr1\t100000\t150000\n")
        flags += ["--tandem-repeats", "tr.bed"]
    with_reference = rnd.random() < 0.5
    # drawn after tools/diff_fuzz.py's draws, which keep their layouts
    if rnd.random() < 0.25:
        flags += ["--qc-nm"]
    if rnd.random() < 0.25:
        flags += ["--minsupport", rnd.choice(["auto", "2", "5"])]
    if rnd.random() < 0.2:
        flags += ["--detect-large-ins", "False"]
    if rnd.random() < 0.2:
        flags += ["--dev-no-resplit"]
    if rnd.random() < 0.2:
        flags += ["--cluster-binsize", str(rnd.choice([50, 200]))]
    nm_rates = ()
    if n_contigs == 2 and rnd.random() < 0.5:
        nm_rates = (rnd.choice([0.0, 0.005, 0.02]), rnd.choice([0.01, 0.04]))
    if cram is None:
        cram = rnd.random() < 0.25
    bam, fasta = write_dataset(dirpath, ref_len=200_000, svs=svs, depth=depth, seed=seed,
                               read_len=read_len, phased=phased, n_contigs=n_contigs,
                               nm_rates=nm_rates)
    if cram:
        bam = write_cram(bam, fasta)
        with_reference = True
    if with_reference:
        flags += ["--reference", "ref.fa"]
    return bam, fasta, flags, cram, phased


def draw_run(seed):
    """(mesh for the device path, the port's --threads, combine flags) of a seed."""
    rnd = random.Random(seed * 31 + 7)
    mesh = rnd.random() < 0.25
    threads = rnd.choice(["0", "2"])
    flags = []
    if rnd.random() < 0.3:
        flags += ["--combine-output-filtered"]
    if rnd.random() < 0.3:
        flags += ["--combine-pctseq", "0"]
    return mesh, threads, flags


def relative(flags, prefix):
    """The flag set with its file arguments as paths from a path's directory."""
    out = []
    for i, f in enumerate(flags):
        out.append(os.path.join(prefix, f) if i and flags[i - 1] in (
            "--tandem-repeats", "--reference") else f)
    return out


class Path:
    """One way to run the CLI: a module, extra arguments, --threads and a
    directory of its own."""

    def __init__(self, name, module, extra, threads, env_extra, seeddir):
        self.name, self.module, self.extra, self.threads = name, module, extra, threads
        self.env_extra = env_extra
        self.dir = os.path.join(seeddir, name)
        os.makedirs(self.dir)

    def run(self, args):
        env = child_env(self.env_extra)
        cmd = [sys.executable, "-m", self.module, *args, "--threads", self.threads,
               *self.extra]
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=self.dir, env=env,
                           timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"{self.name} failed (exit {p.returncode}): "
                               f"{' '.join(cmd)}\n{p.stderr[-2000:]}")

    def file(self, name):
        return os.path.join(self.dir, name)


def _interned(load):
    def load_and_intern(self):
        load(self)
        self.stack[-1] = sys.intern(self.stack[-1])
    return load_and_intern


class _InterningUnpickler(pickle._Unpickler):
    """The pure-Python unpickler, with every string it loads interned: equal
    strings come out as one object, whether the pickle wrote them once or
    each time."""
    dispatch = dict(pickle._Unpickler.dispatch)
    for _op in (pickle.UNICODE, pickle.BINUNICODE, pickle.SHORT_BINUNICODE,
                pickle.BINUNICODE8):
        dispatch[_op[0]] = _interned(dispatch[_op[0]])
    del _op


def snf_equal_but_string_identity(path, reference) -> bool:
    """Whether two SNFs that a run of the port wrote have the same contigs,
    blocks and candidate count, and blocks that differ at most in which of
    their equal strings are one object: each block, unpickled with its
    strings interned, pickles to the same bytes (values, types, dict order
    and the sharing of every other object alike)."""
    import sniffles_tpu_torch.io.snf  # noqa: F401  (the pickles' classes)
    _, header, blocks = snf_parts(path)
    _, ref_header, ref_blocks = snf_parts(reference)
    shape = {c: {b: len(spans) for b, spans in idx.items()} for c, idx in header["index"].items()}
    ref_shape = {c: {b: len(spans) for b, spans in idx.items()}
                 for c, idx in ref_header["index"].items()}
    if (shape != ref_shape or header["snf_candidate_count"] != ref_header["snf_candidate_count"]
            or set(blocks) != set(ref_blocks)):
        return False

    def canonical(data):
        return pickle.dumps(_InterningUnpickler(io.BytesIO(data)).load())

    return all([canonical(x) for x in blocks[key]] == [canonical(x) for x in ref_blocks[key]]
               for key in blocks)


def fuzz_seed(seed, against, workdir):
    """Runs one seed through every path; returns (ok, its line)."""
    seeddir = os.path.join(workdir, f"seed{seed}")
    os.makedirs(seeddir)
    data = [os.path.join(seeddir, "data", f"s{i}") for i in range(SAMPLES)]
    for d in data:
        os.makedirs(d)
    inp, _, flags, cram, phased = gen_dataset(data[0], seed)
    others = [gen_dataset(data[i], seed + 100_000 * i, cram=cram) for i in range(1, SAMPLES)]
    inputs = [os.path.relpath(p, seeddir) for p in [inp] + [o[0] for o in others]]
    phased = [phased] + [o[4] for o in others]
    mesh, threads, combine_flags = draw_run(seed)

    mesh_env = {"SNIFFLES_TPU_MESH_DEVICES": MESH_DEVICES} if mesh else {}
    paths = [Path("host", PORT, ["--no-tpu"], threads, {}, seeddir),
             Path("device", PORT, ["--tpu-mesh", "2"] if mesh else [], threads, mesh_env,
                  seeddir)]
    if against:
        paths.append(Path("against", against, [], "2", {}, seeddir))
    call_flags = relative(flags, os.path.join("..", "data", "s0"))

    def call(path):
        path.run(["--input", os.path.join("..", inputs[0]), "--vcf", "call.vcf",
                  *call_flags])

    def rest(path, base_ready):
        for i in range(SAMPLES):
            ref = (["--reference", os.path.join("..", "data", f"s{i}", "ref.fa")]
                   if cram else [])
            path.run(["--input", os.path.join("..", inputs[i]), "--snf", f"s{i}.snf",
                      "--sample-id", f"s{i}", *ref])
        path.run(["--input", *[f"s{i}.snf" for i in range(SAMPLES)], "--vcf", "combine.vcf",
                  *combine_flags])
        base_ready.wait()
        path.run(["--input", os.path.join("..", inputs[0]), "--genotype-vcf",
                  os.path.join("..", "base.vcf"), "--vcf", "genotype.vcf", *call_flags])

    base_ready = threading.Event()
    with ThreadPoolExecutor(2 * len(paths)) as pool:
        calls = {p.name: pool.submit(call, p) for p in paths}
        rests = [pool.submit(rest, p, base_ready) for p in paths]
        try:
            calls["host"].result()
            shutil.copy(paths[0].file("call.vcf"), os.path.join(seeddir, "base.vcf"))
        except (RuntimeError, subprocess.TimeoutExpired):
            pass    # read again below
        finally:
            base_ready.set()
        failed = []
        for future in [*calls.values(), *rests]:
            try:
                future.result()
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                failed.append(str(e))
    what = (f"flags={flags} combine={combine_flags} {'cram' if cram else 'bam'} "
            f"threads {threads}{' mesh 2' if mesh else ''}")
    if failed:
        return False, f"seed {seed}: RUN FAILED ({what})\n" + "\n".join(failed)

    host = paths[0]
    counts = {mode: len(vcf_records(host.file(f"{mode}.vcf")))
              for mode in ("call", "genotype", "combine")}
    diffs, by_value = [], []
    for path in paths[1:]:
        for mode in counts:
            if vcf_records(path.file(f"{mode}.vcf")) != vcf_records(host.file(f"{mode}.vcf")):
                diffs.append(f"{path.name} {mode}: records differ")
        named = dict(RUN_KEYS_THAT_DIFFER)
        if path.name == "device" and mesh:
            named.update(MESH_KEYS_THAT_DIFFER)
        if path.name == "against":
            named.update(AGAINST_KEYS_THAT_DIFFER)
        for i in range(SAMPLES):
            snf, ref = path.file(f"s{i}.snf"), host.file(f"s{i}.snf")
            found, _, _ = snf_differences(snf, ref, named)
            config_found = [x for x in found if x.startswith("config[")]
            if (path.name == "device" and cram and phased[i] and found and not config_found
                    and snf_equal_but_string_identity(snf, ref)):
                by_value.append(f"{path.name} s{i}.snf")
                continue
            diffs += [f"{path.name} s{i}.snf: {x}" for x in found]
    summary = ", ".join(f"{mode} {n}" for mode, n in counts.items())
    if diffs:
        return False, f"seed {seed}: DIFFER ({what}; {summary} records)\n  " + "\n  ".join(diffs)
    note = (f"; equal but for string identity (a phased CRAM's phase strings, ROADMAP C): "
            f"{', '.join(by_value)}" if by_value else "")
    return True, (f"seed {seed}: OK ({summary} records; "
                  f"{', '.join(p.name for p in paths)} equal{note}; {what})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=10)
    ap.add_argument("start_seed", nargs="?", type=int, default=1000)
    ap.add_argument("--against", default=None,
                    help="a second CLI module (python -m MODULE), run at --threads 2")
    ap.add_argument("--jobs", type=int, default=1, help="seeds run at once")
    args = ap.parse_args(argv)
    seeds = range(args.start_seed, args.start_seed + args.n_seeds)
    workdir = tempfile.mkdtemp(prefix="diff_fuzz_")
    failures = []
    with ThreadPoolExecutor(args.jobs) as pool:
        futures = {seed: pool.submit(fuzz_seed, seed, args.against, workdir) for seed in seeds}
        for seed, future in futures.items():
            ok, line = future.result()
            print(line, flush=True)
            if ok:
                shutil.rmtree(os.path.join(workdir, f"seed{seed}"), ignore_errors=True)
            else:
                failures.append(seed)
    if failures:
        print(f"FAILED seeds: {failures}; their files are in {workdir}")
        return 1
    shutil.rmtree(workdir, ignore_errors=True)
    print(f"all {args.n_seeds} seeds OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
