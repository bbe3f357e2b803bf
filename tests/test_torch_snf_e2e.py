"""The port's --snf output of call_sample (python -m sniffles_tpu_torch)
against the JAX package's (python -m sniffles_tpu.cli), and each
package's combine of the other's SNFs.

Two SNFs are equal here in the sense of
sniffles_tpu_torch.io.snf_compare: index, candidate count and each
block's decompressed pickle bytes equal, and the header's config equal
key by key apart from the keys of SNF_CONFIG_KEYS_THAT_DIFFER. Each run
has a directory of its own and the same relative file names, so that
path-valued keys compare equal.

Each run is its own subprocess: both packages register the same
"sniffles.sv" pickle alias, and in one process the second package's
pickles would resolve to the first package's classes."""
import gzip
import json
import os
import shutil
import subprocess
import sys

import pytest

from sniffles_tpu_torch.io.snf_compare import RUN_KEYS_THAT_DIFFER, snf_differences
from sniffles_tpu_torch.sim import PlantedSV, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# config keys of the SNF header that differ between the runs compared
# here, and why: those of any two runs, and those of the two packages;
# every other key must be equal
SNF_CONFIG_KEYS_THAT_DIFFER = {
    **RUN_KEYS_THAT_DIFFER,
    "command": "the command line, sys.argv: another module path in each package",
    "device": "only the port has it: 'cuda' or 'cpu' on its device path, None on --no-tpu",
    "tpu_combine": "a device flag: the port's device path sets it with tpu_call, the JAX "
                   "package's --tpu-call does not",
    "qc_nm_threshold": "the JAX package writes a task's regional NM statistic onto the "
                       "shared config; the port keeps it on the task's lead provider",
    "average_regional_nm": "as qc_nm_threshold",
}


def run(module, args, cwd, env_extra=None):
    """One CLI run in a process of its own, on the CPU; returns its
    counters (SNIFFLES_TPU_COUNTERS_JSON) or None."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    counters = os.path.join(str(cwd), "counters.json")
    env["SNIFFLES_TPU_COUNTERS_JSON"] = counters
    env.update(env_extra or {})
    if os.path.exists(counters):
        os.unlink(counters)
    r = subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                       text=True, env=env, cwd=str(cwd), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    if not os.path.exists(counters):
        return None
    with open(counters) as f:
        return json.load(f)


def run_dir(root, label, inputs):
    """A fresh directory for one run, holding links to `inputs` under
    their own names."""
    d = root / label
    d.mkdir()
    for path in inputs:
        os.symlink(path, d / os.path.basename(path))
    return d


def assert_snfs_equal(path, reference):
    """The SNFs equal apart from SNF_CONFIG_KEYS_THAT_DIFFER; returns
    their blocks."""
    found, _, blocks = snf_differences(path, reference, SNF_CONFIG_KEYS_THAT_DIFFER)
    assert not found, found
    return blocks


def split_vcf(path, skip=("##command=", "##fileDate=")):
    header, records = [], []
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                if not line.startswith(skip):
                    header.append(line)
            else:
                records.append(line)
    return header, records


def planted(layout):
    return [PlantedSV(pos=p, svtype=t, svlen=ln, vaf=v) for p, t, ln, v in layout]


@pytest.fixture(scope="module")
def two_samples(tmp_path_factory):
    """Two BAMs of two contigs each (a task a contig, so an SNF has two
    parts to rebase), with other SVs and seeds."""
    tmp = tmp_path_factory.mktemp("snfsamples")
    out = {}
    for name, seed, layout in (
            ("a", 61, [(30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 1.0),
                       (95_000, "DUP", 900, 1.0), (125_000, "DEL", 500, 0.5)]),
            ("b", 62, [(30_000, "DEL", 120, 0.5), (60_000, "INS", 150, 1.0),
                       (110_000, "INV", 800, 1.0)])):
        d = tmp / name
        d.mkdir()
        bam, fasta = write_dataset(str(d), ref_len=150_000, depth=18, read_len=10_000,
                                   seed=seed, n_contigs=2, svs=planted(layout))
        out[name] = [bam, bam + ".bai", fasta]
    return out


# (module, extra arguments) of each call_sample run of sample a
CALL_RUNS = {
    "port-device": ("sniffles_tpu_torch", ["--threads", "0"]),
    "port-host": ("sniffles_tpu_torch", ["--threads", "0", "--no-tpu"]),
    "jax-device": ("sniffles_tpu.cli", ["--threads", "0", "--tpu-call"]),
    "jax-host": ("sniffles_tpu.cli", ["--threads", "0"]),
    "port-threads-2": ("sniffles_tpu_torch", ["--threads", "2"]),
    "jax-threads-2": ("sniffles_tpu.cli", ["--threads", "2", "--tpu-call"]),
}


@pytest.mark.parametrize("with_vcf", [True, False], ids=["snf-and-vcf", "snf-alone"])
def test_snf_output_matches_jax(with_vcf, two_samples, tmp_path):
    """--snf (alone, or with --vcf) on the device and host paths at
    --threads 0 and 2: every SNF equal to the JAX package's device run's,
    every VCF's records equal."""
    runs = CALL_RUNS if with_vcf else {k: CALL_RUNS[k] for k in ("port-device",
                                                                  "jax-device")}
    outs = {}
    for label, (module, extra) in runs.items():
        d = run_dir(tmp_path, label, two_samples["a"])
        args = ["--input", "sim.bam", "--reference", "ref.fa", "--snf", "a.snf",
                "--sample-id", "A", *extra]
        if with_vcf:
            args += ["--vcf", "a.vcf"]
        counters = run(module, args, d)
        if label.startswith("port-") and label != "port-host":
            assert counters["engine_consumed"] == counters["children_total"] > 0
        outs[label] = d
    reference = outs["jax-device"] / "a.snf"
    blocks = None
    for label, d in outs.items():
        blocks = assert_snfs_equal(d / "a.snf", reference)
    assert {contig for contig, _ in blocks} == {"chr1", "chr2"}
    if with_vcf:
        records = split_vcf(outs["jax-host"] / "a.vcf")[1]
        assert len(records) >= 6
        for label, d in outs.items():
            assert split_vcf(d / "a.vcf")[1] == records, label


def test_each_package_combines_the_others_snfs(two_samples, tmp_path):
    """Port combine of JAX SNFs == port combine of port SNFs == JAX
    combine of port SNFs == JAX combine of JAX SNFs, each on its device
    path."""
    snfs = {}
    for package, (module, extra) in (("port", ("sniffles_tpu_torch", [])),
                                     ("jax", ("sniffles_tpu.cli", ["--tpu-call"]))):
        for sample in ("a", "b"):
            d = run_dir(tmp_path, f"{package}-{sample}", two_samples[sample])
            run(module, ["--input", "sim.bam", "--snf", f"{sample}.snf", "--sample-id",
                         sample.upper(), "--threads", "0", *extra], d)
            snfs.setdefault(package, []).append(str(d / f"{sample}.snf"))
    for port_snf, jax_snf in zip(snfs["port"], snfs["jax"]):
        assert_snfs_equal(port_snf, jax_snf)

    outs = {}
    for combiner, (module, extra) in (("port", ("sniffles_tpu_torch", [])),
                                      ("jax", ("sniffles_tpu.cli", ["--tpu-combine"]))):
        for writer in ("port", "jax"):
            d = tmp_path / f"combine-{combiner}-of-{writer}"
            d.mkdir()
            for path in snfs[writer]:
                shutil.copy(path, d)
            run(module, ["--input", "a.snf", "b.snf", "--vcf", "m.vcf", "--threads", "0",
                         *extra], d)
            outs[(combiner, writer)] = split_vcf(d / "m.vcf")
    reference = outs[("jax", "jax")]
    assert len(reference[1]) >= 4
    assert all(line.rstrip("\n").split("\t")[9:11] for line in reference[1])
    for key, parts in outs.items():
        assert parts == reference, key


def write_snf(path, config, blocks, mtime):
    """An SNF of `blocks` ({(contig, block): [payload bytes]}), each
    payload a gzip member stamped with `mtime`."""
    body, index = b"", {}
    for (contig, block), payloads in blocks.items():
        for payload in payloads:
            member = gzip.compress(payload, mtime=mtime)
            index.setdefault(contig, {}).setdefault(block, []).append([len(body), len(member)])
            body += member
    header = {"config": config, "index": index, "snf_candidate_count": len(blocks)}
    with open(path, "wb") as f:
        f.write(json.dumps(header).encode() + b"\n" + body)


@pytest.mark.parametrize("change, found", [
    ("nothing", []),
    ("run key", []),
    ("other key", ["config['min_support']: 3 against 2"]),
    ("block", ["the blocks: chr1:1"]),
])
def test_snf_differences(change, found, tmp_path):
    """snf_differences ignores the gzip time stamps and the named config
    keys, and names every other difference."""
    config = {"run_id": 1, "min_support": 2}
    blocks = {("chr1", "0"): [b"a", b"b"], ("chr1", "1"): [b"c"]}
    write_snf(tmp_path / "ref.snf", config, blocks, mtime=1)
    if change == "run key":
        config = {**config, "run_id": 2}
    elif change == "other key":
        config = {**config, "min_support": 3}
    elif change == "block":
        blocks = {**blocks, ("chr1", "1"): [b"d"]}
    write_snf(tmp_path / "new.snf", config, blocks, mtime=2)
    got, differ, ref_blocks = snf_differences(tmp_path / "new.snf", tmp_path / "ref.snf",
                                              RUN_KEYS_THAT_DIFFER)
    assert got == found
    assert differ == ({"run_id"} if change == "run key" else
                      {"min_support"} if change == "other key" else set())
    assert ref_blocks[("chr1", "0")] == [b"a", b"b"]
