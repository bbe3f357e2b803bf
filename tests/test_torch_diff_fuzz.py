"""The port's differential fuzz (sniffles_tpu_torch/tools/diff_fuzz.py): its
layouts are tools/diff_fuzz.py's for the same seed, and two seeds through
the port's device path, its host path and the JAX package's CLI
(--against sniffles_tpu.cli, at --threads 2) are equal in every VCF and
SNF. Seed 1000 is a CRAM at --tpu-mesh 2 with --mosaic --qc-nm
--dev-no-resplit, 1001 a BAM with the default flags."""
import dataclasses
import gzip
import importlib.util
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from sniffles_tpu_torch.tools import diff_fuzz as port_fuzz  # noqa: E402

# the flags the port's fuzz draws beyond tools/diff_fuzz.py's, with the
# number of values each takes
ADDED_FLAGS = {"--qc-nm": 0, "--minsupport": 1, "--detect-large-ins": 1,
               "--dev-no-resplit": 0, "--cluster-binsize": 1}


def load_jax_fuzz():
    path = os.path.join(REPO, "tools", "diff_fuzz.py")
    spec = importlib.util.spec_from_file_location("jax_diff_fuzz", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def without_added(flags):
    out, skip = [], 0
    for f in flags:
        if skip:
            skip -= 1
        elif f in ADDED_FLAGS:
            skip = ADDED_FLAGS[f]
        else:
            out.append(os.path.basename(f))
    return out


@pytest.mark.parametrize("seed", [1000, 1001, 1002, 1009])
def test_layouts_equal_tools_diff_fuzz(seed, tmp_path, monkeypatch):
    """gen_dataset draws tools/diff_fuzz.py's layout, dataset arguments and
    flags for the same seed (a BAM: the CRAM draw is the port's own)."""
    import sniffles_tpu.sim as jax_sim
    import sniffles_tpu_torch.sim as port_sim
    seen = {}

    def capture(name):
        def write_dataset(tmpdir, **kw):
            kw["svs"] = [dataclasses.asdict(sv) for sv in kw["svs"]]
            kw.pop("nm_rates", None)
            seen[name] = kw
            return os.path.join(tmpdir, "sim.bam"), os.path.join(tmpdir, "ref.fa")
        return write_dataset

    monkeypatch.setattr(jax_sim, "write_dataset", capture("jax"))
    monkeypatch.setattr(port_sim, "write_dataset", capture("port"))
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    _, jax_flags = load_jax_fuzz().gen_dataset(str(tmp_path / "j"), seed)
    _, _, port_flags, cram, _ = port_fuzz.gen_dataset(str(tmp_path / "p"), seed, cram=False)
    assert not cram and seen["port"] == seen["jax"] and len(seen["port"]["svs"]) >= 20
    assert without_added(port_flags) == [os.path.basename(f) for f in jax_flags]


def test_two_seeds_equal_against_the_jax_package():
    """Two seeds, three modes (call, force call, combine of three SNFs),
    three paths: every comparison equal."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(SNIFFLES_TPU_FORCE_CPU="1", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "sniffles_tpu_torch.tools.diff_fuzz", "2", "1000",
                        "--against", "sniffles_tpu.cli", "--jobs", "2"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-5000:] + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "all 2 seeds OK"
    for seed, line in zip((1000, 1001), lines):
        assert line.startswith(f"seed {seed}: OK (") and "host, device, against equal" in line
    assert "cram threads 2 mesh 2" in lines[0] and "bam threads 0" in lines[1]


def test_a_difference_fails_the_seed(tmp_path, monkeypatch):
    """A path whose records differ from the host path's fails its seed, and
    main exits non-zero: a stand-in CLI module that writes the host
    path's VCFs with one record dropped."""
    fake = tmp_path / "fakecli.py"
    fake.write_text("""
import os, subprocess, sys
args = sys.argv[1:]
r = subprocess.run([sys.executable, "-m", "sniffles_tpu_torch", *args, "--no-tpu"])
if r.returncode == 0 and "--vcf" in args:
    path = args[args.index("--vcf") + 1]
    lines = open(path).readlines()
    body = [i for i, line in enumerate(lines) if not line.startswith("#")]
    if body:
        del lines[body[-1]]
    open(path, "w").writelines(lines)
sys.exit(r.returncode)
""")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ok, line = port_fuzz.fuzz_seed(1001, "fakecli", str(tmp_path))
    assert not ok and line.startswith("seed 1001: DIFFER")
    assert "against call: records differ" in line and "against combine: records differ" in line
    monkeypatch.setattr(port_fuzz, "fuzz_seed", lambda *args: (ok, line))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))    # main keeps its directory
    assert port_fuzz.main(["1", "1001", "--against", "fakecli"]) == 1


def rewrite_blocks(path, change, out_path):
    """Writes the SNF at `path` to `out_path` with each block's pickle bytes
    replaced by change(bytes), the index following the new lengths."""
    with open(path, "rb") as f:
        header = json.loads(f.readline())
        body = f.read()
    out = bytearray()
    for index in header["index"].values():
        for block, spans in index.items():
            new = []
            for offset, length in spans:
                member = gzip.compress(change(gzip.decompress(body[offset:offset + length])))
                new.append([len(out), len(member)])
                out += member
            index[block] = new
    with open(out_path, "wb") as f:
        f.write(json.dumps(header).encode() + b"\n" + bytes(out))


def share_strings(data):
    """A block's pickle with every run of equal strings made one object."""
    return pickle.dumps(port_fuzz._InterningUnpickler(io.BytesIO(data)).load())


def reverse_dict_order(data):
    import sniffles_tpu_torch.io.snf  # noqa: F401
    block = pickle.loads(data)
    return pickle.dumps(dict(reversed(list(block.items()))))


def test_phase_strings_pickle_alike_in_both_packages(tmp_path):
    """The fuzz's one exception (ROADMAP C, "Phase strings pickled by
    reference"), on seed 1004's first sample (a phased CRAM): the device
    path's SNF differs from the host path's in its bytes and in nothing
    but string identity, in both packages alike; each path writes the
    other package's bytes. A change of value, or of a block's dict order,
    is not passed. Each run is a process of its own, at --threads 0."""
    from sniffles_tpu_torch.io.snf_compare import snf_parts
    data = tmp_path / "data"
    data.mkdir()
    cram, _, _, is_cram, phased = port_fuzz.gen_dataset(str(data), 1004)
    assert is_cram and phased
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(SNIFFLES_TPU_FORCE_CPU="1", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    runs = {"port device": ("sniffles_tpu_torch", []),
            "port host": ("sniffles_tpu_torch", ["--no-tpu"]),
            "jax device": ("sniffles_tpu.cli", ["--tpu-call"]),
            "jax host": ("sniffles_tpu.cli", []),
            "port host, other flags": ("sniffles_tpu_torch", ["--no-tpu", "--minsvlen", "400"])}
    blocks = {}
    for name, (module, extra) in runs.items():
        snf = str(tmp_path / f"{name.replace(' ', '_').replace(',', '')}.snf")
        r = subprocess.run([sys.executable, "-m", module, "--input", cram, "--snf", snf,
                            "--sample-id", "s0", "--reference", str(data / "ref.fa"),
                            "--threads", "0", *extra],
                           capture_output=True, text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        blocks[name] = (snf, snf_parts(snf)[2])
    assert blocks["port device"][1] == blocks["jax device"][1]
    assert blocks["port host"][1] == blocks["jax host"][1]
    assert blocks["port device"][1] != blocks["port host"][1]
    same = port_fuzz.snf_equal_but_string_identity
    assert same(blocks["port device"][0], blocks["port host"][0])
    assert not same(blocks["port host, other flags"][0], blocks["port host"][0])
    reordered = str(tmp_path / "reordered.snf")
    rewrite_blocks(blocks["port device"][0], reverse_dict_order, reordered)
    assert snf_parts(reordered)[2] != blocks["port device"][1]
    assert not same(reordered, blocks["port host"][0])


def test_string_identity_outside_a_phased_cram_fails_the_seed(tmp_path, monkeypatch):
    """Seed 1006, a CRAM whose three samples are unphased: a device path
    whose SNFs differ from the host path's only in string identity (each
    block pickled again with its equal strings shared) fails the seed, and
    the exception is not named on its line."""
    orig = port_fuzz.Path.run
    shared = []

    def run(self, args):
        orig(self, args)
        if self.name == "device" and "--snf" in args:
            snf = self.file(args[args.index("--snf") + 1])
            rewrite_blocks(snf, share_strings, snf)
            shared.append(snf)

    monkeypatch.setattr(port_fuzz.Path, "run", run)
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ok, line = port_fuzz.fuzz_seed(1006, None, str(tmp_path))
    assert len(shared) == port_fuzz.SAMPLES
    assert not ok and line.startswith("seed 1006: DIFFER") and "cram" in line, line
    assert "device s0.snf: the blocks" in line and "string identity" not in line, line
    host = os.path.join(tmp_path, "seed1006", "host", "s0.snf")
    assert port_fuzz.snf_equal_but_string_identity(shared[0], host)
