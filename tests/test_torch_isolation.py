"""The port (sniffles_tpu_torch/ and chip_smoke.py) stands alone: it imports
neither JAX nor anything of the JAX package sniffles_tpu, its combine
runs with both blocked from import, and without a card it raises unless
the CPU was asked for."""
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
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


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
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_FORCE_CPU"] = "1"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


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


def test_threads_with_device_path_is_refused(tmp_path):
    from sniffles_tpu_torch import cli
    snf = tmp_path / "a.snf"
    snf.write_text("")
    assert cli.main(["--input", str(snf), "--vcf", str(tmp_path / "o.vcf"),
                     "--threads", "4"]) == 1
    assert not (tmp_path / "o.vcf").exists()
