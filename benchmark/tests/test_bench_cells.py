"""Every cell at a tiny size on the CPU (SNIFFLES_TPU_FORCE_CPU): its
result line has the benchmark's keys in their order, the port agrees with
the plain reference, the control comes out not correct, and nothing the
run loads is JAX or the JAX package."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT, bench, cells, run_harness

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_cell_runs_and_agrees_with_the_reference(tiny_root, name, trace):
    rc, last, err = run_harness(tiny_root, "--workload", name + "-tiny", "--seed",
                                str(2**31 + 11), "--seconds", "1", "--trace", str(trace))
    assert rc == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    assert DEVICE_KEYS <= set(last["device"])
    for check in last["checks"].values():
        assert check["value"] <= check["limit"]
    assert err.rstrip().splitlines()[-1].startswith("check ")
    b = bench()
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        listed = {m["name"] for m in b["per_layer"] if name in m.get("workloads", [])}
        assert set(last["metrics"]) <= listed     # the device's metrics: not on the CPU
    else:
        listed = {m["name"] for m in b["end_to_end"] if name in m.get("workloads", [name])}
        assert set(last["metrics"]) == listed
        assert all(v["value"] > 0 for v in last["metrics"].values())


@pytest.mark.parametrize("form", ["full", "tail"])
@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(tiny_root, name, form):
    rc, last, err = run_harness(tiny_root, "--workload", name + "-tiny", "--seed", "23",
                                "--seconds", "1", "--trace", "0", "--control", form)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False
    assert any(c["value"] > c["limit"] for c in last["checks"].values())


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, every driver and reader, the traffic generators and
    the plain reference, imported in one process: no module of the
    top-level names jax, jaxlib, flax or sniffles_tpu (whole names:
    sniffles_tpu_torch is the port)."""
    code = """
import glob, os, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
from benchmark.reference import engine
from benchmark.traffic import generate, signatures
for kind in ("drivers", "metrics"):
    for path in glob.glob(os.path.join(sys.argv[1], "benchmark", kind, "*.py")):
        harness.load_module(sys.argv[1], kind, os.path.basename(path)[:-3])
print(" ".join(harness.banned_modules()))
"""
    proc = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""


def test_a_loaded_jax_ends_the_run(tiny_root, monkeypatch):
    """A run whose process holds a module named jax prints no result."""
    import types
    from benchmark import harness
    for var in ("SNIFFLES_TPU_FORCE_CPU", "TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.banned_modules() == ["jax"]
    rc = harness.main(["--workload", cells()[0] + "-tiny", "--seed", "3", "--seconds", "0.2"],
                      root=tiny_root, require_card=False)
    assert rc == harness.EXIT_BANNED
