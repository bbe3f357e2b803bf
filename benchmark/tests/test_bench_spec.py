"""BENCHMARK.json against the rules its format sets, and the harness's
finding of every cell's files by name (a new cell, configuration and
per-layer metric are new files and entries: shown from a temporary
root)."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, bench, cells, run_harness, write_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank)$")


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert len(b["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell) fits in 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200
    assert len(json.dumps(b)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])


def test_configs_name_their_files():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"] and len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert key in conf and NAME.match(key) and not WIDTH.match(key)


def test_cells_and_metrics():
    b = bench()
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for name in cells():
        reported = [m for m in b["end_to_end"] if name in m.get("workloads", [name])]
        assert len(reported) >= 2
        assert any(name in m.get("workloads", []) for m in b["per_layer"])


@pytest.mark.parametrize("name", cells())
def test_harness_finds_every_file_of_a_cell(name):
    from benchmark.harness import load_cell, load_module
    cell = load_cell(name)
    driver = load_module(ROOT, "drivers", cell.workload["driver"])
    for fn in ("setup", "window", "traced", "release", "check"):
        assert callable(getattr(driver, fn))
    assert cell.traffic["generator"] in ("signatures",)
    for m in cell.per_layer:
        assert callable(load_module(ROOT, "metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


DUMMY_METRIC = '''"""Steps the traced window profiled (a dummy metric of the tests)."""


def read(trace):
    return float(trace.units)
'''


def test_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """A configuration, a cell and a per-layer metric added from a
    temporary root, by new files and entries alone, run through the
    harness."""
    root = str(tmp_path)
    b = bench()
    b["configs"].append(dict(b["configs"][0], name="dummy-config",
                             file="benchmark/configs/dummy-config.json"))
    b["workloads"].append({"name": "engine-dummy", "config": "dummy-config",
                           "traffic": "dummy-mix", "chips": 1, "why": "a test's cell"})
    for m in b["end_to_end"]:
        if m["name"] == "engine_signatures_per_s":
            m["workloads"].append("engine-dummy")
    b["per_layer"].append({"name": "steps.dummy", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "tests",
                           "moves": "engine_signatures_per_s", "workloads": ["engine-dummy"]})
    os.makedirs(os.path.join(root, "benchmark", "configs"))
    os.makedirs(os.path.join(root, "benchmark", "workloads"))
    os.makedirs(os.path.join(root, "benchmark", "traffic"))
    os.makedirs(os.path.join(root, "benchmark", "metrics"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    shutil.copy(os.path.join(ROOT, "benchmark", "configs", "hg002-hifi30.json"),
                os.path.join(root, "benchmark", "configs", "dummy-config.json"))
    with open(os.path.join(ROOT, "benchmark", "traffic", "chr1-sites-2m.json")) as f:
        mix = json.load(f)
    mix.update(n_signatures=2048, batches=2, contig_len=500_000)
    with open(os.path.join(root, "benchmark", "traffic", "dummy-mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "workloads", "engine-dummy.json"), "w") as f:
        json.dump({"driver": "engine", "trace_steps": 3,
                   "check": {"sample_steps": 2, "sample_below": 4}}, f)
    with open(os.path.join(root, "benchmark", "metrics", "steps.dummy.py"), "w") as f:
        f.write(DUMMY_METRIC)
    rc, last, err = run_harness(root, "--workload", "engine-dummy", "--seed", "1",
                                "--seconds", "0.5", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"] and last["metrics"]["steps.dummy"]["value"] == 3.0


def test_checkout_without_the_port_exits_without_a_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: no result, a non-zero exit."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cells()[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "correct" not in proc.stdout


def test_no_card_exits_without_a_result():
    """The sandbox has no CUDA card: no result, a non-zero exit."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cells()[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "correct" not in proc.stdout


def test_tiny_root_holds_every_cell(tmp_path):
    root = write_tiny_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        names = {w["name"] for w in json.load(f)["workloads"]}
    assert names == set(cells()) | {c + "-tiny" for c in cells()}
