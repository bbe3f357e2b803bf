"""Shared fixtures of the benchmark's CPU tests: a root that holds a tiny
variant of every cell (a cell, a traffic mix and a workload file each,
beside the checkout's own), and a runner of one harness run in a process
of its own on the CPU."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# what each generator's tiny variant changes
TINY_TRAFFIC = {"signatures": {"n_signatures": 4096, "batches": 2, "contig_len": 1_000_000}}
TINY_WORKLOAD = {"trace_steps": 4, "check": {"sample_steps": 3, "sample_below": 6}}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells() -> list:
    return [w["name"] for w in bench()["workloads"]]


def write_tiny_root(path: str) -> str:
    """A BENCHMARK.json with `<cell>-tiny` beside every cell, and their
    files, under `path`; the harness finds everything else in the
    checkout."""
    b = bench()
    os.makedirs(os.path.join(path, "benchmark", "workloads"), exist_ok=True)
    os.makedirs(os.path.join(path, "benchmark", "traffic"), exist_ok=True)
    tiny = []
    for w in b["workloads"]:
        t = dict(w, name=w["name"] + "-tiny", traffic=w["traffic"] + "-tiny")
        tiny.append(t)
        with open(os.path.join(ROOT, "benchmark", "workloads", f"{w['name']}.json")) as f:
            wl = json.load(f)
        wl.update({k: v for k, v in TINY_WORKLOAD.items() if k in wl})
        with open(os.path.join(path, "benchmark", "workloads", f"{t['name']}.json"), "w") as f:
            json.dump(wl, f)
        with open(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json")) as f:
            tr = json.load(f)
        tr.update(TINY_TRAFFIC[tr["generator"]])
        with open(os.path.join(path, "benchmark", "traffic", f"{t['traffic']}.json"), "w") as f:
            json.dump(tr, f)
    b["workloads"] += tiny
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c + "-tiny" for c in m["workloads"]]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(b, f, indent=1)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return write_tiny_root(str(tmp_path_factory.mktemp("tiny_root")))


def run_harness(root: str, *args: str, timeout: float = 600) -> tuple:
    """(exit code, the last line of stdout as JSON or None, stderr) of one
    harness run on the CPU in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from benchmark.harness import main; "
            "sys.exit(main(sys.argv[3:], root=sys.argv[2], require_card=False))")
    proc = subprocess.run([sys.executable, "-c", code, ROOT, root, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc.returncode, last, proc.stderr
