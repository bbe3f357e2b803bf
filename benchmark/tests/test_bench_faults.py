"""Each cell, at a tiny size on the CPU, run with its timed path broken
underneath: `correct` must come out false for every fault the cell can
have (a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced; no cell spans chips)."""
from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT, bench


def engine_stale(monkeypatch):
    from sniffles_tpu_torch.parallel import engine
    real, first = engine.call_pipeline_step, []

    def step(sig, coverage, params, *a, **kw):
        if not first:
            first.append(real(sig, coverage, params, *a, **kw))
        return first[0]
    monkeypatch.setattr(engine, "call_pipeline_step", step)


def engine_half(monkeypatch):
    from sniffles_tpu_torch.parallel import engine
    real = engine.call_pipeline_step

    def step(sig, coverage, params, *a, **kw):
        valid = sig["valid"].clone()
        valid[valid.shape[0] // 2:] = False
        return real(dict(sig, valid=valid), coverage, params, *a, **kw)
    monkeypatch.setattr(engine, "call_pipeline_step", step)


def engine_altered(monkeypatch):
    from sniffles_tpu_torch.parallel import engine
    real = engine.call_pipeline_step

    def step(*a, **kw):
        out = dict(real(*a, **kw))
        out["svlen"] = out["svlen"].clone()
        out["svlen"][0] += 1
        return out
    monkeypatch.setattr(engine, "call_pipeline_step", step)


FAULTS = {"engine": (engine_stale, engine_half, engine_altered)}


def _cases():
    for w in bench()["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "workloads", f"{w['name']}.json")) as f:
            driver = json.load(f)["driver"]
        for fault in FAULTS[driver]:
            yield pytest.param(w["name"], fault, id=f"{w['name']}-{fault.__name__}")


@pytest.mark.parametrize("name,fault", list(_cases()))
def test_fault_is_not_correct(tiny_root, monkeypatch, capsys, name, fault):
    from benchmark import harness
    for var in ("SNIFFLES_TPU_FORCE_CPU", "TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")
    fault(monkeypatch)
    rc = harness.main(["--workload", name + "-tiny", "--seed", "31", "--seconds", "1.5"],
                      root=tiny_root, require_card=False)
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is False, last["checks"]
