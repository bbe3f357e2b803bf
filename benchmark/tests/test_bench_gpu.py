"""The benchmark's cells on a CUDA card, briefly: each run's result line
says `correct` (run on the card with `python -m pytest -m gpu
benchmark/tests`; skipped without a card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT, cells


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           str(2**31 + 5), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is True and last["device"]["platform"] == "gpu"
