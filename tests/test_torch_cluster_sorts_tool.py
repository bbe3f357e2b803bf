"""tools/time_cluster_sorts.py, the timing tool of the clustering's
segmented sorts and gathers, on the CPU: its dry run end to end (every
sort case built and held, its segment-size histogram, every gather call
site of the engine's clustering and of a call task captured on the
segmented formulation and held against the plain version), and its
histogram, byte counts and capture on small inputs. The dry run is a
subprocess of its own, as a user runs the tool."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sniffles_tpu_torch.ops import cluster_sorts as cso
from sniffles_tpu_torch.tools import time_cluster_sorts as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "sniffles_tpu_torch", "tools", "time_cluster_sorts.py")

# the gather call sites of the engine's clustering and of a call task
GATHER_SITES = ("engine sort_and_seed", "engine _resplit", "fuzz sort_and_seed",
                "fuzz merge_inner_fold", "fuzz resplit_child_ids", "fuzz phase_tallies",
                "fuzz phase_tallies (2)")


def test_dry_run_builds_and_holds_every_case():
    env = dict(os.environ, SNIFFLES_TPU_FORCE_CPU="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, TOOL, "--device", "cpu", "--n", "4096"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    labels = ["engine sort and seed", "engine resplit", "chain resplit", "packed"] + [
        f"{k} a segment" for k in tool.SEGMENT_SIZES]
    for label in labels:
        line = next(ln for ln in lines if ln.startswith(f"{label}: 4096 elements"))
        assert "warp list" in line and "block list" in line, line
        bins = ["1: ", "2-8: ", "9-16: ", "17-32: ", "33-64: ", "65-256: ", "257-8192: ",
                ">8192: "]
        assert all(b in line for b in bins), line
    for site in GATHER_SITES:
        assert any(ln.startswith(f"gather {site}:") and ln.endswith("== plain")
                   for ln in lines), site


def test_histogram_counts_segments_elements_and_lists():
    seg = torch.from_numpy(np.repeat(np.arange(6), [1, 5, 9, 33, 300, 9000]))
    text = tool.histogram(seg, (8, 256, 8192))
    assert "1: 1 (1 elements)" in text
    assert "2-8: 1 (5 elements)" in text
    assert "9-16: 1 (9 elements)" in text
    assert "33-64: 1 (33 elements)" in text
    assert "257-8192: 1 (300 elements)" in text
    assert ">8192: 1 (9000 elements)" in text
    assert text.endswith("warp list 2, block list 2")
    assert tool.tiny_elements(seg, 8) == 6


def test_gather_and_sort_bytes():
    order = torch.arange(10)
    cols = {"a": torch.zeros(10, dtype=torch.int32), "b": torch.zeros(10, dtype=torch.bool),
            "c": torch.zeros(10, dtype=torch.int64), "n": torch.tensor(3)}
    assert tool.gather_bytes(order, cols) == 10 * 8 + 2 * 10 * (4 + 1 + 8)
    # the run pass reads alone through base: the base entry too
    assert tool.sort_bytes(100, 10, True, True, True) == (100 * (1 + 1 + 8) + 10 * 24, 90 * 24)
    assert tool.sort_bytes(100, 10, True, True, False) == (100 + 10 * 24, 90 * 24)
    assert tool.sort_bytes(100, 10, True, False, True) == (200 + 10 * 16, 90 * 16)
    assert tool.sort_bytes(100, 0, False, False, False) == (100, 100 * 12)


def test_captured_gathers_name_each_stage():
    """The capture on a small call task, segmented on the CPU: the five
    gathers named by their stages, each a copy that the plain version
    reproduces."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import fuzz_call_batch
    from sniffles_tpu_torch.tools.profile_call_task import call_meta
    with tool.captured_gathers(True) as kept:
        tc.call_task_packed(torch.as_tensor(fuzz_call_batch(3, 2048)), **call_meta())
    assert [s for s, _, _ in kept] == [site.split(" ", 1)[1] for site in GATHER_SITES[2:]]
    for _, order, cols in kept:
        tool.hold_gather(order, cols, "capture")
    assert tc.on_card is cso.on_card


# element sizes of a stage's columns: sort and seed's and the fold's mixes,
# more columns than a launch takes, a lone byte column, one of each size
@pytest.mark.parametrize("sizes", [[4] * 7 + [1] * 3, [4] * 17 + [1] * 2, [8] * 40, [1],
                                   [8, 4, 1]])
def test_gather_bytes_read_the_permutation_once(sizes):
    """The gather's bound: the int64 permutation read once an element, each
    column read and written once, whatever the columns a launch takes; a
    0-d entry moves nothing."""
    dtypes = {1: torch.bool, 4: torch.int32, 8: torch.int64}
    cols = {f"c{j}": torch.zeros(100, dtype=dtypes[k]) for j, k in enumerate(sizes)}
    cols["count"] = torch.tensor(7)
    assert tool.gather_bytes(torch.arange(100), cols) == 100 * (8 + 2 * sum(sizes))
