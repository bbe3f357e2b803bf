"""tools/time_call_stats.py, the timing tool of the call statistics, on the
CPU: its dry run end to end (every population built, its exact and chain
paths counted), the parts of its --split (the stat_clocks words of the
CLOCKS build as cycles a cluster by part), and the exact-path count on
small crafted clusters. The dry run is a subprocess of its own, as a user
runs the tool."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sniffles_tpu_torch.ops import call_stats as cs
from sniffles_tpu_torch.tools import time_call_stats as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "sniffles_tpu_torch", "tools", "time_call_stats.py")


def test_dry_run_builds_every_population_and_counts_its_paths():
    env = dict(os.environ, SNIFFLES_TPU_FORCE_CPU="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, TOOL, "--device", "cpu", "--n", "4096"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    labels = ["engine", "all invalid", "singletons", "chain"] + [
        f"{k} a slot" for k in tool.SLOT_SIZES]
    for label in labels:
        line = next(ln for ln in lines if ln.startswith(f"{label}: 4096 slots"))
        assert "stat_warps: " in line and "stat_blocks: " in line, line
    block = next(ln for ln in lines if ln.startswith("4096 a slot:"))
    assert "stat_blocks: 0 clusters exact, 1 on the chain" in block
    variants = next(ln for ln in lines if ln.startswith("run pass variants: "))
    for k, part in enumerate(cs.RUN_PARTS, start=1):
        assert f"-DSTAT_RUN_PARTS={k} {part}" in variants


def test_run_split_parts_from_the_variants_times():
    """The run pass with its memsets split from the variants that return
    after each launch: each part its variant's time less the one before,
    the total the last variant's; the text names each part, the masking
    and torch.searchsorted; every variant's flag is one the source reads."""
    got = tool.parts_from_times(("a", "b", "c"), (0.002, 0.005, 0.0125))
    assert got["a"] == 0.002 and abs(got["b"] - 0.003) < 1e-12
    assert abs(got["c"] - 0.0075) < 1e-12 and got["total"] == 0.0125
    got["masking"] = ("torch.where", 0.0107)
    got["searchsorted"] = 0.03
    text = tool.run_split_text(got)
    assert text.startswith("the run pass with its memsets 0.0125 ms (a 0.0020, b 0.0030, c 0.0075)")
    assert "the masking (torch.where) 0.0107 ms; torch.searchsorted 0.0300 ms" in text
    with pytest.raises(ValueError):
        tool.parts_from_times(("a", "b"), (1.0,))
    with pytest.raises(ValueError):
        cs.run_parts_define(len(cs.RUN_PARTS) + 1)
    src = open(cs.__file__.replace("ops/call_stats.py", "csrc/call_stats.cu")).read()
    assert "#ifndef STAT_RUN_PARTS" in src
    assert f"kRunParts == {len(cs.RUN_PARTS)}" in src


def test_clock_words_parse_into_cycles_a_cluster():
    """stat_clocks' words: each tier's parts, then its clusters; a block's
    chains run beside its path and are left out of it."""
    parts = cs.CLOCK_PARTS
    assert parts == ("entry", "gather", "sort", "medians", "chains", "write", "wait")
    assert cs.CLOCK_TIERS == ("stat_warps", "stat_blocks")
    warp = [10, 20, 30, 40, 50, 60, 0, 2]
    block = [100, 200, 300, 400, 5000, 600, 700, 4]
    got = tool.parse_clocks(warp + block, cs.CLOCK_TIERS, parts)
    assert got["stat_warps"]["clusters"] == 2 and got["stat_warps"]["path"] == 105
    assert got["stat_warps"]["sort"] == 15
    assert got["stat_blocks"]["path"] == (100 + 200 + 300 + 400 + 600 + 700) / 4
    assert got["stat_blocks"]["chains"] == 1250
    assert tool.parse_clocks([0] * 16, cs.CLOCK_TIERS, parts)["stat_blocks"] == {"clusters": 0}
    text = tool.split_text(got)
    assert "stat_warps: 2 clusters, 105 cycles a cluster (entry 4.8%" in text
    assert "chains beside it 1250 cycles" in text
    src = open(cs.__file__.replace("ops/call_stats.py", "csrc/call_stats.cu")).read()
    assert "enum Part { kEntry, kGather, kSort, kMedians, kChains, kWrite, kWait, kParts };" in src
    assert f"defined({cs.CLOCKS[2:]})" in src or f"#ifdef {cs.CLOCKS[2:]}" in src


def one_cluster_batch(pos, svlen, tail=0):
    """A batch whose slot 0 is one cluster of the given pos and svlen
    values (and `tail` invalid padding elements)."""
    k = len(pos)
    n = k + tail
    return {"pos": torch.tensor(list(pos) + [0] * tail, dtype=torch.int32),
            "svlen": torch.tensor(list(svlen) + [0] * tail, dtype=torch.int32),
            "cluster_id": torch.zeros(n, dtype=torch.int32),
            "valid": torch.tensor([True] * k + [False] * tail)}


def test_window_paths_at_the_exactness_limit():
    """A window's s1 on the exact path up to sum |x| = 2^24 and on the
    chain one past it; s2 likewise with sum x^2; the window is ranks [trim,
    cnt - trim) centered on its minimum, the trimmed quarters left out."""
    tiers = cs.TIERS
    cnt = 40                                  # trim 10: ranks 10..29 of 40
    limit = tool.EXACT_LIMIT
    base = 1_000_000

    def with_window(window):
        vals = [base - 5] * 10 + [base + x for x in window] + [base + 10 ** 9] * 10
        return one_cluster_batch(vals, [100] * cnt)

    # 20 terms centered on the window's minimum: 0 then 19 of d
    at = with_window([0] + [limit // 19] * 19)
    s1 = 19 * (limit // 19)
    assert s1 <= limit
    assert tool.window_paths(at, tiers)["stat_warps"][:2] == (0, 1)   # s2 is past
    small = with_window([0] + [40] * 19)     # 19 * 1600 = 30,400 squares
    assert tool.window_paths(small, tiers)["stat_warps"] == (1, 0, 0)
    # s2 at exactly 2^24: 16 terms of 1024 (1024^2 * 16 = 2^24), 3 of 0
    s2_at = with_window([0, 0, 0, 0] + [1024] * 16)
    assert tool.window_paths(s2_at, tiers)["stat_warps"] == (1, 0, 0)
    s2_past = with_window([0, 0, 0, 1] + [1024] * 16)
    assert tool.window_paths(s2_past, tiers)["stat_warps"] == (0, 1, 1)
    # the trimmed quarters do not count, however far they lie
    assert np.int64(10 ** 9) ** 2 > limit


def test_window_paths_wrap_as_int32():
    """The centering wraps as int32: a window from INT32_MIN to INT32_MAX
    has a difference of -1 after the wrap (sum |x| small), so the test
    reads the wrapped terms as the kernel does."""
    lo, hi = -2 ** 31, 2 ** 31 - 1
    vals = [lo] * 12 + [hi] * 12             # cnt 24, trim 6: ranks 6..17
    b = one_cluster_batch(vals, [7] * 24)
    e, ch, sums = tool.window_paths(b, cs.TIERS)["stat_warps"]
    # the window's minimum is INT32_MIN; INT32_MAX - INT32_MIN wraps to -1
    assert (e, ch, sums) == (1, 0, 0)
