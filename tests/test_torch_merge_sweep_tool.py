"""tools/time_merge_sweep.py, the timing tool of the merge sweep, on the
CPU: its dry run end to end (the fuzz cases built, their plain
partitions), and the parts of its --split (the cuts_clocks words of the
CUTS_CLOCKS build as cycles a task by part). The dry run is a subprocess
of its own, as a user runs the tool."""
import os
import subprocess
import sys

from sniffles_tpu_torch.ops import clustering as tc
from sniffles_tpu_torch.tools import time_merge_sweep as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "sniffles_tpu_torch", "tools", "time_merge_sweep.py")


def test_dry_run_builds_every_fuzz_case():
    env = dict(os.environ, SNIFFLES_TPU_FORCE_CPU="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, TOOL, "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    for label, _, _, _ in tool.FUZZ:
        line = next(ln for ln in lines if ln.strip().startswith(f"{label}: "))
        assert "plain partition iterations 0, depth 0, segments " in line, line
    # the merge-heavy fuzz batch's and the chain's seeds (PERF.md's cases)
    assert any("fuzz n=65536 seed 5: 14698 seeds" in ln for ln in lines)
    assert any("single-svtype chain n=4096: 964 seeds" in ln for ln in lines)
    assert f"split parts: {', '.join(tc.CUTS_CLOCK_PARTS)}" in r.stdout


def test_cuts_clock_words_parse_into_cycles_a_task():
    """cuts_clocks' words: each part's cycles, then the tasks; a pass's
    scans and walk divide by the passes; the source's parts are the
    wrapper's, in its order."""
    parts = tc.CUTS_CLOCK_PARTS
    assert parts == ("initial", "scans", "walk", "copy", "heads")
    got = tool.parse_cuts_clocks([200, 1200, 1800, 100, 700, 2], parts)
    assert got["tasks"] == 2 and got["scans"] == 600 and got["total"] == 2000
    assert tool.parse_cuts_clocks([0] * 6, parts) == {"tasks": 0}
    text = tool.cuts_split_text(got, 3)
    assert text.startswith("2000 cycles a task: initial 100 (5.0%), scans 600 (30.0%)")
    assert text.endswith("; a pass: scans 200, walk 300")
    assert tool.cuts_split_text({"tasks": 0}, 0) == "no task"
    src = open(tc.__file__.replace("ops/clustering.py", "csrc/merge_sweep.cu")).read()
    assert "enum CutPart { kInitial, kScans, kWalk, kCopy, kHeads, kCutParts };" in src
    assert f"#ifdef {tc.CUTS_CLOCKS[2:]}" in src
