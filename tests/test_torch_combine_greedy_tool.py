"""tools/time_combine_greedy.py, the timing tool of the combine mode's
device greedy, on the CPU: its capture of the greedy dispatches, their
shapes and bounds, and the split of the combine's wall (the dry run). Each
run is its own subprocess: the port's SNF writer and the JAX package's
register the same "sniffles.sv" pickle alias, and another test file in
the same worker may have imported the JAX package."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "sniffles_tpu_torch", "tools", "time_combine_greedy.py")

# in a child: the capture on a 4-sample cohort, each kept result against
# the plain version rerun on its payload, the shapes, bounds and split
CAPTURE = r"""
import json, sys
import numpy as np
from sniffles_tpu_torch.ops import combine_greedy as tcg
from sniffles_tpu_torch.tools import time_combine_greedy as tool
workdir = sys.argv[1]
snfs = tool.build_cohort("combine256", workdir, 4, 1)
again = tool.build_cohort("combine256", workdir, 4, 1)
kept, wall = tool.run_device_combine(snfs, workdir + "/c.vcf")
same = [tcg.run_combine_greedy_task(d["payload"], d["meta"], "cpu")["assign"].tolist()
        == d["result"]["assign"].tolist() for d in kept]
rows = [tool.dispatch_row(d) for d in kept]
bounds = [tool.bound(d) for d in kept]
counts = [d["payload"]["counts"].tolist() for d in kept]
print(json.dumps({"snfs": len(snfs), "reused": again == snfs, "wall": wall, "same": same,
                  "rows": rows, "bounds": bounds, "counts": counts,
                  "split": tool.split(kept, wall)}))
"""


def child_env():
    env = dict(os.environ, SNIFFLES_TPU_FORCE_CPU="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_time_tool_captures_and_splits_a_small_cohort(tmp_path):
    """tools/time_combine_greedy.py on a 4-sample cohort on the CPU: every
    greedy dispatch of the device combine kept (payload, meta, its result
    == the plain version's on the payload), its shape and bound, the
    split of the combine's wall, and the tool's dry run end to end."""
    r = subprocess.run([sys.executable, "-c", CAPTURE, str(tmp_path)], capture_output=True,
                       text=True, env=child_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["snfs"] == 4 and got["reused"]
    assert len(got["same"]) >= 2 and all(got["same"])
    for row, b, counts in zip(got["rows"], got["bounds"], got["counts"]):
        assert row["max_count"] == max(counts) <= row["L"] <= row["Lp"]
        assert row["candidates"] == sum(counts) and row["Sp"] >= max(row["S"], 16)
        assert row["ed_width"] in (1, row["Lp"]) and row["ed_heads"] == 8
        # the live candidates' four values, the ED entries read where
        # limit > 0, counts, assign and segflags
        ed_cells = (8 * sum(min(c, row["ed_width"]) for c in counts) if row["limit_on"]
                    else 0)
        assert b["bytes"] == 4 * (4 * sum(counts) + ed_cells + row["Sp"] * row["Lp"]
                                  + 2 * row["Sp"])
        assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"]) > 0
        assert 0 <= b["probes"] <= row["candidates"] * row["max_count"]
    assert {row["limit_on"] for row in got["rows"]} == {True, False}
    parts = got["split"]
    assert parts["dispatches"] == len(got["rows"]) and 0 < parts["greedy_share"] < 1
    assert abs(parts["greedy_s"] + parts["rest_s"] - got["wall"]) < 1e-9

    out = tmp_path / "t.json"
    r = subprocess.run([sys.executable, TOOL, "--device", "cpu", "--cohorts", "combine256",
                        "--samples", "4", "--dir", str(tmp_path), "--json-out", str(out)],
                       capture_output=True, text=True, env=child_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "CPU dry run" in r.stdout
    report = json.loads(out.read_text())
    assert report["combine256"]["split"]["dispatches"] == len(got["rows"])
    assert report["combine256"]["dispatches"] == got["rows"]


def test_sim_dispatches_keep_the_payloads_as_a_capture():
    """--cohorts "group counts": sim.greedy_task_payloads' payloads of that
    label kept as captured dispatches (each result the plain version's),
    whose rows probe many groups a step."""
    r = subprocess.run([sys.executable, "-c", SIM], capture_output=True, text=True,
                       env=child_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["limits"] == [0.5, 0.0]
    for row, probes in zip(got["rows"], got["probes"]):
        assert row["S"] == 3 and row["max_count"] == 420 and row["limit_on"] in (True, False)
        assert probes > 30 * row["candidates"]


SIM = r"""
import json
from sniffles_tpu_torch.ops import combine_greedy as tcg
from sniffles_tpu_torch.tools import time_combine_greedy as tool
kept = tool.sim_dispatches(tcg, ["group counts"])
print(json.dumps({"limits": [d["meta"]["limit"] for d in kept],
                  "rows": [tool.dispatch_row(d) for d in kept],
                  "probes": [tool.bound(d)["probes"] for d in kept]}))
"""
