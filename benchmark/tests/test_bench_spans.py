"""The readers of the port's spans (metrics/_spans.py): the tiny cell's
traced run on the CPU reports each stage's host time and the step's, and
on hand-made traces the idle share inside the step and the host's syncs
read what they should, and nothing where the port records no span."""
from __future__ import annotations

import sys

import pytest

from conftest import cells, run_harness

from benchmark.harness import Trace
from benchmark.metrics import _spans
from sniffles_tpu_torch import spans

STAGE_METRICS = ("host_ms.sort_seed", "host_ms.relax", "host_ms.resplit", "host_ms.stats",
                 "host_ms.tail")


@pytest.mark.parametrize("name", cells())
def test_traced_tiny_cell_reports_the_host_time_of_each_span(tiny_root, name):
    rc, last, err = run_harness(tiny_root, "--workload", name + "-tiny", "--seed",
                                str(2**31 + 29), "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    got = {k: v["value"] for k, v in last["metrics"].items()}
    assert all(got[m] > 0 for m in ("host_ms.engine",) + STAGE_METRICS), got
    assert sum(got[m] for m in STAGE_METRICS) <= got["host_ms.engine"]
    # no device operation on the CPU: the device's readings are left out
    assert "idle_in_step_pct.engine" not in got and "host_syncs.engine" not in got


def trace(device, host, window=(0.0, 100.0), units=2) -> Trace:
    return Trace(window_s=(window[1] - window[0]) / 1e6, units=units, device_events=device,
                 host_events=host, window_us=window)


STEPS = [(spans.STEP, 10.0, 40.0), (spans.STEP, 60.0, 90.0)]


def test_idle_in_step_share_counts_the_idle_time_inside_step_ranges():
    # idle: [0, 20), [30, 70), [80, 100): 80 us; inside steps: 10 + 10 + 10 + 10
    t = trace([("k", 20.0, 30.0), ("k", 70.0, 80.0)], STEPS)
    assert _spans.idle_in_step_pct(t) == pytest.approx(50.0)
    assert _spans.idle_intervals(t) == [(0.0, 20.0), (30.0, 70.0), (80.0, 100.0)]


def test_host_syncs_counts_waiting_calls_inside_steps_a_step():
    host = STEPS + [("cudaStreamSynchronize", 15.0, 16.0), ("cudaMemcpy", 65.0, 66.0),
                    ("cudaMemcpyAsync", 20.0, 21.0), ("cudaLaunchKernel", 22.0, 23.0),
                    ("cudaDeviceSynchronize", 95.0, 96.0)]
    assert _spans.host_syncs(trace([("k", 20.0, 30.0)], host)) == 1.0
    assert _spans.host_syncs(trace([("k", 20.0, 30.0)], STEPS)) == 0.0


def test_host_ms_sums_a_span_over_the_steps():
    host = STEPS + [(spans.TAIL, 30.0, 35.0), (spans.TAIL, 80.0, 86.0)]
    t = trace([], host)
    assert _spans.host_ms(t, "STEP") == pytest.approx(0.03)
    assert _spans.host_ms(t, "TAIL") == pytest.approx(0.0055)
    assert _spans.host_ms(t, "RELAX") is None


def test_no_reading_where_the_port_records_no_span(monkeypatch):
    """A checkout whose port has no spans module (the parent of the spans)
    reads None from every reader, and nothing raises."""
    t = trace([("k", 20.0, 30.0)], STEPS + [("cudaStreamSynchronize", 15.0, 16.0)])
    monkeypatch.setitem(sys.modules, "sniffles_tpu_torch.spans", None)
    assert _spans.span_name("STEP") is None
    assert _spans.host_ms(t, "STEP") is None
    assert _spans.idle_in_step_pct(t) is None and _spans.host_syncs(t) is None
    monkeypatch.undo()
    no_step = trace([("k", 20.0, 30.0)], [("aten::add", 10.0, 40.0)])
    assert _spans.idle_in_step_pct(no_step) is None and _spans.host_syncs(no_step) is None
