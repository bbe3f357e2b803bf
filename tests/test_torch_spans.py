"""The port's spans (sniffles_tpu_torch/spans.py) on the CPU: the fused
engine's step and its five stages as host ranges under torch.profiler,
nested and in order; nothing made outside a profiler; the step's output
the same either way."""
import pytest
import torch

from sniffles_tpu_torch import spans
from sniffles_tpu_torch.parallel.engine import call_pipeline_step
from sniffles_tpu_torch.tools.profile_engine import engine_inputs

CPU = [torch.profiler.ProfilerActivity.CPU]
FUNCTION_SCOPE = 0    # RecordScope::FUNCTION; record_function's USER_SCOPE is 7


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")


@pytest.fixture(scope="module")
def step_inputs():
    return engine_inputs(4096, "cpu")


def span_events(prof) -> list:
    named = {spans.STEP, *spans.STAGES}
    return sorted((e for e in prof.events() if e.name in named),
                  key=lambda e: e.time_range.start)


def test_step_holds_its_five_stages_once_each_in_order(step_inputs):
    with torch.profiler.profile(activities=CPU) as prof:
        call_pipeline_step(*step_inputs)
    events = span_events(prof)
    assert [e.name for e in events] == [spans.STEP, *spans.STAGES]
    step = events[0]
    for stage, nxt in zip(events[1:], events[2:] + [None]):
        assert step.time_range.start <= stage.time_range.start
        assert stage.time_range.end <= step.time_range.end
        assert nxt is None or stage.time_range.end <= nxt.time_range.start
        assert stage.cpu_parent is step
    assert all(e.scope == FUNCTION_SCOPE for e in events)


def test_span_outside_a_profiler_is_one_shared_null_context():
    assert spans.span(spans.STEP) is spans.span(spans.TAIL) is spans.span("any name")
    with spans.span(spans.STEP) as inner:
        assert inner is None


def test_no_range_is_made_outside_a_profiler(step_inputs, monkeypatch):
    made = []

    def counted(name):
        made.append(name)
        return torch._C._profiler._RecordFunctionFast(name)
    monkeypatch.setattr(spans, "_RecordFunctionFast", counted)
    call_pipeline_step(*step_inputs)
    assert made == []
    with torch.profiler.profile(activities=CPU):
        call_pipeline_step(*step_inputs)
    assert made == [spans.STEP, *spans.STAGES]


def test_step_output_is_the_same_under_the_profiler(step_inputs):
    want = call_pipeline_step(*step_inputs)
    with torch.profiler.profile(activities=CPU):
        got = call_pipeline_step(*step_inputs)
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
