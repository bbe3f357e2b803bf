"""The share of the fused engine's steps that replayed a captured CUDA
graph, %: 100 x the step ranges (span engine.step) that hold a replay
range (span engine.replay) over all step ranges. None where the trace
holds no step range, or the checkout's port has no replay span."""
from benchmark.metrics._spans import ranges, span_name


def read(trace):
    if span_name("REPLAY") is None:
        return None
    steps, replays = ranges(trace, "STEP"), ranges(trace, "REPLAY")
    if not steps:
        return None
    held = sum(1 for s0, s1 in steps if any(s0 <= r0 and r1 <= s1 for r0, r1 in replays))
    return 100.0 * held / len(steps)
