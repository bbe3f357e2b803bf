"""Host time inside the candidate tail (the span engine.tail: the split-read
support sum and ops/candidate_tail), a step, ms."""
from benchmark.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, "TAIL")
