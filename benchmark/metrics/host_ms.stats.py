"""Host time inside the call statistics (the span engine.stats:
ops/clustering.call_statistics), a step, ms."""
from benchmark.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, "STATS")
