"""Host time inside the resplit (the span clustering.resplit:
ops/clustering._resplit and the cluster count), a step, ms."""
from benchmark.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, "RESPLIT")
