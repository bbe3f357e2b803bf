"""Host time inside the relaxation (the span clustering.relax:
ops/merge_relax.merge_relax), a step, ms."""
from benchmark.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, "RELAX")
