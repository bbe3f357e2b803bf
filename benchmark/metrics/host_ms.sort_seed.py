"""Host time inside the clustering's sort and seeds (the span
clustering.sort_seed: ops/clustering.sort_and_seed), a step, ms."""
from benchmark.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, "SORT_SEED")
