"""The engine's hand-written kernels whose bound is a function of their
shapes (metrics/_peaks.ENGINE_KERNELS): the sum of their bounds over the
sum of their device times, %."""
from benchmark.metrics._peaks import ENGINE_KERNELS, roofline_pct


def read(trace):
    return roofline_pct(trace, ENGINE_KERNELS)
