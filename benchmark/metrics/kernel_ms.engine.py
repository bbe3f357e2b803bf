"""Device time of every kernel a step of the fused engine, ms (torch.profiler)."""
from benchmark.metrics._common import kernel_s, per


def read(trace):
    s = kernel_s(trace)
    return per(None if s is None else s * 1e3, trace.units)
