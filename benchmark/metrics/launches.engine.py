"""Kernel launches and copies that a step of the fused engine makes
(the host's CUDA launch and copy calls inside each step's range)."""
from benchmark.harness import SPAN
from benchmark.metrics._common import launches_in, per


def read(trace):
    return per(launches_in(trace, SPAN + "step"), trace.units)
