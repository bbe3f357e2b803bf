"""Host time inside the fused engine's step (its span engine.step: the whole
call, to_device included), a step, ms."""
from benchmark.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, "STEP")
