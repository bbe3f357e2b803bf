"""Calls that make the host wait for the card (stream, device and event
synchronisations, copies without Async) inside the fused engine's step
(its span engine.step), a step."""
from benchmark.metrics._spans import host_syncs


def read(trace):
    return host_syncs(trace)
