"""What the readers of the port's own spans share (sniffles_tpu_torch/
spans.py: the fused engine's step and its stages, host ranges on the
profiler's clock): the host time inside a span's ranges, the device's
idle time while the host was inside the step, and the calls inside the
step that make the host wait for the card. A checkout whose port records
no span reads None."""
from __future__ import annotations

import importlib

# the CUDA calls that make the host wait for the card, besides a copy call
# (cudaMemcpy*, cuMemcpy*) whose name lacks "Async"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpy", "cuMemcpy")


def span_name(attr: str):
    """The port's span name `attr` of sniffles_tpu_torch/spans.py (STEP,
    SORT_SEED, ...); None where the checkout's port has no such module."""
    try:
        spans = importlib.import_module("sniffles_tpu_torch.spans")
    except ImportError:
        return None
    return getattr(spans, attr, None)


def ranges(trace, attr: str) -> list:
    """(start us, end us) of the host ranges of the span `attr`."""
    name = span_name(attr)
    return [(s, e) for n, s, e in trace.host_events if n == name] if name else []


def host_ms(trace, attr: str):
    """Host ms inside the span `attr` a step; None where it has no range."""
    rs = ranges(trace, attr)
    if not rs or not trace.units:
        return None
    return sum(e - s for s, e in rs) / 1e3 / trace.units


def idle_intervals(trace) -> list:
    """(start us, end us) of the device's idle gaps in the window."""
    lo, hi = trace.window_us
    busy = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device_events
                  if e > lo and s < hi)
    gaps, end = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    return gaps


def idle_in_step_pct(trace):
    """100 x the device's idle time while the host was inside a step's
    range over all its idle time in the window; None where the trace holds
    no device operation or no step range."""
    steps = ranges(trace, "STEP")
    if not trace.device_events or not steps:
        return None
    gaps = idle_intervals(trace)
    idle = sum(g1 - g0 for g0, g1 in gaps)
    inside = sum(max(0.0, min(g1, s1) - max(g0, s0)) for g0, g1 in gaps for s0, s1 in steps)
    return 100.0 * inside / idle if idle > 0 else 0.0


def is_sync(name: str) -> bool:
    return name.startswith(SYNC_CALLS) or (name.startswith(COPY_CALLS) and "Async" not in name)


def host_syncs(trace):
    """Calls inside the steps' ranges that make the host wait for the card,
    a step; None where the trace holds no device operation or no step
    range."""
    steps = ranges(trace, "STEP")
    if not trace.device_events or not steps or not trace.units:
        return None
    n = sum(1 for name, s, _ in trace.host_events
            if is_sync(name) and any(lo <= s <= hi for lo, hi in steps))
    return n / trace.units
