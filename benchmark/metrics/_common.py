"""What several per-layer readers share: the device's idle share of a
traced window, its kernels' time, and the launches made inside ranges of
the benchmark's own."""
from __future__ import annotations

# the CUDA runtime and driver calls that put work on the device
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def idle_pct(trace):
    """100 x the share of the window with nothing running on the device;
    None where the trace holds no device operation."""
    if not trace.device_events or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def kernel_s(trace):
    """Seconds of device kernels in the trace; None where it holds none."""
    kernels = trace.kernels()
    return sum(e - s for _, s, e in kernels) / 1e6 if kernels else None


def launches_in(trace, span: str):
    """Launches and copies the host made inside the ranges named `span`;
    None where it made none."""
    ranges = [(s, e) for name, s, e in trace.host_events if name == span]
    n = sum(1 for name, s, _ in trace.host_events if name.startswith(LAUNCH_CALLS)
            and any(lo <= s <= hi for lo, hi in ranges))
    return n or None


def per(value, count):
    return None if value is None or not count else value / count
