"""Copies between host memory and the run's device for the device
service's one-deep response pipeline (parallel/device_service.py): a
request's arrays go up from pinned memory without blocking the host, and
the results come down into pinned memory behind an event, so that the
dispatcher can launch the next request's kernels before it waits for the
previous request's results. On the CPU both are plain conversions."""
from __future__ import annotations

import numpy as np
import torch


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """`array` as a tensor on `device`; to the card from pinned memory,
    without blocking the host (on the current stream)."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def to_host_async(*tensors: torch.Tensor):
    """Starts copies of `tensors` into pinned host memory on the current
    stream and records an event after them. Returns fetch(), which waits
    for that event and returns the numpy arrays. CPU tensors are
    returned as they are."""
    if not tensors[0].is_cuda:
        return lambda: [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch():
        done.synchronize()
        return [host.numpy() for host in hosts]
    return fetch
