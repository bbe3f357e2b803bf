"""
Batched exact edit distance on the card: the port of the TPU kernel
sniffles_tpu/ops/edit_distance_jax.py::edit_distance_batch_pallas.

Replaces edlib for batch workloads (reference: sv.py:287 and
snfp.py:103 gate INS merges by pairwise alt-sequence distance; combine
over thousands of blocks evaluates many pairs).

* `edit_distance_batch_device` is the kernel wrapper: on a CUDA tensor it
  launches csrc/edit_distance.cu (one block per pair, an anti-diagonal
  wavefront) or raises; on a CPU tensor it takes the plain version.
* `edit_distance_batch_plain` is the plain PyTorch version: the same
  recurrence as the JAX package's edit_distance_batch_jnp, vectorised
  over the batch,

      diag_t[i] = min(diag_{t-1}[i-1] + 1,
                      diag_{t-1}[i]   + 1,
                      diag_{t-2}[i-1] + cost(a[i-1], b[t-i-1])),

  with b read through a per-step roll of its reverse.
* `edit_distance_batch` is the dispatcher: host Myers below
  DEVICE_MIN_CELLS, the wrapper above it.

`encode_pairs` and `build_distance_cache` are copies of the JAX
package's, so both packages feed their kernels identical arrays.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from sniffles_tpu_torch.ops._greedy_consts import ED_DEVICE_MIN_CELLS

BIG = 1 << 20

# Only batches of at least this many DP cells (sum of len(a) * len(b)) go
# to the device; smaller ones run the host Myers scan. The value equals
# the JAX package's, so both packages send the same batches to the device.
DEVICE_MIN_CELLS = 2 * 10 ** 8

assert ED_DEVICE_MIN_CELLS == DEVICE_MIN_CELLS, \
    "ops/_greedy_consts.ED_DEVICE_MIN_CELLS must mirror DEVICE_MIN_CELLS"

# Launches of the CUDA kernel and the DP cells (sum of la * lb) they
# covered; the wrapper adds to them only where it launches the kernel.
COUNTS = {"launches": 0, "cells": 0}


def reset_counts() -> None:
    COUNTS["launches"] = 0
    COUNTS["cells"] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def edit_distance_batch_plain(a: torch.Tensor, b: torch.Tensor,
                              la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """a, b: [B, L] uint8 (padded); la, lb: [B] int32 with
    max(la, lb) <= L - 1. Returns [B] int32 edit distances.

    The wavefront of edit_distance_batch_jnp, written out over the batch.
    The loop stops after the last step any pair reads (max(la + lb));
    later steps leave every answer unchanged."""
    B, L = a.shape
    dev = a.device
    i32 = torch.int32
    lane = torch.arange(L + 1, dtype=i32, device=dev)[None, :]
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    big_col = torch.full((B, 1), BIG, dtype=i32, device=dev)
    m = la.to(i32)[:, None]
    n = lb.to(i32)[:, None]
    a_sh = torch.cat([zero_col, a.to(i32)], dim=1)
    b_roll = torch.flip(b.to(i32), dims=[1])

    d_prev2 = torch.where(lane == 0, 0, BIG).to(i32).expand(B, L + 1)
    d_prev1 = torch.where(lane <= 1, 1, BIG).to(i32).expand(B, L + 1)
    total = m + n
    ans = torch.where(total == 0, 0, torch.where(total == 1, 1, BIG)).to(i32)
    t_end = int(total.max()) if B else 0

    for t in range(2, min(t_end, 2 * L) + 1):
        b_roll = torch.roll(b_roll, 1, dims=1)
        bchar = torch.cat([zero_col, b_roll], dim=1)
        cost = (a_sh != bchar).to(i32)
        up = d_prev1 + 1
        left = torch.cat([big_col, d_prev1[:, :-1]], dim=1) + 1
        diagv = torch.cat([big_col, d_prev2[:, :-1]], dim=1) + cost
        d = torch.minimum(torch.minimum(up, left), diagv)
        d = torch.where(lane == 0, t, d)
        d = torch.where(lane == t, torch.clamp(d, max=t), d)
        valid = (lane <= t) & (lane <= m) & ((t - lane) <= n)
        d = torch.where(valid, d, BIG).to(i32)
        ans = torch.where(total == t, torch.gather(d, 1, m.long()), ans)
        d_prev2, d_prev1 = d_prev1, d
    return ans[:, 0]


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_inputs(a, b, la, lb) -> None:
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"a and b must be [B, L] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if la.shape != (a.shape[0],) or lb.shape != (a.shape[0],):
        raise ValueError("la and lb must be [B]")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("a and b must be uint8")
    if la.dtype != torch.int32 or lb.dtype != torch.int32:
        raise TypeError("la and lb must be int32")
    if len({a.device, b.device, la.device, lb.device}) != 1:
        raise ValueError("a, b, la and lb must lie on one device")
    if not all(x.is_contiguous() for x in (a, b, la, lb)):
        raise ValueError("a, b, la and lb must be contiguous")
    if a.shape[1] < 1:
        raise ValueError("L must be at least 1")


def edit_distance_batch_device(a: torch.Tensor, b: torch.Tensor,
                               la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Edit distances of a padded batch: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor. Shapes as edit_distance_batch_plain."""
    _check_inputs(a, b, la, lb)
    if a.device.type == "cpu":
        return edit_distance_batch_plain(a, b, la, lb)
    if a.device.type != "cuda":
        raise ValueError(f"no edit-distance kernel for device {a.device}")
    B, L = a.shape
    if B == 0:
        return torch.empty(0, dtype=torch.int32, device=a.device)
    lo, hi = (int(v) for v in torch.stack([torch.minimum(la.min(), lb.min()),
                                           torch.maximum(la.max(), lb.max())]).tolist())
    if lo < 0 or hi > L - 1:
        raise ValueError(f"lengths must lie in [0, L - 1] = [0, {L - 1}], "
                         f"got [{lo}, {hi}]")
    cells = int((la.to(torch.int64) * lb.to(torch.int64)).sum())
    from sniffles_tpu_torch.ops import _build
    lib = _build.load("edit_distance")
    fn = lib.ed_wavefront
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(B, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
                out.data_ptr(), B, L, stream)
    if rc != 0:
        raise RuntimeError(f"ed_wavefront launch failed with CUDA error {rc}")
    COUNTS["launches"] += 1
    COUNTS["cells"] += cells
    return out


# ---------------------------------------------------------------------------
# Host-side packing and dispatch (copies of the JAX package's)
# ---------------------------------------------------------------------------

def encode_pairs(pairs: list[tuple[str, str]], max_len: int | None = None):
    """Pack string pairs into padded uint8 arrays for the batch kernels."""
    if max_len is None:
        max_len = max((max(len(a), len(b)) for a, b in pairs), default=1)
        # +1: the kernels need lane index la <= L-1
        max_len = max(128, int(np.ceil((max_len + 1) / 128.0)) * 128)
    B = len(pairs)
    a = np.zeros((B, max_len), dtype=np.uint8)
    b = np.zeros((B, max_len), dtype=np.uint8)
    la = np.zeros(B, dtype=np.int32)
    lb = np.zeros(B, dtype=np.int32)
    for i, (x, y) in enumerate(pairs):
        xa = np.frombuffer(x.encode("ascii"), dtype=np.uint8)[:max_len]
        ya = np.frombuffer(y.encode("ascii"), dtype=np.uint8)[:max_len]
        a[i, :len(xa)] = xa
        b[i, :len(ya)] = ya
        la[i] = len(xa)
        lb[i] = len(ya)
    return a, b, la, lb


def build_distance_cache(group_alts: list[str], cand_alts: list[str],
                         max_len: int = 1023, device=None,
                         counters=None) -> dict[tuple[str, str], int]:
    """
    Precompute the pairwise distance matrix (group first-alt x candidate
    alt) used by the combine merge gate (reference: sv.py:280-289), in
    one batch. Pairs longer than max_len are left to the host Myers
    fallback.
    """
    ga = sorted({a for a in group_alts if a and len(a) <= max_len})
    ca = sorted({b for b in cand_alts if b and len(b) <= max_len})
    pairs = [(a, b) for a in ga for b in ca if a != b]
    if not pairs:
        return {}
    dists = edit_distance_batch(pairs, device=device, counters=counters)
    cache = {p: int(d) for p, d in zip(pairs, dists)}
    for a in ga:
        cache[(a, a)] = 0
    return cache


def _bump(counters, key, d=1):
    if counters is not None:
        counters[key] = counters.get(key, 0) + d


def edit_distance_batch(pairs: list[tuple[str, str]], max_len: int | None = None,
                        device=None, counters=None) -> np.ndarray:
    """Edit distances for a batch of string pairs.

    Dispatch: the host Myers scan (native blocked Myers when the library
    loads) handles everything below DEVICE_MIN_CELLS; a larger batch goes
    to the wavefront kernel on `device` ("cuda"), or to its plain version
    when the CPU was asked for ("cpu"). The batch dimension is padded to
    a power of two, with empty padding pairs, as in the JAX package.
    Each route is counted in `counters`."""
    cells = sum(len(x) * len(y) for x, y in pairs)
    if cells < DEVICE_MIN_CELLS:
        from sniffles_tpu_torch.ops.edit_distance import edit_distance as ed_host
        _bump(counters, "ed_host_batches")
        _bump(counters, "ed_host_pairs", len(pairs))
        return np.array([ed_host(x, y) for x, y in pairs], dtype=np.int32)
    if device is None:
        raise ValueError("a batch of at least DEVICE_MIN_CELLS cells needs a device")
    a, b, la, lb = encode_pairs(pairs, max_len)
    n = a.shape[0]
    n_pad = 16
    while n_pad < n:
        n_pad *= 2
    if n_pad > n:
        pad = ((0, n_pad - n), (0, 0))
        a = np.pad(a, pad)
        b = np.pad(b, pad)
        la = np.pad(la, (0, n_pad - n))
        lb = np.pad(lb, (0, n_pad - n))
    out = edit_distance_batch_device(*(torch.from_numpy(x).to(device)
                                       for x in (a, b, la, lb)))
    _bump(counters, "ed_device_batches")
    _bump(counters, "ed_device_pairs", n)
    _bump(counters, "ed_device_cells", cells)
    return out.cpu().numpy()[:n]
