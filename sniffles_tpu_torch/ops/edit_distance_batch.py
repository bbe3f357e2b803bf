"""
Batched exact edit distance on the card: the port of the TPU kernel
sniffles_tpu/ops/edit_distance_jax.py::edit_distance_batch_pallas.

Replaces edlib for batch workloads (reference: sv.py:287 and
snfp.py:103 gate INS merges by pairwise alt-sequence distance; combine
over thousands of blocks evaluates many pairs).

* `edit_distance_batch_device` is the kernel wrapper: on a CUDA tensor it
  launches csrc/edit_distance.cu (Myers/Hyyrö bit-vectors, one warp per
  pair) or raises; on a CPU tensor it takes the plain version.
* `edit_distance_batch_plain` is the plain PyTorch version: the same
  bit-vector recurrence (the global form of native/bamcore.cc's blocked
  Myers scan) in 32-bit words, vectorised over pairs and words with the
  kernel's one-step skew between neighbouring words.
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

M32 = 0xFFFFFFFF

# Longest string the kernel takes: at most 4 words of 32 bits on each of
# a warp's 32 lanes.
MAX_LEN = 4096


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def edit_distance_batch_plain(a: torch.Tensor, b: torch.Tensor,
                              la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """a, b: [B, L] uint8 (padded); la, lb: [B] int32 with
    max(la, lb) <= L - 1. Returns [B] int32 edit distances.

    Myers/Hyyrö bit-vectors in the global form, with a as the pattern:
    32-bit words held in int64 tensors, so a carry is a shift and a mask.
    Word g processes text column j = s - g at step s, with the carries
    word g - 1 produced for that column at step s - 1 (the kernel's skew,
    one word per lane). The pattern masks are built once per distinct byte
    value of the batch and gathered per step. At the end D(la, lb) = lb +
    popc(pv) - popc(mv) over the la pattern bits: the last column's
    vertical deltas."""
    B, L = a.shape
    dev = a.device
    i64 = torch.int64
    if B == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    m = la.to(i64)
    n = lb.to(i64)
    kw = (m + 31) // 32
    W = max(1, int(kw.max()))
    width = 32 * W

    values = torch.unique(torch.cat([a.reshape(-1), b.reshape(-1)]))
    lut = torch.zeros(256, dtype=i64, device=dev)
    lut[values.long()] = torch.arange(len(values), dtype=i64, device=dev)
    a_w = torch.zeros((B, width), dtype=torch.uint8, device=dev)
    a_w[:, :min(L, width)] = a[:, :min(L, width)]
    pos = torch.arange(width, device=dev)[None, :]
    code_a = torch.where(pos < m[:, None], lut[a_w.long()], -1).view(B, W, 32)
    weight = torch.ones(32, dtype=i64, device=dev) << torch.arange(32, device=dev)
    peq = torch.stack([((code_a == u).to(i64) * weight).sum(-1)
                       for u in range(len(values))], dim=-1)      # [B, W, U]
    code_b = lut[b.long()]

    g = torch.arange(W, device=dev)[None, :]
    zero = torch.zeros((B, 1), dtype=i64, device=dev)
    one = torch.ones((B, 1), dtype=i64, device=dev)
    pv = torch.full((B, W), M32, dtype=i64, device=dev)
    mv = torch.zeros_like(pv)
    add_c = torch.zeros_like(pv)    # carries out of each word, last step
    ph_c = torch.zeros_like(pv)
    mh_c = torch.zeros_like(pv)
    live = (m > 0) & (n > 0)
    steps = int(torch.where(live, n + kw - 1, 0).max())
    for s in range(steps):
        j = s - g
        active = (j >= 0) & (j < n[:, None]) & (g < kw[:, None])
        x = torch.gather(code_b, 1, j.clamp(0, L - 1).expand(B, W))
        eq = torch.gather(peq, 2, x.unsqueeze(-1)).squeeze(-1)
        ep = eq & pv
        total = ep + pv + torch.cat([zero, add_c[:, :-1]], dim=1)
        add_c = total >> 32
        total = total & M32
        ph = (mv | ~(total | pv | eq)) & M32
        mh = pv & ((total ^ pv) | eq)
        # word 0 shifts in ph = 1: D(0, j) = j
        ph_sh = ((ph << 1) & M32) | torch.cat([one, ph_c[:, :-1]], dim=1)
        mh_sh = ((mh << 1) & M32) | torch.cat([zero, mh_c[:, :-1]], dim=1)
        ph_c = ph >> 31
        mh_c = mh >> 31
        xv = eq | mv
        mv = torch.where(active, ph_sh & xv, mv)
        pv = torch.where(active, (mh_sh | ~(xv | ph_sh)) & M32, pv)

    bits = (m[:, None] - 32 * g).clamp(0, 32)
    keep = (torch.ones_like(bits) << bits) - 1
    delta = (_popcount32(pv & keep) - _popcount32(mv & keep)).sum(dim=1)
    return (n + delta).to(torch.int32)


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
    the plain version on a CPU tensor. Shapes as edit_distance_batch_plain;
    on the card the lengths must also be at most MAX_LEN. The kernel takes
    the pairs in descending order of la * lb, so the long pairs start
    first."""
    _check_inputs(a, b, la, lb)
    if a.device.type == "cpu":
        return edit_distance_batch_plain(a, b, la, lb)
    if a.device.type != "cuda":
        raise ValueError(f"no edit-distance kernel for device {a.device}")
    B, L = a.shape
    if B == 0:
        return torch.empty(0, dtype=torch.int32, device=a.device)
    work = la.to(torch.int64) * lb.to(torch.int64)
    order = torch.argsort(work, descending=True).to(torch.int32)
    lo, hi, cells = torch.stack([torch.minimum(la.min(), lb.min()).to(torch.int64),
                                 torch.maximum(la.max(), lb.max()).to(torch.int64),
                                 work.sum()]).tolist()
    top = min(L - 1, MAX_LEN)
    if lo < 0 or hi > top:
        raise ValueError(f"lengths must lie in [0, {top}], got [{lo}, {hi}]")
    out = launch_myers(a, b, la, lb, order)
    COUNTS["launches"] += 1
    COUNTS["cells"] += cells
    return out


def launch_myers(a, b, la, lb, order) -> torch.Tensor:
    """One launch of the kernel's entry point ed_myers on CUDA inputs that
    edit_distance_batch_device has checked; `order` is an int32 [B]
    permutation, the order the warps take the pairs in. Counts nothing;
    raises when the launch fails."""
    B, L = a.shape
    from sniffles_tpu_torch.ops import _build
    fn = _build.load("edit_distance").ed_myers
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(B, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
                order.data_ptr(), out.data_ptr(),
                B, L, stream)
    if rc != 0:
        raise RuntimeError(f"ed_myers launch failed with CUDA error {rc}")
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
    to the bit-vector kernel on `device` ("cuda"), or to its plain version
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
