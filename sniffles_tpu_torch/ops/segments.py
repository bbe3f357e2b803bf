"""
Segment primitives for the device clustering pipeline, on torch tensors.

The sort-and-segment formulation of clustering: sort signatures by
(svtype, pos), mark segment boundaries, and reduce per-segment
statistics with fixed-shape segment ops. All functions operate on [N]
tensors with an upper bound of N segments and produce results aligned to
segment slots (values meaningful at segment heads).

Copied from sniffles_tpu/ops/segments.py with the semantics of the JAX
primitives kept where torch's differ:
  * `jax.ops.segment_*` drops ids outside [0, num_segments) and gives an
    empty segment the identity of its reduction (0, the dtype's minimum
    for max, its maximum for min); here out-of-range ids go to a spill
    slot that is cut off, and the output starts at that identity;
  * an int32 sum stays int32 and wraps, as XLA's does (torch.sum would
    widen it to int64);
  * a float32 segment sum (seg_sum of float32 terms, as in seg_mean and
    seg_stdev) adds term by term in float32 in array order, as XLA's
    scatter-add does; torch's CPU index_add_ adds in that order, its CUDA
    one with atomics in no fixed order (the kernel of ops/call_stats.py
    sums each cluster in order instead);
  * seg_sum_f32 accumulates float32 terms in float64 and rounds once:
    the merge kernels' pick sums, whose integer-valued terms add exactly,
    so any order gives the same bits;
  * a float32 square root is the correctly rounded one (sqrt_f32), as
    XLA's and CUDA's sqrtf are;
  * where the JAX package's jitted code has a float32 multiply feeding an
    add, XLA's CPU backend contracts the two into a fused multiply-add
    (eager JAX, one op at a time, does not): `fma_f32` is that operation,
    and seg_stdev(fused=True) the jitted variance.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1
INT32_MIN = -(2 ** 31)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of float32 values. torch's CPU kernel
    for a float32 sqrt is not correctly rounded (it differs from IEEE
    sqrtf in the last place on about 0.7 % of inputs); the square root of
    a float32 value taken in float64 and rounded to float32 is, even from
    a float64 sqrt that is off by an ulp."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c on float32 values with one rounding (a fused multiply-add).
    The product is exact in float64; the sum is rounded to odd in float64
    (the TwoSum error decides the last bit), and rounding that to float32
    is the correctly rounded result."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(fix, torch.nextafter(s, toward), s).to(torch.float32)


def shift_prev(v: torch.Tensor) -> torch.Tensor:
    """concatenate([v[:1], v[:-1]]): each element's predecessor, the first
    its own."""
    return torch.cat([v[:1], v[:-1]])


def segment_ids_from_boundaries(boundary: torch.Tensor) -> torch.Tensor:
    """boundary[i]=True marks the start of a new segment; returns int32 ids."""
    return torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1


def _identity(dtype: torch.dtype, reduce: str):
    if reduce == "sum":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _segment_reduce(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                    reduce: str) -> torch.Tensor:
    ids = seg_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.full((num_segments + 1,), _identity(x.dtype, reduce),
                     dtype=x.dtype, device=x.device)
    if reduce == "sum":
        out.index_add_(0, ids, x)
    else:
        out.scatter_reduce_(0, ids, x, reduce=reduce, include_self=True)
    return out[:num_segments]


def seg_sum(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _segment_reduce(x, seg_ids, num_segments, "sum")


def seg_sum_f32(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Float32 segment sum of float32 terms, accumulated in float64 and
    rounded once (see the module note)."""
    return _segment_reduce(x.to(torch.float64), seg_ids, num_segments,
                           "sum").to(torch.float32)


def seg_max(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _segment_reduce(x, seg_ids, num_segments, "amax")


def seg_min(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _segment_reduce(x, seg_ids, num_segments, "amin")


def seg_count(seg_ids: torch.Tensor, valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    return seg_sum(valid.to(torch.int32), seg_ids, num_segments)


def _heads(seg_ids: torch.Tensor) -> torch.Tensor:
    """True at the first element of each run of equal seg_ids."""
    first = torch.ones((1,), dtype=torch.bool, device=seg_ids.device)
    return torch.cat([first, seg_ids[1:] != seg_ids[:-1]])


def rank_in_segment(seg_ids: torch.Tensor) -> torch.Tensor:
    """0-based rank of each element within its segment (requires seg_ids
    sorted ascending)."""
    n = seg_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=seg_ids.device)
    start_idx = torch.where(_heads(seg_ids), idx, 0)
    return idx - torch.cummax(start_idx, 0).values


def seg_mean(x: torch.Tensor, seg_ids: torch.Tensor, valid: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    cnt = seg_count(seg_ids, valid, num_segments)
    s = seg_sum(torch.where(valid, x, 0).to(torch.float32), seg_ids, num_segments)
    return s / torch.clamp(cnt, min=1).to(torch.float32)


def seg_stdev(x: torch.Tensor, seg_ids: torch.Tensor, valid: torch.Tensor,
              num_segments: int, fused: bool = False) -> torch.Tensor:
    """Sample standard deviation per segment (ddof=1; 0 for <2 elements),
    matching util.stdev semantics (reference: util.py:25-27).

    Values are centered on the segment minimum before the moment
    computation: genome coordinates (~1e8-1e9) squared overflow the f32
    mantissa and would destroy the variance otherwise.

    fused=True takes s2 - (cnt * mean) * mean as one fused multiply-add,
    as the JAX package's jitted steps compute it on the CPU.
    """
    shift = seg_min(torch.where(valid, x, INT32_MAX).to(torch.int32), seg_ids,
                    num_segments)
    # int32 arithmetic that wraps, as the JAX package's (x64 off)
    xc = (x.to(torch.int64) - shift[seg_ids.long()]).to(torch.int32).to(torch.float32)
    cnt = seg_count(seg_ids, valid, num_segments).to(torch.float32)
    xf = torch.where(valid, xc, 0.0)
    s1 = seg_sum(xf, seg_ids, num_segments)
    s2 = seg_sum(xf * xf, seg_ids, num_segments)
    mean = s1 / torch.clamp(cnt, min=1)
    num = fma_f32(-(cnt * mean), mean, s2) if fused else s2 - cnt * mean * mean
    var = num / torch.clamp(cnt - 1, min=1)
    var = torch.clamp(var, min=0.0)
    return torch.where(cnt >= 2, sqrt_f32(var), 0.0)


def run_starts(seg_ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """True where a run of equal (seg_id, value) starts (input sorted by
    (seg_id, value))."""
    first = torch.ones((1,), dtype=torch.bool, device=seg_ids.device)
    rest = (seg_ids[1:] != seg_ids[:-1]) | (values[1:] != values[:-1])
    return torch.cat([first, rest])


def unique_count_per_segment(seg_ids_sorted: torch.Tensor, values_sorted: torch.Tensor,
                             valid_sorted: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Number of distinct values per segment (inputs sorted by (seg, value));
    used for support = unique read names (reference: sv.py:520)."""
    starts = run_starts(seg_ids_sorted, values_sorted) & valid_sorted
    return seg_sum(starts.to(torch.int32), seg_ids_sorted, num_segments)


def lexsort(keys) -> torch.Tensor:
    """The permutation of jnp.lexsort: sorted by the LAST key first, ties
    broken by the earlier keys, stable. A chain of stable sorts, least
    significant key first; int32 keys only."""
    order = None
    for key in keys:
        k = key if order is None else key[order]
        step = torch.sort(k, stable=True).indices
        order = step if order is None else order[step]
    return order
