"""
Batched robust statistics over segments (device formulation of
util.center / util.trim / util.stdev, reference: util.py:25-103).

All functions take tensors sorted by (segment, value) plus the segment
ids, and return per-segment results in [num_segments]-shaped tensors.
Copied from sniffles_tpu/ops/stats.py; tests/test_torch_clustering.py
holds each against the JAX package's.
"""
from __future__ import annotations

import torch

from sniffles_tpu_torch.ops.segments import (INT32_MAX, seg_sum, seg_max, seg_min,
                                             seg_count, seg_stdev, run_starts)


def segment_start_index(seg_ids: torch.Tensor) -> torch.Tensor:
    """Index of the first element of each element's segment (seg_ids sorted)."""
    n = seg_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=seg_ids.device)
    first = torch.ones((1,), dtype=torch.bool, device=seg_ids.device)
    is_start = torch.cat([first, seg_ids[1:] != seg_ids[:-1]])
    start_idx = torch.where(is_start, idx, 0)
    return torch.cummax(start_idx, 0).values


def seg_prefix_count(flags: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Per-element inclusive count of True flags so far within the segment."""
    f = flags.to(torch.int32)
    excl = torch.cumsum(f, 0, dtype=torch.int32)
    start = segment_start_index(seg_ids).long()
    base = excl[start] - f[start]
    return excl - base


def _run_counts(values_sorted, seg_ids, valid):
    """(run starts, element count of each element's run) of equal
    (segment, value) runs among valid elements."""
    n = values_sorted.shape[0]
    starts = run_starts(seg_ids, values_sorted) & valid
    run_id = torch.clamp(torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1,
                         0, n - 1)
    run_len = seg_sum(valid.to(torch.int32), run_id, n)
    return starts, run_len[run_id.long()]


def seg_median_modes(values_sorted: torch.Tensor, seg_ids: torch.Tensor,
                     valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """
    Per-segment `util.median_modes`: restrict to distinct values whose
    count is within 2 of the max count, take the upper median of those
    values (reference: util.py:43-58). Inputs sorted by (segment, value);
    invalid elements must sort last in their segment.
    """
    seg = seg_ids.long()
    starts, count_here = _run_counts(values_sorted, seg_ids, valid)
    max_count = seg_max(torch.where(starts, count_here, 0), seg_ids, num_segments)
    kept = starts & (max_count[seg] - count_here < 3)
    kept_rank = seg_prefix_count(kept, seg_ids) - 1  # rank among kept distinct values
    n_kept = seg_sum(kept.to(torch.int32), seg_ids, num_segments)
    target = torch.div(n_kept[seg], 2, rounding_mode="floor")
    selected = kept & (kept_rank == target)
    return seg_sum(torch.where(selected, values_sorted, 0), seg_ids, num_segments)


def seg_trimmed_stdev(values_sorted: torch.Tensor, seg_ids: torch.Tensor,
                      valid: torch.Tensor, num_segments: int,
                      fused: bool = False) -> torch.Tensor:
    """
    Per-segment `util.stdev(util.trim(values))` (reference: util.py:82-88,
    sv.py:530-532): drop 25% from each end (int truncation), sample stdev
    of the rest (seg_stdev, with its `fused`).
    """
    rank = seg_prefix_count(valid, seg_ids) - 1
    cnt_here = seg_count(seg_ids, valid, num_segments)[seg_ids.long()]
    trim_n = torch.div(cnt_here * 25, 100, rounding_mode="floor")
    in_window = valid & (rank >= trim_n) & (rank < cnt_here - trim_n)
    keep = torch.where(trim_n > 0, in_window, valid)
    return seg_stdev(values_sorted, seg_ids, keep, num_segments, fused)


def seg_most_common_top(values_sorted: torch.Tensor, seg_ids: torch.Tensor,
                        valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """
    Per-segment `util.most_common_top`: the smallest value among those
    tied for the highest count (reference: util.py:91-103).
    """
    starts, count_here = _run_counts(values_sorted, seg_ids, valid)
    max_count = seg_max(torch.where(starts, count_here, 0), seg_ids, num_segments)
    is_top = starts & (count_here == max_count[seg_ids.long()])
    return seg_min(torch.where(is_top, values_sorted, INT32_MAX), seg_ids, num_segments)
