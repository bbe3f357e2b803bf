"""
Device coverage: the difference-array accumulation of read intervals into
a per-base coverage array, replacing the host numpy `coverage[start:end]
+= 1` loop (reference: leadprov.py:451,510), and the 5-point coverage
annotation of each candidate (reference: postprocessing.py:69-130).

Copied from sniffles_tpu/ops/coverage.py as torch ops, with JAX's int32
semantics: index arithmetic wraps in int32, `//` is floor division, a
scatter-add on repeated indices accumulates every update, and an index
outside the array reads 0 (a clamped take, then masked).
"""
from __future__ import annotations

import torch

from sniffles_tpu_torch.ops.clustering import SVTYPE_BND, SVTYPE_INS


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32, as XLA's int32 arithmetic wraps."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def coverage_from_intervals(starts: torch.Tensor, ends: torch.Tensor, valid: torch.Tensor,
                            length: int) -> torch.Tensor:
    """
    Coverage over [0, length) from read intervals via the difference-array
    trick: +1 at start, -1 at end, prefix sum. O(reads + length).
    """
    starts = torch.where(valid, starts, 0).clamp(0, length).long()
    ends = torch.where(valid, ends, 0).clamp(0, length).long()
    one = valid.to(torch.int32)
    diff = torch.zeros((length + 1,), dtype=torch.int32, device=starts.device)
    diff.index_add_(0, starts, one)
    diff.index_add_(0, ends, -one)
    return torch.cumsum(diff[:length], 0, dtype=torch.int32)


def annotate_coverage(coverage: torch.Tensor, svtype: torch.Tensor, pos: torch.Tensor,
                      svlen: torch.Tensor, bnd_is_first: torch.Tensor,
                      region_offset=0, binsize: int = 100, updown_bins: int = 5) -> dict:
    """
    5-point coverage per candidate (upstream/start/center/end/downstream),
    mirroring the index arithmetic of postprocessing.coverage; indexes
    outside the array yield 0 (reference logs and leaves the default 0).
    """
    length = coverage.shape[0]
    i64 = torch.int64
    off = torch.as_tensor(region_offset, dtype=torch.int32, device=pos.device).to(i64)

    start = wrap_i32(pos.to(i64) - off).to(i64)
    start = torch.where((svtype == SVTYPE_BND) & bnd_is_first, wrap_i32(start - 1).to(i64),
                        start)
    abs_len = wrap_i32(svlen.to(i64).abs()).to(i64)
    end = torch.where(svtype == SVTYPE_INS, wrap_i32(start + 1).to(i64),
                      torch.where(svtype == SVTYPE_BND, start, wrap_i32(start + abs_len).to(i64)))

    def at(idx):
        idx = wrap_i32(idx).to(i64)
        ok = (idx >= 0) & (idx < length)
        return torch.where(ok, coverage[idx.clamp(0, length - 1)], 0).to(coverage.dtype)

    ins_or_bnd = (svtype == SVTYPE_INS) | (svtype == SVTYPE_BND)
    center = torch.div(wrap_i32(start + end).to(i64), 2, rounding_mode="floor")
    cov_start = torch.where(ins_or_bnd, at(start - binsize), at(start))
    cov_center = torch.where(ins_or_bnd, at(start), at(center))
    cov_end = torch.where(ins_or_bnd, at(end + binsize), at(end - binsize))
    cov_up = at(start - binsize * updown_bins)
    cov_down = at(end + binsize * updown_bins)

    return {"coverage_upstream": cov_up, "coverage_start": cov_start,
            "coverage_center": cov_center, "coverage_end": cov_end,
            "coverage_downstream": cov_down}
