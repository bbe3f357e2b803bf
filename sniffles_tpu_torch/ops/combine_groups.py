"""
Device grouping of multi-sample combine candidates: sort candidates by
(svtype, pos), segment where the combine-match criterion fails between
neighbours (or, for the mesh combine's byte-exact route, only at the
safe cuts), then per-group medians and counts. Used by the sharded
combine step (parallel/mesh.py build_sharded_combine_step); the host
greedy remains the exact grouping.

Copied from sniffles_tpu/ops/combine_groups.py (group_candidates, :26)
as torch ops on the candidates' device, with the JAX semantics kept
(ops/segments.py): lexsort as a chain of stable sorts, float32 distances
and thresholds, the float32 support mean as XLA divides it (the sum of
integer-valued terms is exact, so its order cannot matter).
"""
from __future__ import annotations

import torch

from sniffles_tpu_torch.ops.segments import (INT32_MAX, lexsort, seg_count, seg_sum,
                                             seg_sum_f32, segment_ids_from_boundaries,
                                             sqrt_f32)
from sniffles_tpu_torch.ops.stats import seg_median_modes


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def group_candidates(cand: dict, combine_match: float, combine_match_max: float,
                     safe_cut_only: bool = False) -> dict:
    """
    cand: dict of [N] tensors — pos (int32), svlen (int32), svtype
    (int32), sample_id (int32), support (int32), qc (bool), valid (bool)
    (+ optional provenance columns like orig_idx, which ride along
    through the sort).

    Returns the sorted columns plus group_id per candidate and per-group
    statistics at group slots: group_pos and group_svlen (medians,
    util.median_modes), group_count, group_pass_count,
    group_sample_count (distinct samples), group_support_mean (float32);
    n_groups is a 0-d int32 tensor.

    safe_cut_only=True segments ONLY at position gaps strictly larger
    than combine_match_max (and at svtype changes): the host greedy's
    candidate-to-group match requires pos distance + len distance <=
    combine_match_max, and a group's evolving pos_mean stays inside the
    convex hull of its members' positions, so no greedy trajectory can
    merge across such a cut (the mesh combine route runs the exact host
    greedy per segment, parallel/device_combine.py).
    """
    n = cand["pos"].shape[0]
    valid = cand["valid"]
    order = lexsort((torch.where(valid, cand["pos"], INT32_MAX),
                     torch.where(valid, cand["svtype"], INT32_MAX)))
    s = {k: v[order] for k, v in cand.items()}
    valid = s["valid"]
    svtype = s["svtype"]

    f32 = torch.float32
    pos = s["pos"].to(f32)
    svlen = s["svlen"].abs().to(f32)
    prev_pos = torch.cat([pos[:1], pos[:-1]])
    prev_len = torch.cat([svlen[:1], svlen[:-1]])
    prev_type = torch.cat([svtype[:1] - 1, svtype[:-1]])

    cap = _f32(combine_match_max, pos)
    if safe_cut_only:
        boundary = (svtype != prev_type) | ((pos - prev_pos) > cap)
    else:
        dist = (pos - prev_pos).abs() + (svlen - prev_len).abs()
        minlen = torch.clamp(torch.minimum(svlen, prev_len), min=1.0)
        thresh = torch.minimum(_f32(combine_match, pos) * sqrt_f32(minlen), cap)
        boundary = (svtype != prev_type) | (dist > thresh) | (minlen <= 0)
    boundary[:1].fill_(True)

    gid = segment_ids_from_boundaries(boundary)
    n_groups = torch.max(torch.where(valid, gid, -1)) + 1

    def by_group(value):
        """(value, group id, valid), sorted by (group, value) with the
        invalid elements last."""
        o = lexsort((torch.where(valid, value, INT32_MAX), torch.where(valid, gid, INT32_MAX)))
        return value[o], gid[o], valid[o]

    pos_median = seg_median_modes(*by_group(s["pos"]), n)
    len_median = seg_median_modes(*by_group(s["svlen"]), n)

    count = seg_count(gid, valid, n)
    pass_count = seg_sum((valid & s["qc"]).to(torch.int32), gid, n)
    support_sum = seg_sum_f32(torch.where(valid, s["support"], 0).to(f32), gid, n)
    support_mean = support_sum / torch.clamp(count, min=1).to(f32)

    # distinct samples per group: sort by (gid, sample) and count runs
    sid_s, gid_s, valid_s = by_group(s["sample_id"])
    first = torch.ones((1,), dtype=torch.bool, device=gid.device)
    run_start = torch.cat([first, (gid_s[1:] != gid_s[:-1]) | (sid_s[1:] != sid_s[:-1])])
    sample_count = seg_sum((run_start & valid_s).to(torch.int32), gid_s, n)

    out = dict(s)
    out.update({
        "group_id": gid,
        "n_groups": n_groups.to(torch.int32),
        "group_pos": pos_median.to(torch.int32),
        "group_svlen": len_median.to(torch.int32),
        "group_count": count,
        "group_pass_count": pass_count,
        "group_sample_count": sample_count,
        "group_support_mean": support_mean,
    })
    return out
