"""
Host-vectorized multi-sample candidate grouping for the combine device
path: the streaming route, taken when the whole-task preplan does not
run (pipeline/tasks.py CombineTask._group_batch).

Design: batches are coarsely segmented at sorted-position gaps larger
than combine_match_max — cuts the host greedy provably cannot merge
across — and the exact host greedy assignment
(cluster.resolve_block_groups, reference: cluster.py:356-390) then runs
independently inside each segment. The result is identical to the host
path by construction (including tie-breaking: see the output ordering
note below), while the quadratic candidate×group scan is confined to
tiny per-segment populations.

Copied from sniffles_tpu/parallel/device_combine.py; the mesh-sharded
segmentation (--tpu-mesh) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from sniffles_tpu_torch import cluster as cl


def device_block_groups(svtype: str, svcands: list, groups_initial: list, config,
                        ed_cache=None) -> list:
    """Drop-in for cluster.resolve_block_groups (output-identical)."""
    n_cands = len(svcands)
    if n_cands == 0:
        return groups_initial

    # rows: kept frontier groups (by their evolving pos_mean) + candidates.
    # Streaming combine batches are capped at max(25, n_samples/2)
    # candidates (reference: parallel.py:489-528), so the segmentation is
    # host-vectorized.
    rows = [(g.pos_mean, 0, i) for i, g in enumerate(groups_initial)] + \
           [(c.pos, 1, i) for i, c in enumerate(svcands)]
    n = len(rows)
    gap = float(config.combine_match_max)
    pos_np = np.fromiter((p for p, _, _ in rows), dtype=np.int64, count=n)
    order = np.argsort(pos_np, kind="stable")
    p_sorted = pos_np[order]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.greater(p_sorted[1:] - p_sorted[:-1], gap, out=boundary[1:])
    seg = np.cumsum(boundary) - 1

    # bucket rows by segment, in ascending position order
    seg_keeps: dict[int, list] = {}
    seg_cands: dict[int, list] = {}
    seg_order: list[int] = []
    for k in range(n):  # first n sorted entries are the valid rows
        j = int(order[k])
        s = int(seg[k])
        if s not in seg_keeps:
            seg_keeps[s] = []
            seg_cands[s] = []
            seg_order.append(s)
        _, kind, idx = rows[j]
        if kind == 0:
            seg_keeps[s].append(idx)
        else:
            seg_cands[s].append(idx)

    return _greedy_by_segment(svtype, svcands, groups_initial, config, ed_cache,
                              seg_keeps, seg_cands, seg_order)


def _greedy_by_segment(svtype, svcands, groups_initial, config, ed_cache,
                       seg_keeps, seg_cands, seg_order):
    """Run the exact host greedy independently inside each segment of a
    greedy-impermeable partition, then reconstruct the host path's global
    output order: groups_initial in their original order first, then new
    groups by the global support-descending rank of their creating
    candidate (greedy creation order) — keeps downstream id assignment
    and tie-breaking byte-identical to the host run."""
    out_by_seg: dict[int, list] = {}
    for s in seg_order:
        keeps = [groups_initial[i] for i in sorted(seg_keeps[s])]
        cands = [svcands[i] for i in sorted(seg_cands[s])]
        out_by_seg[s] = cl.resolve_block_groups(svtype, cands, keeps, config, ed_cache)

    keep_rank = {id(g): i for i, g in enumerate(groups_initial)}
    cand_rank = {id(c): i for i, c in enumerate(
        sorted(svcands, key=lambda cand: cand.support, reverse=True))}
    out = [g for groups in out_by_seg.values() for g in groups]
    out.sort(key=lambda g: (1, cand_rank[id(g.candidates[0])])
             if id(g) not in keep_rank else (0, keep_rank[id(g)]))
    return out
