"""
Packing and replay glue for the device-owned combine greedy
(ops/combine_greedy): one device dispatch covers every flush of a
(combine task, svtype), and the host replays the returned assignment
through the real SVGroup objects so all downstream float statistics,
frontier closure decisions, QC and emission order are the host's own.

Why whole-block batching is exact: the host removes frontier-closed
groups from the active list between flushes, while the device keeps
every group probe-able. A closed group's pos_mean trails the current
bin by at least combine_overlap_abs (the frontier rule, reference:
parallel.py:553-557), and every later candidate lies in a strictly
later bin, so its position distance alone exceeds combine_match_max
whenever ``combine_match_max < combine_overlap_abs`` (guarded below) —
the argmin can never select a closed group, making the device's
keep-everything view equivalent. Closure itself is decided during
replay from host-exact float means.

Reference analogue: the combine hot loop, parallel.py:444-566 +
cluster.py:356-390.

Copied from sniffles_tpu/parallel/combine_device_greedy.py: the
whole-task packer and replay. The per-block packer and its replay have
no caller on the combine path and are not carried over. The device is
the run's torch device (config.device), or in a worker process the
parent's device service; the payload dicts are the JAX package's, byte
for byte.
"""
from __future__ import annotations

import numpy as np

from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.ops._greedy_consts import (CMM_MAX, SEG_LMAX, SPAN_MAX,
                                                   TASK_ED_HEADS)

# alt sequences longer than this keep pairs out of the ED table (a probe
# on such a pair raises ed_miss -> host fallback); matches the device ED
# batch economics
ED_MAX_LEN = 4095
# head-candidate radius for table completeness: a group's mean drifts
# from its head by at most ~combine_match_max * ln(group size); probes
# outside the packed radius flag ed_miss and fall back (exact, rare)
ED_RADIUS_FACTOR = 4.0


def _bump(counters, key, d=1):
    if counters is not None:
        counters[key] = counters.get(key, 0) + d


def pack_task_assignments(svtype, flushes, config, counters=None, service=None):
    """Whole-task device greedy: build ONE payload covering every flush of
    every block of a (combine task, svtype) and run the greedy on the
    run's device (config.device), or, in a worker process, post it to
    the parent's device service (`service`, a DeviceClient) as a
    combine_greedy_task request that the first replay waits for. Returns
    a replay context consumed flush-by-flush via `replay_flush_task`, or
    None when a global guard fails (caller keeps the per-flush host paths).

    Exactness: combine tasks start with an empty frontier, and
    position gaps > combine_match_max partition the candidates into
    provably interaction-free segments (any cross-segment pos distance
    alone exceeds the match cap). Each segment is rebased to local
    coordinates (int32 budget) and carries a segment id the kernel
    enforces in eligibility; per-segment soundness flags (float
    ambiguity, missing ED entry, group-size overflow) route ONLY that
    segment to the live host greedy during replay. Frontier closure
    cannot be matched again for the same reason as the per-block path
    (combine_match_max < combine_overlap_abs, guarded).

    Reference analogue: the combine hot loop across a whole task,
    parallel.py:444-566 + cluster.py:356-390.
    """
    if svtype == "BND" or getattr(config, "combine_separate_intra", False):
        return None
    cmm = int(config.combine_match_max)
    if not (0 < cmm <= CMM_MAX and cmm < int(config.combine_overlap_abs)):
        _bump(counters, "combine_greedy_guard_fallbacks")
        return None

    total = sum(len(batch) for batch, _, _ in flushes)
    if total < int(getattr(config, "dev_combine_greedy_min", 8) or 0):
        _bump(counters, "combine_greedy_small_tasks")
        return None
    device = config.device

    # trajectory order: flush-major, support-descending stable within a
    # flush (reference: cluster.py:361); flush boundaries depend only on
    # candidate counts, never on grouping, so they are precomputable
    per_flush_cands = [sorted(batch, key=lambda c: c.support, reverse=True)
                       for batch, _, _ in flushes]
    cands = [c for fc in per_flush_cands for c in fc]
    n = len(cands)
    if n == 0:
        return None

    # single attribute pass (the packer must stay O(n) with SMALL
    # constants: at population-TR scale n is ~10^5 per svtype and every
    # extra per-candidate Python pass erases the probe-loop savings)
    svlens = [c.svlen for c in cands]
    if any(v is None for v in svlens):
        _bump(counters, "combine_greedy_guard_fallbacks")
        return None
    pos = np.fromiter((c.pos for c in cands), dtype=np.int64, count=n)
    lens = np.abs(np.fromiter(svlens, dtype=np.int64, count=n))

    # safe-cut segmentation over positions (gaps > cmm)
    order = np.argsort(pos, kind="stable")
    sorted_pos = pos[order]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.greater(sorted_pos[1:] - sorted_pos[:-1], cmm, out=boundary[1:])
    seg_of_sorted = np.cumsum(boundary) - 1
    cand_seg = np.empty(n, dtype=np.int64)
    cand_seg[order] = seg_of_sorted
    n_segs = int(seg_of_sorted[-1]) + 1

    # per-segment rebasing; segments whose local span, svlen or
    # candidate count exceeds the kernel budget are host-only
    seg_base = np.full(n_segs, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(seg_base, cand_seg, pos)
    local_pos = pos - seg_base[cand_seg]
    seg_count = np.bincount(cand_seg, minlength=n_segs)
    bad = np.zeros(n_segs, dtype=bool)
    np.logical_or.at(bad, cand_seg,
                     (local_pos >= SPAN_MAX) | (lens >= SPAN_MAX))
    bad |= seg_count > SEG_LMAX
    host_segs = set(np.nonzero(bad)[0].tolist())

    # grid layout: one row per device segment, columns in trajectory
    # order within the segment — all vectorized (stable sort by segment
    # preserves trajectory order within each row)
    is_host = np.zeros(n, dtype=bool)
    if host_segs:
        is_host = np.isin(cand_seg, np.fromiter(host_segs, dtype=np.int64,
                                                count=len(host_segs)))
    dev_t = np.nonzero(~is_host)[0]
    if len(dev_t) == 0:
        _bump(counters, "combine_greedy_guard_fallbacks")
        return None
    order_dev = dev_t[np.argsort(cand_seg[dev_t], kind="stable")]
    seg_sorted = cand_seg[order_dev]
    dev_seg_ids_arr, row_sorted, counts64 = np.unique(
        seg_sorted, return_inverse=True, return_counts=True)
    dev_seg_ids = dev_seg_ids_arr.tolist()
    row_of_seg = {s: r for r, s in enumerate(dev_seg_ids)}
    S = len(dev_seg_ids)
    counts = counts64.astype(np.int32)
    starts = np.zeros(S, dtype=np.int64)
    np.cumsum(counts64[:-1], out=starts[1:])
    col_sorted = np.arange(len(order_dev)) - starts[row_sorted]
    dev_row = np.full(n, -1, dtype=np.int64)
    dev_col = np.full(n, -1, dtype=np.int64)
    dev_row[order_dev] = row_sorted
    dev_col[order_dev] = col_sorted
    L = int(counts.max())
    c_pos = np.zeros((S, L), dtype=np.int32)
    c_len = np.zeros((S, L), dtype=np.int32)
    c_alt = np.zeros((S, L), dtype=np.int32)
    c_hord = np.full((S, L), -1, dtype=np.int32)
    c_pos[row_sorted, col_sorted] = local_pos[order_dev]
    c_len[row_sorted, col_sorted] = lens[order_dev]

    limit = float(config.combine_pctseq or 0.0)
    ed_segs = ed_rows = ed_cols = ed_vals = np.zeros(0, dtype=np.int32)
    if limit > 0:
        packed = _build_task_ed_table(cands, cand_seg, row_of_seg, dev_row,
                                      dev_col, pos, lens, cmm,
                                      c_alt, c_hord, device, counters,
                                      with_table=(svtype == "INS"),
                                      grid=(row_sorted, col_sorted, order_dev),
                                      service=service)
        if packed is None:
            _bump(counters, "combine_greedy_guard_fallbacks")
            return None
        ed_segs, ed_rows, ed_cols, ed_vals, uniform = packed
        if uniform and len(ed_segs) == 0 and limit < 1.0:
            # every device segment carries exactly one distinct alt:
            # each probe is a same-string gate, which passes for any
            # limit < 1 exactly like limit == 0 — so the kernel can
            # drop the ED branch entirely. Non-uniform segments without a table entry flag
            # ed_miss at probe time and replay on the host — exact.
            limit = 0.0

    payload = {
        "c_pos": c_pos, "c_len": c_len, "c_alt": c_alt, "c_hord": c_hord,
        "counts": counts,
        "ed_segs": ed_segs, "ed_rows": ed_rows, "ed_cols": ed_cols,
        "ed_vals": ed_vals,
    }
    meta = {"cm": int(config.combine_match), "cmm": cmm, "limit": limit}
    _bump(counters, "combine_greedy_dispatches")
    _bump(counters, "combine_greedy_candidates", total)
    if host_segs:
        _bump(counters, "combine_greedy_host_segments", len(host_segs))

    ctx = {"per_flush": [], "slots": {}, "closed": set(),
           "dev_row": dev_row, "dev_col": dev_col, "cand_seg": cand_seg,
           "host_segs": host_segs, "dev_seg_ids": dev_seg_ids,
           "counters": counters, "next_fi": 0,
           "result": None, "req": None, "service": service}
    t = 0
    for fc in per_flush_cands:
        ctx["per_flush"].append([(c, t + j) for j, c in enumerate(fc)])
        t += len(fc)
    if service is not None:
        ctx["req"] = service.post("combine_greedy_task", payload, meta)
    else:
        from sniffles_tpu_torch.ops import combine_greedy
        ctx["result"] = combine_greedy.run_combine_greedy_task(payload, meta, device)
    return ctx


def _build_task_ed_table(cands, cand_seg, row_of_seg, dev_row, dev_col,
                         pos, lens, cmm, c_alt_out, c_hord_out, device,
                         counters=None, with_table=True, grid=None, service=None):
    """Alt ids, head ordinals, and (INS only) the sparse exact ED table
    for the grid kernel. Alt ids are GLOBAL (equality is only ever
    compared within a segment, so any bijection works — a global
    factorize is one vectorized pass instead of per-segment dicts).
    Heads are the first TASK_ED_HEADS distinct alts per segment (in
    trajectory order — the g-th group's head is the first candidate
    that matched none of groups 1..g-1, so heads are strongly
    prefix-biased); a probe against an untabulated head flags the
    segment for exact host replay. The per-candidate Python work runs
    ONLY over non-uniform segments (rare in identical-allele cohorts —
    the packer must stay O(n) numpy at 10^5 candidates).

    Fills c_alt_out/c_hord_out (grid coords); returns (ed_segs,
    ed_rows, ed_cols, ed_vals, uniform) where uniform means every
    device segment carries a single distinct alt, or None if
    untabulable."""
    row_sorted, col_sorted, order_dev = grid
    gid_of: dict = {}
    # alt may be a symbolic placeholder or None for non-INS types; the
    # factorize keys on the VALUE so same-string (the host's distance-0
    # shortcut) maps to equal ids exactly
    galts = np.fromiter((gid_of.setdefault(cands[t].alt, len(gid_of))
                         for t in order_dev.tolist()),
                        dtype=np.int64, count=len(order_dev))
    c_alt_out[row_sorted, col_sorted] = galts

    n_alts = len(gid_of) + 1
    pair_key = row_sorted * n_alts + galts
    distinct_rows = np.unique(pair_key) // n_alts
    S = int(row_sorted[-1]) + 1 if len(row_sorted) else 0
    per_row_distinct = np.bincount(distinct_rows, minlength=S)
    uniform = bool((per_row_distinct <= 1).all())
    z = np.zeros(0, dtype=np.int32)
    if not with_table or uniform:
        return (z, z, z, z, uniform)

    bad = np.isin(row_sorted, np.nonzero(per_row_distinct > 1)[0])
    idx = np.nonzero(bad)[0]
    heads_by_row: dict = {}   # grid row -> [(alt_id, alt string, pos, len)]
    ord_by_alt: dict = {}     # (grid row, alt_id) -> head ordinal
    for k in idx.tolist():
        r = int(row_sorted[k])
        t = int(order_dev[k])
        aid = int(galts[k])
        alt = cands[t].alt
        heads = heads_by_row.setdefault(r, [])
        if (len(heads) < TASK_ED_HEADS and isinstance(alt, str) and alt
                and len(alt) <= ED_MAX_LEN and (r, aid) not in ord_by_alt):
            ord_by_alt[(r, aid)] = len(heads)
            heads.append((aid, alt, int(pos[t]), int(lens[t])))
        hord = ord_by_alt.get((r, aid))
        if hord is not None:
            c_hord_out[r, int(col_sorted[k])] = hord

    radius = ED_RADIUS_FACTOR * cmm
    pair_keys: dict = {}
    entries = []
    for k in idx.tolist():
        r = int(row_sorted[k])
        t = int(order_dev[k])
        alt = cands[t].alt
        if not isinstance(alt, str) or not alt or len(alt) > ED_MAX_LEN:
            continue
        for hord, (h_aid, h_alt, h_pos, h_len) in enumerate(
                heads_by_row.get(r, ())):
            if h_alt == alt:
                continue
            if abs(h_pos - int(pos[t])) + abs(h_len - int(lens[t])) > radius:
                continue
            key = (h_alt, alt)
            pair_keys.setdefault(key, len(pair_keys))
            entries.append((r, hord, int(col_sorted[k]), key))

    if not pair_keys:
        return (z, z, z, z, uniform)

    pairs = list(pair_keys)
    # host Myers under DEVICE_MIN_CELLS, the bit-vector kernel above it
    # (through the device service in a worker process)
    from sniffles_tpu_torch.ops.edit_distance_batch import edit_distance_batch
    dists = edit_distance_batch(pairs, device=device, counters=counters, service=service)
    dist_of = {p: int(d) for p, d in zip(pairs, dists)}

    segs, rows, cols, vals = [], [], [], []
    for r, hord, j, key in entries:
        segs.append(r)
        rows.append(hord)
        cols.append(j)
        vals.append(dist_of[key])
    return (np.array(segs, dtype=np.int32), np.array(rows, dtype=np.int32),
            np.array(cols, dtype=np.int32), np.array(vals, dtype=np.int32),
            uniform)


def _resolve_task_ctx(ctx):
    """On first replay use, wait for the device service's result when the
    greedy was posted to it (raises when the service answered with an
    error), fold the segments the device greedy flagged into the
    host-replay set and precompute per-candidate slot keys."""
    if ctx["result"] is None:
        ctx["result"] = ctx["service"].wait(ctx["req"])
    res = ctx["result"]
    if "slot_of" not in ctx:
        flags = res["seg_flags"]
        # grid rows map back to original segment ids
        flagged = {ctx["dev_seg_ids"][r]
                   for r in np.nonzero(flags)[0].tolist()}
        if flagged:
            _bump(ctx["counters"], "combine_greedy_flagged_segments",
                  len(flagged))
        ctx["host_segs"] |= flagged
        # per-candidate slot keys precomputed in one vectorized pass
        # (-1 = host-replay candidate); the replay loop then does one
        # list index + dict lookup per candidate
        assign = res["assign"]
        dr = ctx["dev_row"]
        dc = ctx["dev_col"]
        slot = np.full(len(dr), -1, dtype=np.int64)
        m = dr >= 0
        if m.any() and assign.size:
            width = assign.shape[1] + 1
            slot[m] = dr[m] * width + assign[dr[m], dc[m]]
        if ctx["host_segs"]:
            hs = np.fromiter(ctx["host_segs"], dtype=np.int64,
                             count=len(ctx["host_segs"]))
            slot[np.isin(ctx["cand_seg"], hs)] = -1
        ctx["slot_of"] = slot.tolist()
    return res


def replay_flush_task(ctx, keep, config, ed_cache):
    """Apply the next flush's assignment through the real SVGroup
    objects. Device-clean segments consume kernel slots (slot dict:
    first sight -> from_candidate, else add_candidate); host segments
    (pre-guarded or kernel-flagged) run the live host greedy probe per
    candidate against the SAME evolving active list — exact, because
    cross-segment probes can never match (the safe-cut argument).
    Returns the evolving active list in the host greedy's order."""
    from sniffles_tpu_torch.cluster import _best_length_group
    _resolve_task_ctx(ctx)
    slot_of = ctx["slot_of"]
    fi = ctx["next_fi"]
    groups = keep
    slots = ctx["slots"]
    closed = ctx["closed"]
    from_candidate = sv.SVGroup.from_candidate
    for cand, t in ctx["per_flush"][fi]:
        slot = slot_of[t]
        if slot < 0:
            target = _best_length_group(cand, groups, config, ed_cache)
            if target is None:
                groups.append(from_candidate(cand))
            else:
                target.add_candidate(cand)
            continue
        g = slots.get(slot)
        if g is None:
            g = from_candidate(cand)
            slots[slot] = g
            groups.append(g)
        else:
            if id(g) in closed:
                raise RuntimeError(
                    "device combine greedy matched a frontier-closed group "
                    "(combine_match_max/overlap guard violated)")
            g.add_candidate(cand)
    ctx["next_fi"] = fi + 1
    return groups
