"""
Device-owned multi-sample combine grouping: an EXACT emulation of the
host's sequential greedy assignment (cluster.resolve_block_groups,
reference: cluster.py:356-390), in PyTorch on the run's device. The
port of sniffles_tpu/ops/combine_greedy.py::_greedy_grid_loop and its
dispatch (start_combine_greedy_task / run_combine_greedy_task).

The host greedy walks candidates in support-descending order; each
candidate joins the best existing group by
``dist = |pos_mean - pos| + |len_mean - |svlen||`` subject to
``dist <= combine_match * sqrt(min(len_mean, |svlen|))``, capped at
``combine_match_max``, a sequence-identity gate (edit distance of the
candidate alt against the GROUP HEAD's alt, sv.py:280-301), and strict
improvement (ties keep the earliest group in list order). Group means
evolve as candidates join (sv.py:303-313).

* Group state is kept as INTEGER sums (pos_sum, len_sum, n) in
  segment-local coordinates, so distances are exact rationals D/n.
* Cross-group comparisons use an int32-exact total-order key:
  ``key = (D//n) * 2^20 + ((D%n) * 2^20) // n``. Two distinct rational
  distances with denominators <= NMAX=1024 differ by >= 2^-20, so the
  floor-scaled fraction separates them; equal rationals map to equal
  keys; argmin's first-minimum tie-break is exactly the host's
  earliest-group-wins rule.
* The sqrt threshold and the identity-ratio gate are evaluated in
  float32 where the host uses float64; probes within a ~1e-5 relative
  window of either threshold raise the segment's `ambiguous` flag and
  the caller replays that segment on the exact host greedy. All float
  constants are float32 tensors, as JAX's weak types make them.
* The identity gate reads a PRECOMPUTED exact edit-distance table; a
  probe whose pair is missing raises the `ed_miss` flag.

The loop runs one step per candidate of the longest segment (a Python
loop of tensor ops; the bound is read to the host once, before it). A
hand-written kernel with one block per segment is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from sniffles_tpu_torch.ops._greedy_consts import (EPS, NMAX, SCALE, SEGF_AMBIGUOUS,
                                                   SEGF_ED_MISS, SEGF_N_OVERFLOW,
                                                   TASK_ED_HEADS)

INT32_MAX = 2 ** 31 - 1


def _pow2(x: int, floor: int) -> int:
    size = floor
    while size < x:
        size *= 2
    return size


def _greedy_grid_loop(c_pos, c_len, c_alt, c_hord, counts, ed,
                      *, cm: int, cmm: int, limit: float):
    """Whole-task greedy as a SEGMENT-GRID lockstep loop.

    Combine tasks start with an empty frontier, and position gaps >
    combine_match_max split candidates into provably interaction-free
    segments (any cross-segment pos distance alone exceeds the match
    cap), so every segment's sequential trajectory is independent. The
    grid runs them all at once: row s is segment s, loop step i
    processes each segment's i-th candidate (its trajectory order = the
    host's flush-major support-descending order restricted to the
    segment).

    Inputs are int32 tensors on one device: (S, L) grids c_pos
    (segment-rebased local coordinates), c_len (|svlen|), c_alt
    (segment-local alt ids), c_hord (the candidate alt's row in the
    segment's potential-head ED table, -1 when not tabulated), counts
    (S,) per-segment candidate counts, and ed (S, K, W) exact edit
    distances (head table row x candidate, -1 = missing; W = L, or 1 for
    an all-missing table, whose one column every step reads).

    Returns (assign (S, L) segment-local slot ids, segflags (S,) SEGF_*
    bitmasks).
    """
    S, L = c_pos.shape
    W = ed.shape[2]
    dev = c_pos.device
    i32, f32 = torch.int32, torch.float32
    slots = torch.arange(L, dtype=i32, device=dev)[None, :]
    cm_f = torch.tensor(cm, dtype=f32, device=dev)
    cmm_f = torch.tensor(cmm, dtype=f32, device=dev)
    limit_f = torch.tensor(limit, dtype=f32, device=dev)
    eps_f = torch.tensor(EPS, dtype=f32, device=dev)
    one_f = torch.tensor(1.0, dtype=f32, device=dev)
    zero_f = torch.tensor(0.0, dtype=f32, device=dev)
    tiny_f = torch.tensor(1e-9, dtype=f32, device=dev)
    # the Python double 1 + 2 EPS rounded once to float32, as JAX does
    forced_at = cmm_f * torch.tensor(1.0 + 2.0 * EPS, dtype=f32, device=dev)
    pass_same = bool(limit < 1.0)
    big = torch.tensor(INT32_MAX, dtype=i32, device=dev)

    ngroups = torch.zeros((S,), dtype=i32, device=dev)
    psum = torch.zeros((S, L), dtype=i32, device=dev)
    lsum = torch.zeros((S, L), dtype=i32, device=dev)
    n = torch.zeros((S, L), dtype=i32, device=dev)
    head = torch.zeros((S, L), dtype=i32, device=dev)
    hord = torch.full((S, L), -1, dtype=i32, device=dev)
    assign = torch.full((S, L), -1, dtype=i32, device=dev)
    segflags = torch.zeros((S,), dtype=i32, device=dev)

    max_count = int(counts.max()) if S else 0   # the one host read
    for i in range(max_count):
        upd = i < counts                                     # (S,)
        pos = c_pos[:, i:i + 1]                              # (S, 1)
        ln = c_len[:, i:i + 1]
        aid = c_alt[:, i:i + 1]
        active = (slots < ngroups[:, None]) & (n > 0)

        D = (psum - pos * n).abs() + (lsum - ln * n).abs()
        nf = torch.clamp(n, min=1).to(f32)
        cap_ok = D <= n * cmm
        shorter_pos = (lsum > 0) & (ln > 0)

        lmf = lsum.to(f32) / nf
        shorter_f = torch.minimum(lmf, ln.to(f32))
        thr_f = cm_f * torch.sqrt(torch.maximum(shorter_f, zero_f))
        dist_f = D.to(f32) / nf
        forced = thr_f >= forced_at
        pass2 = (dist_f <= thr_f) | forced
        amb2 = ((dist_f - thr_f).abs()
                <= eps_f * torch.maximum(thr_f, one_f)) & ~forced

        pre = active & cap_ok & shorter_pos
        if limit > 0:
            same = head == aid
            # a width-1 table is read at column 0 by every step (JAX's
            # dynamic slice clamps the index the same way)
            ed_i = ed[:, :, min(i, W - 1)]                   # (S, K)
            d_ed = torch.where(hord >= 0,
                               torch.gather(ed_i, 1, torch.clamp(hord, min=0).long()),
                               torch.full_like(hord, -1))
            have = d_ed >= 0
            ratio = (lmf - d_ed.to(f32)) / torch.maximum(lmf, tiny_f)
            pass3 = torch.where(same, pass_same, have & (ratio > limit_f))
            amb3 = ~same & have & ((ratio - limit_f).abs() <= eps_f)
            miss = ~same & ~have
            miss_hit = (pre & pass2 & miss).any(dim=1)       # (S,)
        else:
            pass3 = torch.ones((S, L), dtype=torch.bool, device=dev)
            amb3 = torch.zeros((S, L), dtype=torch.bool, device=dev)
            miss_hit = torch.zeros((S,), dtype=torch.bool, device=dev)

        eligible = pre & pass2 & pass3
        amb_hit = (pre & (amb2 | amb3)).any(dim=1)           # (S,)

        nd = torch.clamp(n, min=1)
        q = torch.div(D, nd, rounding_mode="floor")
        r = D - q * nd
        key = q * SCALE + torch.div(r * SCALE, nd, rounding_mode="floor")
        key = torch.where(eligible, key, big)
        best = torch.argmin(key, dim=1).to(i32)              # first minimum
        found = key.min(dim=1).values < INT32_MAX

        tgt = torch.where(found, best, ngroups)              # (S,)
        onehot = (slots == tgt[:, None]) & upd[:, None]      # (S, L)
        tgt_n = torch.where(onehot, n, 0).max(dim=1).values
        over = (tgt_n + 1 > NMAX) & upd
        bits = ((amb_hit & upd).to(i32) * SEGF_AMBIGUOUS
                + (miss_hit & upd).to(i32) * SEGF_ED_MISS
                + over.to(i32) * SEGF_N_OVERFLOW)

        create = onehot & ~(found | ~upd)[:, None]
        at_i = slots == i
        ngroups = ngroups + (upd & ~found).to(i32)
        psum = psum + torch.where(onehot, pos, 0)
        lsum = lsum + torch.where(onehot, ln, 0)
        n = n + onehot.to(i32)
        head = torch.where(create, aid, head)
        hord = torch.where(create, c_hord[:, i:i + 1], hord)
        assign = torch.where(at_i & upd[:, None], tgt[:, None], assign)
        segflags = segflags | bits
    return assign, segflags


def run_combine_greedy_task(payload: dict, meta: dict, device) -> dict:
    """Run the whole-task grid greedy for one (combine task, svtype) on
    `device` ("cuda", or "cpu" when the CPU was asked for).

    payload: the JAX package's dict — c_pos/c_len/c_alt/c_hord (S, L)
    int32 grids in segment-row layout (trimmed; padded to powers of two
    here, as the JAX package does), counts (S,), ed_segs, ed_rows (head
    table row), ed_cols, ed_vals (sparse exact ED entries).
    meta: cm, cmm, limit.

    Returns {"assign": (S, L) int32 segment-local slot ids,
    "seg_flags": (S,) int32 SEGF_* bitmasks} as numpy arrays.
    """
    c_pos = np.asarray(payload["c_pos"], dtype=np.int32)
    S, L = c_pos.shape
    Sp = _pow2(max(S, 1), 16)
    Lp = _pow2(max(L, 1), 64)

    def pad_g(a, fill=0):
        out = np.full((Sp, Lp), fill, dtype=np.int32)
        out[:S, :L] = a
        return out

    counts = np.zeros(Sp, dtype=np.int32)
    counts[:S] = np.asarray(payload["counts"], dtype=np.int32)
    segs = np.asarray(payload["ed_segs"], dtype=np.int64)
    if len(segs):
        ed = np.full((Sp, TASK_ED_HEADS, Lp), -1, dtype=np.int32)
        ed[segs, np.asarray(payload["ed_rows"], dtype=np.int64),
           np.asarray(payload["ed_cols"], dtype=np.int64)] = \
            np.asarray(payload["ed_vals"], dtype=np.int32)
    else:
        # all-missing table: a width-1 grid reads the same -1 everywhere
        ed = np.full((Sp, TASK_ED_HEADS, 1), -1, dtype=np.int32)

    def on_dev(x):
        return torch.from_numpy(x).to(device)

    assign, segflags = _greedy_grid_loop(
        on_dev(pad_g(c_pos)),
        on_dev(pad_g(np.asarray(payload["c_len"], dtype=np.int32))),
        on_dev(pad_g(np.asarray(payload["c_alt"], dtype=np.int32))),
        on_dev(pad_g(np.asarray(payload["c_hord"], dtype=np.int32), fill=-1)),
        on_dev(counts), on_dev(ed),
        cm=int(meta["cm"]), cmm=int(meta["cmm"]), limit=float(meta["limit"]))
    return {"assign": assign.cpu().numpy()[:S, :L],
            "seg_flags": segflags.cpu().numpy()[:S]}
