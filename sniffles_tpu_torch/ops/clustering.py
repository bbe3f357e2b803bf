"""
Device clustering of one call task: the sort-and-segment formulation of
the reference's adaptive cluster sweep (reference: cluster.py:219-353),
with the per-cluster calling statistics computed on the device.

Copied from sniffles_tpu/ops/clustering.py, the part that the call
path's `call_task_packed` reaches, as torch ops on `config.device`:

  1. sort by (svtype, seed bin, insertion order) — the host's exact
     per-cluster lead order; invalid slots sort last
  2. seed one segment per cluster_binsize bin
  3. the EXACT merge sweep (`merge_sweep`): the host's sequential
     backtracking sweep (cluster.py:277-308) with linked-list cluster
     state and the `i = max(0, i-2) + 1` pointer semantics, split at the
     JAX package's sound cuts (the cut fixpoint of its grid sweep,
     `sweep_cuts`) and walked one segment at a time with the sequential
     sweep's own arithmetic, which gives the sequential sweep's state
     bit for bit. On the card these are the hand-written kernels of
     csrc/merge_sweep.cu (the partition in one block, then a thread per
     segment); `sweep_cuts_plain` and `merge_sweep_plain` are their plain
     PyTorch versions, and what a CPU tensor gets
  4. the per-read inner merge fold, the svlen-histogram resplit, and the
     per-child calling statistics and phase tallies

The JAX package's other formulations stay there: the grid sweep's
lockstep lanes (whose float32 range metrics round otherwise) and its
auto switch, the parallel relaxation of the fused engine path,
cluster_assign_packed and the vmapped batched_call_task. The tests hold
the segmented sweep to a copy of the sequential one in every state word,
call_task_packed to the JAX package's sequential sweep on every batch,
and to its default (the auto switch) where the JAX package's two
formulations agree.

Where JAX and torch differ, the JAX semantics are kept: `jnp.lexsort`
(last key primary) is a chain of stable sorts (ops/segments.lexsort);
JAX indexing `a[i]` clamps out-of-range indices (`_clamped`); int32 sums
wrap in int32; floor division stays floor division.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from sniffles_tpu_torch.ops.segments import (INT32_MAX, INT32_MIN, lexsort,
                                             segment_ids_from_boundaries, seg_sum,
                                             seg_sum_f32, seg_max, seg_min, seg_count,
                                             seg_mean, sqrt_f32, unique_count_per_segment)
from sniffles_tpu_torch.ops.stats import seg_median_modes, seg_trimmed_stdev

# svtype codes (order matches svcall.ALL_TYPES)
SVTYPE_INS, SVTYPE_DEL, SVTYPE_DUP, SVTYPE_INV, SVTYPE_BND = 0, 1, 2, 3, 4
SVTYPE_SINGLE_LEFT, SVTYPE_SINGLE_RIGHT = 5, 6
SVTYPE_NAMES = ["INS", "DEL", "DUP", "INV", "BND", "SINGLE_LEFT", "SINGLE_RIGHT"]
SVTYPE_CODES = {name: i for i, name in enumerate(SVTYPE_NAMES)}

# stride picks of a cluster's compute_metrics top out at 199 (L in
# [100, 199], stride 1), so this cap never binds
PICK_CAP = 256

# Launches of the CUDA kernels by the sweep wrapper (merge_sweep):
# "launches" counts the segment sweeps, "sweep_cuts" the partitions; it
# adds to them only where it launches the kernels.
COUNTS = {"launches": 0, "sweep_cuts": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _clamped(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] with JAX's indexing rule: out-of-range indices clamp."""
    return v[idx.long().clamp(0, v.shape[0] - 1)]


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _shift_prev(v: torch.Tensor) -> torch.Tensor:
    """concatenate([v[:1], v[:-1]]): each element's predecessor, the first
    its own."""
    return torch.cat([v[:1], v[:-1]])


def _segment_metrics(seg, valid, pos, svlen, arange_n, n):
    """Host-exact compute_metrics per segment (reference: cluster.py:48-61):
    clusters over max_n=100 leads use a stride subsample, with the
    reference's quirks preserved — the stride can visit MORE than max_n
    leads while the svlen mean still divides by max_n, and the start
    stdev is the SAMPLE stdev over the actual pick count. Elements must
    be in host lead order (svtype, bin, insertion) so the picks land on
    the same leads the host visits. The pick sums accumulate in float64
    (ops/segments.seg_sum_f32), as the kernel's do."""
    segl = seg.long()
    L = seg_count(seg, valid, n)
    seg_first = seg_min(torch.where(valid, arange_n, n), seg, n)
    p = arange_n - seg_first[segl]
    nn = torch.clamp(L, max=100)
    stride_seg = torch.clamp(torch.div(L, torch.clamp(nn, min=1), rounding_mode="floor"),
                             min=1)
    is_pick = valid & (torch.remainder(p, stride_seg[segl]) == 0)
    npicks = seg_sum(is_pick.to(torch.int32), seg, n)
    posf = pos.to(torch.float32)
    svlenf = svlen.to(torch.float32)
    mean_svlen = (seg_sum_f32(torch.where(is_pick, svlenf, 0.0), seg, n)
                  / torch.clamp(nn, min=1).to(torch.float32))
    mean_start = (seg_sum_f32(torch.where(is_pick, posf, 0.0), seg, n)
                  / torch.clamp(npicks, min=1).to(torch.float32))
    dev = torch.where(is_pick, posf - mean_start[segl], 0.0)
    ss = seg_sum_f32(dev * dev, seg, n)
    sd_start = torch.where(npicks >= 2,
                           sqrt_f32(ss / torch.clamp(npicks - 1, min=1)
                                    .to(torch.float32)), 0.0)
    return mean_svlen, sd_start


# ---------------------------------------------------------------------------
# The exact merge sweep: slot state, plain versions, kernel wrapper
# ---------------------------------------------------------------------------

SWEEP_STATE = ("nxt", "prv", "hi", "end_bp", "rep", "msv", "sd", "alive")


def sweep_inputs(s: dict, seed_boundary, bin_, binsize):
    """Per-seed slot state of the sweep, as torch ops (the JAX package's
    _exact_merge_sweep, :122-140 and :179-181): n slots, of which the
    first `nseeds` are live. Returns (inputs, state): the read-only
    per-slot arrays and element columns the sweep reads, and the mutable
    linked-list cluster state it updates in place."""
    n = s["pos"].shape[0]
    valid = s["valid"]
    svtype = s["svtype"]
    pos = s["pos"]
    arange_n = _arange(n, pos)
    sent = torch.full_like(arange_n, n)

    seed_id = segment_ids_from_boundaries(seed_boundary)
    nseeds = torch.max(torch.where(valid, seed_id, -1)) + 1

    lo = seg_min(torch.where(valid, arange_n, n), seed_id, n)
    hi = seg_max(torch.where(valid, arange_n, -1), seed_id, n) + 1
    seed_type = seg_max(torch.where(valid, svtype, -1), seed_id, n)
    start_bp = seg_min(torch.where(valid, bin_ * binsize, INT32_MAX), seed_id, n)
    end_bp0 = seg_max(torch.where(valid, bin_ * binsize + binsize, -1), seed_id, n)
    rep0 = seg_max(torch.where(valid, s["repeat"].to(torch.int32), 0), seed_id, n)
    mean_sv0, sd0 = _segment_metrics(seed_id, valid, pos, s["svlen"], arange_n, n)

    inputs = {"seed_type": seed_type, "start_bp": start_bp, "lo": lo,
              "posf": pos.to(torch.float32), "svlenf": s["svlen"].to(torch.float32),
              "nseeds": nseeds.to(torch.int32).reshape(1)}
    state = {"nxt": torch.where(arange_n + 1 < nseeds, arange_n + 1, sent),
             "prv": torch.where(arange_n > 0, arange_n - 1, sent),
             "hi": hi, "end_bp": end_bp0, "rep": rep0,
             "msv": mean_sv0, "sd": sd0,
             "alive": (arange_n < nseeds).to(torch.int32)}
    return inputs, state


def _sum_in_order(values: torch.Tensor) -> float:
    """Sum in float64, term after term in index order, as the kernel's
    loop adds (a library reduction adds in another order, and a sum of
    squared deviations need not be exact in float64)."""
    acc = 0.0
    for v in values.double().tolist():
        acc += v
    return acc


def _range_metrics_plain(posf, svlenf, lo_c: int, hi_c: int):
    """compute_metrics over the contiguous element range [lo_c, hi_c) —
    merges always join adjacent clusters, so a cluster is always a
    contiguous slice of the sorted elements, in host lead order. The
    picks' sums accumulate in float64 in pick order and round once, as
    in the kernel."""
    n = posf.shape[0]
    L = max(hi_c - lo_c, 0)
    nn = min(L, 100)
    stride = max(L // max(nn, 1), 1)
    npicks = min(-(-L // stride), PICK_CAP)
    idx = (lo_c + stride * torch.arange(npicks, dtype=torch.int64,
                                        device=posf.device)).clamp(0, n - 1)
    ps = posf[idx]
    f32 = torch.float32

    def f32_of(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=f32, device=posf.device)

    mean_sv = f32_of(_sum_in_order(svlenf[idx])) / f32_of(max(nn, 1))
    mean_ps = f32_of(_sum_in_order(ps)) / f32_of(max(npicks, 1))
    dev = ps - mean_ps
    ss = f32_of(_sum_in_order(dev * dev))
    sd = sqrt_f32(ss / f32_of(max(npicks - 1, 1))) if npicks >= 2 else f32_of(0.0)
    return mean_sv, sd


SWEEP_COUNTS = ("iterations", "depth", "segments", "passes", "collapsed")
# the cut fixpoint's pass cap (the JAX package's)
MAX_CUT_PASSES = 24


def sweep_cuts_plain(inputs: dict, state: dict, *, cluster_r, cluster_repeat_h_max,
                     cluster_merge_bnd):
    """The plain PyTorch version of the kernel sweep_cuts in
    csrc/merge_sweep.cu: the sound-cut partition of the seed slots (the
    cut fixpoint of the JAX package's _exact_merge_sweep_grid, :339-373),
    from the initial `end_bp` of `state`, so it runs before the sweep.

    Initial cuts: a svtype's first seed, or a gap beyond both merge caps
    (float32). A pass keeps a non-type cut while gap > cluster_r *
    min(span of the segment left of it, span of its own) in float32, all
    cuts judged on the previous pass's partition; a segment's span is
    end_bp of its last seed minus start_bp of its first (within a svtype
    the seeds are one bin each, in bin order). The JAX lines take the
    left span from the per-slot span array at index segid - 1; the left
    segment's span, which the soundness proof needs, is taken here (the
    two agree where every earlier segment is one seed). A partition still
    changing after MAX_CUT_PASSES passes collapses to the type cuts.
    Returns (cut flags, uint8 [n], of which the first nseeds are the
    partition (the kernel writes no other; here slot 0 is always set and
    the rest are 0); the cut slots in order, int64; counts, int32
    [len(SWEEP_COUNTS)] with zero iterations and depth)."""
    seed_type, start_bp = inputs["seed_type"], inputs["start_bp"]
    end_bp = state["end_bp"]
    n = seed_type.shape[0]
    arange_n = torch.arange(n, device=seed_type.device)
    live = arange_n < inputs["nseeds"][0]
    prev_slot = (arange_n - 1).clamp(min=0)
    type_change = (arange_n == 0) | (seed_type != seed_type[prev_slot])
    f32 = torch.float32
    gap = (start_bp - end_bp[prev_slot]).to(f32)
    const_ok = gap > torch.tensor(max(float(cluster_merge_bnd), float(cluster_repeat_h_max)),
                                  dtype=f32)
    r_f = torch.tensor(cluster_r, dtype=f32)
    nseeds = inputs["nseeds"][0].long()

    def heads_of(cut):
        return torch.nonzero(cut & live).flatten()

    cut = live & (type_change | const_ok)
    cut[0] = True
    passes, changed = 0, True
    while changed and passes < MAX_CUT_PASSES:
        passes += 1
        heads = heads_of(cut)
        last = torch.cat([heads[1:] - 1, (nseeds - 1).reshape(1)])
        span = (end_bp[last] - start_bp[heads]).to(f32)
        span_left = torch.cat([span[:1], span[:-1]])
        m1_ok = gap[heads] > r_f * torch.minimum(span_left, span)
        new_cut = cut.clone()
        new_cut[heads] = type_change[heads] | (const_ok[heads] & m1_ok)
        new_cut[0] = True
        changed = bool((new_cut != cut).any())
        cut = new_cut
    if changed:
        cut = live & type_change
        cut[0] = True
    heads = heads_of(cut)
    counts = torch.tensor([0, 0, heads.numel(), passes, int(changed)], dtype=torch.int32)
    return cut.to(torch.uint8), heads, counts


def merge_sweep_plain(inputs: dict, state: dict, *, cluster_r, cluster_repeat_h,
                      cluster_repeat_h_max, cluster_merge_bnd,
                      global_repeat) -> torch.Tensor:
    """The plain PyTorch version of csrc/merge_sweep.cu: EXACT emulation of
    the host cluster merge sweep (reference: cluster.py:277-308), updating
    `state` in place: the partition (sweep_cuts_plain), then each segment
    walked on its own, one pointer move or merge per iteration. Returns
    the counts of SWEEP_COUNTS as an int32 tensor: total iterations, the
    longest segment's iterations (depth), segments, passes, collapsed.

    The sequential sweep runs `i = max(0, i-2) + 1` pointer arithmetic:
    clusters accrete left-to-right, each merge re-evaluates the boundary
    LEFT of the merged cluster (for i >= 2), and the boundary after a
    svtype's first cluster is evaluated exactly once (the i=0 quirk — the
    head cluster can never absorb a third seed). A segment's walk follows
    the JAX grid sweep's lane rules (:489-562): `i` starts at 0 at a
    svtype's first seed (no mesh shards here) and at 2 elsewhere; a pair
    whose right cluster heads the next segment is not evaluated, and the
    walk ends when the pointer leaves the segment; a backtrack from the
    segment's head stays put. By the cut proof (:281-311) no merge crosses
    a cut, so the sequential sweep's evaluations there change nothing and
    the final state is the sequential sweep's. The criteria are evaluated
    in float32 as in the JAX package; metrics are recomputed per merge
    from the merged cluster's contiguous element range
    (_range_metrics_plain)."""
    cut, heads, counts = sweep_cuts_plain(inputs, state, cluster_r=cluster_r,
                                          cluster_repeat_h_max=cluster_repeat_h_max,
                                          cluster_merge_bnd=cluster_merge_bnd)
    return segment_sweep_plain(inputs, state, cut, heads, counts, cluster_r=cluster_r,
                               cluster_repeat_h=cluster_repeat_h,
                               cluster_repeat_h_max=cluster_repeat_h_max,
                               cluster_merge_bnd=cluster_merge_bnd,
                               global_repeat=global_repeat)


def segment_sweep_plain(inputs: dict, state: dict, cut: torch.Tensor, heads: torch.Tensor,
                        counts: torch.Tensor, *, cluster_r, cluster_repeat_h,
                        cluster_repeat_h_max, cluster_merge_bnd,
                        global_repeat) -> torch.Tensor:
    """The plain PyTorch version of the kernel merge_sweep: the walk of
    each segment of a partition (sweep_cuts_plain's cut flags, heads and
    counts), updating `state` in place; sets the iterations and the
    depth in `counts` and returns it."""
    f32 = torch.float32
    cut = cut.tolist()
    seed_type = inputs["seed_type"].tolist()
    start_bp = inputs["start_bp"].tolist()
    lo = inputs["lo"].tolist()
    posf, svlenf = inputs["posf"], inputs["svlenf"]
    n = len(seed_type)
    sent = n
    nxt, prv, hi = state["nxt"], state["prv"], state["hi"]
    end_bp, rep, msv, sd, alive = (state["end_bp"], state["rep"], state["msv"],
                                   state["sd"], state["alive"])
    r_f = torch.tensor(cluster_r, dtype=f32)
    h_f = torch.tensor(cluster_repeat_h, dtype=f32)
    hmax_f = torch.tensor(cluster_repeat_h_max, dtype=f32)
    bnd_f = torch.tensor(cluster_merge_bnd, dtype=f32)
    max_iters = 4 * n + 8

    def walk(head: int) -> int:
        ct = seed_type[head]
        c, i, it = head, 0 if head == 0 or seed_type[head - 1] != ct else 2, 0
        while it < max_iters:
            it += 1
            r = int(nxt[c])
            in_seg = r < sent and not cut[r]
            merge = False
            if in_seg:
                # criteria, as the host evaluates them (cluster.py:266-275)
                inner = torch.tensor(start_bp[r] - int(end_bp[c]), dtype=f32)
                outer = torch.tensor(int(end_bp[r]) - start_bp[c], dtype=f32)
                m1 = bool(inner <= torch.minimum(sd[c].cpu(), sd[r].cpu()) * r_f)
                rep_pair = int(rep[c]) > 0 or int(rep[r]) > 0 or bool(global_repeat)
                h_lim = torch.minimum(hmax_f, (msv[c].cpu().abs() + msv[r].cpu().abs()) * h_f)
                m2 = rep_pair and bool(outer <= h_lim)
                m3 = ct == SVTYPE_BND and bool(inner <= bnd_f)
                merge = m1 or m2 or m3
            if not merge:
                if not in_seg:
                    return it
                c, i = r, i + 1
                continue
            new_hi = int(hi[r])
            mean_new, sd_new = _range_metrics_plain(posf, svlenf, lo[c], new_hi)
            rn = int(nxt[r])
            hi[c] = new_hi
            end_bp[c] = end_bp[r]
            rep[c] = rep[c] | rep[r]
            msv[c] = mean_new
            sd[c] = sd_new
            nxt[c] = rn
            if rn < sent:
                prv[rn] = c
            alive[r] = 0
            # pointer transition (host: i = max(0, i-2) + 1 after a merge):
            #   merge at i == 0 -> the node AFTER the merged head (the
            #     head boundary is never revisited);
            #   merge at i == 1 -> the merged node itself;
            #   merge at i >= 2 -> the node BEFORE it (backtrack), unless c
            #     heads the segment: then the pointer stays put
            if i == 0:
                c, i = rn, 1
                if rn >= sent or cut[rn]:
                    return it
            elif i >= 2 and not cut[c]:
                c, i = int(prv[c]), i - 1
        return it

    iters = [walk(h) for h in heads.tolist()]
    counts[0] = sum(iters)
    counts[1] = max(iters, default=0)
    return counts


def _check_sweep_tensors(inputs: dict, state: dict) -> int:
    n = inputs["seed_type"].shape[0]
    want = {"seed_type": torch.int32, "start_bp": torch.int32, "lo": torch.int32,
            "posf": torch.float32, "svlenf": torch.float32, "nseeds": torch.int32,
            "nxt": torch.int32, "prv": torch.int32, "hi": torch.int32,
            "end_bp": torch.int32, "rep": torch.int32, "msv": torch.float32,
            "sd": torch.float32, "alive": torch.int32}
    tensors = {**inputs, **state}
    device = inputs["seed_type"].device
    for name, dtype in want.items():
        t = tensors[name]
        size = 1 if name == "nseeds" else n
        if t.dtype != dtype or t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{size}] {dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, the others on {device}")
    if n < 1:
        raise ValueError("the sweep needs at least one slot")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no merge-sweep kernel for device {device}")
    return n


def merge_sweep(inputs: dict, state: dict, *, cluster_r, cluster_repeat_h,
                cluster_repeat_h_max, cluster_merge_bnd, global_repeat) -> torch.Tensor:
    """The exact merge sweep over the slot state of `sweep_inputs`,
    updating `state` in place: on CUDA tensors the kernels of
    csrc/merge_sweep.cu, sweep_cuts then merge_sweep, on one stream (or
    an exception), on CPU tensors the plain version. Returns the counts of
    SWEEP_COUNTS as an int32 tensor on the inputs' device (no host
    synchronisation on the card)."""
    _check_sweep_tensors(inputs, state)
    params = dict(cluster_r=cluster_r, cluster_repeat_h=cluster_repeat_h,
                  cluster_repeat_h_max=cluster_repeat_h_max,
                  cluster_merge_bnd=cluster_merge_bnd, global_repeat=global_repeat)
    if not inputs["seed_type"].is_cuda:
        return merge_sweep_plain(inputs, state, **params)
    counts = launch_merge_sweep(inputs, state, inputs["seed_type"].shape[0], **params)
    COUNTS["sweep_cuts"] += 1
    COUNTS["launches"] += 1
    return counts


def _kernel(name: str, argtypes: list):
    from sniffles_tpu_torch.ops import _build
    fn = getattr(_build.load("merge_sweep"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def launch_sweep_cuts(inputs: dict, state: dict, n: int, *, cluster_r,
                      cluster_repeat_h_max, cluster_merge_bnd):
    """One launch of the kernel's entry point sweep_cuts on CUDA tensors
    that merge_sweep has checked. Returns (cut flags, uint8 [n], of which
    the first nseeds are set; the segment heads, int32 [n], of which the
    first `segments` are set; counts). Counts nothing; raises when the
    launch fails."""
    fn = _kernel("sweep_cuts", [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_float] * 2
                 + [ctypes.c_void_p])
    device = inputs["seed_type"].device
    cut = torch.empty(n, dtype=torch.uint8, device=device)
    spare = torch.empty_like(cut)
    heads = torch.empty(n, dtype=torch.int32, device=device)
    counts = torch.empty(len(SWEEP_COUNTS), dtype=torch.int32, device=device)
    rc = fn(inputs["seed_type"].data_ptr(), inputs["start_bp"].data_ptr(),
            state["end_bp"].data_ptr(), inputs["nseeds"].data_ptr(), cut.data_ptr(),
            spare.data_ptr(), heads.data_ptr(), counts.data_ptr(), n, float(cluster_r),
            max(float(cluster_merge_bnd), float(cluster_repeat_h_max)), _stream(device))
    if rc != 0:
        raise RuntimeError(f"sweep_cuts launch failed with CUDA error {rc}")
    return cut, heads, counts


def launch_merge_sweep(inputs: dict, state: dict, n: int, *, cluster_r,
                       cluster_repeat_h, cluster_repeat_h_max, cluster_merge_bnd,
                       global_repeat) -> torch.Tensor:
    """The sweep on CUDA tensors that merge_sweep has checked: a launch of
    sweep_cuts, then one of merge_sweep, a thread per segment, on the
    same stream. Returns the counts; counts no launch; raises when a
    launch fails."""
    cut, heads, counts = launch_sweep_cuts(inputs, state, n, cluster_r=cluster_r,
                                           cluster_repeat_h_max=cluster_repeat_h_max,
                                           cluster_merge_bnd=cluster_merge_bnd)
    return launch_segment_sweep(inputs, state, n, cut, heads, counts, cluster_r=cluster_r,
                                cluster_repeat_h=cluster_repeat_h,
                                cluster_repeat_h_max=cluster_repeat_h_max,
                                cluster_merge_bnd=cluster_merge_bnd,
                                global_repeat=global_repeat)


def launch_segment_sweep(inputs: dict, state: dict, n: int, cut: torch.Tensor,
                         heads: torch.Tensor, counts: torch.Tensor, *, cluster_r,
                         cluster_repeat_h, cluster_repeat_h_max, cluster_merge_bnd,
                         global_repeat) -> torch.Tensor:
    """One launch of the kernel's entry point merge_sweep, a thread per
    segment of the partition that launch_sweep_cuts returned. Returns the
    counts; counts no launch; raises when the launch fails."""
    fn = _kernel("merge_sweep", [ctypes.c_void_p] * 16 + [ctypes.c_int]
                 + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    ptrs = [inputs[k].data_ptr() for k in ("seed_type", "start_bp", "lo", "posf", "svlenf")]
    ptrs += [cut.data_ptr(), heads.data_ptr(), counts.data_ptr()]
    ptrs += [state[k].data_ptr() for k in SWEEP_STATE]
    rc = fn(*ptrs, n, float(cluster_r), float(cluster_repeat_h), float(cluster_repeat_h_max),
            float(cluster_merge_bnd), int(bool(global_repeat)),
            _stream(inputs["seed_type"].device))
    if rc != 0:
        raise RuntimeError(f"merge_sweep launch failed with CUDA error {rc}")
    return counts


def _exact_merge_sweep(s: dict, seed_boundary, bin_, *, cluster_r,
                       cluster_repeat_h, cluster_repeat_h_max,
                       cluster_merge_bnd, global_repeat, binsize):
    """The exact sweep (sniffles_tpu/ops/clustering.py:90 formulation):
    slot state as torch ops, the sweep itself through `merge_sweep`,
    then the element boundaries from the surviving clusters."""
    n = s["pos"].shape[0]
    valid = s["valid"]
    inputs, state = sweep_inputs(s, seed_boundary, bin_, binsize)
    merge_sweep(inputs, state, cluster_r=cluster_r, cluster_repeat_h=cluster_repeat_h,
                cluster_repeat_h_max=cluster_repeat_h_max,
                cluster_merge_bnd=cluster_merge_bnd, global_repeat=global_repeat)
    # final element boundaries: the lo of every alive cluster, plus the
    # original seed boundaries of the invalid tail (padding elements keep
    # any segmentation — they are masked everywhere downstream)
    alive_lo = torch.where(state["alive"] > 0, inputs["lo"], n)
    scat = torch.zeros((n + 1,), dtype=torch.bool, device=valid.device)
    scat[alive_lo.long().clamp(0, n)] = True
    boundary = scat[:n] | (seed_boundary & ~valid)
    boundary[0] = True
    return boundary


def sort_and_seed(sig: dict, binsize: int):
    """Steps 1-2 of _cluster_body: the batch sorted by (svtype, seed bin,
    insertion order), invalid slots last, and its seed boundaries (a
    svtype or bin change). Returns (sorted dict, boundary, bin_)."""
    valid = sig["valid"]
    # Within a bin the HOST keeps scan/insertion order (leadtab lists,
    # reference: leadprov.py:400-418), and the sweep's subsampled
    # compute_metrics picks depend on that order — so the device sorts
    # by the original lead index within bins.
    bin0 = torch.div(sig["pos"], binsize, rounding_mode="floor")
    tie0 = sig.get("orig_idx", sig["pos"])
    order = lexsort((torch.where(valid, tie0, INT32_MAX),
                     torch.where(valid, bin0, INT32_MAX),
                     torch.where(valid, sig["svtype"], INT32_MAX)))
    s = {k: v[order] for k, v in sig.items()}
    valid = s["valid"]
    svtype = s["svtype"]
    bin_ = torch.div(s["pos"], binsize, rounding_mode="floor")
    first = torch.ones((1,), dtype=torch.bool, device=valid.device)
    change = ((svtype[1:] != svtype[:-1]) | (bin_[1:] != bin_[:-1])
              | (~valid[1:] & valid[:-1]))
    return s, torch.cat([first, change]), bin_


def _cluster_body(sig: dict, *, cluster_r: float, cluster_repeat_h: float,
                  cluster_repeat_h_max: float, cluster_merge_bnd: int,
                  binsize: int = 100, global_repeat: bool = False) -> dict:
    """
    Cluster a signature batch (the JAX package's _cluster_body with
    exact_sweep=True, do_resplit=False: the call path resplits after the
    inner merge fold). `sig` is a dict of equal-length tensors: pos, svlen,
    svtype, read_id (int32), repeat, valid (bool), orig_idx and further
    int32 columns that ride along through the sort.

    Returns the sorted signature tensors plus `cluster_id` per element
    and `n_clusters`.
    """
    s, boundary, bin_ = sort_and_seed(sig, binsize)
    boundary = _exact_merge_sweep(
        s, boundary, bin_, cluster_r=cluster_r,
        cluster_repeat_h=cluster_repeat_h,
        cluster_repeat_h_max=cluster_repeat_h_max,
        cluster_merge_bnd=cluster_merge_bnd,
        global_repeat=global_repeat, binsize=binsize)

    seg = segment_ids_from_boundaries(boundary)
    out = dict(s)
    out["cluster_id"] = seg
    out["n_clusters"] = torch.max(torch.where(s["valid"], seg, -1)) + 1
    return out


def merge_inner_fold(clustered: dict, *, cluster_merge_pos: int,
                     global_repeat: bool) -> dict:
    """Device twin of the host per-read inner merge (cluster.merge_inner,
    reference: cluster.py:85-122): INS/DEL fragments of the same read
    inside one cluster fold into a single signature — svlen summed, all
    other fields taken from the first fragment (the host's open_lead).

    The host chain walk is purely local: a fragment merges into the open
    group iff it is `near` its immediate predecessor AND its strand
    matches the group head's — and since every previously-merged member
    already matched the head's strand, head-strand == predecessor-strand,
    so the whole decision is an adjacent-pair predicate (no scan needed).
    Inside repeat clusters the host threshold is -1 (merge a read's
    fragments unconditionally); per-cluster repeat status replicates
    that here.

    Input `clustered` is _cluster_body output carrying ref_end /
    qry_start / qry_end columns. Returns the same dict with `svlen`
    folded and `valid` masked to fold-group heads (non-head slots are
    dropped from statistics exactly as the host drops merged fragments).
    """
    n = clustered["pos"].shape[0]
    cid = clustered["cluster_id"]
    valid = clustered["valid"]
    pos = clustered["pos"]

    rep_cluster = seg_max(torch.where(valid, clustered["repeat"].to(torch.int32), 0),
                          cid, n) > 0
    if global_repeat:
        rep_cluster = torch.ones_like(rep_cluster)
    rep_here = _clamped(rep_cluster, cid)

    # sort by (cluster, read, ref_start); stable, so ties keep the
    # cluster-sort order — the same order the host's stable per-read
    # sort produces from cluster.leads
    order = lexsort((torch.where(valid, pos, INT32_MAX),
                     torch.where(valid, clustered["read_id"], INT32_MAX),
                     torch.where(valid, cid, INT32_MAX)))
    s = {k: (v[order] if isinstance(v, torch.Tensor) and v.dim() == 1 else v)
         for k, v in clustered.items()}
    valid = s["valid"]
    pos = s["pos"]
    cid_s = s["cluster_id"]
    t = cluster_merge_pos

    prev = {k: _shift_prev(v) for k, v in s.items()
            if isinstance(v, torch.Tensor) and v.dim() == 1}
    same_key = (valid & prev["valid"] & (cid_s == prev["cluster_id"])
                & (s["read_id"] == prev["read_id"]))
    near = ((((pos - prev["ref_end"]).abs() < t)
             | ((pos - prev["pos"]).abs() < t))
            & (((s["qry_start"] - prev["qry_end"]).abs() < t)
               | ((s["qry_start"] - prev["qry_start"]).abs() < t)))
    foldable = (s["svtype"] == SVTYPE_INS) | (s["svtype"] == SVTYPE_DEL)
    rep_s = rep_here[order]
    merge = (same_key & foldable
             & (rep_s | (near & (s["strand"] == prev["strand"]))))
    merge[0] = False

    fold_id = segment_ids_from_boundaries(~merge)
    svlen_f = seg_sum(torch.where(valid, s["svlen"], 0), fold_id, n)

    out = dict(s)
    out["svlen"] = svlen_f[fold_id.long()]
    out["valid"] = valid & ~merge
    # pre-head-masking validity: every element of a fold group stays
    # valid here and carries the FOLDED svlen — so per-child phase
    # tallies (which need all pre-fold elements) can segment by the
    # resplit child ids computed from folded lengths
    out["valid_all"] = valid
    return out


def resplit_child_ids(folded: dict, *, resplit_binsize: int, minsvlen: int,
                      cluster_merge_len: float):
    """Device twin of the host svlen-histogram resplit (cluster.resplit,
    reference: cluster.py:125-161), computed over merge_inner_fold
    output.

    The host sweep's backtracking is provably redundant here: merges
    always keep the RIGHT (higher) bin's key, so every comparison is
    between two ORIGINAL bin keys, each adjacent original pair is
    evaluated exactly once before anything to its right, and
    re-evaluations after a removal compare a pair with a strictly larger
    gap at the same (lower-key) threshold — monotone, so they can never
    newly merge. The final partition is therefore the pure
    adjacent-occupied-bin predicate.

    Returns (child_id per element in `folded`'s order, n_children,
    uncertain per parent-cluster slot). Child ids ascend in
    (cluster, bin) order — within a parent cluster, ascending svlen bin,
    exactly the host's child yield order. BND keeps one child per
    cluster (the host routes BND to resplit_bnd instead).

    Precision: the host evaluates ``lo * cluster_merge_len`` in float64;
    this uses float32, as the JAX package does. An adjacent-bin gap
    within a relative ~1e-5 window of its threshold could therefore split
    differently, so such pairs mark their PARENT cluster `uncertain` —
    the consumer withholds device stats for its children and the exact
    host resplit decides (conservative, never wrong).
    """
    n = folded["pos"].shape[0]
    valid = folded["valid_all"]
    cid = folded["cluster_id"]
    svbin = torch.div(folded["svlen"].abs(), resplit_binsize,
                      rounding_mode="floor") * resplit_binsize

    order = lexsort((torch.where(valid, svbin, INT32_MAX),
                     torch.where(valid, cid, INT32_MAX)))
    bin_s = svbin[order]
    cid_s = cid[order]
    valid_s = valid[order]
    type_s = folded["svtype"][order]

    prev_bin = _shift_prev(bin_s)
    prev_cid = torch.cat([cid_s[:1] - 1, cid_s[:-1]])
    same_cluster = cid_s == prev_cid
    f32 = torch.float32
    gap = (bin_s - prev_bin).to(f32)
    thr = torch.maximum(torch.tensor(float(minsvlen), dtype=f32, device=gap.device),
                        prev_bin.to(f32) * torch.tensor(cluster_merge_len, dtype=f32))
    no_resplit = type_s == SVTYPE_BND
    boundary = ((~same_cluster) | ((gap > thr) & ~no_resplit)
                | (~valid_s & _shift_prev(valid_s)))
    boundary[0] = True
    child_sorted = segment_ids_from_boundaries(boundary)
    n_children = torch.max(torch.where(valid_s, child_sorted, -1)) + 1
    child = torch.zeros((n,), dtype=child_sorted.dtype, device=child_sorted.device)
    child[order] = child_sorted

    # float32-vs-float64 ambiguity flag, reduced onto the parent cluster
    eps = (torch.tensor(1e-5, dtype=f32) * torch.clamp(thr, min=1.0)
           + torch.tensor(1e-3, dtype=f32))
    ambiguous = (valid_s & same_cluster & ~no_resplit & (gap > 0)
                 & ((gap - thr).abs() <= eps))
    uncertain = seg_max(ambiguous.to(torch.int32), cid_s.clamp(0, n - 1), n)
    return child, n_children, uncertain


def packed_signatures(packed: torch.Tensor) -> dict:
    """The signature columns of a packed (15, N) int32 batch (layout in
    call_task_packed)."""
    return {
        "pos": packed[0],
        "svlen": packed[1],
        "svtype": packed[2],
        "read_id": packed[8],
        "strand": packed[6],
        "mapq": packed[7],
        "nm": torch.zeros_like(packed[0], dtype=torch.float32),
        "repeat": packed[4] > 0,
        "valid": packed[5] > 0,
        # extra columns: every key is permuted by the sorts, so the
        # original lead index / sa flag simply ride along
        "orig_idx": packed[3],
        "sa": packed[9],
        "ref_end": packed[10],
        "qry_start": packed[11],
        "qry_end": packed[12],
        "hap": packed[13],
        "ps": packed[14],
    }


def call_task_packed(packed: torch.Tensor, *,
                     cluster_r: float,
                     cluster_repeat_h: float,
                     cluster_repeat_h_max: float,
                     cluster_merge_bnd: int,
                     cluster_merge_len: float,
                     minsvlen: int,
                     cluster_merge_pos: int = 150,
                     global_repeat: bool = False,
                     binsize: int = 100,
                     resplit_binsize: int = 20) -> torch.Tensor:
    """The call path's device step: cluster assignment PLUS the exact
    per-cluster calling statistics of call_statistics (reference:
    sv.py:497-598) computed AFTER the device merge_inner fold, on the
    device of `packed`.

    `packed` is a (15, N) int32 tensor with rows pos, svlen, svtype,
    orig_idx, repeat, valid, strand(+1/-1), mapq, read_id (a hash of the
    read name — support counts unique reads, sv.py:520), is_sa (lead
    source != INLINE — split-read evidence, sv.py:580-581), ref_end,
    qry_start, qry_end (the merge_inner anchor columns), hap (HP tag, 0
    when absent), ps (PS tag, -1 when absent).

    Returns ONE flat int32 tensor, the JAX package's layout, which
    split_call_task_output unpacks into:

      elements: (3, N) int32, per element (sort-permuted):
        cluster_id, orig_idx, valid — the PRE-fold stage-1 assignment
        (the host materializes every fragment, then merges)
      stats: (21, SLOTS) int32 with SLOTS = max(1024, N//8), per RESPLIT
        CHILD. Rows 0-8 POST-fold calling stats: raw_pos_center,
        svlen_center, support, lead_count (folded count), fwd, rev,
        sum_mapq, pos_sum (int32-wrapping sum of folded head positions —
        the host verifies its own merge_inner+resplit produced the same
        child before consuming these stats), support_sa (count of
        split-read leads). Rows 9-17 phase-vote tallies (phase_tallies):
        hp0, hp1, hp2, hp_other, ps_win, ps_win_cnt, ps_second_cnt,
        ps_null, mixed. Row 18 the child's parent cluster id. Row 19 the
        parent's resplit float32-ambiguity flag. Row 20 slot 0 =
        n_children, slot 1 = n_clusters. A task with more than SLOTS
        children reports n_children > SLOTS and the caller routes the
        task to the exact host sweep (capacity, not correctness).
    """
    sig = packed_signatures(packed)
    clustered = _cluster_body(sig, cluster_r=cluster_r, cluster_repeat_h=cluster_repeat_h,
                              cluster_repeat_h_max=cluster_repeat_h_max,
                              cluster_merge_bnd=cluster_merge_bnd,
                              binsize=binsize, global_repeat=global_repeat)
    i32 = torch.int32
    elements = torch.stack([clustered["cluster_id"].to(i32),
                            clustered["orig_idx"].to(i32),
                            clustered["valid"].to(i32)])

    folded = merge_inner_fold(clustered, cluster_merge_pos=cluster_merge_pos,
                              global_repeat=global_repeat)
    # svlen-histogram resplit on device (reference: cluster.py:125-161):
    # all statistics below segment by the RESPLIT CHILD
    child, n_children, uncertain_parent = resplit_child_ids(
        folded, resplit_binsize=resplit_binsize, minsvlen=minsvlen,
        cluster_merge_len=cluster_merge_len)
    folded_child = dict(folded)
    folded_child["cluster_id"] = child
    folded_child["n_clusters"] = n_children
    stats = call_statistics(folded_child)
    phase = phase_tallies({"cluster_id": child, "valid": folded["valid_all"],
                           "read_id": folded["read_id"], "hap": folded["hap"],
                           "ps": folded["ps"]}, folded["pos"].shape[0])

    n = folded["pos"].shape[0]
    valid = folded["valid"]
    sum_mapq = seg_sum(torch.where(valid, folded["mapq"], 0), child, n)
    pos_sum = seg_sum(torch.where(valid, folded["pos"], 0), child, n)
    support_sa = seg_sum((valid & (folded["sa"] > 0)).to(i32), child, n)
    # per child slot: its parent cluster id (ordinal host<->device child
    # mapping) and the parent's float32-ambiguity flag
    parent = seg_max(torch.where(folded["valid_all"], folded["cluster_id"], -1), child, n)
    child_uncertain = _clamped(uncertain_parent, parent)

    slots = max(1024, n // 8)
    counts = torch.zeros((n,), dtype=i32, device=packed.device)
    counts[0] = n_children.to(i32)
    counts[1] = clustered["n_clusters"].to(i32)
    full = torch.stack([
        stats["raw_pos_center"], stats["svlen"], stats["support"].to(i32),
        stats["lead_count"].to(i32), stats["fwd"].to(i32), stats["rev"].to(i32),
        sum_mapq.to(i32), pos_sum.to(i32), support_sa.to(i32),
        phase["hp0"], phase["hp1"], phase["hp2"], phase["hp_other"],
        phase["ps_win"], phase["ps_win_cnt"], phase["ps_second_cnt"],
        phase["ps_null"], phase["mixed"],
        parent.to(i32), child_uncertain.to(i32), counts])
    return torch.cat([elements.reshape(-1), full[:, :slots].reshape(-1)])


STATS_ROWS = 21          # 9 calling stats + 9 phase tallies + parent +
                         # uncertain + counts — ALL PER RESPLIT CHILD
STATS_PARENT_ROW = 18    # child's parent (pre-resplit) cluster id
STATS_UNCERTAIN_ROW = 19  # parent's resplit float32-ambiguity flag
STATS_NC_ROW = 20        # slot 0 = n_children, slot 1 = n_clusters


def split_call_task_output(flat: np.ndarray, n: int):
    """Split the flat call_task_packed result back into (elements (3, N),
    stats (STATS_ROWS, SLOTS))."""
    elements = flat[:3 * n].reshape(3, n)
    stats = flat[3 * n:].reshape(STATS_ROWS, -1)
    return elements, stats


def phase_tallies(clustered: dict, n: int) -> dict:
    """Per-cluster phase-vote tallies (reference: postprocessing.py:626-654
    phase_sv): unique-READ counts per haplotype value and the phase-set
    mode, computed pre-fold (the host's by_read dict deduplicates a
    read's leads, so element multiplicity is irrelevant — uniqueness per
    read is what matters).

    The host vote (util.most_common + postprocess._vote) is a pure
    function of the {value: unique-read-count} multiset, so the host can
    reproduce it EXACTLY from these integer tallies. Two cases the counts
    cannot decide ride back as flags and force the exact host vote:
    `mixed` (a read whose elements disagree on hap or ps) and a non-null
    phase-set count tie (winner selection needs string comparison of the
    tied values).
    """
    cid = clustered["cluster_id"]
    valid = clustered["valid"]
    read = clustered["read_id"]
    hap = clustered["hap"]
    ps = clustered["ps"]
    i32 = torch.int32

    order = lexsort((torch.where(valid, read, INT32_MAX),
                     torch.where(valid, cid, INT32_MAX)))
    cid_r = cid[order]
    read_r = read[order]
    hap_r = hap[order]
    ps_r = ps[order]
    valid_r = valid[order]

    same_run = (valid_r & _shift_prev(valid_r) & (cid_r == _shift_prev(cid_r))
                & (read_r == _shift_prev(read_r)))
    same_run[0] = False
    first = valid_r & ~same_run   # representative element per (cluster, read)
    mixed_e = same_run & ((hap_r != _shift_prev(hap_r)) | (ps_r != _shift_prev(ps_r)))
    seg = torch.where(valid_r, cid_r, 0)
    mixed = seg_max(torch.where(valid_r, mixed_e.to(i32), 0), seg, n)

    def ucount(cond):
        return seg_sum((first & cond).to(i32), seg, n)

    hp0 = ucount(hap_r == 0)
    hp1 = ucount(hap_r == 1)
    hp2 = ucount(hap_r == 2)
    hp_other = ucount((hap_r < 0) | (hap_r > 2))
    ps_null = ucount(ps_r < 0)

    # phase-set mode among non-null representatives: run-length count per
    # (cluster, ps) after a second sort, then per-cluster max + second max
    rep = first & (ps_r >= 0)
    order2 = lexsort((torch.where(rep, ps_r, INT32_MAX),
                      torch.where(rep, cid_r, INT32_MAX)))
    cid_p = cid_r[order2]
    ps_p = ps_r[order2]
    rep_p = rep[order2]
    new_run = rep_p & (~_shift_prev(rep_p) | (cid_p != _shift_prev(cid_p))
                       | (ps_p != _shift_prev(ps_p)))
    new_run[0] = rep_p[0]
    run_id = torch.clamp(torch.cumsum(new_run.to(i32), 0, dtype=i32) - 1, 0, n - 1)
    run_count = seg_sum(rep_p.to(i32), run_id, n)
    run_cid = seg_max(torch.where(new_run, cid_p, -1), run_id, n)
    run_ps = seg_max(torch.where(new_run, ps_p, -1), run_id, n)
    run_valid = run_count > 0

    rc = torch.where(run_valid, run_cid, 0)
    win_cnt = seg_max(torch.where(run_valid, run_count, 0), rc, n)
    run_idx = _arange(n, rc)
    is_max = run_valid & (run_count == win_cnt[rc.long()])
    first_max_idx = seg_min(torch.where(is_max, run_idx, INT32_MAX), rc, n)
    win_ps = torch.where(first_max_idx < INT32_MAX,
                         _clamped(run_ps, first_max_idx), -1)
    second_cnt = seg_max(
        torch.where(run_valid & (run_idx != first_max_idx[rc.long()]), run_count, 0),
        rc, n)

    return {
        "hp0": hp0.to(i32), "hp1": hp1.to(i32), "hp2": hp2.to(i32),
        "hp_other": hp_other.to(i32),
        "ps_win": win_ps.to(i32), "ps_win_cnt": win_cnt.to(i32),
        "ps_second_cnt": second_cnt.to(i32),
        "ps_null": ps_null.to(i32), "mixed": mixed.to(i32),
    }


def call_statistics(clustered: dict) -> dict:
    """
    Per-cluster calling statistics (reference: sv.py:497-598 call_from):
    svlen/pos centers via median_modes, trimmed stdevs, support as
    unique read count, mean mapq, strand counts, mean NM, PRECISE flag
    inputs. Results are [N]-shaped, indexed by cluster id.
    """
    n = clustered["pos"].shape[0]
    cid = clustered["cluster_id"]
    valid = clustered["valid"]
    i32 = torch.int32

    # sort by (cluster, value); invalid slots last
    def sorted_by(value):
        order = lexsort((torch.where(valid, value, INT32_MAX),
                         torch.where(valid, cid, INT32_MAX)))
        return value[order], cid[order], valid[order]

    svlen_s, cid_l, valid_l = sorted_by(clustered["svlen"])
    pos_s, cid_p, valid_p = sorted_by(clustered["pos"])
    read_s, cid_r, valid_r = sorted_by(clustered["read_id"])

    svlen_center = seg_median_modes(svlen_s, cid_l, valid_l, n)
    pos_center = seg_median_modes(pos_s, cid_p, valid_p, n)
    stdev_len = seg_trimmed_stdev(svlen_s, cid_l, valid_l, n)
    stdev_pos = seg_trimmed_stdev(pos_s, cid_p, valid_p, n)
    support = unique_count_per_segment(cid_r, read_s, valid_r, n)

    count = seg_count(cid, valid, n)
    qual = torch.floor(seg_mean(clustered["mapq"], cid, valid, n)).to(i32)
    fwd = seg_sum((valid & (clustered["strand"] > 0)).to(i32), cid, n)
    rev = count - fwd
    nm_mean = seg_mean(clustered["nm"], cid, valid, n)
    n_strands = torch.where((fwd > 0) & (rev > 0), 2, torch.where(count > 0, 1, 0))

    # cluster svtype (uniform within a cluster; max is a cheap head-select)
    svtype = seg_max(torch.where(valid, clustered["svtype"], -1), cid, n)

    # element-position extent per cluster
    pos_min = seg_min(torch.where(valid, clustered["pos"], INT32_MAX), cid, n)
    pos_max = seg_max(torch.where(valid, clustered["pos"], INT32_MIN), cid, n)

    # bounds (reference: sv.py:484-494 calculate_bounds)
    is_ins = svtype == SVTYPE_INS
    is_del = svtype == SVTYPE_DEL
    svstart = torch.where(is_del, pos_center + svlen_center, pos_center)
    svend = torch.where(is_ins | is_del, pos_center, pos_center + svlen_center.abs())

    return {
        "n_clusters": clustered["n_clusters"],
        "svtype": svtype.to(i32),
        "svlen": svlen_center.to(i32),
        "pos": svstart.to(i32),
        "end": svend.to(i32),
        "raw_pos_center": pos_center.to(i32),
        "pos_min": pos_min.to(i32),
        "pos_max": pos_max.to(i32),
        "stdev_pos": stdev_pos,
        "stdev_len": stdev_len,
        "support": support,
        "lead_count": count,
        "qual": qual,
        "fwd": fwd,
        "rev": rev,
        "nm": nm_mean,
        "n_strands": n_strands,
    }
