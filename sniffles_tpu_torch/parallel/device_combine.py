"""
Host-vectorized multi-sample candidate grouping for the combine device
path: the streaming route, taken when the whole-task preplan does not
run (pipeline/tasks.py CombineTask._group_batch), and under --tpu-mesh N
the mesh-sharded safe-cut segmentation of each flush (mesh_block_groups).

Design: batches are coarsely segmented at sorted-position gaps larger
than combine_match_max — cuts the host greedy provably cannot merge
across — and the exact host greedy assignment
(cluster.resolve_block_groups, reference: cluster.py:356-390) then runs
independently inside each segment. The result is identical to the host
path by construction (including tie-breaking: see the output ordering
note below), while the quadratic candidate×group scan is confined to
tiny per-segment populations.

Copied from sniffles_tpu/parallel/device_combine.py, with the mesh half
(COMBINE_MESH_HALO_BP, COMBINE_MESH_RETRIES, run_mesh_combine,
mesh_block_groups). Unlike the JAX package, an ownership mismatch of the
mesh's answer raises (the JAX package logs it and takes the host path),
and a halo that still overflows after the retries raises
MeshHaloOverflow, for which the caller takes device_block_groups.
"""
from __future__ import annotations

import logging

import numpy as np

from sniffles_tpu_torch import cluster as cl
from sniffles_tpu_torch.parallel.device_call import MeshHaloOverflow, mesh_result

log = logging.getLogger(__name__)


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


# --------------------------------------------------------------------------
# Mesh-sharded combine (--tpu-mesh N in combine mode)

# halo ladder of the combine mesh step: W must exceed every safe segment's
# span; doubled on overflow (W is a run-time value of the step)
COMBINE_MESH_HALO_BP = 5000
COMBINE_MESH_RETRIES = 3


def run_mesh_combine(payload: dict, meta: dict) -> np.ndarray:
    """The sharded safe-cut segmentation (parallel/mesh.py
    build_sharded_combine_step with safe_cut_only) of the payload, in the
    process that owns the devices. Returns a (2, N) int32 array [orig_idx;
    segment] covering every valid candidate exactly once, or raises
    MeshHaloOverflow when the halo still overflows after the retries."""
    from sniffles_tpu_torch.parallel import mesh as meshmod
    n_dev = int(payload["n_dev"])
    step = meshmod.build_sharded_combine_step(
        meshmod.mesh_devices(n_dev), combine_match=float(meta["combine_match"]),
        combine_match_max=float(meta["combine_match_max"]), safe_cut_only=True,
        binsize=int(meta.get("binsize", 100)))
    window = int(payload["window_len"][0])
    # combine flushes can span only tens of kb, so the call step's default
    # would exceed the shard window outright; W need only exceed every
    # safe segment's span (overflow-checked)
    out, w = meshmod.retry_halo(
        lambda w: step(payload["cand"], payload["offsets"], payload["window_len"],
                       np.full((n_dev,), w, dtype=np.int32)),
        window, min(COMBINE_MESH_HALO_BP, max(window // 2, 1)), COMBINE_MESH_RETRIES)
    if out is None:
        raise MeshHaloOverflow(f"combine mesh halo overflow at W={w}bp (shard window "
                               f"{window}bp)")
    n_ext = out["pos"].shape[0] // n_dev
    gid = out["group_id"].reshape(n_dev, -1)
    gvalid = out["group_valid"].reshape(n_dev, -1)
    ovalid = out["valid"].reshape(n_dev, -1)
    oidx = out["orig_idx"].reshape(n_dev, -1)
    rows_list = []
    seg_base = 0
    for s in range(n_dev):
        owned = ovalid[s] & np.take(gvalid[s], np.clip(gid[s], 0, n_ext - 1))
        # segment ids made global per shard (gid is shard-local)
        rows_list.append(np.stack([oidx[s][owned], gid[s][owned] + seg_base]))
        seg_base += int(gid[s].max(initial=0)) + 1
    return np.concatenate(rows_list, axis=1).astype(np.int32)


def mesh_block_groups(svtype: str, svcands: list, groups_initial: list, config,
                      ed_cache=None, device=None):
    """Byte-exact combine grouping through the device mesh: the sharded
    safe-cut segmentation partitions this flush's candidates AND frontier
    groups over the genome axis, and the exact host greedy then runs per
    gathered segment (_greedy_by_segment restores the host's global
    order). Returns None when the mesh cannot take the flush (fewer than
    2 shards, or a shard window under 2 * (combine_match_max + 2)); raises
    MeshHaloOverflow when its halo does not cover a segment. `device`: a
    DeviceClient in a worker process, None runs the step in process.
    Reference analogue: the combine hot loop, parallel.py:444-566."""
    n_dev = int(getattr(config, "tpu_mesh", 0) or 0)
    if n_dev < 2:
        return None
    # rows: frontier groups (by evolving pos_mean) first, candidates after
    rows_pos = [int(g.pos_mean) for g in groups_initial] + [c.pos for c in svcands]
    rows_len = ([int(abs(g.len_mean)) for g in groups_initial]
                + [abs(c.svlen) if c.svlen else 0 for c in svcands])
    n_keep = len(groups_initial)
    n_rows = len(rows_pos)
    if n_rows == 0:
        return list(groups_initial)
    cand = {
        "pos": np.asarray(rows_pos, dtype=np.int32),
        "svlen": np.asarray(rows_len, dtype=np.int32),
        "svtype": np.zeros(n_rows, dtype=np.int32),  # one svtype per call
        "sample_id": np.zeros(n_rows, dtype=np.int32),
        "support": np.zeros(n_rows, dtype=np.int32),
        "qc": np.ones(n_rows, dtype=bool),
        "valid": np.ones(n_rows, dtype=bool),
        "orig_idx": np.arange(n_rows, dtype=np.int32),
    }
    order = np.argsort(cand["pos"], kind="stable")
    cand = {k: v[order] for k, v in cand.items()}

    # shard windows must be wide enough that a halo of at least the match
    # cap fits (a safe segment spans at least one match radius); smaller
    # flushes take the host-vectorized segmentation
    span = int(cand["pos"][-1]) - int(cand["pos"][0]) + 1
    window = -(-max(span, n_dev) // n_dev)
    if window < 2 * (float(config.combine_match_max) + 2):
        return None

    from sniffles_tpu_torch.parallel.combine_tensors import shard_candidate_tensors
    sharded, offsets, window_len = shard_candidate_tensors(cand, n_dev)
    payload = {"cand": sharded, "offsets": offsets, "window_len": window_len,
               "n_dev": n_dev}
    # +1: frontier rows carry int-truncated pos_means; widening the cut
    # threshold by a base pair only coarsens the partition (cuts stay
    # greedy-impermeable) while covering the sub-bp truncation error
    meta = {"combine_match": float(config.combine_match),
            "combine_match_max": float(config.combine_match_max) + 1.0,
            # the truncation-edge zone scales with the screening bin
            "binsize": int(config.cluster_binsize)}
    rows = (mesh_result(device.request("combine_mesh", payload, meta)) if device is not None
            else run_mesh_combine(payload, meta))
    oidx, seg = rows[0], rows[1]
    if len(oidx) != n_rows or len(set(oidx.tolist())) != n_rows:
        raise RuntimeError(f"mesh combine ownership mismatch: {len(oidx)} owned rows "
                           f"({len(set(oidx.tolist()))} distinct) for {n_rows}")

    seg_keeps: dict[int, list] = {}
    seg_cands: dict[int, list] = {}
    seg_order: list[int] = []
    # ascending original position order within and across segments
    for j, s in sorted(zip(oidx.tolist(), seg.tolist())):
        if s not in seg_keeps:
            seg_keeps[s] = []
            seg_cands[s] = []
            seg_order.append(s)
        if j < n_keep:
            seg_keeps[s].append(j)
        else:
            seg_cands[s].append(j - n_keep)
    log.debug(f"mesh combine segmentation: {len(seg_order)} segments over "
              f"{n_dev} shards ({svtype}, {len(svcands)} candidates, "
              f"{n_keep} frontier groups)")
    return _greedy_by_segment(svtype, svcands, groups_initial, config, ed_cache,
                              seg_keeps, seg_cands, seg_order)
