"""
Genome-sharded device steps over a mesh of torch devices (--tpu-mesh N).

The genome axis is sharded across the mesh's devices: each shard clusters
(or groups) the signatures of its own contiguous genome window, and the
shards meet only at the collectives:

  * a RAW-SIGNATURE halo exchange for clusters straddling shard
    boundaries: each shard sends the signatures of its last 2W bp to its
    right neighbour, which re-clusters the union, so merged boundary
    clusters carry exact statistics, not folded summaries;
  * two-window exactly-once ownership: the left shard suppresses clusters
    touching its last W bp (the right neighbour owns them); the right
    shard drops halo clusters that never reach within W of its own start
    (the left neighbour owned those);
  * a psum of candidate totals, and a pmin of each svtype's first
    position, from which every shard knows whether it holds the svtype's
    task-global head (the sweep's head mask);
  * an overflow flag per shard when the halo slots or the width W do not
    cover a cluster (sender-side and truncation-edge checks), so the
    caller retries with a doubled W or routes the task to the host.

Copied from sniffles_tpu/parallel/mesh.py: GENOME_AXIS, make_genome_mesh
(:43), build_sharded_step (:54, the fused engine's step),
build_sharded_assign (:161), build_sharded_combine_step (:334) and
shard_batch (:441).
The JAX package traces one shard_map program over a jax.sharding.Mesh;
here one process owns the mesh's devices, each shard's body runs as torch
ops on its own device, split at each collective, and the collectives are
tensor operations between the phases: ppermute to the right neighbour is
a copy of shard i-1's halo to shard i's device (shard 0 gets the last
shard's, masked off), psum and pmin reduce on the first shard's device
and copy back. Nothing waits for a device between the phases, so on a
host with several cards the shards' work overlaps. A shard's merge sweep
is the port's kernel (ops/clustering.merge_sweep), one launch pair per
shard, with the shard's head mask; a shard of the engine's step runs
parallel/engine.call_pipeline_step with its two kernels.

Which device holds each shard is decided in one place, mesh_devices.
"""
from __future__ import annotations

import os

import numpy as np

from sniffles_tpu_torch.config import FORCE_CPU_ENV

GENOME_AXIS = "genome"

# one torch device per shard, comma-separated, where fewer cards are
# visible than shards (for example "cuda:0,cuda:0,cuda:0,cuda:0"): the
# counterpart of XLA's --xla_force_host_platform_device_count
ENV_MESH_DEVICES = "SNIFFLES_TPU_MESH_DEVICES"

def _i32(x: int) -> int:
    """x wrapped to int32, as the JAX package's int32 scalar arithmetic."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def mesh_devices(n: int) -> list:
    """The torch device of each of the n shards: the CPU for every shard
    with SNIFFLES_TPU_FORCE_CPU; else the devices SNIFFLES_TPU_MESH_DEVICES
    names (exactly n); else cuda:0 ... cuda:n-1. Raises RuntimeError,
    naming n, the cards visible and the variable, when the mesh cannot
    be placed: the port never takes fewer shards or another device. The
    card count comes from NVML, so no CUDA context is created."""
    if n < 2:
        raise ValueError(f"a mesh needs at least 2 shards, got {n}")
    if os.environ.get(FORCE_CPU_ENV):
        return ["cpu"] * n
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    import torch
    visible = torch.cuda.device_count()
    named = os.environ.get(ENV_MESH_DEVICES, "")
    if named.strip():
        devices = [d.strip() for d in named.split(",") if d.strip()]
        if len(devices) != n:
            raise RuntimeError(f"--tpu-mesh {n}: {ENV_MESH_DEVICES}={named!r} names "
                               f"{len(devices)} device(s), {visible} card(s) are visible; it "
                               f"must name one device per shard")
        for d in devices:
            dev = torch.device(d)
            if dev.type != "cuda" or (dev.index or 0) >= visible:
                raise RuntimeError(f"--tpu-mesh {n}: {ENV_MESH_DEVICES} names {d!r}, but "
                                   f"{visible} card(s) are visible")
        return devices
    if visible < n:
        raise RuntimeError(
            f"--tpu-mesh {n} needs {n} devices, but {visible} card(s) are visible; set "
            f"{ENV_MESH_DEVICES} to one torch device per shard (for example "
            f"{','.join(['cuda:0'] * n)}) to place several shards on one card")
    return [f"cuda:{i}" for i in range(n)]


def make_genome_mesh(n_devices: int) -> list:
    """The mesh: one torch device per shard along GENOME_AXIS
    (mesh_devices)."""
    return mesh_devices(n_devices)


# -- the collectives, between the phases of the shards' bodies --------------

def _ppermute_right(values: list, devices: list) -> list:
    """ppermute over the ring i -> i + 1: shard i receives shard i - 1's
    value on its own device; shard 0 receives the last shard's (the
    wrap-around, which the receiver masks off)."""
    n = len(values)
    return [values[(i - 1) % n].to(devices[i]) for i in range(n)]


def _all_reduce(values: list, devices: list, reduce) -> list:
    """psum / pmin: `reduce` over the shards' values on the first shard's
    device, a copy on every shard's device."""
    import torch
    total = reduce(torch.stack([v.to(devices[0]) for v in values]))
    return [total.to(d) for d in devices]


def _psum_i32(values, devices):
    import torch
    return _all_reduce(values, devices, lambda x: x.sum(0, dtype=torch.int32))


def _pmin(values, devices):
    return _all_reduce(values, devices, lambda x: x.amin(0))


def _halo_order(pos, valid, my_end: int, w: int):
    """The halo a shard sends: its signatures in [my_end - 2W, my_end),
    sorted first by position (jnp.lexsort((pos, ~in_halo)), stable).
    Returns (in_halo, the permutation)."""
    import torch
    from sniffles_tpu_torch.ops.segments import lexsort
    in_halo = valid & (pos >= _i32(my_end - 2 * w))
    return in_halo, lexsort((pos, (~in_halo).to(torch.int32)))


def outgoing_halo(packed, my_end: int, w: int, halo_slots: int):
    """The halo a call step's shard sends right: the first halo_slots
    columns of its packed (15, S) batch in _halo_order, the valid row
    cleared outside the halo. Returns (halo (15, min(halo_slots, S)),
    overflow: more halo signatures than slots, a 0-d bool tensor)."""
    import torch
    in_halo, order = _halo_order(packed[0], packed[5] > 0, my_end, w)
    halo = packed[:, order][:, :halo_slots].clone()
    halo[5] = ((halo[5] > 0) & in_halo[order][:halo_slots]).to(torch.int32)
    return halo, in_halo.sum(dtype=torch.int32) > halo_slots


def _span_i32(hi, lo):
    """hi - lo in wrapping int32 arithmetic."""
    import torch
    wide = hi.to(torch.int64) - lo.to(torch.int64)
    return ((wide + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _ownership(pos_min, pos_max, is_group, my_start: int, my_end: int, w: int, i: int,
               n_dev: int, binsize: int):
    """Two-window exactly-once ownership of shard i's clusters (or groups)
    from their extents [pos_min, pos_max], and the invariant checks that
    force a retry (or the host). The shard suppresses the clusters touching
    its last W bp (its right neighbour owns them) and drops the halo
    clusters that never reach within W of its own start (its left
    neighbour owned them). A suppressed tail cluster wider than W is seen
    whole only by its sender; an owned cluster touching the received
    halo's first seed bin may reach past the truncation edge. Returns
    (owned, span_overflow: a 0-d bool tensor)."""
    suppress_tail = (pos_max >= _i32(my_end - w)) & (i < n_dev - 1)
    ghost = pos_max < _i32(my_start - w)
    owned = is_group & ~suppress_tail & ~ghost
    span_overflow = ((owned | (is_group & suppress_tail))
                     & (_span_i32(pos_max, pos_min) > w)).any()
    if i > 0:
        edge = _i32(my_start - 2 * w + binsize)
        span_overflow = span_overflow | (owned & (pos_min < edge)).any()
    return owned, span_overflow


def genome_windows(pos: np.ndarray, n_dev: int):
    """The split of a batch into n_dev contiguous genome windows of one
    width, from its positions: (each element's shard, the windows' starts
    [n_dev] int32, the width). An empty batch gives windows of width 1
    from 0."""
    n = pos.shape[0]
    lo = int(pos.min()) if n else 0
    span = max((int(pos.max()) - lo + 1) if n else 1, n_dev)
    window = -(-span // n_dev)
    shard_of = np.minimum((pos - lo) // window, n_dev - 1)
    return shard_of, lo + np.arange(n_dev, dtype=np.int32) * window, window


def retry_halo(step, window: int, w: int, retries: int):
    """step(W) from W = w, doubled while any shard reports halo_overflow,
    at most `retries` times and only while 2W <= window: the halo is a
    one-hop exchange, its source zone [my_end - 2W, my_end) must lie
    inside the sender's own window. Returns (the first output without
    overflow, or None, and the last W)."""
    for _ in range(retries):
        if 2 * w > window:
            break
        out = step(w)
        if not out["halo_overflow"].any():
            return out, w
        w *= 2
    return None, w


# -- the call step -----------------------------------------------------------

def build_sharded_assign(devices: list, *, cluster_r: float, cluster_repeat_h: float,
                         cluster_repeat_h_max: float, cluster_merge_bnd: int,
                         cluster_merge_len: float, minsvlen: int,
                         cluster_merge_pos: int = 150, global_repeat: bool = False,
                         binsize: int = 100, resplit_binsize: int = 20,
                         halo_slots: int = 512):
    """
    The multi-device version of the production call step (stage-1 cluster
    assignment plus per-cluster calling statistics), sharded over the
    genome axis with the raw-signature halo exchange and two-window
    exactly-once ownership (module docstring). The host materialises
    Cluster objects from the gathered assignment as in the single-device
    path (parallel/device_call.py).

    Returns run(shards, offsets, window_len, halo_w): shards (n_dev, 15,
    S) int32 in call_task_packed's row layout (rows 13-14 ride along
    unused), offsets, window_len and halo_w (n_dev, 1) int32 (the window
    starts, their lengths and the halo width W, a run-time value: a retry
    with a doubled W builds nothing). It returns numpy arrays:

      rows (n_dev, 13, halo_slots + S) int32: 0 cluster_id (shard-local),
        1 orig_idx, 2 owned_valid (element in a cluster this shard owns),
        3-11 per-cluster statistics (raw_pos_center, svlen, support,
        lead_count, fwd, rev, sum_mapq, pos_sum, support_sa: the JAX
        package's pre-resplit 9 rows), 12 cluster_owned;
      halo_overflow (n_dev,) bool, per shard: the halo slots or W did not
        cover a cluster.

    `resplit_binsize` and `cluster_merge_len` are accepted, as by the JAX
    function (the step does not resplit; the host does).
    """
    import torch
    from sniffles_tpu_torch.ops.clustering import (_exact_merge_sweep, call_statistics,
                                                   merge_inner_fold, packed_signatures,
                                                   sort_and_seed)
    from sniffles_tpu_torch.ops.segments import (INT32_MAX as MAX, INT32_MIN as MIN, seg_max,
                                                 seg_min, seg_sum, segment_ids_from_boundaries)

    n_dev = len(devices)
    i32 = torch.int32
    sweep = dict(cluster_r=cluster_r, cluster_repeat_h=cluster_repeat_h,
                 cluster_repeat_h_max=cluster_repeat_h_max,
                 cluster_merge_bnd=cluster_merge_bnd, global_repeat=global_repeat,
                 binsize=binsize)

    def run(shards, offsets, window_len, halo_w) -> dict:
        windows = [(int(offsets[i][0]), _i32(int(offsets[i][0]) + int(window_len[i][0])),
                    int(halo_w[i][0])) for i in range(n_dev)]
        packed = [torch.as_tensor(np.ascontiguousarray(shards[i]), dtype=i32).to(devices[i])
                  for i in range(n_dev)]

        # phase 1: each shard's outgoing halo
        halos, overflow = zip(*(outgoing_halo(p, my_end, w, halo_slots)
                                for p, (_, my_end, w) in zip(packed, windows)))

        # ppermute right; shard 0 masks off the wrap-around
        incoming = _ppermute_right(list(halos), devices)
        incoming[0] = incoming[0].clone()
        incoming[0][5] = 0
        ext = [torch.cat([incoming[i], packed[i]], dim=1) for i in range(n_dev)]

        # phase 2: each svtype's first position in the extended batch; the
        # pmin over the mesh says which shards hold the svtype's task-global
        # head (min is idempotent, so halo duplicates are safe): those
        # freeze it, as the task's single sweep would
        firsts = []
        for e in ext:
            valid = e[5] > 0
            t = torch.where(valid, e[2].clamp(0, 6), 7)
            firsts.append(seg_min(torch.where(valid, e[0], MAX), t, 8))
        global_first = _pmin(firsts, devices)

        # phase 3: cluster, fold, statistics, ownership
        rows, flags = [], []
        bit = torch.tensor([1 << b for b in range(8)], dtype=i32)
        for i, (my_start, my_end, w) in enumerate(windows):
            dev = devices[i]
            frozen = (firsts[i] == global_first[i]) & (firsts[i] < MAX)
            head_mask = (frozen.to(i32) * bit.to(dev)).sum(dtype=i32)
            s, seed_boundary, bin_ = sort_and_seed(packed_signatures(ext[i]), binsize)
            boundary = _exact_merge_sweep(s, seed_boundary, bin_, head_mask=head_mask,
                                          **sweep)
            cid = segment_ids_from_boundaries(boundary)
            cvalid = s["valid"]
            clustered = dict(s)
            clustered["cluster_id"] = cid
            clustered["n_clusters"] = torch.max(torch.where(cvalid, cid, -1)) + 1
            folded = merge_inner_fold(clustered, cluster_merge_pos=cluster_merge_pos,
                                      global_repeat=global_repeat)
            stats = call_statistics(folded)

            n = cid.shape[0]
            fcid, fvalid = folded["cluster_id"], folded["valid"]
            sum_mapq = seg_sum(torch.where(fvalid, folded["mapq"], 0), fcid, n)
            pos_sum = seg_sum(torch.where(fvalid, folded["pos"], 0), fcid, n)
            support_sa = seg_sum((fvalid & (folded["sa"] > 0)).to(i32), fcid, n)

            # ownership over PRE-fold cluster extents (the fold only affects
            # the calling statistics)
            pos = s["pos"]
            raw_min = seg_min(torch.where(cvalid, pos, MAX), cid, n)
            raw_max = seg_max(torch.where(cvalid, pos, MIN), cid, n)
            is_cluster = torch.arange(n, dtype=i32, device=dev) < clustered["n_clusters"]
            owned, span_overflow = _ownership(raw_min, raw_max, is_cluster, my_start, my_end,
                                              w, i, n_dev, binsize)
            owned_valid = cvalid & owned[cid.long().clamp(0, n - 1)]
            rows.append(torch.stack([
                cid.to(i32), s["orig_idx"].to(i32), owned_valid.to(i32),
                stats["raw_pos_center"], stats["svlen"], stats["support"].to(i32),
                stats["lead_count"].to(i32), stats["fwd"].to(i32), stats["rev"].to(i32),
                sum_mapq.to(i32), pos_sum.to(i32), support_sa.to(i32), owned.to(i32)]))
            flags.append(overflow[i] | span_overflow)

        return {"rows": np.stack([r.cpu().numpy() for r in rows]),
                "halo_overflow": np.array([bool(f) for f in flags])}

    return run


def shard_batch(batch_dict: dict, n_dev: int) -> dict:
    """Pad host arrays with zeros so the leading axis divides n_dev."""
    out = {}
    for k, v in batch_dict.items():
        pad = (-v.shape[0]) % n_dev
        if pad:
            v = np.concatenate([v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)])
        out[k] = v
    return out


_SIG_FIELDS = ("pos", "svlen", "svtype", "read_id", "strand", "mapq", "nm",
               "repeat", "sa", "valid")


def build_sharded_step(devices: list, params: dict | None = None, halo_bp: int = 5000,
                       halo_slots: int = 256, binsize: int = 100):
    """
    The multi-device fused calling step: each shard runs the engine's step
    (parallel/engine.call_pipeline_step) over its own signatures and the
    halo of its left neighbour, with the global coverage and NM means
    reduced over the mesh (psum) and two-window exactly-once ownership
    (module docstring).

    Contract: shard i's signatures lie in [offset_i, offset_i + L) where L
    is its coverage window's length (at least 2 * halo_bp + 1024, the
    coverage tail a shard sends); shards are contiguous along the genome.
    Exactness bound: halo_bp must exceed the span of any single cluster
    plus the coverage probe reach; halo_slots bounds the signatures within
    the last 2 * halo_bp bp of a shard (`halo_overflow` reports when either
    is exceeded).

    Returns run(sig, coverage, region_offset, info=None): sig a dict of
    [n_dev * S] arrays (_SIG_FIELDS, shard i's at [i * S, (i + 1) * S);
    shard_batch pads), coverage [n_dev * L] int32, region_offset [n_dev]
    int32. It returns numpy arrays, each shard's concatenated along the
    first axis as the JAX step's out_specs give them: every key of the
    engine's step ([n_dev * (halo_slots + S)]; n_clusters [n_dev]), with
    cluster_valid the clusters the shard owns, and halo_overflow,
    coverage_global and nm_global [n_dev]. `info`, a dict, receives each
    shard's relaxation rounds under "merge_rounds".

    The global means are float64 sums rounded once: the same on the card
    and the CPU; they differ from XLA's float32 reductions in the last
    bits (the tests hold them to 2^-20 relative).
    """
    import torch
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step, default_params

    if params is None:
        params = default_params()
    n_dev = len(devices)
    f32, f64 = torch.float32, torch.float64
    w = halo_bp
    cov_halo_len = 2 * w + 1024  # probe reach: updown_bins * binsize + slack

    def run(sig: dict, coverage, region_offset, info: dict | None = None) -> dict:
        per = len(sig["pos"]) // n_dev
        cov_len = len(coverage) // n_dev
        if cov_len < cov_halo_len:
            raise ValueError(f"a shard's coverage window of {cov_len} bp is shorter than the "
                             f"coverage tail it sends ({cov_halo_len} bp at halo_bp={w})")
        shards = [{k: torch.as_tensor(np.ascontiguousarray(sig[k][i * per:(i + 1) * per]))
                   .to(devices[i]) for k in _SIG_FIELDS} for i in range(n_dev)]
        covs = [torch.as_tensor(np.ascontiguousarray(coverage[i * cov_len:(i + 1) * cov_len]),
                                dtype=torch.int32).to(devices[i]) for i in range(n_dev)]

        # psum: the global coverage and NM means
        cov_means = [(c.sum(dtype=torch.int64).to(f64) / cov_len).to(f32) for c in covs]
        coverage_global = [(t.to(f64) / n_dev).to(f32) for t in
                           _all_reduce(cov_means, devices, lambda x: x.to(f64).sum(0))]
        nm_sums = [torch.where(sh["valid"], sh["nm"], 0.0).to(f64).sum() for sh in shards]
        nm_counts = [sh["valid"].sum().to(f64) for sh in shards]
        nm_total = _all_reduce(nm_sums, devices, lambda x: x.sum(0))
        nm_n = _all_reduce(nm_counts, devices, lambda x: x.sum(0))
        nm_global = [(a / torch.clamp(b, min=1.0)).to(f32) for a, b in zip(nm_total, nm_n)]

        # each shard's outgoing halo, then ppermute right
        windows = []
        halos, overflow = [], []
        for i, sh in enumerate(shards):
            my_start = _i32(int(region_offset[i]))
            my_end = _i32(my_start + cov_len)
            windows.append((my_start, my_end))
            in_halo, order = _halo_order(sh["pos"], sh["valid"], my_end, w)
            out = {k: v[order][:halo_slots] for k, v in sh.items()}
            out["valid"] = out["valid"] & in_halo[order][:halo_slots]
            halos.append(out)
            overflow.append(in_halo.sum(dtype=torch.int32) > halo_slots)
        incoming = [dict(zip(_SIG_FIELDS, vals)) for vals in zip(
            *(_ppermute_right([h[k] for h in halos], devices) for k in _SIG_FIELDS))]
        # shard 0 receives the wrap-around sender; mask it off
        incoming[0]["valid"] = torch.zeros_like(incoming[0]["valid"])
        cov_in = _ppermute_right([c[cov_len - cov_halo_len:] for c in covs], devices)
        cov_in[0] = torch.zeros_like(cov_in[0])

        parts, rounds = [], []
        for i, (my_start, my_end) in enumerate(windows):
            ext = {k: torch.cat([incoming[i][k], shards[i][k]]) for k in _SIG_FIELDS}
            ext_cov = torch.cat([cov_in[i], covs[i]])
            p = dict(params)
            p["coverage_global"] = coverage_global[i]
            p["qc_nm_threshold"] = nm_global[i]
            step_info = {}
            out = call_pipeline_step(ext, ext_cov, p, region_offset=_i32(my_start - cov_halo_len),
                                     binsize=binsize, device=devices[i], info=step_info)
            rounds.append(step_info["merge_rounds"])
            owned, span_overflow = _ownership(out["pos_min"], out["pos_max"],
                                              out["cluster_valid"], my_start, my_end, w, i,
                                              n_dev, binsize)
            out["cluster_valid"] = owned
            out["halo_overflow"] = overflow[i] | span_overflow
            out["coverage_global"] = coverage_global[i]
            out["nm_global"] = nm_global[i]
            parts.append({k: v.cpu().numpy() for k, v in out.items()})
        if info is not None:
            info["merge_rounds"] = [int(r) for r in rounds]
        return {k: np.concatenate([np.atleast_1d(pt[k]) for pt in parts]) for k in parts[0]}

    return run


# -- the combine step --------------------------------------------------------

_CAND_FIELDS = ("pos", "svlen", "svtype", "sample_id", "support", "qc", "valid",
                "orig_idx")


def build_sharded_combine_step(devices: list, combine_match: float = 250.0,
                               combine_match_max: float = 1000.0,
                               halo_slots: int = 256, safe_cut_only: bool = False,
                               binsize: int = 100):
    """
    Multi-sample combine over the mesh: each shard groups the candidates of
    its genome window (ops/combine_groups.group_candidates), the
    per-sample candidate totals reduce by a psum, and boundary groups use
    the call step's raw-candidate halo exchange and two-window ownership.
    safe_cut_only=True gives the mesh combine route's segmentation (cuts
    only at greedy-impermeable gaps; parallel/device_combine.py).

    Returns run(cand, region_offset, window_len, halo_w): cand a dict of
    [n_dev * S] arrays (_CAND_FIELDS; orig_idx optional), shard i's at
    [i * S, (i + 1) * S); region_offset, window_len and halo_w [n_dev]
    int32. It returns numpy arrays, each shard's concatenated along the
    first axis as the JAX step's out_specs give them: every column and
    statistic of group_candidates ([n_dev * (halo + S)]), n_groups,
    halo_overflow and global_candidates ([n_dev]), and group_valid (the
    groups this shard owns, at group slots).
    """
    import torch
    from sniffles_tpu_torch.ops.combine_groups import group_candidates
    from sniffles_tpu_torch.ops.segments import INT32_MAX as MAX, INT32_MIN as MIN, seg_max, seg_min

    n_dev = len(devices)
    i32 = torch.int32

    def run(cand: dict, region_offset, window_len, halo_w) -> dict:
        keys = [k for k in _CAND_FIELDS if k in cand]
        per = len(cand["pos"]) // n_dev
        shards = [{k: torch.as_tensor(np.ascontiguousarray(cand[k][i * per:(i + 1) * per]))
                   .to(devices[i]) for k in keys} for i in range(n_dev)]
        windows = [(int(region_offset[i]), _i32(int(region_offset[i]) + int(window_len[i])),
                    int(halo_w[i])) for i in range(n_dev)]
        totals = _psum_i32([c["valid"].sum(dtype=i32) for c in shards], devices)

        halos, overflow = [], []
        for c, (my_start, my_end, w) in zip(shards, windows):
            in_halo, order = _halo_order(c["pos"], c["valid"], my_end, w)
            out = {k: v[order][:halo_slots] for k, v in c.items()}
            out["valid"] = out["valid"] & in_halo[order][:halo_slots]
            halos.append(out)
            overflow.append(in_halo.sum(dtype=i32) > halo_slots)
        incoming = [dict(zip(keys, vals)) for vals in zip(
            *(_ppermute_right([h[k] for h in halos], devices) for k in keys))]
        incoming[0]["valid"] = torch.zeros_like(incoming[0]["valid"])

        parts = []
        for i, (my_start, my_end, w) in enumerate(windows):
            ext = {k: torch.cat([incoming[i][k], shards[i][k]]) for k in keys}
            out = group_candidates(ext, combine_match, combine_match_max,
                                   safe_cut_only=safe_cut_only)
            n = out["pos"].shape[0]
            gid, valid = out["group_id"], out["valid"]
            pos_max = seg_max(torch.where(valid, out["pos"], MIN), gid, n)
            pos_min = seg_min(torch.where(valid, out["pos"], MAX), gid, n)
            is_group = torch.arange(n, dtype=i32, device=gid.device) < out["n_groups"]
            group_valid, span_overflow = _ownership(pos_min, pos_max, is_group, my_start,
                                                    my_end, w, i, n_dev, binsize)
            out["group_valid"] = group_valid
            out["halo_overflow"] = overflow[i] | span_overflow
            out["global_candidates"] = totals[i]
            parts.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([np.atleast_1d(p[k]) for p in parts]) for k in parts[0]}

    return run
