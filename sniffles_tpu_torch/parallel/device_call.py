"""
Device-backed candidate grouping for the call path (on unless --no-tpu):
the sort-and-segment clustering (ops/clustering.call_task_packed) assigns
leads to clusters on the device; Cluster objects are materialized from
the assignment and flow through the exact host call/QC/genotype chain
(sv.call_from onward), so output semantics are the host's.

This replaces the sequential merge sweep of cluster.resolve
(reference: cluster.py:219-353) for INS/DEL/DUP/INV/BND; BND's
mate-geometry resplit and the single-break types stay on the host path.

Copied from sniffles_tpu/parallel/device_call.py: the packer, the
wire-compact response of the device service (compress_call_response),
the consumer, in process or through the device service of a worker
process, and the mesh half (--tpu-mesh N: pack_mesh_payload,
run_mesh_assign and the mesh branch of device_clusters, whose pre-resplit
statistics only single-child clusters consume). The hedge and its circuit
breaker are not ported, by design: they reroute a slow device response to
the host. Unlike the JAX package, a failure here raises; the routes that
exist for exactness (the per-child consumption gate, BND's host resplit,
the stats-capacity route of a task to the host sweep, and the mesh's
seam route, MeshHaloOverflow, for a cluster wider than the halo) stay,
each counted in `counters`.
"""
from __future__ import annotations

import logging
import os
import zlib

import numpy as np

from sniffles_tpu_torch.cluster import Cluster, merge_inner, resplit, resplit_bnd
from sniffles_tpu_torch.ops._call_consts import (SVTYPE_CODES, STATS_NC_ROW,
                                                 STATS_PARENT_ROW, STATS_UNCERTAIN_ROW,
                                                 split_call_task_output)

log = logging.getLogger(__name__)

# BND stage-1 merging (cluster_merge_bnd distance) runs on device; the
# mate-geometry resplit stays host-exact (reference: cluster.py:164-216).
_DEVICE_TYPES = ("INS", "DEL", "DUP", "INV", "BND")

# floor of the padded batch width: most tasks share one padded size (the
# JAX package compiles once per shape; kept so both packages pad alike)
DEVICE_BATCH_FLOOR = 8192

# packed batch rows (see pack_task_batch)
PACKED_ROWS = 15


def qname_hash31(qnames) -> np.ndarray:
    """Deterministic 31-bit read-name hash (zlib.crc32): stable across
    processes and PYTHONHASHSEED, capped below INT32_MAX (the invalid-slot
    sentinel of the masked sorts). A collision between two distinct reads
    in one cluster would undercount ``support`` (the unique-read count,
    reference: sv.py:520); the consumption gate in device_clusters
    therefore verifies the device count against the host's unique-NAME
    count before consuming it."""
    n = len(qnames)
    arr = np.fromiter((zlib.crc32(q.encode()) for q in qnames),
                      dtype=np.int64, count=n)
    return np.minimum(arr & 0x7FFFFFFF, 0x7FFFFFFE).astype(np.int32)


# the full hap domain: any other value (None, unparseable, out of range)
# maps to -9, so the device's hp_other tally forces the exact host vote
_HAP_MAP = {"0": 0, "1": 1, "2": 2}


def _ps_int(p) -> int:
    """Lead.phase_set (str(ps) or "NULL"/None) -> int; -1 = NULL, -9 =
    out-of-domain (a negative or non-integer PS string is a legitimate
    VOTE VALUE host-side, not a NULL — the packer downgrades the lead's
    hap to -9 as well, so hp_other forces the exact host vote)."""
    if p is None or p == "NULL":
        return -1
    try:
        v = int(p)
    except (TypeError, ValueError):
        return -9
    return v if v >= 0 else -9


def padded_width(n: int) -> int:
    """Kernel batch width for a task with n signatures: the floor, then
    powers of two."""
    size = DEVICE_BATCH_FLOOR
    while size < n:
        size *= 2
    return size


def pad_packed(packed: np.ndarray) -> np.ndarray:
    """Zero-pad a trimmed (PACKED_ROWS, n) batch to its kernel width."""
    n = packed.shape[1]
    size = padded_width(n)
    if size == n:
        return packed
    out = np.zeros((packed.shape[0], size), dtype=np.int32)
    out[:, :n] = packed
    return out


def compress_call_response(flat: np.ndarray, padded_n: int) -> dict:
    """Wire-compact form of a call_task result: only the valid elements
    (cluster_id, orig_idx — validity is implied) and the stats columns of
    real resplit children. The padded buffer is mostly zeros for a
    typical task, and pickling it costs as much as the request. `nc` (=
    n_children) and `slots` carry the capacity check (device_clusters
    routes the task to the host sweep when nc > slots)."""
    elements, stats = split_call_task_output(flat, padded_n)
    valid = elements[2] != 0
    n_children = int(stats[STATS_NC_ROW][0])
    slots = stats.shape[1]
    keep = min(max(n_children, 1), slots)
    return {
        "nc": n_children,
        "slots": slots,
        "elems": np.ascontiguousarray(elements[:2, valid]),
        "stats": np.ascontiguousarray(stats[:STATS_NC_ROW, :keep]),
    }


def standard_call_meta(config) -> dict:
    """The scalar parameters of call_task_packed for a run (a copy of
    sniffles_tpu/parallel/device_service.py::standard_call_meta)."""
    return dict(
        cluster_r=float(config.cluster_r),
        cluster_repeat_h=float(config.cluster_repeat_h),
        cluster_repeat_h_max=float(config.cluster_repeat_h_max),
        cluster_merge_bnd=int(config.cluster_merge_bnd),
        cluster_merge_len=float(config.cluster_merge_len),
        minsvlen=int(config.minsvlen),
        cluster_merge_pos=int(config.cluster_merge_pos),
        global_repeat=bool(config.repeat),
        binsize=int(config.cluster_binsize),
        resplit_binsize=int(config.cluster_resplit_binsize),
    )


def pack_task_batch(lead_provider, config, tr):
    """Flatten the leadtab (reference layout: leadprov.py:400-418) into
    the packed (15, n) int32 signature batch the call_task step consumes,
    plus the host-side context needed to materialize clusters from its
    output. Returns None when the task has no device-eligible leads."""
    leads = []
    lead_bins = []
    for svtype in _DEVICE_TYPES:
        for bin_pos, bin_leads in lead_provider.leadtab[svtype].items():
            # seeds below the minimum never form clusters (cluster.py:262);
            # for INS the host counts only svlen-carrying leads (soft-clip
            # evidence is the leads_long side channel, cluster.py:231-235)
            if svtype == "INS":
                n_countable = sum(1 for ld in bin_leads if ld.svlen is not None)
            else:
                n_countable = len(bin_leads)
            if n_countable < config.dev_min_leads_cluster:
                continue
            for ld in bin_leads:
                if ld.svlen is None:
                    continue
                leads.append(ld)
                lead_bins.append(bin_pos)
    if not leads:
        return None

    n = len(leads)

    tr_sorted = sorted(tr) if tr else []
    tr_starts = np.array([s for s, e in tr_sorted], dtype=np.int64)
    tr_ends = np.array([e for s, e in tr_sorted], dtype=np.int64)

    # one packed (15, n) int32 buffer, TRIMMED to the real signature
    # count (the caller pads it to padded_width(n)). Rows: pos, svlen,
    # svtype, orig_idx, repeat, valid, strand, mapq, read_id (name hash —
    # support = unique reads), is_sa (split-read evidence), ref_end,
    # qry_start, qry_end (the merge_inner fold anchors, reference:
    # cluster.py:105-119), hap, ps (the phase-vote inputs, reference:
    # postprocessing.py:626-654).
    packed = np.zeros((PACKED_ROWS, n), dtype=np.int32)
    packed[0, :n] = [ld.ref_start for ld in leads]
    packed[1, :n] = [ld.svlen for ld in leads]
    packed[2, :n] = [SVTYPE_CODES[ld.svtype] for ld in leads]
    packed[3, :n] = np.arange(n, dtype=np.int32)
    packed[5, :n] = 1
    packed[6, :n] = [1 if ld.strand == "+" else -1 for ld in leads]
    packed[7, :n] = [ld.mapq if ld.mapq is not None else 0 for ld in leads]
    packed[8, :n] = qname_hash31([ld.read_qname for ld in leads])
    packed[9, :n] = [ld.source != "INLINE" for ld in leads]
    packed[10, :n] = [ld.ref_end if ld.ref_end is not None else 0 for ld in leads]
    packed[11, :n] = [ld.qry_start if ld.qry_start is not None else 0 for ld in leads]
    packed[12, :n] = [ld.qry_end if ld.qry_end is not None else 0 for ld in leads]
    # hap/ps are STRINGS on the Lead ('0'/'1'/'2', str(ps) or "NULL");
    # encode: hap int (-9 for None/unparseable -> device hp_other ->
    # host phase vote), ps int with -1 = NULL. Dict lookups memoize the
    # int parses (PS strings repeat massively within a task).
    ps_cache: dict = {None: -1, "NULL": -1}
    packed[13, :n] = [_HAP_MAP.get(ld.hap, -9) for ld in leads]
    packed[14, :n] = [ps_cache[p] if p in ps_cache
                      else ps_cache.setdefault(p, _ps_int(p))
                      for p in (ld.phase_set for ld in leads)]
    # out-of-domain ps: poison hap too so hp_other forces the host vote
    bad_ps = packed[14, :n] == -9
    if bad_ps.any():
        packed[13, :n][bad_ps] = -9
    if len(tr_starts):
        idx = np.searchsorted(tr_starts, packed[0, :n], side="right") - 1
        packed[4, :n] = ((idx >= 0) & (packed[0, :n] < tr_ends[np.clip(idx, 0, len(tr_ends) - 1)]))

    return packed, standard_call_meta(config), leads, lead_bins


def pack_mesh_payload(pack, n_dev: int) -> dict:
    """Re-shard a single-device packed batch into n_dev contiguous genome
    windows for the mesh call step (parallel/mesh.py
    build_sharded_assign). Each shard keeps the full padded width."""
    from sniffles_tpu_torch.parallel.mesh import genome_windows
    packed, meta, leads, lead_bins = pack
    n = len(leads)
    size = padded_width(n)
    shard_of, offsets, window = genome_windows(packed[0, :n], n_dev)

    shards = np.zeros((n_dev, packed.shape[0], size), dtype=np.int32)
    for shard in range(n_dev):
        sel = np.nonzero(shard_of == shard)[0]
        shards[shard, :, :len(sel)] = packed[:, sel]
    offsets = offsets.reshape(n_dev, 1)
    window_len = np.full((n_dev, 1), window, dtype=np.int32)
    return {"shards": shards, "offsets": offsets, "window_len": window_len,
            "n_dev": n_dev}


# halo width of the mesh call step: it must exceed any cluster's span and
# merge reach; doubled on overflow (W is a run-time value of the step)
# before the task takes the host sweep
MESH_HALO_BP = 5000
MESH_HALO_RETRIES = 3

# a test hook: every mesh call step reports an exhausted halo
ENV_FORCE_OVERFLOW = "SNIFFLES_TPU_MESH_FORCE_OVERFLOW"

# the key of a device service's answer to a mesh request whose halo
# overflowed (serve_mesh): the error crosses the pipe as a result, so the
# task can tell the seam route from a device error
MESH_OVERFLOW_KEY = "mesh_halo_overflow"


class MeshHaloOverflow(RuntimeError):
    """A mesh step's halo did not cover a cluster at any admissible width:
    a cluster spans more than W bp, or more signatures lie in a shard's
    last 2W bp than the halo has slots, and W cannot double past half the
    shard window (the halo is one hop). The caller takes its exact host
    route for the task (the JAX package's seam repair); this is no device
    error."""


def serve_mesh(run, payload, meta):
    """A device service's answer to a mesh request: run(payload, meta), or
    {MESH_OVERFLOW_KEY: message} when its halo overflowed."""
    try:
        return run(payload, meta)
    except MeshHaloOverflow as e:
        return {MESH_OVERFLOW_KEY: str(e)}


def mesh_result(out):
    """The rows of a mesh request's answer (serve_mesh); raises
    MeshHaloOverflow for the overflow answer."""
    if isinstance(out, dict) and MESH_OVERFLOW_KEY in out:
        raise MeshHaloOverflow(out[MESH_OVERFLOW_KEY])
    return out


def run_mesh_assign(payload: dict, meta: dict) -> np.ndarray:
    """The mesh call step on the payload's shards (pack_mesh_payload), in
    the process that owns the devices (mesh.mesh_devices): the device
    service, the daemon, or the CLI at --threads 0. Retries with a
    doubled halo width while a shard reports overflow; returns the
    (n_dev, 13, N_ext) rows, or raises MeshHaloOverflow once W would
    pass half the shard window or the retries are spent."""
    if os.environ.get(ENV_FORCE_OVERFLOW):
        raise MeshHaloOverflow(f"mesh halo overflow (forced by {ENV_FORCE_OVERFLOW}); "
                               f"the host sweep takes this task")
    from sniffles_tpu_torch.parallel import mesh as meshmod
    n_dev = int(payload["n_dev"])
    fn = meshmod.build_sharded_assign(meshmod.mesh_devices(n_dev), **meta)
    window = int(payload["window_len"][0, 0])
    out, w = meshmod.retry_halo(
        lambda w: fn(payload["shards"], payload["offsets"], payload["window_len"],
                     np.full((n_dev, 1), w, dtype=np.int32)),
        window, MESH_HALO_BP, MESH_HALO_RETRIES)
    if out is not None:
        return out["rows"]
    raise MeshHaloOverflow(f"mesh halo overflow at W={w}bp (shard window {window}bp); "
                           f"the host sweep takes this task")


def _mesh_groups(rows: np.ndarray, leads, lead_bins) -> list:
    """(None, member indices, pre-resplit stats9) per owned cluster of the
    mesh step's (n_dev, 13, N_ext) rows, in the host's cluster order
    (svtype, then seed bin); exactly-once ownership puts each element in
    one shard's owned cluster."""
    ordered = []
    for shard_rows in rows:
        groups: dict[int, list[int]] = {}
        for cid, li, ok in zip(shard_rows[0].tolist(), shard_rows[1].tolist(),
                               shard_rows[2].tolist()):
            if ok:
                groups.setdefault(cid, []).append(li)
        for cid, member_idx in groups.items():
            stats9 = tuple(int(shard_rows[3 + r][cid]) for r in range(9))
            svcode = SVTYPE_CODES[leads[member_idx[0]].svtype]
            seed = min(lead_bins[i] for i in member_idx)
            ordered.append(((svcode, seed), member_idx, stats9))
    ordered.sort(key=lambda item: item[0])
    return [(None, m, st) for _, m, st in ordered]


def _rebuild_groups(cids: np.ndarray, ridx: np.ndarray) -> list:
    """(cluster_id, member_index_list) per cluster, ascending cluster id
    == (svtype, pos) sort order == the host sweep's cluster order (seed
    bins ascending per svtype). Members keep element order within a
    cluster (stable sort), matching the host's per-cluster lead order."""
    if len(cids) == 0:
        return []
    order = np.argsort(cids, kind="stable")
    sc = cids[order]
    sr = ridx[order]
    bounds = np.flatnonzero(np.diff(sc)) + 1
    starts = np.concatenate(([0], bounds))
    uniq = sc[starts]
    members = np.split(sr, bounds)
    return [(int(c), m.tolist()) for c, m in zip(uniq, members)]


def _children_by_parent(stats: np.ndarray, n_children: int) -> dict:
    """Child-indexed stats block (call_task_packed rows: 0-17 calling
    stats + phase tallies, 18 parent cluster id, 19 resplit-ambiguity
    flag) -> {parent_cluster_id: [(stats18, uncertain), ...] in
    ascending child-id order}. Both the device resplit and the host's
    cluster.resplit order a parent's children by ascending svlen bin,
    so the k-th device child corresponds to the k-th host child."""
    out: dict[int, list] = {}
    k = min(max(n_children, 0), stats.shape[1])
    if k == 0:
        return out
    parents = stats[STATS_PARENT_ROW, :k].tolist()
    uncertain = stats[STATS_UNCERTAIN_ROW, :k].tolist()
    cols = stats[:18, :k].T.tolist()
    for parent, unc, col in zip(parents, uncertain, cols):
        out.setdefault(int(parent), []).append((tuple(col), bool(unc)))
    return out


def _bump(counters, key, d=1):
    if counters is not None:
        counters[key] = counters.get(key, 0) + d


def run_call_task(packed: np.ndarray, meta: dict, device) -> dict:
    """call_task_packed of one trimmed batch on `device`, in process; the
    result in the device service's wire-compact form
    (compress_call_response), so device_clusters decodes one format."""
    import torch
    from sniffles_tpu_torch.ops.clustering import call_task_packed
    padded = pad_packed(packed)
    batch = torch.from_numpy(padded).to(device)
    return compress_call_response(call_task_packed(batch, **meta).cpu().numpy(),
                                  padded.shape[1])


def device_clusters(lead_provider, config, tr, device=None, posted=None, counters=None):
    """
    Clusters of one task for INS/DEL/DUP/INV/BND, built from the device
    clustering assignment; the caller handles the single-break types with
    the host path. An empty list when the task has no device-eligible
    leads; None when the task has more resplit children than the stats
    block holds, and then the caller runs the exact host sweep for every
    type (counted as fb_capacity). With --tpu-mesh N (N > 1) the step is
    the mesh's (run_mesh_assign; mesh_tasks counts the task), and a halo
    that does not cover a cluster raises MeshHaloOverflow, for which the
    caller runs the exact host sweep.

    `device`: a DeviceClient when running inside a worker process (the
    parent owns the device and answers over the task pipe); None runs the
    step in process, on config.device. Both give the wire-compact
    response (compress_call_response). `posted`: optional (req_id, pack) pair
    from the decode-ahead thread that already posted this task's batch
    to the device service (Task.maybe_post_device). A device error or a
    response that does not come within DeviceClient.TIMEOUT raises.

    `counters`: optional dict accumulating the engine-stat consumption
    split per task — device_tasks, clusters_total, children_total,
    engine_consumed, and the exactness routes (fb_bnd, fb_resplit,
    fb_multi_fragment, fb_support_collision, fb_capacity).
    """
    mesh_n = int(getattr(config, "tpu_mesh", 0) or 0)
    if posted is not None:
        req_id, pack = posted
        if pack is None:
            return []
        try:
            out = device.wait(req_id)
        except TimeoutError:
            device.discard(req_id)   # a late response is dropped on arrival
            raise
    else:
        pack = pack_task_batch(lead_provider, config, tr)
        if pack is None:
            return []
        if mesh_n > 1:
            payload = pack_mesh_payload(pack, mesh_n)
            out = (device.request("call_task_mesh", payload, pack[1]) if device is not None
                   else run_mesh_assign(payload, pack[1]))
        elif device is not None:
            out = device.request("call_task", pack[0], pack[1])
        else:
            out = run_call_task(pack[0], pack[1], config.device)
    packed, meta, leads, lead_bins = pack
    if mesh_n > 1:
        rows = mesh_result(out)
        _bump(counters, "device_tasks")
        _bump(counters, "mesh_tasks")
        return list(_materialize(lead_provider, config, packed, leads, lead_bins,
                                 _mesh_groups(rows, leads, lead_bins), {}, counters))
    _bump(counters, "device_tasks")

    n_children, slots = out["nc"], out["slots"]
    # the stats block holds max(1024, N//8) child slots; a task with more
    # resplit children than slots goes to the exact host sweep
    if n_children > slots:
        log.info(f"device stats capacity exceeded ({n_children} children > "
                 f"{slots} slots); host sweep for this task")
        _bump(counters, "fb_capacity")
        return None
    elems = out["elems"]
    groups = [(cid, m, None) for cid, m in _rebuild_groups(elems[0], elems[1])]
    return list(_materialize(lead_provider, config, packed, leads, lead_bins, groups,
                             _children_by_parent(out["stats"], n_children), counters))


def _materialize(lead_provider, config, packed, leads, lead_bins, groups,
                 child_stats, counters):
    """Cluster objects from the device assignment, with the device's
    statistics attached where the host verifies them. `groups`: (cluster
    id, member indices, stats9) per cluster in the host's cluster order;
    `child_stats` the per-child statistics by cluster id
    (_children_by_parent), or the mesh's pre-resplit stats9 of each
    cluster, which only a single-child cluster consumes (no phase
    tallies: the host votes)."""
    n = len(leads)
    repeat_flags = packed[4, :n] > 0

    # leads_long per INS cluster: long-INS soft clips from the bins the
    # cluster's leads came from (reference: cluster.py:248-250)
    long_by_bin: dict[int, list] = {}
    for bin_pos, bin_leads in lead_provider.leadtab["INS"].items():
        longs = [ld for ld in bin_leads if ld.svlen is None]
        if longs:
            long_by_bin[bin_pos] = longs

    hap_ref = lead_provider.leadhapcount["REF"]

    for cid, member_idx, legacy_stats9 in groups:
        cluster_leads = [leads[i] for i in member_idx]
        if len(cluster_leads) < config.dev_min_leads_cluster:
            continue
        svtype = cluster_leads[0].svtype
        bins = sorted({lead_bins[i] for i in member_idx})
        seed = bins[0]

        leads_long = None
        if svtype == "INS":
            leads_long = []
            for b in bins:
                leads_long.extend(long_by_bin.get(b, []))

        # host-exact hap counts: the SEED BIN's tallies on both the SV and
        # REF sides (reference semantics via _seed_clusters, cluster.py:238-244
        # — the sweep does not re-fold counts when absorbing neighbors), NOT
        # a recount over the merged cluster. rescue_phasing's in-phase ratio
        # (tasks.py) is computed from these, so a recount flips rescues.
        sv_h = lead_provider.leadhapcount[svtype].get(seed, (0, 0, 0))
        hp_counts = hap_ref.get(seed, [0, 0, 0])
        hap_counts_full = (sv_h[0], sv_h[1], sv_h[2],
                           hp_counts[0], hp_counts[1], hp_counts[2])

        within_repeat = any(repeat_flags[i] for i in member_idx)
        cluster = Cluster(
            id=f"CL.{svtype}.{lead_provider.contig}.{lead_provider.start}.D{seed}",
            svtype=svtype,
            contig=lead_provider.contig,
            start=seed,
            end=bins[-1] + config.cluster_binsize,
            seed=seed,
            leads=cluster_leads,
            repeat=within_repeat or config.repeat,
            leads_long=leads_long,
            hap_counts=hap_counts_full,
        )

        _bump(counters, "clusters_total")
        if svtype == "BND":
            # host-exact resplit by (mate contig, orientation, mate pos bin)
            _bump(counters, "fb_bnd")
            if config.dev_no_resplit:
                yield cluster
            else:
                yield from resplit_bnd(cluster, merge_threshold=config.cluster_merge_bnd)
            continue

        # per-read inner merge of fragmented INS/DEL, host-exact
        # (reference: cluster.py:337-343)
        if svtype in ("INS", "DEL"):
            threshold = -1 if cluster.repeat else config.cluster_merge_pos
            merge_inner(cluster, threshold)

        # svlen-histogram resplit, host-exact and in reference order
        # (reference: cluster.py:330-339)
        if config.dev_no_resplit_repeat or config.dev_no_resplit:
            children = [cluster]
        else:
            children = list(resplit(cluster,
                                    prop=lambda lead: lead.svlen,
                                    binsize=config.cluster_resplit_binsize,
                                    merge_threshold_min=config.minsvlen,
                                    merge_threshold_frac=config.cluster_merge_len))
        _bump(counters, "children_total", len(children))

        # Device-computed calling statistics (integer-exact robust centers
        # and counts), computed on the device AFTER its merge_inner fold
        # and its svlen resplit — one stats column PER RESPLIT CHILD. The
        # host still materializes the merged Lead objects, runs its own
        # exact resplit, and VERIFIES per child that the device produced
        # the same grouping before consuming the stats: child count per
        # parent, folded lead count, the int32-wrapping sum of folded head
        # positions, and the unique read-NAME count vs the device's
        # unique-hash `support` must all match — any divergence (or the
        # float32 resplit-ambiguity flag) leaves the affected children to
        # the exact host computation.
        if legacy_stats9 is not None:
            dev_children = ([(tuple(legacy_stats9) + (None,) * 9, False)]
                            if len(children) == 1 else None)
        else:
            dev_children = child_stats.get(cid)
            if dev_children is not None and len(dev_children) != len(children):
                dev_children = None
        if dev_children is None or any(unc for _, unc in dev_children):
            _bump(counters, "fb_resplit", len(children))
            yield from children
            continue

        for host_child, (st, _unc) in zip(children, dev_children):
            (raw_pos_center, svlen_center, support, lead_count, fwd, rev,
             sum_mapq, pos_sum, support_sa) = st[:9]
            host_pos_sum = sum(ld.ref_start for ld in host_child.leads)
            fold_ok = (lead_count == len(host_child.leads)
                       and (host_pos_sum - pos_sum) % (1 << 32) == 0)
            support_ok = (fold_ok and support ==
                          len({ld.read_qname for ld in host_child.leads}))
            if fold_ok and support_ok:
                host_child.engine = {
                    "raw_pos_center": raw_pos_center,
                    "svlen_center": svlen_center,
                    "support": support,
                    "lead_count": lead_count,
                    "fwd": fwd,
                    "rev": rev,
                    "qual": sum_mapq // lead_count,
                    # DEL genotyper split-read support (reference:
                    # sv.py:580-581)
                    "support_sa": support_sa,
                    # phase-vote tallies (postprocess.phase_sv consumes
                    # these instead of iterating the leads; None, from
                    # the mesh, leaves the vote to the host)
                    "phase": st[9:18] if legacy_stats9 is None else None,
                }
                _bump(counters, "engine_consumed")
            else:
                _bump(counters, "fb_support_collision" if fold_ok else "fb_multi_fragment")
        yield from children
