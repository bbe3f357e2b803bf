"""
The per-cluster calling statistics of a clustered batch (reference:
sv.py:497-598 call_from): the JAX package's jitted call_statistics
(sniffles_tpu/ops/clustering.py:1262). Three callers: each call task's
device step (ops/clustering._task_statistics), the call path's sharded
step (parallel/mesh.py) and the fused engine (parallel/engine.py,
fused=True).

`call_statistics` is the wrapper: on CPU tensors the plain version
(`call_statistics_plain`, torch ops), on CUDA tensors the kernels of
csrc/call_stats.cu around one stable sort in torch, or an exception. The
sort is of the keys of `sort_keys` (a valid element's cluster id, an
invalid element's raw id r as n + r; `sorted_ids`); it puts each
cluster's elements together in array order, and the invalid elements
after them by raw id. The kernels: the keys (stat_keys), a run pass over
the sorted keys that writes every slot's run start and invalid mark
(stat_runs, balanced along the merge path; nothing is zeroed ahead of
it), then each live cluster gathers its values through the permutation
and sorts them on chip, by a thread (at most TINY_MAX elements, in
registers), a warp (at most WARP_MAX, in shared memory) or a block (in
shared memory up to BLOCK_MAX elements, past it in a global scratch
buffer); no host synchronisation, no cap on a cluster's size. The
thresholds are built into the kernels (nvcc_defines).

The float32 sums are XLA's: term by term in float32, s1 and s2 in the
cluster's sorted order, the mapq and NM sums in array order
(ops/segments.py). The plain version's index_add_ adds in those orders on
the CPU; on the card it adds with atomics, so the kernels are held against
the plain version on CPU copies of the same inputs, and against the card's
in the integer keys.
"""
from __future__ import annotations

import ctypes

import torch

from sniffles_tpu_torch.ops._call_consts import SVTYPE_CODES
from sniffles_tpu_torch.ops.segments import (INT32_MAX, INT32_MIN, lexsort, seg_count,
                                             seg_max, seg_mean, seg_min, seg_sum,
                                             unique_count_per_segment)
from sniffles_tpu_torch.ops.stats import seg_median_modes, seg_trimmed_stdev

SVTYPE_INS, SVTYPE_DEL = SVTYPE_CODES["INS"], SVTYPE_CODES["DEL"]

# Launches by the wrapper (call_statistics): "launches" one a call, and one
# a call for each kernel of csrc/call_stats.cu (the sort's keys, the run
# pass, the slot pass with the thread tier, the warp tier, the block tier);
# it adds to them only where it launches the kernels.
KERNELS = ("stat_keys", "stat_runs", "stat_slots", "stat_warps", "stat_blocks")
# the kernels' slot count is below it: an invalid mark's key n + r fits int32
MAX_SLOTS = 1 << 30
COUNTS = {"launches": 0, **{k: 0 for k in KERNELS}}

# The tiers by a cluster's element count, chosen on the card by
# tools/time_call_stats.py (PERF.md) and built into the kernels as -D flags
# (nvcc_defines): a thread a cluster up to TINY_MAX (at most the kernel's 8
# registers a list), a warp up to WARP_MAX (12 bytes an element of the
# warp's slice of shared memory; up to PAIR_MAX, 0 or 64, in two registers
# a lane instead), a block beyond, its lists in dynamic shared memory up to
# BLOCK_MAX elements (16 bytes each: three blocks an SM fit the H100's
# shared memory) and in global scratch past it.
TINY_MAX = 8
PAIR_MAX = 64
WARP_MAX = 256
BLOCK_MAX = 4096
TIERS = (TINY_MAX, PAIR_MAX, WARP_MAX, BLOCK_MAX)

# The -D flag of the build whose warp and block tiers sum a cluster's
# cycles by part (csrc/call_stats.cu's StatClock), read by stat_clocks:
# CLOCK_PARTS words a tier, then its clusters (tools/time_call_stats.py
# --split).
CLOCKS = "-DSTAT_CLOCKS"
CLOCK_TIERS = ("stat_warps", "stat_blocks")
CLOCK_PARTS = ("entry", "gather", "sort", "medians", "chains", "write", "wait")
# The launches of the entry point up to the run pass, in order, and the -D
# flag of a variant that returns after the k-th of them (tools/
# time_call_stats.py: the run pass alone; no memset runs ahead of it).
RUN_PARTS = ("run pass",)


def run_parts_define(k: int) -> str:
    """The -D flag of the entry point's variant that returns after the
    k-th launch of RUN_PARTS (1 to len(RUN_PARTS))."""
    if not 1 <= k <= len(RUN_PARTS):
        raise ValueError(f"the run pass has parts 1 to {len(RUN_PARTS)}, not {k}")
    return f"-DSTAT_RUN_PARTS={int(k)}"

# the output keys after n_clusters, in the order of the kernel's 16 rows of
# one int32 tensor (the float32 keys are rows of their bits)
KEYS = ("svtype", "svlen", "pos", "end", "raw_pos_center", "pos_min", "pos_max",
        "stdev_pos", "stdev_len", "support", "lead_count", "qual", "fwd", "rev", "nm",
        "n_strands")
FLOAT_KEYS = ("stdev_pos", "stdev_len", "nm")
# the int32 columns of the clustered batch the statistics read
INT_COLUMNS = ("cluster_id", "pos", "svlen", "read_id", "mapq", "strand", "svtype")


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def call_statistics_plain(clustered: dict, fused: bool = False) -> dict:
    """
    Per-cluster calling statistics (reference: sv.py:497-598 call_from):
    svlen/pos centers via median_modes, trimmed stdevs, support as
    unique read count, mean mapq, strand counts, mean NM, PRECISE flag
    inputs. Results are [N]-shaped, indexed by cluster id. fused=True
    gives the stdevs of the JAX package's jitted fused step
    (ops/segments.seg_stdev).
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
    stdev_len = seg_trimmed_stdev(svlen_s, cid_l, valid_l, n, fused)
    stdev_pos = seg_trimmed_stdev(pos_s, cid_p, valid_p, n, fused)
    support = unique_count_per_segment(cid_r, read_s, valid_r, n)

    count = seg_count(cid, valid, n)
    qual = torch.floor(seg_mean(clustered["mapq"], cid, valid, n)).to(i32)
    fwd = seg_sum((valid & (clustered["strand"] > 0)).to(i32), cid, n)
    rev = count - fwd
    nm_mean = seg_mean(clustered["nm"], cid, valid, n)
    n_strands = torch.where((fwd > 0) & (rev > 0), 2, torch.where(count > 0, 1, 0)).to(i32)

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


def call_statistics(clustered: dict, fused: bool = False) -> dict:
    """The statistics of call_statistics_plain: on CPU tensors the plain
    version, on CUDA tensors the kernels (launch_call_statistics), on any
    other device an exception."""
    dev = clustered["pos"].device
    if dev.type == "cpu":
        return call_statistics_plain(clustered, fused)
    if dev.type != "cuda":
        raise ValueError(f"no call-statistics kernel for device {dev}")
    out = launch_call_statistics(clustered, fused)
    if clustered["pos"].shape[0]:
        for k in COUNTS:
            COUNTS[k] += 1
    return out


def sort_keys_plain(clustered: dict) -> torch.Tensor:
    """The plain PyTorch version of the kernel stat_keys: int32 [n] keys,
    a valid element's cluster id c in [0, n) as c, an invalid element's raw
    id r in [0, n) as n + r, any other element INT32_MAX."""
    cid, valid = clustered["cluster_id"], clustered["valid"]
    n = cid.shape[0]
    inside = (cid >= 0) & (cid < n)
    return torch.where(inside, torch.where(valid, cid, cid + n), INT32_MAX).to(torch.int32)


def sort_keys(clustered: dict) -> torch.Tensor:
    """The sort's keys (sort_keys_plain): on CPU tensors the plain version,
    on CUDA tensors the kernel stat_keys on the current stream (int32
    cluster_id and bool valid, contiguous; n below MAX_SLOTS), or an
    exception. Counts nothing."""
    cid, valid = clustered["cluster_id"], clustered["valid"]
    if not cid.is_cuda:
        return sort_keys_plain(clustered)
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    n = cid.shape[0]
    if n >= MAX_SLOTS:
        raise ValueError(f"call_statistics: {n} slots, the kernels take fewer than {MAX_SLOTS}")
    if cid.dtype != torch.int32 or valid.dtype != torch.bool or not (
            cid.is_contiguous() and valid.is_contiguous()):
        raise ValueError("stat_keys takes contiguous int32 cluster ids and bool valid flags")
    keys = torch.empty_like(cid)
    if n:
        fn = _build.load("call_stats").sort_keys
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        # a bool is one byte, 0 or 1: the kernel reads valid as its bytes
        rc = _launch(fn, cid.device, cid.data_ptr(), valid.view(torch.uint8).data_ptr(),
                     keys.data_ptr(), n)
        if rc != 0:
            raise RuntimeError(f"stat_keys launch failed with CUDA error {rc}")
    return keys


def sorted_ids(clustered: dict) -> tuple:
    """The wrapper's one sort: (sorted keys, permutation) of the stable
    sort of sort_keys. Each cluster's elements are one run, in array
    order, the invalid elements after every cluster by raw id."""
    return torch.sort(sort_keys(clustered), stable=True)


def kernel_inputs(clustered: dict) -> dict:
    """The kernels' inputs from a clustered batch: its columns as
    contiguous int32, bool and float32 [n] tensors, and the one sort
    (sorted_ids). Raises on a column of another shape or device."""
    dev = clustered["pos"].device
    n = clustered["pos"].shape[0]

    def col(key, dtype):
        t = clustered[key]
        if t.device != dev or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"call_statistics: {key} is {tuple(t.shape)} on {t.device}, "
                             f"want ({n},) on {dev}")
        return t.to(dtype).contiguous()

    c = {k: col(k, torch.int32) for k in INT_COLUMNS}
    c["valid"] = col("valid", torch.bool)
    c["nm"] = col("nm", torch.float32)
    c["sort"] = sorted_ids(c) if n else None
    return c


def nvcc_defines(tiers: tuple = TIERS) -> tuple:
    """The -D flags of csrc/call_stats.cu for the thresholds (tiny, pair,
    warp, block); the kernel's static_asserts refuse a set that does not
    fit it."""
    names = ("STAT_TINY_MAX", "STAT_PAIR_MAX", "STAT_WARP_MAX", "STAT_BLOCK_MAX")
    return tuple(f"-D{k}={int(v)}" for k, v in zip(names, tiers, strict=True))


def launch_kernels(inputs: dict, n_clusters, fused: bool = False,
                   tiers: tuple = TIERS, clocks: bool = False, run_parts: int = 0) -> dict:
    """The kernels' entry point call_stats on kernel_inputs (the run pass,
    the slot pass, the warp and the block tiers) on the
    current stream of the tensors' device, from the build with the
    thresholds `tiers` (as nvcc_defines; another set than TIERS is a
    library of its own, built at first use), with `clocks` CLOCKS and
    with `run_parts` k > 0 the variant that returns after RUN_PARTS[k - 1]
    (a timing tool's: its rows are not written); no launch for n = 0.
    Counts nothing; raises when a launch fails or the card refuses a
    tier's shared memory."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    c = inputs
    dev, n = c["pos"].device, c["pos"].shape[0]
    out = torch.empty((len(KEYS), n), dtype=torch.int32, device=dev)
    if n:
        keys_s, order = c["sort"]
        runs = torch.empty((n + 3,), dtype=torch.int32, device=dev)   # run starts, list counts
        lists = torch.empty((4 * n,), dtype=torch.int32, device=dev)  # the tiers' slots
        marks = torch.empty((n,), dtype=torch.uint8, device=dev)      # the invalid marks
        lists_big = torch.empty((4, n), dtype=torch.int32, device=dev)  # past BLOCK_MAX
        fn = _build.load("call_stats", nvcc_defines(tiers) + ((CLOCKS,) if clocks else ())
                         + ((run_parts_define(run_parts),) if run_parts else ())).call_stats
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        rc = _launch(fn, dev, keys_s.data_ptr(), order.data_ptr(), c["svlen"].data_ptr(),
                     c["pos"].data_ptr(), c["read_id"].data_ptr(), c["mapq"].data_ptr(),
                     c["strand"].data_ptr(), c["svtype"].data_ptr(), c["nm"].data_ptr(),
                     runs.data_ptr(), lists.data_ptr(), marks.data_ptr(),
                     lists_big.data_ptr(), out.data_ptr(), n, int(bool(fused)))
        if rc != 0:
            raise RuntimeError(f"call_stats launch failed with CUDA error {rc}")
    stats = {"n_clusters": n_clusters}
    stats.update((k, row.view(torch.float32) if k in FLOAT_KEYS else row)
                 for k, row in zip(KEYS, out))
    return stats


def launch_call_statistics(clustered: dict, fused: bool = False) -> dict:
    """The statistics on CUDA tensors: the sort, then the kernels
    (launch_kernels). Counts nothing; raises when a launch fails."""
    return launch_kernels(kernel_inputs(clustered), clustered["n_clusters"], fused)
