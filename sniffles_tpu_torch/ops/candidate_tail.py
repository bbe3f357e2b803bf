"""
The candidate tail of the fused calling engine: everything the step
computes per candidate slot after the call statistics, in one pass —
the mean NM of each cluster, the length screen of cluster_valid and the
PRECISE flag (sniffles_tpu/parallel/engine.py:133-135, :151), the 5-point
coverage annotation (ops/coverage.py), genotyping (ops/genotype_batch.py)
and the QC cascade (ops/qc_batch.py).

`candidate_tail` is the wrapper: on CPU tensors the plain version
(`candidate_tail_plain`, the composition of those modules' torch
functions), on CUDA tensors the kernel of csrc/candidate_tail.cu (a pass that
writes each cluster's run start, then a thread per candidate slot; no
host synchronisation), or an exception.

The cluster's mean NM is the JAX package's float32 segment sum, which XLA
adds element by element in array order (cluster ids ascend along the
array, so a cluster is a contiguous run): the plain version takes a
float32 index_add_, which adds in that order on the CPU; the kernel sums
the cluster's run in order. call_statistics' float64 mean is replaced.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from sniffles_tpu_torch.ops.clustering import SVTYPE_INV
from sniffles_tpu_torch.ops.coverage import annotate_coverage
from sniffles_tpu_torch.ops.genotype_batch import (genotype_batch, log10_constants,
                                                   param_tensors)
from sniffles_tpu_torch.ops.qc_batch import qc_batch
from sniffles_tpu_torch.ops.segments import seg_sum

# Launches of the kernel by the wrapper (candidate_tail), one a step (each
# is a launch of the run pass tail_runs, then of candidate_tail_kernel); it
# adds to it only where it launches the kernel.
COUNTS = {"launches": 0}

# The run pass's timing variants (csrc/candidate_tail.cu, -DTAIL_RUN_PARTS=k):
# the k-th stops after this part. Only a timing tool builds them.
RUN_PARTS = ("empty launch", "loads")
# The run pass's most ids a lane a round and a warp's chunk of them
# (csrc/candidate_tail.cu: 4 * kRunVecs, 32 lanes of 4 * kRunVecs); the edge
# layouts of sim.tail_run_layouts straddle them
RUN_LANE_IDS = 16
RUN_CHUNK_IDS = 512

# the output keys, by type (the kernel writes them as rows of one int32,
# one float32 and one uint8 tensor, in this order)
INT_KEYS = ("coverage_upstream", "coverage_start", "coverage_center", "coverage_end",
            "coverage_downstream", "gt_a", "gt_b", "gq", "zscore", "dr", "dv",
            "filter_code")
FLOAT_KEYS = ("af", "coverage", "nm")
BOOL_KEYS = ("gt_failed", "qc", "precise", "cluster_valid")

# the kernel's parameter struct (csrc/candidate_tail.cu, TailParams), field
# for field: float32 fields, then int32 fields
FLOAT_PARAMS = ("normalization_target", "long_ins_length", "rescale_base", "rescale_mult",
                "dev_min_dup_vaf", "genotype_min_z_score", "qc_stdev_abs_max", "qc_coverage",
                "long_del_length", "long_del_coverage", "long_dup_length",
                "long_dup_coverage", "long_inv_length", "dev_longer_del", "dev_longer_dup",
                "qc_nm_mult", "minsupport_const", "minsupport_auto_base",
                "minsupport_auto_mult", "minsupport_auto_regional_coverage_weight",
                "mosaic_af_min", "mosaic_af_max", "mosaic_min_reads",
                "mosaic_use_strand_thresholds", "mosaic_qc_invdup_min_length",
                "max_svlen_mosaic")
LOG10_PARAMS = ("log10_err", "log10_1m_err", "log10_het", "log10_1m_het", "log10_1m_1m_err")
# the step's two values that a mesh reduces on the device: in the struct
# where they are numbers, else in a device array the kernel reads
DYN_PARAMS = ("coverage_global", "qc_nm_threshold")
INT_PARAMS = ("minsvlen", "minsvlen_screen", "minsvlen_hard_cap", "qc_stdev", "qc_strand",
              "qc_bnd_filter_strand", "qc_nm", "minsupport_is_auto", "mosaic",
              "mosaic_qc_strand", "mosaic_include_germline", "detect_large_ins")


class TailParams(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_float) for k in FLOAT_PARAMS + LOG10_PARAMS + DYN_PARAMS]
                + [(k, ctypes.c_int) for k in INT_PARAMS])


def reset_counts() -> None:
    COUNTS["launches"] = 0


def run_parts_define(k: int) -> str:
    """The -D flag of the run pass's variant that stops after RUN_PARTS[k - 1]."""
    if not 1 <= k <= len(RUN_PARTS):
        raise ValueError(f"the run pass has parts 1 to {len(RUN_PARTS)}, not {k}")
    return f"-DTAIL_RUN_PARTS={int(k)}"


def _host_value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def log10s_of(params: dict) -> tuple:
    """The likelihoods' five log10 constants from the parameters, in
    float32 as the JAX step computes them (1 / ploidy in float32)."""
    f32 = np.float32
    err = f32(_host_value(params["genotype_error"]))
    het_p = f32(f32(1.0) / f32(_host_value(params["ploidy"])))
    return log10_constants(err, het_p)


def cluster_nm_plain(nm, valid, cluster_id, lead_count):
    """Each cluster's mean NM: the float32 sum in array order (a CPU
    index_add_), over max(lead_count, 1)."""
    n = nm.shape[0]
    total = seg_sum(torch.where(valid, nm, 0.0).to(torch.float32), cluster_id, n)
    return total / torch.clamp(lead_count, min=1).to(torch.float32)


def written_runs(cluster_id) -> int:
    """How many leading entries of run_start the run pass writes:
    clamp(cluster_id[-1] + 1, 0, n) + 1 (a host synchronisation)."""
    n = cluster_id.shape[0]
    return min(max(int(cluster_id[-1]) + 1, 0), n) + 1


def tail_runs_plain(cluster_id):
    """The run pass's plain version: run_start[c], the first element j with
    cluster_id[j] >= c (n where none), for c up to clamp(cluster_id[-1] + 1,
    0, n), as int32 (cluster ids ascend along the array)."""
    cid = cluster_id.to(torch.int32).contiguous()
    slots = torch.arange(written_runs(cid), dtype=torch.int32, device=cid.device)
    return torch.searchsorted(cid, slots, out_int32=True)


def candidate_tail_plain(stats: dict, support_sa, coverage, elements: dict, params: dict,
                         *, region_offset=0, binsize: int = 100, log10s=None) -> dict:
    """The composition of annotate_coverage, genotype_batch and qc_batch
    with the step's cluster NM, length screen and PRECISE flag, as torch
    ops."""
    p = param_tensors(params, coverage.device)
    stats = dict(stats)
    stats["nm"] = cluster_nm_plain(elements["nm"], elements["valid"],
                                   elements["cluster_id"], stats["lead_count"])
    n = stats["svtype"].shape[0]
    cluster_valid = torch.arange(n, device=coverage.device) < stats["n_clusters"]
    is_sv = (stats["svtype"] >= 0) & (stats["svtype"] <= SVTYPE_INV)
    length_ok = ~is_sv | (stats["svlen"].abs() >= p["minsvlen_screen"])
    cluster_valid = cluster_valid & length_ok & (stats["lead_count"] > 0)

    cov = annotate_coverage(coverage, stats["svtype"], stats["pos"], stats["svlen"],
                            bnd_is_first=torch.zeros_like(stats["svtype"], dtype=torch.bool),
                            region_offset=region_offset, binsize=binsize)
    stats.update(cov)
    gt = genotype_batch(stats["svtype"], stats["svlen"], stats["support"],
                        cov["coverage_upstream"], cov["coverage_start"],
                        cov["coverage_center"], cov["coverage_end"],
                        cov["coverage_downstream"], support_sa=support_sa, params=p,
                        log10s=log10s if log10s is not None else log10s_of(params))
    qc = qc_batch(stats, gt, p)
    out = dict(cov)
    out.update(gt)
    out.update(qc)
    out["nm"] = stats["nm"]
    out["precise"] = (stats["stdev_pos"] + stats["stdev_len"]) < 25.0
    out["cluster_valid"] = cluster_valid
    return out


def candidate_tail(stats: dict, support_sa, coverage, elements: dict, params: dict, *,
                   region_offset=0, binsize: int = 100) -> dict:
    """The candidate tail of one step. `stats`: call_statistics' output
    (svtype, svlen, pos, support, lead_count, n_strands, stdev_pos,
    stdev_len, n_clusters); `support_sa` [N] int32; `coverage` [L] int32;
    `elements`: the clustered batch's nm, valid and cluster_id (array
    order); `params`: default_params values (coverage_global and
    qc_nm_threshold may be 0-d tensors of the step's device). Returns
    INT_KEYS, FLOAT_KEYS and BOOL_KEYS."""
    dev = coverage.device
    if dev.type == "cpu":
        return candidate_tail_plain(stats, support_sa, coverage, elements, params,
                                    region_offset=region_offset, binsize=binsize)
    if dev.type != "cuda":
        raise ValueError(f"no candidate-tail kernel for device {dev}")
    out = launch_candidate_tail(stats, support_sa, coverage, elements, params,
                                region_offset=region_offset, binsize=binsize)
    COUNTS["launches"] += 1
    return out


def tail_params(params: dict) -> TailParams:
    """The kernel's parameter struct: each value rounded to float32 or
    int32 as JAX traces it, the log10 constants from log10s_of."""
    f32 = np.float32
    values = {k: float(f32(_host_value(params[k]))) for k in FLOAT_PARAMS}
    values.update(zip(LOG10_PARAMS, (float(c) for c in log10s_of(params))))
    values.update({k: 0.0 if isinstance(params[k], torch.Tensor) else float(f32(params[k]))
                   for k in DYN_PARAMS})
    values.update({k: int(_host_value(params[k])) for k in INT_PARAMS})
    return TailParams(**values)


def launch_candidate_tail(stats: dict, support_sa, coverage, elements: dict, params: dict, *,
                          region_offset=0, binsize: int = 100) -> dict:
    """The kernel's entry point candidate_tail on CUDA tensors (the run
    starts, then a thread per slot) on the current stream of the tensors'
    device. Counts nothing; raises when a launch fails."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    dev = coverage.device
    n = stats["svtype"].shape[0]
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8

    def col(t, dtype, size=n):
        t = torch.as_tensor(t, device=dev).to(dtype).reshape(-1)
        if t.shape[0] != size:
            raise ValueError(f"candidate_tail: a column of {t.shape[0]} slots, want {size}")
        return t.contiguous()

    ints = [col(stats[k], i32) for k in ("svtype", "svlen", "pos", "support", "lead_count",
                                         "n_strands")]
    floats = [col(stats[k], f32) for k in ("stdev_pos", "stdev_len")]
    # a bool is one byte, 0 or 1: the kernel reads and writes bool columns
    # as their bytes, with no conversion
    elems = [col(elements["nm"], f32), col(elements["valid"], torch.bool).view(u8),
             col(elements["cluster_id"], i32)]
    n_clusters = col(stats["n_clusters"], i32, 1)
    sa = col(support_sa, i32)
    cov = coverage.to(i32).contiguous()
    # numbers ride in the parameter struct; device values (a mesh's) are
    # stacked on the device, never copied from the host
    dyn = (torch.stack([params[k].to(dev, f32).reshape(()) if isinstance(params[k], torch.Tensor)
                        else torch.full((), float(params[k]), dtype=f32, device=dev)
                        for k in DYN_PARAMS])
           if any(isinstance(params[k], torch.Tensor) for k in DYN_PARAMS) else None)
    off = int(_host_value(region_offset))
    run_start = torch.empty((n + 1,), dtype=i32, device=dev)   # scratch
    out_i = torch.empty((len(INT_KEYS), n), dtype=i32, device=dev)
    out_f = torch.empty((len(FLOAT_KEYS), n), dtype=f32, device=dev)
    out_b = torch.empty((len(BOOL_KEYS), n), dtype=torch.bool, device=dev)
    fn = _build.load("candidate_tail").candidate_tail
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [TailParams, ctypes.c_void_p])
    rc = _launch(fn, dev, *(t.data_ptr() for t in ints + floats + elems),
                 n_clusters.data_ptr(), sa.data_ptr(), cov.data_ptr(),
                 dyn.data_ptr() if dyn is not None else None, run_start.data_ptr(),
                 out_i.data_ptr(), out_f.data_ptr(), out_b.view(u8).data_ptr(),
                 n, cov.shape[0],
                 off, int(binsize), tail_params(params))
    if rc != 0:
        raise RuntimeError(f"candidate_tail launch failed with CUDA error {rc}")
    out = dict(zip(INT_KEYS, out_i))
    out.update(zip(FLOAT_KEYS, out_f))
    out.update(zip(BOOL_KEYS, out_b))
    return out


def launch_tail_runs(cluster_id, run_parts: int = 0):
    """The run pass alone (the entry point tail_run_starts) on a CUDA int32
    tensor of ascending cluster ids [n], on the current stream of its
    device: run_start int32 [n + 1], whose first written_runs(cluster_id)
    entries are tail_runs_plain's and the rest unwritten. `run_parts` k > 0:
    the timing variant that stops after RUN_PARTS[k - 1] (nothing written).
    Counts nothing; raises when the launch fails."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    if cluster_id.device.type != "cuda" or cluster_id.dtype != torch.int32:
        raise ValueError("tail_runs: a CUDA int32 tensor of cluster ids")
    cid = cluster_id.reshape(-1).contiguous()
    n = cid.shape[0]
    run_start = torch.empty((n + 1,), dtype=torch.int32, device=cid.device)
    fn = _build.load("candidate_tail",
                     (run_parts_define(run_parts),) if run_parts else None).tail_run_starts
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    rc = _launch(fn, cid.device, cid.data_ptr(), run_start.data_ptr(), n)
    if rc != 0:
        raise RuntimeError(f"tail_runs launch failed with CUDA error {rc}")
    return run_start
