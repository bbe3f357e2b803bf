"""
The fused device calling step: signatures -> clusters -> call statistics
-> coverage annotation -> genotypes -> QC, over one static-shaped batch
(the device-side replacement for the reference's per-object
cluster.resolve + sv.call_from + postprocessing chain).

Copied from sniffles_tpu/parallel/engine.py (default_params :25,
call_pipeline_step :90), where it is one jitted XLA program. Here the
sort, the seeds, the resplit and the call statistics are the torch ops of
ops/clustering.py, and the two stages that would be hundreds of small
launches as torch ops are hand-written kernels on the card: the
relaxation's rounds (ops/merge_relax.py, csrc/merge_relax.cu) and the
candidate tail (ops/candidate_tail.py, csrc/candidate_tail.cu). On CPU
tensors both wrappers take their plain versions.

A batch of N signature slots produces N candidate slots, with the
per-cluster results at cluster indices [0, n_clusters).
"""
from __future__ import annotations

import numpy as np
import torch

from sniffles_tpu_torch.config import torch_device
from sniffles_tpu_torch.ops.candidate_tail import candidate_tail
from sniffles_tpu_torch.ops.clustering import call_statistics, cluster_signatures
from sniffles_tpu_torch.ops.segments import seg_sum
from sniffles_tpu_torch.spans import STATS, STEP, TAIL, span


def default_params(config=None) -> dict:
    """Scalar parameter dict for the device pipeline, from a SnifflesConfig
    or reference defaults (reference: config.py:449-618)."""
    def g(name, dflt):
        return getattr(config, name, dflt) if config is not None else dflt

    minsupport = g("minsupport", "3")
    is_auto = minsupport == "auto"
    return {
        # clustering
        "cluster_r": float(g("cluster_r", 2.5)),
        "cluster_repeat_h": float(g("cluster_repeat_h", 1.5)),
        "cluster_repeat_h_max": float(g("cluster_repeat_h_max", 1000)),
        "cluster_merge_bnd": int(g("cluster_merge_bnd", 1000)),
        "cluster_merge_len": float(g("cluster_merge_len", 0.22)),
        "minsvlen": int(g("minsvlen", 50)),
        "minsvlen_screen": int(g("minsvlen_screen", 45)),
        "minsvlen_hard_cap": int(bool(g("minsvlen_hard_cap", True))),
        # genotyping
        "genotype_error": float(g("genotype_error", 0.05)),
        "ploidy": float(g("genotype_ploidy", 2)),
        "normalization_target": 250.0,
        "genotype_min_z_score": float(g("genotype_min_z_score", 5)),
        "long_ins_length": float(g("long_ins_length", 2500)),
        "rescale_base": float(g("long_ins_rescale_base", 1.66)),
        "rescale_mult": float(g("long_ins_rescale_mult", 0.33)),
        "detect_large_ins": int(bool(g("detect_large_ins", True))),
        # QC
        "qc_stdev": int(bool(g("qc_stdev", True))),
        "qc_stdev_abs_max": float(g("qc_stdev_abs_max", 500)),
        "qc_strand": int(bool(g("qc_strand", False))),
        "qc_bnd_filter_strand": int(bool(g("qc_bnd_filter_strand", True))),
        "qc_coverage": float(g("qc_coverage", 1)),
        "long_del_length": float(g("long_del_length", 50000)),
        "long_del_coverage": float(g("long_del_coverage", 0.66)),
        "long_dup_length": float(g("long_dup_length", 50000)),
        "long_dup_coverage": float(g("long_dup_coverage", 1.33)),
        "long_inv_length": float(g("long_inv_length", 10000)),
        "dev_longer_del": float(g("dev_longer_del", 200000)),
        "dev_longer_dup": float(g("dev_longer_dup", 200000)),
        "qc_nm": int(bool(g("qc_nm", False))),
        "qc_nm_threshold": float(g("qc_nm_threshold", 0.0)),
        "qc_nm_mult": float(g("qc_nm_mult", 1.66)),
        "dev_min_dup_vaf": float(g("dev_min_dup_vaf", 1 / 6.0)),
        "minsupport_is_auto": int(is_auto),
        "minsupport_const": float(minsupport if not is_auto else 0),
        "minsupport_auto_base": float(g("minsupport_auto_base", 1.5)),
        "minsupport_auto_mult": float(g("minsupport_auto_mult", 0.1)),
        "minsupport_auto_regional_coverage_weight": float(
            g("minsupport_auto_regional_coverage_weight", 0.75)),
        "coverage_global": 30.0,  # overwritten per shard at runtime
        # mosaic
        "mosaic": int(bool(g("mosaic", False))),
        "mosaic_af_min": float(g("mosaic_af_min", 0.05)),
        "mosaic_af_max": float(g("mosaic_af_max", 0.218)),
        "mosaic_min_reads": float(g("mosaic_min_reads", 3)),
        "mosaic_use_strand_thresholds": float(g("mosaic_use_strand_thresholds", 10)),
        "mosaic_qc_strand": int(bool(g("mosaic_qc_strand", True))),
        "mosaic_qc_invdup_min_length": float(g("mosaic_qc_invdup_min_length", 500)),
        "max_svlen_mosaic": float(g("max_svlen_mosaic", 50000)),
        "mosaic_include_germline": int(bool(g("mosaic_include_germline", False))),
    }


def step_device(coverage, device=None) -> torch.device:
    """The step's device: `device` when given, else the coverage tensor's,
    else the port's device path (the card; the CPU only with
    SNIFFLES_TPU_FORCE_CPU; with neither it raises)."""
    if device is not None:
        return torch.device(device)
    if isinstance(coverage, torch.Tensor):
        return coverage.device
    return torch.device(torch_device())


def to_device(sig: dict, coverage, device=None):
    """(sig, coverage) as tensors on the step's device (step_device)."""
    dev = step_device(coverage, device)
    sig = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
           .to(dev) for k, v in sig.items()}
    return sig, torch.as_tensor(coverage).to(dev)


def call_pipeline_step(sig: dict, coverage, params: dict, region_offset=0,
                       binsize: int = 100, resplit_binsize: int = 20, *, device=None,
                       info: dict | None = None) -> dict:
    """
    One fused calling step over a signature batch.

    sig: signature arrays (SignatureBatch.as_dict), tensors or numpy
         arrays; coverage: int32 coverage array for the batch's genome
         window; both go to the step's device (step_device)
    params: default_params() dict; coverage_global and qc_nm_threshold may
            be 0-d tensors of the step's device (a mesh's reductions)
    info: a dict that receives "merge_rounds", the relaxation's rounds
          (an int on the CPU, an int32 0-d tensor on the card)

    Returns candidate tensors [N] (valid for cluster ids < n_clusters):
    svtype, pos, end, svlen, support, qual, stdev_pos, stdev_len,
    gt_(a,b), gq, dr, dv, af, filter_code, qc, precise, ...
    """
    with span(STEP):
        sig, coverage = to_device(sig, coverage, device)
        clustered = cluster_signatures(
            sig,
            cluster_r=params["cluster_r"],
            cluster_repeat_h=params["cluster_repeat_h"],
            cluster_repeat_h_max=params["cluster_repeat_h_max"],
            cluster_merge_bnd=params["cluster_merge_bnd"],
            cluster_merge_len=params["cluster_merge_len"],
            minsvlen=params["minsvlen"],
            binsize=binsize,
            resplit_binsize=resplit_binsize,
            # the fused path: the parallel relaxation (a documented deviation
            # of the JAX package); the production call path uses the exact sweep
            exact_sweep=False,
        )
        if info is not None:
            info["merge_rounds"] = clustered.pop("merge_rounds")
        else:
            clustered.pop("merge_rounds")

        with span(STATS):
            stats = call_statistics(clustered, fused=True)
        n = stats["svtype"].shape[0]

        with span(TAIL):
            # split-read support per cluster (reference: sv.py:580-581 counts
            # source != INLINE leads into SUPPORT_SA for the DEL genotyper)
            sa = clustered.get("sa")
            support_sa = (seg_sum((clustered["valid"] & (sa > 0)).to(torch.int32),
                                  clustered["cluster_id"], n)
                          if sa is not None else torch.zeros_like(stats["support"]))
            tail = candidate_tail(stats, support_sa, coverage, clustered, params,
                                  region_offset=region_offset, binsize=binsize)
        out = dict(stats)
        out.update(tail)
        return out
