"""
Vectorized QC cascade (device formulation of postprocessing.py:133-600).

The filter string of the FIRST failing check is part of the output
contract; filters are evaluated in reference order and the first
failing code is selected per candidate with a priority chain.

Copied from sniffles_tpu/ops/qc_batch.py as torch ops, on the parameter
tensors of ops/genotype_batch.param_tensors (float32 and int32, as JAX
traces them), with the JAX package's CPU arithmetic kept bit for bit: the
auto minimum support's blend of regional and global coverage is two fused
multiply-adds there (ops/segments.fma_f32).
"""
from __future__ import annotations

import torch

from sniffles_tpu_torch.ops.clustering import (SVTYPE_BND, SVTYPE_DEL, SVTYPE_DUP, SVTYPE_INS,
                                               SVTYPE_INV, SVTYPE_SINGLE_LEFT,
                                               SVTYPE_SINGLE_RIGHT)
from sniffles_tpu_torch.ops.genotype_batch import param_tensors, rescale_support_batch
from sniffles_tpu_torch.ops.segments import fma_f32

# Filter codes, 0 = PASS. Order here is just an enumeration; application
# order is the cascade below.
FILTERS = ["PASS", "STDEV_POS", "STDEV_LEN", "SINGLE_BREAK", "SVLEN_MIN", "STRAND_BND",
           "COV_CHANGE_DEL", "COV_CHANGE_DUP", "COV_CHANGE_INS", "SUPPORT_MIN",
           "COV_MIN_GT", "ALN_NM", "MOSAIC_VAF", "SVLEN_MAX_MOSAIC", "STRAND",
           "STRAND_MOSAIC", "SVLEN_MIN_MOSAIC", "COV_MIN", "NOT_MOSAIC_VAF", "GT",
           "GT_FAILED"]
FILTER_CODES = {name: i for i, name in enumerate(FILTERS)}


def _first_fail(*checks):
    """checks: list of (fail_mask, code). Returns the first failing code, 0 otherwise."""
    code = torch.zeros_like(checks[0][0], dtype=torch.int32)
    for fail, c in reversed(checks):
        code = torch.where(fail, c, code).to(torch.int32)
    # reversed + where gives the FIRST entry priority
    return code


def qc_batch(stats: dict, gt: dict, params: dict) -> dict:
    """
    Main QC + post-annotate QC cascade over candidate batches.

    `stats`: output of call_statistics (+ coverage_* arrays added).
    `gt`: output of genotype_batch.
    `params`: scalar thresholds mirroring SnifflesConfig.
    Returns filter codes [N] (0=PASS) and the qc mask.
    """
    svtype = stats["svtype"]
    p = param_tensors(params, svtype.device)
    f32 = torch.float32
    svlen = stats["svlen"]
    abs_svlen = svlen.abs()
    support = stats["support"]
    stdev_pos = stats["stdev_pos"]
    stdev_len = stats["stdev_len"]
    cov_u = stats["coverage_upstream"].to(f32)
    cov_s = stats["coverage_start"].to(f32)
    cov_c = stats["coverage_center"].to(f32)
    cov_e = stats["coverage_end"].to(f32)
    cov_d = stats["coverage_downstream"].to(f32)

    def floor_at(x, lo):
        return torch.clamp(x, min=lo)

    is_bnd = svtype == SVTYPE_BND
    is_single = (svtype == SVTYPE_SINGLE_LEFT) | (svtype == SVTYPE_SINGLE_RIGHT)
    not_bnd_single = ~is_bnd & ~is_single
    safe_len = floor_at(abs_svlen.to(f32), 1.0)

    # --- qc_sv (reference: postprocessing.py:200-441) ---
    f_stdev_pos = (stdev_pos > p["qc_stdev_abs_max"]) | \
                  (not_bnd_single & (stdev_pos / safe_len > 2.0))
    f_stdev_len = (stdev_len != 0) & (
        (~is_bnd & (stdev_len / safe_len > 1.0)) | (stdev_len > p["qc_stdev_abs_max"]))
    f_stdev_pos = f_stdev_pos & (p["qc_stdev"] > 0)
    f_stdev_len = f_stdev_len & (p["qc_stdev"] > 0)

    f_single = is_single

    f_svlen_min = (abs_svlen < p["minsvlen"]) & ~is_bnd & (
        (support < 10) | (p["minsvlen_hard_cap"] > 0))

    f_strand_bnd = is_bnd & (p["qc_bnd_filter_strand"] > 0) & (stats["n_strands"] < 2)

    # long DEL / DUP central coverage checks
    updown_max_diff = 0.7
    updown_diff = 0.5
    eps = 1e-6
    mosaic_off = p["mosaic"] == 0
    long_del = (svtype == SVTYPE_DEL) & (abs_svlen >= p["long_del_length"]) & \
               mosaic_off & (abs_svlen <= p["dev_longer_del"])
    del_c1 = cov_c > (cov_u + cov_d) * (p["long_del_coverage"] / 2.0)
    slope_dn = (cov_u > cov_c) & (cov_c > cov_d)
    slope_up = (cov_u < cov_c) & (cov_c < cov_d)
    d_over_u = cov_d / floor_at(cov_u, eps)
    u_over_d = cov_u / floor_at(cov_d, eps)
    del_slope_fail = (slope_dn & (d_over_u < updown_max_diff)) | \
                     (slope_up & (u_over_d < updown_max_diff))
    del_ud_fail = torch.where(
        cov_u > cov_d, (updown_diff > d_over_u) | (cov_c > cov_d),
        (cov_u < cov_d) & ((updown_diff > u_over_d) | (cov_u < cov_c)))
    f_cov_del = long_del & ((del_c1 & del_slope_fail) | del_ud_fail)

    long_dup = (svtype == SVTYPE_DUP) & (abs_svlen >= p["long_dup_length"]) & \
               mosaic_off & (abs_svlen <= p["dev_longer_dup"])
    dup_c1 = cov_c < (cov_u + cov_d) * (p["long_dup_coverage"] / 2.0)
    dup_ud_fail = torch.where(
        cov_u > cov_d, (updown_diff > d_over_u) | (cov_c < cov_d),
        (cov_u < cov_d) & ((updown_diff > u_over_d) | (cov_u > cov_c)))
    f_cov_dup = long_dup & dup_c1 & (del_slope_fail | dup_ud_fail)

    f_cov_ins = (svtype == SVTYPE_INS) & (
        (cov_u < p["qc_coverage"]) | (cov_d < p["qc_coverage"]))

    # --- support filter (reference: postprocessing.py:133-197) ---
    supp_rescaled = rescale_support_batch(svtype, svlen, support, p["long_ins_length"],
                                          p["rescale_base"], p["rescale_mult"])
    cov_reg_ud = cov_u * (cov_u != 0) + cov_d * (cov_d != 0)
    n_ud = (cov_u != 0).to(f32) + (cov_d != 0).to(f32)
    cov_regional = torch.where(n_ud > 0, torch.round(cov_reg_ud / floor_at(n_ud, 1.0)), 0.0)
    n_sce = (cov_s != 0).to(f32) + (cov_c != 0).to(f32) + (cov_e != 0).to(f32)
    sum_sce = cov_s * (cov_s != 0) + cov_c * (cov_c != 0) + cov_e * (cov_e != 0)
    cov_sce = torch.where(n_sce > 0, torch.round(sum_sce / floor_at(n_sce, 1.0)), 0.0)
    cov_regional = torch.where(n_ud > 0, cov_regional, cov_sce)
    cov_global = p["coverage_global"].to(f32)
    cov_regional = torch.where(cov_regional == 0, cov_global, cov_regional)
    w = p["minsupport_auto_regional_coverage_weight"].to(f32)
    cov_blend = fma_f32(cov_regional, w, cov_global * (1.0 - w))
    min_support_auto = torch.round(fma_f32(p["minsupport_auto_mult"], cov_blend,
                                           p["minsupport_auto_base"]))
    is_auto = p["minsupport_is_auto"] > 0
    min_support = torch.where(is_auto, min_support_auto, p["minsupport_const"].to(f32))
    f_support = torch.where(is_auto, supp_rescaled < min_support,
                            support.to(f32) < min_support)
    f_support = f_support & mosaic_off

    # --- qc_sv_post_annotate (reference: postprocessing.py:444-600) ---
    af = gt["af"]
    sv_is_mosaic = af <= p["mosaic_af_max"]
    gt_sum = gt["gt_a"] + gt["gt_b"]

    f_cov_min_gt = (cov_c < p["qc_coverage"]) & (gt_sum < 2) & \
                   (svtype != SVTYPE_DEL) & (abs_svlen > p["long_del_length"])

    f_nm = (p["qc_nm"] > 0) & (stats["nm"] > p["qc_nm_threshold"] * p["qc_nm_mult"]) & \
           (gt["gt_b"] == 0)

    skip_dup = (svtype == SVTYPE_DUP) & (af >= p["dev_min_dup_vaf"])
    f_mosaic_vaf_germ = mosaic_off & sv_is_mosaic & ~skip_dup

    mosaic_on = p["mosaic"] > 0
    mosaic_sv = mosaic_on & sv_is_mosaic
    f_mosaic_support = mosaic_sv & (support < p["mosaic_min_reads"])
    f_mosaic_len = mosaic_sv & ~is_bnd & (abs_svlen > p["max_svlen_mosaic"])

    is_long_ins = (svtype == SVTYPE_INS) & (svlen >= p["long_ins_length"])
    one_strand = stats["n_strands"] < 2
    f_strand = (p["qc_strand"] > 0) & ~mosaic_sv & ~is_bnd & ~is_long_ins & one_strand
    f_strand_mosaic = mosaic_sv & (p["mosaic_qc_strand"] > 0) & ~is_bnd & \
                      ~is_long_ins & one_strand & \
                      (support >= p["mosaic_use_strand_thresholds"])

    f_mosaic_invdup = mosaic_sv & ((svtype == SVTYPE_INV) | (svtype == SVTYPE_DUP)) & \
                      (svlen < p["mosaic_qc_invdup_min_length"])

    long_inv_exempt = (svtype == SVTYPE_INV) & (svlen > p["long_inv_length"]) & ~mosaic_sv
    f_cov_min = (cov_c < p["qc_coverage"]) & \
                ~((svtype == SVTYPE_DEL) | (svtype == SVTYPE_INS)) & ~long_inv_exempt

    f_mosaic_window = mosaic_sv & ((af < p["mosaic_af_min"]) | (af > p["mosaic_af_max"]))
    f_not_mosaic = mosaic_on & ~sv_is_mosaic & (p["mosaic_include_germline"] == 0)

    f_gt = (gt["zscore"] < p["genotype_min_z_score"]) & mosaic_off & \
           ~(is_long_ins & (p["detect_large_ins"] > 0)) & ~skip_dup

    code = _first_fail(
        (f_stdev_pos, FILTER_CODES["STDEV_POS"]),
        (f_stdev_len, FILTER_CODES["STDEV_LEN"]),
        (f_single, FILTER_CODES["SINGLE_BREAK"]),
        (f_svlen_min, FILTER_CODES["SVLEN_MIN"]),
        (f_strand_bnd, FILTER_CODES["STRAND_BND"]),
        (f_cov_del, FILTER_CODES["COV_CHANGE_DEL"]),
        (f_cov_dup, FILTER_CODES["COV_CHANGE_DUP"]),
        (f_cov_ins, FILTER_CODES["COV_CHANGE_INS"]),
        (f_support, FILTER_CODES["SUPPORT_MIN"]),
        (gt["gt_failed"], FILTER_CODES["GT_FAILED"]),
        (f_gt, FILTER_CODES["GT"]),
        (f_cov_min_gt, FILTER_CODES["COV_MIN_GT"]),
        (f_nm, FILTER_CODES["ALN_NM"]),
        (f_mosaic_vaf_germ, FILTER_CODES["MOSAIC_VAF"]),
        (f_mosaic_support, FILTER_CODES["SUPPORT_MIN"]),
        (f_mosaic_len, FILTER_CODES["SVLEN_MAX_MOSAIC"]),
        (f_strand, FILTER_CODES["STRAND"]),
        (f_strand_mosaic, FILTER_CODES["STRAND_MOSAIC"]),
        (f_mosaic_invdup, FILTER_CODES["SVLEN_MIN_MOSAIC"]),
        (f_cov_min, FILTER_CODES["COV_MIN"]),
        (f_mosaic_window, FILTER_CODES["MOSAIC_VAF"]),
        (f_not_mosaic, FILTER_CODES["NOT_MOSAIC_VAF"]),
    )

    return {"filter_code": code, "qc": code == 0}
