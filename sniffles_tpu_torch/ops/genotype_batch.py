"""
Vectorized binomial genotyping over candidate batches (device
formulation of genotyping.py:62-241).

Per-type coverage composition, long-INS support rescaling, likelihoods
computed in log10 space with the reference's float-underflow semantics
reproduced (likelihoods below DBL_MIN behave as exactly 0 in the
likelihood-ratio formulas, reference: genotyping.py:36-43).

Copied from sniffles_tpu/ops/genotype_batch.py as torch ops on float32,
with the JAX package's CPU arithmetic kept bit for bit:
  * every parameter is a 0-d tensor of the type JAX traces it as (float32,
    int32; `param_tensors`), so scalar-only arithmetic rounds in float32;
  * `jnp.round` and `torch.round` both round half to even;
  * `jnp.log10` is XLA's float32 log times float32(1/ln 10), and XLA's CPU
    log is its own polynomial (`xla_log_f32`), not a correctly rounded
    one: the five log10 constants of the likelihoods are computed once,
    on the host, with that polynomial;
  * XLA's CPU backend contracts a float32 multiply feeding an add into a
    fused multiply-add (vfmadd): `fma_f32` (ops/segments.py) stands where
    the JAX package's compiled step fuses (the likelihoods, the long-INS
    rescale).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from sniffles_tpu_torch.ops.clustering import SVTYPE_DEL, SVTYPE_DUP, SVTYPE_INS, SVTYPE_INV
from sniffles_tpu_torch.ops.segments import fma_f32

LOG10_UNDERFLOW = -323.3  # double underflow threshold in log10

# float32(1 / ln 10), the constant jnp.log10 multiplies XLA's log by
LOG10_E_F32 = np.float32(0.434294492)


def param_tensors(params: dict, device) -> dict:
    """Every parameter as a 0-d tensor on `device`, of the dtype JAX traces
    it as with x64 off: float32 for a float, int32 for an int or a bool; a
    tensor stays as it is (moved to `device`)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif isinstance(v, (bool, int, np.integer, np.bool_)):
            out[k] = torch.tensor(int(v), dtype=torch.int32, device=device)
        else:
            out[k] = torch.tensor(float(v), dtype=torch.float32, device=device)
    return out


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 natural log (Eigen's plog_float, Cephes'
    polynomial), with the fused multiply-adds of its compiled code: the
    bits jnp.log gives on the CPU. XLA's CPU code reads subnormals as 0
    (denormals-are-zero): 0 gives -inf, a negative value nan, inf inf."""
    f32 = torch.float32
    x_in = x.to(f32)
    bits = torch.clamp(x_in, min=torch.finfo(f32).tiny).view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(f32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(f32)
    below = m < torch.tensor(0.707106781186547524, dtype=f32)
    x = m - 1.0
    e = e - below.to(f32)
    x = x + torch.where(below, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = [torch.tensor(c, dtype=f32) for c in (
        7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
        1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
        3.3333331174E-1)]
    y0 = fma_f32(x, p[0], p[1])
    y1 = fma_f32(x, p[3], p[4])
    y2 = fma_f32(x, p[6], p[7])
    y0 = fma_f32(y0, x, p[2])
    y1 = fma_f32(y1, x, p[5])
    y2 = fma_f32(y2, x, p[8])
    y0 = fma_f32(y0, x3, y1)
    y0 = fma_f32(y0, x3, y2)
    y0 = fma_f32(y0, x3, torch.tensor(-2.12194440e-4, dtype=f32) * e)
    x = fma_f32(torch.tensor(-0.5, dtype=f32), x2, x) + y0
    out = fma_f32(torch.tensor(0.693359375, dtype=f32), e, x)
    out = torch.where(x_in == float("inf"), float("inf"), out)
    out = torch.where(x_in.abs() < torch.finfo(f32).tiny, float("-inf"), out)
    return torch.where(x_in <= -torch.finfo(f32).tiny, float("nan"), out)


@functools.lru_cache(maxsize=64)
def log10_constants(err, het_p) -> tuple:
    """The float32 log10 of the likelihoods' five probabilities, as jnp.log10
    gives them on the CPU: err, 1 - err, het_p, 1 - het_p and 1 - (1 - err)
    (the hom-alt likelihood takes p = 1 - err and log10(1 - p), which in
    float32 is not log10(err)); err and het_p are float32 values. Cached:
    a step's wrapper asks for them at every call."""
    f32 = np.float32
    err, het_p = f32(err), f32(het_p)
    x = torch.tensor([err, f32(1.0) - err, het_p, f32(1.0) - het_p,
                      f32(1.0) - (f32(1.0) - err)], dtype=torch.float32)
    return tuple(f32(v) for v in (xla_log_f32(x) * float(LOG10_E_F32)).tolist())


def _mean_nonzero(*vals):
    """round(mean of non-zero entries); (0, all_zero_flag) when none."""
    stacked = torch.stack(vals, dim=0).to(torch.float32)
    nz = (stacked != 0).to(torch.float32)
    cnt = nz.sum(0)
    s = stacked[0] * nz[0]
    for i in range(1, stacked.shape[0]):
        s = s + stacked[i] * nz[i]
    mean = torch.where(cnt > 0, s / torch.clamp(cnt, min=1), 0.0)
    return torch.round(mean), cnt == 0


def rescale_support_batch(svtype, svlen, support, long_ins_length, rescale_base,
                          rescale_mult):
    """(reference: postprocessing.py:162-171)"""
    is_long_ins = (svtype == SVTYPE_INS) & (svlen >= long_ins_length)
    scale = fma_f32(rescale_mult, svlen.to(torch.float32) / long_ins_length, rescale_base)
    rescaled = torch.round(support.to(torch.float32) * scale)
    return torch.where(is_long_ins, rescaled, support.to(torch.float32))


def genotype_batch(svtype: torch.Tensor, svlen: torch.Tensor, support: torch.Tensor,
                   coverage_upstream: torch.Tensor, coverage_start: torch.Tensor,
                   coverage_center: torch.Tensor, coverage_end: torch.Tensor,
                   coverage_downstream: torch.Tensor, support_sa: torch.Tensor,
                   params: dict, log10s: tuple | None = None) -> dict:
    """
    Returns gt_a, gt_b (alleles), gq, zscore, dr, dv, af, gt_failed and the
    genotyping coverage per candidate. `params`: genotype_error, ploidy,
    long_ins_length, rescale_base, rescale_mult, normalization_target (and
    dev_min_dup_vaf, 1/6 when absent). `log10s`: the five log10 constants
    (log10_constants) when the caller has them.
    """
    params = param_tensors(params, svtype.device)
    f32 = torch.float32
    err = params["genotype_error"].to(f32)
    het_p = 1.0 / params["ploidy"].to(f32)
    norm_target = params["normalization_target"].to(f32)
    if log10s is None:
        log10s = log10_constants(err.item(), het_p.item())
    c_err, c_1err, c_het, c_1het, c_11err = (
        torch.tensor(float(c), dtype=f32, device=svtype.device) for c in log10s)

    # Per-type support (reference: genotyping.py:186-191 InsertionGenotyper)
    supp = rescale_support_batch(svtype, svlen, support, params["long_ins_length"],
                                 params["rescale_base"], params["rescale_mult"])

    # Per-type coverage (reference: genotyping.py:96-116, 186-233)
    cov_default, fail_default = _mean_nonzero(coverage_start, coverage_center, coverage_end)
    cov_ins, fail_ins = _mean_nonzero(coverage_center)
    cov_dup_base, fail_dup = _mean_nonzero(coverage_start, coverage_end)
    cov_dup = cov_dup_base + torch.round(0.75 * supp)
    cov_inv_base, fail_inv = _mean_nonzero(coverage_upstream, coverage_downstream)
    cov_inv = cov_inv_base + torch.round(0.5 * supp)
    cov_del_sa, fail_del_sa = _mean_nonzero(coverage_start + support_sa,
                                            coverage_center + support_sa,
                                            coverage_end + support_sa)
    has_sa = support_sa > 0
    cov_del = torch.where(has_sa, cov_del_sa, cov_default)
    fail_del = torch.where(has_sa, fail_del_sa, fail_default)

    def by_type(ins, dup, inv, dele, default):
        return torch.where(svtype == SVTYPE_INS, ins,
               torch.where(svtype == SVTYPE_DUP, dup,
               torch.where(svtype == SVTYPE_INV, inv,
               torch.where(svtype == SVTYPE_DEL, dele, default))))

    coverage = by_type(cov_ins, cov_dup, cov_inv, cov_del, cov_default)
    gt_failed = by_type(fail_ins, fail_dup, fail_inv, fail_del, fail_default)

    coverage = torch.maximum(coverage, supp)  # support > coverage -> coverage = support
    af = supp / torch.clamp(coverage, min=1.0)

    # normalization to 250 (reference: genotyping.py:149-157)
    max_lead = torch.maximum(supp, coverage)
    norm = torch.where(max_lead > norm_target, norm_target / torch.clamp(max_lead, min=1.0),
                       torch.ones_like(max_lead))
    k = torch.round(supp * norm)
    n = torch.round(coverage * norm)

    # log10 likelihoods for (0,0), (0,1), (1,1): k * log10(p) + (n - k) *
    # log10(1 - p), the second product fused into the add
    nk = n - k

    def log10_binom(c_p, c_q):
        return fma_f32(nk, c_q, k * c_p)

    lq = torch.stack([log10_binom(c_err, c_1err), log10_binom(c_het, c_1het),
                      log10_binom(c_1err, c_11err)], dim=0)  # [3, N]

    # best first (ties keep genotype order, as the reference sort is stable)
    order = torch.argsort(-lq, dim=0, stable=True)
    lq_sorted = torch.take_along_dim(lq, order, dim=0)
    l1 = lq_sorted[0]
    l2 = lq_sorted[1]
    lz = lq[0]  # hom-ref likelihood

    # Reference underflow semantics: a likelihood below DBL_MIN is exactly
    # 0.0 and likelihood_ratio returns 0 -> quality 0.
    q2_zero = l2 < LOG10_UNDERFLOW
    qz_zero = lz < LOG10_UNDERFLOW
    sixty = torch.tensor(60.0, dtype=f32, device=svtype.device)
    gq = torch.where(q2_zero, 0.0, torch.minimum(sixty, torch.trunc(-10.0 * (l2 - l1))))
    z = torch.where(qz_zero, 0.0, torch.minimum(sixty, torch.trunc(-10.0 * (lz - l1))))

    best = order[0]  # 0 -> (0,0), 1 -> (0,1), 2 -> (1,1)
    i32 = torch.int32
    gt_a = (best == 2).to(i32)
    gt_b = (best >= 1).to(i32)

    # DUP VAF override: a DUP with af above the expected single-copy gain
    # reported hom-ref becomes 0/1 (reference: genotyping.py:172-181)
    min_dup_vaf = params.get("dev_min_dup_vaf")
    if min_dup_vaf is None:
        min_dup_vaf = torch.tensor(1 / 6.0, dtype=f32, device=svtype.device)
    update_dup = (svtype == SVTYPE_DUP) & (af >= min_dup_vaf)
    gt_b = torch.where(update_dup & (best == 0), 1, gt_b).to(i32)

    return {"gt_a": gt_a, "gt_b": gt_b, "gq": gq.to(i32), "zscore": z.to(i32),
            "dr": (coverage - supp).to(i32), "dv": supp.to(i32), "af": af,
            "gt_failed": gt_failed, "coverage": coverage}
