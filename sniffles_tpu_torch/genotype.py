"""Binomial genotype assignment for SV candidates.

Computes the diploid genotype (GT), genotype quality (GQ), allele depth
(DR/DV) and VAF for one candidate call from its read support and local
read depth, matching the behavior of the reference genotyper
(reference: genotyping.py:62-241) while organized as a dispatch table of
per-SV-type depth recipes feeding one shared likelihood routine.

Model: support ~ Binomial(depth, p) with p in {err, 1/ploidy, 1-err} for
genotypes 0/0, 0/1, 1/1.  Counts are rescaled so the larger of
support/depth is at most 250 before exponentiation.  GQ is the capped
Phred ratio between the best and second-best genotype; a separate
hom-ref Phred ratio ("z score") gates low-confidence calls into the GT
filter (reference: genotyping.py:124-183).

A copy of sniffles_tpu/genotype.py (combine re-QC uses it).
"""
from __future__ import annotations

import math


class UnknownGenotypeError(Exception):
    """No usable depth information at the candidate site."""


# Phred cap and count-normalization ceiling (reference: genotyping.py:126,170-171).
_PHRED_CAP = 60
_COUNT_CEILING = 250


def _phred_of_ratio(num: float, den: float) -> int:
    """Capped integer Phred score of the likelihood ratio num/den.

    Mirrors the reference's likelihood_ratio + "-10 log10, min 60"
    wrapping (reference: genotyping.py:36-43,170-171), including its
    treatment of non-positive ratios as score 0.
    """
    ratio = num / den
    if not ratio > 0:
        return 0
    try:
        lg = math.log(ratio, 10)
    except ValueError:
        lg = 0
    return min(_PHRED_CAP, int(-10 * lg))


def _binom_weight(k: int, n: int, p: float) -> float:
    """p^k (1-p)^(n-k); the nCk coefficient cancels in every ratio we take
    (reference: genotyping.py:28-33)."""
    try:
        return (p ** k) * ((1.0 - p) ** (n - k))
    except OverflowError:
        return 1.0


def _pooled_depth(points) -> int:
    """Round-mean of the informative span-point depths.

    Zero entries are uninformative and dropped first; an unknown (None)
    entry among the survivors drops to the known subset.  Raises
    UnknownGenotypeError when nothing informative remains
    (reference: genotyping.py:96-116).
    """
    informative = [d for d in points if d != 0]
    if informative and any(d is None for d in informative):
        informative = [d for d in informative if d is not None]
    if not informative:
        raise UnknownGenotypeError()
    return round(sum(informative) / len(informative))


# --- per-SV-type depth recipes -------------------------------------------
# Each recipe maps (call, support) -> pooled depth.  DUP/INV add back a
# fraction of the event's own support because spanning reads are split at
# the breakpoints and under-counted (reference: genotyping.py:206-223).

def _depth_default(call, support):
    return _pooled_depth((call.coverage_start, call.coverage_center, call.coverage_end))


def _depth_ins(call, support):
    return _pooled_depth((call.coverage_center,))


def _depth_del(call, support):
    sa = call.get_info("SUPPORT_SA")
    if sa:
        return _pooled_depth((call.coverage_start + sa,
                              call.coverage_center + sa,
                              call.coverage_end + sa))
    return _depth_default(call, support)


def _depth_dup(call, support):
    return _pooled_depth((call.coverage_start, call.coverage_end)) + round(support * 0.75)


def _depth_inv(call, support):
    return _pooled_depth((call.coverage_upstream, call.coverage_downstream)) + round(support * 0.5)


_DEPTH_RECIPES = {
    "INS": _depth_ins,
    "DEL": _depth_del,
    "DUP": _depth_dup,
    "INV": _depth_inv,
}


def _event_support(call, config) -> int:
    """INS support is rescaled upward for long events whose reads only
    partially traverse the insertion (reference: genotyping.py:186-191)."""
    if call.svtype == "INS":
        from sniffles_tpu_torch.postprocess import rescale_support
        return rescale_support(call, config)
    return call.support


def _z_gate_applies(call, config, z_score: int) -> bool:
    """Whether the hom-ref z score demotes this call to the GT filter.

    Mosaic mode never gates on z; large-INS detection exempts long
    insertions (reference: genotyping.py:118-122,196-203).
    """
    gated = z_score < config.genotype_min_z_score and not config.mosaic
    if (gated and call.svtype == "INS" and config.detect_large_ins
            and call.svlen >= config.long_ins_length):
        return False
    return gated


def assign_genotype(call, config, phase) -> None:
    """Genotype one candidate in place.

    Writes call.genotypes[0] = (a, b, GQ, DR, DV, phase) and the VAF info
    field; may demote call.filter to GT or GT_FAILED
    (reference: genotyping.py:124-183).
    """
    support = _event_support(call, config)
    try:
        depth = _DEPTH_RECIPES.get(call.svtype, _depth_default)(call, support)
    except UnknownGenotypeError:
        call.filter = "GT_FAILED"
        call.qc = False
        return

    depth = max(depth, support)
    vaf = support / float(depth)

    # Rescale counts so exponentiation stays in float range.
    widest = max(support, depth)
    if widest > _COUNT_CEILING:
        shrink = _COUNT_CEILING / float(widest)
        k, n = round(support * shrink), round(depth * shrink)
    else:
        k, n = support, depth

    err = config.genotype_error
    models = [((0, 0), _binom_weight(k, n, err)),
              ((0, 1), _binom_weight(k, n, 1.0 / config.genotype_ploidy)),
              ((1, 1), _binom_weight(k, n, 1.0 - err))]
    ranked = sorted(models, key=lambda m: m[1], reverse=True)

    total = sum(w for _, w in ranked)
    posteriors = [(gt, w / total) for gt, w in ranked]
    (best_gt, best_q), (_, runner_q) = posteriors[0], posteriors[1]
    homref_q = next(q for gt, q in posteriors if gt == (0, 0))

    z_score = _phred_of_ratio(homref_q, best_q)
    gq = _phred_of_ratio(runner_q, best_q)
    dup_rescued = call.svtype == "DUP" and vaf >= config.dev_min_dup_vaf

    if call.filter == "PASS" and _z_gate_applies(call, config, z_score):
        call.filter = "PASS" if dup_rescued else "GT"
        call.qc = not config.pass_only

    a, b = best_gt
    if dup_rescued and best_gt == (0, 0):
        a, b = 0, 1
    call.genotypes[0] = (a, b, gq, depth - support, support, phase)
    call.set_info("VAF", vaf)


def _inherited_phase(call):
    try:
        return call.genotypes[0][5]
    except (KeyError, IndexError):
        return None


class Genotyper:
    """API-compatible adapter over assign_genotype; SV-type dispatch is
    internal to the depth-recipe table rather than a class hierarchy."""

    def __init__(self, svcall, config, phase):
        self.svcall = svcall
        self.config = config
        self.phase = phase if phase is not None else _inherited_phase(svcall)

    def calculate(self):
        assign_genotype(self.svcall, self.config, self.phase)


# Kept for callers that look up a per-type genotyper class; every entry is
# the same adapter since dispatch happens in the depth-recipe table.
GENOTYPER_BY_TYPE = {t: Genotyper for t in _DEPTH_RECIPES}
