"""Post-processing needed by combine: the re-QC genotyper entry point
for SNF files from builds that need re-QC (pipeline/tasks.py
CombineTask._bin_candidates). Copied from sniffles_tpu/postprocess.py;
the call-path QC screens and annotation are not part of the combine
slice (reference: postprocessing.py:162-171, 607-623).
"""
from __future__ import annotations

from sniffles_tpu_torch.svcall import SVCall


def rescale_support(svcall, config) -> int:
    """Long insertions are only partially traversed by reads, so raw read
    support under-counts; scale it up with length
    (reference: postprocessing.py:162-171)."""
    if svcall.svtype != "INS" or svcall.svlen < config.long_ins_length:
        return svcall.support
    growth = config.long_ins_rescale_mult * (float(svcall.svlen) / config.long_ins_length)
    return round(svcall.support * (config.long_ins_rescale_base + growth))


def genotype_sv(svcall: SVCall, config, phase: tuple | None = None):
    """Run the genotyper, then let hom-alt calls bypass a failed haplotype
    filter (reference: postprocessing.py:607-623)."""
    from sniffles_tpu_torch.genotype import GENOTYPER_BY_TYPE, Genotyper

    GENOTYPER_BY_TYPE.get(svcall.svtype, Genotyper)(svcall, config, phase).calculate()

    try:
        a, b, gq, dr, dv, phase = svcall.genotypes[0]
        if a == b == 1 and (phase_info := svcall.get_info("PHASE")):
            hp, ps, hp_supp, ps_supp, hp_filt, ps_filt = phase_info.split(",")
            if hp != "0":
                svcall.genotypes[0] = (a, b, gq, dr, dv, (hp, ps))
                svcall.set_info("PHASE", f"{hp},{ps},{hp_supp},{ps_supp},PASS,{ps_filt}")
    except KeyError:
        pass
