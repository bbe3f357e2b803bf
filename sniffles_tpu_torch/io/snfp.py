"""Population SNF: allele-frequency annotation against a merged cohort
(reference: snfp.py:25-201).

A population SNF stores PopulationVariant records (not SVCalls) in the
standard SNF block layout; combine mode looks up each merged call's
population AF by locus/length matching with an identity gate for INS.

Copied from sniffles_tpu/io/snfp.py.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, asdict
from typing import Optional

from sniffles_tpu_torch.config import SnifflesConfig
from sniffles_tpu_torch.io.snf import SNFileBase
from sniffles_tpu_torch.svcall import SVCall
from sniffles_tpu_torch.ops.edit_distance import edit_distance

log = logging.getLogger(__name__)


@dataclass
class PopulationVariant:
    """One cohort variant with its allele frequency and sample tallies
    (reference: snfp.py:25-107)."""
    svtype: str
    contig: str
    pos: int
    end: int
    svlen: int
    id: str
    alt: str

    af: float
    genotyped_sample_count: int
    variant_sample_count: int

    @staticmethod
    def _cohort_tallies(genotypes: dict[int, tuple]) -> tuple[float, int, int]:
        """(allele frequency, #genotyped samples, #variant samples) over a
        merged call's per-sample genotypes (reference: snfp.py:44-68)."""
        ploidy = SnifflesConfig.GLOBAL.genotype_ploidy
        alleles_seen = 0
        alleles_variant = 0
        genotyped = 0
        carriers = 0
        for gt in genotypes.values():
            if gt[0] == '.':
                continue
            genotyped += 1
            alleles_seen += ploidy
            dose = gt[0] + gt[1]
            alleles_variant += dose
            carriers += dose > 0
        return alleles_variant / alleles_seen, genotyped, carriers

    @classmethod
    def from_svcall(cls, svcall: SVCall) -> Optional['PopulationVariant']:
        """Build a cohort variant, or None when too few samples were
        genotyped (reference: snfp.py:70-89)."""
        cfg = SnifflesConfig.GLOBAL
        af, genotyped, carriers = cls._cohort_tallies(svcall.genotypes)
        if genotyped / len(cfg.snf_input_info) < cfg.dev_population_min_gt:
            return None
        return cls(contig=svcall.contig, pos=svcall.pos, id=svcall.id, alt=svcall.alt,
                   svtype=svcall.svtype, svlen=svcall.svlen, end=svcall.end,
                   af=af, genotyped_sample_count=genotyped, variant_sample_count=carriers)

    def match(self, svcall: SVCall) -> int | None:
        """Distance if svcall is this variant, else None
        (reference: snfp.py:91-107)."""
        config = SnifflesConfig.GLOBAL
        dist = abs(self.pos - svcall.pos) + abs(abs(self.svlen) - abs(svcall.svlen))
        shorter = float(min(abs(self.svlen), abs(svcall.svlen)))
        if dist > config.combine_match * math.sqrt(shorter) or dist > config.combine_match_max:
            return None

        if self.svtype == 'INS' and (limit := config.combine_pctseq):
            # bounded form: the gate only needs d vs svlen*(1-limit)
            k = int(math.ceil(self.svlen * (1.0 - limit)))
            if (self.svlen - edit_distance(self.alt, svcall.alt, k=k)) / self.svlen <= limit:
                return None
        return dist


@dataclass
class PopulationInfo:
    name: str
    description: str
    version: int
    size: int


class PopulationSNF(SNFileBase):
    """SNF file holding PopulationVariants, with cached per-contig block
    loading for AF lookup (reference: snfp.py:118-192)."""

    _blocks = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._blocks = {}

    def _block_base(self, pos: int) -> int:
        return int(pos / self.config.snf_block_size) * self.config.snf_block_size

    def get_population_AF(self, svcall: SVCall) -> tuple[float, int] | None:
        """(AF rounded to 5 places, genotyped sample count) of the closest
        matching cohort variant, or None (reference: snfp.py:131-155)."""
        if svcall.contig not in self._blocks:
            self._blocks[svcall.contig] = self.get_all_blocks(svcall.contig)

        block_key = str(self._block_base(svcall.pos))
        winner = None
        winner_dist = None
        try:
            candidates = self._blocks[svcall.contig][block_key][svcall.svtype]
        except KeyError:
            return None
        for pv in candidates:
            dist = pv.match(svcall)
            if dist is not None and (winner_dist is None or dist < winner_dist):
                winner, winner_dist = pv, dist
        if winner is None:
            return None
        return round(winner.af, 5), winner.genotyped_sample_count

    def _create_header(self, config: SnifflesConfig, main_index: dict, snf_candidate_count: int) -> dict:
        header = super()._create_header(config, main_index, snf_candidate_count)
        header['population'] = asdict(PopulationInfo(
            version=1, name='Population', description='A sample population',
            size=len(config.snf_input_info)))
        return header

    def read_header(self):
        super().read_header()
        try:
            self.header['population'] = PopulationInfo(**self.header['population'])
        except Exception:
            log.warning('Unable to deserialize population information from SNF header.',
                        exc_info=True)

    def _calculate_contig_coverages(self, *args, **kwargs) -> dict:
        return {}

    def store(self, svcand: SVCall) -> bool:
        variant = PopulationVariant.from_svcall(svcand)
        if variant is not None:
            super().store(variant)
        return variant is not None


from sniffles_tpu_torch.compat import alias_module_for_pickle

alias_module_for_pickle("sniffles.snfp", __name__,
                        [PopulationVariant, PopulationInfo])
