"""Genomic interval model: 0-based, half-open (contig, start, end)
triples parsed from BED lines or contig:start-end strings
(reference: region.py:18-57)."""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger(__name__)


@dataclass
class Region:
    contig: str
    start: int
    end: int

    @classmethod
    def _build(cls, contig, start, end, source, label) -> Optional['Region']:
        try:
            return cls(contig, int(start), int(end))
        except ValueError as ex:
            log.warning(f'Invalid {label}: {source} ({ex})')
            return None

    @classmethod
    def from_bed_line(cls, line: str) -> Optional['Region']:
        cols = line.split('\t')
        if len(cols) < 3:
            log.warning(f'Invalid region line: {line} '
                        f'(not enough values to unpack (expected 3, got {len(cols)}))')
            return None
        return cls._build(cols[0], cols[1], cols[2], line, "region line")

    @classmethod
    def from_string(cls, value: str) -> Optional['Region']:
        try:
            contig, span = value.split(':')
            start, end = span.split('-')
        except ValueError as ex:
            log.warning(f'Invalid region string: {value} ({ex})')
            return None
        return cls._build(contig, start, end, value, "region string")

    def __str__(self) -> str:
        return f'{self.contig}:{self.start}-{self.end}'


from sniffles_tpu_torch.compat import alias_module_for_pickle

alias_module_for_pickle("sniffles.region", __name__, [Region])
