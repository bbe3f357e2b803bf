"""Lead (raw SV signature) extraction from BAM alignments.

Produces the same signature stream as the reference extraction
(reference: leadprov.py): CIGAR indels >= minsvlen_screen, long
soft-clips as putative long INS, clip-only single-break signatures,
split-read signatures from SA tags, and dedicated BND leads.  Consumes
records from the built-in BAM decoder (io/bam.py) or the native C++
decoder (csrc/host/bamcore.cc through io/native.py).

The per-base coverage array and the binned leadtab produced here feed
both the exact host pipeline and (packed by parallel/device_call.py) the
device clustering. Copied from sniffles_tpu/leads.py, both region
scans; the regional NM statistic stays on the provider (ROADMAP C2).
"""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Optional, Iterator

import numpy as np

from sniffles_tpu_torch import util
from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.region import Region
from sniffles_tpu_torch.svcall import SVCallBNDInfo
from sniffles_tpu_torch.io.bam import (BamRead, CINS, CDEL, CSOFT_CLIP, CHARD_CLIP, CMATCH,
                                 CEQUAL, CDIFF, CREF_SKIP, CPAD)

log = logging.getLogger(__name__)

_CLIP_OPS = (CSOFT_CLIP, CHARD_CLIP)


@dataclass(slots=True)
class Lead:
    """A raw SV signature from one read (reference: leadprov.py:34-141).

    Slots: leads are the most numerous objects in the pipeline (millions
    at WGS scale), so per-instance dicts dominate memory without them.
    `__setstate__` also accepts the reference's dict-form pickle state so
    Leads inside reference-written SNF blocks still load (compat.py maps
    sniffles.leadprov.Lead here).
    """

    read_qname: str = None
    read_id: int = None
    contig: str = None
    ref_start: int = None
    ref_end: int = None
    svtype: str = None
    svlen: Optional[int] = None
    qry_start: int = None
    qry_end: int = None
    strand: str = None
    mapq: int = None
    source: str = None
    nm: float = None
    seq: Optional[str] = None
    svtypes_starts_lens: list = None
    bnd_info: Optional[SVCallBNDInfo] = None
    phase_set: str = None
    hap: str = "0"
    read_len: int = 0
    is_sa: bool = False
    sa_same_strand: bool = False

    def __setstate__(self, state):
        from sniffles_tpu_torch.compat import _apply_pickle_state
        _apply_pickle_state(self, state)

    @classmethod
    def for_bnd(cls, read_id: int, read: BamRead) -> Optional['Lead']:
        """BND lead from the SA tag of a read (reference: leadprov.py:57-132).

        Unlike the reference code (which bails out with None when the SA
        strand equals the read strand, leadprov.py:83-84), this also
        extracts same-strand junctions — the reference's own truth tests
        (src/tests/test_bnd_leads.py, "red" cases and the HG002 case)
        require it. The caller (LeadProvider.iter_region) gates which of
        these reach the calling pipeline.
        """
        first_op, first_len = read.cigartuples[0]
        last_op, last_len = read.cigartuples[-1]
        clip_head = first_len if first_op in _CLIP_OPS else 0
        clip_tail = last_len if last_op in _CLIP_OPS else 0

        # The larger clip marks the side where the read continues elsewhere.
        if clip_head > clip_tail:
            anchor, is_first = read.reference_start + 1, False
        else:
            anchor, is_first = read.reference_end, True
        own_strand = "-" if read.is_reverse else "+"

        for entry in read.get_tag("SA").split(";"):
            if not entry:
                continue
            mate_contig, sa_pos, sa_strand, sa_cigar, _sa_mapq, sa_nm = entry.split(",")
            try:
                head_clip, tail_clip, mate_refspan, _ = CIGAR_analyze(sa_cigar)
            except Exception as e:
                util.error(f"Malformed CIGAR '{sa_cigar}' with pos {sa_pos} of read "
                           f"'{read.query_name}' ({e}). Skipping.")
                return None

            mate_start = int(sa_pos) - 1  # SA positions are 1-based
            mate_is_reverse = tail_clip > head_clip
            if mate_is_reverse:
                mate_anchor = mate_start + mate_refspan
            elif is_first:
                mate_anchor = mate_start + 1
            elif sa_strand == own_strand:
                mate_anchor = mate_start + mate_refspan
            else:
                mate_anchor = mate_start + 2

            return cls(
                read_qname=read.query_name,
                read_id=read_id,
                contig=read.reference_name,
                ref_start=anchor,
                ref_end=anchor,
                svtype="BND",
                svlen=0,
                qry_start=read.query_alignment_start,
                qry_end=read.query_alignment_end,
                strand=own_strand,
                mapq=read.mapping_quality,
                source="BND_SA",
                nm=int(sa_nm) if read.has_tag("NM") else None,
                seq=None,
                bnd_info=SVCallBNDInfo(mate_contig, mate_anchor, is_first, mate_is_reverse),
                sa_same_strand=own_strand == sa_strand,
            )
        return None


_CIGAR_TOKEN = re.compile(r"(\d+)([A-Z=])")

# op -> (counts toward read span, counts toward ref span)
_CIGAR_SPANS = {
    "M": (True, True), "=": (True, True), "X": (True, True),
    "I": (True, False), "D": (False, True), "N": (False, True),
}


def CIGAR_analyze(cigar: str) -> tuple[int, int, int, int]:
    """(clip_start, clip_end, refspan, readspan) from a CIGAR string
    (reference: leadprov.py:144-176)."""
    refspan = readspan = 0
    leading_clip = None
    clip_total = 0
    at = 0
    for m in _CIGAR_TOKEN.finditer(cigar):
        if m.start() != at:
            raise ValueError(f"Unparsable CIGAR at offset {at}: '{cigar}'")
        at = m.end()
        n, op = int(m.group(1)), m.group(2)
        spans = _CIGAR_SPANS.get(op)
        if spans is not None:
            readspan += n if spans[0] else 0
            refspan += n if spans[1] else 0
        elif op in "SH":
            if leading_clip is None and readspan + refspan > 0:
                leading_clip = clip_total
            clip_total += n
        else:
            raise ValueError(f"Unknown CIGAR operation: '{op}'")
    rest = cigar[at:]
    if rest and not rest.isdigit():
        raise ValueError(f"Unparsable CIGAR tail: '{cigar}'")
    if leading_clip is None:
        leading_clip = clip_total
    return leading_clip, clip_total - leading_clip, refspan, readspan


# (add_read, add_ref, event, Δ coverage) per numeric op (reference: leadprov.py:180-195)
OPLIST = [
    (1, 1, 0, 1),  # M
    (1, 0, 1, 0),  # I
    (0, 1, 1, 0),  # D
    (0, 1, 0, 0),  # N
    (1, 0, 1, 0),  # S
    (0, 0, 0, 0),  # H
    (0, 0, 0, 0),  # P
    (1, 1, 0, 1),  # =
    (1, 1, 0, 1),  # X
]


def get_cigar_indels(read: BamRead, minoplen: int = 10) -> tuple[int, int, int, int]:
    """Total inserted/deleted bases, plus the share from ops above
    minoplen (reference: leadprov.py:198-224)."""
    totals = {CINS: 0, CDEL: 0}
    larges = {CINS: 0, CDEL: 0}
    for op, n in read.cigartuples:
        if op in totals:
            totals[op] += n
            if n > minoplen:
                larges[op] += n
    return totals[CINS], totals[CDEL], larges[CINS], larges[CDEL]


# --------------------------------------------------------------------------
# Split-read lead extraction


def _split_alignment_chain(read_id, read: BamRead, contig, config,
                           read_nm, hap, ps) -> Optional[list[Lead]]:
    """The read's primary alignment plus every SA entry as SPLIT leads in
    one list, or None when the read carries too many splits or a bad SA
    CIGAR (reference: leadprov.py:231-265)."""
    sa_entries = [part.split(",") for part in read.get_tag("SA").split(";") if part]
    allowed = config.max_splits_base + config.max_splits_kb * (read.query_length / 1000.0)
    if len(sa_entries) > allowed:
        return None

    if read.is_reverse:
        prim_qry_start = read.query_length - read.query_alignment_end
    else:
        prim_qry_start = read.query_alignment_start

    chain = [Lead(
        read_qname=read.query_name, read_id=read_id, contig=contig,
        ref_start=read.reference_start,
        ref_end=read.reference_start + read.reference_length,
        svtype="?", qry_start=prim_qry_start,
        qry_end=prim_qry_start + read.query_alignment_length,
        strand="-" if read.is_reverse else "+",
        mapq=read.mapping_quality, source="SPLIT_PRIM", nm=read_nm,
        hap=str(hap), phase_set=str(ps), is_sa=read.is_supplementary)]

    for refname, pos, strand, cigar, mapq, _nm in sa_entries:
        try:
            clip_fwd, clip_rev, refspan, readspan = CIGAR_analyze(cigar)
        except Exception as e:
            util.error(f"Malformed CIGAR '{cigar}' with pos {pos} of read "
                       f"'{read.query_name}' ({e}). Skipping.")
            return None
        sa_start = int(pos) - 1
        sa_qry_start = clip_rev if strand == "-" else clip_fwd
        chain.append(Lead(
            read_qname=read.query_name, read_id=read_id, contig=refname,
            ref_start=sa_start, ref_end=sa_start + refspan,
            svtype="?", qry_start=sa_qry_start, qry_end=sa_qry_start + readspan,
            strand=strand, mapq=int(mapq), source="SPLIT_SUP", nm=read_nm,
            hap=str(hap), phase_set=str(ps), is_sa=read.is_supplementary))
    return chain


def _lead_from_hint(lead, hint, read_id, hap, ps, is_supp, config) -> Lead:
    """Materialize one classified split hint as a lead
    (reference: leadprov.py:275-310)."""
    svtype, svstart, arg = hint
    if svtype == "BND":
        out = Lead(read_qname=lead.read_qname, read_id=lead.read_id,
                   contig=lead.contig, ref_start=svstart, ref_end=svstart,
                   svtype="BND", svlen=config.bnd_cluster_length,
                   qry_start=lead.qry_start, qry_end=lead.qry_end,
                   strand=lead.strand, mapq=lead.mapq, source=lead.source,
                   nm=lead.nm, seq=None,
                   hap=str(hap), phase_set=str(ps), is_sa=is_supp)
        out.bnd_info = arg
        return out
    span_end = svstart + arg if (arg is not None and svtype != "INS") else svstart
    return Lead(read_qname=lead.read_qname, read_id=lead.read_id,
                contig=lead.contig, ref_start=svstart, ref_end=span_end,
                svtype=svtype, svlen=arg,
                qry_start=lead.qry_start, qry_end=lead.qry_end,
                strand=lead.strand, mapq=lead.mapq, source=lead.source,
                nm=lead.nm, seq=lead.seq if svtype == "INS" else None,
                hap=str(hap), phase_set=str(ps), is_sa=is_supp)


def read_itersplits(read_id, read: BamRead, contig, config, read_nm,
                    read_hap, read_ps) -> Iterator[Lead]:
    """Leads from a primary read's supplementary alignments
    (reference: leadprov.py:227-355)."""
    chain = _split_alignment_chain(read_id, read, contig, config,
                                   read_nm, read_hap, read_ps)
    if chain is None:
        return
    chain = sv.classify_splits(read, chain, config, contig)

    for i, lead in enumerate(chain):
        # mapq gate over the pair that produced the hint
        pair_mapq = min(lead.mapq, chain[max(0, i - 1)].mapq)
        drop_lowqual = (not config.dev_keep_lowqual_splits
                        and pair_mapq < config.mapq)
        for hint in lead.svtypes_starts_lens:
            if drop_lowqual or hint[0] == "NOSV":
                continue
            yield _lead_from_hint(lead, hint, read_id, read_hap, read_ps,
                                  read.is_supplementary, config)


# --------------------------------------------------------------------------
# Region scanning / leadtab construction


class RefHapBins:
    """REF-side haplotype counts per cluster bin, dict-like
    (bin_pos -> [h0, h1, h2]) but backed by a (3, n_bins) array.

    The reference keeps a dict with one entry per covered 100bp bin
    (leadprov.py:387-398) — at WGS scale that is millions of small-list
    entries built to serve a few thousand seed-cluster lookups. Lookup
    semantics match the dict: a bin is 'present' iff any haplotype
    count is nonzero."""
    __slots__ = ("binsize", "counts")

    def __init__(self, binsize: int):
        self.binsize = binsize
        self.counts = None            # (3, n_bins) int64, grown on demand

    def _ensure(self, n_bins: int) -> None:
        if self.counts is None:
            self.counts = np.zeros((3, max(n_bins, 256)), dtype=np.int64)
        elif self.counts.shape[1] < n_bins:
            grown = np.zeros((3, max(n_bins, 2 * self.counts.shape[1])),
                             dtype=np.int64)
            grown[:, :self.counts.shape[1]] = self.counts
            self.counts = grown

    def add_counts(self, counts: np.ndarray) -> None:
        """Accumulate a (3, n) per-bin count block (bin 0 = position 0)."""
        self._ensure(counts.shape[1])
        self.counts[:, :counts.shape[1]] += counts

    def _row(self, key):
        b = key // self.binsize
        if self.counts is None or not (0 <= b < self.counts.shape[1]):
            return None
        row = self.counts[:, b]
        if not row.any():
            return None
        return [int(row[0]), int(row[1]), int(row[2])]

    def get(self, key, default=None):
        row = self._row(key)
        return default if row is None else row

    def __contains__(self, key) -> bool:
        return self._row(key) is not None

    def __getitem__(self, key):
        row = self._row(key)
        if row is None:
            raise KeyError(key)
        return row


class LeadProvider:
    """Builds the binned leadtab + coverage array for a set of regions
    (reference: leadprov.py:358-670)."""
    coverage: np.ndarray

    def __init__(self, config, read_id_offset, contig: str):
        self.config = config
        self.contig = contig
        self.start = self.end = None

        self.leadtab = {t: {} for t in sv.ALL_TYPES}
        self.leadcounts = {t: 0 for t in sv.ALL_TYPES}
        self.leadhapcount = {t: {} for t in sv.ALL_TYPES}
        self.leadhapcount["REF"] = RefHapBins(config.cluster_binsize)

        # hot-loop constant (record_lead runs per lead, millions at WGS
        # scale; the attribute chain was measurable)
        self._max_reads_bin = config.consensus_max_reads_bin
        self.covrtab_fwd, self.covrtab_rev = {}, {}
        self.covrtab_min_bin = None
        self.read_id = read_id_offset
        self.read_count = 0
        self.overflow = 0
        self.average_regional_nm = 0.0

    # -- accumulators -------------------------------------------------------

    def fold_hap_spans(self, spans: list, binsize: int) -> None:
        """REF-side haplotype bin counts (reference: leadprov.py:387-398),
        batched: `spans` holds (hp, pos_leadtab, end_leadtab) per read;
        bins cover [pos_leadtab, end_leadtab) exclusive, accumulated per
        haplotype with difference arrays."""
        if not spans:
            return
        arr = np.asarray(spans, dtype=np.int64)
        hps = arr[:, 0]
        b0 = arr[:, 1] // binsize
        b1 = arr[:, 2] // binsize
        n_bins = int(b1.max()) + 1
        block = np.zeros((3, n_bins), dtype=np.int64)
        for hpv in np.unique(hps):
            pick = hps == hpv
            d = np.zeros(n_bins + 1, dtype=np.int64)
            np.add.at(d, b0[pick], 1)
            np.add.at(d, np.minimum(b1[pick], n_bins), -1)
            block[int(hpv)] = np.cumsum(d[:n_bins])
        self.leadhapcount["REF"].add_counts(block)

    def record_lead(self, ld: Lead, pos_leadtab: int) -> None:
        """File one lead into its svtype/bin slot, tracking per-bin
        haplotype counts and dropping sequences past the per-bin cap
        (reference: leadprov.py:400-418)."""
        by_bin = self.leadtab[ld.svtype]
        haps = self.leadhapcount[ld.svtype]
        hp = int(ld.hap)
        slot = by_bin.get(pos_leadtab)
        if slot is None:
            by_bin[pos_leadtab] = [ld]
            fresh = [0, 0, 0]
            fresh[hp] = 1
            haps[pos_leadtab] = fresh
        else:
            slot.append(ld)
            if len(slot) > self._max_reads_bin:
                ld.seq = None
            haps[pos_leadtab][hp] += 1
        self.leadcounts[ld.svtype] += 1

    def _mask_N_coverage(self, regions: list[Region] = None) -> None:
        """Zero coverage over N runs in the reference genome
        (reference: leadprov.py:420-443)."""
        if not self.config.reference:
            return
        try:
            from sniffles_tpu_torch.io.fasta import FastaFile
            fasta = FastaFile(self.config.reference)
        except Exception as e:
            log.warning(f'Unable to mask N regions in coverage vector, reference could not '
                        f'be opened: {e}')
            return
        try:
            if regions is None:
                bases = np.frombuffer(fasta.fetch(self.contig).encode('ascii'), dtype=np.uint8)
            else:
                bases = np.zeros(len(self.coverage), dtype=np.uint8)
                for region in regions:
                    window = np.frombuffer(
                        fasta.fetch(region.contig, region.start, region.end).encode('ascii'),
                        dtype=np.uint8)
                    bases[region.start:region.end] = window
            self.coverage[bases == ord('N')] = 0
        except Exception as e:
            log.warning(f'Unable to mask N regions in coverage vector: {e}')

    def build_leadtab(self, regions: list[Region], bam) -> list[Lead]:
        assert self.start is None and self.end is None
        binsize = self.config.cluster_binsize
        self.coverage = np.zeros(bam.get_reference_length(self.contig), dtype=np.uint16)

        outside: list[Lead] = []
        for region in regions:
            if self.contig != region.contig:
                raise Exception(f"Region contig '{region.contig}' does not match LeadProvider "
                                f"contig '{self.contig}'")
            self.start = region.start if self.start is None else min(region.start, self.start)
            # NB the running max compares region *starts*, as the reference
            # does (leadprov.py:459)
            self.end = region.end if self.end is None else max(region.start, self.end)
            self.covrtab_min_bin = (int(self.start / self.config.coverage_binsize)
                                    * self.config.coverage_binsize)

            for ld in self.iter_region(bam, region):
                if region.contig == ld.contig and region.start <= ld.ref_start < region.end:
                    self.record_lead(ld, int(ld.ref_start / binsize) * binsize)
                else:
                    outside.append(ld)

        self._mask_N_coverage(regions)
        return outside

    # -- per-read scanning --------------------------------------------------

    def iter_region(self, bam, region: Region) -> Iterator[Lead]:
        """Per-read scan of one region (reference: leadprov.py:474-581).

        The native C++ scan (csrc/host/bamcore.cc, built at first use;
        a failed build raises) for a BAM; the pure-Python scan below, of
        equal output, for a CRAM, under --no-native, and with
        --dev-trace-read, which needs per-read visibility.
        """
        if (not self.config.no_native and not self.config.dev_trace_read
                and hasattr(bam, "scan_region")):
            yield from self._iter_region_native(bam, region)
        else:
            yield from self._iter_region_python(bam, region)

    def _read_passes(self, read, region, mapq_min, alen_min, exclude_flags) -> bool:
        """Whole-read filter (reference: leadprov.py:494-503); reads are
        assigned to the task whose region contains their start."""
        if (read.mapping_quality < mapq_min or read.is_secondary
                or read.query_alignment_length < alen_min):
            return False
        if exclude_flags is not None and read.flag & exclude_flags:
            return False
        return region.start <= read.reference_start < region.end

    def _iter_region_python(self, bam, region: Region) -> Iterator[Lead]:
        config = self.config
        advanced_tags = config.qc_nm_measure or config.phase
        mapq_min, alen_min = config.mapq, config.min_alignment_length
        exclude_flags = config.exclude_flags
        binsize = config.cluster_binsize
        trace_read = config.dev_trace_read
        coverage = self.coverage

        nm_sum = 0
        nm_count = 0
        hap_spans: list[tuple[int, int, int]] = []

        for read in bam.fetch(region.contig, region.start, region.end):
            if trace_read and read.query_name in trace_read:
                print(f"[DEV_TRACE_READ] [0b/4] [LeadProvider.iter_region] [{region}] "
                      f"[{read.query_name}] has been fetched and is entering pre-filtering")
            if not self._read_passes(read, region, mapq_min, alen_min, exclude_flags):
                continue

            hp = read.get_tag("HP") if read.has_tag("HP") else 0
            ps = read.get_tag("PS") if read.has_tag("PS") else "NULL"

            self.read_id += 1
            self.read_count += 1
            curr_read_id = self.read_id
            coverage[read.reference_start:read.reference_end] += 1

            has_sa = read.has_tag("SA")
            use_clips = config.detect_large_ins and not read.is_supplementary and not has_sa

            nm = -1
            if advanced_tags and read.has_tag("NM"):
                # large indel events are SVs, not sequencing errors: remove
                # them from the per-read mismatch rate
                _, _, *large_ops = get_cigar_indels(read)
                nm = (read.get_tag("NM") - sum(large_ops)) / float(read.query_alignment_length + 1)
                nm_sum += nm
                nm_count += 1

            if trace_read and read.query_name in trace_read:
                print(f"[DEV_TRACE_READ] [0b/4] [LeadProvider.iter_region] [{region}] "
                      f"[{read.query_name}] passed pre-filtering (whole-read), begin to "
                      f"extract leads")

            for lead in self.read_iterindels(curr_read_id, read, region.contig, use_clips,
                                             read_nm=nm, read_hap=hp, read_ps=ps):
                if trace_read and read.query_name in trace_read:
                    print(f"[DEV_TRACE_READ] [1/4] [leadprov.read_iterindels] [{region}] "
                          f"[{read.query_name}] new lead: {lead}")
                yield lead

            if has_sa:
                # Same-strand junctions within one contig are colinear
                # splits (INS/DEL/DUP) handled by classify_splits; emitting
                # them as BNDs too would duplicate calls (reference keeps
                # them out by bailing in for_bnd, leadprov.py:83-84).
                # Inter-contig same-strand junctions are real translocation
                # breakends (test_bnd_leads.py "red" cases) and are kept.
                if lead := Lead.for_bnd(curr_read_id, read):
                    if (not lead.sa_same_strand
                            or lead.bnd_info.mate_contig != lead.contig):
                        yield lead
                if not read.is_supplementary:
                    yield from read_itersplits(curr_read_id, read, region.contig, config,
                                               read_nm=nm, read_hap=hp, read_ps=ps)

            # record haplotype counts over the read's span (folded in one
            # batch after the scan; per-bin dict updates per read were a
            # top-3 cost of this loop)
            if region.start <= read.reference_start < region.end:
                hap_spans.append((hp,
                                  int(read.reference_start / binsize) * binsize,
                                  int(read.reference_end / binsize) * binsize))

        self.fold_hap_spans(hap_spans, binsize)
        log.debug(f'Processed {self.read_count} reads in region '
                  f'{region.contig}:{region.start}-{region.end}')

        # Per-task regional NM statistic of the last region scanned. The
        # reference writes it into the shared config (leadprov.py:577-578);
        # here it stays on this provider, so a decode-ahead scan of the next
        # task cannot change the threshold this task's QC reads.
        self.average_regional_nm = nm_sum / float(max(1, nm_count))

    def _iter_region_native(self, bam, region: Region) -> Iterator[Lead]:
        """Native-decoder scan with identical semantics to the Python path:
        per-read filtering, coverage, NM statistics, CIGAR indel/clip
        leads from pre-extracted events, and full Python split-read
        handling only for reads carrying an SA tag."""
        config = self.config
        qc_nm = config.qc_nm_measure
        phase = config.phase
        advanced_tags = qc_nm or phase
        mapq_min = config.mapq
        alen_min = config.min_alignment_length
        exclude_flags = config.exclude_flags if config.exclude_flags is not None else 0
        minsvlen = config.minsvlen_screen
        longinslen = config.long_ins_length / 2.0
        seq_cache_maxlen = config.dev_seq_cache_maxlen
        detect_large_ins = config.detect_large_ins
        ld_binsize = config.cluster_binsize
        nm_sum = 0.0
        nm_count = 0
        coverage = self.coverage
        hap_diff = None  # (3, n_bins+1) per-hp difference accumulator

        from sniffles_tpu_torch.io import native
        from sniffles_tpu_torch.io.bam import parse_record, FREVERSE, FSECONDARY, FSUPPLEMENTARY
        from sniffles_tpu_torch.io.bam import CINS as OP_I, CDEL as OP_D, CSOFT_CLIP as OP_S

        for res, mask in bam.scan_region(region.contig, region.start, region.end,
                                         min_event_len=minsvlen):
            c = res.cols
            ev_rec = res.events["rec_index"]
            pos_arr = c["pos"]
            flag_arr = c["flag"]
            qalen_arr = c["qalen"]
            ref_len_arr = c["ref_len"]

            # Vectorized per-read filtering (reference: leadprov.py:494-503)
            passing = (mask & (c["mapq"] >= mapq_min)
                       & ((flag_arr & (FSECONDARY | exclude_flags)) == 0)
                       & (qalen_arr >= alen_min)
                       & (pos_arr >= region.start) & (pos_arr < region.end))
            idxs = np.nonzero(passing)[0]
            n_pass = len(idxs)
            if n_pass == 0:
                continue

            # read ids: sequential in record order
            read_ids = self.read_id + 1 + np.arange(n_pass, dtype=np.int64)
            self.read_id += n_pass
            self.read_count += n_pass

            # coverage: batched difference-array accumulation
            starts = pos_arr[idxs].astype(np.int64)
            ends = starts + ref_len_arr[idxs]
            lo_bp = int(starts.min())
            hi_bp = int(min(ends.max(), len(coverage)))
            # one native pass builds the interval difference array AND
            # prefix-adds it into the coverage track (scratch reused)
            native.coverage_add(starts, ends, coverage, lo_bp, hi_bp)

            # NM statistics, vectorized (reference: leadprov.py:517-529)
            nm_raw = c["nm"][idxs]
            nm_vals = np.where(
                nm_raw >= 0,
                (nm_raw - c["large_indel_sum"][idxs]) / (qalen_arr[idxs] + 1.0),
                -1.0)
            if advanced_tags:
                has_nm = nm_raw >= 0
                nm_sum += float(nm_vals[has_nm].sum())
                nm_count += int(has_nm.sum())

            # haplotype/REF-bin counts: accumulate per-region difference
            # arrays across batches, folded into the leadhapcount dict
            # ONCE after the scan (a per-batch dict fold was ~1.5M dict
            # ops on a 30x multi-contig run)
            hp_arr = np.clip(c["hp"][idxs], 0, 2)
            bin_start = (starts // ld_binsize).astype(np.int64)
            bin_end = (ends // ld_binsize).astype(np.int64)
            if hap_diff is None or hap_diff.shape[1] <= int(bin_end.max()) + 1:
                need = max(int(bin_end.max()) + 2,
                           len(coverage) // ld_binsize + 2)
                grown = np.zeros((3, need), dtype=np.int64)
                if hap_diff is not None:
                    grown[:, :hap_diff.shape[1]] = hap_diff
                hap_diff = grown
            np.add.at(hap_diff, (hp_arr, bin_start), 1)
            np.add.at(hap_diff, (hp_arr, bin_end), -1)

            # Only reads producing leads need Python-side work
            has_events = np.zeros(len(pos_arr), dtype=bool)
            has_events[ev_rec] = True
            has_sa_arr = c["sa_off"] >= 0
            interesting = idxs[(has_events | has_sa_arr)[idxs]]
            if len(interesting) == 0:
                continue

            # Native split-chain parse for all SA carriers of the batch
            # (bamcore_scan_splits): SA tag tokenization, CIGAR analysis,
            # query-order sort, pair classification and BND mate geometry
            # all happen in C; the loop below only materializes Lead
            # objects from the returned columns. Reads the scanner flags
            # (malformed SA) fall back to the exact per-read Python path.
            sa_sub = interesting[has_sa_arr[interesting]]
            if len(sa_sub):
                want = np.where(
                    (flag_arr[sa_sub] & FSUPPLEMENTARY) != 0, 1, 3).astype(np.uint8)
                split_bnd, split_hints = native.scan_splits(
                    res.buf, c["offset"][sa_sub], c["rec_len"][sa_sub], want,
                    region.contig,
                    minsvlen=minsvlen,
                    long_ins_half=config.long_ins_length * 0.5,
                    seq_cap=seq_cache_maxlen,
                    max_splits_base=config.max_splits_base,
                    max_splits_kb=float(config.max_splits_kb),
                    mapq_min=mapq_min,
                    keep_lowqual=bool(config.dev_keep_lowqual_splits))
                sa_pos_of = {int(v): j for j, v in enumerate(sa_sub.tolist())}
                hint_read = split_hints["h_read"]
            read_id_of = dict(zip(idxs.tolist(), read_ids.tolist()))
            ev_lo_a = np.searchsorted(ev_rec, interesting, side="left")
            ev_hi_a = np.searchsorted(ev_rec, interesting, side="right")
            # box only the event range interesting reads consume (events
            # of reads failing the pass mask are skipped entirely)
            ev_base = int(ev_lo_a[0]) if len(ev_lo_a) else 0
            ev_top = int(ev_hi_a[-1]) if len(ev_hi_a) else 0
            ev_lo = (ev_lo_a - ev_base).tolist()
            ev_hi = (ev_hi_a - ev_base).tolist()

            # batch scalar extraction: one .tolist() per column beats
            # per-element numpy indexing (~8 boxed reads per record) in
            # this, the last remaining per-read Python loop
            flag_l = flag_arr[interesting].tolist()
            pos_l = pos_arr[interesting].tolist()
            qstart_l = c["qstart"][interesting].tolist()
            hp_l = c["hp"][interesting].tolist()
            ps_l = c["ps"][interesting].tolist()
            nm_raw_l = c["nm"][interesting].tolist()
            lis_l = c["large_indel_sum"][interesting].tolist()
            qalen_l = qalen_arr[interesting].tolist()
            mapq_l = c["mapq"][interesting].tolist()
            sa_l = has_sa_arr[interesting].tolist()
            ev_op_l = res.events["op"][ev_base:ev_top].tolist()
            ev_oplen_l = res.events["oplen"][ev_base:ev_top].tolist()
            ev_pos_ref_l = res.events["pos_ref"][ev_base:ev_top].tolist()
            ev_pos_read_l = res.events["pos_read"][ev_base:ev_top].tolist()

            for k, i in enumerate(interesting.tolist()):
                flag = flag_l[k]
                ref_start = pos_l[k]
                hp = hp_l[k]
                ps_raw = ps_l[k]
                ps = ps_raw if ps_raw >= 0 else "NULL"
                has_sa = sa_l[k]
                is_supp = bool(flag & FSUPPLEMENTARY)
                use_clips = detect_large_ins and not is_supp and not has_sa
                curr_read_id = read_id_of[i]
                nm = -1
                if advanced_tags and nm_raw_l[k] >= 0:
                    nm = (nm_raw_l[k] - lis_l[k]) / float(qalen_l[k] + 1)
                qname = res.name(i)
                strand = "-" if (flag & FREVERSE) else "+"
                mapq = mapq_l[k]
                read_len = qalen_l[k]

                # CIGAR indel/clip leads from pre-extracted native events
                for e in range(ev_lo[k], ev_hi[k]):
                    op = ev_op_l[e]
                    oplength = ev_oplen_l[e]
                    pos_ref = ev_pos_ref_l[e]
                    pos_read = ev_pos_read_l[e]
                    if op == OP_I:
                        yield Lead(qname, curr_read_id, region.contig,
                                   pos_ref, pos_ref, "INS", oplength,
                                   pos_read, pos_read + oplength,
                                   strand, mapq, "INLINE", nm,
                                   seq=(res.seq_slice(i, pos_read, pos_read + oplength)
                                        if oplength <= seq_cache_maxlen else None),
                                   hap=str(hp), phase_set=str(ps), is_sa=is_supp,
                                   read_len=read_len)
                    elif op == OP_D:
                        yield Lead(qname, curr_read_id, region.contig,
                                   pos_ref + oplength, pos_ref, "DEL", -oplength,
                                   pos_read, pos_read,
                                   strand, mapq, "INLINE", nm,
                                   hap=str(hp), phase_set=str(ps), is_sa=is_supp,
                                   read_len=read_len)
                    elif op == OP_S:
                        # hard clips carry event=0 in the reference OPTAB and
                        # never produce leads (leadprov.py:180-195)
                        if use_clips and oplength >= longinslen:
                            yield Lead(qname, curr_read_id, region.contig,
                                       pos_ref, pos_ref, "INS", None,
                                       pos_read, pos_read + oplength,
                                       strand, mapq, "INLINE", nm, seq=None,
                                       hap=str(hp), phase_set=str(ps),
                                       is_sa=is_supp, read_len=read_len)
                        else:
                            yield Lead(qname, curr_read_id, region.contig,
                                       pos_ref, pos_ref,
                                       "SINGLE_LEFT" if pos_ref == ref_start else "SINGLE_RIGHT",
                                       0, pos_read, pos_read + oplength,
                                       strand, mapq, "INLINE", nm, seq=None,
                                       hap=str(hp), phase_set=str(ps),
                                       is_sa=is_supp, read_len=read_len)

                # Split reads: materialize from the native split-chain
                # columns; the per-read Python parse remains only as the
                # exactness route for a read the scanner flags (malformed
                # SA — reproduces the reference's error messages)
                if has_sa:
                    j = sa_pos_of[i]
                    if split_bnd["bnd_ok"][j] < 0 or split_bnd["split_err"][j]:
                        read = parse_record(res.record_bytes(i), bam.references)
                        if lead := Lead.for_bnd(curr_read_id, read):
                            if (not lead.sa_same_strand
                                    or lead.bnd_info.mate_contig != lead.contig):
                                yield lead
                        if not is_supp:
                            yield from read_itersplits(curr_read_id, read, region.contig,
                                                       config, read_nm=nm, read_hap=hp,
                                                       read_ps=ps)
                    else:
                        if split_bnd["bnd_ok"][j] == 1:
                            moff = int(split_bnd["bnd_mate_off"][j])
                            mlen = int(split_bnd["bnd_mate_len"][j])
                            mate = res.buf[moff:moff + mlen].tobytes().decode("ascii")
                            sa_same = bool(split_bnd["bnd_same_strand"][j])
                            if not sa_same or mate != region.contig:
                                anchor = int(split_bnd["bnd_anchor"][j])
                                qs = qstart_l[k]
                                yield Lead(
                                    qname, curr_read_id, region.contig,
                                    anchor, anchor, "BND", 0,
                                    qs, qs + qalen_l[k], strand, mapq, "BND_SA",
                                    int(split_bnd["bnd_sa_nm"][j])
                                    if nm_raw_l[k] >= 0 else None,
                                    seq=None,
                                    bnd_info=sv.SVCallBNDInfo(
                                        mate,
                                        int(split_bnd["bnd_mate_anchor"][j]),
                                        bool(split_bnd["bnd_is_first"][j]),
                                        bool(split_bnd["bnd_mate_is_reverse"][j])),
                                    sa_same_strand=sa_same)
                        lo = int(np.searchsorted(hint_read, j, side="left"))
                        hi = int(np.searchsorted(hint_read, j, side="right"))
                        for h in range(lo, hi):
                            typ = int(split_hints["h_type"][h])
                            hstart = int(split_hints["h_start"][h])
                            seq = None
                            if typ == 4:
                                svtype, svlen, ref_end = "INS", None, hstart
                            else:
                                svtype = ("INS", "DEL", "DUP", "INV")[typ]
                                svlen = int(split_hints["h_svlen"][h])
                                ref_end = hstart if svtype == "INS" else hstart + svlen
                                if svtype == "INS" and split_hints["h_seq_a"][h] >= 0:
                                    seq = res.seq_slice(
                                        i, int(split_hints["h_seq_a"][h]),
                                        int(split_hints["h_seq_b"][h]))
                            coff = int(split_hints["h_ctg_off"][h])
                            ctg = (region.contig if coff < 0 else
                                   res.buf[coff:coff + int(split_hints["h_ctg_len"][h])]
                                   .tobytes().decode("ascii"))
                            yield Lead(
                                qname, curr_read_id, ctg, hstart, ref_end,
                                svtype, svlen,
                                int(split_hints["h_qry_start"][h]),
                                int(split_hints["h_qry_end"][h]),
                                "-" if split_hints["h_strand"][h] < 0 else "+",
                                int(split_hints["h_mapq"][h]),
                                "SPLIT_PRIM" if split_hints["h_source"][h] == 0
                                else "SPLIT_SUP",
                                nm, seq=seq, hap=str(hp), phase_set=str(ps),
                                is_sa=False)

        if hap_diff is not None:
            # one array accumulate instead of a per-covered-bin dict fold
            # (millions of dict entries at WGS scale; see RefHapBins)
            self.leadhapcount["REF"].add_counts(
                np.cumsum(hap_diff[:, :-1], axis=1))

        # the per-task regional NM statistic stays on this provider, as in
        # the pure-Python scan
        self.average_regional_nm = nm_sum / float(max(1, nm_count))

    def read_iterindels(self, read_id: int, read: BamRead, contig, use_clips,
                        read_nm, read_hap, read_ps) -> Iterator[Lead]:
        """CIGAR-indel / clip leads of one read, walking the alignment with
        per-op read/ref strides (reference: leadprov.py:583-670)."""
        config = self.config
        floor = config.minsvlen_screen
        long_clip = config.long_ins_length / 2.0
        seq_cap = config.dev_seq_cache_maxlen
        anchor = read.reference_start

        shared = dict(read_qname=read.query_name, read_id=read_id, contig=contig,
                      strand="-" if read.is_reverse else "+",
                      mapq=read.mapping_quality, source="INLINE", nm=read_nm,
                      hap=str(read_hap), phase_set=str(read_ps),
                      is_sa=read.is_supplementary,
                      read_len=read.query_alignment_length)

        pos_read = 0
        pos_ref = anchor
        for op, oplen in read.cigartuples:
            stride_read, stride_ref, eventful, _ = OPLIST[op]
            if eventful and oplen >= floor:
                if op == CINS:
                    yield Lead(ref_start=pos_ref, ref_end=pos_ref, svtype="INS",
                               svlen=oplen, qry_start=pos_read, qry_end=pos_read + oplen,
                               seq=(read.query_sequence[pos_read:pos_read + oplen]
                                    if oplen <= seq_cap else None),
                               **shared)
                elif op == CDEL:
                    yield Lead(ref_start=pos_ref + oplen, ref_end=pos_ref, svtype="DEL",
                               svlen=-oplen, qry_start=pos_read, qry_end=pos_read,
                               **shared)
                elif use_clips and op == CSOFT_CLIP and oplen >= long_clip:
                    # a long soft-clip is half of a putative long insertion
                    yield Lead(ref_start=pos_ref, ref_end=pos_ref, svtype="INS",
                               svlen=None, qry_start=pos_read, qry_end=pos_read + oplen,
                               seq=None, **shared)
                elif op in _CLIP_OPS:
                    side = "SINGLE_LEFT" if pos_ref == anchor else "SINGLE_RIGHT"
                    yield Lead(ref_start=pos_ref, ref_end=pos_ref, svtype=side,
                               svlen=0, qry_start=pos_read, qry_end=pos_read + oplen,
                               seq=None, **shared)
            pos_read += stride_read * oplen
            pos_ref += stride_ref * oplen


from sniffles_tpu_torch.compat import alias_module_for_pickle

alias_module_for_pickle("sniffles.leadprov", __name__, [Lead])
