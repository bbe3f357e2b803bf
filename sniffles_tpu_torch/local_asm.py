"""Local assembly rescue for filtered INS/DEL calls.

Re-fetches the supporting reads around a filtered call, builds a read
consensus (ops/poa.py replaces SPOA), aligns consensus against the local
reference window, locates the gap run matching the event length, and
rescues the call (reference: local_asm.py:26-304; gated at
parallel.py:186-196). Copied from sniffles_tpu/local_asm.py.
"""
from __future__ import annotations

import logging
from pathlib import Path

from sniffles_tpu_torch.svcall import SVCall
from sniffles_tpu_torch.ops.poa import poa

GAP = "-"
log = logging.getLogger('sniffles_tpu_torch.local_asm')

_ALGO = {"local": 0, "global": 1, "semig": 2}

# Size-tiered alignment scores for the consensus-vs-reference MSA
# (reference: local_asm.py:26-73): (upper svlen bound, (match, mismatch,
# gap open, gap extend, second gap open, second gap extend)).
_SCORE_TIERS = (
    (400, (10, -10, -20, 0, -10, -1)),
    (1200, (13, -5, -25, 0, -25, -1)),
    (None, (10, -10, -30, -1, -15, -1)),
)

# Padding tiers (reference: local_asm.py:105-124): (upper svlen bound,
# svlen-proportional factor, default-pad multiplier).
_PAD_TIERS = (
    (400, 0.5, 0.70),
    (1200, 0.5, 1.0),
    (None, 0.75, 1.2),
)


def _tier(table, svlen):
    size = abs(svlen)
    for bound, *rest in table:
        if bound is None or size <= bound:
            return rest if len(rest) > 1 else rest[0]


class SPOA:
    """Scoring-parameter holder kept API-compatible with round-1 callers;
    tiers live in _SCORE_TIERS."""

    def __init__(self):
        self.algorithm = dict(_ALGO)
        self.match = self.miss = self.gap_open = self.gap_expand = 0
        self.gap_open2 = self.gap_expand2 = 0

    def set(self, svlen: int):
        (self.match, self.miss, self.gap_open, self.gap_expand,
         self.gap_open2, self.gap_expand2) = _tier(_SCORE_TIERS, svlen)


def _scan_for_gap(aln: str, target_len: int, eps: float, enabled: bool = True,
                  count_aln: str = None):
    """Walk an alignment string; stop at the first non-gap character that
    follows a gap run within eps of target_len.

    The offset is counted over the non-gap characters of `count_aln`
    (default: the scanned string itself). The DEL solver passes the
    REFERENCE row here so the recovered position is a true reference
    coordinate even when the consensus is end-trimmed or carries
    insertions upstream of the event — a robustness improvement over
    the reference, which counts consensus-row characters and assumes a
    flush, indel-free consensus prefix (reference: local_asm.py:154-189).

    Returns (offset at the stop point, gap-run size at the stop point,
    number of gap runs seen, whether the walk stopped early). When the
    walk runs off the end, the trailing gap run (if any) is still
    reported — the caller's final verdict re-checks it, matching the
    reference's post-loop acceptance (local_asm.py:154-189, 217-252).
    """
    if count_aln is None:
        count_aln = aln
    gap_run = 0
    run_counted = 0   # count_aln bases consumed inside the current gap run
    runs = 0
    in_gap = False
    offset = 0
    for col, (ch, cch) in enumerate(zip(aln, count_aln)):
        if ch == GAP:
            if cch != GAP:
                offset += 1
                run_counted += 1
            gap_run += 1
            if not in_gap:
                runs += 1
                in_gap = True
            continue
        in_gap = False
        if gap_run > 0 and abs(gap_run - target_len) / float(target_len) <= eps and enabled:
            return offset - run_counted, gap_run, runs, True, col
        if cch != GAP:
            offset += 1
        gap_run = 0
        run_counted = 0
    return offset, gap_run, runs, False, len(aln)


def _run_slice(aln: str, stop_col: int, length: int) -> str:
    """The other row's bases across the gap run that ended at alignment
    column stop_col (exclusive): aln[stop_col-length:stop_col]."""
    lo = stop_col - length
    if lo < 0 or length <= 0:
        return ""
    return aln[lo:stop_col]


class LocalAsm:
    """The assembly rescue of one filtered call
    (reference: local_asm.py:76-304)."""

    def __init__(self, sv: SVCall):
        self.sv = sv
        self.info_sv = ""

    # -- call mutation ------------------------------------------------------

    def update_sv_cand(self, sv_pos: int, sv_seq: str):
        call = self.sv
        if call.filter == "MOSAIC_VAF":
            call.set_info("MOSAIC", True)
            call.filter = "GT"
        else:
            call.filter = "PASS"
        call.qc = True
        call.pos = sv_pos
        call.set_info("LASM", True)
        if call.svtype == "DEL":
            call.end = sv_pos + len(sv_seq) + 1
        elif call.svtype == "INS":
            call.end = sv_pos + 1

    # -- I/O helpers --------------------------------------------------------

    @staticmethod
    def open_bam(bam_file_in: str, ref: str):
        """The input as a BAM, or as a CRAM when its extension is .cram,
        as io/bam.py::AlignmentFile decides (the JAX package opens any
        path that holds "cram" as a CRAM, local_asm.py:146)."""
        from sniffles_tpu_torch.io.bam import AlignmentFile
        mode = "rc" if bam_file_in.endswith(".cram") else "rb"
        return AlignmentFile(bam_file_in, mode=mode, require_index=True,
                             reference_filename=ref)

    @staticmethod
    def ref_seq_by_region(fas, region: str):
        return fas.fetch(region=region)

    @staticmethod
    def region_pos(region: str):
        span = region.split(":")[1]
        lo, hi = span.split("-")
        return int(lo), int(hi)

    def select_padding(self, read_type: str, default_pad: int = 2000):
        proportional = (self.sv.svlen if read_type == "sv"
                        else round(self.sv.svlen / 2))
        frac, mult = _tier(_PAD_TIERS, self.sv.svlen)
        return min(max(round(proportional * frac), round(default_pad * mult)),
                   default_pad * 3)

    # -- supporting-read harvest -------------------------------------------

    def _harvest_windows(self, bam, region: str, rnames, for_del: bool):
        """Cut the SV-spanning subsequence (with size-dependent padding)
        out of every supporting read (reference: local_asm.py:126-152 DEL,
        191-215 INS)."""
        call = self.sv
        contig = ""
        windows = []
        window_starts, window_stops = [], []
        for read in bam.fetch(region=region):
            if not contig:
                contig = read.reference_name
            if read.query_name not in rnames or read.query_sequence is None:
                continue
            pad = self.select_padding("sv")
            qseq = read.query_sequence
            anchor = call.pos - read.reference_start
            if for_del:
                lo = anchor - pad
                hi = call.end - read.reference_start + pad + 1
                needed = 2 * pad
                margin = pad + 100
                span = (call.pos - margin, call.end + margin)
            else:
                lo = max(anchor - pad, 0)
                hi = anchor + call.svlen + pad
                needed = call.svlen + 2 * pad
                span = (call.pos - pad, call.pos + call.svlen + pad)
            window = qseq[lo:hi]
            if len(window) >= needed and lo > 0 and 0 < hi < len(qseq):
                windows.append(window)
                window_starts.append(span[0])
                window_stops.append(span[1])

        if windows:
            fetch_region = f'{contig}:{min(window_starts)}-{max(window_stops)}'
        else:
            fetch_region = ""
        return windows, [], fetch_region

    def read_seq_by_name_del(self, bam, region: str, rnames: list[str]):
        return self._harvest_windows(bam, region, rnames, for_del=True)

    def read_seq_by_name_ins(self, bam, region: str, rnames: list[str]):
        return self._harvest_windows(bam, region, rnames, for_del=False)

    # -- gap location -------------------------------------------------------

    def solve_del(self, region: str, sv_aln: str, ref_aln: str, eps: float = 0.15,
                  max_gaps_aln: int = 3):
        """DEL: the gap sits in the consensus row; its reference-row bases
        recover the deleted sequence (reference: local_asm.py:154-189)."""
        target = abs(self.sv.svlen)
        region_start, _ = self.region_pos(region)
        # offset counted over the reference row: a true ref coordinate,
        # robust to consensus end-trimming (see _scan_for_gap docstring)
        offset, gap_size, n_gaps, stopped, col = _scan_for_gap(sv_aln, target, eps,
                                                               count_aln=ref_aln)
        del_pos = region_start + offset if stopped else 0
        ref_seq = _run_slice(ref_aln, col, gap_size)
        ok = (len(ref_seq) > 0 and gap_size > 0 and n_gaps <= max_gaps_aln
              and abs((gap_size - target) / float(target)) <= eps)
        return [del_pos, ref_seq, ok]

    def solve_ins(self, region: str, sv_aln: str, ref_aln: str, eps: float = 0.15,
                  max_gaps_aln: int = 3):
        """INS: the gap sits in the reference row; its consensus-row bases
        recover the inserted sequence (reference: local_asm.py:217-252)."""
        target = self.sv.svlen
        region_start, _ = self.region_pos(region)
        offset, gap_size, n_gaps, stopped, col = _scan_for_gap(
            ref_aln, target, eps, enabled=region_start > 0)
        ins_pos = region_start + offset if stopped else 0
        ins_seq = _run_slice(sv_aln, col, gap_size)
        ok = (len(ins_seq) > 0 and gap_size > 0 and n_gaps <= max_gaps_aln
              and abs((gap_size - target) / target) <= eps)
        return [ins_pos, ins_seq, ok]

    # -- the rescue -----------------------------------------------------------

    def assembly(self, config, min_reads: int = 5, max_reads: int = 30,
                 fetch_read: int = 5000) -> bool:
        """POA consensus of supporting reads, consensus-vs-reference MSA,
        gap location, and call rescue (reference: local_asm.py:254-304)."""
        call = self.sv
        if Path(config.input).suffix not in (".bam", ".cram"):
            log.warning(f'Input {config.input} is not BAM or CRAM, skipping local assembly')
            return False
        if config.reference is None:
            log.warning('Reference not provided, skipping local assembly')
            return False
        if call.svtype not in ("DEL", "INS"):
            log.warning(f'SVTYPE: {call.svtype} not supported, skipping local assembly')
            return False

        from sniffles_tpu_torch.io.fasta import FastaFile
        bam = self.open_bam(config.input, config.reference)
        fas = FastaFile(config.reference)
        scores = SPOA()
        scores.set(abs(call.svlen))

        fetch_region = f'{call.contig}:{call.pos - fetch_read}-{call.end + fetch_read}'
        windows, _, msa_region = self._harvest_windows(
            bam, fetch_region, call.rnames, for_del=call.svtype == "DEL")

        if len(windows) < min_reads:
            return False

        ref_seq = self.ref_seq_by_region(fas, msa_region)
        min_cov = round(len(windows) * 0.50)
        consensus, _ = poa(sequences=windows[:max_reads], algorithm=_ALGO["local"],
                           genmsa=True, min_coverage=min_cov)
        _, msa = poa(sequences=[consensus, ref_seq], algorithm=_ALGO["local"],
                     genmsa=True, min_coverage=1,
                     m=scores.match, n=scores.miss, g=scores.gap_open,
                     e=scores.gap_expand, q=scores.gap_open2, c=scores.gap_expand2,
                     # the event's gap run shifts the alignment diagonal by
                     # svlen even when the two lengths agree
                     slack=abs(call.svlen) + 256)
        if len(msa) != 2:
            return False
        sv_aln, ref_aln = msa

        if call.svtype == "INS":
            sv_pos, sv_seq, rescued = self.solve_ins(msa_region, sv_aln, ref_aln)
        else:
            sv_pos, sv_seq, rescued = self.solve_del(msa_region, sv_aln, ref_aln)
        if rescued:
            self.update_sv_cand(sv_pos, sv_seq)
        return rescued
