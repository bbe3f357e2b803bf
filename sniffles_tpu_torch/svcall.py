"""SV data model, cluster-to-call conversion, and split-pair classification.

Behavior matches the reference data model and calling step (reference:
sv.py:87-782): robust center statistics, PRECISE determination, BND alt
resolution, multi-sample group merging, and the adjacent-split geometry
rules.  The classes keep the JAX package's slot layout and pickle under
the same reference aliases ("sniffles.sv.*"), so SNF blocks written by
either package load in the other. Copied from sniffles_tpu/svcall.py.
The per-candidate statistics (center/trim/stdev) also have batched
device implementations in ops/stats.py; this module is the exact
host-side ground truth.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

from typing import Optional, TYPE_CHECKING

from sniffles_tpu_torch import util
from sniffles_tpu_torch.compat import _apply_pickle_state
from sniffles_tpu_torch.ops.edit_distance import edit_distance

if TYPE_CHECKING:
    from sniffles_tpu_torch.cluster import Cluster
    from sniffles_tpu_torch.config import SnifflesConfig

log = logging.getLogger(__name__)

TYPES = ["INS", "DEL", "DUP", "INV", "BND"]
SINGLE_TYPES = ["SINGLE_LEFT", "SINGLE_RIGHT"]
ALL_TYPES = TYPES + SINGLE_TYPES


@dataclass
class SVCallBNDInfo:
    """Breakend geometry: mate locus plus bracket orientation
    (reference: sv.py:36-44)."""
    mate_contig: str
    mate_ref_start: int
    is_first: bool      # True for N..., False for ...N
    is_reverse: bool    # True for ]...], False for [...[


@dataclass
class SVCallPostprocessingInfo:
    cluster: 'Cluster'


class ForwardDifferenceWelford:
    """Streaming mean/variance of relative forward differences, the state
    of the large-event coverage-smoothness screen (reference: sv.py:51-85).
    Nothing feeds it samples (the JAX package's update method has no
    caller either), so its variance stays None and the screen passes."""

    def __init__(self):
        self.n, self.m1, self.m2, self.last = 0, 0, 0, None

    @property
    def variance(self):
        # population variance (ddof=0)
        return self.m2 / self.n if self.n >= 2 else None


@dataclass(slots=True)
class SVCall:
    """One called SV record (reference: sv.py:87-223).

    Slots: calls are the bulk of SNF blocks and combine working sets
    (samples x blocks), so per-instance dicts dominate memory at
    population scale.  `__setstate__` also accepts the reference's
    dict-form pickle state so SVCalls inside reference-written SNF
    blocks still load (compat.py maps sniffles.sv.SVCall here).
    """
    # event shape + locus
    svtype: str
    svlen: int
    end: int
    contig: str
    pos: int

    # VCF columns
    ref: str
    alt: str
    id: str
    qual: int
    filter: str
    info: dict
    genotypes: dict[int, tuple]

    # evidence summary
    support: int
    precise: bool
    qc: bool
    nm: float
    rnames: list[str] | None
    postprocess: Optional[SVCallPostprocessingInfo]

    svlens: list[int] = None
    fwd: int = None
    rev: int = None

    # span depths (filled by postprocess.coverage)
    coverage_upstream: int = 0
    coverage_start: int = 0
    coverage_center: int = 0
    coverage_end: int = 0
    coverage_downstream: int = 0
    forward_difference_sampler: ForwardDifferenceWelford = field(default_factory=ForwardDifferenceWelford)

    bnd_info: SVCallBNDInfo = None
    sample_internal_id: int = None
    support_inline: int = None
    support_splits: int = None

    # force-calling passthrough (GenotypeTask, reference: parallel.py:309-366)
    raw_vcf_line: Optional[str] = None
    raw_vcf_line_index: Optional[int] = None
    genotype_match_sv: Optional['SVCall'] = None
    genotype_match_dist: float = 0.0

    # snapshotted candidate-CSV lines (see Task.finalize_candidates:
    # computed while postprocess info is still attached, consumed by
    # CallResult.store_candidates); plain fields instead of
    # cached_property so the class can use slots
    csv_line: Optional[tuple] = None
    csv_line_single: Optional[tuple] = None

    def __setstate__(self, state):
        # accept both the slots pickle form and dict-form states: the
        # reference's plain-dataclass pickles (SNF interop) and pre-slots
        # pickles of this class, whose __dict__ may carry cached-property
        # values that are not settable fields.  Defaults are applied first
        # so fields absent from an older state read as their dataclass
        # defaults instead of raising AttributeError.
        _apply_pickle_state(self, state)

    def set_info(self, k, v):
        self.info[k] = v

    def get_info(self, k):
        return self.info.get(k)

    @property
    def is_single_break(self) -> bool:
        return self.svtype.startswith('SINGLE')

    def _csv_orientations(self):
        """Orientation pair for candidate-CSV output (reference: sv.py:183-193)."""
        if self.svtype == "DEL":
            return '+', '-'
        if self.svtype == "DUP":
            return '-', '+'
        if self.svtype == "BND":
            return ('+' if self.bnd_info.is_first else '-',
                    '+' if self.bnd_info.is_reverse else '-')
        return '=', '='

    def _to_csv_line(self, single_break: bool = False) -> tuple | None:
        """Candidate CSV emission (reference: sv.py:180-214)."""
        vaf = self.get_info('VAF')
        ref_reads = str(int(self.support / vaf) if vaf else 0)
        o1, o2 = self._csv_orientations()

        cluster = self.postprocess.cluster
        inline = len({ld.read_qname for ld in cluster.leads if ld.source == "INLINE"})
        counts = (str(inline), str(self.support - inline), ref_reads)

        if single_break:
            # Half-calls: unclassified single breaks and the break side of an INS.
            masked = self.filter if self.filter != 'SINGLE_BREAK' else ''
            if self.svtype == 'INS' and (loc := cluster.get_break()):
                return (self.svtype, '-', self.contig, str(loc), '', '', '', self.filter) + counts
            if self.svtype == 'SINGLE_LEFT':
                return (self.svtype, '-', self.contig, str(self.pos), '', '', '', masked) + counts
            if self.svtype == 'SINGLE_RIGHT':
                return (self.svtype, '+', self.contig, str(self.pos), '', '', '', masked) + counts
            return None
        if self.is_single_break:
            return None

        if self.svtype == 'BND':
            mate = (self.bnd_info.mate_contig, str(self.bnd_info.mate_ref_start))
        else:
            mate = (self.contig, str(self.end))
        return (self.svtype, o1, self.contig, str(self.pos), o2) + mate + (self.filter,) + counts

    def finalize(self):
        self.postprocess = None

    # variance ceiling for the coverage-smoothness screen (COV_VAR)
    _COVERAGE_VAR_MAX = 0.3

    def qc_coverage_samples(self) -> tuple[bool, float | None]:
        var = self.forward_difference_sampler.variance
        return (True, None) if var is None else (var < self._COVERAGE_VAR_MAX, float(var))


# --------------------------------------------------------------------------
# Multi-sample merge groups (combine mode)


def _merged_sample_genotype(existing, incoming, merged_id):
    """Keep the stronger of two same-sample genotypes under one merged id
    (reference: sv.py:353-362)."""
    a, b = incoming[0], incoming[1]
    if existing[0] == "." or (a != "." and (a, b) >= (existing[0], existing[1])):
        return incoming[:6] + (merged_id,)
    return existing[:6] + (merged_id,)


@dataclass
class SVGroup:
    """Cross-sample candidate group built during combine
    (reference: sv.py:226-481)."""
    pos_mean: float
    len_mean: float
    candidates: list[SVCall]
    included_samples: set
    coverages_nonincluded: dict

    bnd_mate_ref_start_mean: float = None
    bnd_mate_contig: str = None

    @classmethod
    def from_candidate(cls, candidate: SVCall) -> "SVGroup":
        group = cls(candidates=[candidate],
                    pos_mean=float(candidate.pos),
                    len_mean=float(abs(candidate.svlen)),
                    included_samples={candidate.sample_internal_id},
                    coverages_nonincluded={})
        if candidate.svtype == "BND":
            group.bnd_mate_contig = candidate.bnd_info.mate_contig
            group.bnd_mate_ref_start_mean = candidate.bnd_info.mate_ref_start
        return group

    def align_call(self, candidate: SVCall, limit: float,
                   ed_cache: dict | None = None) -> bool:
        """Sequence-identity gate for merging (reference: sv.py:280-289).

        Uses the built-in edit-distance kernels instead of edlib:
        a precomputed device batch (ops/edit_distance_batch.py) when the
        combine task supplied a cache, host Myers otherwise.
        """
        if not limit:
            return True
        key = (self.candidates[0].alt, candidate.alt)
        # the gate passes iff distance < len_mean * (1 - limit): a value
        # bounded at k = ceil(len_mean * (1 - limit)) decides it exactly
        # (d <= k is exact; d > k >= threshold always fails)
        k = int(math.ceil(self.len_mean * (1.0 - limit)))
        if key[0] == key[1]:
            distance = 0
        elif ed_cache is not None and key in ed_cache:
            cached = ed_cache[key]
            if isinstance(cached, tuple):  # ("gt", k_used): d > k_used
                if k <= cached[1]:
                    return False
                distance = edit_distance(*key, k=k)
                ed_cache[key] = distance if distance <= k else ("gt", k)
                if distance > k:
                    return False
            else:
                distance = cached
        else:
            # distance >= |len(a) - len(b)|: when even that lower bound
            # fails the identity gate, the DP outcome is already decided
            length_lb = abs(len(key[0]) - len(key[1]))
            if (self.len_mean - length_lb) / self.len_mean <= limit:
                return False
            distance = edit_distance(*key, k=k)
            if ed_cache is not None:
                ed_cache[key] = distance if distance <= k else ("gt", k)
            if distance > k:
                return False
        return ((self.len_mean - distance) / self.len_mean) > limit

    def add_candidate(self, candidate: SVCall):
        """Fold one candidate into the group's running means
        (reference: sv.py:297-317)."""
        n = len(self.candidates)
        self.pos_mean = (self.pos_mean * n + candidate.pos) / (n + 1)
        self.len_mean = (self.len_mean * n + abs(candidate.svlen)) / (n + 1)
        if candidate.svtype == "BND":
            self.bnd_mate_ref_start_mean = (
                (self.bnd_mate_ref_start_mean * n + candidate.bnd_info.mate_ref_start) / (n + 1))
        self.candidates.append(candidate)
        self.included_samples.add(candidate.sample_internal_id)

    # -- group calling stages ---------------------------------------------

    def _passes_confidence(self, config) -> bool:
        """High-confidence (QC-pass share) or low-confidence (presence
        share + absolute floor) acceptance (reference: sv.py:326-342)."""
        n = float(len(config.snf_input_info))
        passed = sum(cand.qc for cand in self.candidates)
        present = len(self.included_samples)
        return ((passed > 0 and passed / n >= config.combine_high_confidence)
                or (present / n >= config.combine_low_confidence
                    and present >= config.combine_low_confidence_abs))

    def _collect_genotypes(self, config):
        """Per-sample 7-tuple genotypes with intra-sample merging; also
        gathers rnames (reference: sv.py:344-365)."""
        rnames, genotypes = [], {}
        for cand in self.candidates:
            if rnames is not None and cand.rnames is not None:
                rnames.extend(cand.rnames)
            cand.genotypes.setdefault(0, (".", ".", 0, 0, cand.support, (None, None)))
            sid = cand.sample_internal_id
            tagged_id = config.id_prefix + cand.id
            if sid in genotypes:
                merged_id = genotypes[sid][6] + "," + tagged_id
                genotypes[sid] = _merged_sample_genotype(genotypes[sid], cand.genotypes[0], merged_id)
            else:
                genotypes[sid] = cand.genotypes[0] + (tagged_id,)
        return rnames, genotypes

    def _fill_absent_samples(self, genotypes, config, all_sample_ids):
        """Samples without a candidate get 0/0 or ./. from block coverage
        (reference: sv.py:367-374)."""
        for sid in all_sample_ids:
            if sid in genotypes:
                continue
            depth = self.coverages_nonincluded[sid]
            alleles = (0, 0) if depth >= config.combine_null_min_coverage else (".", ".")
            genotypes[sid] = alleles + (0, depth, 0, (None, None), "NULL")

    @staticmethod
    def _relabel_pairs(genotypes, config):
        """Propagate the strongest confident genotype onto low-quality
        samples (reference: sv.py:398-410)."""
        strongest = (0, 0)
        for a, b, qual, dr, dv, ps, gid in genotypes.values():
            if qual > config.combine_pair_relabel_threshold and a != ".":
                strongest = max(strongest, (a, b))
        if strongest == (0, 0):
            return
        for sid, (a, b, qual, dr, dv, ps, gid) in genotypes.items():
            if qual < config.combine_pair_relabel_threshold and a != ".":
                genotypes[sid] = strongest + (qual, dr, dv, ps, gid)

    def _pick_alt(self, median_len):
        """For INS: the candidate alt closest in length to the median
        (reference: sv.py:420-428)."""
        best = self.candidates[0].alt
        best_gap = abs(len(best) - median_len)
        for cand in self.candidates:
            gap = abs(len(cand.alt) - median_len)
            if gap < best_gap:
                best, best_gap = cand.alt, gap
        return best

    def call(self, config, task) -> Optional[SVCall]:
        """Emit the merged multi-sample call, or None when the group fails
        a combine screen (reference: sv.py:320-481)."""
        cands = self.candidates
        lead_cand = cands[0]
        n_samples = len(config.snf_input_info)
        solo_unfiltered = config.no_qc and n_samples == 1

        if not self._passes_confidence(config) and not solo_unfiltered:
            return None
        if (not config.combine_output_filtered
                and not any(c.qc and c.filter == "PASS" for c in cands)
                and not solo_unfiltered):
            return None

        rnames, genotypes = self._collect_genotypes(config)
        all_sample_ids = {s["internal_id"] for s in config.snf_input_info}
        self._fill_absent_samples(genotypes, config, all_sample_ids)

        if config.combine_pair_relabel:
            self._relabel_pairs(genotypes, config)

        median_pos = int(util.median(c.pos for c in cands))
        median_len = int(util.median(c.svlen for c in cands))
        all_lengths = ([n for c in cands for n in (c.svlens or [])]
                       if config.dev_emit_sv_lengths else None)

        if lead_cand.svtype == "INS":
            merged_end = median_pos
            merged_alt = self._pick_alt(median_len)
        else:
            merged_end = median_pos + abs(median_len)
            merged_alt = lead_cand.alt

        def span_mean(attr):
            return util.mean_or_none_round(getattr(c, attr) for c in cands
                                           if getattr(c, attr) is not None)

        use_medians = config.dev_combine_medians
        svcall = SVCall(
            contig=lead_cand.contig,
            pos=median_pos if use_medians else lead_cand.pos,
            id=f"{lead_cand.svtype}.{task.sv_id:X}M{task.id:X}",
            ref="N",
            alt=merged_alt,
            qual=util.mean_or_none_round(int(c.qual) for c in cands if c.qual is not None),
            filter="PASS" if n_samples != 1 else lead_cand.filter,
            info={} if n_samples != 1 else lead_cand.info,
            svtype=lead_cand.svtype,
            svlen=median_len if use_medians else lead_cand.svlen,
            svlens=all_lengths,
            end=merged_end if use_medians else lead_cand.end,
            genotypes=genotypes,
            precise=sum(int(c.precise) for c in cands) / float(len(cands)) > 0.5,
            support=round(util.mean(c.support for c in cands)),
            rnames=rnames,
            postprocess=None,
            qc=True,
            nm=-1,
            fwd=sum(c.fwd for c in cands),
            rev=sum(c.rev for c in cands),
            coverage_upstream=span_mean("coverage_upstream"),
            coverage_start=span_mean("coverage_start"),
            coverage_center=span_mean("coverage_center"),
            coverage_end=span_mean("coverage_end"),
            coverage_downstream=span_mean("coverage_downstream"))

        if n_samples != 1:
            svcall.set_info("STDEV_POS", util.stdev(c.pos for c in cands))
            svcall.set_info("STDEV_LEN", util.stdev(c.svlen for c in cands))

        # The reference applies the length screen HERE to every type,
        # including BND (sv.py:470-471) — unlike call_from, which exempts
        # BND (sv.py:511-514). BND groups whose stored median svlen is 0
        # (clusters dominated by for_bnd leads, i.e. all inter-contig
        # translocations) are therefore dropped from combine output;
        # split-lead-backed BNDs carry bnd_cluster_length and survive.
        # Found via combine fuzzing (tools/diff_fuzz.py --combine, seed
        # 700); --dev-combine-keep-bnd opts out of the reference quirk.
        if abs(svcall.svlen) < config.minsvlen_screen:
            if not (svcall.svtype == "BND"
                    and getattr(config, "dev_combine_keep_bnd", False)):
                return None

        task.sv_id += 1

        if psnf := config.combine_population:
            hit = psnf.get_population_AF(svcall)
            af, size = hit if hit is not None else (0, 0)
            svcall.set_info("POPULATION_AF", af)
            svcall.set_info("POPULATION_SIZE", size)

        return svcall


# --------------------------------------------------------------------------
# Cluster -> candidate conversion (call path)


def calculate_bounds(svtype, ref_start_mode, svlen_mode):
    """Start/end of the event interval from its robust center statistics
    (reference: sv.py:484-494)."""
    if svtype == "INS":
        return ref_start_mode, ref_start_mode
    if svtype == "DEL":
        return ref_start_mode + svlen_mode, ref_start_mode
    return ref_start_mode, ref_start_mode + abs(svlen_mode)


def call_from(cluster, config, keep_qc_fails, task):
    """Convert one lead cluster into an SV candidate; yields at most one
    call (reference: sv.py:497-598)."""
    leads = cluster.leads
    svtype = cluster.svtype
    qc = True

    # device-computed statistics from the fused --tpu-call step
    # (parallel/device_call.py): integer-exact robust centers and counts
    # over this cluster's MERGED leads (the device applies the
    # merge_inner fold before computing them, and the host verified the
    # fold grouping before attaching the dict), so they equal the host
    # computations below. Float statistics (stdevs, NM mean) and
    # set-carrying fields (rnames) stay host-side: they feed formatted
    # output and downstream object paths, and host f64 keeps them
    # byte-stable.
    eng = getattr(cluster, "engine", None)

    svlen = eng["svlen_center"] if eng else util.center(ld.svlen for ld in leads)
    lengths = [ld.svlen for ld in leads] if config.dev_emit_sv_lengths else None

    if not svtype.startswith("SINGLE_") and svtype != 'BND':
        if abs(svlen) < config.minsvlen_screen:
            return

    supporting = {ld.read_qname for ld in leads}
    support_long = 0
    if svtype == "INS" and svlen >= config.long_ins_length:
        # soft-clip evidence counts toward long-INS support
        long_reads = {ld.read_qname for ld in cluster.leads_long}
        support_long = len(long_reads)
        supporting |= long_reads
    support = len(supporting)

    ref_start = eng["raw_pos_center"] if eng else util.center(ld.ref_start for ld in leads)
    stdev_pos = util.stdev(util.trim(ld.ref_start for ld in leads))
    if svtype == "BND":
        stdev_len = None
        precise = stdev_pos < config.precise
    else:
        stdev_len = util.stdev(util.trim(ld.svlen for ld in leads))
        precise = stdev_pos + stdev_len < config.precise

    svstart, svend = calculate_bounds(svtype, ref_start, svlen)
    fwd_count = eng["fwd"] if eng else sum(ld.strand == "+" for ld in leads)
    nm_mean = util.mean(ld.nm for ld in leads) if config.qc_nm_measure else -1

    if not keep_qc_fails and not qc:
        return

    svcall = SVCall(
        contig=cluster.contig,
        pos=svstart,
        id=f"{svtype}.{task.sv_id:X}S{task.id:X}",
        ref="N",
        alt=f"<{svtype}>",
        qual=eng["qual"] if eng else int(util.mean(ld.mapq for ld in leads)),
        filter="PASS",
        info={},
        svtype=svtype,
        svlen=svlen,
        svlens=lengths,
        end=svend,
        genotypes={},
        precise=precise,
        support=support,  # set-based (needs rnames anyway); equals eng["support"]
        # sorted, not set order: the reference emits RNAMES in hash-seed-
        # dependent set order (reference sv.py:555 via list(support_set)),
        # so its output varies run to run under --output-rnames; ours is
        # deterministic (docs/migration.md, known differences)
        rnames=sorted(supporting),
        postprocess=SVCallPostprocessingInfo(cluster=cluster),
        qc=qc,
        nm=nm_mean,
        fwd=fwd_count,
        rev=len(leads) - fwd_count)

    type_extras = {
        "BND": lambda: resolve_bnd(svcall, cluster, config),
        "INS": lambda: svcall.set_info("SUPPORT_LONG", support_long),
        # split-read support for the DEL genotyper; the device counts it
        # per cluster in the fused step (sa flag row, call_task_packed)
        "DEL": lambda: svcall.set_info("SUPPORT_SA",
                                       eng["support_sa"] if eng else
                                       sum(ld.source != "INLINE" for ld in leads)),
    }
    if svtype in type_extras:
        type_extras[svtype]()

    for tag, scatter in (("STDEV_POS", stdev_pos), ("STDEV_LEN", stdev_len)):
        if scatter is not None:
            svcall.set_info(tag, scatter)

    task.sv_id += 1
    yield svcall


def resolve_bnd(svcall: 'SVCall', cluster: 'Cluster', config=None) -> None:
    """Resolve the dominant mate locus/orientation of a BND cluster into
    VCF 4.2 bracket syntax (reference: sv.py:625-639)."""
    mate_contig = util.most_common_top([ld.bnd_info.mate_contig for ld in cluster.leads])
    mates = [ld for ld in cluster.leads if ld.bnd_info.mate_contig == mate_contig]
    mate_pos = util.center([ld.bnd_info.mate_ref_start for ld in mates])
    is_first = util.most_common_top([ld.bnd_info.is_first for ld in mates])
    is_reverse = util.most_common_top([ld.bnd_info.is_reverse for ld in mates])

    bracket = "]" if is_reverse else "["
    locus = f"{bracket}{mate_contig}:{mate_pos}{bracket}"
    svcall.alt = f"N{locus}" if is_first else f"{locus}N"
    svcall.support = len({ld.read_qname for ld in mates})
    svcall.bnd_info = SVCallBNDInfo(mate_contig, mate_pos, is_first, is_reverse)
    svcall.set_info("CHR2", mate_contig)
    cluster.leads = mates


def call_groups(svgroups: list[SVGroup], config, task):
    """Yield the merged call of every group that survives combine QC."""
    calls = (group.call(config, task) for group in svgroups)
    yield from (c for c in calls if c is not None)


# --------------------------------------------------------------------------
# Split-read pair classification


def _same_strand_event(read, last, curr, minlen, seq_cap):
    """INS/DEL/DUP geometry for an adjacent same-strand pair; returns the
    (svtype, start, svlen) hint or None and sets curr.seq for INS
    (reference: sv.py:665-721).

    Gap convention: query gap is read-bases skipped between alignments;
    reference gap runs forward or backward with strand.
    """
    forward = curr.strand != "-"
    qry_gap = curr.qry_start - last.qry_end
    ref_gap = (curr.ref_start - last.ref_end) if forward else (last.ref_start - curr.ref_end)
    anchor = curr.ref_start if forward else last.ref_start

    if qry_gap >= minlen and qry_gap - ref_gap >= minlen:
        # inserted sequence between the two alignments
        curr.seq = (read.query_sequence[last.qry_end:curr.qry_start]
                    if qry_gap <= seq_cap else None)
        return "INS", anchor, qry_gap
    if ref_gap >= minlen and ref_gap - qry_gap >= minlen:
        return "DEL", anchor, -ref_gap
    # re-visited reference span -> duplication
    if forward and curr.ref_start <= last.ref_end:
        span = last.ref_end - curr.ref_start
        if span >= minlen:
            return "DUP", curr.ref_start, span
    elif not forward and last.ref_start <= curr.ref_end:
        span = curr.ref_end - last.ref_start
        if span >= minlen:
            return "DUP", last.ref_start, span
    return None


def _strand_flip_event(last, curr, minlen):
    """INV geometry for an adjacent opposite-strand pair; the breakpoint
    pair is taken on ref starts (current read forward) or ref ends
    (current read reverse) (reference: sv.py:723-755)."""
    if curr.strand != "-":
        a, b = curr.ref_start, last.ref_start
    else:
        a, b = curr.ref_end, last.ref_end
    span = abs(a - b)
    if span >= minlen:
        return "INV", min(a, b), span
    return None


def classify_splits(read, leads: list, config, main_contig: str) -> list:
    """Order a read's alignments by query position and classify each
    adjacent pair into an SV hint (reference: sv.py:649-782).

    Inter-contig pairs are not handled here — they become BNDs via
    Lead.for_bnd.  When no pair yields a hint, retry once on the
    alignments matching the first alignment's contig+strand (the
    short-pseudo-BND filter).
    """
    minlen = config.minsvlen_screen
    leads.sort(key=lambda ld: ld.qry_start)

    head = leads[0]
    head.svtypes_starts_lens = []
    # A long unaligned prefix is a putative long-INS half-signal.
    if head.qry_start >= config.long_ins_length * 0.5:
        head.svtypes_starts_lens.append(("INS", head.ref_start, None))

    hints = 0
    last = head
    for curr in leads[1:]:
        curr.svtypes_starts_lens = []
        if curr.contig == last.contig:
            if curr.strand == last.strand:
                hint = _same_strand_event(read, last, curr, minlen,
                                          config.dev_seq_cache_maxlen)
            else:
                hint = _strand_flip_event(last, curr, minlen)
            if hint is not None:
                curr.svtypes_starts_lens.append(hint)
                hints += 1
        last = curr

    if not hints and len(leads) > 2:
        # filter out short pseudo BND hints
        anchor = leads[0]
        leads = [ld for ld in leads
                 if ld.contig == anchor.contig and ld.strand == anchor.strand]
        if len(leads) == 2:
            return classify_splits(read, leads, config, main_contig)
    return leads


from sniffles_tpu_torch.compat import alias_module_for_pickle

alias_module_for_pickle("sniffles.sv", __name__,
                        [SVCallBNDInfo, SVCallPostprocessingInfo,
                         ForwardDifferenceWelford, SVCall, SVGroup])
