"""Post-calling stages: span coverage, QC screens, genotype dispatch, phasing.

The QC cascade is expressed as a sequence of screens feeding a
FilterLedger: in normal mode the first failing screen stamps the call's
filter column and aborts (the tag of the first failure is part of the
output contract); with --dev-filter every failing tag accumulates and is
joined at the end.  Behavior matches the reference cascade
(reference: postprocessing.py:25-654). Copied from
sniffles_tpu/postprocess.py.
"""
from __future__ import annotations

import logging

from sniffles_tpu_torch import util
from sniffles_tpu_torch import consensus
from sniffles_tpu_torch.config import SnifflesConfig
from sniffles_tpu_torch.svcall import SVCall

log = logging.getLogger('sniffles_tpu_torch.postprocess')

ACCEPTED_SVTYPES = ["INS", "DEL", "DUP", "INV", "BND"]

# Fixed screen constants (reference: postprocessing.py:233,250-251,330,449-450).
_SVLEN_WAIVER_SUPPORT = 10        # read support above which SVLEN_MIN is waived
_FLANK_RATIO_CEIL = 0.7           # max down/up flank coverage ratio (long DEL/DUP)
_FLANK_RATIO_FLOOR = 0.5          # min flank ratio before COV_CHANGE fires
_INLINE_SA_MIN_READS = 5
_MOSAIC_STDEV_LEN_RATIO = 0.1
_MOSAIC_STDEV_POS_MAX = 5


class FilterLedger:
    """Outcome collector for one call's QC screens.

    flag(tag) returns True when the cascade must stop immediately
    (normal mode); in --dev-filter mode it accumulates and returns False.
    (reference: postprocessing.py:200-207,383-385,534-541)
    """

    __slots__ = ("_call", "_collect", "_tags")

    def __init__(self, call, config):
        self._call = call
        self._collect = bool(config.dev_filter)
        self._tags = []
        if self._collect and isinstance(call.filter, str):
            self._tags = call.filter.split(";")

    def flag(self, tag: str) -> bool:
        if self._collect:
            self._tags.append(tag)
            return False
        self._call.filter = tag
        return True

    def seal(self) -> None:
        """qc_sv/support sealing: replace the filter with all joined tags."""
        if self._collect:
            self._call.filter = ";".join(self._tags)

    def seal_trimmed(self) -> None:
        """Post-annotate sealing: a leading PASS is dropped once failures exist."""
        if not self._collect or not self._tags:
            return
        tags = self._tags
        if len(tags) > 1 and tags[0] == "PASS":
            tags = tags[1:]
        self._call.filter = ";".join(tags)


def _strand_diversity(svcall) -> int:
    return len({lead.strand for lead in svcall.postprocess.cluster.leads})


# --------------------------------------------------------------------------
# Annotation


def _choose_consensus_anchor(merged_leads, svcall):
    """Index of the lead whose sequence best matches the called length and
    position; ties go to the earliest lead (reference: postprocessing.py:37-49)."""
    return min(range(len(merged_leads)),
               key=lambda i: (abs(len(merged_leads[i].seq) - svcall.svlen)
                              + abs(merged_leads[i].ref_start - svcall.pos) * 1.5))


def annotate_sv(svcall: SVCall, config):
    """Phase, genotype, and (for sequence-bearing INS) fill in the alt
    sequence, via consensus when enough reads carry one
    (reference: postprocessing.py:25-66)."""
    phase = phase_sv(svcall, config) if config.phase else (None, None)
    genotype_sv(svcall, config, phase)

    if svcall.svtype != "INS" or config.symbolic:
        return
    seq_leads = [lead for lead in svcall.postprocess.cluster.leads if lead.seq is not None]
    if not seq_leads:
        return

    anchor = seq_leads.pop(_choose_consensus_anchor(seq_leads, svcall))
    if len(seq_leads) >= config.consensus_min_reads and not config.no_consensus:
        hop = config.consensus_kmer_skip_base + int(
            len(anchor.seq) * config.consensus_kmer_skip_seqlen_mult)
        svcall.alt = consensus.novel_from_reads(
            anchor, seq_leads, klen=config.consensus_kmer_len,
            skip=hop, skip_repetitive=hop)
    else:
        svcall.alt = anchor.seq


def _assign_depths(svcall, track, probes):
    """Copy per-base depth values onto the call; probes outside the track
    leave the attribute untouched (reference: postprocessing.py:80-128)."""
    for attr, index in probes:
        try:
            setattr(svcall, attr, int(track[index]))
        except IndexError:
            pass


def coverage(calls: list[SVCall], lead_provider) -> float:
    """Annotate the five span depths (upstream/start/center/end/downstream)
    per call from the task's per-base coverage track; returns the track
    average (reference: postprocessing.py:69-130)."""
    track = lead_provider.coverage
    config = SnifflesConfig.GLOBAL
    step = config.coverage_binsize
    flank = step * config.coverage_updown_bins

    for svcall in calls:
        kind = svcall.svtype
        start = svcall.pos
        if kind == "INS":
            end = start + 1
        elif kind == "BND":
            end = start
            start -= 1 if svcall.bnd_info.is_first else 0
        else:
            end = start + abs(svcall.svlen)

        if svcall.svtype in ("INS", "BND"):
            inner = (("coverage_start", start - step),
                     ("coverage_center", start),
                     ("coverage_end", end + step))
        else:
            inner = (("coverage_start", start),
                     ("coverage_center", int((start + end) / 2)),
                     ("coverage_end", end - step))
        _assign_depths(svcall, track, inner)
        _assign_depths(svcall, track, (("coverage_upstream", start - flank),
                                       ("coverage_downstream", end + flank)))

    return lead_provider.coverage.mean()


# --------------------------------------------------------------------------
# Support screens


def rescale_support(svcall, config) -> int:
    """Long insertions are only partially traversed by reads, so raw read
    support under-counts; scale it up with length
    (reference: postprocessing.py:162-171)."""
    if svcall.svtype != "INS" or svcall.svlen < config.long_ins_length:
        return svcall.support
    growth = config.long_ins_rescale_mult * (float(svcall.svlen) / config.long_ins_length)
    return round(svcall.support * (config.long_ins_rescale_base + growth))


def qc_support_auto(svcall, coverage_global, config):
    """Support threshold from a regional/global coverage blend
    (reference: postprocessing.py:174-192)."""
    support = rescale_support(svcall, config)

    nearby = [d for d in (svcall.coverage_upstream, svcall.coverage_downstream) if d != 0]
    if not nearby:
        nearby = [d for d in (svcall.coverage_start, svcall.coverage_center,
                              svcall.coverage_end) if d != 0]
    regional = round(sum(nearby) / len(nearby)) if nearby else 0
    if regional == 0:
        regional = coverage_global

    w = config.minsupport_auto_regional_coverage_weight
    blended = regional * w + coverage_global * (1.0 - w)
    needed = round(config.minsupport_auto_base + config.minsupport_auto_mult * blended)
    return support >= needed


def qc_support_const(svcall, config):
    return svcall.support >= config.minsupport


def qc_sv_support(svcall, coverage_global, config) -> bool:
    """Minimum-support screen, auto or constant threshold
    (reference: postprocessing.py:133-159)."""
    ledger = FilterLedger(svcall, config)
    if config.minsupport == "auto":
        ok = qc_support_auto(svcall, coverage_global, config)
    else:
        ok = qc_support_const(svcall, config)
    if not ok and ledger.flag("SUPPORT_MIN"):
        return False
    ledger.seal()
    return True


# --------------------------------------------------------------------------
# Main QC cascade (pre-annotation)


def _screen_stdev(svcall, config, ledger):
    """Breakpoint/length scatter screens (reference: postprocessing.py:209-224)."""
    stdev_pos = svcall.get_info("STDEV_POS")
    if stdev_pos > config.qc_stdev_abs_max and ledger.flag("STDEV_POS"):
        return False
    if svcall.svtype not in ("BND", "SINGLE_LEFT", "SINGLE_RIGHT"):
        # The reference evaluates this ratio twice (first pass stamps without
        # returning); net effect is a single failure, reproduced here.
        if stdev_pos / abs(svcall.svlen) > 2.0 and ledger.flag("STDEV_POS"):
            return False

    stdev_len = svcall.get_info("STDEV_LEN")
    if stdev_len:
        if (svcall.svtype != "BND" and stdev_len / abs(svcall.svlen) > 1.0
                and ledger.flag("STDEV_LEN")):
            return False
        if stdev_len > config.qc_stdev_abs_max and ledger.flag("STDEV_LEN"):
            return False
    return True


def _screen_long_del_coverage(svcall, config, ledger):
    """Long deletions must show the expected central coverage drop
    (reference: postprocessing.py:252-285)."""
    up, mid, down = svcall.coverage_upstream, svcall.coverage_center, svcall.coverage_downstream
    expect_drop = config.long_del_coverage / 2.0

    if mid > (up + down) * expect_drop:
        if up > mid > down and down / up < _FLANK_RATIO_CEIL and ledger.flag("COV_CHANGE_DEL"):
            return False
        if up < mid < down and up / down < _FLANK_RATIO_CEIL and ledger.flag("COV_CHANGE_DEL"):
            return False
    if up > down:
        if (_FLANK_RATIO_FLOOR > down / up or mid > down) and ledger.flag("COV_CHANGE_DEL"):
            return False
    elif up < down:
        if (_FLANK_RATIO_FLOOR > up / down or up < mid) and ledger.flag("COV_CHANGE_DEL"):
            return False
    return True


def _screen_long_dup_coverage(svcall, config, ledger):
    """Long duplications must show the expected central coverage gain
    (reference: postprocessing.py:286-319)."""
    up, mid, down = svcall.coverage_upstream, svcall.coverage_center, svcall.coverage_downstream
    expect_gain = config.long_dup_coverage / 2.0

    if mid < (up + down) * expect_gain:
        if up > mid > down and down / up < _FLANK_RATIO_CEIL and ledger.flag("COV_CHANGE_DUP"):
            return False
        if up < mid < down and up / down < _FLANK_RATIO_CEIL and ledger.flag("COV_CHANGE_DUP"):
            return False
        if up > down:
            if (_FLANK_RATIO_FLOOR > down / up or mid < down) and ledger.flag("COV_CHANGE_DUP"):
                return False
        elif up < down:
            if (_FLANK_RATIO_FLOOR > up / down or up > mid) and ledger.flag("COV_CHANGE_DUP"):
                return False
    return True


def _screen_coverage_steps(svcall, config, ledger):
    """Adjacent span-point coverage jumps beyond the configured fraction
    (reference: postprocessing.py:350-381)."""
    frac = config.qc_coverage_max_change_frac
    if frac == -1.0:
        return True
    points = [float(d) if d != 0 else 1.0
              for d in (svcall.coverage_upstream, svcall.coverage_start,
                        svcall.coverage_center, svcall.coverage_end,
                        svcall.coverage_downstream)]
    tags = ("COV_CHANGE_FRAC_US", "COV_CHANGE_FRAC_SC",
            "COV_CHANGE_FRAC_CE", "COV_CHANGE_FRAC_ED")
    for (a, b), tag in zip(zip(points, points[1:]), tags):
        if abs(a - b) / max(a, b) > frac and ledger.flag(tag):
            return False
    return True


def qc_sv(svcall: SVCall, config) -> bool:
    """Pre-annotation QC cascade (reference: postprocessing.py:200-441)."""
    ledger = FilterLedger(svcall, config)

    if config.qc_stdev and not _screen_stdev(svcall, config, ledger):
        return False

    if (svcall.is_single_break and not config.dev_output_candidates
            and ledger.flag("SINGLE_BREAK")):
        return False

    if abs(svcall.svlen) < config.minsvlen and svcall.svtype != 'BND':
        if ((svcall.support < _SVLEN_WAIVER_SUPPORT or config.minsvlen_hard_cap)
                and ledger.flag("SVLEN_MIN")):
            return False

    if (svcall.svtype == "BND" and config.qc_bnd_filter_strand
            and _strand_diversity(svcall) < 2 and ledger.flag("STRAND_BND")):
        return False

    span = abs(svcall.svlen)
    if (svcall.svtype == "DEL" and config.long_del_length != -1
            and span >= config.long_del_length and not config.mosaic
            and span <= config.dev_longer_del):
        if not _screen_long_del_coverage(svcall, config, ledger):
            return False
    elif (svcall.svtype == "DUP" and config.long_dup_length != -1
            and span >= config.long_dup_length and not config.mosaic
            and span <= config.dev_longer_dup):
        if not _screen_long_dup_coverage(svcall, config, ledger):
            return False
    elif svcall.svtype == "INS" and (svcall.coverage_upstream < config.qc_coverage
                                     or svcall.coverage_downstream < config.qc_coverage):
        if ledger.flag("COV_CHANGE_INS"):
            return False

    if svcall.svtype in ("INS", "DEL"):
        # CIGAR-only events backed mostly by reads that also carry split
        # alignments are suspect (reference: postprocessing.py:329-339).
        sa_inline, sap_inline = svcall.postprocess.cluster.sa_counts
        if (sap_inline > config.dev_inline_sa_support_max
                and sa_inline > _INLINE_SA_MIN_READS
                and not svcall.info.get("SUPPORT_SA")
                and ledger.flag("INLINE_SA")):
            return False

    smooth, variance = svcall.qc_coverage_samples()
    svcall.set_info('COVERAGE_VAR', variance)
    if not smooth and ledger.flag("COV_VAR"):
        return False

    if not _screen_coverage_steps(svcall, config, ledger):
        return False

    ledger.seal()
    return True


# --------------------------------------------------------------------------
# Post-annotation QC (genotype-aware + mosaic arms)


def _screen_mosaic_support(svcall, config, ledger):
    """Mosaic-mode support/length rules (reference: postprocessing.py:444-468)."""
    stdev_pos = svcall.info.get("STDEV_POS")
    stdev_len = svcall.info.get("STDEV_LEN")
    span_info = svcall.info.get("SVLEN", 1)
    needed = config.mosaic_min_reads
    if stdev_pos is not None and stdev_len is not None and svcall.svtype in ACCEPTED_SVTYPES:
        scattered = ((not svcall.precise
                      or stdev_len / abs(svcall.svlen) > _MOSAIC_STDEV_LEN_RATIO
                      or stdev_pos > _MOSAIC_STDEV_POS_MAX)
                     and abs(span_info) <= config.max_svlen_mosaic)
        if not (svcall.svtype in ("BND", "INV") or scattered):
            needed = config.mosaic_min_reads - 1
    if svcall.support < needed and ledger.flag("SUPPORT_MIN"):
        return False
    if (svcall.svtype != "BND" and abs(svcall.svlen) > config.max_svlen_mosaic
            and ledger.flag("SVLEN_MAX_MOSAIC")):
        return False
    return True


def _screen_strand_support(svcall, config, ledger, mosaic_arm):
    """Both-strand support requirement, with the mosaic variant gated by a
    support floor (reference: postprocessing.py:470-487)."""
    if svcall.svtype == "BND":
        return True
    long_ins = svcall.svtype == "INS" and svcall.svlen >= config.long_ins_length
    if not mosaic_arm and config.qc_strand:
        if not long_ins and _strand_diversity(svcall) < 2 and ledger.flag("STRAND"):
            return False
    elif mosaic_arm and config.mosaic_qc_strand:
        if (not long_ins and _strand_diversity(svcall) < 2
                and svcall.support >= config.mosaic_use_strand_thresholds
                and ledger.flag("STRAND_MOSAIC")):
            return False
    return True


def _screen_mosaic_edges(svcall, config, ledger):
    """Mosaic calls anchored near read ends are artifacts
    (reference: postprocessing.py:520-532)."""
    if svcall.svtype in {"BND", "SINGLE_LEFT", "SINGLE_RIGHT"}:
        return True
    margin = config.dev_min_close_edge_dist
    near_edge = sum(1 for ld in svcall.postprocess.cluster.leads
                    if ld.qry_start <= margin or abs(ld.read_len - ld.qry_start) <= margin)
    if (near_edge / svcall.support >= config.dev_min_read_close_edge_prop
            and ledger.flag("MOSAIC_SV_CLOSE_EDGE")):
        return False
    return True


def qc_sv_post_annotate(svcall: SVCall, config, coverage_average_total: float,
                        nm_threshold: float) -> bool:
    """Genotype-aware QC incl. mosaic arms (reference: postprocessing.py:444-600).

    nm_threshold is the task's regional NM statistic (the reference reads
    config.qc_nm_threshold, which its lead scan writes; here the task's
    own scan gives it, so a decode-ahead scan of the next task cannot
    perturb this task's QC).
    """
    ledger = FilterLedger(svcall, config)

    af = svcall.get_info("VAF")
    af = af if af is not None else 0
    in_mosaic_band = af <= config.mosaic_af_max
    mosaic_arm = config.mosaic and in_mosaic_band

    if ((svcall.coverage_center < config.qc_coverage and
            (len(svcall.genotypes) == 0 or (svcall.genotypes[0][0] != "." and
                                            svcall.genotypes[0][0] + svcall.genotypes[0][1] < 2))) and
            ("DEL" != svcall.svtype and abs(svcall.svlen) > config.long_del_length)):
        if ledger.flag("COV_MIN_GT"):
            return False

    if config.mosaic and not in_mosaic_band:
        if not qc_sv_support(svcall, coverage_average_total, config) and not config.dev_filter:
            return False

    nm_active = config.mosaic_qc_nm if mosaic_arm else config.qc_nm
    nm_limit = nm_threshold * config.qc_nm_mult
    if (nm_active and svcall.nm > nm_limit
            and (len(svcall.genotypes) == 0 or svcall.genotypes[0][1] == 0)
            and ledger.flag("ALN_NM")):
        return False

    if not config.mosaic and in_mosaic_band:
        dup_exempt = svcall.svtype == "DUP" and af >= config.dev_min_dup_vaf
        if not dup_exempt and ledger.flag("MOSAIC_VAF"):
            return False

    if mosaic_arm and not _screen_mosaic_support(svcall, config, ledger):
        return False

    if not _screen_strand_support(svcall, config, ledger, mosaic_arm):
        return False

    if (mosaic_arm and svcall.svtype in ("INV", "DUP")
            and svcall.svlen < config.mosaic_qc_invdup_min_length
            and ledger.flag("SVLEN_MIN_MOSAIC")):
        return False

    if svcall.coverage_center < config.qc_coverage and svcall.svtype not in ("DEL", "INS"):
        # Parenthesization preserved from the reference: the comparison is
        # (svtype==INV and svlen) > threshold (reference: postprocessing.py:498).
        long_inv_exempt = ((svcall.svtype == "INV" and svcall.svlen) > config.long_inv_length
                           and not mosaic_arm)
        if not long_inv_exempt and ledger.flag("COV_MIN"):
            return False

    if config.mosaic:
        if in_mosaic_band and (af < config.mosaic_af_min or af > config.mosaic_af_max):
            if ledger.flag("MOSAIC_VAF"):
                return False
        elif not in_mosaic_band and not config.mosaic_include_germline:
            if ledger.flag("NOT_MOSAIC_VAF"):
                return False
        if in_mosaic_band and not _screen_mosaic_edges(svcall, config, ledger):
            return False

    ledger.seal_trimmed()
    return True


# --------------------------------------------------------------------------
# Genotyping + phasing glue


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


def _vote(values, conflict_threshold):
    """Majority vote with a conflict share; returns (winner, support, filter).

    The winner must carry positive support and less than the threshold share
    of conflicting (non-NULL, different) votes to PASS
    (reference: postprocessing.py:634-650).
    """
    tally = util.most_common(values)
    support, winner = tally[0]
    if winner is None:
        winner = "NULL"
    rivals = sum(n for n, v in tally if v != winner and v != "NULL")
    passed = (rivals / float(support + rivals) < conflict_threshold
              and winner != "NULL" and support > 0)
    return winner, support, "PASS" if passed else "FAIL"


# worker-local counters: device phase-tally consumption (merged into the
# per-task engine counters by pipeline/tasks and surfaced in the bench
# JSON via SNIFFLES_TPU_COUNTERS_JSON)
PHASE_COUNTERS = {"phase_fast": 0, "phase_fallback": 0}


def _phase_from_tallies(tally, threshold):
    """Reproduce _vote EXACTLY from the device's per-cluster phase
    tallies (ops/clustering.phase_tallies): the host vote is a pure
    function of the {value: unique-read-count} multiset (most_common
    sorts (count, value-string) descending), so integer counts decide
    it — except the two flagged cases, which return None for the exact
    host fallback: `mixed` reads (last-lead-wins would apply) and a
    non-null phase-set count tie (string comparison of unseen values).

    Returns ((hp, hp_support, hp_filter), (ps, ps_support, ps_filter))
    or None."""
    (hp0, hp1, hp2, hp_other, ps_win, ps_win_cnt, ps_second_cnt,
     ps_null, mixed) = tally
    if mixed or hp_other:
        return None
    hp_pairs = sorted(((c, str(h)) for h, c in ((0, hp0), (1, hp1), (2, hp2))
                       if c > 0), reverse=True)
    if not hp_pairs:
        return None
    hp_support, hp = hp_pairs[0]
    hp_rivals = sum(c for c, v in hp_pairs if v != hp)   # no 'NULL' in domain
    hp_pass = (hp_rivals / float(hp_support + hp_rivals) < threshold
               and hp_support > 0)

    if ps_win_cnt > 0 and ps_second_cnt == ps_win_cnt:
        return None   # tied non-null modes: winner needs the value strings
    nonnull = hp0 + hp1 + hp2 - ps_null
    # 'NULL' vs the non-null mode: most_common ties sort by string, and
    # "NULL" > any digit string, so NULL wins an equal count
    if ps_null >= ps_win_cnt:
        ps, ps_support, ps_rivals = "NULL", ps_null, nonnull
    else:
        ps, ps_support, ps_rivals = str(ps_win), ps_win_cnt, nonnull - ps_win_cnt
    ps_pass = (ps_rivals / float(ps_support + ps_rivals) < threshold
               and ps != "NULL" and ps_support > 0)
    return ((hp, hp_support, "PASS" if hp_pass else "FAIL"),
            (ps, ps_support, "PASS" if ps_pass else "FAIL"))


def phase_sv(svcall, config):
    """Derive the call's haplotype/phase-set from its supporting reads'
    HP/PS tags (reference: postprocessing.py:626-654).

    When the cluster carries device phase tallies (--tpu-call engine
    consumption), the vote is reconstructed from the integer counts
    without touching the leads; the exact lead iteration remains for
    host clusters and the flagged ambiguous cases."""
    cluster = svcall.postprocess.cluster
    engine = getattr(cluster, "engine", None)
    if engine is not None and engine.get("phase") is not None:
        votes = _phase_from_tallies(engine["phase"],
                                    config.phase_conflict_threshold)
        PHASE_COUNTERS["phase_fast" if votes is not None
                       else "phase_fallback"] += 1
        if votes is not None:
            (hp, hp_support, hp_filter), (ps, ps_support, ps_filter) = votes
            svcall.set_info("PHASE", f"{hp},{ps},{hp_support},{ps_support},"
                                     f"{hp_filter},{ps_filter}")
            hp_out = (hp if hp in config.phase_identifiers
                      and hp_filter == "PASS" else None)
            ps_out = ps if ps_filter == "PASS" else None
            return hp_out, ps_out

    by_read = {lead.read_id: (lead.hap, lead.phase_set)
               for lead in svcall.postprocess.cluster.leads}
    hp, hp_support, hp_filter = _vote([h for h, _ in by_read.values()],
                                      config.phase_conflict_threshold)
    ps, ps_support, ps_filter = _vote([p for _, p in by_read.values()],
                                      config.phase_conflict_threshold)

    svcall.set_info("PHASE", f"{hp},{ps},{hp_support},{ps_support},{hp_filter},{ps_filter}")
    hp_out = hp if hp in config.phase_identifiers and hp_filter == "PASS" else None
    ps_out = ps if ps_filter == "PASS" else None
    return hp_out, ps_out
