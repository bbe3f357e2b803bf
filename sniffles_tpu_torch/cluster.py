"""Signature clustering: seed-bin clusters, adaptive merge sweep, inner
merge, svlen resplit, BND resplit, and combine group assignment.

Host-side exact implementation of the reference clustering semantics
(reference: cluster.py:27-390).  The merge sweep is an order-dependent
sequential algorithm with backtracking; the device pipeline in
ops/clustering.py implements the sort-and-segment formulation and is
validated against this module. Copied from sniffles_tpu/cluster.py.
"""
from __future__ import annotations

import logging
import math
import statistics
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional, Any, Generator, Iterator, TYPE_CHECKING

from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch import util

if TYPE_CHECKING:
    from sniffles_tpu_torch import leads as leadprov

log = logging.getLogger(__name__)


@dataclass
class Cluster:
    """A group of leads believed to describe the same SV
    (reference: cluster.py:27-82)."""
    svtype: str
    contig: str
    id: str
    seed: int
    start: int
    end: int
    leads: list['leadprov.Lead']
    leads_long: Optional[list]
    repeat: bool
    hap_counts: tuple
    sa_counts: tuple = (0, 0.0)

    @property
    def span(self) -> Optional[int]:
        if None in (self.start, self.end):
            return None
        return self.end - self.start

    def compute_metrics(self, max_n=100):
        """Subsampled mean svlen + start-position stdev, driving the merge
        sweep criteria.  Quirk preserved from the reference: the stride
        subsample can visit more than max_n leads while the mean still
        divides by max_n (reference: cluster.py:48-61).
        """
        n = min(len(self.leads), max_n)
        if n == 0:
            self.mean_svlen, self.stdev_start = 0, 0
        elif n == 1:
            self.mean_svlen, self.stdev_start = self.leads[0].svlen, 0
        else:
            stride = int(len(self.leads) / n)
            picks = range(0, len(self.leads), stride)
            self.mean_svlen = sum(self.leads[i].svlen for i in picks) / float(n)
            self.stdev_start = util.stdev([self.leads[i].ref_start for i in picks])

    def get_break(self):
        """Single-end break location for long-INS clusters: the median
        soft-clip anchor, accepted when it agrees with the mean
        (reference: cluster.py:63-77)."""
        from sniffles_tpu_torch.config import SnifflesConfig
        cfg = SnifflesConfig.GLOBAL
        if not self.leads_long or len(self.leads_long) < cfg.dev_single_break_count:
            return None
        anchors = [lead.ref_start for lead in self.leads_long]
        loc = int(statistics.median(anchors))
        if abs(loc - int(statistics.mean(anchors))) < cfg.dev_single_break_dist:
            return loc
        return None

    def get_sa_count(self):
        pool = self.leads + self.leads_long if self.leads_long is not None else self.leads
        with_sa = sum(1 for lead in pool if lead.is_sa)
        self.sa_counts = (with_sa, with_sa / float(len(pool)))

    def spawn(self, suffix: str, leads: list, leads_long="inherit") -> 'Cluster':
        """Child cluster carrying a subset of leads (used by resplit)."""
        return Cluster(id=self.id + suffix, svtype=self.svtype, contig=self.contig,
                       start=self.start, end=self.end, seed=self.seed, leads=leads,
                       repeat=self.repeat,
                       leads_long=self.leads_long if leads_long == "inherit" else leads_long,
                       hap_counts=self.hap_counts)


# --------------------------------------------------------------------------
# Intra-cluster refinement


def merge_inner(cluster: Cluster, threshold: int) -> Cluster:
    """Combine fragmented INS/DEL leads of the same read into one lead when
    their ref/query anchors are within threshold; threshold -1 merges a
    read's leads unconditionally (inside tandem repeats)
    (reference: cluster.py:85-122)."""
    by_read: dict[str, list] = {}
    for ld in cluster.leads:
        by_read.setdefault(ld.read_qname, []).append(ld)

    merged_leads = []
    for fragments in by_read.values():
        fragments.sort(key=lambda k: k.ref_start)
        open_lead = fragments[0]
        prev = fragments[0]
        for nxt in fragments[1:]:
            # NB the strand condition binds to the threshold branch only,
            # exactly as in the reference: threshold -1 merges regardless.
            near = ((abs(nxt.ref_start - prev.ref_end) < threshold
                     or abs(nxt.ref_start - prev.ref_start) < threshold)
                    and (abs(nxt.qry_start - prev.qry_end) < threshold
                         or abs(nxt.qry_start - prev.qry_start) < threshold))
            if threshold == -1 or (near and open_lead.strand == nxt.strand):
                open_lead.svlen += nxt.svlen
                open_lead.seq = (None if nxt.seq is None or open_lead.seq is None
                                 else open_lead.seq + nxt.seq)
            else:
                merged_leads.append(open_lead)
                open_lead = nxt
            prev = nxt
        merged_leads.append(open_lead)

    cluster.leads = merged_leads
    return cluster


def resplit(cluster: Cluster, prop, binsize, merge_threshold_min, merge_threshold_frac):
    """Split a cluster along the svlen histogram: quantize to bins, then
    re-join adjacent bins whose gap is small relative to their lengths
    (reference: cluster.py:125-161)."""
    by_bin: dict[int, list] = {}
    for lead in cluster.leads:
        q = int(abs(prop(lead)) / binsize) * binsize
        by_bin.setdefault(q, []).append(lead)

    order = sorted(by_bin)
    i = 1
    while len(order) > 1 and i < len(order):
        lo, hi = order[i - 1], order[i]
        allowed = max(merge_threshold_min, min(hi, lo) * merge_threshold_frac)
        if abs(hi - lo) <= allowed:
            # fold the lower bin into the higher one (higher-bin leads stay
            # first; downstream center statistics depend on this order)
            by_bin[hi].extend(by_bin[lo])
            order.pop(i - 1)
            i = max(0, i - 2)
        i += 1

    for q in order:
        yield cluster.spawn(f".{q}", by_bin[q])


def resplit_bnd(cluster: 'Cluster', merge_threshold: int) -> Iterator['Cluster']:
    """Partition BND leads by (mate contig, orientation), then by runs of
    nearby mate-position bins (reference: cluster.py:164-216)."""
    if len(cluster.leads) <= 1:
        yield cluster
        return

    partitions: dict = defaultdict(lambda: defaultdict(list))
    for lead in cluster.leads:
        info = lead.bnd_info
        pos_bin = (int(info.mate_ref_start / merge_threshold) * merge_threshold
                   if merge_threshold > 0 else 0)
        partitions[(info.mate_contig, info.is_first)][pos_bin].append(lead)

    for (mate_contig, _), by_bin in partitions.items():
        bins = sorted(by_bin)
        run = list(by_bin[bins[0]])
        prev_bin = bins[0]
        tag_bin = 0
        for tag_bin in bins[1:]:
            if tag_bin - prev_bin <= merge_threshold:
                run.extend(by_bin[tag_bin])
            else:
                if run:
                    yield cluster.spawn(f".CHR2.{mate_contig}.POS2.{tag_bin}",
                                        list(run), leads_long=None)
                run = list(by_bin[tag_bin])
            prev_bin = tag_bin
        if run:
            # NB tag_bin here is the last bin visited (or 0 for a single
            # bin), matching the reference's id quirk (cluster.py:199)
            yield cluster.spawn(f".CHR2.{mate_contig}.POS2.{tag_bin}",
                                list(run), leads_long=None)


# --------------------------------------------------------------------------
# Main clustering entry (per svtype, per task)


class _RepeatCursor:
    """Walks the sorted tandem-repeat intervals alongside the seed sweep
    (reference: cluster.py:232-246)."""

    def __init__(self, tr):
        self.tr = tr if tr else None
        self.idx = 0
        if self.tr:
            self.lo, self.hi = self.tr[0]

    def covers(self, seed) -> bool:
        if self.tr is None or self.idx >= len(self.tr):
            return False
        while self.hi < seed and self.idx + 1 < len(self.tr):
            self.idx += 1
            self.lo, self.hi = self.tr[self.idx]
        return self.lo < seed < self.hi


def _seed_clusters(svtype, leadtab_provider, config, tr):
    """One cluster per occupied 100bp bin with enough leads
    (reference: cluster.py:229-275)."""
    leadtab = leadtab_provider.leadtab[svtype]
    hap_counts = leadtab_provider.leadhapcount[svtype]
    hap_ref = leadtab_provider.leadhapcount["REF"]
    cursor = _RepeatCursor(tr)

    clusters = []
    for seed_index, seed in enumerate(sorted(leadtab)):
        in_repeat = cursor.covers(seed)

        binned = leadtab[seed]
        if svtype == "INS":
            # soft-clip (svlen None) leads are long-INS side evidence
            leads = [lead for lead in binned if lead.svlen is not None]
            leads_long = [lead for lead in binned if lead.svlen is None]
        else:
            leads, leads_long = binned, None

        h0, h1, h2 = hap_counts[seed]
        sv_haps = (h0, h1, h2)
        if seed in hap_ref:
            r0, r1, r2 = hap_ref[seed]
            ref_haps = (r0, r1, r2)
        else:
            ref_haps = (0, 0, 0)

        if len(leads) >= config.dev_min_leads_cluster:
            cluster = Cluster(
                svtype=svtype, contig=leadtab_provider.contig,
                id=f"CL.{svtype}.{leadtab_provider.contig}.{leadtab_provider.start}.{seed_index}",
                seed=seed, start=seed, end=seed + config.cluster_binsize,
                leads=leads, leads_long=leads_long,
                repeat=in_repeat or config.repeat,
                hap_counts=sv_haps + ref_haps)
            cluster.compute_metrics()
            clusters.append(cluster)
    return clusters


def _merge_sweep(clusters, svtype, config):
    """Adjacent-cluster merge with backtracking.  Criteria: stddev-scaled
    inner distance, tandem-repeat length-scaled outer distance, and a flat
    BND distance (reference: cluster.py:277-308)."""
    i = 0
    while i < len(clusters) - 1:
        a, b = clusters[i], clusters[i + 1]
        inner = b.start - a.end
        outer = b.end - a.start

        merge = inner <= min(a.stdev_start, b.stdev_start) * config.cluster_r
        if not merge and (config.repeat or a.repeat or b.repeat):
            reach = min(config.cluster_repeat_h_max,
                        (abs(a.mean_svlen) + abs(b.mean_svlen)) * config.cluster_repeat_h)
            merge = outer <= reach
        if not merge and svtype == "BND":
            merge = inner <= config.cluster_merge_bnd

        if merge:
            clusters.pop(i + 1)
            a.leads += b.leads
            if svtype == "INS":
                a.leads_long += b.leads_long
            a.end = b.end
            a.repeat = a.repeat or b.repeat
            a.compute_metrics()
            i = max(0, i - 2)
        i += 1
    return clusters


def _trace_and_dump(clusters, svtype, leadtab_provider, config):
    if config.dev_trace_read:
        for c in clusters:
            for ld in c.leads:
                if ld.read_qname in config.dev_trace_read:
                    print(f"[DEV_TRACE_READ] [2/4] [cluster.resolve] Read lead {ld} is in "
                          f"cluster {c.id}, containing a total of {len(c.leads)} leads.")

    if config.dev_dump_clusters:
        filename = (f"{config.vcf}.clusters.{svtype}.{leadtab_provider.contig}."
                    f"{leadtab_provider.start}.{leadtab_provider.end}.bed")
        with open(filename, "w") as h:
            for c in clusters:
                details = "".join(
                    f"(ref_start={ld.ref_start},svlen={ld.svlen},source={ld.source}); "
                    for ld in c.leads)
                info = f"ID={c.id}, #LEADS={len(c.leads)}; " + details
                h.write(f"{c.contig}\t{c.start}\t{c.end}\t\"{info}\"\n")


def resolve(svtype, leadtab_provider, config, tr) -> Generator[Cluster | Any, None, list[Any] | None]:
    """Cluster one svtype's binned leads for a task region: seed, sweep-
    merge, then per-type refinement (reference: cluster.py:219-353)."""
    if not leadtab_provider.leadtab[svtype]:
        return []

    clusters = _merge_sweep(_seed_clusters(svtype, leadtab_provider, config, tr),
                            svtype, config)
    _trace_and_dump(clusters, svtype, leadtab_provider, config)

    resplit_off = config.dev_no_resplit_repeat or config.dev_no_resplit
    for cluster in clusters:
        if not cluster.leads:
            continue
        if svtype == "BND":
            if config.dev_no_resplit:
                yield cluster
            else:
                yield from resplit_bnd(cluster, merge_threshold=config.cluster_merge_bnd)
            continue
        if svtype in ("INS", "DEL"):
            merge_inner(cluster, -1 if cluster.repeat else config.cluster_merge_pos)
        if resplit_off:
            yield cluster
        else:
            yield from resplit(cluster,
                               prop=lambda lead: lead.svlen,
                               binsize=config.cluster_resplit_binsize,
                               merge_threshold_min=config.minsvlen,
                               merge_threshold_frac=config.cluster_merge_len)


# --------------------------------------------------------------------------
# Combine-mode group assignment


def _best_bnd_group(svcand, groups, config):
    """Closest group by pos + mate-pos distance on the same mate contig
    (reference: cluster.py:362-371)."""
    info = svcand.bnd_info
    best, best_dist = None, math.inf
    for group in groups:
        dist = (abs(group.pos_mean - svcand.pos)
                + abs(group.bnd_mate_ref_start_mean - info.mate_ref_start))
        if (dist < best_dist and dist <= config.cluster_merge_bnd * 2
                and group.bnd_mate_contig == info.mate_contig):
            if (not config.combine_separate_intra
                    or svcand.sample_internal_id not in group.included_samples):
                best, best_dist = group, dist
    return best


def _best_length_group(svcand, groups, config, ed_cache):
    """Closest group by pos + length distance within the sqrt-scaled match
    radius, gated by sequence identity (reference: cluster.py:373-385)."""
    best, best_dist = None, math.inf
    for group in groups:
        dist = (abs(group.pos_mean - svcand.pos)
                + abs(abs(group.len_mean) - abs(svcand.svlen)))
        shorter = float(min(abs(group.len_mean), abs(svcand.svlen)))
        if (shorter > 0 and dist < best_dist
                and dist <= config.combine_match * math.sqrt(shorter)
                and dist <= config.combine_match_max):
            if ((not config.combine_separate_intra
                 or svcand.sample_internal_id not in group.included_samples)
                    and group.align_call(svcand, config.combine_pctseq, ed_cache)):
                best, best_dist = group, dist
    return best


def resolve_block_groups(svtype, svcands, groups_initial, config, ed_cache=None):
    """Greedy best-group assignment in support-descending order
    (reference: cluster.py:356-390).  ed_cache optionally carries
    device-precomputed pairwise edit distances for the INS identity gate."""
    groups = groups_initial
    for svcand in sorted(svcands, key=lambda cand: cand.support, reverse=True):
        if svtype == "BND":
            target = _best_bnd_group(svcand, groups, config)
        else:
            target = _best_length_group(svcand, groups, config, ed_cache)
        if target is None:
            groups.append(sv.SVGroup.from_candidate(svcand))
        else:
            target.add_candidate(svcand)
    return groups


from sniffles_tpu_torch.compat import alias_module_for_pickle

alias_module_for_pickle("sniffles.cluster", __name__, [Cluster])
