"""Combine-mode group assignment: the greedy best-group search
(reference: cluster.py:356-390). Copied from sniffles_tpu/cluster.py;
the call-path clustering is not part of the combine slice, and SNF
blocks pickle no Cluster object (postprocess is None once a call is
finalized), so the class is not carried over.
"""
from __future__ import annotations

import math

from sniffles_tpu_torch import svcall as sv


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
