"""
Insertion-sequence consensus by k-mer-anchor pseudo-alignment.

Host-side exact port of the reference consensus (reference:
consensus.py:280-394 novel_from_reads; triggered from
postprocess.annotate_sv, params at config.py:549-553). Copied from
sniffles_tpu/consensus.py: novel_from_reads takes the native consensus
(bamcore_consensus_novel in csrc/host/bamcore.cc, io/native.py) for
klen <= 8, and the numpy path below, of equal output, with debug set or
when the native one declines its parameters.

The per-column vote, the alignment-count scan, and the segment-identity
pass are vectorized with numpy (the reference iterates per character,
consensus.py:360-394); `tests/test_consensus.py` checks the vectorized
path against a per-character spec implementation.
"""
from __future__ import annotations

import numpy as np

from sniffles_tpu_torch import util

_DASH = ord("-")

# Voting thresholds of the anchor consensus, shared by the vectorized and
# sequential formulations (reference: consensus.py:281-287): minimum
# non-gap votes per column, minimum matched-span fraction per read,
# minimum alignment share per column, segment identity floor (fraction and
# absolute), and the required vote margin over the runner-up.
_VOTE_PARAMS = (2, 0.2, 0.25, 0.5, 5, 3)


def iter_kmers(seq, klen, skip):
    """(reference: consensus.py:142-144)"""
    for i in range(0, len(seq) - klen, skip):
        yield (i, seq[i:i + klen])


def _flatten_votes(best_seq: str, alignments: list, consensus_min: int,
                   minalns: float, minbestdiff: int) -> str:
    """Per-column majority vote (reference: consensus.py:377-394),
    vectorized.

    The reference excludes '^'/'_' markers when counting alignments per
    column (consensus.py:379); BAM sequences draw from "=ACMGRSVTWYHKDBN"
    and our alignment strings only add '-', so those markers cannot occur
    and the per-column count is constant: len(alignments) + 1.
    """
    n_aln = len(alignments)
    if n_aln == 0:
        return best_seq
    size = len(best_seq)
    best = np.frombuffer(best_seq.encode("ascii"), dtype=np.uint8)
    if isinstance(alignments[0], np.ndarray):
        mat = np.vstack(alignments)
    else:
        mat = np.frombuffer("".join(alignments).encode("ascii"),
                            dtype=np.uint8).reshape(n_aln, size)
    maxal = float(n_aln + 1)

    al_count = (mat != _DASH).sum(axis=0)
    present = np.zeros(256, dtype=bool)
    present[mat.reshape(-1)] = True
    present[best] = True
    present[_DASH] = False
    syms = np.nonzero(present)[0].astype(np.uint8)
    counts = np.zeros((len(syms), size), dtype=np.int32)
    for k, s in enumerate(syms):
        counts[k] = (mat == s).sum(axis=0)
        counts[k] += (best == s)
    top_idx = counts.argmax(axis=0)
    sc = np.sort(counts, axis=0)
    top1 = sc[-1]
    top2 = sc[-2] if len(syms) >= 2 else np.zeros(size, dtype=np.int32)

    # reference: fewer than consensus_min non-gap chars, a sparse column,
    # or an ambiguous vote all fall back to the anchor read's base
    use_vote = ((al_count >= consensus_min)
                & (al_count / maxal >= minalns)
                & (top1 - top2 >= minbestdiff))
    out = np.where(use_vote, syms[top_idx], best)
    return out.tobytes().decode("ascii")


def _filter_segments(conseq: str, best: np.ndarray, minident: float,
                     minident_abs: int) -> str:
    carr = np.frombuffer(conseq.encode("ascii"), dtype=np.uint8).copy()
    return _filter_segments_arr(carr, best, minident,
                                minident_abs).tobytes().decode("ascii")


def _filter_segments_arr(carr: np.ndarray, best: np.ndarray, minident: float,
                         minident_abs: int) -> np.ndarray:
    """Blank out non-gap segments below the identity floor (reference:
    consensus.py:360-375), via run-length reduceat instead of the
    reference's per-character scan. Mutates and returns `carr`."""
    nondash = carr != _DASH
    if not nondash.any():
        return carr
    # run starts: first position, and every dash/non-dash flip
    flips = np.empty(carr.shape[0], dtype=bool)
    flips[0] = True
    np.not_equal(nondash[1:], nondash[:-1], out=flips[1:])
    starts = np.nonzero(flips)[0]
    eq = (carr == best[:carr.shape[0]]) & nondash
    ident_per_run = np.add.reduceat(eq.astype(np.int32), starts)
    len_per_run = np.diff(np.append(starts, carr.shape[0]))
    run_is_seq = nondash[starts]
    keep = (ident_per_run / len_per_run.astype(np.float64) > minident) \
        & (ident_per_run > minident_abs)
    blank = run_is_seq & ~keep
    for s, ln in zip(starts[blank], len_per_run[blank]):
        carr[s:s + ln] = _DASH
    return carr


def _pack_kmers(arr: np.ndarray, klen: int, skip: int) -> tuple[np.ndarray, np.ndarray]:
    """Sampled k-mer start positions and their base-256 packed uint64
    codes (injective for klen <= 8), matching iter_kmers' sampling."""
    n = arr.shape[0] - klen
    if n <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64)
    pos = np.arange(0, n, skip, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(arr, klen)[pos]
    powers = (256 ** np.arange(klen - 1, -1, -1, dtype=np.uint64))
    codes = win.astype(np.uint64) @ powers
    return pos, codes


def novel_from_reads(best_lead, other_leads, klen, skip, skip_repetitive, debug=False):
    """Per-position majority-vote consensus anchored on the best lead's
    sequence (reference: consensus.py:280-394).

    Semantics are identical to the reference's per-kmer dict walk
    (novel_from_reads_spec below, checked by tests/test_consensus.py);
    the anchor build, anchor matching, the monotone anchor-chain
    acceptance and the per-segment identity counts are vectorized:
    unique-sampled kmers via np.unique over packed codes, matches via
    searchsorted, the chain via a running-maximum scan, and identity
    sums via per-diagonal equality prefix sums."""
    if klen > 8:
        return novel_from_reads_spec(best_lead, other_leads, klen, skip,
                                     skip_repetitive, debug)
    if not debug:
        from sniffles_tpu_torch.io import native
        res = native.consensus_novel(
            best_lead.seq.encode("ascii"),
            [ld.seq.encode("ascii") for ld in other_leads],
            klen, skip, skip_repetitive)
        if res is not None:
            return res
    (consensus_min, minspan, minalns, minident, minident_abs,
     minbestdiff), maxshift = _VOTE_PARAMS, klen

    best_seq = best_lead.seq
    lb = len(best_seq)
    best_arr = np.frombuffer(best_seq.encode("ascii"), dtype=np.uint8)

    # anchors: sampled kmers of the best lead that occur exactly once in
    # the sample (a repeated kmer deletes its anchor and taboos further
    # occurrences -- net effect: count == 1)
    a_pos, a_codes = _pack_kmers(best_arr, klen, skip_repetitive)
    codes_u, first_idx, counts = np.unique(a_codes, return_index=True,
                                           return_counts=True)
    once = counts == 1
    anchor_codes = codes_u[once]                 # sorted by np.unique
    anchor_pos = a_pos[first_idx[once]]

    alignments = []
    for lead in other_leads:
        lead_seq = lead.seq
        lead_arr = np.frombuffer(lead_seq.encode("ascii"), dtype=np.uint8)
        l_pos, l_codes = _pack_kmers(lead_arr, klen, skip)
        if anchor_codes.shape[0]:
            idx = np.searchsorted(anchor_codes, l_codes)
            np.minimum(idx, anchor_codes.shape[0] - 1, out=idx)
            hit = anchor_codes[idx] == l_codes
        else:
            idx = np.zeros(0, dtype=np.int64)
            hit = np.zeros(l_codes.shape[0], dtype=bool)
        jj = l_pos[hit]
        ii = anchor_pos[idx[hit]] if anchor_codes.shape[0] else jj
        shift_ok = np.abs(ii - jj) <= maxshift
        ii = ii[shift_ok]
        jj = jj[shift_ok]
        if ii.shape[0] == 0:
            continue     # no anchors: span stays 0, alignment is dropped
        # greedy chain in j order: accept iff i exceeds every prior i
        # (prior rejected i are <= the running max, so the running max
        # over all priors equals the last accepted i)
        pm = np.maximum.accumulate(ii)
        accept = np.empty(ii.shape[0], dtype=bool)
        accept[0] = True
        accept[1:] = ii[1:] > pm[:-1]
        ii = ii[accept]
        jj = jj[accept]

        # Segment s runs from anchor s to anchor s+1. The reference walks
        # them sequentially, carrying `clen` (output length so far) with a
        # clamp at lb; since every fwd_j > 0, the clamped running length
        # is min(lb, clen0 + cumsum(fwd_j)) and the whole walk vectorizes.
        nseg = ii.shape[0] - 1
        if nseg == 0:
            continue     # single anchor: span 0, alignment dropped
        ll = lead_arr.shape[0]
        clen0 = int(ii[0]) if jj[0] > 0 else 0
        fwd_i = np.diff(ii)
        fwd_j = np.diff(jj)
        cum = np.minimum(clen0 + np.cumsum(fwd_j), lb)
        prev = np.empty(nseg, dtype=np.int64)
        prev[0] = clen0
        prev[1:] = cum[:-1]
        fwd_jc = cum - prev                      # post-clamp fwd_j
        same = (fwd_i == fwd_jc) & (fwd_jc > 0)
        span = int(fwd_j[same].sum())            # reference adds unclamped j-last_j
        if span / float(lb) <= minspan:
            continue

        # identity gate per same-diagonal segment: equal-char count between
        # lead[last_j+1:j+1] and best on diagonal d = last_i - last_j, via
        # one equality prefix sum per distinct diagonal
        ident_ok = np.zeros(nseg, dtype=bool)
        sidx = np.nonzero(same)[0]
        d_seg = ii[sidx] - jj[sidx]
        diag_prefix: dict[int, np.ndarray] = {}
        for d in np.unique(d_seg).tolist():
            pref = diag_prefix.get(d)
            if pref is None:
                eq = np.zeros(ll + 1, dtype=np.int32)
                s = max(0, -d)
                e = min(ll, lb - d)
                if e > s:
                    np.cumsum(lead_arr[s:e] == best_arr[s + d:e + d],
                              out=eq[s + 1:e + 1], dtype=np.int32)
                    eq[e + 1:] = eq[e]
                diag_prefix[d] = pref = eq
            sel = sidx[d_seg == d]
            m = pref[jj[sel + 1] + 1] - pref[jj[sel] + 1]
            ident_ok[sel] = (m.astype(np.float64)
                             / (jj[sel + 1] - jj[sel])) >= minident

        out = np.full(lb, _DASH, dtype=np.uint8)
        total = int(cum[-1]) - clen0
        if total > 0:
            use = same & ident_ok
            seg_of = np.repeat(np.arange(nseg), fwd_jc)
            within = np.arange(total, dtype=np.int64) \
                - np.repeat(prev - clen0, fwd_jc)
            src = jj[:nseg][seg_of] + within
            vals = np.where(use[seg_of], lead_arr[src], _DASH)
            out[clen0:clen0 + total] = vals

        alignments.append(_filter_segments_arr(out, best_arr, minident,
                                               minident_abs))

    return _flatten_votes(best_seq, alignments, consensus_min, minalns,
                          minbestdiff)


def _unique_anchor_map(seq: str, klen: int, skip: int) -> dict:
    """k-mer -> position over the anchor read, keeping only k-mers seen
    exactly once in the sample (repeated k-mers are poisoned)
    (reference: consensus.py:291-299)."""
    anchors: dict = {}
    repeated: set = set()
    for pos, kmer in iter_kmers(seq, klen=klen, skip=skip):
        if kmer in repeated:
            continue
        if kmer in anchors:
            del anchors[kmer]
            repeated.add(kmer)
        else:
            anchors[kmer] = pos
    return anchors


def _project_onto_anchor(best_seq, best_arr, lead, anchors, klen, skip,
                         maxshift, minident):
    """Pseudo-align one lead onto the anchor read's coordinates via shared
    unique k-mers: between consecutive accepted anchors on the same
    diagonal, copy the lead's bases when segment identity clears the
    floor; anything else becomes gaps.  Returns (projection, span)
    (reference: consensus.py:301-338)."""
    blen = len(best_seq)
    lead_arr = np.frombuffer(lead.seq.encode("ascii"), dtype=np.uint8)
    pieces: list[str] = []
    written = 0
    span = 0
    prev_i = prev_j = None

    for j, kmer in iter_kmers(lead.seq, klen=klen, skip=skip):
        i = anchors.get(kmer)
        if i is None or abs(i - j) > maxshift:
            continue
        if prev_i is not None and i <= prev_i:
            continue

        if prev_i is None:
            if j > 0:
                pieces, written = ["-" * i], i
        else:
            step_i = i - prev_i
            step_j = min(j - prev_j, blen - written)
            if step_i == step_j and step_j > 0:
                span += j - prev_j
                hits = int((lead_arr[prev_j + 1:j + 1]
                            == best_arr[prev_i + 1:prev_i + 1 + (j - prev_j)]).sum())
                if hits / float(j - prev_j) >= minident:
                    pieces.append(lead.seq[prev_j:j][:step_j])
                else:
                    pieces.append("-" * step_j)
            else:
                pieces.append("-" * step_j)
            written += step_j
        prev_i, prev_j = i, j

    projection = "".join(pieces)
    if len(projection) < blen:
        projection += "-" * (blen - len(projection))
    return projection, span


def novel_from_reads_spec(best_lead, other_leads, klen, skip, skip_repetitive,
                          debug=False):
    """Sequential per-kmer formulation of the reference consensus
    (reference: consensus.py:280-394); the exactness reference for the
    vectorized novel_from_reads above and the fallback for klen > 8
    (the packed-code fast path needs one uint64 per kmer)."""
    (consensus_min, minspan, minalns, minident, minident_abs,
     minbestdiff), maxshift = _VOTE_PARAMS, klen

    anchors = _unique_anchor_map(best_lead.seq, klen, skip_repetitive)
    best_arr = np.frombuffer(best_lead.seq.encode("ascii"), dtype=np.uint8)

    alignments = []
    for lead in other_leads:
        projection, span = _project_onto_anchor(
            best_lead.seq, best_arr, lead, anchors, klen, skip, maxshift, minident)
        projection = _filter_segments(projection, best_arr, minident, minident_abs)
        if span / float(len(best_lead.seq)) > minspan:
            alignments.append(projection)

    return _flatten_votes(best_lead.seq, alignments, consensus_min, minalns,
                          minbestdiff)
