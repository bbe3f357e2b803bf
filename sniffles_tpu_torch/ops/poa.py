"""
Multi-sequence consensus for the local-assembly rescue path.

Replaces pyspoa.poa (reference: local_asm.py:287-291): `poa(sequences,
...)` returns (consensus, msa). The engine is a graph-based
partial-order alignment in C++ (csrc/host/poacore.cc, built with the
port's native library at first use — a failed build raises:
sequence-to-graph banded affine DP, aligned-node groups for mismatches,
heaviest-bundle consensus with min-coverage trimming). Where the graph
gives no consensus (an empty one after trimming, or a failure of
poacore_consensus) the star alignment below (center sequence + banded
Gotoh + column majority vote) takes its place, as in
sniffles_tpu/ops/poa.py, of which this is a copy.
"""
from __future__ import annotations

from collections import Counter

from sniffles_tpu_torch.ops.align import banded_global_affine


def _pick_center(sequences: list[str]) -> int:
    """Index of the sequence with median length (robust star center)."""
    order = sorted(range(len(sequences)), key=lambda i: len(sequences[i]))
    return order[len(order) // 2]


def consensus_from_sequences(sequences: list[str], min_coverage: int = 1,
                             match: int = 10, mismatch: int = -10,
                             gap_open: int = -20, gap_extend: int = 0,
                             slack: int = 256) -> str:
    """Multi-sequence consensus: graph POA (native), or the star
    alignment where the graph gives none."""
    sequences = [s for s in sequences if s]
    if not sequences:
        return ""
    if len(sequences) == 1:
        return sequences[0]

    from sniffles_tpu_torch.io import native
    cons = native.poa_consensus(sequences, match=match, mismatch=mismatch,
                                gap_open=gap_open, gap_extend=gap_extend,
                                min_coverage=min_coverage, band_slack=slack)
    if cons:
        return cons

    ci = _pick_center(sequences)
    center = sequences[ci]
    others = [s for i, s in enumerate(sequences) if i != ci]

    # Column profiles over center coordinates; insertions keyed by
    # (center_pos, run_index) are only kept if a majority of reads has them.
    votes: list[Counter] = [Counter() for _ in range(len(center))]
    ins_after: dict[int, Counter] = {}

    for s in others:
        res = banded_global_affine(center, s, match=match, mismatch=mismatch,
                                   gap_open=gap_open, gap_extend=gap_extend, slack=slack)
        if res is None:
            continue
        aln_c, aln_s, _ = res
        cpos = -1
        pending_ins: list[str] = []
        for cc, sc in zip(aln_c, aln_s):
            if cc == '-':
                pending_ins.append(sc)
            else:
                if pending_ins:
                    ins_after.setdefault(cpos, Counter())[''.join(pending_ins)] += 1
                    pending_ins = []
                cpos += 1
                votes[cpos][sc] += 1
        if pending_ins:
            ins_after.setdefault(cpos, Counter())[''.join(pending_ins)] += 1

    n_other = len(others)
    majority = (n_other + 1) // 2 + ((n_other + 1) % 2)  # > half of (others + center)
    out: list[str] = []
    for i, base in enumerate(center):
        if i - 1 in ins_after:
            seq, count = ins_after[i - 1].most_common(1)[0]
            if count + 0 >= majority:
                out.append(seq)
        v = votes[i]
        total = sum(v.values())
        if total >= min_coverage and total > 0:
            top_base, top_count = v.most_common(1)[0]
            # center base gets one implicit vote
            if top_base != '-' and top_count > v.get(base, 0) + 1 and top_count > total / 2:
                out.append(top_base)
            elif top_base == '-' and top_count > total / 2 and top_count >= majority:
                continue  # deletion consensus: drop center base
            else:
                out.append(base)
        else:
            out.append(base)
    return "".join(out)


def poa(sequences: list[str], algorithm: int = 0, genmsa: bool = True,
        min_coverage: int = 1, m: int = 10, n: int = -10, g: int = -20,
        e: int = 0, q: int = -10, c: int = -1,
        slack: int | None = None) -> tuple[str, list[str]]:
    """
    pyspoa.poa-compatible facade (reference: local_asm.py:287-291).

    Returns (consensus, msa). For exactly two sequences the msa is the
    pairwise banded affine alignment; for more, alignments of each
    sequence against the consensus. The two-piece affine params (q, c)
    are folded into a single affine model. `slack` widens the pairwise
    band — callers aligning a consensus across a length-L event must
    pass slack >= L, since the event's gap shifts the alignment off the
    main diagonal even when the sequence lengths agree.
    """
    sequences = list(sequences)
    if not sequences:
        return "", []
    if len(sequences) == 2:
        if slack is None:
            slack = max(256, abs(len(sequences[0]) - len(sequences[1])) // 8)
        res = banded_global_affine(sequences[0], sequences[1], match=m, mismatch=n,
                                   gap_open=g, gap_extend=e, slack=slack)
        if res is None:
            return sequences[0], []
        aln_a, aln_b, _ = res
        return sequences[0], [aln_a, aln_b]

    cons = consensus_from_sequences(sequences, min_coverage=min_coverage,
                                    match=m, mismatch=n, gap_open=g, gap_extend=e)
    msa: list[str] = []
    if genmsa:
        for s in sequences:
            res = banded_global_affine(cons, s, match=m, mismatch=n, gap_open=g, gap_extend=e)
            if res is not None:
                msa.append(res[1])
    return cons, msa
