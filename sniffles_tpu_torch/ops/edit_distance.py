"""
Edit (Levenshtein) distance kernels.

Replaces `edlib.align(...)['editDistance']` (reference: sv.py:287,
snfp.py:103 — global/NW distance between INS alt sequences when merging
across samples).

Two implementations:
  * `edit_distance` — host-side Myers bit-parallel algorithm: the native
    uint64-blocked scan of the port's native library (io/native.py) for
    ASCII input, else Python big ints; O(n*m/w), exact, used by the host
    pipeline.
  * `edit_distance_batch` — the same bit-vector recurrence on the card,
    one warp per pair (ops/edit_distance_batch.py), operating on padded
    uint8 sequence tensors.

A copy of sniffles_tpu/ops/edit_distance.py.
"""
from __future__ import annotations


def edit_distance(a: str, b: str, k: int = -1) -> int:
    """Global (NW) Levenshtein distance via Myers' bit-parallel scan.

    With k >= 0 the result is exact when <= k, and k+1 when the true
    distance exceeds k (the bounded form the identity gates need —
    `edlib.align(..., k=...)` semantics). Common prefix/suffix trimming
    and a per-column abort (`score - remaining_cols > k` proves
    exceedance) make near-identical and far-apart pairs cheap; both are
    exact under unit edit costs.

    ASCII input goes to the uint64-blocked C implementation in
    csrc/host/bamcore.cc (same algorithm); this pure-Python version takes
    the rest and is the exactness reference."""
    # trim common prefix / suffix (exact under unit costs)
    lo = 0
    hi_a, hi_b = len(a), len(b)
    while lo < hi_a and lo < hi_b and a[lo] == b[lo]:
        lo += 1
    while hi_a > lo and hi_b > lo and a[hi_a - 1] == b[hi_b - 1]:
        hi_a -= 1
        hi_b -= 1
    a = a[lo:hi_a]
    b = b[lo:hi_b]
    m = len(a)
    n = len(b)
    if k >= 0 and abs(m - n) > k:
        return k + 1
    if m == 0:
        return n
    if n == 0:
        return m
    try:
        ab = a.encode("ascii")
        bb = b.encode("ascii")
    except UnicodeEncodeError:
        ab = None
    if ab is not None:
        from sniffles_tpu_torch.io import native
        return int(native.get_lib().bamcore_edit_distance_k(ab, m, bb, n, k))
    # Build match bitmasks for the pattern
    peq: dict[str, int] = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)

    mask = (1 << m) - 1
    hibit = 1 << (m - 1)
    pv = mask
    mv = 0
    score = m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = (mv | (~(xh | pv) & mask)) & mask
        mh = pv & xh
        if ph & hibit:
            score += 1
        if mh & hibit:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mv_new = ph & xv
        pv = ((mh << 1) | (~(xv | ph) & mask)) & mask
        mv = mv_new
        n -= 1
        if k >= 0 and score - n > k:
            return k + 1
    return score
