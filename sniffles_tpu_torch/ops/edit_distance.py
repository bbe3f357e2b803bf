"""
Edit (Levenshtein) distance kernels.

Replaces `edlib.align(...)['editDistance']` (reference: sv.py:287,
snfp.py:103 — global/NW distance between INS alt sequences when merging
across samples).

Two implementations:
  * `edit_distance` — host-side Myers bit-parallel algorithm: the native
    uint64-blocked scan of native/libbamcore.so when that library loads,
    else Python big ints; O(n*m/w), exact, used by the host pipeline.
  * `edit_distance_batch` — the same bit-vector recurrence on the card,
    one warp per pair (ops/edit_distance_batch.py), operating on padded
    uint8 sequence tensors.

A copy of sniffles_tpu/ops/edit_distance.py with its own loader for the
native library (the loading logic of sniffles_tpu/io/native.py, reduced
to the two edit-distance symbols).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libbamcore.so")


@functools.lru_cache(maxsize=1)
def native_lib() -> Optional[ctypes.CDLL]:
    """native/libbamcore.so with its edit-distance entry points typed, or
    None when the library is absent or does not load."""
    if not os.path.exists(_LIB_PATH):
        return None
    # RTLD_DEEPBIND: libraries loaded earlier in the process may export
    # their own zlib symbols RTLD_GLOBAL; this library must resolve
    # against its own first (the same mode as sniffles_tpu/io/native.py)
    mode = ctypes.DEFAULT_MODE
    if hasattr(os, "RTLD_DEEPBIND"):
        mode = os.RTLD_LOCAL | os.RTLD_DEEPBIND
    try:
        lib = ctypes.CDLL(_LIB_PATH, mode=mode)
    except OSError:
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
    try:
        lib.bamcore_edit_distance.restype = ctypes.c_int64
        lib.bamcore_edit_distance.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    except AttributeError:
        return None
    try:  # separate: a stale build may lack the bounded variant
        lib.bamcore_edit_distance_k.restype = ctypes.c_int64
        lib.bamcore_edit_distance_k.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64]
    except AttributeError:
        pass
    return lib


def edit_distance(a: str, b: str, k: int = -1) -> int:
    """Global (NW) Levenshtein distance via Myers' bit-parallel scan.

    With k >= 0 the result is exact when <= k, and k+1 when the true
    distance exceeds k (the bounded form the identity gates need —
    `edlib.align(..., k=...)` semantics). Common prefix/suffix trimming
    and a per-column abort (`score - remaining_cols > k` proves
    exceedance) make near-identical and far-apart pairs cheap; both are
    exact under unit edit costs.

    Dispatches to the uint64-blocked C implementation in native/bamcore.cc
    when available (same algorithm); this pure-Python version is the
    fallback and the exactness reference."""
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
        lib = native_lib()
        if lib is not None and hasattr(lib, "bamcore_edit_distance_k"):
            return int(lib.bamcore_edit_distance_k(ab, m, bb, n, k))
        if lib is not None and hasattr(lib, "bamcore_edit_distance"):
            d = int(lib.bamcore_edit_distance(ab, m, bb, n))
            return d if k < 0 or d <= k else k + 1
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
