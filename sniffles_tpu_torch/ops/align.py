"""
Banded affine-gap (Gotoh) pairwise alignment with traceback.

Replaces the SPOA consensus<->reference MSA used by the local-assembly
rescue (reference: local_asm.py:287-291 calls pyspoa.poa). The band is
centered on the diagonal range k = j - i in [min(0, m-n) - slack,
max(0, m-n) + slack], which covers alignments containing one dominant
indel (the SV) plus small noise — exactly the local-asm use case.

The in-row E dependency (gap-in-A runs) is vectorized with a prefix
cummax/argmax so each DP row is O(band) numpy work; E-run starts are
recorded so traceback emits whole gap runs exactly. Copied from
sniffles_tpu/ops/align.py.
"""
from __future__ import annotations

import numpy as np

NEG = -(10 ** 8)

TB_M = 0     # diagonal
TB_E = 1     # gap in A (consumes B)
TB_F = 2     # gap in B (consumes A)
FLAG_F_EXT = 0x8   # F extended from F above
FLAG_NOE_F = 0x10  # max(M, F) at this cell is F


def _encode(seq: str) -> np.ndarray:
    return np.frombuffer(seq.upper().encode("ascii"), dtype=np.uint8)


def banded_global_affine(a: str, b: str, match: int = 10, mismatch: int = -10,
                         gap_open: int = -20, gap_extend: int = 0,
                         slack: int = 256, max_cells: int = 120_000_000):
    """
    Global alignment of a (rows) vs b (cols) with affine gap cost
    go + ge * L. Returns (aln_a, aln_b, score) with '-' gaps, or None
    when the banded problem exceeds max_cells.
    """
    n, m = len(a), len(b)
    if n == 0:
        return "-" * m, b, (gap_open + gap_extend * m if m else 0)
    if m == 0:
        return a, "-" * n, gap_open + gap_extend * n

    klo = min(0, m - n) - slack
    khi = max(0, m - n) + slack
    w = khi - klo + 1
    if (n + 1) * w > max_cells:
        return None

    A = _encode(a)
    B = _encode(b)
    go = np.int64(gap_open)
    ge = np.int64(gap_extend)
    ks = np.arange(klo, khi + 1, dtype=np.int64)
    arange_w = np.arange(w, dtype=np.int32)

    H_prev = np.full(w, NEG, dtype=np.int64)
    F_prev = np.full(w, NEG, dtype=np.int64)

    # Row 0 (i=0, j=k): single gap in A of length j
    j0 = ks
    valid0 = (j0 >= 0) & (j0 <= m)
    H_prev[valid0] = np.where(j0[valid0] == 0, 0, go + ge * j0[valid0])

    tb = np.zeros((n + 1, w), dtype=np.uint8)
    e_src = np.zeros((n + 1, w), dtype=np.int32)  # k-index where an E gap run started
    tb[0, valid0 & (j0 > 0)] = TB_E
    if klo <= 0 <= khi:
        e_src[0, :] = 0 - klo

    for i in range(1, n + 1):
        j = i + ks
        valid = (j >= 0) & (j <= m)

        # M from (i-1, j-1) == H_prev at same k
        jj = np.clip(j, 1, m).astype(np.int64)
        sub = np.where(A[i - 1] == B[jj - 1], np.int64(match), np.int64(mismatch))
        M_row = np.where(valid & (j >= 1) & (H_prev > NEG // 2), H_prev + sub, NEG)

        # F from (i-1, j) == k+1 in previous row
        H_up = np.concatenate([H_prev[1:], [NEG]])
        F_up = np.concatenate([F_prev[1:], [NEG]])
        F_open = np.where(H_up > NEG // 2, H_up + go + ge, NEG)
        F_ext = np.where(F_up > NEG // 2, F_up + ge, NEG)
        F_row = np.maximum(F_open, F_ext)
        F_ext_flag = (F_ext >= F_open) & (F_row > NEG // 2)
        F_row = np.where(valid, F_row, NEG)

        # E via prefix cummax of base over k' < k
        HnoE = np.maximum(M_row, F_row)
        noE_is_F = (F_row > M_row)
        base = np.where(HnoE > NEG // 2, HnoE - ge * j, np.int64(NEG) * 4)
        run = np.empty(w, dtype=np.int64)
        run_idx = np.empty(w, dtype=np.int32)
        run[0] = np.int64(NEG) * 4
        run_idx[0] = 0
        if w > 1:
            shifted = base[:-1]
            cm = np.maximum.accumulate(shifted)
            new_max = shifted >= cm
            idx = np.where(new_max, arange_w[:-1], np.int32(-1))
            idx_ff = np.maximum.accumulate(idx)
            run[1:] = cm
            run_idx[1:] = idx_ff
        E_row = np.where(run > np.int64(NEG) * 2, run + go + ge * j, NEG)
        E_row = np.where(valid & (j >= 1), E_row, NEG)

        H_row = np.maximum(np.maximum(M_row, E_row), F_row)
        # Source priority on ties: M, then F, then E
        src = np.full(w, TB_E, dtype=np.uint8)
        src = np.where(H_row == F_row, TB_F, src).astype(np.uint8)
        src = np.where(H_row == M_row, TB_M, src).astype(np.uint8)
        tb[i] = (src
                 | np.where(F_ext_flag, np.uint8(FLAG_F_EXT), np.uint8(0))
                 | np.where(noE_is_F, np.uint8(FLAG_NOE_F), np.uint8(0)))
        e_src[i] = run_idx
        H_row = np.where(valid, H_row, NEG)

        H_prev = H_row
        F_prev = F_row

    k_end = (m - n) - klo
    score = int(H_prev[k_end])

    # Exact traceback following state runs
    aln_a: list[str] = []
    aln_b: list[str] = []
    i, k = n, k_end
    while True:
        j = i + (k + klo)
        if i == 0 and j == 0:
            break
        if i == 0:
            aln_a.append("-" * j)
            aln_b.append(b[:j][::-1])
            break
        if j == 0:
            aln_a.append(a[:i][::-1])
            aln_b.append("-" * i)
            break
        state = tb[i, k] & 0x3
        if state == TB_M:
            aln_a.append(a[i - 1])
            aln_b.append(b[j - 1])
            i -= 1
        elif state == TB_E:
            k_start = int(e_src[i, k])
            gap_len = k - k_start
            j_start = i + (k_start + klo)
            aln_a.append("-" * gap_len)
            aln_b.append(b[j_start:j][::-1])
            k = k_start
            # next state at (i, k_start) is max(M, F) there
            if tb[i, k] & FLAG_NOE_F:
                tb[i, k] = (tb[i, k] & ~np.uint8(0x3)) | TB_F
            else:
                tb[i, k] = (tb[i, k] & ~np.uint8(0x3)) | TB_M
        else:  # TB_F
            aln_a.append(a[i - 1])
            aln_b.append("-")
            extended = bool(tb[i, k] & FLAG_F_EXT)
            i -= 1
            k += 1
            if extended:
                tb[i, k] = (tb[i, k] & ~np.uint8(0x3)) | TB_F

    return "".join(aln_a)[::-1], "".join(aln_b)[::-1], score
