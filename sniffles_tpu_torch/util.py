"""
Robust statistics and small helpers used throughout the calling pipeline.

Semantics mirror the reference implementation (reference: util.py:25-170)
because the breakpoint estimators are load-bearing for VCF-equivalent
output. Copied from sniffles_tpu/util.py. Device-side (torch) batched
equivalents live in ops/stats.py.
"""
from __future__ import annotations

import math
import sys
from collections import Counter


class SnifflesTPUExit(Exception):
    code: int = 1


def stdev(nums) -> float:
    """Sample standard deviation; 0 for <2 elements (reference: util.py:25-27).

    Two-pass math.fsum formulation: matches statistics.stdev/numpy
    std(ddof=1) to ~1 ulp while avoiding the exact-rational arithmetic of
    statistics (ms-scale per call) and numpy's per-call dispatch overhead
    (~90us) — this runs per cluster in the calling hot path.
    """
    a = nums if isinstance(nums, list) else list(nums)
    n = len(a)
    if n < 2:
        return 0
    mean = math.fsum(a) / n
    ss = math.fsum((x - mean) * (x - mean) for x in a)
    return math.sqrt(ss / (n - 1))


def median(nums) -> int:
    """int(statistics.median(...)) (reference: util.py:30-31)."""
    a = sorted(nums)
    n = len(a)
    mid = n // 2
    if n % 2 == 1:
        return int(a[mid])
    # statistics.median averages the two middle values
    return int((a[mid - 1] + a[mid]) / 2)


def median_noavg(nums):
    """Upper median without averaging (reference: util.py:43-46)."""
    a = sorted(nums)
    return a[int(len(a) / 2)]


def median_modes(nums):
    """
    Mode-filtered, no-averaging median: restrict to distinct values whose
    count is within 2 of the max count, then take their upper median
    (reference: util.py:49-58; median_noavg sorts, so the result is
    order-independent — this enables the batched device formulation in
    ops/stats.py).
    """
    counts = Counter(nums)
    max_count = max(counts.values(), default=0)
    return median_noavg(k for k, c in counts.items() if max_count - c < 3)


def mean(nums) -> float:
    values = list(nums)
    return sum(values) / len(values)


def mean_or_none(nums):
    values = list(nums)
    return sum(values) / len(values) if values else None


def mean_or_none_round(nums):
    m = mean_or_none(nums)
    return None if m is None else round(m)


def trim(nums, pct=25):
    """Two-sided trim of pct% of sorted values (reference: util.py:82-88)."""
    a = sorted(nums)
    trim_n = int(len(a) / 100.0 * pct)
    if trim_n > 0:
        return a[trim_n:-trim_n]
    return a


def most_common(nums):
    """[(count, value)] sorted descending (reference: util.py:91-98).

    Counter's C counting loop; the full sort afterward makes the result
    independent of counting order, so this is exactly the reference dict
    formulation, faster.
    """
    return sorted(((c, n) for n, c in Counter(nums).items()), reverse=True)


def most_common_top(nums):
    """Smallest value among ties for the top count (reference: util.py:101-103)."""
    result = most_common(nums)
    return sorted(item for count, item in result if count == result[0][0])[0]


def error(msg: str) -> None:
    sys.stderr.write("sniffles-tpu Error: " + msg + "\n")
    sys.stderr.flush()


def fatal_error(msg: str) -> None:
    error(msg + " (Fatal error, exiting.)")
    sys.exit(1)


def fatal_error_main(msg: str) -> None:
    error(msg + " (Fatal error, exiting.)")
    raise SnifflesTPUExit


def load_tandem_repeats(filename: str, padding: int) -> dict[str, list[tuple[int, int]]]:
    """Load a tandem-repeat BED as padded per-contig interval lists,
    sorting in memory only when the file itself was unsorted
    (reference: util.py:121-147)."""
    by_contig: dict[str, list[tuple[int, int]]] = {}
    needs_sort = False
    with open(filename, "r") as handle:
        for line in handle:
            cols = line.split("\t")
            if len(cols) < 3:
                continue
            contig = cols[0]
            lo, hi = int(cols[1]), int(cols[2])
            intervals = by_contig.setdefault(contig, [])
            needs_sort = needs_sort or bool(intervals and lo < intervals[-1][0])
            intervals.append((max(0, lo - padding), hi + padding))
    if needs_sort:
        for intervals in by_contig.values():
            intervals.sort()
    return by_contig


def should_process_contig(contig: str, length: int, config) -> bool:
    """Contig gating (reference: util.py:150-164)."""
    if config.contig and contig not in config.contig:
        return False
    if config.regions_by_contig and contig not in config.regions_by_contig:
        return False
    if not config.all_contigs and length < 1_000_000:
        return bool((config.contig and contig in config.contig) or (contig in config.regions_by_contig))
    return True


center = median_modes

ambiguous_iupac_symbols = 'RYSWKMBDHV'
ambiguity_cleanup_table = str.maketrans(ambiguous_iupac_symbols, 'N' * len(ambiguous_iupac_symbols))
