"""
Statistics and small helpers of the combine mode.

Semantics mirror the reference implementation (reference: util.py:25-170)
because the estimators are load-bearing for VCF-equivalent output. Copied
from sniffles_tpu/util.py: the parts combine uses.
"""
from __future__ import annotations

import math
import sys


class SnifflesTPUExit(Exception):
    code: int = 1


def stdev(nums) -> float:
    """Sample standard deviation; 0 for <2 elements (reference: util.py:25-27).

    Two-pass math.fsum formulation: matches statistics.stdev/numpy
    std(ddof=1) to ~1 ulp without the exact-rational arithmetic of
    statistics or numpy's per-call dispatch.
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


def mean(nums) -> float:
    values = list(nums)
    return sum(values) / len(values)


def mean_or_none(nums):
    values = list(nums)
    return sum(values) / len(values) if values else None


def mean_or_none_round(nums):
    m = mean_or_none(nums)
    return None if m is None else round(m)


def error(msg: str) -> None:
    sys.stderr.write("sniffles-tpu Error: " + msg + "\n")
    sys.stderr.flush()


def fatal_error(msg: str) -> None:
    error(msg + " (Fatal error, exiting.)")
    sys.exit(1)


def fatal_error_main(msg: str) -> None:
    error(msg + " (Fatal error, exiting.)")
    raise SnifflesTPUExit


ambiguous_iupac_symbols = 'RYSWKMBDHV'
ambiguity_cleanup_table = str.maketrans(ambiguous_iupac_symbols, 'N' * len(ambiguous_iupac_symbols))
