"""The arithmetic that csrc/combine_greedy.cu's step takes from a slot's
cached state in place of recomputing it every step, held on the CPU to
what the plain version computes (numpy inputs from a seed, bit for bit):

  * the match radius from the cached root of the group's length mean: a
    correctly rounded float32 square root is monotone, so
    sqrt(max(min(a, b), 0)) == min(sqrt(max(a, 0)), sqrt(max(b, 0))), and
    so is cm times either, over a sweep of 0, subnormals, powers of two and
    their neighbours, values whose radius lies next to forced_at, integers
    and ratios of integers (the means), below 0 and random;
  * the exact division by a group's size from its cached magic number
    (ops/combine_greedy.div_magic, the kernel's model) against floor
    division, for every n of 1 to SEG_LMAX on edge and sampled dividends
    (0, n - 1, multiples of n and their neighbours, 2^31 - 1), and the key
    floor(D / n) 2^20 + floor((D mod n) 2^20 / n) it builds."""
import numpy as np
import pytest
import torch

from sniffles_tpu_torch.ops import combine_greedy as tcg
from sniffles_tpu_torch.ops._greedy_consts import EPS, SCALE, SEG_LMAX
from sniffles_tpu_torch.ops.segments import sqrt_f32

F32 = np.float32


def sweep_values(seed: int) -> np.ndarray:
    """float32 values for the radius: 0, subnormals, powers of two and
    their float32 neighbours, the length means near each cm's forced_at
    radius, small integers, ratios of integers, negatives and random
    magnitudes."""
    rng = np.random.default_rng(seed)
    pows = F32(2.0) ** np.arange(-149, 128, dtype=np.float64)
    pows = pows.astype(F32)
    out = [np.zeros(1, F32), np.array([1e-45, 1e-40, 1.1754942e-38, 1.1754944e-38], F32),
           pows, np.nextafter(pows, F32(0)), np.nextafter(pows, F32(np.inf))]
    for cm, cmm in ((10, 120), (250, 1000)):
        forced_at = F32(cmm) * F32(1.0 + 2.0 * EPS)
        near = F32((float(forced_at) / cm) ** 2)
        steps = np.arange(-64, 65)
        out.append(np.array([near], F32).view(np.int32) + steps.astype(np.int32))
        out[-1] = out[-1].view(F32)
    out.append(np.arange(-8, 5000, dtype=F32))
    lsum = rng.integers(-100, 2 ** 21, size=3000)
    n = rng.integers(1, SEG_LMAX + 1, size=3000)
    out.append((lsum.astype(F32) / n.astype(F32)).astype(F32))
    out.append((10.0 ** rng.uniform(-40, 38, size=3000)).astype(F32))
    out.append(-(10.0 ** rng.uniform(-40, 38, size=200)).astype(F32))
    vals = np.concatenate(out).astype(F32)
    return vals[np.isfinite(vals)]


def radius_direct(cm, a, b):
    """The plain version's radius: cm * sqrt(max(min(lmf, len), 0))."""
    return F32(cm) * np.sqrt(np.maximum(np.minimum(a, b), F32(0)))


def radius_cached(cm, a, b):
    """The kernel's: cm * min(root of the cached mean, root of the length)."""
    return F32(cm) * np.minimum(np.sqrt(np.maximum(a, F32(0))), np.sqrt(np.maximum(b, F32(0))))


@pytest.mark.parametrize("seed", [0, 1])
def test_min_of_roots_gives_the_plain_radius(seed):
    vals = sweep_values(seed)
    rng = np.random.default_rng(100 + seed)
    a = np.repeat(vals, 64)
    b = vals[rng.integers(0, vals.size, size=a.size)]
    # and every pair of a sample that holds every kind of value
    sample = vals[rng.choice(vals.size, size=1500, replace=False)]
    a = np.concatenate([a, np.repeat(sample, sample.size)])
    b = np.concatenate([b, np.tile(sample, sample.size)])
    roots = np.sqrt(np.maximum(np.minimum(a, b), F32(0)))
    cached = np.minimum(np.sqrt(np.maximum(a, F32(0))), np.sqrt(np.maximum(b, F32(0))))
    assert np.array_equal(roots.view(np.int32), cached.view(np.int32))
    for cm, cmm in ((10, 120), (250, 1000)):
        direct, kernel = radius_direct(cm, a, b), radius_cached(cm, a, b)
        assert np.array_equal(direct.view(np.int32), kernel.view(np.int32)), cm
        forced_at = F32(cmm) * F32(1.0 + 2.0 * EPS)
        assert np.array_equal(direct >= forced_at, kernel >= forced_at)
    # the plain version's root (ops/segments.sqrt_f32) is numpy's, correctly rounded
    x = np.maximum(vals, F32(0))
    assert np.array_equal(sqrt_f32(torch.from_numpy(x)).numpy().view(np.int32),
                          np.sqrt(x).view(np.int32))


def dividends(n: int, rng) -> np.ndarray:
    top = 2 ** 31 - 1
    last = top // n * n
    k = rng.integers(0, top // n + 1, size=64, dtype=np.int64)
    edge = [0, n - 1, n, n + 1, 2 * n - 1, 2 * n, last - 1, last, top, top - 1]
    out = np.concatenate([np.array(edge, np.int64), k * n, k * n - 1, k * n + n - 1,
                          rng.integers(0, top, size=64, dtype=np.int64, endpoint=True)])
    return out[(out >= 0) & (out <= top)].astype(np.uint64)


def test_magic_division_is_floor_division_for_every_group_size():
    rng = np.random.default_rng(7)
    for n in range(1, SEG_LMAX + 1):
        m, s = tcg.div_magic(n)
        assert 0 < m < 2 ** 32 and 2 ** s >= n and (s == 0 or 2 ** (s - 1) < n), n
        x = dividends(n, rng)
        assert np.array_equal(tcg.magic_div(x, np.uint64(m), s), x // np.uint64(n)), n
        # the key's second division: the remainder times 2^20
        r = np.unique(np.r_[0, n - 1, rng.integers(0, n, size=32)]).astype(np.uint64)
        assert np.array_equal(tcg.magic_div(r * np.uint64(SCALE), np.uint64(m), s),
                              r * np.uint64(SCALE) // np.uint64(n)), n


@pytest.mark.parametrize("n", [SEG_LMAX + 1, 4095, 4096, 65_537, 2 ** 30, 2 ** 30 + 1,
                               2 ** 31 - 1])
def test_magic_division_past_the_table(n):
    """Past SEG_LMAX (a flush's initial groups may be larger) the kernel
    computes the same (m, s); it divides exactly there too."""
    rng = np.random.default_rng(n)
    m, s = tcg.div_magic(n)
    assert m < 2 ** 32
    x = dividends(n, rng)
    assert np.array_equal(tcg.magic_div(x, np.uint64(m), s), x // np.uint64(n))


def test_the_key_from_two_magic_divisions():
    """key = floor(D / n) 2^20 + floor((D mod n) 2^20 / n), each division by
    the magic number, == floor(D 2^20 / n), the plain version's order of
    the rational distance D / n, for every eligible D (below 2^30)."""
    rng = np.random.default_rng(11)
    n = rng.integers(1, SEG_LMAX + 1, size=20_000)
    D = rng.integers(0, 2 ** 30, size=n.size)
    D[:2048] = np.arange(2048) % n[:2048]
    for d, k in zip(D.tolist(), n.tolist()):
        m, s = tcg.div_magic(k)
        q = tcg.magic_div(d, m, s)
        key = q * SCALE + tcg.magic_div((d - q * k) * SCALE, m, s)
        assert key == d * SCALE // k, (d, k)


def test_div_magic_refuses_a_size_out_of_range():
    for n in (0, -1, 2 ** 31):
        with pytest.raises(ValueError):
            tcg.div_magic(n)
