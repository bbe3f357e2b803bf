"""The arithmetic that csrc/call_stats.cu's warp and block tiers take as
exact integer reductions in place of the plain version's float32 chains,
held on the CPU with numpy float32 sums term by term (inputs from a seed):

  * integer terms whose sum of |x| is at most 2^24 add, term by term in
    float32 from 0, to their exact integer sum in any order (every partial
    sum is an integer of at most 2^24, which float32 holds); so do the
    squares of terms whose sum of x^2 is at most 2^24, each square exact;
  * crafted terms just past 2^24 whose sequential float32 sum differs from
    the integer sum: the case the kernels route to their chains;
  * the kernels' test itself (abs_term, sq_term and the lanes' clamped
    sums, modelled here with the kernel's constants read from its source):
    it passes exactly where the sums are within 2^24, with no 32-bit
    wrap, for a warp's pair (two terms a lane), a warp's list (up to 1,024
    terms) and the int32 extremes."""
import os

import numpy as np
import pytest

F32 = np.float32
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "sniffles_tpu_torch", "csrc", "call_stats.cu")


def constant(name: str) -> int:
    text = open(SRC).read()
    expr = text.split(f"constexpr unsigned {name} = ")[1].split(";")[0]
    return int(eval(expr.replace("u <<", " <<")))  # "1u << 24" -> 1 << 24


LIMIT = constant("kExact")
CLAMP = constant("kClamp")


def chain(terms, square=False) -> F32:
    """The plain version's float32 chain: term by term from 0 (each term
    converted to float32, squared in float32 for s2)."""
    acc = F32(0)
    for t in terms:
        x = F32(t)
        acc = F32(acc + (F32(x * x) if square else x))
    return acc


def edge_terms(rng, k: int, total: int, signs: bool) -> np.ndarray:
    """k integer terms whose |x| sum to `total`, some negative with `signs`."""
    cuts = np.sort(rng.choice(np.arange(1, total), size=k - 1, replace=False))
    parts = np.diff(np.r_[0, cuts, total])
    if signs:
        parts = parts * rng.choice([-1, 1], size=k)
    return parts.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integer_terms_within_the_limit_add_exactly_in_any_order(seed):
    rng = np.random.default_rng(seed)
    for k, signs in ((20, False), (500, True), (2500, False), (64, True)):
        terms = edge_terms(rng, k, LIMIT, signs)
        assert np.abs(terms).sum() == LIMIT
        want = int(terms.sum())
        for order in (np.arange(k), np.arange(k)[::-1], np.argsort(terms),
                      rng.permutation(k), rng.permutation(k)):
            got = chain(terms[order])
            assert int(got) == want and F32(want) == got


@pytest.mark.parametrize("seed", [0, 1])
def test_squares_within_the_limit_add_exactly_in_any_order(seed):
    rng = np.random.default_rng(10 + seed)
    for k in (20, 100, 500):
        # squares that sum to 2^24 exactly: terms of 2^a, and small ones
        a = int(rng.integers(7, 11))
        m = min(LIMIT >> (2 * a), k)
        terms = np.r_[np.full(m, 1 << a), np.zeros(k - m, np.int64)]
        rest = LIMIT - int((terms * terms).sum())
        small = []
        while rest and len(small) < k - m:     # fill what is left with 1s and 2s
            v = 2 if rest >= 4 else 1
            small.append(v)
            rest -= v * v
        terms[m:m + len(small)] = small
        terms *= rng.choice([-1, 1], size=k)
        sq = int((terms * terms).sum())
        assert sq <= LIMIT
        for order in (np.arange(k), rng.permutation(k), np.argsort(terms)):
            assert int(chain(terms[order], square=True)) == sq


def test_terms_past_the_limit_round_in_the_chain():
    """Just past 2^24 the chain loses the odd unit: the sum of |x| (or of
    x^2) over the limit is where the kernels run the chain itself."""
    cases = [np.array([LIMIT, 1, 1]),                    # 2^24 + 1 rounds to 2^24, twice
             np.array([LIMIT + 1, 1, -LIMIT, 3]),        # the conversion itself rounds
             np.array([1] * 3 + [LIMIT - 2, 1])]         # reaches 2^24 + 1 at its end
    for terms in cases:
        assert np.abs(terms).sum() > LIMIT
        assert int(chain(terms)) != int(terms.sum())
    sq = np.array([4096, 1, 1])                          # squares 2^24, 1, 1
    assert int((sq * sq).sum()) == LIMIT + 2
    assert int(chain(sq, square=True)) != LIMIT + 2


def abs_term(d: int) -> int:
    """csrc/call_stats.cu abs_term: |d| as unsigned 32-bit, clamped."""
    a = (-d) & 0xFFFFFFFF if d < 0 else d
    return min(a, CLAMP)


def sq_term(a: int) -> int:
    return a * a if a <= 4096 else CLAMP


def pair_test(d: np.ndarray) -> tuple:
    """The pair path's test (pair_window): a lane's two terms, its clamped
    sums, the warp's 32-bit reductions; (s1 exact, s2 exact)."""
    d = np.r_[d, np.zeros(64 - d.size, np.int64)]
    A = Q = 0
    for lane in range(32):
        a0, a1 = abs_term(int(d[lane])), abs_term(int(d[lane + 32]))
        A += min(a0 + a1, CLAMP)
        Q += min(sq_term(a0) + sq_term(a1), CLAMP)
    assert A < 1 << 32 and Q < 1 << 32          # the reductions cannot wrap
    return A <= LIMIT, Q <= LIMIT


def list_test(d: np.ndarray) -> tuple:
    """The warp list's test (list_window): lane l takes terms l, l + 32, ...,
    its running sums clamped after each term."""
    A = Q = 0
    for lane in range(32):
        a = q = 0
        for x in d[lane::32]:
            ad = abs_term(int(x))
            a = min(a + ad, CLAMP)
            q = min(q + sq_term(ad), CLAMP)
            assert a + ad < 1 << 32 and q + CLAMP < 1 << 32
        A += a
        Q += q
    assert A < 1 << 32 and Q < 1 << 32
    return A <= LIMIT, Q <= LIMIT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_kernels_test_passes_exactly_within_the_limit(seed):
    rng = np.random.default_rng(20 + seed)
    cases = []
    for k in (5, 20, 47, 64):
        cases += [edge_terms(rng, k, LIMIT, True), edge_terms(rng, k, LIMIT + 1, True),
                  rng.integers(-4096, 4097, k), rng.integers(-2 ** 31, 2 ** 31, k),
                  np.r_[np.full(k - 1, 0), -2 ** 31], np.r_[np.full(k - 1, 1), 4096]]
    big = [edge_terms(rng, k, LIMIT, False) for k in (100, 1024)]
    big += [edge_terms(rng, 1024, LIMIT + 1, True), rng.integers(-2 ** 31, 2 ** 31, 1024),
            np.full(1024, 2 ** 31 - 1), np.full(1024, -2 ** 31), rng.integers(-128, 129, 1024)]
    for d in cases + big:
        want = (sum(abs(int(x)) for x in d) <= LIMIT, sum(int(x) ** 2 for x in d) <= LIMIT)
        if d.size <= 64:
            assert pair_test(d) == want, d
        assert list_test(d) == want, d[:8]
