"""The port's device combine greedy (sniffles_tpu_torch/ops/combine_greedy.py,
plain PyTorch on the CPU here) against the JAX package's
run_combine_greedy_task on the SAME numpy payload dicts: `assign` and
`seg_flags` must be equal on fuzz payloads, exact ties, near-threshold
(ambiguous) probes, ED misses, group-size overflow, limit = 0 and the
width-1 table. The port's packer must also build byte-identical
payloads from the same cohort (the carry-across: the payload dicts are
the interface, no conversion is needed), and its replay must reproduce
the host greedy. The sequential greedy of one flush, run_combine_greedy,
is held to the JAX package's on every case of
tests/test_combine_greedy_kernel.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sniffles_tpu import cluster as jcl  # noqa: E402
from sniffles_tpu import svcall as jsv  # noqa: E402
from sniffles_tpu.config import SnifflesConfig as JConfig  # noqa: E402
from sniffles_tpu.ops import combine_greedy as jcg  # noqa: E402
from sniffles_tpu.parallel import combine_device_greedy as jcdg  # noqa: E402
from sniffles_tpu_torch import cluster as tcl  # noqa: E402
from sniffles_tpu_torch import svcall as tsv  # noqa: E402
from sniffles_tpu_torch.config import SnifflesConfig as TConfig  # noqa: E402
from sniffles_tpu_torch.ops import combine_greedy as tcg  # noqa: E402
from sniffles_tpu_torch.ops._greedy_consts import (NMAX, SEGF_AMBIGUOUS,  # noqa: E402
                                                   SEGF_ED_MISS, SEGF_N_OVERFLOW,
                                                   TASK_ED_HEADS)
from sniffles_tpu_torch.parallel import combine_device_greedy as tcdg  # noqa: E402


def assert_same_result(payload, meta):
    ours = tcg.run_combine_greedy_task(payload, meta, "cpu")
    theirs = jcg.run_combine_greedy_task(payload, meta)
    for key in ("assign", "seg_flags"):
        assert ours[key].dtype == np.int32
        assert ours[key].shape == theirs[key].shape
        assert (ours[key] == np.asarray(theirs[key])).all(), key
    return ours


# ---------------------------------------------------------------------------
# payload-level cases


def fuzz_payload(rng, S, L, n_sites=3, lens=(16, 60, 200), n_alts=6,
                 table=0.8, heads=TASK_ED_HEADS):
    """Grid payload with clustered positions and lengths (so exact and
    near ties are common), per-segment head ordinals assigned as the
    packer assigns them, and a random sparse ED table."""
    counts = rng.integers(1, L + 1, size=S).astype(np.int32)
    c_pos = np.zeros((S, L), np.int32)
    c_len = np.zeros((S, L), np.int32)
    c_alt = np.zeros((S, L), np.int32)
    c_hord = np.full((S, L), -1, np.int32)
    segs, rows, cols, vals = [], [], [], []
    for s in range(S):
        sites = rng.integers(0, 3000, size=n_sites)
        site_len = rng.choice(lens, size=n_sites)
        ords = {}
        for j in range(int(counts[s])):
            k = int(rng.integers(0, n_sites))
            c_pos[s, j] = sites[k] + int(rng.integers(-30, 31))
            c_len[s, j] = max(1, int(site_len[k]) + int(rng.integers(-4, 5)))
            alt = int(rng.integers(0, n_alts))
            c_alt[s, j] = alt
            if alt not in ords and len(ords) < heads:
                ords[alt] = len(ords)
            c_hord[s, j] = ords.get(alt, -1)
        for h in range(len(ords)):
            for j in range(int(counts[s])):
                if rng.random() < table:
                    segs.append(s)
                    rows.append(h)
                    cols.append(j)
                    vals.append(int(rng.integers(0, 2 * int(c_len[s, j]) + 1)))
    as32 = lambda v: np.array(v, dtype=np.int32)  # noqa: E731
    return {"c_pos": c_pos, "c_len": c_len, "c_alt": c_alt, "c_hord": c_hord,
            "counts": counts, "ed_segs": as32(segs), "ed_rows": as32(rows),
            "ed_cols": as32(cols), "ed_vals": as32(vals)}


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_payloads_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    payload = fuzz_payload(rng, S=int(rng.integers(1, 20)),
                           L=int(rng.integers(2, 40)))
    for meta in ({"cm": 250, "cmm": 1000, "limit": 0.7},
                 {"cm": 10, "cmm": 120, "limit": 0.5},
                 {"cm": 250, "cmm": 1000, "limit": 0.0}):
        assert_same_result(payload, meta)


def test_exact_ties_first_group_wins():
    """Two groups at exactly the same rational distance from a probe:
    the earliest group wins, in both packages."""
    # alt 0 and alt 1 fail the identity gate against each other (ED 90
    # of length 100) and so found two groups; alt 2 passes against both
    # heads, and the third candidate sits midway: distance 50 to each.
    # The fifth is nearer the second group's mean and joins it.
    c_pos = np.array([[100, 200, 150, 150, 175]], np.int32)
    c_len = np.array([[100, 100, 100, 100, 100]], np.int32)
    c_alt = np.array([[0, 1, 2, 2, 2]], np.int32)
    c_hord = np.array([[0, 1, -1, -1, -1]], np.int32)
    segs = [0] * 8
    rows = [0, 0, 0, 0, 1, 1, 1, 1]
    cols = [1, 2, 3, 4, 0, 2, 3, 4]
    vals = [90, 5, 5, 5, 90, 5, 5, 5]
    payload = {"c_pos": c_pos, "c_len": c_len, "c_alt": c_alt,
               "c_hord": c_hord, "counts": np.array([5], np.int32),
               "ed_segs": np.array(segs, np.int32),
               "ed_rows": np.array(rows, np.int32),
               "ed_cols": np.array(cols, np.int32),
               "ed_vals": np.array(vals, np.int32)}
    out = assert_same_result(payload, {"cm": 250, "cmm": 1000, "limit": 0.7})
    assert out["assign"][0].tolist() == [0, 1, 0, 0, 1]
    assert out["seg_flags"].tolist() == [0]


def test_near_threshold_flags_ambiguous():
    """Probes exactly on the float32 thresholds (the sqrt radius: cm 10
    at length 16 gives 40.0; the identity ratio: (100 - 30) / 100 = 0.7)
    raise the ambiguity flag for the segment only."""
    payload = {
        "c_pos": np.array([[1000, 1040], [5000, 5010]], np.int32),
        "c_len": np.array([[16, 16], [100, 100]], np.int32),
        "c_alt": np.array([[0, 0], [0, 1]], np.int32),
        "c_hord": np.array([[0, 0], [0, -1]], np.int32),
        "counts": np.array([2, 2], np.int32),
        "ed_segs": np.array([1], np.int32), "ed_rows": np.array([0], np.int32),
        "ed_cols": np.array([1], np.int32), "ed_vals": np.array([30], np.int32)}
    out = assert_same_result(payload, {"cm": 10, "cmm": 1000, "limit": 0.7})
    assert out["seg_flags"].tolist() == [SEGF_AMBIGUOUS, SEGF_AMBIGUOUS]


def test_ed_miss_and_width_one_table():
    """A probe against a head whose pair is not tabulated flags ed_miss;
    with no table at all the ED grid has width 1 and every step reads its
    one column (limit > 0, non-uniform alts)."""
    rng = np.random.default_rng(7)
    payload = fuzz_payload(rng, S=5, L=12, table=0.3)
    out = assert_same_result(payload, {"cm": 250, "cmm": 1000, "limit": 0.7})
    assert (out["seg_flags"] & SEGF_ED_MISS).any()
    empty = dict(payload)
    for key in ("ed_segs", "ed_rows", "ed_cols", "ed_vals"):
        empty[key] = np.zeros(0, np.int32)
    out = assert_same_result(empty, {"cm": 250, "cmm": 1000, "limit": 0.7})
    assert (out["seg_flags"] & SEGF_ED_MISS).any()
    # limit 0 never reads the table
    out = assert_same_result(empty, {"cm": 250, "cmm": 1000, "limit": 0.0})
    assert not (out["seg_flags"] & SEGF_ED_MISS).any()


def test_group_size_overflow():
    n = NMAX + 3
    payload = {"c_pos": (np.arange(n, dtype=np.int32) % 3)[None, :],
               "c_len": np.full((1, n), 250, np.int32),
               "c_alt": np.zeros((1, n), np.int32),
               "c_hord": np.full((1, n), -1, np.int32),
               "counts": np.array([n], np.int32),
               "ed_segs": np.zeros(0, np.int32), "ed_rows": np.zeros(0, np.int32),
               "ed_cols": np.zeros(0, np.int32), "ed_vals": np.zeros(0, np.int32)}
    out = assert_same_result(payload, {"cm": 250, "cmm": 1000, "limit": 0.0})
    assert out["seg_flags"].tolist() == [SEGF_N_OVERFLOW]


# ---------------------------------------------------------------------------
# the sequential greedy of one flush (run_combine_greedy, the
# combine_greedy request kind)


@pytest.mark.parametrize("name", [
    "test_basic_trajectory_matches_host", "test_initial_groups_and_tie_break",
    "test_identity_gate_matches_host", "test_greedy_fuzz_matches_host",
    "test_group_size_overflow_flags", "test_ed_miss_flags_fallback"])
def test_flush_greedy_matches_jax(name, monkeypatch):
    """Every payload of tests/test_combine_greedy_kernel.py's cases (fuzz
    included) through the port's run_combine_greedy and the JAX
    package's: `assign` and `flags` equal, bit for bit."""
    import tests.test_combine_greedy_kernel as jtest
    real, held = jcg.run_combine_greedy, []

    def both(payload, meta):
        theirs = real(payload, meta)
        ours = tcg.run_combine_greedy(payload, meta, "cpu")
        for key in ("assign", "flags"):
            assert ours[key].dtype == np.int32
            assert ours[key].tolist() == np.asarray(theirs[key]).tolist(), key
        held.append(meta)
        return theirs
    monkeypatch.setattr(jtest, "run_combine_greedy", both)
    monkeypatch.setattr(jcg, "run_combine_greedy", both)
    getattr(jtest, name)()
    assert held


def test_sim_flush_payloads_are_the_jax_cases(monkeypatch):
    """sniffles_tpu_torch.sim.greedy_flush_payloads (the cases chip_smoke.py
    sends through the device daemon on the card) gives the payloads and
    metas of tests/test_combine_greedy_kernel.py, array for array."""
    import tests.test_combine_greedy_kernel as jtest
    from sniffles_tpu_torch.sim import greedy_flush_payloads
    real, captured = jcg.run_combine_greedy, []

    def capture(payload, meta):
        captured.append((payload, meta))
        return real(payload, meta)
    monkeypatch.setattr(jtest, "run_combine_greedy", capture)
    monkeypatch.setattr(jcg, "run_combine_greedy", capture)
    for name in ("test_basic_trajectory_matches_host", "test_initial_groups_and_tie_break",
                 "test_identity_gate_matches_host", "test_greedy_fuzz_matches_host",
                 "test_group_size_overflow_flags", "test_ed_miss_flags_fallback"):
        getattr(jtest, name)()
    ours = greedy_flush_payloads()
    assert len(ours) == len(captured) == 47
    for (payload, meta), (want, want_meta) in zip(ours, captured):
        assert meta == want_meta and sorted(payload) == sorted(want)
        for key in want:
            assert np.asarray(payload[key]).tolist() == np.asarray(want[key]).tolist(), key


# ---------------------------------------------------------------------------
# packer + replay on SVCall cohorts (generators after
# tests/test_combine_task_greedy.py)


def make_configs(**kw):
    jconf = JConfig("--input", "x.bam", "--vcf", "y.vcf")
    tconf = TConfig("--input", "x.bam", "--vcf", "y.vcf")
    tconf.device = "cpu"
    for conf in (jconf, tconf):
        for k, v in kw.items():
            setattr(conf, k, v)
    return jconf, tconf


def cand(sv, pos, svlen, svtype="DEL", alt="<DEL>", support=10, sample=0, cid=0):
    return sv.SVCall(contig="chr1", pos=pos, id=f"c{cid}", ref="N", alt=alt,
                     qual=50, filter="PASS", info={}, svtype=svtype,
                     svlen=svlen, end=pos + abs(svlen),
                     genotypes={0: (1, 1, 60, 0, 20, (None, None))},
                     precise=True, support=support, rnames=None, qc=True,
                     nm=-1, postprocess=None, fwd=5, rev=5,
                     coverage_upstream=20, coverage_start=20,
                     coverage_center=20, coverage_end=20,
                     coverage_downstream=20, sample_internal_id=sample)


def random_spec(rng, svtype="DEL", n_sites=6, site_span=400_000,
                per_site=(4, 30), alt_pool=None):
    """Candidate tuples and flush sizes, as random_flushes of the JAX
    package's task-greedy test draws them."""
    sites = sorted(int(rng.integers(0, site_span)) for _ in range(n_sites))
    spec = []
    cid = 0
    for sp in sites:
        sl = int(rng.integers(50, 900))
        for _ in range(int(rng.integers(*per_site))):
            alt = ("<DEL>" if svtype != "INS"
                   else (alt_pool[int(rng.integers(0, len(alt_pool)))]
                         if alt_pool else "A" * sl))
            spec.append(dict(pos=sp + int(rng.integers(-40, 41)),
                             svlen=max(20, sl + int(rng.integers(-10, 11)))
                             * (-1 if svtype == "DEL" else 1),
                             svtype=svtype, alt=alt,
                             support=int(rng.integers(3, 40)),
                             sample=int(rng.integers(0, 64)), cid=cid))
            cid += 1
    order = rng.permutation(len(spec))
    spec = [spec[i] for i in order]
    spec.sort(key=lambda c: c["pos"])
    sizes = []
    k = 0
    while k < len(spec):
        step = int(rng.integers(5, 25))
        sizes.append(min(step, len(spec) - k))
        k += step
    return spec, sizes


def flushes_of(sv, spec, sizes):
    cands = [cand(sv, **c) for c in spec]
    flushes = []
    k = 0
    for size in sizes:
        batch = cands[k:k + size]
        flushes.append((batch, batch[-1].pos // 100 * 100, 100 * len(batch)))
        k += size
    return flushes


def groups_shape(groups):
    return [(sorted(c.id for c in g.candidates),
             round(g.pos_mean, 9), round(abs(g.len_mean), 9))
            for g in groups]


def capture(monkeypatch, module, calls):
    real = module.run_combine_greedy_task

    def spy(payload, meta, *args):
        calls.append((payload, meta))
        return real(payload, meta, *args)
    monkeypatch.setattr(module, "run_combine_greedy_task", spy)


def run_both(monkeypatch, svtype, spec, sizes, **kw):
    jconf, tconf = make_configs(**kw)
    jcalls, tcalls = [], []
    capture(monkeypatch, jcg, jcalls)
    capture(monkeypatch, tcg, tcalls)
    results = []
    for sv, cdg, conf in ((jsv, jcdg, jconf), (tsv, tcdg, tconf)):
        flushes = flushes_of(sv, spec, sizes)
        counters = {}
        if cdg is jcdg:
            ctx = cdg.pack_task_assignments(svtype, flushes, conf,
                                            counters=counters, device=None)
        else:
            ctx = cdg.pack_task_assignments(svtype, flushes, conf,
                                            counters=counters)
        assert ctx is not None
        keep = []
        ed_cache = {} if (svtype == "INS" and conf.combine_pctseq) else None
        for _ in flushes:
            keep = cdg.replay_flush_task(ctx, keep, conf, ed_cache)
        results.append((keep, counters))
    (jpayload, jmeta), = jcalls
    (tpayload, tmeta), = tcalls
    assert jmeta == tmeta
    assert sorted(jpayload) == sorted(tpayload)
    for key in jpayload:
        a, b = np.asarray(jpayload[key]), np.asarray(tpayload[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key
    # the port's greedy on the JAX packer's own payload
    assert_same_result(jpayload, jmeta)

    host = []
    for batch, _, _ in flushes_of(tsv, spec, sizes):
        ed_cache = {} if (svtype == "INS" and tconf.combine_pctseq) else None
        host = tcl.resolve_block_groups(
            svtype, sorted(batch, key=lambda c: c.support, reverse=True),
            host, tconf, ed_cache)
    (jkeep, jcounters), (tkeep, tcounters) = results
    assert groups_shape(tkeep) == groups_shape(jkeep) == groups_shape(host)
    return tcounters


@pytest.mark.parametrize("seed", range(4))
def test_packer_and_replay_match_jax_del(monkeypatch, seed):
    rng = np.random.default_rng(3000 + seed)
    spec, sizes = random_spec(rng)
    counters = run_both(monkeypatch, "DEL", spec, sizes)
    assert counters.get("combine_greedy_dispatches") == 1


@pytest.mark.parametrize("seed", range(3))
def test_packer_and_replay_match_jax_ins_identity_gate(monkeypatch, seed):
    rng0 = np.random.default_rng(99)
    shared = "".join(rng0.choice(list("ACGT"), size=300))
    near = shared[:290] + "ACGTACGTAC"
    far = "".join(rng0.choice(list("ACGT"), size=300))
    rng = np.random.default_rng(4000 + seed)
    spec, sizes = random_spec(rng, svtype="INS", per_site=(4, 16),
                              alt_pool=[shared, near, far])
    run_both(monkeypatch, "INS", spec, sizes)


def test_many_distinct_alts_flag_segment_to_host(monkeypatch):
    rng = np.random.default_rng(5)
    alts = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(12)]
    spec = [dict(pos=1000 + i, svlen=200, svtype="INS", alt=alts[i % 12],
                 support=40 - i, cid=i) for i in range(24)]
    counters = run_both(monkeypatch, "INS", spec, [24])
    assert counters.get("combine_greedy_flagged_segments", 0) >= 1


def test_small_cmm_configs(monkeypatch):
    for cm, cmm in ((100, 400), (50, 120)):
        rng = np.random.default_rng(cm + cmm)
        spec, sizes = random_spec(rng, n_sites=5)
        run_both(monkeypatch, "DEL", spec, sizes,
                 combine_match=cm, combine_match_max=cmm)


def test_host_greedy_copy_matches_jax():
    """The port's copy of the host greedy (cluster.resolve_block_groups)
    groups like the JAX package's."""
    rng = np.random.default_rng(21)
    spec, sizes = random_spec(rng, n_sites=8)
    jconf, tconf = make_configs()
    out = []
    for sv, cl, conf in ((jsv, jcl, jconf), (tsv, tcl, tconf)):
        keep = []
        for batch, _, _ in flushes_of(sv, spec, sizes):
            keep = cl.resolve_block_groups("DEL", batch, keep, conf, None)
        out.append(groups_shape(keep))
    assert out[0] == out[1]
