"""The port's device combine greedy (sniffles_tpu_torch/ops/combine_greedy.py:
the wrappers run the plain versions on the CPU here) against the JAX
package's run_combine_greedy_task on the SAME numpy payload dicts, those
of sniffles_tpu_torch.sim.greedy_task_payloads (shared with the card's
tests and chip_smoke.py): `assign` and `seg_flags` must be equal on fuzz
payloads, exact ties, near-threshold (ambiguous) probes, ED misses,
group-size overflow, limit = 0, the width-1 table, one segment of
SEG_LMAX candidates and 16,384 segments of one. The sim's fuzz
payloads are held to this file's old fuzz_payload; the wrappers take the
plain versions on CPU tensors and raise on any device without a kernel;
what they hand the kernel (int32 inputs, the gates' float32 bits) is the
plain version's. The port's packer must also build byte-identical
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
from sniffles_tpu_torch.ops._greedy_consts import (NMAX, SEG_LMAX,  # noqa: E402
                                                   SEGF_AMBIGUOUS, SEGF_ED_MISS,
                                                   SEGF_N_OVERFLOW, TASK_ED_HEADS)
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
# payload-level cases (sniffles_tpu_torch.sim.greedy_task_payloads, which the
# card's tests and chip_smoke.py share)


def fuzz_payload(rng, S, L, n_sites=3, lens=(16, 60, 200), n_alts=6,
                 table=0.8, heads=TASK_ED_HEADS):
    """The fuzz payload this file built before it moved to
    sim.greedy_fuzz_payload, kept as the reference that one is held to: grid
    payload with clustered positions and lengths (so exact and near ties
    are common), per-segment head ordinals assigned as the packer assigns
    them, and a random sparse ED table."""
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


def task_cases(label):
    """[(payload, meta)] of sim.greedy_task_payloads() under `label`."""
    from sniffles_tpu_torch.sim import greedy_task_payloads
    cases = [(p, m) for name, p, m in greedy_task_payloads() if name == label]
    assert cases, label
    return cases


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_payloads_match_jax(seed):
    cases = task_cases(f"fuzz seed {seed}")
    assert [m for _, m in cases] == [{"cm": 250, "cmm": 1000, "limit": 0.7},
                                     {"cm": 10, "cmm": 120, "limit": 0.5},
                                     {"cm": 250, "cmm": 1000, "limit": 0.0}]
    for payload, meta in cases:
        assert_same_result(payload, meta)


@pytest.mark.parametrize("seed", range(6))
def test_sim_fuzz_payloads_are_the_old_ones(seed):
    """sim.greedy_task_payloads' fuzz seeds are this file's old
    fuzz_payload draws, array for array."""
    rng = np.random.default_rng(100 + seed)
    want = fuzz_payload(rng, S=int(rng.integers(1, 20)), L=int(rng.integers(2, 40)))
    for payload, _ in task_cases(f"fuzz seed {seed}"):
        assert sorted(payload) == sorted(want)
        for key in want:
            assert payload[key].dtype == want[key].dtype, key
            assert payload[key].tolist() == want[key].tolist(), key


def test_exact_ties_first_group_wins():
    """Two groups at exactly the same rational distance from a probe:
    the earliest group wins, in both packages."""
    (payload, meta), = task_cases("exact ties")
    out = assert_same_result(payload, meta)
    assert out["assign"][0].tolist() == [0, 1, 0, 0, 1]
    assert out["seg_flags"].tolist() == [0]


def test_near_threshold_flags_ambiguous():
    """Probes exactly on the float32 thresholds (the sqrt radius: cm 10
    at length 16 gives 40.0; the identity ratio: (100 - 30) / 100 = 0.7)
    raise the ambiguity flag for the segment only."""
    (payload, meta), = task_cases("near threshold")
    out = assert_same_result(payload, meta)
    assert out["seg_flags"].tolist() == [SEGF_AMBIGUOUS, SEGF_AMBIGUOUS]


def test_ed_miss_and_width_one_table():
    """A probe against a head whose pair is not tabulated flags ed_miss;
    with no table at all the ED grid has width 1 and every step reads its
    one column (limit > 0, non-uniform alts)."""
    (payload, meta), = task_cases("ed miss")
    out = assert_same_result(payload, meta)
    assert (out["seg_flags"] & SEGF_ED_MISS).any()
    (empty, meta7), (empty0, meta0) = task_cases("width-1 table")
    assert meta7["limit"] == 0.7 and meta0["limit"] == 0.0
    assert not any(len(empty[k]) for k in ("ed_segs", "ed_rows", "ed_cols", "ed_vals"))
    out = assert_same_result(empty, meta7)
    assert (out["seg_flags"] & SEGF_ED_MISS).any()
    # limit 0 never reads the table
    out = assert_same_result(empty0, meta0)
    assert not (out["seg_flags"] & SEGF_ED_MISS).any()


def test_group_size_overflow():
    (payload, meta), = task_cases("group overflow")
    assert int(payload["counts"][0]) == NMAX + 3
    out = assert_same_result(payload, meta)
    assert out["seg_flags"].tolist() == [SEGF_N_OVERFLOW]


@pytest.mark.parametrize("label", ["one long segment", "many segments"])
def test_long_segment_and_many_segments_match_jax(label):
    """One segment of SEG_LMAX candidates and 16,384 segments of one, at
    limits 0.7 and 0: the port == the JAX package."""
    cases = task_cases(label)
    assert [m["limit"] for _, m in cases] == [0.7, 0.0]
    for payload, meta in cases:
        out = assert_same_result(payload, meta)
        if label == "one long segment":
            assert out["assign"].shape == (1, SEG_LMAX) and out["assign"].max() > 32
        else:
            assert out["assign"].shape == (16_384, 1) and (out["assign"] == 0).all()


def test_group_counts_cross_the_probe_trips():
    """Rows whose live groups cross 32, 64 and 128 (a probe trip a warp's
    32 slots), at limits 0.5 and 0: the port == the JAX package."""
    cases = task_cases("group counts")
    assert [m["limit"] for _, m in cases] == [0.5, 0.0]
    for payload, meta in cases:
        out = assert_same_result(payload, meta)
        groups = [int(out["assign"][s, :c].max()) + 1 for s, c in enumerate(payload["counts"])]
        assert groups[0] > 32 and groups[1] > 64 and groups[2] > 128, groups


def test_long_group_passes_nmax():
    """One group joined until its size passes NMAX, the identity gate on:
    the overflow flag, in both packages."""
    (payload, meta), = task_cases("long group")
    assert meta["limit"] == 0.7
    out = assert_same_result(payload, meta)
    assert (out["assign"][0] == 0).sum() > NMAX
    assert out["seg_flags"].tolist() == [SEGF_N_OVERFLOW]


def test_tiny_ratios():
    """Group length means of 0, below 0 and under 1 (the identity ratio's
    denominator at tiny), at limits 0.7 and 0: the port == the JAX
    package."""
    cases = task_cases("tiny ratios")
    assert [m["limit"] for _, m in cases] == [0.7, 0.0]
    for payload, meta in cases:
        assert (payload["c_len"] <= 0).any()
        assert_same_result(payload, meta)


def test_every_task_payload_is_held():
    """Every label of sim.greedy_task_payloads is held by a test above."""
    from sniffles_tpu_torch.sim import greedy_task_payloads
    held = {f"fuzz seed {k}" for k in range(6)} | {
        "exact ties", "near threshold", "ed miss", "width-1 table", "group overflow",
        "one long segment", "many segments", "group counts", "long group", "tiny ratios"}
    assert {name for name, _, _ in greedy_task_payloads()} == held


def test_wrappers_run_the_plain_version_on_the_cpu_and_raise_on_meta():
    """_greedy_grid_loop and _greedy_loop take the plain versions on CPU
    tensors (no kernel launch counted) and raise on a device that has no
    kernel."""
    import torch
    (payload, meta), = task_cases("exact ties")
    sim_meta = dict(cm=meta["cm"], cmm=meta["cmm"], limit=meta["limit"])
    c = {k: torch.as_tensor(np.pad(payload[k], ((0, 0), (0, 59)))) for k in
         ("c_pos", "c_len", "c_alt", "c_hord")}
    counts = torch.as_tensor(payload["counts"])
    ed = torch.full((1, TASK_ED_HEADS, 64), -1, dtype=torch.int32)
    ed[0, payload["ed_rows"], payload["ed_cols"]] = torch.as_tensor(payload["ed_vals"])
    tcg.reset_counts()
    got = tcg._greedy_grid_loop(*c.values(), counts, ed, **sim_meta)
    want = tcg.greedy_grid_plain(*c.values(), counts, ed, **sim_meta)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0][0, :5].tolist() == [0, 1, 0, 0, 1]
    flush = tcg.run_combine_greedy(*greedy_flush_case(), "cpu")
    assert tcg.COUNTS == {"launches": 0, "segments": 0, "steps": 0}
    assert flush["assign"].tolist() == [0, 0, 1, 0, 1, 0]
    meta_dev = {k: v.to("meta") for k, v in c.items()}
    with pytest.raises(ValueError, match="no combine greedy kernel"):
        tcg._greedy_grid_loop(*meta_dev.values(), counts.to("meta"), ed.to("meta"),
                              **sim_meta)
    z = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no combine greedy kernel"):
        tcg._greedy_loop(z, z, z, 1, z, z, z, z, torch.zeros((16, 64), dtype=torch.int32,
                                                            device="meta"), 0, **sim_meta)
    assert tcg.COUNTS == {"launches": 0, "segments": 0, "steps": 0}


def greedy_flush_case():
    from sniffles_tpu_torch.sim import greedy_flush_payloads
    return greedy_flush_payloads()[0]


def test_kernel_inputs_match_the_plain_versions_gates():
    """What the wrappers hand the kernel: the grids, counts and ED table as
    contiguous int32 tensors of the plain version's shapes, and the five
    float32 constants' bits those of the plain version's _Gates
    (forced_at = float32(cmm) * float32(1 + 2 EPS), one rounding)."""
    import torch
    for payload, meta in task_cases("fuzz seed 0"):
        g = tcg._Gates(meta["cm"], meta["cmm"], meta["limit"], "cpu")
        bits = tcg.gate_bits(meta["cm"], meta["cmm"], meta["limit"])
        for key in ("cm_f", "limit_f", "eps_f", "tiny_f", "forced_at"):
            want = getattr(g, key)
            assert want.dtype == torch.float32 and want.dim() == 0
            assert bits[key] == want.view(torch.int32).item(), key
        assert bits["forced_at"] == np.array(
            np.float32(meta["cmm"]) * np.float32(1 + 2e-5)).view(np.int32)
        gates = tcg._kernel_gates(meta["cm"], meta["cmm"], meta["limit"])
        assert gates == (meta["cmm"], *(bits[k] for k in ("cm_f", "limit_f", "eps_f",
                                                           "tiny_f", "forced_at")),
                         int(meta["limit"] > 0), int(g.pass_same))
        S, L = payload["c_pos"].shape
        # a transposed copy is not contiguous: the inputs are made so
        grids = [torch.as_tensor(payload[k].T.copy()).T for k in
                 ("c_pos", "c_len", "c_alt", "c_hord")]
        assert not grids[0].is_contiguous()
        ed = torch.full((S, TASK_ED_HEADS, L), -1, dtype=torch.int32)
        inputs = tcg.grid_inputs(*grids, torch.as_tensor(payload["counts"]), ed)
        assert list(inputs) == ["c_pos", "c_len", "c_alt", "c_hord", "counts", "ed"]
        for k, t in inputs.items():
            assert t.dtype == torch.int32 and t.is_contiguous(), k
        assert inputs["c_pos"].shape == (S, L) and inputs["counts"].shape == (S,)
        assert inputs["ed"].shape == (S, TASK_ED_HEADS, L)
        assert torch.equal(inputs["c_pos"], torch.as_tensor(payload["c_pos"]))
    with pytest.raises(ValueError, match="want int32"):
        tcg.grid_inputs(*[g.long() for g in grids], torch.as_tensor(payload["counts"]), ed)
    with pytest.raises(ValueError, match="ed is"):
        tcg.grid_inputs(*grids, torch.as_tensor(payload["counts"]),
                        torch.zeros((S, 33, L), dtype=torch.int32))
    z = torch.zeros(64, dtype=torch.int32)
    flush = tcg.flush_inputs(z, z, z, z[:16], z[:16], z[:16], z[:16],
                             torch.zeros((16, 64), dtype=torch.int32))
    assert [t.shape for t in flush.values()] == [(64,)] * 3 + [(16,)] * 4 + [(16, 64)]
    with pytest.raises(ValueError, match="ed is"):
        tcg.flush_inputs(z, z, z, z, z, z, z, torch.zeros((16, 32), dtype=torch.int32))


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


@pytest.mark.parametrize("limit", [0.0, 0.7])
def test_flush_past_shared_memory_matches_jax(limit):
    """sim.greedy_flush_wide_payloads, whose row of group slots is too
    large for a block's shared memory (the flush kernel's global-scratch
    layout), through the port's run_combine_greedy and the JAX package's:
    `assign` and `flags` equal, bit for bit; the candidates join initial
    groups and found groups of their own."""
    from sniffles_tpu_torch.sim import greedy_flush_wide_payloads
    (payload, meta), = [(p, m) for p, m in greedy_flush_wide_payloads() if m["limit"] == limit]
    K0, C = len(payload["g_n"]), len(payload["c_pos"])
    G = tcg._pow2(C, 64) + tcg._pow2(K0, 16)
    assert 4 * tcg.STATE_WORDS * G > tcg.SHARED_STATE_MAX
    ours = tcg.run_combine_greedy(payload, meta, "cpu")
    theirs = jcg.run_combine_greedy(payload, meta)
    for key in ("assign", "flags"):
        assert ours[key].tolist() == np.asarray(theirs[key]).tolist(), key
    assert (ours["assign"] < K0).any() and (ours["assign"] >= K0).sum() >= 15


def test_grid_rows_past_shared_memory_are_refused():
    """The grid kernel keeps every row's state in shared memory: grid_inputs
    takes rows of SEG_LMAX = 2,048 slots (the packer's largest segment,
    64 KB of slot records) and refuses the next padded width, 4,096."""
    import torch
    assert 4 * tcg.STATE_WORDS * SEG_LMAX <= tcg.SHARED_STATE_MAX
    for L in (SEG_LMAX, 2 * SEG_LMAX):
        grids = [torch.zeros((2, L), dtype=torch.int32)] * 4
        args = (*grids, torch.ones(2, dtype=torch.int32),
                torch.full((2, TASK_ED_HEADS, 1), -1, dtype=torch.int32))
        if L == SEG_LMAX:
            assert tcg.grid_inputs(*args)["c_pos"].shape == (2, L)
        else:
            with pytest.raises(ValueError, match="past a block's shared memory"):
                tcg.grid_inputs(*args)


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

