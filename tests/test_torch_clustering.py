"""The port's device clustering (sniffles_tpu_torch/ops/segments.py,
ops/stats.py and ops/clustering.py; plain PyTorch on the CPU here, where
the merge-sweep wrapper takes its plain version) against the JAX
package's on the same numpy inputs made from a seed.

Tolerance: 0 for every integer output. Float outputs of the segment
primitives are compared at inputs whose float32 sums are exact (so the
port's float64 accumulation and XLA's float32 one give the same bits)
and asserted equal.

call_task_packed is held to the JAX package's two formulations of the
exact sweep: its sequential while_loop on every batch, and its default
(the auto switch, which picks the segment-lockstep grid for batches that
cut well) on every batch where the two JAX formulations agree; batches
where they disagree are counted and reported. Batches: fuzz batches
whose seeds merge (sniffles_tpu_torch.sim.fuzz_call_batch: sub-threshold
gaps, repeat flags, BND and single-svtype chains, fragmented reads) and
batches packed from simulated BAMs (write_dataset), where the port's
pack_task_batch must also give the JAX package's buffer and meta.

The merge sweep's segmented plain version (the sound-cut partition, then
a walk per segment) is held to a copy of the sequential sweep
(`sequential_sweep` below) in every state array, floats bit for bit, on
all of those batches, with global_repeat on, and on the layouts of
sim.sweep_layout_batches (a head seed alone, BND chains, a cascade that
collapses the cut fixpoint); its partition is checked for soundness."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jc  # noqa: E402
from sniffles_tpu.ops import segments as jseg  # noqa: E402
from sniffles_tpu.ops import stats as jstats  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tc  # noqa: E402
from sniffles_tpu_torch.ops import segments as tseg  # noqa: E402
from sniffles_tpu_torch.ops import stats as tstats  # noqa: E402
from sniffles_tpu_torch.sim import (PlantedSV, edge_call_batches, fuzz_call_batch,  # noqa: E402
                                   sweep_layout_batches, write_dataset)

# the default configuration's call_task_packed parameters
META = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
            cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50,
            cluster_merge_pos=150, global_repeat=False, binsize=100,
            resplit_binsize=20)


# ---------------------------------------------------------------------------
# segment primitives


def segment_case(seed, n=96, num_segments=40):
    """Sorted (segment, value) int32 data with empty segments (ids skip),
    an invalid padding tail, and ids beyond num_segments for the
    reductions that must drop them."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.choice(np.arange(0, num_segments, 2), size=n)).astype(np.int32)
    vals = rng.integers(-300, 300, size=n).astype(np.int32)
    order = np.lexsort((vals, seg))
    seg, vals = seg[order], vals[order]
    valid = np.ones(n, dtype=bool)
    valid[-7:] = False            # padding tail: sorts last
    seg[-7:] = num_segments - 1
    return seg, vals, valid


def as_np(x):
    return np.asarray(x)


REDUCTIONS = [
    ("seg_sum", lambda m, s, v, ok, ns: m.seg_sum(v, s, ns)),
    ("seg_max", lambda m, s, v, ok, ns: m.seg_max(v, s, ns)),
    ("seg_min", lambda m, s, v, ok, ns: m.seg_min(v, s, ns)),
    ("seg_count", lambda m, s, v, ok, ns: m.seg_count(s, ok, ns)),
    ("seg_mean", lambda m, s, v, ok, ns: m.seg_mean(v, s, ok, ns)),
    ("seg_stdev", lambda m, s, v, ok, ns: m.seg_stdev(v, s, ok, ns)),
    ("unique_count_per_segment",
     lambda m, s, v, ok, ns: m.unique_count_per_segment(s, v, ok, ns)),
    ("run_starts", lambda m, s, v, ok, ns: m.run_starts(s, v)),
    ("rank_in_segment", lambda m, s, v, ok, ns: m.rank_in_segment(s)),
    ("segment_ids_from_boundaries",
     lambda m, s, v, ok, ns: m.segment_ids_from_boundaries(v > 100)),
]

STATS = [
    ("segment_start_index", lambda m, s, v, ok, ns: m.segment_start_index(s)),
    ("seg_prefix_count", lambda m, s, v, ok, ns: m.seg_prefix_count(v > 0, s)),
    ("seg_median_modes", lambda m, s, v, ok, ns: m.seg_median_modes(v, s, ok, ns)),
    ("seg_trimmed_stdev", lambda m, s, v, ok, ns: m.seg_trimmed_stdev(v, s, ok, ns)),
    ("seg_most_common_top", lambda m, s, v, ok, ns: m.seg_most_common_top(v, s, ok, ns)),
]


def compare(fn, jmod, tmod, seg, vals, valid, num_segments):
    ours = fn(tmod, torch.from_numpy(seg), torch.from_numpy(vals),
              torch.from_numpy(valid), num_segments).numpy()
    theirs = as_np(fn(jmod, jnp.asarray(seg), jnp.asarray(vals), jnp.asarray(valid),
                      num_segments))
    assert ours.shape == theirs.shape
    if ours.dtype == np.float32:
        assert ours.view(np.int32).tolist() == theirs.astype(np.float32).view(np.int32).tolist()
    else:
        assert ours.tolist() == theirs.astype(ours.dtype).tolist()


@pytest.mark.parametrize("name,fn", REDUCTIONS, ids=[r[0] for r in REDUCTIONS])
@pytest.mark.parametrize("seed", [1, 2])
def test_segment_primitive_matches_jax(name, fn, seed):
    seg, vals, valid = segment_case(seed)
    compare(fn, jseg, tseg, seg, vals, valid, 40)


@pytest.mark.parametrize("name,fn", STATS, ids=[s[0] for s in STATS])
@pytest.mark.parametrize("seed", [3, 4])
def test_segment_statistic_matches_jax(name, fn, seed):
    seg, vals, valid = segment_case(seed)
    compare(fn, jstats, tstats, seg, vals, valid, 40)


@pytest.mark.parametrize("reduce", ["seg_sum", "seg_max", "seg_min"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_reduction_drops_out_of_range_ids(reduce, dtype):
    """jax.ops.segment_* drops ids < 0 and >= num_segments and gives an
    empty segment the reduction's identity; so must the port."""
    ids = np.array([-1, 0, 0, 3, 5, 9, 2], dtype=np.int32)
    x = np.array([7, 1, 2, -4, 6, 8, 3], dtype=dtype)
    ours = getattr(tseg, reduce)(torch.from_numpy(x), torch.from_numpy(ids), 6).numpy()
    theirs = np.asarray(getattr(jseg, reduce)(jnp.asarray(x), jnp.asarray(ids), 6))
    assert ours.dtype == theirs.dtype
    assert ours.tolist() == theirs.tolist()


def test_int32_sum_wraps_like_xla():
    x = np.array([2 ** 31 - 5, 10, 7], dtype=np.int32)
    ids = np.zeros(3, dtype=np.int32)
    ours = tseg.seg_sum(torch.from_numpy(x), torch.from_numpy(ids), 1).numpy()
    assert ours.dtype == np.int32
    assert ours.tolist() == np.asarray(jseg.seg_sum(jnp.asarray(x), jnp.asarray(ids), 1)).tolist()


def test_sqrt_f32_is_correctly_rounded():
    """torch's CPU float32 sqrt misrounds (9112.5 is one such input);
    sqrt_f32 must give IEEE sqrtf, which numpy's float32 sqrt is."""
    rng = np.random.default_rng(0)
    x = np.concatenate([[9112.5, 0.0, 1.0, 2.0], rng.random(20_000) * 1e6]).astype(np.float32)
    ours = tseg.sqrt_f32(torch.from_numpy(x)).numpy()
    assert ours.view(np.int32).tolist() == np.sqrt(x).view(np.int32).tolist()


@pytest.mark.parametrize("keys", [1, 2, 3])
def test_lexsort_matches_jnp_lexsort(keys):
    rng = np.random.default_rng(keys)
    cols = [rng.integers(-3, 4, size=200).astype(np.int32) for _ in range(keys)]
    ours = tseg.lexsort([torch.from_numpy(c) for c in cols]).numpy()
    assert ours.tolist() == np.asarray(jnp.lexsort([jnp.asarray(c) for c in cols])).tolist()


# ---------------------------------------------------------------------------
# call_task_packed


_JAX_FNS = {}


def jax_call_task(packed, sequential: bool, monkeypatch):
    """The JAX package's call_task_packed with its sequential sweep
    (sequential=True) or its default formulation; each variant is its own
    jit, traced with the module switch set accordingly."""
    if sequential not in _JAX_FNS:
        _JAX_FNS[sequential] = jax.jit(
            jc.call_task_packed.__wrapped__,
            static_argnames=tuple(META))
    monkeypatch.setattr(jc, "_FORCE_SEQ_SWEEP", sequential)
    return np.asarray(_JAX_FNS[sequential](jnp.asarray(packed), **META))


def port_call_task(packed):
    out = tc.call_task_packed(torch.from_numpy(packed), **META)
    assert out.dtype == torch.int32
    return out.numpy()


FUZZ = [
    pytest.param(dict(seed=11, size=512), id="fuzz-512-a"),
    pytest.param(dict(seed=12, size=512), id="fuzz-512-b"),
    pytest.param(dict(seed=13, size=2048), id="fuzz-2048"),
    pytest.param(dict(seed=14, size=2048, fill=0.97), id="fuzz-2048-full"),
    pytest.param(dict(seed=15, size=2048, svtypes=(4,)), id="bnd-chains"),
    pytest.param(dict(seed=16, size=2048, svtypes=(1,)), id="del-chain"),
    pytest.param(dict(seed=17, size=512, svtypes=(0, 1)), id="ins-del"),
    pytest.param(dict(seed=18, size=8192), id="fuzz-8192"),
    # BND chains on which the JAX grid sweep's cut rule, which reads the
    # left span at slot segid - 1, keeps a cut that a merge crosses
    pytest.param(dict(seed=6, size=2048, svtypes=(4,)), id="bnd-chains-6"),
    pytest.param(dict(seed=22, size=2048, svtypes=(4,)), id="bnd-chains-22"),
    pytest.param(dict(seed=27, size=2048, svtypes=(4,)), id="bnd-chains-27"),
]

def check_call_task(packed, monkeypatch):
    ours = port_call_task(packed)
    seq = jax_call_task(packed, True, monkeypatch)
    default = jax_call_task(packed, False, monkeypatch)
    assert ours.shape == seq.shape
    n = packed.shape[1]
    o_el, o_st = tc.split_call_task_output(ours, n)
    s_el, s_st = tc.split_call_task_output(seq, n)
    assert o_el.tolist() == s_el.tolist()
    for row in range(tc.STATS_ROWS):
        assert o_st[row].tolist() == s_st[row].tolist(), f"stats row {row}"
    if np.array_equal(seq, default):
        assert np.array_equal(ours, default)
    return o_el, o_st


@pytest.mark.parametrize("kw", FUZZ)
def test_call_task_packed_matches_jax_on_fuzz_batches(kw, monkeypatch):
    packed = fuzz_call_batch(**kw)
    el, st = check_call_task(packed, monkeypatch)
    # the batch exercised merges: fewer clusters than seeds
    s, b, bin_ = tc.sort_and_seed(tc.packed_signatures(torch.from_numpy(packed)), 100)
    inputs, _ = tc.sweep_inputs(s, b, bin_, 100)
    assert int(st[tc.STATS_NC_ROW][1]) < int(inputs["nseeds"][0])


@pytest.mark.parametrize("name", ["nseeds-0", "one-seed", "fragmented-read"])
def test_call_task_packed_matches_jax_on_edges(name, monkeypatch):
    check_call_task(edge_call_batches()[name], monkeypatch)


# ---------------------------------------------------------------------------
# batches packed from simulated BAMs


def planted(layout):
    return [PlantedSV(pos=p, svtype=t, svlen=ln, vaf=v) for p, t, ln, v in layout]


BAMS = {
    "sim-6sv": dict(ref_len=200_000, depth=24, seed=11, svs=[
        (30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 1.0), (90_000, "DEL", 500, 1.0),
        (120_000, "INS", 80, 1.0), (150_000, "DEL", 2000, 1.0), (175_000, "DUP", 900, 1.0)]),
    "sim-phased-tr": dict(ref_len=160_000, depth=24, seed=7, phased=True, svs=[
        (30_000, "DEL", 120, 1.0), (60_000, "INS", 150, 0.5), (90_000, "DEL", 500, 0.5),
        (120_000, "INV", 800, 1.0), (140_000, "INS", 80, 1.0)],
        tr=[(59_000, 61_500), (119_000, 121_500)]),
}


@pytest.fixture(scope="module")
def sim_bams(tmp_path_factory):
    out = {}
    for name, spec in BAMS.items():
        d = tmp_path_factory.mktemp(name)
        bam, fa = write_dataset(str(d), ref_len=spec["ref_len"], depth=spec["depth"],
                                read_len=12_000, seed=spec["seed"],
                                phased=spec.get("phased", False),
                                svs=planted(spec["svs"]))
        out[name] = (bam, fa, spec.get("tr"))
    return out


def leadtabs(bam, fa, tr):
    """The JAX package's and the port's LeadProvider over the same BAM
    (the JAX package's pure-Python scan, --no-native), and both configs."""
    from sniffles_tpu import leads as jleads
    from sniffles_tpu.config import SnifflesConfig as JConfig
    from sniffles_tpu.io.bam import AlignmentFile as JBam
    from sniffles_tpu.region import Region as JRegion
    from sniffles_tpu_torch import leads as tleads
    from sniffles_tpu_torch.config import SnifflesConfig as TConfig
    from sniffles_tpu_torch.io.bam import AlignmentFile as TBam
    from sniffles_tpu_torch.region import Region as TRegion

    args = ["--input", bam, "--vcf", "x.vcf", "--reference", fa, "--phase", "--no-native"]
    out = []
    for Config, Bam, Region, leads in ((JConfig, JBam, JRegion, jleads),
                                       (TConfig, TBam, TRegion, tleads)):
        config = Config(*args)
        config.input_mode = "rb"
        provider = leads.LeadProvider(config, 0, "chr1")
        f = Bam(bam, "rb", require_index=True)
        provider.build_leadtab([Region("chr1", 0, f.get_reference_length("chr1") - 1)], f)
        out.append((provider, config))
    return out


@pytest.mark.parametrize("name", list(BAMS))
def test_pack_task_batch_matches_jax(name, sim_bams):
    from sniffles_tpu.parallel import device_call as jdc
    from sniffles_tpu_torch.parallel import device_call as tdc
    bam, fa, tr = sim_bams[name]
    (jprov, jconf), (tprov, tconf) = leadtabs(bam, fa, tr)
    jpack = jdc.pack_task_batch(jprov, jconf, tr)
    tpack = tdc.pack_task_batch(tprov, tconf, tr)
    assert tpack[0].dtype == np.int32 and tpack[0].shape == jpack[0].shape
    assert tpack[0].tolist() == jpack[0].tolist()
    assert tpack[1] == jpack[1]
    assert [b for b in tpack[3]] == [b for b in jpack[3]]
    assert tdc.pad_packed(tpack[0]).tolist() == jdc.pad_packed(jpack[0]).tolist()


@pytest.mark.parametrize("name", list(BAMS))
def test_call_task_packed_matches_jax_on_sim_batches(name, sim_bams, monkeypatch):
    from sniffles_tpu_torch.parallel import device_call as tdc
    bam, fa, tr = sim_bams[name]
    _, (tprov, tconf) = leadtabs(bam, fa, tr)
    packed, meta, leads, _ = tdc.pack_task_batch(tprov, tconf, tr)
    assert meta == META
    check_call_task(tdc.pad_packed(packed), monkeypatch)


# ---------------------------------------------------------------------------
# the merge sweep: the segmented sweep against the sequential one


def sequential_sweep(inputs: dict, state: dict, *, cluster_r, cluster_repeat_h,
                     cluster_repeat_h_max, cluster_merge_bnd, global_repeat) -> int:
    """The sequential sweep, the reference the segmented one is held to:
    EXACT emulation of the host cluster merge sweep (reference:
    cluster.py:277-308) over the whole task, one pointer move or merge per
    iteration, updating `state` in place; the JAX package's
    _exact_merge_sweep loop (:194-252) with its float32 criteria and the
    port's range metrics. Every svtype's head is the task's, so each
    svtype's pointer starts at i = 0. Returns the number of iterations."""
    f32 = torch.float32
    seed_type = inputs["seed_type"].tolist()
    start_bp = inputs["start_bp"].tolist()
    lo = inputs["lo"].tolist()
    posf, svlenf = inputs["posf"], inputs["svlenf"]
    nseeds = int(inputs["nseeds"][0])
    n = len(seed_type)
    sent = n
    nxt, prv, hi = state["nxt"], state["prv"], state["hi"]
    end_bp, rep, msv, sd, alive = (state["end_bp"], state["rep"], state["msv"],
                                   state["sd"], state["alive"])
    r_f = torch.tensor(cluster_r, dtype=f32)
    h_f = torch.tensor(cluster_repeat_h, dtype=f32)
    hmax_f = torch.tensor(cluster_repeat_h_max, dtype=f32)
    bnd_f = torch.tensor(cluster_merge_bnd, dtype=f32)

    def clip(x):
        return min(max(x, 0), n - 1)

    if nseeds <= 0:
        return 0
    c, i, cur_t, it = 0, 0, seed_type[0], 0
    max_iters = 4 * n + 8
    while c < sent and it < max_iters:
        ct = seed_type[c]
        if ct != cur_t:
            i = 0
        r = int(nxt[c])
        rc = clip(r)
        merge = False
        if r < sent and seed_type[rc] == ct:
            inner = torch.tensor(start_bp[rc] - int(end_bp[c]), dtype=f32)
            outer = torch.tensor(int(end_bp[rc]) - start_bp[c], dtype=f32)
            m1 = bool(inner <= torch.minimum(sd[c], sd[rc]) * r_f)
            rep_pair = int(rep[c]) > 0 or int(rep[rc]) > 0 or bool(global_repeat)
            h_lim = torch.minimum(hmax_f, (msv[c].abs() + msv[rc].abs()) * h_f)
            m2 = rep_pair and bool(outer <= h_lim)
            m3 = ct == tc.SVTYPE_BND and bool(inner <= bnd_f)
            merge = m1 or m2 or m3
        if merge:
            new_hi = int(hi[rc])
            mean_new, sd_new = tc._range_metrics_plain(posf, svlenf, lo[c], new_hi)
            rn = int(nxt[rc])
            hi[c] = new_hi
            end_bp[c] = end_bp[rc]
            rep[c] = rep[c] | rep[rc]
            msv[c] = mean_new
            sd[c] = sd_new
            nxt[c] = rn
            if rn < sent:
                prv[rn] = c
            alive[rc] = 0
            # i == 0 -> the node after the merged head; i == 1 -> the merged
            # node itself; i >= 2 -> the node before it (backtrack)
            p = int(prv[c])
            p_ok = p < sent and seed_type[clip(p)] == ct
            if i == 0:
                c2, i2 = rn, 1
            elif i == 1:
                c2, i2 = c, 1
            else:
                c2, i2 = (p, i - 1) if p_ok else (c, i)
        else:
            c2, i2 = r, i + 1
        c, i, cur_t, it = c2, i2, ct, it + 1
    return it


SWEEP = {k: META[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                              "cluster_merge_bnd", "global_repeat")}
CUTS = {k: META[k] for k in ("cluster_r", "cluster_repeat_h_max", "cluster_merge_bnd")}

# (kind, key, global_repeat): every FUZZ batch, the edges, both sim-packed
# batches, global_repeat on, and the layouts of sim.sweep_layout_batches
SWEEP_CASES = (
    [pytest.param("fuzz", p.values[0], False, id=p.id) for p in FUZZ]
    + [pytest.param("edge", name, False, id=name)
       for name in ("nseeds-0", "one-seed", "fragmented-read")]
    + [pytest.param("sim", name, False, id=name) for name in BAMS]
    + [pytest.param("fuzz", dict(seed=13, size=2048), True, id="fuzz-2048-global-repeat"),
       pytest.param("fuzz", dict(seed=15, size=2048, svtypes=(4,)), True,
                    id="bnd-chains-global-repeat")]
    + [pytest.param("layout", name, False, id=f"layout-{name}")
       for name in ("head-alone", "bnd-chains", "cascade")])


def sweep_batch(kind, key, request) -> np.ndarray:
    if kind == "fuzz":
        return fuzz_call_batch(**key)
    if kind == "edge":
        return edge_call_batches()[key]
    if kind == "layout":
        return sweep_layout_batches()[key]
    from sniffles_tpu_torch.parallel import device_call as tdc
    bam, fa, tr = request.getfixturevalue("sim_bams")[key]
    _, (tprov, tconf) = leadtabs(bam, fa, tr)
    return tdc.pad_packed(tdc.pack_task_batch(tprov, tconf, tr)[0])


def sweep_case(packed):
    s, b, bin_ = tc.sort_and_seed(tc.packed_signatures(torch.from_numpy(packed)), 100)
    return tc.sweep_inputs(s, b, bin_, 100)


def bits(t: torch.Tensor) -> list:
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).tolist()


@pytest.mark.parametrize("kind,key,global_repeat", SWEEP_CASES)
def test_segmented_sweep_equals_the_sequential_sweep(kind, key, global_repeat, request):
    """merge_sweep_plain (the partition, then a walk per segment) leaves
    every state array as the sequential sweep does, floats bit for bit,
    in no more iterations."""
    inputs, state = sweep_case(sweep_batch(kind, key, request))
    params = dict(SWEEP, global_repeat=global_repeat)
    seq = {k: v.clone() for k, v in state.items()}
    seg = {k: v.clone() for k, v in state.items()}
    seq_iters = sequential_sweep(inputs, seq, **params)
    counts = dict(zip(tc.SWEEP_COUNTS, tc.merge_sweep_plain(inputs, seg, **params).tolist()))
    for k in tc.SWEEP_STATE:
        assert bits(seg[k]) == bits(seq[k]), k
    nseeds = int(inputs["nseeds"][0])
    assert counts["depth"] <= counts["iterations"] <= seq_iters
    assert (counts["segments"] > 0) == (nseeds > 0)
    assert counts["segments"] <= nseeds and 1 <= counts["passes"] <= tc.MAX_CUT_PASSES


@pytest.mark.parametrize("kind,key,global_repeat", SWEEP_CASES)
def test_sweep_partition_is_sound(kind, key, global_repeat, request):
    """No cluster that survives the sweep spans a kept cut, and, unless the
    fixpoint collapsed, every kept cut that is not a svtype's first seed
    has a gap beyond both caps and beyond cluster_r times the smaller span
    of the two segments beside it (float32, recomputed here with numpy)."""
    inputs, state = sweep_case(sweep_batch(kind, key, request))
    cut, _, counts = tc.sweep_cuts_plain(inputs, state, **CUTS)
    end_bp0 = state["end_bp"].numpy().copy()
    tc.merge_sweep_plain(inputs, state, **dict(SWEEP, global_repeat=global_repeat))
    nseeds = int(inputs["nseeds"][0])
    cut = cut.numpy().astype(bool)
    assert cut[0] and not cut[max(nseeds, 1):].any()
    nxt, alive = state["nxt"].numpy(), state["alive"].numpy()
    for c in np.flatnonzero(alive[:nseeds]):
        assert not cut[c + 1:min(nxt[c], nseeds)].any(), c
    seed_type = inputs["seed_type"].numpy()[:nseeds]
    type_cut = np.ones(nseeds, dtype=bool)
    type_cut[1:] = seed_type[1:] != seed_type[:-1]
    if counts[4]:
        assert cut[:nseeds].tolist() == type_cut.tolist()
        return
    start_bp = inputs["start_bp"].numpy()
    heads = np.flatnonzero(cut[:nseeds])
    ends = np.append(heads[1:], nseeds) - 1
    span = (end_bp0[ends] - start_bp[heads]).astype(np.float32)
    for k, c in enumerate(heads):
        if type_cut[c]:
            continue
        gap = np.float32(start_bp[c] - end_bp0[c - 1])
        assert gap > np.float32(max(META["cluster_merge_bnd"], META["cluster_repeat_h_max"]))
        assert gap > np.float32(META["cluster_r"]) * min(span[k - 1], span[k]), c


def test_sweep_layouts_take_their_paths():
    """head-alone: the DEL's head seed is a segment of its own and the next
    segment merges; bnd-chains: BND merges, within and across the 1 kb m3
    reach; cascade: the fixpoint runs its 24 passes and collapses."""
    layouts = sweep_layout_batches()
    found = {}
    for name, packed in layouts.items():
        inputs, state = sweep_case(packed)
        cut, _, _ = tc.sweep_cuts_plain(inputs, state, **CUTS)
        counts = dict(zip(tc.SWEEP_COUNTS, tc.merge_sweep_plain(inputs, state, **SWEEP).tolist()))
        found[name] = (cut.tolist(), counts, state["alive"].tolist(), int(inputs["nseeds"][0]))
    cut, counts, alive, nseeds = found["head-alone"]
    assert cut[:2] == [1, 1] and alive[0] == 1 and sum(alive[1:nseeds]) < nseeds - 1
    assert not counts["collapsed"]
    cut, counts, alive, nseeds = found["bnd-chains"]
    assert sum(alive[:nseeds]) < nseeds and counts["segments"] > 1
    cut, counts, alive, nseeds = found["cascade"]
    assert counts["collapsed"] == 1 and counts["passes"] == tc.MAX_CUT_PASSES
    assert counts["segments"] == 1


def test_merge_sweep_wrapper_takes_the_plain_version_on_the_cpu():
    inputs, state = sweep_case(fuzz_call_batch(21, 1024))
    a = {k: v.clone() for k, v in state.items()}
    b = {k: v.clone() for k, v in state.items()}
    launches = dict(tc.COUNTS)
    counts = tc.merge_sweep(inputs, a, **SWEEP)
    assert tc.COUNTS == launches                  # no kernel on the CPU
    assert counts.dtype == torch.int32 and counts.shape == (len(tc.SWEEP_COUNTS),)
    assert torch.equal(counts, tc.merge_sweep_plain(inputs, b, **SWEEP))
    assert int(counts[0]) > 0
    for k in tc.SWEEP_STATE:
        assert torch.equal(a[k], b[k]), k
    assert int(a["alive"].sum()) < int(inputs["nseeds"][0])   # merges happened


def test_merge_sweep_wrapper_rejects_bad_inputs():
    inputs, state = sweep_case(fuzz_call_batch(21, 1024))
    bad = dict(state, sd=state["sd"].double())
    with pytest.raises(ValueError, match="sd"):
        tc.merge_sweep(inputs, bad, **SWEEP)
    meta_inputs = {k: v.to("meta") for k, v in inputs.items()}
    meta_state = {k: v.to("meta") for k, v in state.items()}
    with pytest.raises(ValueError, match="no merge-sweep kernel"):
        tc.merge_sweep(meta_inputs, meta_state, **SWEEP)


def test_exact_sweep_matches_the_host_sweep():
    """The sweep's partition against the host's sequential sweep
    (cluster.resolve, float64 compute_metrics), the truth both packages
    approximate, on merge chains of the fuzz generator."""
    from sniffles_tpu_torch import cluster as cl
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import Lead, LeadProvider

    config = SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf")
    packed = fuzz_call_batch(31, 2048, svtypes=(0,))
    n = int(packed[5].sum())
    # the host seeds only bins with >= dev_min_leads_cluster leads: keep those
    bins = packed[0, :n] // 100 * 100
    ub, cnt = np.unique(bins, return_counts=True)
    keep = np.isin(bins, ub[cnt >= config.dev_min_leads_cluster])
    packed[5, :n] = keep
    packed[4, :n] = 0          # the host flags repeats per bin start; leave them out
    provider = LeadProvider(config, 0, "chr1")
    order = np.argsort(packed[3, :n], kind="stable")
    for i in order[keep[order]]:
        ld = Lead(read_id=int(i), read_qname=str(packed[3, i]), contig="chr1",
                  ref_start=int(packed[0, i]), ref_end=int(packed[0, i]), qry_start=0,
                  qry_end=0, strand="+", mapq=60, nm=0.0, source="INLINE",
                  svtype="INS", svlen=int(packed[1, i]))
        provider.record_lead(ld, int(ld.ref_start / 100) * 100)
    provider.start, provider.end = 0, 10_000_000
    host = sorted(sorted(int(ld.read_qname) for ld in c.leads)
                  for c in cl._merge_sweep(cl._seed_clusters("INS", provider, config, None),
                                           "INS", config))
    el, _ = tc.split_call_task_output(port_call_task(packed), packed.shape[1])
    groups: dict = {}
    for cid, orig, ok in zip(*el.tolist()):
        if ok:
            groups.setdefault(cid, []).append(orig)
    assert sorted(sorted(g) for g in groups.values()) == host


def test_jax_grid_sweep_disagreement_is_reported(capsys):
    """The JAX grid sweep called directly (its auto switch takes the
    sequential sweep on these batches) against the JAX sequential sweep
    on the BND FUZZ batches: where its pass rule reads the left span at
    slot segid - 1, it can keep a cut that a merge crosses and split a
    cluster. The count is reported; the port's segmented sweep must give
    the sequential sweep's boundaries on every one of them."""
    kw = dict(SWEEP, binsize=100, head_freeze=True)
    batches = [p for p in FUZZ if p.values[0].get("svtypes") == (4,)]
    disagree = 0
    for p in batches:
        s, b, bin_ = tc.sort_and_seed(
            tc.packed_signatures(torch.from_numpy(fuzz_call_batch(**p.values[0]))), 100)
        ours = tc._exact_merge_sweep(s, b, bin_, binsize=100, **SWEEP).numpy()
        js = {k: jnp.asarray(s[k].numpy()) for k in ("pos", "svlen", "svtype", "repeat",
                                                      "valid")}
        jb, jbin = jnp.asarray(b.numpy()), jnp.asarray(bin_.numpy())
        seq = np.asarray(jc._exact_merge_sweep(js, jb, jbin, **kw))
        grid = np.asarray(jc._exact_merge_sweep_grid(js, jb, jbin, **kw))
        assert ours.tolist() == seq.tolist(), p.id
        disagree += not np.array_equal(seq, grid)
    with capsys.disabled():
        print(f"\n[test_torch_clustering] {len(batches)} BND batches, JAX grid sweep vs "
              f"sequential disagree on {disagree}")


def test_jax_formulation_agreement_is_reported(sim_bams, monkeypatch, capsys):
    """Counts the batches of this file on which the JAX package's two
    formulations of the sweep disagree (those batches hold the port to
    the sequential one only) and reports the count."""
    from sniffles_tpu_torch.parallel import device_call as tdc
    batches = [fuzz_call_batch(**p.values[0]) for p in FUZZ]
    batches += list(edge_call_batches().values())
    for bam, fa, tr in sim_bams.values():
        _, (tprov, tconf) = leadtabs(bam, fa, tr)
        batches.append(tdc.pad_packed(tdc.pack_task_batch(tprov, tconf, tr)[0]))
    disagree = sum(not np.array_equal(jax_call_task(p, True, monkeypatch),
                                      jax_call_task(p, False, monkeypatch))
                   for p in batches)
    with capsys.disabled():
        print(f"\n[test_torch_clustering] {len(batches)} batches, JAX sequential vs "
              f"default disagree on {disagree}")
    assert len(batches) == len(FUZZ) + 3 + len(BAMS)
