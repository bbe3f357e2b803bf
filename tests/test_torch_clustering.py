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
pack_task_batch must also give the JAX package's buffer and meta."""
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
                                   write_dataset)

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
# the merge-sweep wrapper


def sweep_case(seed=21, size=1024):
    packed = fuzz_call_batch(seed, size)
    s, b, bin_ = tc.sort_and_seed(tc.packed_signatures(torch.from_numpy(packed)), 100)
    return tc.sweep_inputs(s, b, bin_, 100)


SWEEP = {k: META[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                              "cluster_merge_bnd", "global_repeat")}


def test_merge_sweep_wrapper_takes_the_plain_version_on_the_cpu():
    inputs, state = sweep_case()
    a = {k: v.clone() for k, v in state.items()}
    b = {k: v.clone() for k, v in state.items()}
    launches = tc.COUNTS["launches"]
    iters = tc.merge_sweep(inputs, a, **SWEEP)
    assert tc.COUNTS["launches"] == launches      # no kernel on the CPU
    assert int(iters[0]) == tc.merge_sweep_plain(inputs, b, **SWEEP) > 0
    for k in tc.SWEEP_STATE:
        assert torch.equal(a[k], b[k]), k
    assert int(a["alive"].sum()) < int(inputs["nseeds"][0])   # merges happened


def test_merge_sweep_wrapper_rejects_bad_inputs():
    inputs, state = sweep_case()
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
