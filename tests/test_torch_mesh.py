"""The port's mesh (sniffles_tpu_torch/parallel/mesh.py, --tpu-mesh N) and
the modules under it against the JAX package's on the same numpy inputs
made from a seed, the JAX side on its 8 virtual CPU devices
(tests/conftest.py), the port's shards on the CPU (SNIFFLES_TPU_FORCE_CPU,
where the merge-sweep wrapper takes its plain version):

  * the merge sweep with a head mask against the JAX sequential sweep
    with head_freeze, on fuzz batches whose seeds merge, for the masks
    0xFF, 0x00 and mixed ones;
  * group_candidates in both cut modes;
  * the call step's outgoing halo (slot choice and order across position
    ties), and build_sharded_assign's rows and overflow flags at W and 2W
    on fuzz payloads of 8 and 4 shards and on the payloads of
    tests/test_tpu_mesh.py's providers;
  * build_sharded_combine_step on tests/test_mesh.py's cases and on
    candidate tensors read from SNF files (combine_tensors);
  * device_clusters on tests/test_tpu_mesh.py:133-292's cases: the
    doubled-halo retry, the exhausted halo (MeshHaloOverflow, and the
    task's counted host route), the head freeze off shard 0, and the
    sender's span overflow;
  * build_sharded_step (the fused engine's step) on 4 CPU shards against
    the JAX step on 4 virtual devices, on tests/test_mesh.py's planted and
    straddling cases, and its overflow flags;
  * mesh_devices' placement and refusals, and the service's mesh kinds.

Tolerance: 0. Every integer output is compared bit for bit, the float32
support mean by its bits; the engine step's global coverage and NM means
within 2^-20 relative (MEAN_RTOL), its other float32 outputs by their
bits. The JAX mesh step runs its sequential sweep
(`_FORCE_SEQ_SWEEP`, as tests/test_torch_clustering.py does): its default
grid sweep keeps unsound cuts on some batches (ROADMAP C), and where its
grid and sequential mesh rows differ the count is reported."""
import os
from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jc  # noqa: E402
from sniffles_tpu.ops import combine_groups as jcg  # noqa: E402
from sniffles_tpu.parallel import device_call as jdc  # noqa: E402
from sniffles_tpu.parallel import mesh as jmesh  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tc  # noqa: E402
from sniffles_tpu_torch.ops import combine_groups as tcg  # noqa: E402
from sniffles_tpu_torch.parallel import device_call as tdc  # noqa: E402
from sniffles_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sniffles_tpu_torch.sim import fuzz_call_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
             cluster_merge_bnd=1000, global_repeat=False)
# the default configuration's call step parameters (standard_call_meta)
META = dict(SWEEP, cluster_merge_len=0.22, minsvlen=50, cluster_merge_pos=150, binsize=100,
            resplit_binsize=20)


@pytest.fixture(autouse=True)
def cpu_shards(monkeypatch):
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one torch thread, beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the JAX mesh steps this module builds, by (kind, shards, sequential
# sweep, parameters): each jit traces at its first call, with the module
# switch set as its key says, and W is a run-time input
_JAX_STEPS: dict = {}
_JAX_SEQUENTIAL_CACHE: dict = {}


@pytest.fixture
def jax_sequential(monkeypatch):
    """The JAX package's sequential sweep in every step traced from here;
    its device_call keeps the mesh steps it builds in a cache of this
    module's, where no step of another formulation is."""
    monkeypatch.setattr(jc, "_FORCE_SEQ_SWEEP", True)
    monkeypatch.setattr(jdc, "_mesh_fn_cache", _JAX_SEQUENTIAL_CACHE)


# ---------------------------------------------------------------------------
# the merge sweep's head mask

HEAD_CASES = [
    pytest.param(dict(seed=11, size=512), id="fuzz-512"),
    pytest.param(dict(seed=13, size=2048), id="fuzz-2048"),
    pytest.param(dict(seed=15, size=2048, svtypes=(4,)), id="bnd-chains"),
    pytest.param(dict(seed=16, size=2048, svtypes=(1,)), id="del-chain"),
    pytest.param(dict(seed=17, size=512, svtypes=(0, 1)), id="ins-del"),
]
MASKS = {"all": 0xFF, "none": 0x00, "mixed-a": 0x0A, "mixed-b": 0xF5}

_jax_sweep = jax.jit(partial(jc._exact_merge_sweep, binsize=100, **SWEEP))


def head_vector(mask: int) -> np.ndarray:
    return np.array([(mask >> t) & 1 for t in range(8)], dtype=bool)


def sweeps(kw, mask):
    """(the port's element boundaries, the JAX sequential sweep's) of a
    fuzz batch under a head mask."""
    s, b, bin_ = tc.sort_and_seed(tc.packed_signatures(torch.from_numpy(fuzz_call_batch(**kw))),
                                  100)
    ours = tc._exact_merge_sweep(s, b, bin_, binsize=100, head_mask=mask, **SWEEP).numpy()
    js = {k: jnp.asarray(s[k].numpy()) for k in ("pos", "svlen", "svtype", "repeat", "valid")}
    want = np.asarray(_jax_sweep(js, jnp.asarray(b.numpy()), jnp.asarray(bin_.numpy()),
                                 head_freeze=jnp.asarray(head_vector(mask))))
    return ours, want


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kw", HEAD_CASES)
def test_head_masked_sweep_matches_jax(kw, mask):
    ours, want = sweeps(kw, MASKS[mask])
    assert ours.tolist() == want.tolist()


def test_head_mask_changes_the_sweep():
    """Not vacuous: on these batches an unfrozen head merges otherwise
    (the JAX sweep says so too), and the sweep's state keeps the mask."""
    changed = [p.id for p in HEAD_CASES
               if sweeps(p.values[0], 0x00)[1].tolist() != sweeps(p.values[0], 0xFF)[1].tolist()]
    assert changed, "no batch where head_freeze matters"
    inputs, _ = tc.sweep_inputs(*tc.sort_and_seed(
        tc.packed_signatures(torch.from_numpy(fuzz_call_batch(11, 512))), 100), 100, 0x0A)
    assert inputs["head_mask"].tolist() == [0x0A]
    stacked = tc._stack_tasks([inputs, inputs])
    assert stacked["head_mask"].tolist() == [0x0A, 0x0A]
    assert tc._task_row(stacked, 1)["head_mask"].tolist() == [0x0A]


# ---------------------------------------------------------------------------
# group_candidates


def candidate_case(seed, n=600, n_types=4, invalid=40):
    """Candidates at clustered positions with position ties, several
    svtypes and samples, an invalid tail and some invalid slots inside."""
    rng = np.random.default_rng(seed)
    centers = np.sort(rng.integers(0, 400_000, size=n // 6))
    pos = (np.repeat(centers, 6)[:n] + rng.integers(-40, 41, size=n)).astype(np.int32)
    valid = np.ones(n, dtype=bool)
    valid[-invalid:] = False
    valid[rng.choice(n - invalid, size=10, replace=False)] = False
    return {
        "pos": pos,
        "svlen": (rng.integers(50, 3000, size=n) * rng.choice([-1, 1], size=n)).astype(np.int32),
        "svtype": rng.integers(0, n_types, size=n).astype(np.int32),
        "sample_id": rng.integers(0, 9, size=n).astype(np.int32),
        "support": rng.integers(1, 60, size=n).astype(np.int32),
        "qc": rng.random(n) < 0.8,
        "valid": valid,
        "orig_idx": np.arange(n, dtype=np.int32),
    }


def same_outputs(ours: dict, theirs: dict, skip=()):
    assert set(ours) == set(theirs)
    for k in ours:
        if k in skip:
            continue
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert a.shape == b.shape and a.tolist() == b.tolist(), k


@pytest.mark.parametrize("safe_cut_only", [False, True], ids=["criterion", "safe-cuts"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_group_candidates_matches_jax(seed, safe_cut_only):
    cand = candidate_case(seed)
    ours = tcg.group_candidates({k: torch.from_numpy(v) for k, v in cand.items()},
                                250.0, 1000.0, safe_cut_only=safe_cut_only)
    theirs = jcg.group_candidates({k: jnp.asarray(v) for k, v in cand.items()}, 250.0, 1000.0,
                                  safe_cut_only=safe_cut_only)
    same_outputs({k: v.numpy() for k, v in ours.items()}, theirs)
    assert 1 < int(ours["n_groups"]) < len(cand["pos"])


# ---------------------------------------------------------------------------
# the call step


def trimmed_fuzz(seed, size, **kw):
    """A fuzz batch as the packer leaves it: the valid columns, orig_idx
    0..n-1, wrapped as a pack for pack_mesh_payload."""
    packed = fuzz_call_batch(seed, size, **kw)
    packed = packed[:, packed[5] > 0].copy()
    packed[3] = np.arange(packed.shape[1], dtype=np.int32)
    return packed, META, [None] * packed.shape[1], None


def test_outgoing_halo_matches_jax():
    """The exchanged halo itself: which signatures cross and in what order,
    across position ties (stable), with its overflow flag."""
    rng = np.random.default_rng(5)
    n = 1024
    packed = rng.integers(0, 1000, size=(15, n)).astype(np.int32)
    packed[0] = np.sort(rng.integers(90_000, 100_000, size=n)) // 50 * 50   # many ties
    packed[5] = rng.random(n) < 0.9
    for my_end, w, slots in ((100_000, 2_000, 512), (100_000, 1_000, 64), (95_000, 500, 300)):
        halo, overflow = tmesh.outgoing_halo(torch.from_numpy(packed), my_end, w, slots)
        jp = jnp.asarray(packed)
        in_halo = (jp[5] > 0) & (jp[0] >= my_end - 2 * w)
        order = jnp.lexsort((jp[0], ~in_halo))
        want = jnp.take(jp, order, axis=1)[:, :slots]
        want = want.at[5].set(((want[5] > 0) & jnp.take(in_halo, order)[:slots])
                              .astype(jnp.int32))
        assert halo.numpy().tolist() == np.asarray(want).tolist()
        assert bool(overflow) == bool(jnp.sum(in_halo.astype(jnp.int32)) > slots)


def jax_assign(payload, halo_w, sequential):
    key = ("assign", len(halo_w), sequential)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jmesh.build_sharded_assign(jmesh.make_genome_mesh(len(halo_w)),
                                                     **META)
    before, jc._FORCE_SEQ_SWEEP = jc._FORCE_SEQ_SWEEP, sequential
    try:
        out = jax.device_get(_JAX_STEPS[key](
            jnp.asarray(payload["shards"]), jnp.asarray(payload["offsets"]),
            jnp.asarray(payload["window_len"]), jnp.asarray(halo_w)))
    finally:
        jc._FORCE_SEQ_SWEEP = before
    return {k: np.asarray(v) for k, v in out.items()}


def assign_both(payload, w, grid=False):
    """build_sharded_assign's output of the port and of the JAX package
    (its sequential sweep; with grid=True also its default one) on a
    payload at halo width w."""
    n = int(payload["n_dev"])
    halo_w = np.full((n, 1), w, dtype=np.int32)
    ours = tmesh.build_sharded_assign(["cpu"] * n, **META)(
        payload["shards"], payload["offsets"], payload["window_len"], halo_w)
    theirs = [jax_assign(payload, halo_w, True)]
    if grid:
        theirs.append(jax_assign(payload, halo_w, False))
    return ours, *theirs


ASSIGN_FUZZ = [
    pytest.param(dict(seed=21, size=2048), 8, id="fuzz-2048-8"),
    pytest.param(dict(seed=22, size=2048, svtypes=(1, 4)), 4, id="del-bnd-2048-4"),
    pytest.param(dict(seed=23, size=1024, fill=0.97), 8, id="fuzz-1024-full-8"),
]


@pytest.mark.parametrize("kw,n_dev", ASSIGN_FUZZ)
def test_sharded_assign_matches_jax_on_fuzz_payloads(kw, n_dev, monkeypatch, capsys):
    pack = trimmed_fuzz(**kw)
    payload = tdc.pack_mesh_payload(pack, n_dev)
    assert all(np.array_equal(payload[k], v)
               for k, v in jdc.pack_mesh_payload(pack, n_dev).items())
    masks, sweep = [], tc.merge_sweep

    def recorded(inputs, state, **params):
        masks.append(int(inputs["head_mask"][0]))
        return sweep(inputs, state, **params)
    monkeypatch.setattr(tc, "merge_sweep", recorded)
    grid_differs = 0
    for w in (tdc.MESH_HALO_BP, 2 * tdc.MESH_HALO_BP):
        ours, theirs, grid = assign_both(payload, w, grid=True)
        assert ours["rows"].tolist() == theirs["rows"].tolist(), w
        assert ours["halo_overflow"].tolist() == theirs["halo_overflow"].tolist(), w
        if not ours["halo_overflow"].any():
            # exactly once: every signature in one owned cluster
            assert ours["rows"][:, 2].sum() == len(pack[2])
        grid_differs += not np.array_equal(grid["rows"], theirs["rows"])
    # shards hold some svtypes' task-global heads and not others'
    assert len(masks) == 2 * n_dev and any(m not in (0, 0xFF) for m in masks), masks
    with capsys.disabled():
        print(f"\n[test_torch_mesh] {kw}: JAX grid vs sequential mesh rows differ at "
              f"{grid_differs} of 2 widths")


# tests/test_tpu_mesh.py's providers, as (pos, svtype, svlen) lead specs


def wide_specs(span_bp=14_000, far_pos=800_000):
    specs = [(b + off, "DEL", -200) for b in range(20_000, 20_000 + span_bp, 100)
             for off in (5, 35, 65)]
    return specs + [(far_pos + k, "DEL", -500) for k in range(4)]


def head_freeze_specs():
    specs = [(20_000 + o, "INS", 150) for o in (0, 1, 2, 3)]
    specs += [(600_000 + o, "DEL", -200) for o in (0, 0, 99, 99)]       # c0 spread
    specs += [(600_250 + o, "DEL", -200) for o in (0, 0, 1, 1)]         # c1 tight
    specs += [(600_300 + o, "DEL", -200) for o in (0, 0, 99, 99)]       # c2 spread
    specs += [(900_000 + o, "DEL", -500) for o in (0, 1, 2, 3)]         # span stretch
    return specs


def sender_span_specs():
    specs = [(500 + o, "DEL", -300) for o in (0, 1, 2, 3)]
    for lo, hi in ((28_000, 31_100), (32_300, 36_400)):
        specs += [(b + off, "DEL", -200) for b in range(lo, hi, 100) for off in (5, 35, 65)]
    return specs + [(79_500 + o, "DEL", -500) for o in (0, 1, 2, 3)]


PROVIDERS = {
    "wide-14kb": (wide_specs, 8),
    "wide-50kb": (lambda: wide_specs(50_000, far_pos=160_000), 8),
    "head-freeze": (head_freeze_specs, 8),
    "sender-span": (sender_span_specs, 2),
}


def provider(lead_provider_class, lead_class, config, specs):
    prov = lead_provider_class(config, 0, "chr1")
    for i, (pos, svtype, svlen) in enumerate(specs):
        prov.record_lead(lead_class(read_id=i, read_qname=f"r{i}", contig="chr1",
                                    ref_start=pos, ref_end=pos, qry_start=0, qry_end=0,
                                    strand="+", mapq=40, nm=0.0, source="INLINE",
                                    svtype=svtype, svlen=svlen),
                         pos // config.cluster_binsize * config.cluster_binsize)
    prov.start, prov.end = 0, 1_000_000
    return prov


@pytest.mark.parametrize("name", list(PROVIDERS))
def test_sharded_assign_matches_jax_on_provider_payloads(name):
    from sniffles_tpu.config import SnifflesConfig as JaxConfig
    from sniffles_tpu.leads import Lead as JaxLead, LeadProvider as JaxProvider
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import Lead, LeadProvider
    specs, n_dev = PROVIDERS[name]
    config = SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf")
    payload = tdc.pack_mesh_payload(
        tdc.pack_task_batch(provider(LeadProvider, Lead, config, specs()), config, None), n_dev)
    jconfig = JaxConfig("--input", "x.bam", "--vcf", "y.vcf")
    jpack = jdc.pack_task_batch(provider(JaxProvider, JaxLead, jconfig, specs()), jconfig, None)
    assert all(np.array_equal(payload[k], v)
               for k, v in jdc.pack_mesh_payload(jpack, n_dev).items())
    flags = []
    for w in (tdc.MESH_HALO_BP, 2 * tdc.MESH_HALO_BP):
        ours, theirs = assign_both(payload, w)
        assert ours["rows"].tolist() == theirs["rows"].tolist(), w
        assert ours["halo_overflow"].tolist() == theirs["halo_overflow"].tolist(), w
        flags.append(bool(ours["halo_overflow"].any()))
    # the wide and sender-span chains overflow at W; the sender's check
    # flags the span (test_mesh_sender_span_overflow_forces_retry)
    if name in ("wide-14kb", "wide-50kb", "sender-span"):
        assert flags[0]


# ---------------------------------------------------------------------------
# the combine step


def test_mesh_combine_halo_case_matches_jax():
    """tests/test_mesh.py::test_combine_halo_exchange_matches_single_device's
    candidates: the port's sharded step == the JAX step in every output,
    and its owned groups == single-device group_candidates'."""
    n_dev, per_dev, window = 8, 128, 50_000
    total = per_dev * n_dev
    rng = np.random.default_rng(5)
    pos, svlen, svtype = (np.zeros(total, dtype=np.int32) for _ in range(3))
    slot = [s * per_dev for s in range(n_dev)]

    def add(shard, p, ln, ty, n_c):
        for _ in range(n_c):
            i = slot[shard]
            pos[i] = p + int(rng.integers(-10, 11))
            svlen[i] = ln + int(rng.integers(-2, 3))
            svtype[i] = ty
            slot[shard] += 1

    for s in range(n_dev):
        for c in range(6):
            add(s, s * window + 4_000 + c * 7_000, int(rng.integers(60, 900)),
                int(rng.integers(0, 4)), int(rng.integers(3, 8)))
    for b, ty in ((1, 0), (3, 1), (6, 2)):
        ln = int(rng.integers(80, 400))
        add(b - 1, b * window - 30, ln, ty, 4)
        add(b, b * window + 30, ln, ty, 4)
    valid = np.zeros(total, dtype=bool)
    for s in range(n_dev):
        valid[s * per_dev:slot[s]] = True
    cand = {"pos": pos, "svlen": svlen, "svtype": svtype,
            "sample_id": rng.integers(0, 6, size=total).astype(np.int32),
            "support": rng.integers(3, 30, size=total).astype(np.int32),
            "qc": np.ones(total, dtype=bool), "valid": valid}
    offs = np.arange(n_dev, dtype=np.int32) * window
    wlen = np.full(n_dev, window, dtype=np.int32)
    ours, theirs = combine_both(cand, offs, wlen, 2000, halo_slots=64)
    assert not ours["halo_overflow"].any()
    assert ours["global_candidates"].tolist() == [int(valid.sum())] * n_dev

    def records(o, n_shards):
        per = o["group_valid"].shape[0] // n_shards
        recs = []
        for s in range(n_shards):
            sl = slice(s * per, (s + 1) * per)
            gid = o["group_id"][sl]
            for i in np.nonzero(o["group_valid"][sl])[0]:
                head = int(np.searchsorted(gid, i))
                recs.append((int(o["svtype"][sl][head]),) + tuple(
                    int(o[k][sl][i]) for k in ("group_pos", "group_svlen", "group_count",
                                               "group_sample_count")))
        return sorted(recs)

    single = {k: v.numpy() for k, v in tcg.group_candidates(
        {k: torch.from_numpy(v) for k, v in cand.items()}, 250.0, 1000.0).items()}
    single["group_valid"] = np.arange(total) < single["n_groups"]
    assert records(ours, n_dev) == records(single, 1)


def combine_both(cand, offs, wlen, w, n_dev=8, **kw):
    """build_sharded_combine_step's output of the port and of the JAX
    package; every output key equal (the float32 mean by its bits)."""
    halo_w = np.full(n_dev, w, dtype=np.int32)
    ours = tmesh.build_sharded_combine_step(["cpu"] * n_dev, **kw)(cand, offs, wlen, halo_w)
    key = ("combine", n_dev, tuple(sorted(kw.items())))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jmesh.build_sharded_combine_step(jmesh.make_genome_mesh(n_dev), **kw)
    theirs = jax.device_get(_JAX_STEPS[key]({k: jnp.asarray(v) for k, v in cand.items()},
                                 jnp.asarray(offs), jnp.asarray(wlen), jnp.asarray(halo_w)))
    same_outputs(ours, theirs)
    return ours, theirs


@pytest.mark.parametrize("binsize", [100, 400])
def test_mesh_combine_sentinel_case_matches_jax(binsize):
    """tests/test_tpu_mesh.py::test_combine_step_sentinel_scales_with_binsize:
    a group 200 bp past the receiver's truncation edge flags overflow at
    binsize 400 and not at 100, in both packages."""
    n_dev, per_dev, window = 8, 64, 50_000
    total = per_dev * n_dev
    pos, svlen = np.zeros(total, dtype=np.int32), np.zeros(total, dtype=np.int32)
    valid = np.zeros(total, dtype=bool)
    slot = [s * per_dev for s in range(n_dev)]

    def add(shard, p, ln=400):
        i = slot[shard]
        pos[i], svlen[i], valid[i] = p, ln, True
        slot[shard] += 1

    for p in range(46_200, 48_101, 500):
        add(0, p)
    add(0, 48_100)
    for s in range(n_dev):
        for p in (s * window + 10_000, s * window + 30_000):
            add(s, p)
            add(s, p + 40)
    cand = {"pos": pos, "svlen": svlen, "svtype": np.zeros(total, dtype=np.int32),
            "sample_id": np.zeros(total, dtype=np.int32),
            "support": np.full(total, 5, dtype=np.int32),
            "qc": np.ones(total, dtype=bool), "valid": valid}
    ours, _ = combine_both(cand, np.arange(n_dev, dtype=np.int32) * window,
                           np.full(n_dev, window, dtype=np.int32), 2000, halo_slots=64,
                           binsize=binsize)
    assert bool(ours["halo_overflow"].any()) == (binsize == 400)


@pytest.fixture(scope="module")
def snf_cohort(tmp_path_factory):
    """Four SNFs written by the port's sim, in a process of their own: in
    this one the JAX package holds the "sniffles.sv" pickle alias."""
    import subprocess
    import sys
    d = str(tmp_path_factory.mktemp("cohort"))
    code = ("import sys; from sniffles_tpu_torch.sim import write_cohort; "
            "print(*write_cohort(sys.argv[1], 4, 77, contigs=(('chr1', 400_000),), "
            "site_gap=(2_000, 6_000)))")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code, d], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.split()


@pytest.mark.parametrize("safe_cut_only", [False, True], ids=["criterion", "safe-cuts"])
def test_mesh_combine_on_snf_tensors_matches_jax(snf_cohort, safe_cut_only):
    """Candidate tensors read from SNF files (combine_tensors) equal the JAX
    package's, and the sharded step over them equals the JAX step's."""
    from sniffles_tpu.config import SnifflesConfig as JaxConfig
    from sniffles_tpu.parallel import combine_tensors as jct
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.parallel import combine_tensors as tct
    config = SnifflesConfig("--input", "x.snf", "--vcf", "y.vcf")
    cand = tct.snf_candidate_tensors(snf_cohort, "chr1", config,
                                     support_threshold=config.combine_support_threshold)
    jcand = jct.snf_candidate_tensors(snf_cohort, "chr1", JaxConfig("--input", "x.snf",
                                                                    "--vcf", "y.vcf"),
                                      support_threshold=config.combine_support_threshold)
    same_outputs(cand, jcand)
    assert len(cand["pos"]) > 100
    sharded, offs, wlen = tct.shard_candidate_tensors(cand, 8)
    jsharded, joffs, jwlen = jct.shard_candidate_tensors(jcand, 8)
    same_outputs(sharded, jsharded)
    assert offs.tolist() == joffs.tolist() and wlen.tolist() == jwlen.tolist()
    ours, _ = combine_both(sharded, offs, wlen, 2000, combine_match=250.0,
                           combine_match_max=1000.0, safe_cut_only=safe_cut_only)
    assert not ours["halo_overflow"].any()


# ---------------------------------------------------------------------------
# device_clusters (tests/test_tpu_mesh.py:133-292)


def cluster_records(clusters):
    return [(c.id, c.svtype, [ld.read_qname for ld in c.leads], c.engine) for c in clusters]


def both_device_clusters(specs, n_dev):
    """device_clusters of the port (mesh and single device) and of the JAX
    package (mesh) on one provider's leads."""
    from sniffles_tpu.config import SnifflesConfig as JaxConfig
    from sniffles_tpu.leads import Lead as JaxLead, LeadProvider as JaxProvider
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import Lead, LeadProvider
    config = SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf")
    config.device = "cpu"
    single = tdc.device_clusters(provider(LeadProvider, Lead, config, specs), config, None)
    config.tpu_mesh = n_dev
    counters = {}
    mesh = tdc.device_clusters(provider(LeadProvider, Lead, config, specs), config, None,
                               counters=counters)
    jconfig = JaxConfig("--input", "x.bam", "--vcf", "y.vcf")
    jconfig.tpu_call, jconfig.tpu_mesh = True, n_dev
    jmesh_out = list(jdc.device_clusters(provider(JaxProvider, JaxLead, jconfig, specs),
                                         jconfig, None))
    return single, mesh, jmesh_out, counters


def keyset(clusters):
    return sorted((c.svtype, tuple(sorted(ld.read_qname for ld in c.leads))) for c in clusters)


def test_mesh_wide_cluster_retries_with_doubled_halo(jax_sequential):
    single, mesh, theirs, counters = both_device_clusters(wide_specs(), 8)
    assert cluster_records(mesh) == cluster_records(theirs)
    assert keyset(mesh) == keyset(single) and len(mesh) >= 1
    assert counters["mesh_tasks"] == 1


def test_mesh_overflow_exhausted_raises_and_the_task_takes_the_host_sweep(jax_sequential):
    """A cluster wider than the last admissible W: the JAX package raises
    ("halo overflow"), the port raises MeshHaloOverflow, and a call task's
    _iter_clusters takes the exact host sweep for it, counted as
    mesh_seam_host; any other device error propagates."""
    from sniffles_tpu.config import SnifflesConfig as JaxConfig
    from sniffles_tpu.leads import Lead as JaxLead, LeadProvider as JaxProvider
    from sniffles_tpu_torch import cluster
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import Lead, LeadProvider
    from sniffles_tpu_torch.pipeline.tasks import CallTask
    max_w = tdc.MESH_HALO_BP * 2 ** (tdc.MESH_HALO_RETRIES - 1)
    specs = wide_specs(2 * max_w + 10_000, far_pos=160_000)
    jconfig = JaxConfig("--input", "x.bam", "--vcf", "y.vcf")
    jconfig.tpu_call, jconfig.tpu_mesh = True, 8
    with pytest.raises(RuntimeError, match="halo overflow"):
        list(jdc.device_clusters(provider(JaxProvider, JaxLead, jconfig, specs), jconfig, None))

    config = SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf")
    config.device, config.tpu_mesh = "cpu", 8
    with pytest.raises(tdc.MeshHaloOverflow, match="halo overflow"):
        tdc.device_clusters(provider(LeadProvider, Lead, config, specs), config, None)

    task = CallTask(contig="chr1", start=0, end=1_000_000, id=0, sv_id=0, config=config)
    task.lead_provider = provider(LeadProvider, Lead, config, specs)
    ids = [c.id for c in task._iter_clusters(config)]
    assert task.engine_counters == {"mesh_seam_host": 1}
    host = provider(LeadProvider, Lead, config, specs)
    assert ids == [c.id for t in ("DEL",) for c in cluster.resolve(t, host, config, None)]

    def broken(payload, meta):
        raise RuntimeError("the mesh step is broken for the test")
    task = CallTask(contig="chr1", start=0, end=1_000_000, id=1, sv_id=0, config=config)
    task.lead_provider = provider(LeadProvider, Lead, config, specs)
    original, tdc.run_mesh_assign = tdc.run_mesh_assign, broken
    try:
        with pytest.raises(RuntimeError, match="broken for the test"):
            list(task._iter_clusters(config))
    finally:
        tdc.run_mesh_assign = original


def test_mesh_head_freeze_applies_off_shard_zero(jax_sequential):
    single, mesh, theirs, _ = both_device_clusters(head_freeze_specs(), 8)
    assert cluster_records(mesh) == cluster_records(theirs)
    assert keyset(mesh) == keyset(single)
    keys = keyset(single)
    assert ("DEL", ("r10", "r11", "r12", "r13", "r14", "r15", "r8", "r9")) in keys
    assert ("DEL", ("r4", "r5", "r6", "r7")) in keys


def test_mesh_sender_span_overflow_forces_retry(jax_sequential):
    single, mesh, theirs, _ = both_device_clusters(sender_span_specs(), 2)
    assert cluster_records(mesh) == cluster_records(theirs)
    assert keyset(mesh) == keyset(single)
    assert len([k for k in keyset(single) if len(k[1]) > 200]) == 1


# ---------------------------------------------------------------------------
# the fused engine's sharded step (build_sharded_step) on 4 shards

STEP_SHARDS = 4
# the global means are float32 reductions in XLA's order on the JAX side
# and float64 sums rounded once here: equal within 2^-20 relative
MEAN_RTOL = 2.0 ** -20


def planted_step_case(per_dev, cov_per_dev, seed, straddle_types):
    """tests/test_mesh.py::_planted_shard_batch on STEP_SHARDS shards:
    interior clusters of mixed svtypes on every shard, and a straddling
    cluster of each requested svtype at successive shard boundaries; NM
    values drawn from the seed."""
    n_dev = STEP_SHARDS
    rng = np.random.default_rng(seed)
    total = per_dev * n_dev
    sig = {k: np.zeros(total, dtype=np.int32) for k in ("pos", "svlen", "svtype", "read_id")}
    sig["strand"] = np.ones(total, dtype=np.int32)
    sig["mapq"] = np.full(total, 60, dtype=np.int32)
    sig["nm"] = np.zeros(total, dtype=np.float32)
    for k in ("repeat", "sa", "valid"):
        sig[k] = np.zeros(total, dtype=bool)
    next_slot = [s * per_dev for s in range(n_dev)]

    def add(shard, pos, svlen, svtype, n_sig):
        for _ in range(n_sig):
            i = next_slot[shard]
            sig["pos"][i] = pos + int(rng.integers(-12, 13))
            sig["svlen"][i] = svlen + int(rng.integers(-3, 4))
            sig["svtype"][i] = svtype
            sig["read_id"][i] = i + 1
            sig["strand"][i] = int(rng.choice((-1, 1)))
            sig["mapq"][i] = int(rng.integers(30, 60))
            sig["nm"][i] = rng.random() * 0.05
            sig["sa"][i] = rng.random() < 0.3
            sig["valid"][i] = True
            next_slot[shard] += 1

    for s in range(n_dev):
        for c in range(3):
            pos = s * cov_per_dev + 8_000 + c * 15_000 + int(rng.integers(0, 4_000))
            svtype = int(rng.integers(0, 4))
            add(s, pos, int(rng.integers(60, 1500)) * (-1 if svtype == 1 else 1), svtype,
                int(rng.integers(4, 9)))
    for b, svtype in enumerate(straddle_types):
        right = b % (n_dev - 1) + 1
        svlen = int(rng.integers(80, 900)) * (-1 if svtype == 1 else 1)
        add(right - 1, right * cov_per_dev - 40, svlen, svtype, 5)
        add(right, right * cov_per_dev + 40, svlen, svtype, 5)
    return sig


def straddling_step_case(per_dev):
    """tests/test_mesh.py's 20-signature INS cluster split 10/10 across the
    first shard boundary."""
    total = per_dev * STEP_SHARDS
    sig = {k: np.zeros(total, dtype=np.int32) for k in ("pos", "svlen", "svtype", "mapq")}
    sig["read_id"] = np.arange(total, dtype=np.int32)
    sig["strand"] = np.ones(total, dtype=np.int32)
    sig["mapq"][:] = 60
    sig["nm"] = np.zeros(total, dtype=np.float32)
    for k in ("repeat", "sa", "valid"):
        sig[k] = np.zeros(total, dtype=bool)
    for i in range(10):
        for j, p in ((i, 65400 + i), (per_dev + i, 65560 + i)):
            sig["pos"][j], sig["svlen"][j], sig["valid"][j] = p, 100, True
    return sig


@pytest.fixture(scope="module")
def jax_step_mesh():
    if len(jax.devices()) < STEP_SHARDS:
        pytest.skip("needs 4 virtual devices")
    return jmesh.make_genome_mesh(STEP_SHARDS)


STEP_CASES = {"planted-3": (128, 3), "planted-17": (128, 17), "planted-99": (128, 99),
              "straddling": (64, None)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_matches_jax(case, jax_step_mesh):
    from sniffles_tpu.parallel.engine import default_params as jax_default_params
    from sniffles_tpu_torch.parallel.engine import default_params
    per_dev, seed = STEP_CASES[case]
    cov_per_dev = 65536
    sig = (planted_step_case(per_dev, cov_per_dev, seed, [0, 1, 2, 3, 4, 0, 1, 4, 2, 3])
           if seed is not None else straddling_step_case(per_dev))
    sig = tmesh.shard_batch(sig, STEP_SHARDS)
    coverage = np.full(cov_per_dev * STEP_SHARDS, 25, dtype=np.int32)
    coverage[cov_per_dev - 3000:cov_per_dev + 500] = 31
    offs = np.arange(STEP_SHARDS, dtype=np.int32) * cov_per_dev
    halo_slots = 128 if seed is not None else 64
    key = ("step", STEP_SHARDS, halo_slots)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jmesh.build_sharded_step(jax_step_mesh, jax_default_params(),
                                                   halo_bp=5000, halo_slots=halo_slots)
    theirs = _JAX_STEPS[key]({k: jnp.asarray(v) for k, v in sig.items()},
                             jnp.asarray(coverage), jnp.asarray(offs))
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    info = {}
    ours = tmesh.build_sharded_step(["cpu"] * STEP_SHARDS, default_params(), halo_bp=5000,
                                    halo_slots=halo_slots)(sig, coverage, offs, info=info)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if k in ("coverage_global", "nm_global"):
            np.testing.assert_allclose(ours[k], v, rtol=MEAN_RTOL, atol=0)
        elif v.dtype == np.float32:
            assert ours[k].view(np.int32).tolist() == v.view(np.int32).tolist(), k
        else:
            assert ours[k].dtype == v.dtype and ours[k].tolist() == v.tolist(), k
    assert not ours["halo_overflow"].any()
    assert len(info["merge_rounds"]) == STEP_SHARDS
    if seed is None:
        # emitted once, with the full union's 20 reads
        owned = np.nonzero(ours["cluster_valid"])[0]
        assert len(owned) == 1 and ours["support"][owned[0]] == 20


def test_sharded_step_reports_a_halo_overflow(jax_step_mesh):
    """More halo signatures than slots: JAX's and the port's flags agree."""
    from sniffles_tpu.parallel.engine import default_params as jax_default_params
    from sniffles_tpu_torch.parallel.engine import default_params
    sig = planted_step_case(128, 65536, 5, [0, 1, 2, 3, 4, 0, 1, 4, 2, 3])
    coverage = np.full(65536 * STEP_SHARDS, 25, dtype=np.int32)
    offs = np.arange(STEP_SHARDS, dtype=np.int32) * 65536
    step = jmesh.build_sharded_step(jax_step_mesh, jax_default_params(), halo_bp=5000,
                                    halo_slots=4)
    theirs = np.asarray(step({k: jnp.asarray(v) for k, v in sig.items()},
                             jnp.asarray(coverage), jnp.asarray(offs))["halo_overflow"])
    ours = tmesh.build_sharded_step(["cpu"] * STEP_SHARDS, default_params(), halo_bp=5000,
                                    halo_slots=4)(sig, coverage, offs)["halo_overflow"]
    assert theirs.any() and ours.tolist() == theirs.tolist()


# ---------------------------------------------------------------------------
# placement and the service


def test_mesh_devices_places_or_refuses(monkeypatch):
    assert tmesh.mesh_devices(4) == ["cpu"] * 4
    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU")
    monkeypatch.delenv(tmesh.ENV_MESH_DEVICES, raising=False)
    visible = torch.cuda.device_count()
    if visible < 8:
        with pytest.raises(RuntimeError, match=f"--tpu-mesh 8 needs 8 devices, but {visible} "
                                               f"card.*{tmesh.ENV_MESH_DEVICES}"):
            tmesh.mesh_devices(8)
    monkeypatch.setenv(tmesh.ENV_MESH_DEVICES, "cuda:0,cuda:0")
    with pytest.raises(RuntimeError, match="names 2 device"):
        tmesh.mesh_devices(3)
    if visible == 0:
        with pytest.raises(RuntimeError, match="card"):
            tmesh.mesh_devices(2)
    with pytest.raises(ValueError):
        tmesh.mesh_devices(1)


def test_cli_refuses_a_mesh_it_cannot_place(tmp_path, monkeypatch, capsys):
    """Before any task: exit 1 and a message naming N, the cards visible
    and the variable; no VCF."""
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset
    bam, fa = write_dataset(str(tmp_path), ref_len=40_000, depth=4, read_len=8_000, seed=4,
                            svs=[PlantedSV(pos=20_000, svtype="DEL", svlen=200)])
    monkeypatch.setenv(tmesh.ENV_MESH_DEVICES, "cuda:0,cuda:0,cuda:0")
    out = tmp_path / "o.vcf"
    assert cli.main(["--input", bam, "--reference", fa, "--vcf", str(out), "--threads", "0",
                     "--tpu-mesh", "2"]) == 0
    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    os.unlink(out)
    assert cli.main(["--input", bam, "--reference", fa, "--vcf", str(out), "--threads", "0",
                     "--tpu-mesh", "2"]) == 1
    err = capsys.readouterr().err
    assert "--tpu-mesh 2" in err and tmesh.ENV_MESH_DEVICES in err
    assert not out.exists()
