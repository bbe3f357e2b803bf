"""The port's fused calling engine (sniffles_tpu_torch/parallel/engine.py)
and the modules under it against the JAX package's, on the same numpy
inputs made from a seed, on the CPU (SNIFFLES_TPU_FORCE_CPU; the wrappers
of the two kernels, ops/merge_relax.py and ops/candidate_tail.py, take
their plain versions there):

  * synthetic_batch byte for byte; from_leads field for field, read ids as
    a partition (the JAX package hashes names with Python's salted hash);
  * coverage_from_intervals, annotate_coverage, genotype_batch (the grid of
    tests/test_device_genotype.py, a long INS, the DUP VAF override, both
    underflow branches, the DEL support_sa case), the log10 constants and
    qc_batch over flag sets that together produce every FILTERS code;
  * cluster_signatures(exact_sweep=False) on synthetic seeds, the merge
    cascade of tests/test_device_cluster.py, a chain of 36 links (the
    32-round cap binds; sim.relax_chain_positions), BND chains and
    repeat-flagged segments;
  * call_pipeline_step on tests/test_device_cluster.py's two batches at
    the default parameters, with --mosaic and with --minsupport auto.

Tolerance: 0. Integer outputs are compared bit for bit, float32 outputs by
their bits, against the JAX functions as jitted (XLA's CPU code fuses a
multiply into an add where eager JAX does not; the port follows the
jitted arithmetic)."""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu import signatures as jsig  # noqa: E402
from sniffles_tpu.ops import clustering as jcl  # noqa: E402
from sniffles_tpu.ops import coverage as jcov  # noqa: E402
from sniffles_tpu.ops import genotype_batch as jgt  # noqa: E402
from sniffles_tpu.ops import qc_batch as jqc  # noqa: E402
from sniffles_tpu.parallel import engine as jeng  # noqa: E402
from sniffles_tpu_torch import signatures as tsig  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tcl  # noqa: E402
from sniffles_tpu_torch.ops import coverage as tcov  # noqa: E402
from sniffles_tpu_torch.ops import genotype_batch as tgt  # noqa: E402
from sniffles_tpu_torch.ops import merge_relax as tmr  # noqa: E402
from sniffles_tpu_torch.ops import qc_batch as tqc  # noqa: E402
from sniffles_tpu_torch.parallel import engine as teng  # noqa: E402
from sniffles_tpu_torch.sim import relax_chain_positions  # noqa: E402

SVTYPE = {name: i for i, name in enumerate(jcl.SVTYPE_NAMES)}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one torch thread, beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfg(**kw):
    return types.SimpleNamespace(**kw)


# flag sets of the CLI, as default_params sees them
FLAG_SETS = {
    "default": None,
    "mosaic": cfg(mosaic=True),
    "minsupport-auto": cfg(minsupport="auto"),
    "auto-qc-nm": cfg(minsupport="auto", qc_nm=True, qc_nm_threshold=0.02),
    "qc-strand": cfg(qc_strand=True, genotype_error=0.1, genotype_ploidy=3),
}


def same(ours, theirs, label=""):
    """Bit-for-bit equality of a torch tensor and a JAX/numpy array."""
    a = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    b = np.asarray(theirs)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    assert a.dtype == b.dtype, (label, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    bad = np.nonzero(a != b)[0]
    assert bad.size == 0, (label, bad.size, bad[:5], a[bad[:5]], b[bad[:5]])


def same_dicts(ours: dict, theirs: dict, skip=()):
    assert set(ours) - set(skip) == set(theirs) - set(skip), set(ours) ^ set(theirs)
    for k in theirs:
        if k not in skip:
            same(ours[k], theirs[k], k)


# -- signatures --------------------------------------------------------------

@pytest.mark.parametrize("args", [(3000, 50, 5, 5_000_000, 4096), (2000, 40, 9, 8_000_000, 2048),
                                  (4096, 64, 7, 900_000, None), (100, 3, 1, 20_000, None)])
def test_synthetic_batch_matches_jax_byte_for_byte(args):
    n, ncl, seed, span, bs = args
    ours = tsig.synthetic_batch(n, ncl, seed=seed, genome_span=span, batch_size=bs).as_dict()
    theirs = jsig.synthetic_batch(n, ncl, seed=seed, genome_span=span, batch_size=bs).as_dict()
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k


def test_from_leads_matches_jax_but_for_the_name_hash():
    rng = np.random.default_rng(4)
    names = [f"read{i}" for i in range(40)]
    leads = [types.SimpleNamespace(
        ref_start=int(rng.integers(0, 90_000)), svlen=None if i % 17 == 5 else int(
            rng.integers(-900, 900)), svtype=jcl.SVTYPE_NAMES[int(rng.integers(0, 7))],
        read_qname=names[int(rng.integers(0, 40))], strand="+" if i % 3 else "-",
        mapq=None if i % 11 == 0 else int(rng.integers(0, 60)),
        nm=None if i % 7 == 0 else float(rng.random() * 0.1 - 0.01),
        source="INLINE" if i % 4 else "SUPPL") for i in range(150)]
    tr = [(10_000, 20_000), (50_000, 50_500), (85_000, 99_000)]
    ours = tsig.from_leads(leads, tr_regions=tr).as_dict()
    theirs = jsig.from_leads(leads, tr_regions=tr).as_dict()
    for k in theirs:
        if k != "read_id":
            assert ours[k].tobytes() == theirs[k].tobytes(), k
    # read ids: the same partition of the leads (equal names <-> equal ids)
    n = int(theirs["valid"].sum())
    a, b = ours["read_id"][:n], theirs["read_id"][:n]
    assert len(set(zip(a, b))) == len(set(a)) == len(set(b))
    assert ours["read_id"][n:].tolist() == theirs["read_id"][n:].tolist()


# -- coverage ----------------------------------------------------------------

def test_coverage_from_intervals_matches_jax():
    rng = np.random.default_rng(1)
    n, length = 3000, 5000
    starts = rng.integers(-200, length + 200, n).astype(np.int32)
    ends = (starts + rng.integers(0, 800, n)).astype(np.int32)
    starts[:50] = starts[50:100]            # repeated indices
    valid = rng.random(n) < 0.85
    ours = tcov.coverage_from_intervals(torch.from_numpy(starts), torch.from_numpy(ends),
                                        torch.from_numpy(valid), length)
    theirs = jcov.coverage_from_intervals(jnp.asarray(starts), jnp.asarray(ends),
                                          jnp.asarray(valid), length)
    same(ours, theirs)


def annotate_case(seed, n=4096):
    rng = np.random.default_rng(seed)
    svtype = rng.integers(0, 7, n).astype(np.int32)
    pos = rng.integers(-2_000, 60_000, n).astype(np.int32)
    svlen = rng.integers(-30_000, 30_000, n).astype(np.int32)
    # int32 extremes: start + |svlen| and the probes wrap
    pos[:8] = [2 ** 31 - 1, 2 ** 31 - 300, -2 ** 31, -2 ** 31 + 100, 0, 1, 499, 50_000]
    svlen[:8] = [5, -(2 ** 31), 2 ** 31 - 1, 7, -(2 ** 31), 3, 1, 2 ** 31 - 1]
    bnd_first = rng.random(n) < 0.5
    return svtype, pos, svlen, bnd_first


@pytest.mark.parametrize("region_offset", [0, 1_234, -700])
def test_annotate_coverage_matches_jax(region_offset):
    rng = np.random.default_rng(2)
    cov = rng.integers(0, 90, 50_000).astype(np.int32)
    svtype, pos, svlen, bnd_first = annotate_case(3)
    ours = tcov.annotate_coverage(torch.from_numpy(cov), *(torch.from_numpy(a) for a in (
        svtype, pos, svlen, bnd_first)), region_offset=region_offset)
    theirs = jcov.annotate_coverage(jnp.asarray(cov), *(jnp.asarray(a) for a in (
        svtype, pos, svlen, bnd_first)), region_offset=region_offset)
    same_dicts(ours, theirs)


# -- genotyping --------------------------------------------------------------

def genotype_cases():
    """tests/test_device_genotype.py's grid for INS/DEL/DUP/INV, a long INS,
    DUPs over the VAF override threshold, both underflow branches (support
    near coverage at 250 reads and above), DELs with support_sa, and
    random cases (all svtypes, zero coverage points)."""
    rows = []
    for t in ("INS", "DEL", "DUP", "INV"):
        svlen = -120 if t == "DEL" else 120
        for s in (1, 3, 5, 10, 20, 35, 60, 200, 300):
            for c in (5, 10, 30, 60, 250, 400):
                rows.append((SVTYPE[t], svlen, s, (c,) * 5, 0))
    rows += [(SVTYPE["INS"], 5000, 10, (30,) * 5, 0), (SVTYPE["INS"], 25_000, 40, (30,) * 5, 0)]
    rows += [(SVTYPE["DUP"], 800, s, (0, 40, 0, 40, 0), 0) for s in (7, 8, 9, 30)]
    rows += [(SVTYPE["DEL"], -500, s, (c,) * 5, 0) for s in (250, 600, 1000)
             for c in (250, 600, 1000)]
    rows += [(SVTYPE["DEL"], -300, 6, (30,) * 5, sa) for sa in (1, 6, 30)]
    rng = np.random.default_rng(8)
    for _ in range(600):
        covs = tuple(int(v) if rng.random() > 0.15 else 0 for v in rng.integers(0, 500, 5))
        rows.append((int(rng.integers(0, 7)), int(rng.integers(-60_000, 60_000)),
                     int(rng.integers(0, 700)), covs, int(rng.integers(0, 20) * (rng.random() < 0.4))))
    svtype = np.array([r[0] for r in rows], dtype=np.int32)
    svlen = np.array([r[1] for r in rows], dtype=np.int32)
    support = np.array([r[2] for r in rows], dtype=np.int32)
    covs = [np.array([r[3][j] for r in rows], dtype=np.int32) for j in range(5)]
    sa = np.array([r[4] for r in rows], dtype=np.int32)
    return svtype, svlen, support, covs, sa


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_genotype_batch_matches_jax(flags):
    params = jeng.default_params(FLAG_SETS[flags])
    svtype, svlen, support, covs, sa = genotype_cases()
    ours = tgt.genotype_batch(*(torch.from_numpy(a) for a in (svtype, svlen, support, *covs)),
                              support_sa=torch.from_numpy(sa), params=params)
    theirs = jgt.genotype_batch(*(jnp.asarray(a) for a in (svtype, svlen, support, *covs)),
                                support_sa=jnp.asarray(sa), params=params)
    same_dicts(ours, theirs)


@pytest.mark.parametrize("err,ploidy", [(0.05, 2), (0.1, 3), (0.01, 1), (0.02, 4)])
def test_log10_constants_match_jax(err, ploidy):
    f = jax.jit(lambda e, pl: [jnp.log10(p) for p in (
        e, 1.0 - e, 1.0 / pl, 1.0 - 1.0 / pl, 1.0 - (1.0 - e))])
    theirs = [np.float32(v) for v in f(jnp.float32(err), jnp.float32(ploidy))]
    het = np.float32(np.float32(1.0) / np.float32(ploidy))
    ours = tgt.log10_constants(np.float32(err), het)
    assert [v.view(np.int32) for v in ours] == [v.view(np.int32) for v in theirs]


def test_xla_log_matches_jax_log():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(20_000, dtype=np.float32),
                        rng.random(2_000, dtype=np.float32) * 1e-30,
                        np.float32([0.0, 1.0, 0.5, 2.0, 1e30, np.inf, 1e-40])])
    same(tgt.xla_log_f32(torch.from_numpy(x)), jax.jit(jnp.log)(jnp.asarray(x)))


# -- QC ----------------------------------------------------------------------

def qc_case(seed=5):
    svtype, svlen, support, covs, sa = genotype_cases()
    n = svtype.shape[0]
    rng = np.random.default_rng(seed)
    # long DELs and DUPs with central coverage changes (COV_CHANGE_*)
    k = 80
    svtype[:k] = np.where(np.arange(k) % 2 == 0, SVTYPE["DEL"], SVTYPE["DUP"])
    svlen[:k] = np.where(svtype[:k] == SVTYPE["DEL"], -1, 1) * rng.integers(50_000, 150_000, k)
    covs[2][:k] = rng.integers(0, 80, k)
    stats = {
        "svtype": svtype, "svlen": svlen, "support": support,
        "stdev_pos": (rng.random(n) * 60).astype(np.float32),
        "stdev_len": np.where(rng.random(n) < 0.4, 0.0, rng.random(n) * 40).astype(np.float32),
        "n_strands": rng.integers(0, 3, n).astype(np.int32),
        "nm": (rng.random(n) * 0.05).astype(np.float32),
    }
    # the stdev filters (one candidate each), and long INS with a high NM
    # that pass every check before ALN_NM under --qc-nm
    stats["stdev_pos"][-1] = 600.0
    stats["stdev_pos"][-2], stats["stdev_len"][-2], svlen[-2] = 10.0, 300.0, 120
    for j in range(3, 7):
        svtype[-j], svlen[-j], support[-j] = SVTYPE["INS"], 3000, 20
        stats["stdev_pos"][-j], stats["stdev_len"][-j] = 5.0, 2.0
        stats["n_strands"][-j], stats["nm"][-j], sa[-j] = 2, 0.049, 0
        for c in covs:
            c[-j] = 300
    stats.update(zip(("coverage_upstream", "coverage_start", "coverage_center",
                      "coverage_end", "coverage_downstream"), covs))
    return stats, sa


@pytest.fixture(scope="module")
def qc_codes():
    """Every flag set's filter codes, ours and JAX's (computed once)."""
    stats, sa = qc_case()
    out = {}
    for flags, c in FLAG_SETS.items():
        params = jeng.default_params(c)
        params["coverage_global"] = 27.3
        jstats = {k: jnp.asarray(v) for k, v in stats.items()}
        gt = jgt.genotype_batch(jstats["svtype"], jstats["svlen"], jstats["support"],
                                jstats["coverage_upstream"], jstats["coverage_start"],
                                jstats["coverage_center"], jstats["coverage_end"],
                                jstats["coverage_downstream"], support_sa=jnp.asarray(sa),
                                params=params)
        theirs = jqc.qc_batch(jstats, gt, params)
        ours = tqc.qc_batch({k: torch.from_numpy(v) for k, v in stats.items()},
                            {k: torch.from_numpy(np.asarray(v)) for k, v in gt.items()}, params)
        out[flags] = (ours, theirs)
    return out


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_qc_batch_matches_jax(flags, qc_codes):
    ours, theirs = qc_codes[flags]
    same_dicts(ours, theirs)


def test_qc_cases_produce_every_filter_code(qc_codes):
    """The first-fail order is exercised: across the flag sets every code
    of FILTERS (PASS included) is some candidate's first failure."""
    seen = set()
    for ours, _ in qc_codes.values():
        seen |= set(ours["filter_code"].tolist())
    assert seen == set(range(len(tqc.FILTERS))), sorted(set(range(len(tqc.FILTERS))) - seen)
    assert tqc.FILTERS == jqc.FILTERS and tqc.FILTER_CODES == jqc.FILTER_CODES


# -- the relaxation ----------------------------------------------------------

CLUSTER = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
               cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50)
WIDTH = 4096


def signature_dict(pos, svlen, svtype, repeat=None, size=WIDTH, seed=0):
    rng = np.random.default_rng(seed)
    n = len(pos)
    sig = {k: np.zeros(size, dtype=np.int32) for k in ("pos", "svlen", "svtype", "read_id",
                                                       "mapq")}
    sig["strand"] = np.ones(size, dtype=np.int32)
    sig["nm"] = np.zeros(size, dtype=np.float32)
    for k in ("repeat", "sa", "valid"):
        sig[k] = np.zeros(size, dtype=bool)
    sig["pos"][:n], sig["svlen"][:n], sig["svtype"][:n] = pos, svlen, svtype
    sig["read_id"][:n] = rng.integers(0, 1 << 30, n)
    sig["strand"][:n] = rng.choice([-1, 1], n)
    sig["mapq"][:n] = rng.integers(20, 60, n)
    sig["nm"][:n] = rng.random(n, dtype=np.float32) * 0.05
    sig["sa"][:n] = rng.random(n) < 0.3
    sig["valid"][:n] = True
    if repeat is not None:
        sig["repeat"][:n] = repeat
    return sig


def cascade_sig():
    """tests/test_device_cluster.py::_merge_cascade_positions, INS of one length."""
    pos = []
    for start, width in [(100_000, 400), (100_800, 700), (102_500, 1500), (106_200, 3300),
                         (114_600, 7300)]:
        for p in range(start, start + width + 1, 100):
            pos.extend((p, p))
    return signature_dict(pos, 100, 0), dict(CLUSTER, cluster_repeat_h=0.4,
                                             cluster_merge_bnd=1500, cluster_merge_len=0.33,
                                             minsvlen=35)


def bnd_sig(seed=6):
    """BND chains: runs of breakends 600-1,400 bp apart (cluster_merge_bnd
    is 1000), some of them chained by their sd as well."""
    rng = np.random.default_rng(seed)
    pos, p = [], 50_000
    for _ in range(300):
        p += int(rng.choice([600, 900, 1000, 1100, 1400, 5000]))
        pos.extend((p + rng.integers(-40, 40, int(rng.integers(1, 6)))).tolist())
    pos = sorted(pos)
    return signature_dict(pos, 0, SVTYPE["BND"], seed=seed), CLUSTER


def repeat_sig(seed=7):
    """Segments in tandem repeats (m2: outer span within (|msv| + |msv'|)
    * cluster_repeat_h), long and short svlens, INS and DEL."""
    rng = np.random.default_rng(seed)
    pos, svlen, svtype, rep = [], [], [], []
    p = 20_000
    for _ in range(250):
        p += int(rng.integers(150, 2_500))
        t = int(rng.integers(0, 2))
        L = int(rng.integers(60, 1_200))
        for _ in range(int(rng.integers(1, 8))):
            pos.append(p + int(rng.integers(-60, 60)))
            svlen.append((-1 if t == 1 else 1) * (L + int(rng.integers(-20, 20))))
            svtype.append(t)
        rep.extend([rng.random() < 0.6] * (len(pos) - len(rep)))
    return signature_dict(pos, svlen, svtype, repeat=np.array(rep), seed=seed), \
        dict(CLUSTER, cluster_repeat_h=1.5)


def relax_case(name):
    if name.startswith("synthetic"):
        seed = int(name.split("-")[1])
        b = jsig.synthetic_batch(3000, 60, seed=seed, genome_span=2_000_000, batch_size=WIDTH)
        return b.as_dict(), CLUSTER
    if name == "cascade":
        return cascade_sig()
    if name == "chain36":
        return signature_dict(relax_chain_positions(36), 100, 0), CLUSTER
    if name == "bnd":
        return bnd_sig()
    return repeat_sig()


RELAX_CASES = ["synthetic-1", "synthetic-2", "synthetic-3", "cascade", "chain36", "bnd",
               "repeat"]


@pytest.mark.parametrize("name", RELAX_CASES)
def test_cluster_signatures_relaxation_matches_jax(name):
    sig, kw = relax_case(name)
    theirs = jcl.cluster_signatures({k: jnp.asarray(v) for k, v in sig.items()},
                                    exact_sweep=False, **kw)
    ours = tcl.cluster_signatures({k: torch.from_numpy(v) for k, v in sig.items()},
                                  exact_sweep=False, **kw)
    same_dicts(ours, {k: np.asarray(v) for k, v in theirs.items()}, skip=("merge_rounds",))
    if name == "cascade":
        assert int(ours["n_clusters"]) < 10   # the cascade merges
    if name == "chain36":
        assert ours["merge_rounds"] == tmr.MERGE_ITERS_MAX


def test_relaxation_cap_binds_before_the_fixed_point():
    """On the 36-link chain the 32nd round still merges: the cap stops the
    loop, the boundaries are not a fixed point (one more round merges
    again), and they are JAX's (test above)."""
    sig, kw = relax_case("chain36")
    t = {k: torch.from_numpy(v) for k, v in sig.items()}
    s, boundary, bin_ = tcl.sort_and_seed(t, 100)
    params = dict(cluster_r=kw["cluster_r"], cluster_repeat_h=kw["cluster_repeat_h"],
                  cluster_repeat_h_max=kw["cluster_repeat_h_max"],
                  cluster_merge_bnd=kw["cluster_merge_bnd"], global_repeat=False, binsize=100)
    capped, rounds = tmr.merge_relax(s, boundary, bin_, **params)
    assert rounds == 32
    again = tmr.merge_step_plain(s, capped, bin_, **params)
    assert int(again.sum()) < int(capped.sum())


# -- the whole step ----------------------------------------------------------

STEP_BATCHES = {"b1": ((3000, 50), dict(seed=5, genome_span=5_000_000, batch_size=4096),
                       5_200_000),
                "b2": ((2000, 40), dict(seed=9, genome_span=8_000_000, batch_size=2048),
                       8_200_000)}


@pytest.mark.parametrize("flags", ["default", "mosaic", "minsupport-auto"])
@pytest.mark.parametrize("batch", list(STEP_BATCHES))
def test_call_pipeline_step_matches_jax(batch, flags):
    (n, ncl), kw, cov_len = STEP_BATCHES[batch]
    sig = jsig.synthetic_batch(n, ncl, **kw).as_dict()
    sig["sa"][::7] = True
    coverage = np.full(cov_len, 30, dtype=np.int32)
    coverage[1_000_000:1_200_000] = 0
    params = jeng.default_params(FLAG_SETS[flags])
    theirs = jeng.call_pipeline_step({k: jnp.asarray(v) for k, v in sig.items()},
                                     jnp.asarray(coverage), params)
    info = {}
    ours = teng.call_pipeline_step(sig, coverage, params, info=info)
    same_dicts(ours, {k: np.asarray(v) for k, v in theirs.items()})
    assert info["merge_rounds"] >= 1
    assert ours["coverage"].device.type == "cpu"
