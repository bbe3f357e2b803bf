"""The call statistics (sniffles_tpu_torch/ops/call_stats.py) against the
JAX package's call_statistics (sniffles_tpu/ops/clustering.py:1262), on the
CPU, where the wrapper takes its plain version.

Batches: sniffles_tpu_torch.sim.call_stats_batch, seeded numpy, in
shuffled array order: "random" (1,024 and 8,192 slots: clusters of 1 to 60
elements, invalid elements, empty and invalid-only slots), "edge"
(8,192 slots: clusters of 1 to 5 elements, one of 5,000, ties in the
modes, values at the int32 limits, a centered svlen spanning 2^29, NM
across 40 binades), "tiers" (65,536 slots: a cluster at each of the
kernels' tier thresholds and one above and below each), "huge" (32,768
slots: a cluster of 25,000 elements, past a block's shared memory) and
"sums" (65,536 slots: the trimmed windows' sum |x| and sum x^2 at 2^24 and
one past it in each tier, mapq sums at and past it, mapq 255 in clusters
of 256, narrow and wide spreads past 256: the kernels' exact sums and
their chains).

Tolerance: 0. Every key, every slot, bit for bit (float32 keys by their
bits). The JAX function's two arithmetics, as its callers run it:
  * fused=True against call_statistics as jitted: XLA's CPU code fuses the
    stdev numerator's multiply into its subtract, as in the engine's jitted
    step (tests/test_torch_engine.py holds the engine at fused=True);
  * fused=False against call_statistics with jax.disable_jit (one op at a
    time, no fused multiply-add), as in the call path's step
    (tests/test_torch_clustering.py holds call_task_packed, which calls
    the statistics unfused).

Also: the wrapper takes the plain version on CPU tensors and counts no
launch, raises on a device that is neither; its one sort keeps each
cluster's elements in array order; the tier thresholds fit the kernels;
tools/time_call_stats.py's cases. The kernels themselves run on the card
only (tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jcl  # noqa: E402
from sniffles_tpu_torch.ops import call_stats as cs  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tcl  # noqa: E402
from sniffles_tpu_torch.ops.segments import INT32_MAX  # noqa: E402
from sniffles_tpu_torch.sim import call_stats_batch  # noqa: E402

BATCHES = [("random", 1024, 1), ("random", 1024, 2), ("random", 8192, 3), ("edge", 8192, 4),
           ("edge", 8192, 5), ("tiers", 65536, 8), ("huge", 32768, 9), ("sums", 65536, 10)]
BATCH_IDS = [f"{k}-{n}-seed{s}" for k, n, s in BATCHES]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one torch thread, beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def assert_same(ours, theirs):
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        a = np.asarray(ours[k])
        b = np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        bad = np.flatnonzero(a != b)
        assert bad.size == 0, f"{k}: {bad.size} slots differ, first {bad[:5].tolist()}"


@pytest.mark.parametrize("kind,n,seed", BATCHES, ids=BATCH_IDS)
def test_plain_fused_matches_jitted_jax(kind, n, seed):
    b = call_stats_batch(kind, n, seed)
    want = jcl.call_statistics({k: jnp.asarray(v) for k, v in b.items()})
    got = cs.call_statistics_plain(torch_batch(b), fused=True)
    assert_same({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("kind,n,seed", BATCHES, ids=BATCH_IDS)
def test_plain_unfused_matches_eager_jax(kind, n, seed):
    b = call_stats_batch(kind, n, seed)
    with jax.disable_jit():
        want = jcl.call_statistics({k: jnp.asarray(v) for k, v in b.items()})
    got = cs.call_statistics_plain(torch_batch(b), fused=False)
    assert_same({k: v.numpy() for k, v in got.items()}, want)


def test_edge_batch_reaches_its_edges():
    """The edge batch holds what its docstring names: every cluster size
    of 1 to 5, the 5,000-element cluster, slots with only invalid elements
    (svtype -1) and empty slots (svtype INT32_MIN), the wrapping
    centering, a stdev_len of a span over 2^26, float32 sums that round."""
    b = call_stats_batch("edge", 8192, 4)
    out = cs.call_statistics_plain(torch_batch(b), fused=True)
    counts = out["lead_count"].numpy()
    assert {1, 2, 3, 4, 5, 5000} <= set(counts.tolist())
    svtype = out["svtype"].numpy()
    assert (svtype == -1).sum() >= 10 and (svtype == -2 ** 31).sum() >= 10
    assert out["stdev_len"].max() > 2 ** 26
    # a float32 sum that rounds: the NM sum of the largest cluster in
    # float64 is not the float32 one
    big = int(np.argmax(counts))
    nm = b["nm"][(b["cluster_id"] == big) & b["valid"]]
    assert np.float32(nm.astype(np.float64).sum()) != np.float32(
        np.add.reduce(nm, dtype=np.float32))
    wrap = b["pos"][b["valid"]]
    assert wrap.min() == -2 ** 31 and wrap.max() == 2 ** 31 - 1


def test_sums_batch_reaches_its_edges():
    """The "sums" batch: in the warp and the block tiers, clusters whose
    trimmed-window sums all pass the exactness test and clusters with sums
    past it (tools/time_call_stats.window_paths); a cluster past
    BLOCK_MAX; mapq 255 in clusters of 256; a mapq sum |q| of exactly
    2^24, and a mapq chain whose float32 sum is not the integer sum."""
    from sniffles_tpu_torch.tools.time_call_stats import window_paths
    b = call_stats_batch("sums", 65536, 10)
    t = torch_batch(b)
    out = cs.call_statistics_plain(t, True)
    counts = out["lead_count"].numpy()
    assert {40, 200, 256, 300, 1000, 5000} <= set(counts.tolist())
    assert counts.max() > cs.BLOCK_MAX
    paths = window_paths(t, cs.TIERS)
    for tier in ("stat_warps", "stat_blocks"):
        exact, chain, sums = paths[tier]
        assert exact >= 2 and chain >= 8 and sums > chain, (tier, paths[tier])
    live = b["valid"] & (b["cluster_id"] >= 0)
    mapq_abs = np.zeros(65536, np.int64)
    np.add.at(mapq_abs, b["cluster_id"][live], np.abs(b["mapq"][live].astype(np.int64)))
    assert (mapq_abs == 1 << 24).sum() == 2 and (mapq_abs == (1 << 24) + 1).sum() == 2
    full = [c for c in np.flatnonzero(counts == 256)
            if (b["mapq"][live & (b["cluster_id"] == c)] == 255).all()]
    assert len(full) == 2
    # the mixed-sign mapq terms: the float32 chain in array order rounds
    mixed = [c for c in np.flatnonzero(counts > 0)
             if (b["mapq"][live & (b["cluster_id"] == c)] == -(1 << 24)).any()]
    assert len(mixed) == 2
    for c in mixed:
        q = b["mapq"][live & (b["cluster_id"] == c)]
        assert int(np.add.reduce(q.astype(np.float32), dtype=np.float32)) != int(q.sum())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    b = torch_batch(call_stats_batch("random", 1024, 6))
    before = dict(cs.COUNTS)
    for fused in (False, True):
        want = cs.call_statistics_plain(b, fused)
        for got in (cs.call_statistics(b, fused), tcl.call_statistics(b, fused)):
            assert_same({k: v.numpy() for k, v in got.items()},
                        {k: v.numpy() for k, v in want.items()})
    assert cs.COUNTS == before


def test_wrapper_raises_on_another_device():
    b = {k: v.to("meta") for k, v in torch_batch(call_stats_batch("random", 1024, 6)).items()}
    with pytest.raises(ValueError, match="no call-statistics kernel"):
        cs.call_statistics(b)
    with pytest.raises(ValueError, match="no call-statistics kernel"):
        tcl.call_statistics(b, fused=True)


def test_id_sort_keeps_each_cluster_in_array_order():
    """The wrapper's one sort (sorted_ids) of the keys of sort_keys: a
    valid element's id in [0, n) ascending, each cluster's elements one
    run in array order, which the kernels' mapq and NM sums need; then an
    invalid element's raw id r in [0, n) as n + r (the invalid marks, by
    raw id); every other element (ids outside [0, n), valid elements whose
    id is INT32_MAX) INT32_MAX, last."""
    b = torch_batch(call_stats_batch("edge", 8192, 4))
    rng = np.random.default_rng(3)
    b["cluster_id"][torch.as_tensor(rng.choice(8192, 40, replace=False))] = torch.as_tensor(
        np.r_[np.full(10, -5), np.full(10, 9000), np.full(10, INT32_MAX), np.full(10, -1)]
        .astype(np.int32))
    cid_s, order = cs.sorted_ids(b)
    cid = b["cluster_id"].to(torch.int64)
    inside = (cid >= 0) & (cid < 8192)
    keys = torch.where(inside, torch.where(b["valid"], cid, cid + 8192), INT32_MAX)
    assert not bool(b["valid"].all()) and bool((inside & ~b["valid"]).any())
    assert order.tolist() == sorted(range(8192), key=lambda i: (int(keys[i]), i))
    assert cid_s.dtype == torch.int32 and cid_s.tolist() == keys[order].tolist()
    assert torch.equal(cs.sort_keys(b), cs.sort_keys_plain(b))


def test_tier_batches_reach_every_tier():
    """The "tiers" batch holds a cluster at each tier threshold and one
    above and below it; the "huge" batch one past a block's shared memory;
    the thresholds fit the kernels (a thread's registers hold TINY_MAX
    elements, a warp's two registers a lane PAIR_MAX; a warp's lists, 20
    bytes an element, and a block's, 16, fit the H100's 227 KB of shared
    memory a block)."""
    src = open(cs.__file__.replace("ops/call_stats.py", "csrc/call_stats.cu")).read()
    cap = int(src.split("constexpr int kTinyCap = ")[1].split(";")[0])
    assert 0 <= cs.TINY_MAX <= cap and cs.TINY_MAX < cs.WARP_MAX < cs.BLOCK_MAX
    assert cs.PAIR_MAX in (0, 64) and cs.PAIR_MAX <= cs.WARP_MAX
    # a warp's slice: 5 lists of 4 bytes; a block's: 4 (the sort's scratch)
    warp_lists = int(src.split("constexpr int kWarpLists = ")[1].split(";")[0])
    block_lists = int(src.split("constexpr int kBlockLists = ")[1].split(";")[0])
    assert (warp_lists, block_lists) == (5, 4)
    assert 8 * 4 * warp_lists * cs.WARP_MAX <= 232_448
    assert 4 * block_lists * cs.BLOCK_MAX <= 232_448
    assert cs.TIERS == (cs.TINY_MAX, cs.PAIR_MAX, cs.WARP_MAX, cs.BLOCK_MAX)
    counts = set(cs.call_statistics_plain(torch_batch(call_stats_batch("tiers", 65536, 8)),
                                          True)["lead_count"].tolist())
    for at in cs.TIERS:
        assert {at - 1, at, at + 1} <= counts
    huge = cs.call_statistics_plain(torch_batch(call_stats_batch("huge", 32768, 9)), True)
    assert int(huge["lead_count"].max()) == 25_000 > cs.BLOCK_MAX


def test_tier_thresholds_are_build_flags():
    """The thresholds reach the kernels as nvcc -D flags, one for each name
    the source requires; the default build takes ops/call_stats.TIERS, and
    another set of thresholds is a library of its own."""
    from sniffles_tpu_torch.ops import _build
    src = open(cs.__file__.replace("ops/call_stats.py", "csrc/call_stats.cu")).read()
    flags = cs.nvcc_defines()
    assert _build.default_defines("call_stats") == flags
    for flag, value in zip(flags, cs.TIERS, strict=True):
        name, got = flag[2:].split("=")
        assert f"defined({name})" in src and int(got) == value
    assert _build.default_defines("merge_relax") == ()
    other = cs.nvcc_defines((cs.TINY_MAX - 1,) + cs.TIERS[1:])
    assert _build.library_path("call_stats") == _build.library_path("call_stats", flags)
    assert _build.library_path("call_stats", other) != _build.library_path("call_stats")
    with pytest.raises(ValueError):
        cs.nvcc_defines(cs.TIERS[:3])


def test_smoke_times_a_kernel_by_its_recorded_launches(monkeypatch):
    """chip_smoke.py's launch_us: a kernel's time is the mean over the
    launches the profiler recorded (a profile that dropped 9 calls of 10
    reads the same), a profile with a kernel missing is retaken, and the
    script fails when every one misses it; call_stats_kernel_bounds counts
    a comparison sort's cnt * log2(cnt) compares and the latency of the
    largest cluster's NM chain, so 16 clusters of 3,689 are bound by their
    chain and 568 by their bytes."""
    import importlib.util
    import pathlib
    from sniffles_tpu_torch.tools import time_call_stats
    path = pathlib.Path(cs.__file__).parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_launch_us", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    profiles = iter([{"void stat_runs(int)": (2.0, 1.0), "memset": (1.0, 2.0)},
                     {"void stat_runs(int)": (1.2, 0.1), "void stat_warps(int)": (15.0, 1.0)}])
    monkeypatch.setattr(time_call_stats, "by_kernel", lambda fn: next(profiles))
    got = smoke.launch_us(None, ("stat_runs", "stat_warps"))
    assert got == {"stat_runs": pytest.approx(12.0), "stat_warps": 15.0}
    monkeypatch.setattr(time_call_stats, "by_kernel", lambda fn: {"memset": (1.0, 1.0)})
    with pytest.raises(SystemExit, match="recorded no launch"):
        smoke.launch_us(None, ("stat_runs",), tries=2)
    n = 1 << 16
    counts = np.zeros(n, np.int64)
    counts[:16] = 3689
    by_bytes, by_ops, by_chain = smoke.call_stats_kernel_parts(counts, n)["stat_blocks"]
    assert by_bytes > by_ops
    ops = 16 * 3689 * (smoke.CALL_STATS_OPS_PER_ELEMENT
                       + np.log2(3689) * smoke.CALL_STATS_OPS_PER_COMPARE)
    assert by_ops == pytest.approx(ops / smoke.INT32_OPS_PER_S * 1e3)
    # beside bytes and operations, the largest cluster's NM chain: 3,689
    # dependent float32 adds; the bound is the larger of the three
    assert by_chain == pytest.approx(3689 * smoke.FADD_LATENCY_CYCLES / smoke.SM_CLOCK_HZ * 1e3)
    bound, by = smoke.call_stats_kernel_bounds(counts, n)["stat_blocks"]
    assert bound == max(by_bytes, by_ops, by_chain) == by_chain and by == "operations"
    many = np.zeros(1 << 21, np.int64)
    many[:568] = 3689
    bound, by = smoke.call_stats_kernel_bounds(many, 1 << 21)["stat_blocks"]
    assert by == "bytes" and bound == smoke.call_stats_kernel_parts(many, 1 << 21)["stat_blocks"][0]


def test_timing_tool_populations():
    """tools/time_call_stats.py's cases on the CPU: the engine's clustered
    batch, every slot empty, every slot a singleton, K elements a slot for
    each tier's size; the plain version gives each its live slots."""
    from sniffles_tpu_torch.tools import time_call_stats
    n = 4096
    cases = time_call_stats.populations(n, "cpu")
    live = {k: int((cs.call_statistics_plain(c, True)["lead_count"] > 0).sum())
            for k, c in cases.items()}
    assert live["all invalid"] == 0 and live["singletons"] == n
    for k in time_call_stats.SLOT_SIZES:
        assert live[f"{k} a slot"] == -(-n // k)
    assert 0 < live["engine"] <= n // 40
    assert time_call_stats.short("void (anonymous namespace)::stat_warps(Columns, int)") \
        == "stat_warps"


def test_kernel_inputs_on_the_cpu():
    """The host side of the kernels' launch: the columns as contiguous
    int32, bool and float32 (other integer types converted), the wrapper's
    one sort (sorted_ids); a column of another length raises."""
    b = torch_batch(call_stats_batch("random", 1024, 7))
    b["mapq"] = b["mapq"].to(torch.int64)
    b["read_id"] = torch.stack([b["read_id"], b["read_id"]], 1)[:, 0]  # strided
    inputs = cs.kernel_inputs(b)
    assert inputs["mapq"].dtype == torch.int32 and inputs["nm"].dtype == torch.float32
    assert all(inputs[k].is_contiguous() for k in cs.INT_COLUMNS)
    cid_s, order = inputs["sort"]
    want_s, want_o = cs.sorted_ids(b)
    assert torch.equal(cid_s, want_s) and torch.equal(order, want_o)
    assert cid_s.dtype == torch.int32 and order.dtype == torch.int64
    b["nm"] = b["nm"][:-1]
    with pytest.raises(ValueError, match="nm is"):
        cs.kernel_inputs(b)
