"""The call statistics (sniffles_tpu_torch/ops/call_stats.py) against the
JAX package's call_statistics (sniffles_tpu/ops/clustering.py:1262), on the
CPU, where the wrapper takes its plain version.

Batches: sniffles_tpu_torch.sim.call_stats_batch, seeded numpy, in
shuffled array order: "random" (1,024 and 8,192 slots: clusters of 1 to 60
elements, invalid elements, empty and invalid-only slots) and "edge"
(8,192 slots: clusters of 1 to 5 elements, one of 5,000, ties in the
modes, values at the int32 limits, a centered svlen spanning 2^29, NM
across 40 binades).

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
launch, raises on a device that is neither; the int64 sort key gives
ops/segments.lexsort's permutation, ties and masks included;
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
from sniffles_tpu_torch.ops.segments import INT32_MAX, lexsort  # noqa: E402
from sniffles_tpu_torch.sim import call_stats_batch  # noqa: E402

BATCHES = [("random", 1024, 1), ("random", 1024, 2), ("random", 8192, 3), ("edge", 8192, 4),
           ("edge", 8192, 5)]
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


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_int64_key_sort_is_lexsort(seed):
    """One stable sort of the int64 key gives lexsort's permutation of
    (masked value, masked cluster id): ties in both keys, values at the
    int32 limits, masked elements (INT32_MAX in both) and valid elements
    whose value is INT32_MAX."""
    rng = np.random.default_rng(seed)
    n = 4096
    cid = torch.as_tensor(rng.integers(-3, 40, n).astype(np.int32))
    vals = rng.choice(np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 7, 2 ** 31 - 2, 2 ** 31 - 1]),
                      n)
    vals = torch.as_tensor(np.where(rng.random(n) < 0.5, vals, rng.integers(-50, 50, n))
                           .astype(np.int32))
    valid = torch.as_tensor(rng.random(n) < 0.8)
    want = lexsort((torch.where(valid, vals, INT32_MAX), torch.where(valid, cid, INT32_MAX)))
    key = cs.masked_keys(cid, valid, vals)
    got = torch.sort(key, stable=True).indices
    assert got.tolist() == want.tolist()
    # the sorted key's words are the masked id and value
    s = key[got]
    assert (s >> 32).to(torch.int32).tolist() == torch.where(valid, cid, INT32_MAX)[want].tolist()
    low = ((s & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    assert low.tolist() == torch.where(valid, vals, INT32_MAX)[want].tolist()


def test_wrapper_sorts_share_the_masked_id_sequence():
    """The four sorts of the wrapper put the same sequence of masked
    cluster ids first, so one run table serves them all; the cid-only
    sort keeps each cluster's elements in array order."""
    b = torch_batch(call_stats_batch("edge", 8192, 4))
    (k_len, _), (k_pos, _), (k_read, _), (cid_s, order) = cs.sorted_keys(b)
    for k in (k_len, k_pos, k_read):
        assert (k >> 32).to(torch.int32).tolist() == cid_s.tolist()
    mcid = torch.where(b["valid"], b["cluster_id"], INT32_MAX)
    assert order.tolist() == sorted(range(8192), key=lambda i: (int(mcid[i]), i))


def test_timing_tool_populations():
    """tools/time_call_stats.py's cases on the CPU: the engine's clustered
    batch, every slot empty, every slot a singleton, 40 elements a slot;
    the plain version gives each its live slots."""
    from sniffles_tpu_torch.tools import time_call_stats
    n = 4096
    cases = time_call_stats.populations(n, "cpu")
    live = {k: int((cs.call_statistics_plain(c, True)["lead_count"] > 0).sum())
            for k, c in cases.items()}
    assert live["all invalid"] == 0 and live["singletons"] == n
    assert live["40 a slot"] == -(-n // 40)
    assert 0 < live["engine"] <= n // 40


def test_kernel_inputs_on_the_cpu():
    """The host side of the kernels' launch: the columns as contiguous
    int32, bool and float32 (other integer types converted), the wrapper's
    four sorts; a column of another length raises."""
    b = torch_batch(call_stats_batch("random", 1024, 7))
    b["mapq"] = b["mapq"].to(torch.int64)
    inputs = cs.kernel_inputs(b)
    assert inputs["mapq"].dtype == torch.int32 and inputs["nm"].dtype == torch.float32
    for (k1, p1), (k2, p2) in zip(inputs["sorts"], cs.sorted_keys(b)):
        assert torch.equal(k1, k2) and torch.equal(p1, p2)
    b["nm"] = b["nm"][:-1]
    with pytest.raises(ValueError, match="nm is"):
        cs.kernel_inputs(b)
