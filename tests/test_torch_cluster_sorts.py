"""The clustering's segmented sorts (sniffles_tpu_torch/ops/cluster_sorts.py)
and the stages that use them (ops/clustering.py: sort_and_seed,
merge_inner_fold, resplit_child_ids, _resplit, phase_tallies) against the
JAX package, on the CPU, on numpy inputs made from a seed.

Each stage runs its segmented formulation here too (clustering.on_card
patched to say so, `segmented()`): the same torch code the card runs,
with cluster_sorts' plain versions in place of the kernels of
csrc/cluster_sorts.cu, which the card tests hold to them
(tests/test_torch_gpu.py). Tolerance 0: every output bit for bit.

  * seg_sort's plain version equals jnp.lexsort of the callers' masked
    keys (the masked segment id last) on every sim.seg_sort_batch
    population, with one key and with two, and through a base permutation;
  * each stage's segmented formulation equals the JAX function: steps 1-2
    and 4 of _cluster_body (sort and seed, and the resplit of a merged
    boundary: the exact sweep's and the relaxation's), merge_inner_fold
    (both repeat settings), resplit_child_ids and phase_tallies, on the
    inputs the call task gives them on fuzz and edge batches;
    call_task_packed and cluster_assign_packed whole, segmented, equal
    the JAX package's;
  * the invariant the segmented sorts rely on, at each caller (the call
    task, cluster_assign_packed, the engine's clustering): every segment a
    contiguous run of ascending ids, the invalid elements a suffix made
    of whole segments, and each parent cluster's child ids below the next
    parent's;
  * the wrappers (the sort, the gather, the stages' predicates) take their
    plain versions on CPU tensors without counting a launch, and raise on
    any other device.
"""
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jc  # noqa: E402
from sniffles_tpu_torch.ops import cluster_sorts as cs  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tc  # noqa: E402
from sniffles_tpu_torch.sim import (SEG_SORT_KINDS, edge_call_batches,  # noqa: E402
                                   fuzz_call_batch, seg_sort_batch, seg_sort_width)

INT32_MAX = 2 ** 31 - 1
META = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
            cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50,
            cluster_merge_pos=150, global_repeat=False, binsize=100,
            resplit_binsize=20)
SWEEP = {k: META[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                              "cluster_merge_bnd", "global_repeat", "binsize")}
RESPLIT = {k: META[k] for k in ("resplit_binsize", "minsvlen", "cluster_merge_len")}
ASSIGN_META = {k: META[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                                    "cluster_merge_bnd", "cluster_merge_len", "minsvlen",
                                    "binsize", "resplit_binsize")}

BATCHES = [pytest.param(dict(seed=31, size=2048), id="fuzz-2048"),
           pytest.param(dict(seed=32, size=4096, fill=0.97), id="fuzz-4096-full"),
           pytest.param(dict(seed=33, size=2048, svtypes=(4,)), id="bnd-chains"),
           pytest.param(dict(seed=34, size=1024, svtypes=(0, 1)), id="ins-del")] + [
    pytest.param(name, id=name) for name in ("nseeds-0", "one-seed", "fragmented-read")]


@contextlib.contextmanager
def segmented():
    """The stages' segmented formulation on CPU tensors (the plain versions
    of cluster_sorts in place of the kernels)."""
    real = tc.on_card
    tc.on_card = lambda t, what: True
    try:
        yield
    finally:
        tc.on_card = real


def packed_batch(kw) -> np.ndarray:
    return fuzz_call_batch(**kw) if isinstance(kw, dict) else edge_call_batches()[kw]


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(ours: dict, theirs: dict, keys):
    for k in keys:
        o, t = as_np(ours[k]), as_np(theirs[k])
        assert o.dtype == t.dtype or (o.dtype.kind == t.dtype.kind and o.itemsize == t.itemsize), k
        assert np.array_equal(o.view(np.uint8), t.view(np.uint8)), k


def to_jax(d: dict) -> dict:
    return {k: jnp.asarray(as_np(v)) for k, v in d.items()}


# ---------------------------------------------------------------------------
# seg_sort's plain version against jnp.lexsort


def masked(batch):
    valid = batch["valid"]
    return (np.where(valid, batch["k1"], INT32_MAX).astype(np.int32),
            np.where(valid, batch["k2"], INT32_MAX).astype(np.int32),
            np.where(valid, batch["seg_id"], INT32_MAX).astype(np.int32))


def starts(seg_id) -> torch.Tensor:
    seg_id = torch.as_tensor(seg_id)
    return tc._starts(seg_id)


@pytest.mark.parametrize("kind", SEG_SORT_KINDS)
def test_seg_sort_plain_equals_jnp_lexsort(kind):
    b = seg_sort_batch(kind, seg_sort_width(kind), 5)
    k1, k2, seg = masked(b)
    want2 = np.asarray(jnp.lexsort((k2, k1, seg)))
    want1 = np.asarray(jnp.lexsort((k1, seg)))
    got2 = cs.seg_sort(starts(b["seg_id"]), torch.from_numpy(k1), torch.from_numpy(k2))
    got1 = cs.seg_sort(starts(b["seg_id"]), torch.from_numpy(k1))
    assert got2.dtype == torch.int64
    assert np.array_equal(got2.numpy(), want2)
    assert np.array_equal(got1.numpy(), want1)
    # the invalid suffix left alone, as the callers leave it
    alone = torch.from_numpy(~b["valid"])
    got = cs.seg_sort(starts(b["seg_id"]), torch.from_numpy(k1), torch.from_numpy(k2),
                      alone=alone)
    assert np.array_equal(got.numpy(), want2)
    # and every segment of one element marked alone too (between the packed
    # segments of "packed")
    single = np.bincount(b["seg_id"])[b["seg_id"]] == 1
    got = cs.seg_sort(starts(b["seg_id"]), torch.from_numpy(k1), torch.from_numpy(k2),
                      alone=torch.from_numpy(single | ~b["valid"]))
    assert np.array_equal(got.numpy(), want2)


def test_tiles_population_sits_on_the_run_pass_tile_edges():
    """sim.seg_sort_batch's "tiles": at the run pass's tile edges (RUN_TILE
    elements a tile), a segment across a boundary, heads whose next head
    lies WARP_MAX and WARP_MAX + 1 past them across one (from a tile's
    middle and its last element), segments of one as a tile's last and
    first elements, a thread-tier segment across a boundary, a segment
    longer than a tile; its width leaves the last tile partial."""
    T, W = cs.RUN_TILE, cs.WARP_MAX
    width = seg_sort_width("tiles")
    b = seg_sort_batch("tiles", width, 5)
    sizes = np.bincount(b["seg_id"])
    at = dict(zip(np.r_[0, np.cumsum(sizes)[:-1]].tolist(), sizes.tolist()))
    want = {T - 20: 50, 2 * T - 100: W, 3 * T - 100: W + 1, 4 * T - 1: W, 5 * T - 1: W + 1,
            6 * T - 1: 1, 6 * T: 1, 8 * T - 3: cs.TINY_MAX, 9 * T: 40, 10 * T - 50: T + 100,
            12 * T - W: W}
    assert {k: at.get(k) for k in want} == want
    assert width % T and b["valid"].sum() < width and b["valid"][:width - width // 10].all()


def test_seg_heads_make_each_element_alone_a_segment():
    seg_start = torch.tensor([True, False, False, False, True, False])
    alone = torch.tensor([False, False, True, False, False, True])
    assert cs.seg_heads(seg_start, alone).tolist() == [True, False, True, True, True, True]
    # an element alone stays where it is, whatever its key
    k1 = torch.tensor([5, 4, 0, 3, 9, 1], dtype=torch.int32)
    assert cs.seg_sort(seg_start, k1, alone=alone).tolist() == [1, 0, 2, 3, 4, 5]


@pytest.mark.parametrize("kind", ["tiers", "random", "limits", "packed", "tiles"])
def test_seg_sort_through_a_base_permutation(kind):
    """With base: the element at position x is original element base[x];
    the result is base composed with the sort of the keys read through it,
    as sort_and_seed uses it after its int64 sort."""
    b = seg_sort_batch(kind, 65536, 6)
    rng = np.random.default_rng(6)
    base = rng.permutation(65536)
    k1, k2, seg = masked(b)
    orig1, orig2 = np.empty_like(k1), np.empty_like(k2)
    orig1[base], orig2[base] = k1, k2
    want = base[np.asarray(jnp.lexsort((k2, k1, seg)))]
    got = cs.seg_sort(starts(b["seg_id"]), torch.from_numpy(orig1), torch.from_numpy(orig2),
                      base=torch.from_numpy(base))
    assert np.array_equal(got.numpy(), want)
    alone = np.empty_like(b["valid"])
    alone[base] = ~b["valid"]
    got = cs.seg_sort(starts(b["seg_id"]), torch.from_numpy(orig1), torch.from_numpy(orig2),
                      base=torch.from_numpy(base), alone=torch.from_numpy(alone))
    assert np.array_equal(got.numpy(), want)


def test_gather_columns_plain_takes_every_column():
    rng = np.random.default_rng(3)
    order = torch.from_numpy(rng.permutation(100))
    cols = {"i": torch.arange(100, dtype=torch.int32), "f": torch.rand(100),
            "b": torch.rand(100) < 0.5, "l": torch.arange(100, dtype=torch.int64),
            "n": torch.tensor(7)}
    out = cs.gather_columns(order, cols)
    for k in ("i", "f", "b", "l"):
        assert torch.equal(out[k], cols[k][order])
    assert out["n"] is cols["n"]


# ---------------------------------------------------------------------------
# the stages against the JAX package


def jax_cluster_steps(sig: dict, boundary, monkeypatch):
    """The JAX package's _cluster_body, eager, with its merge sweep
    replaced: returns (its sort and seed: s, seed boundary, bin_; its
    step 4 on `boundary`: the resplit's dict with cluster_id)."""
    seen = {}

    def sweep(s, seed_boundary, bin_, **_):
        seen.update(s=s, boundary=seed_boundary, bin_=bin_)
        return jnp.asarray(as_np(boundary))
    monkeypatch.setattr(jc, "_exact_merge_sweep", sweep)
    monkeypatch.setattr(jc, "_exact_merge_sweep_auto", sweep)
    out = jc._cluster_body(to_jax(sig), cluster_r=2.5, cluster_repeat_h=1.5,
                           cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                           cluster_merge_len=0.22, minsvlen=50)
    return seen, out


@pytest.mark.parametrize("kw", BATCHES)
def test_sort_and_seed_and_resplit_equal_jax(kw, monkeypatch):
    """Steps 1-2 of _cluster_body, and step 4 on the exact sweep's merged
    boundary, segmented, equal the JAX package's."""
    sig = tc.packed_signatures(torch.from_numpy(packed_batch(kw)))
    with segmented():
        s, seed_boundary, bin_ = tc.sort_and_seed(sig, 100)
    boundary = tc._exact_merge_sweep(s, seed_boundary, bin_, **SWEEP)
    seen, want = jax_cluster_steps(sig, boundary, monkeypatch)
    assert_same(s, seen["s"], sig)
    assert_same({"b": seed_boundary, "bin": bin_}, {"b": seen["boundary"], "bin": seen["bin_"]},
                ("b", "bin"))
    with segmented():
        s2, cid = tc._resplit(s, boundary, **RESPLIT)
    assert_same({**s2, "cluster_id": cid}, want, [*sig, "cluster_id"])


def test_sort_and_seed_with_valid_slots_at_the_padding_key_equals_jax(monkeypatch):
    """Valid slots of svtype and bin INT32_MAX share the padding's int64 key:
    the run is then sorted by the tie, as the lexsort ties them, and not
    left alone."""
    packed = fuzz_call_batch(35, 2048)
    packed[2, 3:40:3] = INT32_MAX
    packed[0, 3:40:3] = INT32_MAX    # a bin of INT32_MAX at binsize 1
    packed[5, 1:40:3] = 0            # padding slots before them
    sig = tc.packed_signatures(torch.from_numpy(packed))
    with segmented():
        ours = tc.sort_and_seed(sig, 1)
    plain = tc.sort_and_seed(sig, 1)
    seen = {}

    def sweep(s, seed_boundary, bin_, **_):
        seen.update(s=s, boundary=seed_boundary, bin_=bin_)
        return seed_boundary
    monkeypatch.setattr(jc, "_exact_merge_sweep", sweep)
    monkeypatch.setattr(jc, "_exact_merge_sweep_auto", sweep)
    jc._cluster_body(to_jax(sig), cluster_r=2.5, cluster_repeat_h=1.5,
                     cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                     cluster_merge_len=0.22, minsvlen=50, binsize=1)
    assert_same(ours[0], seen["s"], sig)
    assert_same(plain[0], seen["s"], sig)
    assert_same({"b": ours[1]}, {"b": seen["boundary"]}, ("b",))


@pytest.mark.parametrize("seed", [7, 8])
def test_engine_resplit_equals_jax(seed, monkeypatch):
    """The engine's clustering (the relaxation's boundary, ties of pos as
    the tie): sort and seed, and the resplit, segmented, equal the JAX
    package's steps."""
    from sniffles_tpu_torch.ops.merge_relax import merge_relax
    from sniffles_tpu_torch.signatures import synthetic_batch
    raw = synthetic_batch(4096, 100, seed=seed, genome_span=200_000, batch_size=4096).as_dict()
    sig = {k: torch.as_tensor(np.asarray(v)) for k, v in raw.items()}
    with segmented():
        s, seed_boundary, bin_ = tc.sort_and_seed(sig, 100)
    boundary, _ = merge_relax(s, seed_boundary, bin_, **SWEEP)
    seen, want = jax_cluster_steps(sig, boundary, monkeypatch)
    assert_same(s, seen["s"], sig)
    with segmented():
        s2, cid = tc._resplit(s, boundary, **RESPLIT)
    assert_same({**s2, "cluster_id": cid}, want, [*sig, "cluster_id"])


def call_task_stage_inputs(packed, monkeypatch) -> dict:
    """The inputs the call task hands merge_inner_fold, resplit_child_ids
    and phase_tallies (its plain run on the CPU)."""
    held = {}
    for name in ("merge_inner_fold", "resplit_child_ids", "phase_tallies"):
        def keep(*args, _name=name, _fn=getattr(tc, name), **kw):
            held[_name] = (args, kw)
            return _fn(*args, **kw)
        monkeypatch.setattr(tc, name, keep)
    tc.call_task_packed(torch.from_numpy(packed), **META)
    monkeypatch.undo()
    return held


@pytest.mark.parametrize("global_repeat", [False, True])
@pytest.mark.parametrize("kw", BATCHES)
def test_fold_resplit_ids_and_tallies_equal_jax(kw, global_repeat, monkeypatch):
    held = call_task_stage_inputs(packed_batch(kw), monkeypatch)
    (clustered,), _ = held["merge_inner_fold"]
    with segmented():
        ours = tc.merge_inner_fold(clustered, cluster_merge_pos=150,
                                   global_repeat=global_repeat)
    theirs = jc.merge_inner_fold(to_jax({k: v for k, v in clustered.items() if v.dim() == 1}),
                                 cluster_merge_pos=150, global_repeat=global_repeat)
    assert_same(ours, theirs, [k for k in theirs])

    (folded,), _ = held["resplit_child_ids"]
    with segmented():
        ours = tc.resplit_child_ids(folded, **RESPLIT)
    theirs = jc.resplit_child_ids(to_jax({k: v for k, v in folded.items() if v.dim() == 1}),
                                  **RESPLIT)
    for o, t in zip(ours, theirs):
        assert np.array_equal(as_np(o), as_np(t))

    (tallied, n), _ = held["phase_tallies"]
    with segmented():
        ours = tc.phase_tallies(tallied, n)
    theirs = jc.phase_tallies(to_jax({k: v for k, v in tallied.items() if k != "parent"}), n)
    assert sorted(ours) == sorted(theirs)
    assert_same(ours, theirs, theirs)


def phase_case(seed, n=2048):
    """phase_tallies' inputs with every phase-set value, INT32_MAX among
    them (a representative that ties with the masked keys), on the parent
    and child layout the call task gives: parents contiguous, child ids
    ascending in (parent, bin) order, the invalid elements last."""
    rng = np.random.default_rng(seed)
    n_valid = n - n // 8
    parent = np.sort(rng.integers(0, n_valid // 12, n_valid))
    sub = rng.integers(0, 3, n_valid)
    child = np.unique(parent * 4 + sub, return_inverse=True)[1]
    perm = np.arange(n_valid)
    starts_ = np.r_[0, np.flatnonzero(np.diff(parent)) + 1, n_valid]
    for a, b in zip(starts_[:-1], starts_[1:]):   # a parent's elements in any order
        perm[a:b] = a + rng.permutation(b - a)
    pad = n - n_valid
    col = lambda valid_part, fill: np.r_[valid_part[perm], np.full(pad, fill)].astype(np.int32)
    return {"cluster_id": torch.from_numpy(col(child, 0)),
            "parent": torch.from_numpy(col(parent, parent.max() + 1)),
            "valid": torch.from_numpy(np.arange(n) < n_valid),
            "read_id": torch.from_numpy(rng.integers(0, n // 6, n).astype(np.int32)),
            "hap": torch.from_numpy(rng.choice([0, 1, 2, -9], n).astype(np.int32)),
            "ps": torch.from_numpy(rng.choice([-1, 0, 1000, INT32_MAX, 7], n).astype(np.int32))}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_phase_tallies_with_every_phase_set_equal_jax(seed):
    """Non-representatives sit inside their child in the segmented order
    and at the batch's end in the lexsort's: the nine tallies are equal,
    with phase sets at INT32_MAX among the representatives."""
    case = phase_case(seed)
    with segmented():
        ours = tc.phase_tallies(case, 2048)
    plain = tc.phase_tallies(case, 2048)
    theirs = jc.phase_tallies(to_jax({k: v for k, v in case.items() if k != "parent"}), 2048)
    assert_same(ours, theirs, theirs)
    assert_same(plain, theirs, theirs)


def jax_call_task(packed):
    fn = jax.jit(jc.call_task_packed.__wrapped__, static_argnames=tuple(META))
    return np.asarray(fn(jnp.asarray(packed), **META))


@pytest.mark.parametrize("kw", BATCHES)
def test_call_task_and_assign_segmented_equal_jax(kw, monkeypatch):
    """call_task_packed and cluster_assign_packed whole, every stage
    segmented, equal the JAX package's (its sequential sweep)."""
    packed = packed_batch(kw)
    monkeypatch.setattr(jc, "_FORCE_SEQ_SWEEP", True)
    want = jax_call_task(packed)
    assign = np.ascontiguousarray(packed[[0, 1, 2, 8, 4, 5]])
    want_assign = np.asarray(jax.jit(jc.cluster_assign_packed.__wrapped__,
                                     static_argnames=tuple(ASSIGN_META))(
        jnp.asarray(assign), **ASSIGN_META))
    with segmented():
        got = tc.call_task_packed(torch.from_numpy(packed), **META).numpy()
        got_assign = tc.cluster_assign_packed(torch.from_numpy(assign), **ASSIGN_META).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got_assign, want_assign)


# ---------------------------------------------------------------------------
# the invariant the segmented sorts rely on


def check_segments(seg, valid, what):
    """Each segment a contiguous run of ascending ids; the invalid elements
    a suffix made of whole segments."""
    seg, valid = as_np(seg).astype(np.int64), as_np(valid).astype(bool)
    assert (np.diff(seg) >= 0).all(), f"{what}: segment ids do not ascend"
    nv = int(valid.sum())
    assert valid[:nv].all(), f"{what}: a valid element after an invalid one"
    if 0 < nv < seg.size:
        assert seg[nv - 1] != seg[nv], f"{what}: a segment holds valid and invalid elements"


def check_children(parent, child, valid, what):
    """Each parent's child ids below the next parent's."""
    parent, child, valid = as_np(parent), as_np(child), as_np(valid).astype(bool)
    p, c = parent[valid], child[valid]
    if p.size == 0:
        return
    ids, first = np.unique(p, return_index=True)
    last = np.r_[first[1:], p.size]
    lo = np.array([c[a:b].min() for a, b in zip(first, last)])
    hi = np.array([c[a:b].max() for a, b in zip(first, last)])
    assert (hi[:-1] < lo[1:]).all(), f"{what}: child ids do not ascend with the parent"


def recording(monkeypatch, checks):
    for name in ("merge_inner_fold", "resplit_child_ids", "phase_tallies", "_resplit"):
        def keep(*args, _name=name, _fn=getattr(tc, name), **kw):
            checks.append((_name, args))
            return _fn(*args, **kw)
        monkeypatch.setattr(tc, name, keep)


def check_recorded(checks):
    names = set()
    for name, args in checks:
        names.add(name)
        if name == "merge_inner_fold":
            check_segments(args[0]["cluster_id"], args[0]["valid"], name)
        elif name == "resplit_child_ids":
            check_segments(args[0]["cluster_id"], args[0]["valid_all"], name)
        elif name == "_resplit":
            s, boundary = args
            check_segments(torch.cumsum(boundary.to(torch.int32), 0), s["valid"], name)
        else:
            t = args[0]
            check_segments(t["parent"], t["valid"], name)
            check_children(t["parent"], t["cluster_id"], t["valid"], name)
    return names


@pytest.mark.parametrize("kw", BATCHES)
def test_segments_are_contiguous_at_every_caller(kw, monkeypatch):
    packed = packed_batch(kw)
    checks = []
    recording(monkeypatch, checks)
    tc.call_task_packed(torch.from_numpy(packed), **META)
    tc.cluster_assign_packed(torch.from_numpy(np.ascontiguousarray(packed[[0, 1, 2, 8, 4, 5]])),
                             **ASSIGN_META)
    assert check_recorded(checks) == {"merge_inner_fold", "resplit_child_ids",
                                      "phase_tallies", "_resplit"}


@pytest.mark.parametrize("seed", [7, 9])
def test_segments_are_contiguous_in_the_engine(seed, monkeypatch):
    from sniffles_tpu_torch.signatures import synthetic_batch
    raw = synthetic_batch(4096, 60, seed=seed, genome_span=200_000, batch_size=8192).as_dict()
    sig = {k: torch.as_tensor(np.asarray(v)) for k, v in raw.items()}
    checks = []
    recording(monkeypatch, checks)
    tc.cluster_signatures(sig, exact_sweep=False, **ASSIGN_META)
    assert check_recorded(checks) == {"_resplit"}


def test_the_invariant_check_finds_a_broken_layout():
    with pytest.raises(AssertionError, match="valid element after"):
        check_segments([0, 0, 1, 1], [True, False, True, False], "case")
    with pytest.raises(AssertionError, match="valid and invalid"):
        check_segments([0, 0, 1, 1], [True, True, True, False], "case")
    with pytest.raises(AssertionError, match="do not ascend"):
        check_segments([0, 1, 0, 2], [True] * 4, "case")
    with pytest.raises(AssertionError, match="child ids"):
        check_children([0, 0, 1], [2, 0, 1], [True] * 3, "case")


# ---------------------------------------------------------------------------
# the wrappers


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    cs.reset_counts()
    b = seg_sort_batch("random", 65536, 9)
    k1, k2, _ = masked(b)
    seg_start = starts(b["seg_id"])
    got = cs.seg_sort(seg_start, torch.from_numpy(k1), torch.from_numpy(k2))
    assert torch.equal(got, cs.seg_sort_plain(seg_start, torch.from_numpy(k1),
                                              torch.from_numpy(k2)))
    out = cs.gather_columns(got, {"k1": torch.from_numpy(k1)})
    assert torch.equal(out["k1"], torch.from_numpy(k1)[got])
    k = torch.from_numpy(k1)
    valid = torch.from_numpy(b["valid"])
    assert all(torch.equal(x, y) for x, y in zip(cs.seed_marks(k, k, valid, 100),
                                                   cs.seed_marks_plain(k, k, valid, 100)))
    assert all(v == 0 for v in cs.COUNTS.values())


@pytest.mark.parametrize("unordered", [False, True])
def test_gather_columns_takes_the_plain_version_in_either_order(unordered):
    """On CPU tensors the gather is the plain version, counting nothing,
    whether its permutation sends each element to a random place (as the
    engine's sort and seed does) or keeps it inside its segment; other
    entries pass as they are."""
    cs.reset_counts()
    rng = np.random.default_rng(4)
    order = (rng.permutation(1000) if unordered
             else np.concatenate([s + rng.permutation(10) for s in range(0, 1000, 10)]))
    order = torch.from_numpy(order)
    cols = {"i": torch.arange(1000, dtype=torch.int32), "b": torch.rand(1000) < 0.5,
            "l": torch.arange(1000, dtype=torch.int64), "n": torch.tensor(3)}
    out = cs.gather_columns(order, cols)
    for k in ("i", "b", "l"):
        assert torch.equal(out[k], cols[k][order])
    assert out["n"] is cols["n"]
    assert all(v == 0 for v in cs.COUNTS.values())


# (n, columns): the kernel's chunks are multiples of 16 elements, a launch
# takes 32 columns; n off both, and more columns than a launch takes
@pytest.mark.parametrize("n,ncols", [(1, 3), (15, 5), (16, 4), (17, 33), (1000, 7),
                                     (4099, 40)])
def test_gather_columns_equals_jax_take(n, ncols):
    """gather_columns on every element size it moves (bool, int32, float32,
    int64) equals the JAX package's _apply_order (a jnp.take a column),
    bit for bit, through a random and a segment-local permutation."""
    rng = np.random.default_rng(n + ncols)
    cols = {}
    for j in range(ncols):
        kind = j % 4
        cols[f"c{j}"] = (rng.random(n) < 0.5 if kind == 0
                         else rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
                         if kind == 1 else rng.standard_normal(n).astype(np.float32)
                         if kind == 2 else rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64))
    seg = np.sort(rng.integers(0, max(1, n // 8), n))
    for order in (rng.permutation(n), np.lexsort((rng.random(n), seg))):
        got = cs.gather_columns(torch.from_numpy(order),
                                {k: torch.from_numpy(v) for k, v in cols.items()})
        with jax.enable_x64(True):
            want = jc._apply_order({k: jnp.asarray(v) for k, v in cols.items()},
                                   jnp.asarray(order))
            for k, v in want.items():
                assert got[k].numpy().dtype == np.asarray(v).dtype, k
                assert np.array_equal(got[k].numpy().view(np.uint8),
                                      np.asarray(v).view(np.uint8)), k


def test_launch_gather_refuses_2_to_the_31_elements():
    """The kernel keeps the chunk's permutation entries as int32: the
    entry point refuses n of 2^31 or more before it reads a tensor."""
    order = torch.empty(2 ** 31, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="fewer than 2"):
        cs.launch_gather(order, {"a": torch.empty(2 ** 31, dtype=torch.int32, device="meta")})


def test_wrappers_and_stages_raise_on_another_device():
    meta = torch.device("meta")
    k = torch.empty(8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no segmented-sort kernel"):
        cs.seg_sort(torch.empty(8, dtype=torch.bool, device=meta), k)
    with pytest.raises(ValueError, match="no gather kernel"):
        cs.gather_columns(torch.empty(8, dtype=torch.int64, device=meta), {"k": k})
    flags = torch.empty(8, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="no stage-predicate kernel"):
        cs.seed_marks(k, k, flags, 100)
    with pytest.raises(ValueError, match="no stage-predicate kernel"):
        cs.fold_marks({}, flags, 150)
    sig = {key: (torch.empty(8, dtype=torch.bool, device=meta) if key == "valid" else k)
           for key in ("pos", "svtype", "valid")}
    with pytest.raises(ValueError, match="no clustering kernel for device meta"):
        tc.sort_and_seed(sig, 100)


def test_nvcc_defines_name_the_thresholds():
    assert cs.nvcc_defines() == ("-DSORT_TINY_MAX=8", "-DSORT_WARP_MAX=256",
                                 "-DSORT_BLOCK_MAX=8192", "-DSORT_RUN_TILE=4096")
    assert cs.run_parts_define(2) == "-DSORT_RUN_PARTS=2"
    with pytest.raises(ValueError):
        cs.run_parts_define(len(cs.RUN_PARTS) + 1)
    from sniffles_tpu_torch.ops import _build
    assert "cluster_sorts" in _build.KERNEL_SOURCES
    assert _build.default_defines("cluster_sorts") == cs.nvcc_defines()
