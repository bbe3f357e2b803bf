"""The layouts the redesigned kernels rely on, on the CPU, through small
Python mirrors of the kernels' index rules (their constants read from the
sources):

  - the call statistics' sort keys (ops/call_stats.sort_keys_plain, the
    plain version of stat_keys) and the run pass of csrc/call_stats.cu
    (stat_runs: the merge path of the slot ids 0..2n-1 and the sorted keys,
    a block a run of tiles, the first tile's split by a warp's probes, each
    thread's split in the tile's window, the merge steps): every slot's run
    start against torch.searchsorted and numpy, every invalid mark against
    the raw ids, on n = 1, n off the tile, all invalid, one cluster of n,
    the last slot live, K a slot, diagonals inside a run, ids outside
    [0, n);
  - the sweep's partition of csrc/merge_sweep.cu (sweep_cuts: the passes
    over the candidate cuts alone, a bit each, neighbours from the words'
    bits and the scans of their last and first alive cuts) against
    sweep_cuts_plain: cut flags, heads and counts, the fixpoint's collapse
    at pass 24 included;
  - the candidate tail's run pass of csrc/candidate_tail.cu (tail_runs: the
    ids before the first 16-byte boundary and after the last vector by
    scalar loads, int4 vectors in chunks dealt to the warps, kRunVecs a
    lane a round, each element's left neighbour from the previous lane or
    the chunk's last vector before it): every element visited once, every
    start written once, the starts against tail_runs_plain and numpy on
    n = 1, n off a lane's and a chunk's ids, one cluster of n, a cluster an
    element, gaps, leading negative ids, ids at and past n, and views at an
    offset of 1-3 int32 from a 16-byte boundary; and tail_runs_plain's
    starts, summed as the kernel sums a cluster's NM, against the JAX
    package's seg_mean.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from sniffles_tpu_torch.ops import call_stats as cs
from sniffles_tpu_torch.ops import candidate_tail as ct
from sniffles_tpu_torch.ops import clustering as tc
from sniffles_tpu_torch.sim import (edge_call_batches, fuzz_call_batch, sweep_layout_batches,
                                    tail_run_layouts)

INT32_MAX = 2 ** 31 - 1
CSRC = os.path.join(os.path.dirname(cs.__file__), "..", "csrc")


def const(source, name):
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(rf"constexpr (?:int|unsigned) {name} = (\d+);", text).group(1))


RUN_THREADS = const("call_stats.cu", "kRunThreads")
RUN_ITEMS = const("call_stats.cu", "kRunItems")
PROBES = const("call_stats.cu", "kProbes")


# ---------------------------------------------------------------------------
# the run pass


def first_split(keys, n, d, probes=PROBES):
    """first_split: the slots among the first d items of the merge, by
    rounds of 32 * probes probes."""
    lo, hi = max(0, d - n), min(d, 2 * n)
    width = 32 * probes
    while lo < hi:
        step = -(-(hi - lo) // width)
        ahead = sum(1 for k in range(width)
                    if lo + k * step < hi and lo + k * step <= keys[d - 1 - (lo + k * step)])
        if ahead == 0:
            hi = lo
        else:
            last = lo + (ahead - 1) * step
            hi, lo = min(hi, last + step), last + 1
    return lo


def run_pass(keys, n, threads=RUN_THREADS, items=RUN_ITEMS, grid=None):
    """stat_runs on the sorted keys (a list): (starts [n + 1], marks [n]),
    every entry written exactly once, and each block's first split; grid
    blocks (the kernel's resident grid, at most the tiles), each a run of
    tiles of threads * items diagonals."""
    tile = threads * items
    total = 3 * n
    tiles = -(-total // tile)
    grid = min(tiles, grid or 132 * 4)
    starts, marks, firsts = [None] * (n + 1), [None] * n, []
    for blk in range(grid):
        first, last = tiles * blk // grid, tiles * (blk + 1) // grid
        if first >= last:
            continue
        d0 = first * tile
        i0 = first_split(keys, n, d0)
        j0 = d0 - i0
        firsts.append((i0, j0))
        for _ in range(first, last):
            dn = min(tile, total - d0)
            win = [keys[j0 + k] if k < n - j0 else INT32_MAX for k in range(dn + 1)]
            nb, na = min(dn, n - j0), min(dn, 2 * n - i0)

            def tile_split(dt):
                lo, hi = max(0, dt - nb), min(dt, na)
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if i0 + mid <= win[dt - 1 - mid]:
                        lo = mid + 1
                    else:
                        hi = mid
                return lo
            taken = tile_split(dn)      # the tile's end split, the next tile's start
            tslot, end = {}, set()
            for t in range(threads):
                dt = min(t * items, dn)
                de = min(dt + items, dn)
                i = tile_split(dt)
                j = dt - i
                b = win[j]
                for _step in range(dt, de):
                    if i < na and i0 + i <= b:
                        assert i not in tslot
                        tslot[i] = (j0 + j, i0 + i == b)
                        i += 1
                    else:
                        j += 1
                        b = win[j]
                if de == dn:
                    end.add(i)
            assert end == {taken}      # the last thread's merge ends at the end split
            assert sorted(tslot) == list(range(taken))
            for k in range(taken):
                a = i0 + k
                if a <= n:
                    assert starts[a] is None
                    starts[a] = tslot[k][0]
                if a >= n:
                    assert marks[a - n] is None
                    marks[a - n] = tslot[k][1]
            i0 += taken
            j0 += dn - taken
            d0 += dn
    assert None not in starts and None not in marks
    return starts, marks, firsts


def layout_case(cid, valid):
    return {"cluster_id": torch.as_tensor(np.asarray(cid, dtype=np.int32)),
            "valid": torch.as_tensor(np.asarray(valid, dtype=bool))}


def held_layout(cid, valid, **kw):
    """The mirror's starts and marks against torch.searchsorted and numpy
    on the sort of sort_keys_plain; the keys against their rule."""
    c = layout_case(cid, valid)
    n = len(cid)
    keys = cs.sort_keys_plain(c)
    cid_np, valid_np = np.asarray(cid, dtype=np.int64), np.asarray(valid, dtype=bool)
    inside = (cid_np >= 0) & (cid_np < n)
    want_keys = np.where(inside, np.where(valid_np, cid_np, cid_np + n), INT32_MAX)
    assert keys.dtype == torch.int32 and keys.tolist() == want_keys.tolist()
    sorted_keys, order = cs.sorted_ids(c)
    assert order.tolist() == sorted(range(n), key=lambda i: (int(want_keys[i]), i))
    starts, marks, firsts = run_pass(sorted_keys.tolist(), n, **kw)
    slots = torch.arange(n + 1, dtype=torch.int32)
    assert starts == torch.searchsorted(sorted_keys, slots).tolist()
    counts = np.bincount(cid_np[inside & valid_np], minlength=n)
    assert starts == np.concatenate([[0], np.cumsum(counts)]).tolist()
    named = np.zeros(n, dtype=bool)
    named[cid_np[inside & ~valid_np]] = True
    assert marks == named.tolist()
    return sorted_keys.tolist(), firsts


LAYOUTS = {
    "one valid": ([0], [True]),
    "one invalid": ([0], [False]),
    "one outside": ([5], [True]),
    "n off the tile": (list(np.random.default_rng(1).integers(0, 700, 2049)),
                       list(np.random.default_rng(2).random(2049) < 0.8)),
    "all invalid": (list(np.random.default_rng(3).integers(0, 3000, 3001)), [False] * 3001),
    "one cluster of n": ([0] * 4099, [True] * 4099),
    "the last slot live": ([4096] * 3 + [0] * 4094, [True] * 4097),
    "K a slot": ([i // 37 for i in range(5000)], [True] * 5000),
    "outside ids": ([-5, 9000, INT32_MAX, -1, 3, 3, 7, 1] * 300, [True, True, True, False] * 600),
}


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_run_layout_against_searchsorted(label):
    cid, valid = LAYOUTS[label]
    held_layout(cid, valid)


@pytest.mark.parametrize("threads,items,grid", [(4, 3, 5), (2, 5, 1), (8, 2, 64), (3, 1, 2)])
def test_run_layout_on_small_tiles(threads, items, grid):
    """Tiles of a few diagonals: many tiles a block, blocks whose first
    split falls inside a run (a cluster of 40 over tiles of 12), each edge
    layout."""
    rng = np.random.default_rng(threads * 100 + items)
    cid = [0] * 40 + list(rng.integers(0, 30, 60)) + [55] * 7
    valid = [True] * 40 + list(rng.random(60) < 0.7) + [True] * 7
    keys, firsts = held_layout(cid, valid, threads=threads, items=items, grid=grid)
    inside = [(i, j) for i, j in firsts if 0 < j < len(keys) and keys[j - 1] == keys[j]]
    assert inside or grid < 64
    for label in ("one valid", "one invalid", "all invalid", "the last slot live",
                  "one cluster of n"):
        cid, valid = LAYOUTS[label]
        held_layout(cid[:300], valid[:300], threads=threads, items=items, grid=grid)


def test_first_split_is_the_merge_path():
    """The warp's probes find the split of every diagonal (a linear merge
    gives each), on keys with long gaps and long runs."""
    n = 500
    keys = sorted([3] * 200 + [4] * 50 + [499] * 100 + [n + 7] * 50 + [INT32_MAX] * 100)
    i = j = 0
    for d in range(3 * n + 1):
        assert first_split(keys, n, d) == i, d
        if d == 3 * n:
            break
        if i < 2 * n and (j == n or i <= keys[j]):
            i += 1
        else:
            j += 1
    assert first_split(keys, n, d, probes=1) == i


# ---------------------------------------------------------------------------
# the sweep's partition

F32 = np.float32


def partition(inputs, state, *, cluster_r, cluster_repeat_h_max, cluster_merge_bnd):
    """sweep_cuts' passes over the candidate cuts (see the module's
    docstring): (cut flags of the live seeds, heads, counts)."""
    st = inputs["seed_type"].tolist()
    sb = inputs["start_bp"].tolist()
    eb = state["end_bp"].tolist()
    live = int(inputs["nseeds"][0])
    const_gap = F32(max(float(cluster_merge_bnd), float(cluster_repeat_h_max)))
    r = F32(cluster_r)

    def diff(a, b):    # int32 wrap, as the kernel's
        return F32(np.int32(np.int64(a) - np.int64(b)))
    S, E, P, T = [], [], [], []
    for j in range(live):
        typ = j == 0 or st[j] != st[j - 1]
        ej = eb[j - 1] if j > 0 else 0
        if typ or diff(sb[j], ej) > const_gap:
            S.append(sb[j])
            E.append(ej)
            P.append(j)
            T.append(typ)
    m = len(S)
    words = -(-m // 32)
    alive = [True] * m
    e_last = eb[live - 1] if live else 0
    passes, changed = 0, True
    while changed and passes < tc.MAX_CUT_PASSES:
        passes += 1
        # a word's last alive cut before it and first after it
        bf, af, last = [], [None] * words, -1
        for w in range(words):
            bf.append(last)
            ks = [k for k in range(32 * w, min(32 * w + 32, m)) if alive[k]]
            last = ks[-1] if ks else last
        first = INT32_MAX
        for w in reversed(range(words)):
            af[w] = first
            ks = [k for k in range(32 * w, min(32 * w + 32, m)) if alive[k]]
            first = ks[0] if ks else first
        nxt = list(alive)
        for k in range(m):
            if not alive[k] or T[k]:
                continue
            w = k // 32
            lower = [q for q in range(32 * w, k) if alive[q]]
            upper = [q for q in range(k + 1, min(32 * w + 32, m)) if alive[q]]
            prev = lower[-1] if lower else bf[w]
            nx = upper[0] if upper else af[w]
            assert prev >= 0                        # a type cut lies before every cut
            span_l = diff(E[k], S[prev])
            span_r = diff(E[nx] if nx < m else e_last, S[k])
            nxt[k] = bool(diff(S[k], E[k]) > F32(r * min(span_l, span_r)))
        changed = nxt != alive
        alive = nxt
    if changed:
        alive = list(T)
    heads = [P[k] for k in range(m) if alive[k]]
    cut = np.zeros(live, dtype=np.uint8)
    cut[heads] = 1
    return cut, heads, [0, 0, len(heads), passes, int(changed)]


CUTS = dict(cluster_r=2.5, cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000)


def sweep_case(packed):
    sig = tc.packed_signatures(torch.as_tensor(packed))
    return tc.sweep_inputs(*tc.sort_and_seed(sig, 100), 100)


PARTITION_CASES = {
    **{f"fuzz {seed} {size}": (seed, size, (0, 1, 2, 3, 4))
       for seed, size in ((1, 32768), (2, 2048), (5, 8192))},
    "bnd chains": (3, 2048, (4,)), "del chain": (4, 512, (1,)),
    "single-svtype chain": (99, 4096, (1,)),
    **{f"layout {k}": k for k in sweep_layout_batches()},
    **{f"edge {k}": ("edge", k) for k in edge_call_batches()},
}


@pytest.mark.parametrize("label", list(PARTITION_CASES))
def test_partition_over_candidates_matches_plain(label):
    spec = PARTITION_CASES[label]
    if isinstance(spec, str):
        packed = sweep_layout_batches()[spec]
    elif spec[0] == "edge":
        packed = edge_call_batches()[spec[1]]
    else:
        packed = fuzz_call_batch(spec[0], spec[1], svtypes=spec[2])
    inputs, state = sweep_case(packed)
    cut, heads, counts = partition(inputs, state, **CUTS)
    want_cut, want_heads, want_counts = tc.sweep_cuts_plain(inputs, state, **CUTS)
    live = int(inputs["nseeds"][0])
    assert cut.tolist() == want_cut[:live].tolist()
    assert heads == want_heads.tolist()
    assert counts == want_counts.tolist()
    if label == "layout cascade":
        assert counts[3:] == [tc.MAX_CUT_PASSES, 1]


def test_partition_scratch_and_threshold():
    """The scratch the wrapper gives a task past the shared-memory
    threshold holds the kernel's cand_ints(n) words; the threshold's
    candidates, their 12 bytes and four words a 32 fit a block's shared
    memory beside its static words."""
    src = open(os.path.join(CSRC, "merge_sweep.cu")).read()
    assert "return 3 * static_cast<size_t>(cap) + 4 * cand_words(cap);" in src
    cap = const("merge_sweep.cu", "kSmemCands")
    assert tc.cut_scratch_ints(cap) * 4 <= 232_448 - 3 * 32 * 4
    assert tc.cut_scratch_ints(1) == 3 + 4 and tc.cut_scratch_ints(33) == 99 + 8
    assert math.ceil(cap / 32) * 32 == cap


# ---------------------------------------------------------------------------
# the candidate tail's run pass

TAIL_THREADS = const("candidate_tail.cu", "kRunThreads")
TAIL_VECS = const("candidate_tail.cu", "kRunVecs")


def lane_vectors(vecs, sms, threads=TAIL_THREADS, most_vecs=TAIL_VECS):
    """The launch's vectors a lane: the most (4, 2, 1) whose chunks of 32
    give each of `sms` SMs a block's warps."""
    v = most_vecs
    while v > 1 and vecs // (32 * v) < sms * (threads // 32):
        v //= 2
    return v


def tail_run_pass(cid, offset=0, resident=132 * 8, sms=132, threads=TAIL_THREADS,
                  most_vecs=TAIL_VECS):
    """tail_runs on the ids `cid` (a list) whose element 0 lies `offset`
    int32 past a 16-byte boundary, on a card of `sms` SMs that holds
    `resident` blocks: run_start [n + 1] (None where unwritten); every
    element j in [0, n] visited once and every start written once."""
    n = len(cid)
    head = min((4 - offset % 4) % 4, n)
    vecs = (n - head) // 4
    per_block = threads // 32
    v = lane_vectors(vecs, sms, threads, most_vecs)
    chunk = 32 * v
    chunks = -(-vecs // chunk)
    grid = max(1, min(resident, -(-chunks // per_block)))
    warps = grid * per_block
    per_warp = -(-chunks // warps)
    starts, seen = [None] * (n + 1), [0] * (n + 1)

    def write(prev, cur, j):
        seen[j] += 1
        first = 0 if prev < 0 else (n + 1 if prev >= n else prev + 1)
        for c in range(first, min(cur, n) + 1):
            assert starts[c] is None, (c, j)
            starts[c] = j

    for w in range(warps):
        c0 = min(w * per_warp, chunks)
        c1 = min(c0 + per_warp, chunks)
        carry = cid[head + 4 * c0 * chunk - 1] if c0 < c1 and (c0 > 0 or head > 0) else -1
        for c in range(c0, c1):
            ks = [[c * chunk + u * 32 + lane for lane in range(32)] for u in range(v)]
            x = [[cid[head + 4 * k:head + 4 * k + 4] if k < vecs else [0] * 4 for k in row]
                 for row in ks]
            for u, row in enumerate(ks):
                for lane, k in enumerate(row):
                    if k < vecs:
                        ids = [carry if lane == 0 else x[u][lane - 1][3]] + x[u][lane]
                        for e in range(4):
                            write(ids[e], ids[e + 1], head + 4 * k + e)
                carry = x[u][31][3]
    for j in list(range(head)) + list(range(head + 4 * vecs, n)):
        write(cid[j - 1] if j else -1, cid[j], j)
    last = cid[-1]
    write(last, max(last + 1, 0) if last < n else -1, n)
    assert seen == [1] * (n + 1)
    return starts, v


def searchsorted_starts(cid):
    """run_start's written entries by numpy: the lower bound of each id
    0..clamp(cid[-1] + 1, 0, n)."""
    n = len(cid)
    return np.searchsorted(np.asarray(cid, dtype=np.int64),
                           np.arange(min(max(cid[-1] + 1, 0), n) + 1), side="left").tolist()


def test_tail_run_layout_constants():
    """The ids a lane and a chunk that sim.tail_run_layouts straddles are
    the source's."""
    assert ct.RUN_LANE_IDS == 4 * TAIL_VECS
    assert ct.RUN_CHUNK_IDS == 4 * 32 * TAIL_VECS


TAIL_LAYOUTS = tail_run_layouts(5000)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("label", list(TAIL_LAYOUTS))
def test_tail_run_layouts(label, offset):
    """The kernel's index rules (tail_run_pass) on every edge layout and
    alignment: the written starts == tail_runs_plain == numpy, none past
    them; the wrapper's CPU path takes no kernel."""
    cid = TAIL_LAYOUTS[label].tolist()
    want = searchsorted_starts(cid)
    plain = ct.tail_runs_plain(torch.tensor(cid, dtype=torch.int32))
    assert plain.dtype == torch.int32 and plain.tolist() == want
    assert ct.written_runs(torch.tensor(cid, dtype=torch.int32)) == len(want)
    starts, _ = tail_run_pass(cid, offset)
    assert starts[:len(want)] == want
    assert all(v is None for v in starts[len(want):])


@pytest.mark.parametrize("resident,sms,vecs", [(1, 1, 4), (2, 3, 2), (3, 132, 1), (5, 2, 4)])
def test_tail_run_pass_on_a_small_grid(resident, sms, vecs):
    """Grids of 1-5 blocks: a warp takes several chunks in turn, its carry
    from round to round, at 4, 2 and 1 vectors a lane; views at every
    offset."""
    for label, ids in tail_run_layouts(9000, seed=2).items():
        cid = ids.tolist()
        want = searchsorted_starts(cid)
        for offset in range(4):
            starts, v = tail_run_pass(cid, offset, resident, sms)
            assert starts[:len(want)] == want, (label, offset)
            assert v == vecs or len(cid) < 9000


def test_tail_run_vectors_a_lane_by_size():
    """4 vectors a lane where the chunks fill 132 SMs with a block's warps
    each (the engine's 2^21 ids), 2 and 1 below them: dense3-chr1's 65,536
    ids take 1."""
    fill = 132 * (TAIL_THREADS // 32)
    for n, want in ((1 << 21, 4), (4 * 32 * 4 * fill, 4), (4 * 32 * 4 * fill - 4, 2),
                    (4 * 32 * 2 * fill, 2), (4 * 32 * 2 * fill - 4, 1), (65536, 1), (1, 1)):
        assert lane_vectors(n // 4, 132) == want, n
    assert tail_run_pass(list(range(600)), 0, 1, 132)[1] == 1


def test_tail_run_source_rules():
    """The rules the mirror copies, as the source writes them: the head
    from the pointer's 16-byte offset, a warp's chunks, the left
    neighbours and the vectors a lane."""
    src = open(os.path.join(CSRC, "candidate_tail.cu")).read()
    for rule in ("const int head = std::min(static_cast<int>((16 - at % 16) % 16 / 4), n);",
                 "const int vecs = (n - head) / 4;",
                 "const int c0 = min(warp * per_warp, chunks), c1 = min(c0 + per_warp, chunks);",
                 "const int per_warp = (chunks + grid * kWarps - 1) / (grid * kWarps);",
                 "const int k = c * kChunk + u * 32 + lane;",
                 "const int prev = lane == 0 ? carry : up;",
                 "if (vecs / (32 * 4) >= fill)",
                 "else if (vecs / (32 * 2) >= fill)"):
        assert rule in src, rule


def test_tail_runs_launcher_refuses_cpu_tensors():
    """The run pass's launcher takes CUDA tensors only: on the CPU the tail
    runs its plain version, never a kernel."""
    with pytest.raises(ValueError):
        ct.launch_tail_runs(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("seed", [3, 11])
def test_tail_runs_plain_nm_matches_jax_seg_mean(seed, monkeypatch):
    """tail_runs_plain's starts, each cluster's NM summed over its run in
    array order in float32 as candidate_tail_kernel sums it and divided by
    max(lead_count, 1), == the JAX package's seg_mean (jitted) bit for
    bit, and == the plain tail's nm, on a seeded clustered batch."""
    jax = pytest.importorskip("jax")
    from sniffles_tpu.ops import segments as jseg
    from sniffles_tpu_torch.signatures import synthetic_batch
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")
    n = 4096
    sig = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        3000, 70, seed=seed, genome_span=2_000_000, batch_size=n).as_dict().items()}
    clustered = tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                      cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                      cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
    lead_count = tc.call_statistics(clustered, fused=True)["lead_count"].numpy()
    cid = clustered["cluster_id"].to(torch.int32)
    nm = clustered["nm"].numpy().astype(np.float32)
    valid = clustered["valid"].numpy()
    starts = ct.tail_runs_plain(cid).tolist()
    ours = np.zeros(n, dtype=np.float32)
    for c in range(len(starts) - 1):
        acc = np.float32(0.0)
        for j in range(starts[c], starts[c + 1]):
            acc = np.float32(acc + (nm[j] if valid[j] else np.float32(0.0)))
        ours[c] = acc
    ours = ours / np.maximum(lead_count, 1).astype(np.float32)
    seg_mean = jax.jit(jseg.seg_mean, static_argnums=3)
    want = np.asarray(seg_mean(nm, cid.numpy(), valid, n))
    assert int(cid[-1]) + 2 == len(starts) and len(starts) > 50
    assert ours.view(np.int32).tolist() == want.view(np.int32).tolist()
    plain = ct.cluster_nm_plain(clustered["nm"], clustered["valid"], clustered["cluster_id"],
                                torch.as_tensor(lead_count))
    assert plain.numpy().view(np.int32).tolist() == want.view(np.int32).tolist()
