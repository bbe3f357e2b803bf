#!/usr/bin/env python3
"""Device time of the clustering's segmented sorts and gathers
(`ops/cluster_sorts.py`, the kernels of csrc/cluster_sorts.cu) against
their bound, their plain versions and one PyTorch call, and each tier
threshold from both sides:

    python3 sniffles_tpu_torch/tools/time_cluster_sorts.py [--n 2097152] [--dense DIR] [--split]
        [--cases "engine resplit,engine sort and seed"] [--no-thresholds]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_cluster_sorts.py ...

Sort cases of n elements (`cases`), each a seg_sort call's inputs on the
card as the main path builds them (ops/clustering.py):
  - "engine sort and seed": the engine step's first sort at chip_smoke.py
    phase 10d's inputs (`signatures.synthetic_batch`, n/40 sites, seed 42,
    a genome span of 900 kb): each run of equal (svtype, bin) of the int64
    sort by pos (the tie), read through the sort's permutation, the
    padding left alone;
  - "engine resplit": the step's resplit, each merged segment (the
    relaxation's boundaries) by the masked svlen bin, the invalid
    elements alone;
  - "chain resplit": the same on sim.relax_chain_batch(n) (568 tiled
    36-link chains, merged segments of up to 3,689);
  - "packed": sim.seg_sort_batch's "packed" population (segments of 9 to
    32 elements, the warp tier's packing), the padding alone;
  - "K a segment" (SEGMENT_SIZES): segments of K elements, keys from a
    range of 64 (ties), the tier thresholds' populations.
Each case prints its segment-size histogram (HISTOGRAM_BINS: segments and
elements) and the two lists' counts (the warp tier's, the block tier's).
For each it holds the kernels against the plain version on CPU copies,
then prints the wrapper's device time (CUDA events, the card asleep ahead
of the start event, the mean of REPS calls after one that warms up), the
run pass's, the warp tier's and the block tier's between CUDA events that
the entry point records (split_ms), the plain version's on the card (the
ops/segments.lexsort chain), the one stable torch.sort of the int64
(segment id, key) pair that gives the same permutation (no base; the ids
made beforehand), and the bound: the bytes the function must move at
3.35 TB/s (`sort_bytes`).

Gather cases (`gather_sites`): every gather_columns call of the main
paths on its own real inputs, captured as the stage calls it: the engine
step's sort and seed (a global permutation) and resplit on the engine's
batch; the call task's sort and seed, fold, resplit_child_ids and both
phase_tallies sorts on sim.fuzz_call_batch(1, n); with --dense DIR, the
five gathers of dense3's widest call task (tools/profile_call_task.py's
dense leg, written to DIR on its first run). Each is held against its
plain version and timed beside the plain version (an index a column), the
library call (torch.index_select, one call a column) and its bound
(`gather_bytes`). Then the resplit's predicate (seg_marks) against its
plain version, and a call task's five gathers summed at n = 2^15 to 2^21
(`task_gathers_by_size`: where the kernel's chunk shrinks to fill the
card and where it does not).

--split builds csrc/cluster_sorts.cu with ops/cluster_sorts.PHASE_CLOCKS
and prints, for each sort case, the warp tier's cycles by phase (its
list entries and keys loaded, ranked, written), summed over its warps,
and the run pass's time by part (ops/cluster_sorts.RUN_PARTS: the
heads, each head's next head, the lists' appends, the thread tier; and
the memset ahead of it), from its variants that stop after each part
(`run_split`). --cases A,B times only the sort cases so named (no
gathers, no task sizes).
Then, for each threshold of ops/cluster_sorts.TIERS, its populations
through the tier on either side of it, each side a build of its own (all
built at once first), ptxas's registers and spills of every kernel, and
the card's nvidia-smi name and power limit. `kernel_rows` gives
chip_smoke.py its rows of the kernels. A package without a feature (an
older tree under PYTHONPATH: no phase clocks) is timed without it. Needs
a CUDA card; `--device cpu` builds every case at a small n and holds the
segmented formulation and every captured gather against the plain
versions (a dry run).
"""
import argparse
import contextlib
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

REPS = 10
SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of each call
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, at the full 700 W power limit
SEGMENT_SIZES = (1, 4, 8, 9, 16, 32, 33, 64, 65, 256, 257, 512, 8192, 8193, 16384)
HISTOGRAM_BINS = ((1, 1), (2, 8), (9, 16), (17, 32), (33, 64), (65, 256), (257, 8192),
                  (8193, None))
PHASES = ("loads", "ranks", "writes")      # csrc/cluster_sorts.cu Phase
INT32_MAX = 2 ** 31 - 1
# the kernels of csrc/cluster_sorts.cu, as ptxas names them
KERNEL_NAMES = ("seg_runs", "seg_tiers", "seg_gather", "seg_marks")
ENGINE_PARAMS = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
                     cluster_merge_bnd=1000, global_repeat=False, binsize=100)
CLUSTER_PARAMS = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
                      cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50,
                      exact_sweep=False)


def engine_signatures(n: int, device: str) -> dict:
    from sniffles_tpu_torch.signatures import synthetic_batch
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in synthetic_batch(
        n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict().items()}


def engine_sorts(sig: dict) -> dict:
    """{case: (seg_start, k1, k2, base, alone, segment ids)} of the engine step's two
    sorts on `sig` (tensors of one device; the resplit's boundaries from the
    step's own sort and relaxation there), and the resplit's predicate
    inputs under "marks"."""
    from sniffles_tpu_torch.ops import clustering as tc, segments as ts
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    from sniffles_tpu_torch.ops.merge_relax import merge_relax
    valid = sig["valid"]
    bin0 = torch.div(sig["pos"], 100, rounding_mode="floor")
    key, first = torch.sort(tc.seed_key(torch.where(valid, sig["svtype"], INT32_MAX),
                                        torch.where(valid, bin0, INT32_MAX)), stable=True)
    starts = tc._starts(key)
    tie = torch.where(valid, sig["pos"], INT32_MAX)
    # as sort_and_seed: the padding alone unless a valid slot shares its key
    shared = (valid & (sig["svtype"] == INT32_MAX) & (bin0 == INT32_MAX)).any()
    alone = ~(valid | shared)
    seg = ts.segment_ids_from_boundaries(cso.seg_heads(starts, alone[first]))
    out = {"engine sort and seed": (starts, tie, None, first, alone, seg)}
    s, boundary, bin_ = tc.sort_and_seed(sig, 100)
    boundary, _ = merge_relax(s, boundary, bin_, **ENGINE_PARAMS)
    svbin = torch.div(s["svlen"].abs(), 20, rounding_mode="floor") * 20
    seg = ts.segment_ids_from_boundaries(boundary)
    alone = ~s["valid"]
    out["resplit"] = (boundary, torch.where(s["valid"], svbin, INT32_MAX), None, None, alone,
                      ts.segment_ids_from_boundaries(cso.seg_heads(boundary, alone)))
    # the resplit's predicate inputs: its columns in its order
    order = cso.seg_sort(*out["resplit"][:5])
    out["marks"] = (seg[order], svbin[order], s["svtype"][order])
    return out


def cases(n: int, device: str) -> dict:
    """{case: (seg_start, k1, k2, base, alone, segment ids)} on `device`, and
    "marks": the engine resplit's predicate inputs."""
    from sniffles_tpu_torch.sim import SEG_SORT_KINDS, relax_chain_batch, seg_sort_batch
    engine = engine_sorts(engine_signatures(n, device))
    out = {"engine sort and seed": engine["engine sort and seed"],
           "engine resplit": engine["resplit"]}
    chain = {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in relax_chain_batch(n).items()}
    out["chain resplit"] = engine_sorts(chain)["resplit"]
    if "packed" in SEG_SORT_KINDS:      # an older package has no such population
        b = seg_sort_batch("packed", n, 5)
        seg = torch.from_numpy(b["seg_id"]).to(device)
        out["packed"] = (_starts(seg), torch.from_numpy(b["k1"]).to(device),
                         torch.from_numpy(b["k2"]).to(device), None,
                         torch.from_numpy(~b["valid"]).to(device), seg)
    rng = np.random.default_rng(11)
    for k in SEGMENT_SIZES:
        seg = torch.arange(n, dtype=torch.int32, device=device) // k
        out[f"{k} a segment"] = (_starts(seg), torch.from_numpy(
            rng.integers(0, 64, n).astype(np.int32)).to(device), None, None, None, seg)
    out["marks"] = engine["marks"]
    return out


def _starts(seg):
    from sniffles_tpu_torch.ops.clustering import _starts as starts
    return starts(seg)


def segment_sizes(seg: torch.Tensor) -> np.ndarray:
    """Each segment's element count, from a case's segment ids (0, 1, ... in
    array order; the elements alone segments of their own)."""
    return np.bincount(seg.cpu().numpy().astype(np.int64))


def tiny_elements(seg: torch.Tensor, tiny: int) -> int:
    """The elements in segments of at most `tiny` (the thread tier's)."""
    sizes = segment_sizes(seg)
    return int(sizes[sizes <= tiny].sum())


def histogram(seg: torch.Tensor, tiers: tuple) -> str:
    """The case's segments and elements in each of HISTOGRAM_BINS, and the
    two lists' counts under `tiers` (the warp list: segments of tiny + 1 to
    warp elements; the block list: larger ones)."""
    sizes = segment_sizes(seg)
    parts = []
    for lo, hi in HISTOGRAM_BINS:
        pick = (sizes >= lo) & (sizes <= (hi if hi is not None else sizes.max(initial=0)))
        label = f"{lo}" if lo == hi else f"{lo}-{hi}" if hi else f">{lo - 1}"
        parts.append(f"{label}: {int(pick.sum())} ({int(sizes[pick].sum())} elements)")
    tiny, warp = tiers[0], tiers[1]
    warp_list = int(((sizes > tiny) & (sizes <= warp)).sum())
    block_list = int((sizes > warp).sum())
    return (f"segments {'; '.join(parts)}; warp list {warp_list}, block list {block_list}")


def sort_bytes(n: int, tiny: int, with_k2: bool, with_base: bool, with_alone: bool) -> tuple:
    """(run pass, tiers) bytes the function must move: seg_start and alone
    (where given) read once by the run pass, and where alone is read
    through a base permutation, the base entry too (alone[base[x]]); each
    element's keys (k1, k2 where given, the base entry where given) read
    once and its int64 permutation entry written once, by the tier that
    sorts it (tiny: the thread tier's elements)."""
    per = 4 + 4 * with_k2 + 8 * with_base + 8
    runs = n * (1 + with_alone + 8 * (with_alone and with_base))
    return runs + tiny * per, (n - tiny) * per


def gather_bytes(order: torch.Tensor, columns: dict) -> int:
    """The permutation read once, each column's element read and written once."""
    n = order.shape[0]
    return n * 8 + sum(2 * n * v.element_size() for v in columns.values()
                       if isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == n)


def queued_ms(fn) -> float:
    """Device ms of fn() between two CUDA events, the mean of REPS calls
    after one that warms up, the card asleep ahead of the start event."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(REPS + 1):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    return total / REPS


def split_ms(case, run_parts: int | None = None) -> dict:
    """{"seg_runs": ms (the run pass with its memset), "seg_tiers": ms,
    and "memset", "run pass" where the package names its events apart}:
    the entry point's own CUDA events around each part, the mean of REPS
    calls after one that warms up, the card asleep ahead of each.
    `run_parts`: the run pass's variant that stops after that part
    (ops/cluster_sorts.run_parts_define)."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    parts = getattr(cso, "SORT_EVENT_PARTS", ("run pass and memset", "tiers"))
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
    for e in evs:
        e.record()          # creates the events the entry point records again
    kw = {} if run_parts is None else {"run_parts": run_parts}
    total = np.zeros(len(parts))
    for rep in range(REPS + 1):
        torch.cuda._sleep(SLEEP_CYCLES)
        cso.launch_seg_sort(*case[:5], events=evs, **kw)
        torch.cuda.synchronize()
        if rep:
            total += [evs[i].elapsed_time(evs[i + 1]) for i in range(len(parts))]
    ms = dict(zip(parts, (float(t) for t in total / REPS)))
    if "memset" not in ms:
        return {"seg_runs": ms["run pass and memset"], "seg_tiers": ms["tiers"]}
    return {"seg_runs": ms["memset"] + ms["run pass"], "seg_tiers": ms["tiers"],
            "memset": ms["memset"], "run pass": ms["run pass"]}


def run_split(case) -> dict | None:
    """{part: ms} of the run pass (ops/cluster_sorts.RUN_PARTS): the run
    pass's time (between the entry point's events) in each variant that
    stops after part k, less the one before it, and "memset"; None where
    the package has no such variants. Build the variants first
    (build_run_variants)."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    if not hasattr(cso, "RUN_PARTS"):
        return None
    out, before = {}, 0.0
    for k, part in enumerate(cso.RUN_PARTS, start=1):
        ms = split_ms(case, run_parts=k)
        out[part] = ms["run pass"] - before
        before = ms["run pass"]
        out["memset"] = ms["memset"]
    out["run pass"] = before
    return out


def build_run_variants() -> None:
    """Every run-pass variant of the package (run_split's), built at once."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    if not hasattr(cso, "RUN_PARTS"):
        return
    started = [_build.start_build("cluster_sorts", defines=cso.nvcc_defines()
                                  + (cso.run_parts_define(k),))
               for k in range(1, len(cso.RUN_PARTS) + 1)]
    for s in started:
        _build.finish_build(s)


def phase_split(case) -> dict | None:
    """{phase: share of the warp tier's cycles}, and "cycles": their sum
    over the warps, of REPS calls of the PHASE_CLOCKS build; None where
    the package has no such build."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    if not hasattr(cso, "PHASE_CLOCKS"):
        return None
    import ctypes
    fn = _build.load("cluster_sorts", cso.nvcc_defines() + (cso.PHASE_CLOCKS,)).sort_phase_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_uint64 * len(PHASES))()
    cso.launch_seg_sort(*case[:5], clocks=True)
    torch.cuda.synchronize()
    if fn(out) != 0:                    # zeroes the sums after the warm-up call
        raise SystemExit("time_cluster_sorts: reading the phase clocks failed")
    for _ in range(REPS):
        cso.launch_seg_sort(*case[:5], clocks=True)
    torch.cuda.synchronize()
    if fn(out) != 0:
        raise SystemExit("time_cluster_sorts: reading the phase clocks failed")
    cycles = [int(v) for v in out]
    total = sum(cycles)
    return {"cycles": total / REPS,
            **{p: (c / total if total else 0.0) for p, c in zip(PHASES, cycles)}}


def library_sort(case):
    """The one torch.sort that gives the case's permutation where there is
    one (no base): the stable sort of segment id * 2^32 + (k1 + 2^31), the
    ids those of the segments with the elements alone as their own."""
    seg_start, k1, k2, base, _, seg = case
    if base is not None or k2 is not None:
        return None
    key = seg.to(torch.int64) * (1 << 32) + (k1.to(torch.int64) + (1 << 31))
    return lambda: torch.sort(key, stable=True)


def hold(case, label, tiers=None) -> torch.Tensor:
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    want = cso.seg_sort_plain(*(None if t is None else t.cpu() for t in case[:5]))
    got = (cso.seg_sort(*case[:5]) if tiers is None
           else cso.launch_seg_sort(*case[:5], tiers=tiers))
    if not torch.equal(got.cpu(), want):
        raise SystemExit(f"time_cluster_sorts: {label}: the kernels differ from the plain version")
    return want


def sort_row(case, label) -> dict:
    """The kernels of one case held and timed: ms (the wrapper), by kernel
    and tier, plain_ms, library_ms, the bounds."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    seg_start, k1, k2, base, alone, seg = case
    want = hold(case, label)
    lib = library_sort(case)
    if lib is not None and not torch.equal(lib().indices.cpu(), want):
        raise SystemExit(f"time_cluster_sorts: {label}: the library sort differs")
    tiny = tiny_elements(seg, cso.TIERS[0])
    runs_b, tiers_b = sort_bytes(k1.shape[0], tiny, k2 is not None, base is not None,
                                 alone is not None)
    return {"ms": queued_ms(lambda: cso.seg_sort(*case[:5])),
            "split": split_ms(case),
            "plain_ms": queued_ms(lambda: cso.seg_sort_plain(*case[:5])),
            "library_ms": queued_ms(lib) if lib is not None else None,
            "bytes": (runs_b, tiers_b),
            "bound_ms": (runs_b + tiers_b) / HBM_BYTES_PER_S * 1e3}


@contextlib.contextmanager
def captured_gathers(segmented: bool):
    """Every gather_columns call of the block as [(stage, order, columns)],
    the stage named by the calling function (a second call of one stage
    numbered); copies of the inputs. With `segmented`, the stages take their
    segmented formulation on CPU tensors too (ops/clustering.on_card)."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso, clustering as tc
    real, real_on_card, kept = cso.gather_columns, tc.on_card, []

    def keep(order, columns, *args, **kw):
        stage = sys._getframe(1).f_code.co_name
        seen = sum(1 for s, _, _ in kept if s.split(" (")[0] == stage)
        kept.append((f"{stage} ({seen + 1})" if seen else stage, order.clone(),
                     {k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in columns.items()}))
        return real(order, columns, *args, **kw)
    cso.gather_columns = keep
    if segmented:
        tc.on_card = lambda t, what: True
    try:
        yield kept
    finally:
        cso.gather_columns, tc.on_card = real, real_on_card


def gather_sites(n: int, device: str, dense_dir: str | None = None,
                 call_task: bool = True) -> dict:
    """{label: (order, columns)}: every gather_columns call of the engine's
    clustering on its batch at n, of a call task on sim.fuzz_call_batch(1,
    n) (with `call_task`), and (dense_dir) of dense3's widest call task."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import fuzz_call_batch
    from sniffles_tpu_torch.tools.profile_call_task import call_meta, dense_largest
    meta = call_meta()
    out = {}
    with captured_gathers(device == "cpu") as kept:
        tc.cluster_signatures(engine_signatures(n, device), **CLUSTER_PARAMS)
    out.update((f"engine {stage}", (order, cols)) for stage, order, cols in kept)
    if call_task:
        with captured_gathers(device == "cpu") as kept:
            tc.call_task_packed(torch.as_tensor(fuzz_call_batch(1, n)).to(device), **meta)
        out.update((f"fuzz {stage}", (order, cols)) for stage, order, cols in kept)
    if dense_dir:
        packed = dense_largest(dense_dir, device)
        with captured_gathers(device == "cpu") as kept:
            tc.call_task_packed(torch.as_tensor(packed).to(device), **meta)
        out.update((f"dense3 largest {stage} (n = {packed.shape[1]})", (order, cols))
                   for stage, order, cols in kept)
    return out


TASK_SIZES = tuple(1 << k for k in range(15, 22))
TASK_N = 1 << 16     # dense3's widest call task (chip_smoke.py phase 4)


def task_gathers_by_size(device: str = "cuda") -> list:
    """[(n, ms)]: the five gathers of a call task on sim.fuzz_call_batch(1,
    n), each held and timed, summed, for n in TASK_SIZES."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import fuzz_call_batch
    from sniffles_tpu_torch.tools.profile_call_task import call_meta
    meta, out = call_meta(), []
    for n in TASK_SIZES:
        with captured_gathers(device == "cpu") as kept:
            tc.call_task_packed(torch.as_tensor(fuzz_call_batch(1, n)).to(device), **meta)
        total = 0.0
        for stage, order, cols in kept:
            hold_gather(order, cols, f"{stage} at n = {n}")
            if device != "cpu":
                total += queued_ms(lambda: run_gather(order, cols))
        out.append((n, total))
    return out


def run_gather(order, columns):
    """The package's gather: the kernel on CUDA tensors, the plain version
    on CPU ones."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    return cso.gather_columns(order, columns)


def hold_gather(order, columns, label) -> None:
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    want = cso.gather_columns_plain(order.cpu(), {k: v.cpu() if isinstance(v, torch.Tensor)
                                                  else v for k, v in columns.items()})
    got = run_gather(order, columns)
    for k, v in want.items():
        if isinstance(v, torch.Tensor) and not torch.equal(got[k].cpu(), v):
            raise SystemExit(f"time_cluster_sorts: {label}: the gather differs from the plain "
                             f"version ({k})")


def library_gather(order, columns):
    """torch's own index, one call a column (index_select)."""
    n = order.shape[0]
    cols = [v for v in columns.values()
            if isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == n]
    return lambda: [torch.index_select(v, 0, order) for v in cols]


def gather_row(order, columns, label="gather") -> dict:
    """One call site's gather held and timed: {ms, plain_ms, library_ms,
    bytes, bound_ms, columns}."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    hold_gather(order, columns, label)
    b = gather_bytes(order, columns)
    return {"ms": queued_ms(lambda: run_gather(order, columns)),
            "plain_ms": queued_ms(lambda: cso.gather_columns_plain(order, columns)),
            "library_ms": queued_ms(library_gather(order, columns)), "bytes": b,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3,
            "columns": sum(1 for v in columns.values() if isinstance(v, torch.Tensor)
                           and v.dim() == 1 and v.shape[0] == order.shape[0])}


def marks_row(seg, svbin, svtype) -> dict:
    """The resplit's predicate (seg_marks, one launch) held against its plain
    version on CPU copies and timed beside it; its bound: the three int32
    columns read and the flags written."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    dev = svbin.device
    lo, cml = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (50.0, 0.22))
    want = cso.resplit_marks_plain(seg.cpu(), svbin.cpu(), svtype.cpu(), lo.cpu(), cml.cpu())
    if not torch.equal(cso.resplit_marks(seg, svbin, svtype, lo, cml).cpu(), want):
        raise SystemExit("time_cluster_sorts: the resplit's marks differ from the plain version")
    b = 13 * svbin.shape[0]
    return {"ms": queued_ms(lambda: cso.resplit_marks(seg, svbin, svtype, lo, cml)),
            "plain_ms": queued_ms(lambda: cso.resplit_marks_plain(seg, svbin, svtype, lo, cml)),
            "library_ms": None, "bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3}


def kernel_rows(n: int = 1 << 21) -> dict:
    """chip_smoke.py's rows of the kernels at the engine step's n, each held
    against its plain version first: seg_runs and seg_tiers on the
    resplit's sort (the one with a torch.sort of the same permutation,
    between the entry point's CUDA events), seg_gather on sort and seed's
    gather (a random permutation, 10 columns: PR 16's site), seg_marks on
    the resplit's predicate; plain_ms the plain version of the wrapper on
    the card, library_ms one PyTorch call of the same function where there
    is one (torch.sort; index_select, one call a column), bound_ms the
    bytes of each kernel's part of the function. Under "wrappers" also
    sort and seed's sort (alone read through its base permutation), the
    resplit's gather (a local permutation) and a call task's fold at
    TASK_N."""
    c = cases(n, "cuda")
    r = sort_row(c["engine resplit"], "engine resplit")
    seed = sort_row(c["engine sort and seed"], "engine sort and seed")
    sites = gather_sites(n, "cuda", call_task=False)
    glob = gather_row(*sites["engine sort_and_seed"], "engine sort_and_seed")
    local = gather_row(*sites["engine _resplit"], "engine _resplit")
    task = gather_row(*gather_sites(TASK_N, "cuda")["fuzz merge_inner_fold"],
                      "a call task's fold")
    m = marks_row(*c["marks"])
    common = {"max_abs_err": 0, "bound_by": "bytes"}
    to_ms = 1e3 / HBM_BYTES_PER_S
    return {
        "seg_runs": {**common, "ms": r["split"]["seg_runs"],
                     "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                     "bound_ms": r["bytes"][0] * to_ms},
        "seg_tiers": {**common, "ms": r["split"]["seg_tiers"],
                      "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                      "bound_ms": r["bytes"][1] * to_ms},
        "seg_gather": {**common, "ms": glob["ms"], "plain_ms": glob["plain_ms"],
                       "library_ms": glob["library_ms"], "bound_ms": glob["bound_ms"]},
        "seg_marks": {**common, "ms": m["ms"], "plain_ms": m["plain_ms"], "library_ms": None,
                      "bound_ms": m["bound_ms"]},
        "wrappers": {"seg_sort": r, "seg_sort (sort and seed)": seed,
                     "gather_columns (sort and seed)": glob,
                     "gather_columns (resplit)": local, "gather_columns (a call task)": task,
                     "resplit_marks": m}}


def threshold_cases(tiers: tuple) -> list:
    """(case, [(label, tiers)]): each threshold's populations through the
    tier on either side of it (tiers as ops/cluster_sorts.TIERS), and the
    engine's sorts under a warp tier of twice the room (fewer warps an SM)."""
    t, w, b = tiers
    return [("4 a segment", [(f"thread tier (tiny {t})", (t, w, b)),
                             ("warp tier (tiny 2)", (2, w, b))]),
            ("8 a segment", [(f"thread tier (tiny {t})", (t, w, b)),
                             ("warp tier (tiny 4)", (4, w, b)),
                             ("warp tier (tiny 2)", (2, w, b))]),
            ("packed", [(f"tiny {t}", (t, w, b)), ("tiny 4", (4, w, b))]),
            ("256 a segment", [(f"warp tier (warp {w})", (t, w, b)),
                               ("block tier (warp 255)", (t, 255, b))]),
            ("512 a segment", [(f"block tier (warp {w})", (t, w, b)),
                               ("warp tier (warp 512)", (t, 512, b))]),
            ("engine sort and seed", [(f"warp {w}", (t, w, b)), ("warp 512", (t, 512, b)),
                                      ("tiny 4", (4, w, b)), ("block 4096", (t, w, 4096))]),
            ("engine resplit", [(f"warp {w}", (t, w, b)), ("warp 512", (t, 512, b)),
                                ("tiny 4", (4, w, b)), ("block 4096", (t, w, 4096))]),
            ("8192 a segment", [(f"block in shared memory (block {b})", (t, w, b)),
                                ("block over global scratch (block 8191)", (t, w, 8191)),
                                ("one block an SM (block 16384)", (t, w, 16384))]),
            ("16384 a segment", [(f"block over global scratch (block {b})", (t, w, b)),
                                 ("block in shared memory (block 16384)", (t, w, 16384))]),
            ("chain resplit", [(f"block {b}", (t, w, b)), ("block 4096", (t, w, 4096)),
                               ("one block an SM (block 16384)", (t, w, 16384))])]


def dry_run(n: int) -> int:
    """--device cpu: every sort case built and held (the plain version on
    both sides), its histogram, and every gather call site captured on the
    segmented formulation and held against the plain version."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    for label, case in cases(n, "cpu").items():
        if label != "marks":
            hold(case, label)
            print(f"{label}: {n} elements, {int(case[0].sum())} segments; "
                  f"{histogram(case[5], cso.TIERS)}")
    for label, (order, cols) in gather_sites(n, "cpu").items():
        hold_gather(order, cols, label)
        columns = sum(1 for v in cols.values() if isinstance(v, torch.Tensor) and v.dim() == 1
                      and v.shape[0] == order.shape[0])
        print(f"gather {label}: {columns} columns, {gather_bytes(order, cols)} bytes == plain")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dense", default=None, help="directory of the dense leg's BAM")
    ap.add_argument("--split", action="store_true",
                    help="the warp tier's cycles by phase (a PHASE_CLOCKS build)")
    ap.add_argument("--no-thresholds", action="store_true")
    ap.add_argument("--cases", default="",
                    help="only these sort cases, comma-separated (no gathers)")
    args = ap.parse_args()
    only = [c for c in args.cases.split(",") if c]
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    print(f"time_cluster_sorts: the package at "
          f"{os.path.dirname(os.path.dirname(os.path.dirname(cso.__file__)))}", flush=True)
    if args.device == "cpu":
        return dry_run(args.n)
    if not torch.cuda.is_available():
        print("time_cluster_sorts: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import _build
    all_cases = cases(args.n, "cuda")
    if only:
        unknown = set(only) - set(all_cases)
        if unknown:
            raise SystemExit(f"time_cluster_sorts: no case {', '.join(sorted(unknown))}")
        all_cases = {k: v for k, v in all_cases.items() if k in only}
    if args.split:
        build_run_variants()
    for label, case in all_cases.items():
        if label == "marks":
            r = marks_row(*case)
            print(f"the engine resplit's predicate (seg_marks): == plain (bit-exact); "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bytes']} bytes), {100 * r['bound_ms'] / r['ms']:.1f} % of it",
                  flush=True)
            continue
        print(f"{label}: {histogram(case[5], cso.TIERS)}", flush=True)
        r = sort_row(case, label)
        lib = f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "none"
        split = ", ".join(f"{k} {v:.4f} ms" for k, v in r["split"].items())
        tiers_bound = r["bytes"][1] / HBM_BYTES_PER_S * 1e3
        print(f"  == plain (bit-exact); the wrapper {r['ms']:.4f} ms ({split}), plain "
              f"{r['plain_ms']:.4f} ms, torch.sort {lib} ms, bound {r['bound_ms']:.5f} ms "
              f"({sum(r['bytes'])} bytes), {100 * r['bound_ms'] / r['ms']:.1f} % of it; the "
              f"tiers' bound {tiers_bound:.5f} ms, "
              f"{100 * tiers_bound / max(r['split']['seg_tiers'], 1e-9):.1f} % of them",
              flush=True)
        if args.split:
            ph = phase_split(case)
            print("  warp tier by phase: " + ("no phase clocks in this package" if ph is None
                  else f"{ph['cycles']:.4g} warp-cycles a call; " + ", ".join(
                      f"{p} {100 * ph[p]:.1f} %" for p in PHASES)), flush=True)
            rs = run_split(case)
            print("  run pass by part: " + ("no run-pass variants in this package" if rs is None
                  else ", ".join(f"{k} {v:.4f} ms" for k, v in rs.items())), flush=True)
    if only:
        print_ptxas()
        print(smi_line())
        return 0
    for label, (order, cols) in gather_sites(args.n, "cuda", args.dense).items():
        r = gather_row(order, cols, label)
        print(f"gather {label}: {r['columns']} columns, == plain; {r['ms']:.4f} ms "
              f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound); plain "
              f"{r['plain_ms']:.4f} ms, index_select a column {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bytes']} bytes)", flush=True)
    for n, total in task_gathers_by_size():
        print(f"gather at n = {n}, a call task's five gathers summed: {total:.4f} ms",
              flush=True)
    if not args.no_thresholds:
        variants = {tiers for _, sides in threshold_cases(cso.TIERS) for _, tiers in sides}
        started = [_build.start_build("cluster_sorts", defines=cso.nvcc_defines(v))
                   for v in variants]
        for s in started:
            _build.finish_build(s)
        for label, sides in threshold_cases(cso.TIERS):
            case = all_cases.get(label)
            if case is None:
                continue
            times = []
            for side, tiers in sides:
                hold(case, label, tiers)
                ms = queued_ms(lambda: cso.launch_seg_sort(*case[:5], tiers=tiers))
                times.append(f"{side} {ms:.4f} ms")
            print(f"threshold, {label}: the kernels (== plain): {'; '.join(times)}", flush=True)
    print_ptxas()
    print(smi_line())
    return 0


def print_ptxas() -> None:
    """ptxas's registers, shared memory and spills of each kernel."""
    from sniffles_tpu_torch.ops import _build
    log = _build.finish_build(_build.start_build("cluster_sorts", ptxas_verbose=True))
    kernel = None
    for line in log.splitlines():
        if "Function properties" in line or "Compiling entry" in line:
            kernel = next((k for k in KERNEL_NAMES if k in line), "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"


if __name__ == "__main__":
    sys.exit(main())
