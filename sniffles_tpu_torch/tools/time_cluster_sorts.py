#!/usr/bin/env python3
"""Device time of the clustering's segmented sorts (`ops/cluster_sorts.py`,
the kernels of csrc/cluster_sorts.cu) against their bound, their plain
versions and one torch.sort, and each tier threshold from both sides:

    python3 sniffles_tpu_torch/tools/time_cluster_sorts.py [--n 2097152]

Cases of n elements (`cases`), each a seg_sort call's inputs on the card
as the main path builds them (ops/clustering.py):
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
  - "K a segment" (SEGMENT_SIZES): segments of K elements, keys from a
    range of 64 (ties), the tier thresholds' populations.
For each it holds the kernels against the plain version on CPU copies,
then prints the wrapper's device time (CUDA events, the card asleep ahead
of the start event, the mean of 10 calls after one that warms up), the run
pass's and the tiers' between CUDA events that the entry point records
(split_ms; torch.profiler was seen to drop kernels in a process that had
profiled before), the plain version's
on the card (the ops/segments.lexsort chain), the one stable torch.sort
of the int64 (segment id, key) pair that gives the same permutation (no
base; the ids made beforehand), and the bound: the bytes the function must
move at 3.35 TB/s (`sort_bytes`). Then the gather of the engine's sort and
seed (every column of the batch through its permutation) against its
plain version (an index a column) and its bound (`gather_bytes`), and the
resplit's predicate (seg_marks) against its plain version. Then, for
each threshold of ops/cluster_sorts.TIERS, its populations through the tier
on either side of it, each side a build of its own (all built at once
first), and ptxas's registers and spills, and the card's nvidia-smi name
and power limit. `kernel_rows` gives chip_smoke.py its rows of the four
kernels. Needs a CUDA card; `--device cpu` builds the cases and holds the
segmented formulation against the plain one (a dry run).
"""
import argparse
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
SEGMENT_SIZES = (1, 8, 9, 256, 257, 512, 8192, 8193, 16384)
INT32_MAX = 2 ** 31 - 1
KERNEL_NAMES = ("seg_runs", "seg_tiers", "seg_gather", "seg_marks")   # csrc/cluster_sorts.cu
ENGINE_PARAMS = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
                     cluster_merge_bnd=1000, global_repeat=False, binsize=100)


def engine_sorts(sig: dict) -> dict:
    """{case: (seg_start, k1, k2, base, alone, segment ids)} of the engine step's two
    sorts on `sig` (tensors of one device; the resplit's boundaries from the
    step's own sort and relaxation there), and the sort and seed's gather
    inputs under "gather": (permutation, columns)."""
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
    out["gather"] = (cso.seg_sort(starts, tie, None, first, alone), sig)
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
    "gather": the engine's sort and seed's (permutation, columns)."""
    from sniffles_tpu_torch.signatures import synthetic_batch
    from sniffles_tpu_torch.sim import relax_chain_batch
    sig = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in synthetic_batch(
        n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict().items()}
    engine = engine_sorts(sig)
    out = {"engine sort and seed": engine["engine sort and seed"],
           "engine resplit": engine["resplit"]}
    chain = {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in relax_chain_batch(n).items()}
    out["chain resplit"] = engine_sorts(chain)["resplit"]
    rng = np.random.default_rng(11)
    for k in SEGMENT_SIZES:
        seg = torch.arange(n, dtype=torch.int32, device=device) // k
        out[f"{k} a segment"] = (_starts(seg), torch.from_numpy(
            rng.integers(0, 64, n).astype(np.int32)).to(device), None, None, None, seg)
    out["gather"] = engine["gather"]
    out["marks"] = engine["marks"]
    return out


def _starts(seg):
    from sniffles_tpu_torch.ops.clustering import _starts as starts
    return starts(seg)


def tiny_elements(seg: torch.Tensor, tiny: int) -> int:
    """The elements in segments of at most `tiny` (the thread tier's), from
    a case's segment ids (0, 1, ... in array order; the elements alone
    segments of their own)."""
    sizes = np.bincount(seg.cpu().numpy())
    return int(sizes[sizes <= tiny].sum())


def sort_bytes(n: int, tiny: int, with_k2: bool, with_base: bool, with_alone: bool) -> tuple:
    """(run pass, tiers) bytes the function must move: seg_start and alone
    (where given) read once by the run pass; each element's keys (k1, k2 where given, the base
    entry where given) read once and its int64 permutation entry written
    once, by the tier that sorts it (tiny: the thread tier's elements)."""
    per = 4 + 4 * with_k2 + 8 * with_base + 8
    return n * (1 + with_alone) + tiny * per, (n - tiny) * per


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


def split_ms(case) -> dict:
    """{"seg_runs": ms, "seg_tiers": ms}: the entry point's own CUDA events
    around the run pass (with its memset) and around the two tiers, the mean
    of REPS calls after one that warms up, the card asleep ahead of each."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for e in evs:
        e.record()          # creates the events the entry point records again
    runs = tiers = 0.0
    for rep in range(REPS + 1):
        torch.cuda._sleep(SLEEP_CYCLES)
        cso.launch_seg_sort(*case[:5], events=evs)
        torch.cuda.synchronize()
        if rep:
            runs += evs[0].elapsed_time(evs[1])
            tiers += evs[1].elapsed_time(evs[2])
    return {"seg_runs": runs / REPS, "seg_tiers": tiers / REPS}


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
    """The kernels of one case held and timed: ms (the wrapper), by kernel,
    plain_ms, library_ms, the bounds."""
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


def gather_row(order, columns) -> dict:
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    want = cso.gather_columns_plain(order.cpu(), {k: v.cpu() for k, v in columns.items()})
    got = cso.gather_columns(order, columns)
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), v):
            raise SystemExit(f"time_cluster_sorts: the gather differs from the plain version ({k})")
    b = gather_bytes(order, columns)
    return {"ms": queued_ms(lambda: cso.gather_columns(order, columns)),
            "plain_ms": queued_ms(lambda: cso.gather_columns_plain(order, columns)),
            "library_ms": None, "bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3}


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
    """chip_smoke.py's rows of the four kernels at the engine step's n:
    seg_runs and seg_tiers on the resplit's sort (the one with a torch.sort
    of the same permutation), seg_gather on the sort and seed's gather,
    seg_marks on the resplit's predicate;
    each kernel's ms between CUDA events (split_ms; the gather is one
    launch), plain_ms the plain version of its wrapper on the card,
    bound_ms the bytes of its part of the function."""
    c = cases(n, "cuda")
    r = sort_row(c["engine resplit"], "engine resplit")
    g = gather_row(*c["gather"])
    m = marks_row(*c["marks"])
    common = {"max_abs_err": 0, "bound_by": "bytes"}
    return {
        "seg_runs": {**common, "ms": r["split"]["seg_runs"],
                     "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                     "bound_ms": r["bytes"][0] / HBM_BYTES_PER_S * 1e3},
        "seg_tiers": {**common, "ms": r["split"]["seg_tiers"],
                      "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                      "bound_ms": r["bytes"][1] / HBM_BYTES_PER_S * 1e3},
        "seg_gather": {**common, "ms": g["ms"],
                       "plain_ms": g["plain_ms"], "library_ms": None,
                       "bound_ms": g["bound_ms"]},
        "seg_marks": {**common, "ms": m["ms"], "plain_ms": m["plain_ms"], "library_ms": None,
                      "bound_ms": m["bound_ms"]},
        "wrappers": {"seg_sort": r, "gather_columns": g, "resplit_marks": m}}


def threshold_cases(tiers: tuple) -> list:
    """(case, [(label, tiers)]): each threshold's populations through the
    tier on either side of it (tiers as ops/cluster_sorts.TIERS), and the
    engine's sorts under a warp tier of twice the room (fewer warps an SM)."""
    t, w, b = tiers
    return [("8 a segment", [(f"thread tier (tiny {t})", (t, w, b)),
                             ("warp tier (tiny 4)", (4, w, b))]),
            ("256 a segment", [(f"warp tier (warp {w})", (t, w, b)),
                               ("block tier (warp 255)", (t, 255, b))]),
            ("512 a segment", [(f"block tier (warp {w})", (t, w, b)),
                               ("warp tier (warp 512)", (t, 512, b))]),
            ("engine sort and seed", [(f"warp {w}", (t, w, b)), ("warp 512", (t, 512, b))]),
            ("engine resplit", [(f"warp {w}", (t, w, b)), ("warp 512", (t, 512, b))]),
            ("8192 a segment", [(f"block in shared memory (block {b})", (t, w, b)),
                                ("block over global scratch (block 8191)", (t, w, 8191)),
                                ("one block an SM (block 16384)", (t, w, 16384))]),
            ("16384 a segment", [(f"block over global scratch (block {b})", (t, w, b)),
                                 ("block in shared memory (block 16384)", (t, w, 16384))]),
            ("chain resplit", [(f"block {b}", (t, w, b)),
                               ("one block an SM (block 16384)", (t, w, 16384))])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    if args.device == "cpu":
        for label, case in cases(args.n, "cpu").items():
            if label not in ("gather", "marks"):
                hold(case, label)
                print(f"{label}: {args.n} elements, {int(case[0].sum())} segments")
        return 0
    if not torch.cuda.is_available():
        print("time_cluster_sorts: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import _build
    all_cases = cases(args.n, "cuda")
    for label, case in all_cases.items():
        if label == "marks":
            r = marks_row(*case)
            what = "the engine resplit's predicate (seg_marks)"
        elif label == "gather":
            r = gather_row(*case)
            what = f"gather of the engine's sort and seed ({len(case[1])} columns)"
        else:
            r = sort_row(case, label)
            what = f"{label}: {int(case[0].sum())} segments"
        lib = f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "none"
        if "split" in r:
            what += (f" (between the entry point's events: seg_runs {r['split']['seg_runs']:.4f}"
                     f" ms, seg_tiers {r['split']['seg_tiers']:.4f} ms)")
        print(f"{what}: == plain (bit-exact); the wrapper {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch.sort {lib} ms, bound "
              f"{r['bound_ms']:.5f} ms ({sum(np.atleast_1d(r['bytes']))} bytes), "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it", flush=True)
    variants = {tiers for _, sides in threshold_cases(cso.TIERS) for _, tiers in sides}
    started = [_build.start_build("cluster_sorts", defines=cso.nvcc_defines(v))
               for v in variants]
    for s in started:
        _build.finish_build(s)
    for label, sides in threshold_cases(cso.TIERS):
        case = all_cases[label]
        times = []
        for side, tiers in sides:
            hold(case, label, tiers)
            ms = queued_ms(lambda: cso.launch_seg_sort(*case[:5], tiers=tiers))
            times.append(f"{side} {ms:.4f} ms")
        print(f"threshold, {label}: the kernels (== plain): {'; '.join(times)}", flush=True)
    log = _build.finish_build(_build.start_build("cluster_sorts", ptxas_verbose=True))
    kernel = None
    for line in log.splitlines():
        if "Function properties" in line or "Compiling entry" in line:
            kernel = next((k for k in KERNEL_NAMES if k in line), "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
