#!/usr/bin/env python3
"""Device time of the call statistics (`ops/call_stats.py`, the kernels of
csrc/call_stats.cu) by how the n slots are filled, for whichever
`sniffles_tpu_torch` comes first on the import path:

    python3 sniffles_tpu_torch/tools/time_call_stats.py [--n 2097152] [--split] [--no-thresholds]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/time_call_stats.py

Cases of n slots (`populations`):
  - "engine": the engine step's clustered batch at chip_smoke.py phase
    10d's inputs (`signatures.synthetic_batch`, n/40 sites, seed 42, a
    genome span of 900 kb), n/40 live slots of 22 to 60 elements;
  - "all invalid": the same with no valid element, every slot empty;
  - "singletons": every slot a cluster of one element;
  - "K a slot" for K in 8, 40, 256, 4096 and 32768: slot k holds elements
    kK..kK+K-1 of the engine's columns; 8 is the thread tier's largest
    cluster, 40 the engine's count of live slots, 256 the warp tier's
    largest, 4096 a block's, 32768 past a block's shared memory;
  - "chain": the tiled 36-link chain (`sim.relax_chain_batch(n)`, chain2^21
    at the default n) clustered as the engine clusters, n/36 clusters of
    up to 3,689 elements: the block tier's.
Each case prints its clusters in the warp and block tiers on the exact
path and on the chain path (`window_paths`: a cluster whose trimmed
windows' s1 and s2 all pass the exactness test, Σ|x| and Σx² at most 2^24,
and one where some sum runs the sequential chain).
For each it holds the kernels against the plain version on CPU copies
(every key and slot bit for bit), then prints the device time of the
wrapper (the sort and the kernels) and of the kernels alone (CUDA events,
the card asleep ahead of the start event so that the host's launch work
stays out, the mean of 10 calls after one that warms up), and the
wrapper's device time by kernel (torch.profiler over 10 calls: each
kernel's device us and launches a call). Then (unless --no-thresholds),
where the package builds its tier thresholds into the kernels
(ops/call_stats.TIERS: TINY_MAX,
PAIR_MAX, WARP_MAX, BLOCK_MAX), the kernels alone at each threshold's
population through the tier on either side of it, each side a build of
its own (all built at once first): the engine's and 40 a slot through a
warp's registers and through its shared memory; then ptxas's registers
and spills of the kernels and the card's nvidia-smi name and power limit.
--split runs first, on the build with ops/call_stats.CLOCKS (where the
package has it): each population's clusters in the warp and block tiers
and their cycles a cluster by part (`clock_split`: the list and
permutation entries, the gather, the sort, the medians and support, the
chains, the row, a block's barrier waits; a block's chains run on a warp
of their own beside its path), after it is held against the plain version.
Each population also prints the run pass with its memsets as one time
(the entry point's variant that returns after the run pass, CUDA events as
above) and each of its launches (ops/call_stats.RUN_PARTS: the time of the
variant that returns after it less the one before; `run_split`), the
masking of the ids ahead of the sort (the package's `sort_keys` where it
has one, else the torch.where of the wrapper), and the library call that
computes every slot's run start, torch.searchsorted of the sorted ids for
0..n.
Needs a CUDA card; `--device cpu` builds the populations, counts their
exact and chain paths and holds nothing (a dry run).
"""
import argparse
import ctypes
import os
import subprocess
import sys
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

REPS = 10
SLEEP_CYCLES = 2_000_000     # about 1 ms of device sleep ahead of each call
SLOT_SIZES = (8, 40, 256, 4096, 32768)
EXACT_LIMIT = 1 << 24        # a float32 sum of integer terms is exact up to it


def populations(n: int, device: str) -> dict:
    """{case: clustered batch on `device`} (see the module's docstring)."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = {k: torch.as_tensor(v).to(device) for k, v in synthetic_batch(
        n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict().items()}
    engine = tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                   cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                   cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
    engine.pop("merge_rounds")
    ids = torch.arange(n, dtype=torch.int32, device=device)
    every = torch.ones_like(engine["valid"])

    def slots_of(k):
        return dict(engine, valid=every, cluster_id=ids // k,
                    n_clusters=torch.tensor(-(-n // k), dtype=torch.int32, device=device))
    cases = {"engine": engine,
             "all invalid": dict(engine, valid=torch.zeros_like(engine["valid"])),
             "singletons": slots_of(1)}
    cases.update((f"{k} a slot", slots_of(k)) for k in SLOT_SIZES)
    cases["chain"] = chain_clustered(n, device)
    return cases


def chain_clustered(n: int, device: str) -> dict:
    """The tiled chain of n slots (sim.relax_chain_batch) clustered with
    the engine's parameters (chip_smoke.py phase 10d's chain2^21)."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import relax_chain_batch
    sig = {k: torch.as_tensor(v).to(device) for k, v in relax_chain_batch(n).items()}
    out = tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
    out.pop("merge_rounds")
    return out


def window_paths(c: dict, tiers: tuple) -> dict:
    """{tier kernel: (clusters on the exact path, on the chain path, window
    sums on the chain)} of a clustered batch (torch, any device): a
    cluster of the warp tier (TINY_MAX < cnt <= WARP_MAX of `tiers`) or
    the block tier (cnt > WARP_MAX) is on the exact path when each of its
    four trimmed-window sums (s1 and s2 of svlen and of pos: ranks [trim,
    cnt - trim) of the sorted list, centered on the window's minimum with
    int32 wrap) passes its test, sum |x| <= 2^24 for s1 and sum x^2 <= 2^24
    for s2, and so adds exactly in any order; else on the chain path."""
    tiny, _, warp_max, _ = tiers
    n = c["pos"].shape[0]
    cid = c["cluster_id"].cpu().to(torch.int64)
    mask = c["valid"].cpu() & (cid >= 0) & (cid < n)
    ids = cid[mask]
    cnt = torch.bincount(ids, minlength=n)
    start = torch.cumsum(cnt, 0) - cnt
    trim = cnt * 25 // 100
    chained = torch.zeros(n, dtype=torch.int64)
    for key in ("svlen", "pos"):
        v = c[key].cpu().to(torch.int64)[mask]
        order = torch.argsort(ids * (1 << 33) + (v + (1 << 31)))
        ids_s, v_s = ids[order], v[order]
        rank = torch.arange(ids_s.numel()) - start[ids_s]
        lo = trim[ids_s]
        inside = (rank >= lo) & (rank < cnt[ids_s] - lo)
        shift = v_s[(start + trim).clamp(max=max(v_s.numel() - 1, 0))] if v_s.numel() else v_s
        d = (v_s - shift[ids_s] + (1 << 31)) % (1 << 32) - (1 << 31)
        s1 = torch.zeros(n, dtype=torch.int64).index_add_(0, ids_s, torch.where(
            inside, d.abs(), 0))
        s2 = torch.zeros(n, dtype=torch.int64).index_add_(0, ids_s, torch.where(
            inside, (d * d).clamp(max=EXACT_LIMIT + 1), 0))
        chained += (s1 > EXACT_LIMIT).to(torch.int64) + (s2 > EXACT_LIMIT).to(torch.int64)
    out = {}
    for k, sel in (("stat_warps", (cnt > tiny) & (cnt <= warp_max)),
                   ("stat_blocks", cnt > warp_max)):
        out[k] = (int((sel & (chained == 0)).sum()), int((sel & (chained > 0)).sum()),
                  int(chained[sel].sum()))
    return out


def paths_text(paths: dict) -> str:
    return "; ".join(f"{k}: {e} clusters exact, {ch} on the chain ({s} sums)"
                     for k, (e, ch, s) in paths.items())


def parse_clocks(words, tiers=("stat_warps", "stat_blocks"),
                 parts=("entry", "gather", "sort", "medians", "chains", "write", "wait")
                 ) -> dict:
    """The stat_clocks words (a tier's parts, then its clusters) as {tier:
    {"clusters": k, "path": cycles a cluster on the stamping thread's path
    (a block's without its chains, which run beside it), part: cycles a
    cluster}}; a tier with no cluster gives {"clusters": 0}."""
    out = {}
    stride = len(parts) + 1
    for t, tier in enumerate(tiers):
        w = [int(x) for x in words[t * stride:(t + 1) * stride]]
        k = w[-1]
        if not k:
            out[tier] = {"clusters": 0}
            continue
        cycles = {p: w[i] / k for i, p in enumerate(parts)}
        beside = ("chains",) if tier == "stat_blocks" else ()
        out[tier] = {"clusters": k, "path": sum(v for p, v in cycles.items() if p not in beside),
                     **cycles}
    return out


def split_text(split: dict) -> str:
    """A clock_split's tiers as text: cycles a cluster, each part's share
    of the path (a block's chains as cycles beside it)."""
    out = []
    for tier, d in split.items():
        if not d["clusters"]:
            out.append(f"{tier}: no cluster")
            continue
        parts = [f"{p} {v / d['path']:.1%}" for p, v in d.items()
                 if p not in ("clusters", "path") and not (tier == "stat_blocks" and p == "chains")]
        extra = (f"; chains beside it {d['chains']:.0f} cycles"
                 if tier == "stat_blocks" else "")
        out.append(f"{tier}: {d['clusters']} clusters, {d['path']:.0f} cycles a cluster "
                   f"({', '.join(parts)}{extra})")
    return " | ".join(out)


def clock_split(cs, c: dict, want: dict, case: str) -> dict | None:
    """parse_clocks of REPS calls of the CLOCKS build on the case (held
    against the plain version first); None where the package has no such
    build."""
    from sniffles_tpu_torch.ops import _build
    if not hasattr(cs, "CLOCKS"):
        return None
    fn = _build.load("call_stats", cs.nvcc_defines() + (cs.CLOCKS,)).stat_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_uint64 * (len(cs.CLOCK_TIERS) * (len(cs.CLOCK_PARTS) + 1)))()
    inputs = cs.kernel_inputs(c)
    held(cs.launch_kernels(inputs, c["n_clusters"], True, clocks=True), want, case)
    torch.cuda.synchronize()
    if fn(out) != 0:                    # zeroes the sums after the call that held it
        raise SystemExit("time_call_stats: reading the clocks failed")
    for _ in range(REPS):
        cs.launch_kernels(inputs, c["n_clusters"], True, clocks=True)
    torch.cuda.synchronize()
    if fn(out) != 0:
        raise SystemExit("time_call_stats: reading the clocks failed")
    got = parse_clocks(out, cs.CLOCK_TIERS, cs.CLOCK_PARTS)
    for d in got.values():
        d["clusters"] //= REPS
    return got


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


def by_kernel(fn) -> dict:
    """{kernel name: (device us a call, launches a call)} of fn() under
    torch.profiler over REPS calls, after one that warms up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0.0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "Activity Buffer Request":
            out[e.name][0] += e.time_range.elapsed_us() / REPS
            out[e.name][1] += 1 / REPS
    return dict(out)


def short(name: str) -> str:
    """A kernel's name without its template arguments and namespaces."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return base[-1].split("::")[-1][:40] if base else name[:40]


def held(got: dict, want: dict, case: str) -> None:
    for k, v in want.items():
        a, b = got[k].cpu(), v
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise SystemExit(f"time_call_stats: {case}: {k} differs from the plain version")


def parts_from_times(parts, times) -> dict:
    """{part: ms} from the times of the variants that stop after each of
    `parts` in turn (each part: its variant's time less the one before),
    and "total": the last variant's."""
    out, before = {}, 0.0
    for part, ms in zip(parts, times, strict=True):
        out[part] = ms - before
        before = ms
    out["total"] = before
    return out


def run_split(cs, inputs: dict, n_clusters) -> dict | None:
    """parts_from_times of the entry point's RUN_PARTS variants on a case's
    kernel inputs, and the masking's and torch.searchsorted's ms (see the
    module's docstring); None where the package has no such variants.
    Build the variants first (build_run_variants)."""
    if not hasattr(cs, "RUN_PARTS"):
        return None
    times = [queued_ms(lambda: cs.launch_kernels(inputs, n_clusters, True, run_parts=k))
             for k in range(1, len(cs.RUN_PARTS) + 1)]
    out = parts_from_times(cs.RUN_PARTS, times)
    if hasattr(cs, "sort_keys"):
        out["masking"] = ("stat_keys", queued_ms(lambda: cs.sort_keys(inputs)))
    else:
        out["masking"] = ("torch.where", queued_ms(lambda: torch.where(
            inputs["valid"], inputs["cluster_id"], 2 ** 31 - 1)))
    cid_s = inputs["sort"][0]
    slots = torch.arange(cid_s.shape[0] + 1, dtype=torch.int32, device=cid_s.device)
    out["searchsorted"] = queued_ms(lambda: torch.searchsorted(cid_s, slots))
    return out


def run_split_text(split: dict) -> str:
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items()
                      if k not in ("total", "masking", "searchsorted"))
    label, mask_ms = split["masking"]
    return (f"the run pass with its memsets {split['total']:.4f} ms ({parts}); the masking "
            f"({label}) {mask_ms:.4f} ms; torch.searchsorted {split['searchsorted']:.4f} ms")


def build_run_variants(cs) -> None:
    """Every RUN_PARTS variant of the package, built at once."""
    from sniffles_tpu_torch.ops import _build
    if not hasattr(cs, "RUN_PARTS"):
        return
    started = [_build.start_build("call_stats", defines=cs.nvcc_defines()
                                  + (cs.run_parts_define(k),))
               for k in range(1, len(cs.RUN_PARTS) + 1)]
    for s in started:
        _build.finish_build(s)


def threshold_cases(cs) -> list:
    """(case, [(label, tiers)]): each tier threshold's population through
    the tier on either side of it (tiers as ops/call_stats.TIERS)."""
    t, p, w, b = cs.TIERS
    return [("8 a slot", [(f"thread tier (tiny {t})", (t, p, w, b)),
                          ("warp tier (tiny 7)", (min(t, 7), p, w, b))]),
            ("engine", [(f"warp registers (pair {p})", (t, p, w, b)),
                        ("warp shared memory (pair 0)", (t, 0, w, b))]),
            ("40 a slot", [(f"warp registers (pair {p})", (t, p, w, b)),
                           ("warp shared memory (pair 0)", (t, 0, w, b)),
                           ("block tier (warp 39)", (t, p, 39, b))]),
            ("256 a slot", [(f"warp tier (warp {w})", (t, p, w, b)),
                            ("block tier (warp 255)", (t, p, 255, b))]),
            ("4096 a slot", [(f"block in shared memory (block {b})", (t, p, w, b)),
                             ("two blocks an SM (block 5632)", (t, p, w, 5632)),
                             ("one block an SM (block 11264)", (t, p, w, 11264)),
                             ("block over global scratch (block 4095)", (t, p, w, 4095))]),
            ("chain", [(f"block in shared memory (block {b})", (t, p, w, b)),
                       ("two blocks an SM (block 5632)", (t, p, w, 5632)),
                       ("past 2048 over global scratch (block 2048)", (t, p, w, 2048))])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--split", action="store_true",
                    help="first each population's cycles a cluster by part (the CLOCKS build)")
    ap.add_argument("--no-thresholds", action="store_true",
                    help="skip the tier thresholds from both sides")
    args = ap.parse_args()
    if args.device == "cpu":
        from sniffles_tpu_torch.ops import call_stats as cs
        for case, c in populations(args.n, "cpu").items():
            live = int(torch.unique(c["cluster_id"][c["valid"]]).numel())
            print(f"{case}: {args.n} slots, {live} live; {paths_text(window_paths(c, cs.TIERS))}")
        if hasattr(cs, "RUN_PARTS"):
            variants = (f"{cs.run_parts_define(k)} {part}"
                        for k, part in enumerate(cs.RUN_PARTS, start=1))
            print(f"run pass variants: {'; '.join(variants)}")
        return 0
    if not torch.cuda.is_available():
        print("time_call_stats: no CUDA device is visible", file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import call_stats as cs
    print(f"time_call_stats: the package at {os.path.dirname(os.path.dirname(cs.__file__))}")
    cases = populations(args.n, "cuda")
    build_run_variants(cs)
    if args.split and hasattr(cs, "CLOCKS"):
        _build.finish_build(_build.start_build("call_stats",
                                               defines=cs.nvcc_defines() + (cs.CLOCKS,)))
        for case, c in cases.items():
            want = cs.call_statistics_plain({k: v.cpu() for k, v in c.items()}, True)
            split = clock_split(cs, c, want, case)
            print(f"split, {case}: {split_text(split)}; {paths_text(window_paths(c, cs.TIERS))}",
                  flush=True)
    for case, c in cases.items():
        want = cs.call_statistics_plain({k: v.cpu() for k, v in c.items()}, True)
        held(cs.launch_call_statistics(c, True), want, case)
        inputs = cs.kernel_inputs(c)
        ms = queued_ms(lambda: cs.launch_call_statistics(c, True))
        kernels_ms = queued_ms(lambda: cs.launch_kernels(inputs, c["n_clusters"], True))
        split = by_kernel(lambda: cs.launch_call_statistics(c, True))
        runs = run_split(cs, inputs, c["n_clusters"])
        live = int((want["lead_count"] > 0).sum())
        print(f"{case}: {args.n} slots, {live} live ({paths_text(window_paths(c, cs.TIERS))}); "
              f"== plain (bit-exact); the wrapper "
              f"{ms:.4f} ms, the kernels alone {kernels_ms:.4f} ms; by kernel (us, launches "
              f"a call): " + "; ".join(
                  f"{short(k)} {us:.1f} x{n:.0f}"
                  for k, (us, n) in sorted(split.items(), key=lambda kv: -kv[1][0]))
              + (f"; {run_split_text(runs)}" if runs else ""),
              flush=True)
    if hasattr(cs, "TIERS") and not args.no_thresholds:
        variants = {tiers for _, sides in threshold_cases(cs) for _, tiers in sides}
        started = [_build.start_build("call_stats", defines=cs.nvcc_defines(v))
                   for v in variants]
        for s in started:
            _build.finish_build(s)
        for case, sides in threshold_cases(cs):
            c = cases[case]
            want = cs.call_statistics_plain({k: v.cpu() for k, v in c.items()}, True)
            inputs = cs.kernel_inputs(c)
            times = []
            for label, tiers in sides:
                held(cs.launch_kernels(inputs, c["n_clusters"], True, tiers), want, case)
                t_ms = queued_ms(lambda: cs.launch_kernels(inputs, c["n_clusters"], True, tiers))
                times.append(f"{label} {t_ms:.4f} ms")
            print(f"threshold, {case}: the kernels alone (== plain): {'; '.join(times)}",
                  flush=True)
    log = _build.finish_build(_build.start_build("call_stats", ptxas_verbose=True))
    kernel = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = next((k for k in ("stat_keys", "stat_runs", "stat_slots", "stat_warps",
                                       "stat_blocks", "call_stats_kernel") if k in line), "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.split('info    :', 1)[-1].strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
