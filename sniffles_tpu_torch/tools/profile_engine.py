#!/usr/bin/env python3
"""Where the device time of the fused engine's step goes, by stage.

    python3 sniffles_tpu_torch/tools/profile_engine.py [--n 2097152] [--steps 3] [--trace PATH]
    python3 sniffles_tpu_torch/tools/profile_engine.py --tail-split [--dense DIR]
    PYTHONPATH=DIR python3 sniffles_tpu_torch/tools/profile_engine.py --tail-split

Runs the eager body of `parallel/engine.call_pipeline_step` (`eager_step`:
the stages' spans and launch calls, which a replayed step has not) on
chip_smoke.py phase 10d's inputs (`signatures.synthetic_batch`, n/40
sites, seed 42, a genome span of 900 kb; 1 Mb of coverage at 30;
default_params), from tensors on the card: two steps to warm up, then
STEPS steps under torch.profiler (CPU and CUDA activities). The stages
are the step's own spans
(sniffles_tpu_torch/spans.py), host ranges that the profiler records:
  clustering.sort_seed  ops/clustering.sort_and_seed (3 stable sorts, the seeds)
  clustering.relax      ops/merge_relax.merge_relax (csrc/merge_relax.cu)
  clustering.resplit    ops/clustering._resplit (2 stable sorts, the child
                        ids) and the cluster count
  engine.stats          ops/clustering.call_statistics (the step's statistics)
  engine.tail           the split-read support sum (ops/segments.seg_sum) and
                        ops/candidate_tail.candidate_tail (csrc/candidate_tail.cu)
  engine.step (self)    the rest of the step: to_device, the dicts between stages
A kernel belongs to the stage whose range holds the host call that
launched it (stage_split: the kernel and its launch call share a
correlation id). Prints, a step: the device time of each stage's
kernels, its launches and its three largest kernels; the device time of
kernels under no span; tail_runs (the
tail's run pass) beside its byte bound (the cluster ids read, a run start
a cluster written) and beside torch.searchsorted of the step's cluster ids
(the library call that computes the same starts; CUDA events, the card
asleep ahead of the start event); the step's wall between CUDA events
outside the profiler, eager (the body) and replayed (call_pipeline_step
on inputs it has captured), in turns, each with the host's enqueue time
a step; and the card's nvidia-smi name and power limit.
With --trace, writes the chrome trace there. Needs a
CUDA card, unless --device cpu (a dry run of the stages on the CPU).

--tail-split takes the tail's run pass apart instead, for whichever
`sniffles_tpu_torch` comes first on the import path, on the cluster ids
the engine's step hands the tail (`tail_ids`) at three layouts: the
engine's 2^N step (the inputs above), dense3's chr1 (chip_smoke.py phase
10b: bench.py's dense leg, 3 contigs of 2 Mb at depth 60, seed 17, written
to DIR or read from it when it holds sim.bam; the port's lead provider over
chr1) and chain2^N (sim.relax_chain_batch, phase 10d). Each layout's pass
is held bit for bit against ops/candidate_tail.tail_runs_plain, then
timed, by CUDA events (the mean of 10 calls after one that warms up, the
card asleep ahead of the start event) and by torch.profiler (the kernel's
device us over 10 calls): the empty launch of its grid and its loads alone
(ops/candidate_tail.RUN_PARTS, a -DTAIL_RUN_PARTS build each), the pass,
and torch.searchsorted of the ids for 0..clamp(last + 1, 0, n); beside its
byte bound. Each is timed twice: warm (the ids in L2 from the call
before), and each call after a write of 64 MB (more than the card's 50 MB
of L2: the ids come from device memory past dirty lines, as in the step,
whose earlier stages leave L2 so).
"""
import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(REPO)     # after PYTHONPATH, so that a package there comes first

HBM_BYTES_PER_S = 3.35e12    # the H100's device memory rate (the tail_runs bound)
# the CUDA runtime and driver calls that put work on the device
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def launched_by(events) -> list:
    """[(device event, the host call that launched it, or None where the
    profiler recorded none)]: a device operation and the runtime call that
    launched it share their correlation id (`FunctionEvent.id`)."""
    cuda = torch.autograd.DeviceType.CUDA
    calls = {e.id: e for e in events
             if e.device_type != cuda and e.name.startswith(LAUNCH_CALLS)}
    return [(e, calls.get(e.id)) for e in events
            if e.device_type == cuda and not e.is_user_annotation
            and not e.name.startswith("Activity Buffer")]


def stage_split(events, steps: int, stages=None, outer=None) -> dict:
    """{stage: (device us a step, launches a step, {kernel: us a step},
    calls a step)} from the profiler's events of `steps` steps: a device
    operation belongs to the innermost host range named in `stages`, or
    `outer`, that holds the host call that launched it (launched_by);
    under `outer` fall the step's own kernels outside its stages, under
    None those launched outside every such range, or whose launch call the
    profiler did not record. By default the stages are the engine's spans
    (sniffles_tpu_torch/spans.py: STAGES inside STEP)."""
    if stages is None:
        from sniffles_tpu_torch.spans import STAGES, STEP
        stages, outer = STAGES, STEP
    named = set(stages) | ({outer} if outer else set())
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [e for e in events if e.device_type != cuda and e.name in named]
    out = {}
    for r in ranges:
        us, n, by, calls = out.get(r.name, (0.0, 0.0, defaultdict(float), 0.0))
        out[r.name] = (us, n, by, calls + 1 / steps)
    for e, call in launched_by(events):
        if e.name in named:
            continue
        label, width = None, None
        if call is not None:
            t = call.time_range.start
            for r in ranges:
                w = r.time_range.end - r.time_range.start
                if r.time_range.start <= t <= r.time_range.end and (width is None or w < width):
                    label, width = r.name, w
        us, n, by, calls = out.get(label, (0.0, 0.0, defaultdict(float), 0.0))
        by[e.name] += e.time_range.elapsed_us() / steps
        out[label] = (us + e.time_range.elapsed_us() / steps, n + 1 / steps, by, calls)
    return out


def engine_inputs(n: int, device: str):
    from sniffles_tpu_torch.parallel.engine import default_params, to_device
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = synthetic_batch(n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict()
    sig, coverage = to_device(sig, np.full(1_000_000, 30, dtype=np.int32), device)
    return sig, coverage, default_params()


def eager_step(sig, coverage, params) -> dict:
    """The engine's step through its eager body, inside the step's span,
    whatever graphs the engine holds for these inputs."""
    from sniffles_tpu_torch.parallel import engine
    from sniffles_tpu_torch.spans import STEP, span
    with span(STEP):
        return engine._eager_step(sig, coverage, params, 0, 100, 20, None, None)


def tail_ids(sig, coverage, params) -> torch.Tensor:
    """The cluster ids that the engine's step hands its candidate tail."""
    from sniffles_tpu_torch.parallel import engine
    kept, tail = [], engine.candidate_tail

    def keep(stats, support_sa, coverage, elements, params, **kw):
        kept.append(elements["cluster_id"])
        return tail(stats, support_sa, coverage, elements, params, **kw)
    engine.candidate_tail = keep
    try:
        eager_step(sig, coverage, params)
    finally:
        engine.candidate_tail = tail
    return kept[0].to(torch.int32).contiguous()


def dense_chr1(bam, contig="chr1"):
    """The port's lead provider over one contig of a BAM: its leads with a
    length (sorted by position), its coverage as int32 and its regional NM
    (chip_smoke.py phases 10b and 10c)."""
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.io.bam import AlignmentFile
    from sniffles_tpu_torch.leads import LeadProvider
    from sniffles_tpu_torch.region import Region
    config = SnifflesConfig("--input", bam, "--vcf", "out.vcf")
    f = AlignmentFile(bam, "rb", require_index=True)
    provider = LeadProvider(config, 0, contig)
    provider.build_leadtab([Region(contig, 0, f.get_reference_length(contig))], f)
    leads = sorted((ld for tab in provider.leadtab.values() for binned in tab.values()
                    for ld in binned if ld.svlen is not None), key=lambda ld: ld.ref_start)
    return leads, provider.coverage.astype(np.int32), provider.average_regional_nm


def dense_chr1_inputs(dense_dir: str, device: str):
    """dense3's chr1 as chip_smoke.py phase 10b steps it (dense_chr1 of
    bench.py's dense leg, written to dense_dir unless it is there)."""
    from sniffles_tpu_torch.parallel.engine import default_params, to_device
    from sniffles_tpu_torch.signatures import from_leads
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    from sniffles_tpu_torch.tools.profile_call_task import DENSE
    bam = os.path.join(dense_dir, "sim.bam")
    if not os.path.exists(bam):
        os.makedirs(dense_dir, exist_ok=True)
        bam, _ = write_dataset(dense_dir, svs=dense_layout(DENSE["ref_len"]), **DENSE)
    leads, coverage, _ = dense_chr1(bam)
    sig, coverage = to_device(from_leads(leads).as_dict(), coverage, device)
    return sig, coverage, default_params()


def tail_layouts(n: int, device: str, dense_dir: str) -> dict:
    """{layout: the cluster ids the step hands the tail} (see the module's
    docstring)."""
    from sniffles_tpu_torch.parallel.engine import default_params, to_device
    from sniffles_tpu_torch.sim import relax_chain_batch
    chain, coverage = to_device(relax_chain_batch(n), np.full(1_000_000, 30, dtype=np.int32),
                                device)
    return {f"engine 2^{n.bit_length() - 1}": tail_ids(*engine_inputs(n, device)),
            "dense3-chr1": tail_ids(*dense_chr1_inputs(dense_dir, device)),
            f"chain2^{n.bit_length() - 1}": tail_ids(chain, coverage, default_params())}


DIRTY_BYTES = 64 << 20      # more than the H100's 50 MB of L2


def after_writes(fn, scratch, match) -> tuple:
    """(ms by CUDA events, us by torch.profiler of the kernels whose name
    `match` takes) of fn(), the mean of 10 calls, each after a write of
    `scratch` (the start event after it; the card asleep ahead of the
    write, so that the host's launches wait in the queue)."""
    from sniffles_tpu_torch.tools.time_call_stats import REPS, SLEEP_CYCLES
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(REPS + 1):
        torch.cuda._sleep(SLEEP_CYCLES)     # the launches queue up behind it
        scratch.fill_(rep)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for rep in range(REPS):
            scratch.fill_(rep)
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match(e.name))
    return total / REPS, us / REPS


def tail_split(n: int, device: str, dense_dir: str) -> dict:
    """{layout: {"parts": {part: (warm CUDA-event ms, warm profiler us,
    the same after a 64 MB write)}, "bound": (ms, bytes), "n": ids}} of the
    run pass on each tail_layouts layout (see the
    module's docstring); held against tail_runs_plain first. On the CPU,
    the layouts and their plain starts only (a dry run)."""
    from sniffles_tpu_torch.ops import _build, candidate_tail as ct
    from sniffles_tpu_torch.tools.time_call_stats import by_kernel, queued_ms
    on_card = device != "cpu"
    parts = getattr(ct, "RUN_PARTS", ())
    if on_card:
        started = [_build.start_build("candidate_tail", defines=(ct.run_parts_define(k),))
                   for k in range(1, len(parts) + 1)]
        for st in started:
            _build.finish_build(st)
    out = {}
    for label, cid in tail_layouts(n, device, dense_dir).items():
        want = ct.tail_runs_plain(cid)
        runs_bytes = 4 * cid.shape[0] + 4 * want.shape[0]
        row = {"n": cid.shape[0], "bound": (runs_bytes / HBM_BYTES_PER_S * 1e3, runs_bytes),
               "parts": {}}
        out[label] = row
        if not on_card:
            continue
        got = ct.launch_tail_runs(cid)[:want.shape[0]]
        if not torch.equal(got, want):
            raise SystemExit(f"profile_engine: {label}: tail_runs differs from tail_runs_plain")
        slots = torch.arange(want.shape[0], dtype=torch.int32, device=cid.device)
        scratch = torch.empty(DIRTY_BYTES // 4, dtype=torch.int32, device=cid.device)
        calls = [(part, lambda k=k: ct.launch_tail_runs(cid, run_parts=k))
                 for k, part in enumerate(parts, start=1)]
        calls += [("pass", lambda: ct.launch_tail_runs(cid)),
                  ("torch.searchsorted", lambda: torch.searchsorted(cid, slots, out_int32=True))]
        for part, fn in calls:
            def match(name, part=part):
                return "FillFunctor" not in name if part == "torch.searchsorted" else (
                    "tail_runs" in name)
            us = sum(v[0] for k, v in by_kernel(fn).items() if match(k))
            row["parts"][part] = (queued_ms(fn), us, *after_writes(fn, scratch, match))
        del scratch
    return out


def print_tail_split(split: dict) -> None:
    print("the tail's run pass (tail_runs) by part, ms by CUDA events (the mean of 10) and "
          "us by torch.profiler, warm / after a 64 MB write; each layout held against "
          "tail_runs_plain first:")
    for label, row in split.items():
        bound_ms, runs_bytes = row["bound"]
        parts = "; ".join(f"{part} {ms:.4f} ms, {us:.1f} us / {d_ms:.4f} ms, {d_us:.1f} us"
                          for part, (ms, us, d_ms, d_us) in row["parts"].items())
        pass_us = row["parts"]["pass"][1::2] if "pass" in row["parts"] else ()
        share = (f", the pass {bound_ms * 1e3 / pass_us[0]:.1%} / "
                 f"{bound_ms * 1e3 / pass_us[1]:.1%} of it (profiler)"
                 if pass_us and all(pass_us) else "")
        print(f"  {label} (n={row['n']}): {parts or 'not measured (no card)'}; bound "
              f"{bound_ms:.5f} ms ({runs_bytes} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
              f"{share}")


def turns_ms(fns: dict, turns: int = 2, reps: int = 10) -> dict:
    """{label: [(wall ms a step between CUDA events, host ms a step to
    enqueue)] a turn} of reps back-to-back calls of each fn, the fns in
    turns."""
    out = {label: [] for label in fns}
    for _ in range(turns):
        for label, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            host = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            out[label].append((start.elapsed_time(stop) / reps, host))
    return out


def profile(n: int, steps: int, device: str, trace: str | None = None) -> dict:
    """Runs the profile and returns its figures: split (stage_split of the
    eager body), device_us (all device kernels a step), turns (turns_ms of
    the eager and the replayed step, on the card)."""
    from sniffles_tpu_torch.parallel import engine
    sig, coverage, params = engine_inputs(n, device)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for _ in range(2):
        eager_step(sig, coverage, params)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            last = eager_step(sig, coverage, params)
        sync()
    if trace:
        prof.export_chrome_trace(trace)
    split = stage_split(prof.events(), steps)
    out = {"split": split, "device_us": sum(v[0] for v in split.values()), "turns": None,
           "n_clusters": int(last["n_clusters"]), "searchsorted_ms": None}
    if on_card:
        for _ in range(2):      # the inputs' first sight, then their capture
            engine.call_pipeline_step(sig, coverage, params)
        replays = engine.COUNTS["replays"]
        out["turns"] = turns_ms({
            "eager": lambda: eager_step(sig, coverage, params),
            "replayed": lambda: engine.call_pipeline_step(sig, coverage, params)})
        out["replays"] = engine.COUNTS["replays"] - replays
        from sniffles_tpu_torch.ops.candidate_tail import written_runs
        from sniffles_tpu_torch.tools.time_call_stats import queued_ms
        cid = tail_ids(sig, coverage, params)
        slots = torch.arange(written_runs(cid), dtype=torch.int32, device=cid.device)
        out["searchsorted_ms"] = queued_ms(lambda: torch.searchsorted(cid, slots,
                                                                      out_int32=True))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    ap.add_argument("--tail-split", action="store_true",
                    help="the tail's run pass by part on three layouts instead")
    ap.add_argument("--dense", default=None,
                    help="dense3's directory for --tail-split (default: a temporary one)")
    args = ap.parse_args()
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("profile_engine: no CUDA device is visible", file=sys.stderr)
            return 2
        os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    if args.tail_split:
        with contextlib.ExitStack() as stack:
            dense_dir = args.dense or stack.enter_context(tempfile.TemporaryDirectory())
            print_tail_split(tail_split(args.n, args.device, dense_dir))
        print_smi(args.device)
        return 0
    fig = profile(args.n, args.steps, args.device, args.trace)
    split = fig["split"]
    print(f"engine step n={args.n} on {args.device}, {args.steps} profiled steps; a step:")
    from sniffles_tpu_torch.spans import STAGES, STEP, TAIL
    for label in [*STAGES, STEP, None]:
        us, n, by, calls = split.get(label, (0.0, 0.0, {}, 0.0))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
        name = {STEP: STEP + " (self)", None: "under no span"}.get(label, label)
        print(f"  {name:21s} {us / 1e3:9.4f} ms of kernels, {n:5.0f} launches"
              + (f", {calls:.0f} calls" if label else "")
              + "".join(f"; {v / 1e3:.4f} ms {k[:60]}" for k, v in top))
    print(f"  all kernels {fig['device_us'] / 1e3:.4f} ms")
    runs_us = sum(us for name, us in split.get(TAIL, (0, 0, {}, 0))[2].items()
                  if "tail_runs" in name)
    runs_bytes = 4 * args.n + 4 * (fig["n_clusters"] + 1)
    bound_ms = runs_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  tail_runs {runs_us / 1e3:.4f} ms of the tail stage; its bound {bound_ms:.5f} ms "
          f"({runs_bytes} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: the {args.n} cluster ids "
          f"read, the {fig['n_clusters'] + 1} run starts written)"
          + (f", {bound_ms * 1e3 / runs_us:.1%} of it" if runs_us else "")
          + (f"; torch.searchsorted of the step's ids {fig['searchsorted_ms']:.4f} ms (CUDA "
             f"events)" if fig["searchsorted_ms"] is not None else ""))
    if fig["turns"] is not None:
        print(f"  the step's wall between CUDA events, ms a step (10 steps a turn, no "
              f"profiler; the host's enqueue ms in brackets; {fig['replays']} replays):")
        for label, rows in fig["turns"].items():
            print(f"    {label:9s} " + ", ".join(f"{wall:.4f} ({host:.4f})" for wall, host in rows))
    if args.device != "cpu" and fig["device_us"] == 0:
        print("  device time by kernel: not measured (the profiler recorded no device events); "
              "the step between CUDA events above stands")
    print_smi(args.device)
    return 0


def print_smi(device: str) -> None:
    if device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")


if __name__ == "__main__":
    sys.exit(main())
