#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sniffles_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. set-up: the card's name and power limit; build every CUDA kernel of
     the port from csrc/ (one nvcc per source, started together), with
     ptxas's register and shared-memory report;
  2. the edit-distance kernel against its plain PyTorch version on the
     card, bit for bit, at the main path's shapes and edge cases (lengths
     at 32-bit word boundaries, alphabets beyond ACGT, a batch mixing
     60 bp and 4,095 bp pairs), a subsample against the host Myers scan;
  2b. the merge sweep's two kernels (the sound-cut partition, sweep_cuts,
     then a thread per segment, merge_sweep) against their plain PyTorch
     versions (run on the CPU copies of the same inputs), bit for bit in
     the cut flags, the counts and every state array: fuzz batches whose
     seeds merge, at the dense call tasks' padded widths n = 32,768 and
     n = 65,536 and at n = 512, the edges nseeds = 0, one seed, one
     fragmented read and a single-svtype chain, and the partition's
     layouts (a head seed alone, BND chains, a cascade that collapses
     the fixpoint);
  3. combine on the card: a 256-sample cohort written by
     sniffles_tpu_torch.sim, combined into a multi-sample VCF on the card
     (the device greedy and the edit-distance kernel) and again on the
     host path (--no-tpu); the two VCFs must be identical, and the kernel
     must have been launched by the device run;
  4. call_sample on the card: the JAX package's compute-dense bench leg
     (3 contigs of 2 Mb, depth 60, seed 17, sim.dense_layout) written by
     sniffles_tpu_torch.sim and called on the device path (--threads 0)
     and on the host path (--no-tpu): identical records, at least 1,500
     of them, every device child's statistics consumed, no exactness
     route taken but BND's, one launch of each sweep kernel per task,
     and the state and counts of every one of those sweeps == the plain
     version's on the same inputs, bit for bit; the device time of
     call_task_packed per task (CUDA events), the wall time of both
     paths and the peak device memory are printed.
Then (5) the kernels' timings on the inputs of the main paths' largest
launches (CUDA events) beside their bounds and plain versions, the
sweep's device time on phase 2b's fuzz batches and chain, one JSON
line of kernel figures, the nvidia-smi name and power-limit line, and,
last, {"ok": true, "device": {...}}. Without a card it exits non-zero
before any of that.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks: HBM3 bandwidth, and INT32 instructions per second
# (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost; NVIDIA's Hopper
# architecture white paper). Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations per 32-bit word and text column of the bit-vector
# recurrence in csrc/edit_distance.cu, counted from the source (a LOP3, an
# add with carry or a funnel shift is one): 10 for the recurrence, 2 or
# more for the match mask
ED_OPS_PER_WORD = 12
ED_OPS_PER_CELL_WAVEFRONT = 6  # the earlier wavefront kernel: a compare, 3 adds, 2 mins
COHORT_SAMPLES = 256
COHORT_SEED = 2024
# bench.py's compute-dense leg (DENSE_* and bench_dense, bench.py:288-330)
DENSE_REF_LEN = 2_000_000
DENSE_CONTIGS = 3
DENSE_DEPTH = 60
DENSE_SEED = 17
# int32/float32 slot arrays the sweep's criteria read for every live seed:
# seed_type, nxt, start_bp, end_bp, rep, msv, sd
SWEEP_CRITERIA_ARRAYS = 7
# operations per sweep iteration (the criteria, the list update and the
# pointer move), counted from csrc/merge_sweep.cu; the stride picks of a
# merge's range_metrics come on top
SWEEP_OPS_PER_ITERATION = 40
# phase-2b cases whose sweep phase 5 times beside the main path's largest
SWEEP_TIMED = ("fuzz n=32768 seed 1", "fuzz n=32768 seed 2", "fuzz n=65536 seed 5",
               "single-svtype chain n=4096")
# cycles of the device sleep queued ahead of a timed sweep (about 1 ms)
SLEEP_CYCLES = 2_000_000
# int32 operations a live seed and pass of the partition's walk (the cut
# test: a compare of types, three differences, a min, a multiply, two
# compares), counted from csrc/merge_sweep.cu
CUTS_OPS_PER_SEED = 8


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 2 ----------------------------------------------------------------

def random_pairs(rng, n, L, related):
    """Pairs of lengths in [0, L - 1]: unrelated strings, or (related)
    a string and its copy with about 2 % substitutions, like the alleles
    of one site in the cohort."""
    from sniffles_tpu_torch.sim import _mutate
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(n):
        la = int(rng.integers(0, L))
        a = bases[rng.integers(0, 4, size=la)].tobytes().decode()
        if related:
            b = _mutate(rng, a, 0.02)
        else:
            b = bases[rng.integers(0, 4, size=int(rng.integers(0, L)))].tobytes().decode()
        pairs.append((a, b))
    return pairs


def edge_pairs(L):
    top = L - 1
    return [("", ""), ("A", ""), ("", "C"), ("A" * top, ""), ("", "G" * top),
            ("ACGT" * (top // 4), "ACGT" * (top // 4)), ("A" * top, "T" * top),
            ("A" * top, "A" * (top - 1) + "T"), ("GATTACA", "GCATGCT")]


def related_bytes(rng, a, alphabet, n, edits):
    """a cut or extended to n bytes from alphabet, then `edits` substitutions."""
    t = bytearray(a[:n]) + bytes(rng.choice(list(alphabet), max(0, n - len(a))).tolist())
    for _ in range(edits):
        if t:
            t[int(rng.integers(0, len(t)))] = int(rng.choice(list(alphabet)))
    return bytes(t)


def special_pairs(rng):
    """Byte pairs for L = 4096: every pair of lengths at 32-bit word
    boundaries; DNA with N (5 symbols: the kernel's 3-plane path);
    patterns with more than 8 distinct bytes (lowercase, N, IUPAC) and
    arbitrary bytes; one batch share of 60 bp and 4,095 bp pairs mixed."""
    def rand(alphabet, n):
        return bytes(rng.choice(list(alphabet), n).tolist())

    bounds = (31, 32, 33, 63, 64, 65, 1023, 1024, 4095)
    pairs = []
    for x in bounds:
        for y in bounds:
            a = rand(b"ACGT", x)
            pairs.append((a, related_bytes(rng, a, b"ACGT", y, 5)))
    for x, y in ((2500, 2500), (700, 690), (64, 65)):
        a = rand(b"ACGTN", x)
        pairs += [(a, related_bytes(rng, a, b"ACGTN", y, 20)),
                  (rand(b"ACGT", x), rand(b"ACGTN", y))]
    iupac = b"ACGTNacgtnRYKMSWBDHV"
    for x, y in ((2500, 2480), (4095, 4095), (300, 60), (33, 4095)):
        a = rand(iupac, x)
        pairs += [(a, related_bytes(rng, a, iupac, y, 20)), (a, rand(b"ACGT", y)),
                  (rand(bytes(range(256)), x), rand(bytes(range(256)), y))]
    for k in range(64):
        x, y = (60, 60) if k % 4 == 0 else (4095, 4095) if k % 4 == 1 else \
            (60, 4095) if k % 4 == 2 else (4095, 60)
        a = rand(b"ACGT", x)
        pairs.append((a, related_bytes(rng, a, b"ACGT", y, 30)))
    return pairs


def on_card(pairs, L):
    """Padded [B, L] uint8 arrays and [B] int32 lengths of byte pairs, on
    the card."""
    B = len(pairs)
    a = np.zeros((B, L), dtype=np.uint8)
    b = np.zeros((B, L), dtype=np.uint8)
    for i, (x, y) in enumerate(pairs):
        a[i, :len(x)] = np.frombuffer(x, dtype=np.uint8)
        b[i, :len(y)] = np.frombuffer(y, dtype=np.uint8)
    la = np.array([len(x) for x, _ in pairs], dtype=np.int32)
    lb = np.array([len(y) for _, y in pairs], dtype=np.int32)
    return [torch.from_numpy(v).cuda() for v in (a, b, la, lb)]


def check_ed_kernel(pairs, L, label, host_every):
    """Kernel == plain version on the card, bit for bit; every
    host_every-th pair and the last 9 == host Myers. Returns the max
    |kernel - plain|."""
    from sniffles_tpu_torch.ops.edit_distance import edit_distance
    from sniffles_tpu_torch.ops.edit_distance_batch import (
        edit_distance_batch_device, edit_distance_batch_plain)
    inputs = on_card(pairs, L)
    kernel = edit_distance_batch_device(*inputs)
    torch.cuda.synchronize()
    plain = edit_distance_batch_plain(*inputs)
    err = int((kernel - plain).abs().max())
    if err != 0 or not torch.equal(kernel, plain):
        fail(f"ED kernel differs from its plain version on {label} (max err {err})")
    pick = sorted(set(range(0, len(pairs), host_every)) |
                  set(range(max(0, len(pairs) - 9), len(pairs))))
    got = kernel.cpu().numpy()
    for k in pick:
        x, y = pairs[k]
        if int(got[k]) != edit_distance(x.decode("latin-1"), y.decode("latin-1")):
            fail(f"ED kernel differs from host Myers on {label}, pair {k}")
    print(f"  {label} B={len(pairs)}: kernel == plain (bit-exact), "
          f"{len(pick)} pairs == host Myers", flush=True)
    return err


def time_ed_kernel(inputs):
    """Kernel, plain version and bound on one batch the main path gave the
    kernel (inputs: its a, b, la, lb on the card). The kernel's time is
    that of its launch alone, in the wrapper's order; the wrapper (checks,
    sort, counts, launch) and a launch in index order are timed beside it.
    The bound counts the 32-bit word-columns these pairs need,
    ceil(min(la, lb) / 32) * max(la, lb) a pair, at ED_OPS_PER_WORD int32
    operations each, and each input byte read once, each output written
    once."""
    from sniffles_tpu_torch.ops.edit_distance_batch import (
        edit_distance_batch_device, edit_distance_batch_plain, launch_myers)
    B, L = inputs[0].shape
    la = inputs[2].to(torch.int64)
    lb = inputs[3].to(torch.int64)
    dp_cells = int(((la + 1) * (lb + 1)).sum())
    word_cols = int(((torch.minimum(la, lb) + 31) // 32 * torch.maximum(la, lb)).sum())
    in_bytes = 2 * B * L + 8 * B
    out_bytes = 4 * B
    bound_ops_ms = ED_OPS_PER_WORD * word_cols / INT32_OPS_PER_S * 1e3
    bound_bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    wavefront_bound_ms = ED_OPS_PER_CELL_WAVEFRONT * dp_cells / INT32_OPS_PER_S * 1e3
    order = torch.argsort(la * lb, descending=True).to(torch.int32)
    index_order = torch.arange(B, dtype=torch.int32, device=order.device)
    launches = {"sorted": lambda: launch_myers(*inputs, order),
                "index order": lambda: launch_myers(*inputs, index_order),
                "wrapper": lambda: edit_distance_batch_device(*inputs)}

    plain_ms = cuda_ms(lambda: edit_distance_batch_plain(*inputs), 1)
    plain = edit_distance_batch_plain(*inputs)
    err = 0
    for name, fn in launches.items():
        out = fn()
        err = max(err, int((out - plain).abs().max()))
        if not torch.equal(out, plain):
            fail(f"ED kernel ({name}) differs from its plain version on the main "
                 f"path's batch ({B}, {L}) (max err {err})")
    ms = {name: cuda_ms(fn, 20) for name, fn in launches.items()}
    kernel_ms = ms["sorted"]
    real = int(((la + lb) > 0).sum())
    unequal = int((la != lb).sum())
    print(f"  main-path batch B={B} L={L}, {real} non-empty pairs ({unequal} with "
          f"la != lb): {dp_cells} DP cells, "
          f"{word_cols} word-columns; kernel {kernel_ms:.3f} ms "
          f"({dp_cells / kernel_ms / 1e9:.3f} Tcells/s), in index order "
          f"{ms['index order']:.3f} ms, through the wrapper {ms['wrapper']:.3f} ms; "
          f"plain {plain_ms:.1f} ms; all == plain (bit-exact); bound {bound_ms:.3f} ms "
          f"({ED_OPS_PER_WORD} int32 ops/word-column at {INT32_OPS_PER_S / 1e12:.1f} Tops/s: "
          f"{bound_ops_ms:.3f} ms; {in_bytes + out_bytes} bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {bound_bytes_ms:.5f} ms), "
          f"{bound_ms / kernel_ms:.1%} of it; the wavefront kernel's bound "
          f"({ED_OPS_PER_CELL_WAVEFRONT} int32 ops/DP cell) {wavefront_bound_ms:.3f} ms",
          flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
            "max_abs_err": err}


# -- phase 2b ---------------------------------------------------------------

def sweep_params(meta):
    return {k: meta[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                                 "cluster_merge_bnd", "global_repeat")}


def sweep_case(packed, meta):
    """The merge sweep's inputs and initial state for a packed call-task
    batch, built on the card by the main path's own torch ops."""
    from sniffles_tpu_torch.ops import clustering as tc
    sig = tc.packed_signatures(torch.from_numpy(packed).cuda())
    return tc.sweep_inputs(*tc.sort_and_seed(sig, meta["binsize"]), meta["binsize"])


def cuts_params(meta):
    return {k: meta[k] for k in ("cluster_r", "cluster_repeat_h_max", "cluster_merge_bnd")}


def check_sweep_kernel(inputs, state, meta, label):
    """The partition kernel's cut flags (the nseeds live ones, all it
    writes) and counts == its plain version's; then one sweep on the card
    from `state` (both kernels), held against the plain version
    (hold_against_plain). Returns the max |kernel - plain| over the float
    arrays."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[0]
    nseeds = int(inputs["nseeds"][0])
    cut, _, cut_counts = tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta))
    cut = cut.cpu()[:nseeds]
    plain_cut, _, plain_counts = tc.sweep_cuts_plain(
        {k: v.cpu() for k, v in inputs.items()}, {k: v.cpu() for k, v in state.items()},
        **cuts_params(meta))
    plain_cut = plain_cut[:nseeds]
    if not torch.equal(cut, plain_cut) or not torch.equal(cut_counts.cpu(), plain_counts):
        fail(f"sweep_cuts kernel differs from its plain version on {label}: counts "
             f"{cut_counts.tolist()} plain {plain_counts.tolist()}, "
             f"{int((cut != plain_cut).sum())} cut flags differ")
    kernel_state = {k: v.clone() for k, v in state.items()}
    counts = tc.merge_sweep(inputs, kernel_state, **sweep_params(meta)).tolist()
    torch.cuda.synchronize()
    return hold_against_plain(inputs, state, kernel_state, counts, meta, label)


def hold_against_plain(inputs, state, kernel_state, counts, meta, label):
    """The kernel's state and counts after a sweep from `state` == the
    plain version's on CPU copies of the same inputs, in every state
    array, floats bit for bit. Returns the max |kernel - plain| over the
    float arrays."""
    from sniffles_tpu_torch.ops import clustering as tc
    plain_state = {k: v.cpu().clone() for k, v in state.items()}
    plain_counts = tc.merge_sweep_plain({k: v.cpu() for k, v in inputs.items()},
                                        plain_state, **sweep_params(meta)).tolist()
    err = 0.0
    for k in tc.SWEEP_STATE:
        got, want = kernel_state[k].cpu(), plain_state[k]
        if got.dtype == torch.float32:
            err = max(err, float((got - want).abs().max()))
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            same = torch.equal(got, want)
        if not same:
            bad = torch.nonzero(got != want).flatten()[:5].tolist()
            fail(f"merge-sweep kernel differs from its plain version in {k} on {label} "
                 f"at slots {bad}: kernel {got[bad].tolist()} plain {want[bad].tolist()}")
    named = dict(zip(tc.SWEEP_COUNTS, counts))
    if counts != plain_counts:
        fail(f"merge-sweep kernel counted {named}, its plain version "
             f"{dict(zip(tc.SWEEP_COUNTS, plain_counts))}, on {label}")
    nseeds = int(inputs["nseeds"][0])
    merged = nseeds - int(kernel_state["alive"].cpu().sum())
    print(f"  {label}: {nseeds} seeds, {merged} merges, "
          + ", ".join(f"{k} {v}" for k, v in named.items())
          + f"; kernels == plain in the cut flags, the counts and all "
          f"{len(tc.SWEEP_STATE)} state arrays (bit-exact)", flush=True)
    return err


def sweep_bytes(inputs, state, final):
    """The global-memory bytes a sweep from `state` to `final` must move,
    each read once and each write once, counted from what this launch's
    data needs: for every live seed, the slot arrays the criteria read;
    for every merged-away seed, its range end; for every seed that
    absorbed a merge, its range start and back link, and the position and
    length of each stride pick of its surviving range; every state element
    that changed, written once; nseeds read and the iteration count
    written. A sweep that merges nothing reads 28 bytes a seed."""
    from sniffles_tpu_torch.ops import clustering as tc
    nseeds = int(inputs["nseeds"][0])
    changed = sum(int((final[k].view(torch.int32) != state[k].view(torch.int32)).sum())
                  for k in tc.SWEEP_STATE)
    merged = nseeds - int(final["alive"].sum())
    grew = final["hi"] != state["hi"]
    length = (final["hi"] - inputs["lo"])[grew & (final["alive"] == 1)].to(torch.int64)
    stride = (length // length.clamp(max=100).clamp(min=1)).clamp(min=1)
    picks = int(((length + stride - 1) // stride).clamp(max=256).sum())
    return (4 * SWEEP_CRITERIA_ARRAYS * nseeds + 4 * merged + 8 * int(grew.sum())
            + 8 * picks + 4 * changed + 8)


def sweep_edge_batches():
    """(label, packed) edge cases: no seed, one seed, one fragmented read,
    one svtype chain, and the partition's layouts (a head seed alone, BND
    chains, a cascade that collapses the fixpoint)."""
    from sniffles_tpu_torch.sim import edge_call_batches, fuzz_call_batch, sweep_layout_batches
    edges = [(name, packed) for name, packed in edge_call_batches().items()]
    layouts = [(f"layout {name}", packed) for name, packed in sweep_layout_batches().items()]
    return (edges + [("single-svtype chain n=4096", fuzz_call_batch(99, 4096, svtypes=(1,)))]
            + layouts)


def cuts_bytes(inputs, counts):
    """The global-memory bytes the partition must move: seed_type,
    start_bp and end_bp of every live seed and nseeds read once; the cut
    flags of the live seeds (all the sweep reads), a head slot a segment
    and the counts written once."""
    nseeds = int(inputs["nseeds"][0])
    return 12 * nseeds + 4 + nseeds + 4 * counts["segments"] + 4 * len(counts)


def device_ms(launch, state, prepare=lambda st: None, reps=10):
    """Device time of launch(st, prepare(st)), from a fresh copy st of
    `state` each time, between two CUDA events; the mean of `reps` runs
    after one that warms up. prepare's launches come ahead of the start
    event. The card sleeps ahead of that event, so the timed launches are
    queued before it reaches them and the host's launch time stays out.
    Returns (ms, what the last launch returned, its final st)."""
    st = {k: torch.empty_like(v) for k, v in state.items()}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(reps + 1):
        for k, v in state.items():
            st[k].copy_(v)
        ready = prepare(st)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        out = launch(st, ready)
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    return total / reps, out, st


def sweep_device_ms(inputs, state, meta):
    """Device time of one sweep (device_ms), both launches of
    launch_merge_sweep, from sweep_inputs' state to the final state.
    Returns (ms, the counts the sweep returned by name, the final
    state)."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[0]
    ms, out, st = device_ms(
        lambda st, _: tc.launch_merge_sweep(inputs, st, n, **sweep_params(meta)), state)
    return ms, dict(zip(tc.SWEEP_COUNTS, out.cpu().tolist())), st


def segments_device_ms(inputs, state, meta):
    """Device time of the kernel merge_sweep alone (device_ms of
    launch_segment_sweep, the partition launched ahead of the start
    event). Returns (ms, the counts by name, the final state)."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[0]
    ms, out, st = device_ms(
        lambda st, part: tc.launch_segment_sweep(inputs, st, n, *part, **sweep_params(meta)),
        state, lambda st: tc.launch_sweep_cuts(inputs, st, n, **cuts_params(meta)))
    return ms, dict(zip(tc.SWEEP_COUNTS, out.cpu().tolist())), st


def cuts_device_ms(inputs, state, meta):
    """Device time of the partition alone (device_ms of
    launch_sweep_cuts); returns (ms, cut flags, counts by name)."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[0]
    ms, (cut, _, counts), _ = device_ms(
        lambda st, _: tc.launch_sweep_cuts(inputs, st, n, **cuts_params(meta)), state)
    return ms, cut, dict(zip(tc.SWEEP_COUNTS, counts.cpu().tolist()))


def time_sweep_case(inputs, state, meta, label):
    """Prints the device time of one sweep over a case (both launches)
    beside its seeds, merges and the counts the sweep returned, and the
    times of the partition and of the segment kernel, each alone."""
    ms, counts, final = sweep_device_ms(inputs, state, meta)
    nseeds = int(inputs["nseeds"][0])
    merged = nseeds - int(final["alive"].sum())
    print(f"  {label}: {nseeds} seeds, {merged} merges, "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; sweep {ms:.4f} ms ({ms * 1e3 / max(counts['depth'], 1):.3f} us a step of "
          f"its longest chain): sweep_cuts alone {cuts_device_ms(inputs, state, meta)[0]:.4f} "
          f"ms, merge_sweep alone {segments_device_ms(inputs, state, meta)[0]:.4f} ms",
          flush=True)


def time_cuts_kernel(inputs, state, meta):
    """The partition kernel and its plain version (on the card) on the
    inputs of the main path's largest sweep, and its bound: the bytes it
    must move (cuts_bytes) over the card's memory rate, against
    CUTS_OPS_PER_SEED int32 operations a live seed and pass."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[0]
    nseeds = int(inputs["nseeds"][0])
    ms, cut, counts = cuts_device_ms(inputs, state, meta)
    plain_ms = cuda_ms(lambda: tc.sweep_cuts_plain(inputs, state, **cuts_params(meta)), 1)
    plain_cut, _, plain_counts = tc.sweep_cuts_plain(inputs, state, **cuts_params(meta))
    if (not torch.equal(cut[:nseeds], plain_cut[:nseeds])
            or list(counts.values()) != plain_counts.tolist()):
        fail("sweep_cuts kernel differs from its plain version on the main path's task")
    n_bytes = cuts_bytes(inputs, counts)
    bound_bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = CUTS_OPS_PER_SEED * nseeds * counts["passes"] / INT32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"  main-path partition n={n}: {nseeds} seeds, {counts['segments']} segments, "
          f"{counts['passes']} passes, collapsed {counts['collapsed']}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms; == plain (bit-exact); bound {bound_ms * 1e3:.4f} us "
          f"({n_bytes} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {CUTS_OPS_PER_SEED} ops "
          f"a seed and pass: {bound_ops_ms * 1e3:.5f} us), {bound_ms / ms:.5%} of it",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "max_abs_err": 0}


def time_sweep_kernel(inputs, state, meta):
    """The kernel merge_sweep alone (the partition launched ahead of its
    timing) and its plain version, segment_sweep_plain (on the card, from
    the plain partition, which is not timed), on the inputs of the main
    path's largest sweep, each from a fresh copy of the state; and the
    bound: the bytes this sweep must move (sweep_bytes) over the card's
    memory rate, against its iterations' operations over the int32 rate.
    The sweep's time with both launches is printed on a line of its own."""
    from sniffles_tpu_torch.ops import clustering as tc
    params = sweep_params(meta)
    n = inputs["seed_type"].shape[0]
    kernel_ms, counts, st = segments_device_ms(inputs, state, meta)
    both_ms = sweep_device_ms(inputs, state, meta)[0]
    iters = counts["iterations"]
    plain_state = {k: v.clone() for k, v in state.items()}
    partition = tc.sweep_cuts_plain(inputs, plain_state, **cuts_params(meta))
    plain_ms = cuda_ms(lambda: tc.segment_sweep_plain(inputs, plain_state, *partition,
                                                      **params), 1)
    err = max(float((st[k] - plain_state[k]).abs().max()) for k in ("msv", "sd"))
    if (any(not torch.equal(st[k], plain_state[k]) for k in tc.SWEEP_STATE)
            or list(counts.values()) != partition[2].tolist()):
        fail("merge-sweep kernel differs from its plain version on the main path's task")
    nseeds = int(inputs["nseeds"][0])
    merged = nseeds - int(st["alive"].sum())
    n_bytes = sweep_bytes(inputs, state, st)
    bound_bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = SWEEP_OPS_PER_ITERATION * iters / INT32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"  main-path sweep n={n}: {nseeds} seeds, {merged} merges, "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; merge_sweep kernel {kernel_ms:.4f} ms, plain {plain_ms:.1f} ms; "
          f"bound {bound_ms * 1e3:.4f} us ({n_bytes} bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {SWEEP_OPS_PER_ITERATION} ops an iteration "
          f"at {INT32_OPS_PER_S / 1e12:.1f} Tops/s: {bound_ops_ms * 1e3:.5f} us), "
          f"{bound_ms / kernel_ms:.5%} of it", flush=True)
    print(f"  main-path sweep n={n}, both launches (sweep_cuts, then merge_sweep): "
          f"{both_ms:.4f} ms", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "max_abs_err": err}


# -- phase 3 ----------------------------------------------------------------

def vcf_parts(path):
    header, records = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                if not line.startswith(("##command=", "##fileDate=")):
                    header.append(line)
            else:
                records.append(line)
    return header, records


def run_cli(args, extra, counters_path, what):
    """The port's CLI in this process; its log goes to a buffer that is
    printed only when the run fails."""
    from sniffles_tpu_torch import cli
    os.environ["SNIFFLES_TPU_COUNTERS_JSON"] = counters_path
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([*args, "--threads", "0", "--allow-overwrite", *extra])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-6000:])
        fail(f"{what} {' '.join(extra) or '(device path)'} exited {rc}")
    counters = {}
    if os.path.exists(counters_path):   # written only when a task counted
        with open(counters_path) as f:
            counters = json.load(f)
    return wall, counters


# -- phase 4 ----------------------------------------------------------------

@contextlib.contextmanager
def stage_times(totals):
    """Adds the host-clock seconds of the call path's stages to `totals`
    while the block runs: BAM decode and lead extraction (build_leadtab),
    clustering (device_clusters on the device path; the host sweep,
    cluster.resolve, for the rest), the calls (call_candidates without its
    clustering) and QC, annotation and genotyping (finalize_candidates).
    Each wrapped function ends in a synchronize, so a stage's time holds
    its device work."""
    from sniffles_tpu_torch import cluster
    from sniffles_tpu_torch.parallel import device_call
    from sniffles_tpu_torch.pipeline import tasks
    saved = [(tasks.CallTask, "build_leadtab"), (tasks.CallTask, "call_candidates"),
             (tasks.CallTask, "finalize_candidates"), (device_call, "device_clusters"),
             (cluster, "resolve")]
    originals = [getattr(owner, name) for owner, name in saved]

    def timed(fn, key, generator=False):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = list(fn(*args, **kwargs)) if generator else fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    keys = ("decode+leads", "calls", "finalize", "cluster:device", "cluster:host")
    for (owner, name), fn, key in zip(saved, originals, keys):
        setattr(owner, name, timed(fn, key, generator=name == "resolve"))
    try:
        yield totals
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)
        totals["calls"] -= totals.get("cluster:device", 0.0) + totals.get("cluster:host", 0.0)


def run_dense_call(tmp, meta):
    """call_sample on the dense leg, device path then host path, and every
    sweep launch of the device path held against the plain version.
    Returns (the inputs and initial state of the sweep with the most
    seeds, the kernel launches by count name, the max |kernel - plain| of
    the float state)."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    t0 = time.perf_counter()
    bam, fa = write_dataset(tmp, ref_len=DENSE_REF_LEN, svs=dense_layout(DENSE_REF_LEN),
                            depth=DENSE_DEPTH, read_len=12_000, seed=DENSE_SEED,
                            n_contigs=DENSE_CONTIGS)
    print(f"    wrote {DENSE_CONTIGS} contigs of {DENSE_REF_LEN // 1_000_000} Mb at depth "
          f"{DENSE_DEPTH} ({os.path.getsize(bam) / 1e6:.1f} MB BAM) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # host copies of every sweep launch's inputs, its state before the
    # launch (which updates it in place) and after, and CUDA events around
    # each task's call_task_packed; both wrappers are looked up at each call
    sweep, task_step, kept, task_events = tc.merge_sweep, tc.call_task_packed, [], []

    def keep_every(inputs, state, **params):
        before = {k: v.cpu() for k, v in state.items()}
        counts = sweep(inputs, state, **params)
        kept.append(({k: v.cpu() for k, v in inputs.items()}, before,
                     {k: v.cpu() for k, v in state.items()}, counts.tolist()))
        return counts

    def timed_step(packed, **meta):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = task_step(packed, **meta)
        stop.record()
        task_events.append((packed.shape[1], start, stop))
        return out

    args = ["--input", bam, "--reference", fa]
    torch.cuda.reset_peak_memory_stats()
    tc.reset_counts()
    tc.merge_sweep, tc.call_task_packed = keep_every, timed_step
    dev_stages, host_stages = {}, {}
    try:
        with stage_times(dev_stages):
            dev_wall, dev_counters = run_cli([*args, "--vcf", os.path.join(tmp, "device.vcf")],
                                             [], os.path.join(tmp, "k1.json"), "call_sample")
    finally:
        tc.merge_sweep, tc.call_task_packed = sweep, task_step
    launches = dict(tc.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    task_ms = [(n, start.elapsed_time(stop)) for n, start, stop in task_events]
    with stage_times(host_stages):
        host_wall, _ = run_cli([*args, "--vcf", os.path.join(tmp, "host.vcf")], ["--no-tpu"],
                               os.path.join(tmp, "k2.json"), "call_sample")
    dev_parts = vcf_parts(os.path.join(tmp, "device.vcf"))
    host_parts = vcf_parts(os.path.join(tmp, "host.vcf"))
    n_records = len(dev_parts[1])
    print(f"    device path {dev_wall:.2f} s, host path {host_wall:.2f} s, {n_records} "
          f"records, peak device memory {peak / 2**20:.1f} MiB", flush=True)
    print(f"    device counters {json.dumps(dev_counters, sort_keys=True)}")
    for label, stages, wall in (("device", dev_stages, dev_wall), ("host", host_stages,
                                                                 host_wall)):
        print(f"    {label} path stages (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()) +
              f", rest {wall - sum(stages.values()):.3f}", flush=True)
    print(f"    call_task_packed per task (width, ms): "
          f"{[(n, round(ms, 3)) for n, ms in task_ms]}; kernel launches {launches}",
          flush=True)
    if dev_parts != host_parts:
        fail("call_sample: device-path VCF differs from the host-path VCF")
    if n_records < 1500:
        fail(f"call_sample: only {n_records} records")
    if dev_counters.get("engine_consumed", -1) != dev_counters.get("children_total", -2):
        fail("call_sample: device statistics were not consumed by every child")
    routes = {k: dev_counters.get(k, 0) for k in ("fb_resplit", "fb_multi_fragment",
                                                   "fb_support_collision", "fb_capacity")}
    if any(routes.values()):
        fail(f"call_sample: exactness routes taken {routes}")
    tasks = dev_counters.get("device_tasks", 0)
    if tasks != DENSE_CONTIGS or any(v != tasks for v in launches.values()):
        fail(f"call_sample: kernel launches {launches} for {tasks} device tasks")
    print("    device VCF == host VCF", flush=True)
    err = 0.0
    for j, (inputs, before, after, counts) in enumerate(kept):
        n = inputs["seed_type"].shape[0]
        err = max(err, hold_against_plain(inputs, before, after, counts, meta,
                                          f"main-path sweep {j} n={n}"))
    largest = max(kept, key=lambda launch: int(launch[0]["nseeds"][0]))
    return largest[:2], launches, err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke run needs a card",
              file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import edit_distance_batch as ted

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {smi} | torch {torch.__version__} (CUDA {torch.version.cuda}) "
          f"| {name} | count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_verbose=True)
    print(f"[1] built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    print("[2] edit-distance kernel against its plain version", flush=True)
    rng = np.random.default_rng(7)
    max_err = 0
    for L, B in ((128, 4096), (1024, 4096), (2560, 2048), (4096, 2048)):
        pairs = (random_pairs(rng, B // 2, L, related=False)
                 + random_pairs(rng, B - B // 2, L, related=True) + edge_pairs(L))
        pairs = [(x.encode(), y.encode()) for x, y in pairs]
        max_err = max(max_err, check_ed_kernel(pairs, L, f"L={L}", len(pairs) // 100))
    max_err = max(max_err, check_ed_kernel(special_pairs(rng), 4096,
                                           "word boundaries, alphabets, 60/4095 mix", 1))

    print("[2b] merge-sweep kernel against its plain version", flush=True)
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.parallel.device_call import standard_call_meta
    from sniffles_tpu_torch.sim import fuzz_call_batch
    meta = standard_call_meta(SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf"))
    sweep_err = 0.0
    cases = [(f"fuzz n={n} seed {seed}", fuzz_call_batch(seed, n))
             for n, seed in ((32768, 1), (32768, 2), (65536, 5), (512, 3), (512, 4))]
    timed_cases = {}
    for label, packed in cases + sweep_edge_batches():
        inputs, state = sweep_case(packed, meta)
        sweep_err = max(sweep_err, check_sweep_kernel(inputs, state, meta, label))
        if label in SWEEP_TIMED:
            timed_cases[label] = (inputs, state)

    print(f"[3] combine: {COHORT_SAMPLES}-sample cohort, 2 contigs of 1 Mb", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        from sniffles_tpu_torch.sim import write_cohort
        t0 = time.perf_counter()
        snfs = write_cohort(os.path.join(tmp, "cohort"), COHORT_SAMPLES, COHORT_SEED)
        print(f"    wrote {len(snfs)} SNFs in {time.perf_counter() - t0:.1f} s", flush=True)
        dev_vcf, host_vcf = os.path.join(tmp, "device.vcf"), os.path.join(tmp, "host.vcf")
        # a host copy of the inputs of the main path's largest kernel launch,
        # for the timing below (the dispatcher looks the wrapper up at each
        # call; a host copy leaves the run's peak device memory as it is)
        wrapper, largest, shapes = ted.edit_distance_batch_device, [], []

        def keep_largest(*inputs):
            shapes.append(tuple(inputs[0].shape))
            if not largest or inputs[0].numel() > largest[0].numel():
                largest[:] = [x.cpu() for x in inputs]
            return wrapper(*inputs)

        torch.cuda.reset_peak_memory_stats()
        ted.reset_counts()
        ted.edit_distance_batch_device = keep_largest
        try:
            dev_wall, dev_counters = run_cli(["--input", *snfs, "--vcf", dev_vcf], [],
                                             os.path.join(tmp, "c1.json"), "combine")
        finally:
            ted.edit_distance_batch_device = wrapper
        launches, cells = ted.COUNTS["launches"], ted.COUNTS["cells"]
        peak = torch.cuda.max_memory_allocated()
        host_wall, host_counters = run_cli(["--input", *snfs, "--vcf", host_vcf],
                                           ["--no-tpu"], os.path.join(tmp, "c2.json"),
                                           "combine")
        dev_parts, host_parts = vcf_parts(dev_vcf), vcf_parts(host_vcf)
        n_records = len(dev_parts[1])
        print(f"    device path {dev_wall:.2f} s, host path {host_wall:.2f} s, "
              f"{n_records} records, peak device memory {peak / 2**20:.1f} MiB", flush=True)
        print(f"    device counters {json.dumps(dev_counters, sort_keys=True)}")
        print(f"    ED kernel launches {launches}, cells {cells}, shapes {shapes}")
        if dev_parts != host_parts:
            fail("device-path VCF differs from the host-path VCF")
        if n_records < 100:
            fail(f"only {n_records} records")
        if launches < 1 or cells < ted.DEVICE_MIN_CELLS:
            fail(f"the main path launched the ED kernel {launches} times over {cells} cells")
        if dev_counters.get("combine_greedy_dispatches", 0) < 1:
            fail("the device greedy never ran")
        print("    device VCF == host VCF", flush=True)

    print(f"[4] call_sample: {DENSE_CONTIGS} contigs of {DENSE_REF_LEN // 1_000_000} Mb, "
          f"depth {DENSE_DEPTH}, seed {DENSE_SEED} (the dense bench leg)", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_call_") as tmp:
        sweep_largest, sweep_launches, err = run_dense_call(tmp, meta)
    sweep_err = max(sweep_err, err)

    print("[5] kernel timings on the main paths' largest launches", flush=True)
    timing = time_ed_kernel([x.cuda() for x in largest])
    max_err = max(max_err, timing["max_abs_err"])
    sweep_timing = time_sweep_kernel(*({k: v.cuda() for k, v in d.items()}
                                       for d in sweep_largest), meta)
    sweep_err = max(sweep_err, sweep_timing["max_abs_err"])
    cuts_timing = time_cuts_kernel(*({k: v.cuda() for k, v in d.items()}
                                     for d in sweep_largest), meta)
    for label, (inputs, state) in timed_cases.items():
        time_sweep_case(inputs, state, meta, label)
    kernels = [{
        "name": "edit_distance_myers", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/edit_distance.cu",
        "replaces": "sniffles_tpu/ops/edit_distance_jax.py:37",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "merge_sweep", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/merge_sweep.cu",
        "replaces": "sniffles_tpu/ops/clustering.py:90",
        "launches": sweep_launches["launches"], "max_abs_err": sweep_err,
        "ms": sweep_timing["ms"], "plain_ms": sweep_timing["plain_ms"],
        "bound_ms": sweep_timing["bound_ms"], "bound_by": sweep_timing["bound_by"],
        "library_ms": None}, {
        "name": "sweep_cuts", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/merge_sweep.cu",
        "replaces": "sniffles_tpu/ops/clustering.py:339",
        "launches": sweep_launches["sweep_cuts"], "max_abs_err": cuts_timing["max_abs_err"],
        "ms": cuts_timing["ms"], "plain_ms": cuts_timing["plain_ms"],
        "bound_ms": cuts_timing["bound_ms"], "bound_by": cuts_timing["bound_by"],
        "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
