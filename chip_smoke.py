#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sniffles_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. set-up: the card's name and power limit; build every CUDA kernel of
     the port from csrc/ (one nvcc per source, started together), with
     ptxas's register and shared-memory report, and beside them the
     native host library from csrc/host/ (the host C++ compiler);
  2. the edit-distance kernel against its plain PyTorch version on the
     card, bit for bit, at the main path's shapes and edge cases (lengths
     at 32-bit word boundaries, alphabets beyond ACGT, a batch mixing
     60 bp and 4,095 bp pairs), a subsample against the host Myers scan;
  2b. the merge sweep's two kernels (the sound-cut partition, sweep_cuts,
     then a thread per segment, merge_sweep) against their plain PyTorch
     versions (run on the CPU copies of the same inputs), bit for bit in
     the cut flags, the heads, the counts and every state array (the
     partition with its candidate cuts in shared memory and in its global
     scratch): fuzz batches whose
     seeds merge, at the dense call tasks' padded widths n = 32,768 and
     n = 65,536 and at n = 512, the edges nseeds = 0, one seed, one
     fragmented read and a single-svtype chain, and the partition's
     layouts (a head seed alone, BND chains, a cascade that collapses
     the fixpoint);
  2d. the combine greedy's two kernels (csrc/combine_greedy.cu: the
     whole-task grid greedy, a warp a segment row, and the flush greedy)
     against their plain PyTorch versions on CPU copies of the same
     inputs, bit for bit in assign, seg_flags and flags, on every payload
     of sim.greedy_task_payloads, sim.greedy_flush_payloads and
     sim.greedy_flush_wide_payloads;
  2e. the clustering's segmented sorts (csrc/cluster_sorts.cu: the run
     pass and the thread tier, the warp and block tiers, the gather of
     many columns, the stages' predicates) against their
     plain versions on CPU copies of the same inputs, bit for bit:
     sim.seg_sort_batch's populations (segments of 1, of each tier
     threshold and one either side of it, presorted and all-equal
     segments, keys at the int32 limits, no valid element, a segment of
     2^20, the warp tier's packed segments of 9 to 64) with two keys, one
     key and through a base permutation; then every seg_sort,
     gather_columns and predicate call of call_task_packed on sim.fuzz_call_batch seeds 1 and 2 (n =
     32,768) and sim.edge_call_batches(), and of the engine's clustering on
     phase 10d's 2^21 batch and on chain2^21 (segments of up to 3,689: the
     block tier);
  3. combine on the card: a 256-sample cohort written by
     sniffles_tpu_torch.sim, combined into a multi-sample VCF on the card
     (the device greedy and the edit-distance kernel) and again on the
     host path (--no-tpu); the two VCFs must be identical, and the kernel
     must have been launched by the device run; every greedy dispatch
     (one launch of the grid kernel each) kept as a host copy of its
     payload and result and held against the plain version on the CPU,
     bit for bit;
  4. call_sample on the card: the JAX package's compute-dense bench leg
     (3 contigs of 2 Mb, depth 60, seed 17, sim.dense_layout) written by
     sniffles_tpu_torch.sim and called on the device path (--threads 0)
     and on the host path (--no-tpu): identical records, at least 1,500
     of them, every device child's statistics consumed, no exactness
     route taken but BND's, one launch of each sweep kernel and of the
     call statistics (csrc/call_stats.cu) per task, and the state and
     counts of every one of those sweeps == the plain version's on the
     same inputs, bit for bit, and five segmented sorts and gathers and two
     predicates a task (csrc/cluster_sorts.cu); (b) each task's call statistics (the folded
     children, unfused) == the plain version on CPU copies of its inputs on
     every key and slot, and on the card in the integer keys; the device
     time of call_task_packed per task (CUDA events), the wall time of
     both paths and the peak device memory are printed.
  3b. combine with --threads 4, the worker pool and the parent's device
     service, in a child process (`python -m sniffles_tpu_torch`, the
     parent users run, which refuses to fork with a CUDA context):
     its VCF == phase 3's device and host VCFs, the edit-distance kernel
     launched by the parent at least once, the greedy kernel wherever the
     run made a greedy dispatch (as in phases 6, 8 and 9d); the service's
     counters and the edit-distance batches of --threads 0 and --threads 4
     are printed;
  4b. call_sample on the dense leg with the default command line (no
     --threads: 4 workers) in a child process (`python -m
     sniffles_tpu_torch`): records == phase 4's, every child's statistics
     consumed, no route but BND's; its service counters, its parent's
     kernel launches and its wall beside that of --threads 0 (another
     child) are printed. Then again in a child that runs the CLI the same
     way and keeps every merge-sweep launch of its device service (a host
     copy before and after each): every launch, solo and fused, held
     against the plain version bit for bit;
  2c. the batched sweep: stacks of k = 2 and k = 4 tasks of one width
     (phase 2b's fuzz batches at n = 32,768, the dense leg's two tasks of
     that width, a zero pad slot), one launch of each kernel a stack,
     every slice's cut flags, counts and state == the single-task
     kernel's and the plain version's, bit for bit.
  6. the other run modes, on three samples (one contig of 2 Mb each,
     sim.dense_layout, depth 30, seeds 31, 32 and 33): (a) --snf with
     --vcf, every sample in process on the device path (every merge-sweep
     launch held against the plain version bit for bit), sample 31 again
     on the host path and in a child process with the default command
     line: its three SNFs equal (index, decompressed blocks, header config
     apart from SNF_OUTPUT_KEYS and the keys of any two runs) and its
     three VCFs equal; (b) the three device SNFs combined to a .vcf.gz
     with --dev-population-snf, on the device and host paths: equal
     records, each contig's records back from the .tbi index, equal
     population SNFs; then a combine annotated with --combine-population,
     device and host: equal records, POPULATION_AF on every one; every
     edit-distance launch of the device combines held against the plain
     version on the card, bit for bit; (c) force calling,
     sample 31's BAM against sample 32's VCF from (a), plain and gzipped,
     on the device path in process (every sweep held against plain), on
     the host path and in a child with the default command line: every
     VCF's records equal.
  7. the native host library (csrc/host/, built by the host compiler at
     first use; phases 3-6 scan their BAMs with it) on the card's host:
     (a) dense3 as CRAM: phase 4's BAM inflated by the library in this
     process, which holds a CUDA context, equal to zlib's; the BAM written
     as a reference-based CRAM by the port's cramwrite (sim.write_cram),
     its reads fetched per contig through the .crai equal to the BAM's
     (count, names, positions); the CRAM called on the device path in
     process (every sweep launch held against the plain version bit for
     bit) and with the default command line in a child: records == phase
     4's, every child's statistics consumed; (b) dense3 on the device path
     with --no-native, the pure-Python scan: records == phase 4's, the
     decode-ahead time of both scans printed; (c) --dev-locasm-do on an
     INS and a DEL filtered by --minsupport (the generator of
     tests/test_local_asm_rescue.py), device and host paths: equal VCFs,
     the assemblies and rescued calls counted (at least one of each);
     (d) --dev-cache, modes3's sample 31 twice: the second run loads the
     task's leadtab from the cache, and both VCFs equal phase 6's.
  8a. the wall of a child process in parts, before any daemon code runs:
     each child of phases 3b and 4b runs unbuffered and every line of its
     log is stamped on arrival; dense3 at --threads 4 and 0 and combine256
     at --threads 4 are split into start and imports (to "Running"), the
     configuration and the device and index checks (to "Opening for
     writing"), planning and the pool's start, the analysis (of which the
     service's warmup), the emission (to "Wrote N called SVs") and the
     exit.
  8. the device daemon: one process (this script's --daemon-child, which
     runs the port's device daemon as `python -m` does and keeps every
     merge-sweep and edit-distance launch on the host) holds the card and
     serves, each in a child with no card visible (CUDA_VISIBLE_DEVICES
     empty): dense3 at --threads 4 and 0, combine256 at --threads 4,
     modes3's sample 31 with --snf and its force call, and two dense3 runs
     at once; every VCF and SNF == the same run's in phases 3, 4 and 6;
     cluster_assign on phase 2b's fuzz batches and combine_greedy on
     tests/test_combine_greedy_kernel.py's cases on the card through the
     daemon, each == its plain version on the CPU; the daemon's launches
     of each kernel over those runs (> 0), and every launch it kept held
     against its plain version; phase 8a's splits again with the daemon,
     side by side; the daemon shut down by request, then a second one
     that must exit by itself after --idle-timeout 2.
  9. --tpu-mesh 4, four genome shards on the one card
     (SNIFFLES_TPU_MESH_DEVICES=cuda:0,cuda:0,cuda:0,cuda:0, set for the
     whole script): (a) phase 2b's fuzz batches with mixed head masks
     (0x00, 0x0A, 0xF5, and a stack of three tasks with three masks in one
     launch): kernels == plain; (c) dense3 at --tpu-mesh 4, --threads 0
     and 4, each in a child that keeps every sweep launch (and the mesh
     payloads): VCFs == phase 4's, mesh_tasks = 3 and no seam route, every
     launch == plain with mixed head masks among them; (b) the mesh call
     step (parallel/mesh.py build_sharded_assign) on dense3's largest
     task's payload as 4 shards on cuda:0 against the same step on 4 CPU
     shards (the plain versions): rows and overflow flags bit for bit;
     (d) the mesh cohort (tests/test_mesh_combine_cli.py's: three samples
     at depth 18, called to .snf) and combine256 at --tpu-mesh 4, each in
     a child that keeps every edit-distance launch: VCFs == their host
     VCFs, combine_mesh_flushes > 0 on the cohort, every launch (per-flush
     batches, at least one on combine256) == plain bit for bit; (e) (inside
     phase 8) dense3 at --tpu-mesh 4 served by phase 8's daemon: VCF ==
     phase 4's, its launches held against plain with the daemon's; (f) two
     processes on the card joined by SNIFFLES_TPU_COORDINATOR (the
     multi-host run, --tpu-mesh 4): process 0 writes phase 4's records,
     process 1 writes nothing, the 3 tasks split between them.
  10. the fused calling engine (parallel/engine.py, call_pipeline_step) and
     its three kernel sources (csrc/merge_relax.cu, the relaxation's rounds;
     csrc/call_stats.cu, the call statistics, a run pass, then a thread, a
     warp or a block a cluster by its size; csrc/candidate_tail.cu,
     coverage, genotype and QC in one pass): (a)
     the whole step on the card against the same step on the CPU (the
     plain versions), every output key bit for bit, on
     __graft_entry__.entry()'s batch (4,096 signatures, 1 Mb of coverage
     at 30) and bench.py::bench_device's two sizes (2^16 and 2^21
     signatures, n/40 sites, seed 42); (b) dense3's chr1 signatures
     (from_leads of the port's lead provider over phase 4's BAM, its
     coverage) under the default flags, --mosaic and --minsupport auto
     --qc-nm: card == CPU, the filter codes counted; (c) build_sharded_step
     as 4 shards on cuda:0 against 4 CPU shards, on
     __graft_entry__.dryrun_multichip's recipe (16,384 bp and 256 slots a
     shard, halo_bp 2,000, 64 halo slots) and on dense3's chr1 in 4
     windows of 500 kb: integer outputs and halo_overflow equal; every
     kernel launched on (a)-(c), the call statistics on each of (a), (b) and
     (c), and each call-statistics call of (a) and (c) held against the
     plain version (on CPU copies of its inputs every key and slot bit for
     bit, on the card the integer keys; float32 sums on the card add with
     atomics); (d) the call statistics held so on the tiled chain's 2^21
     slots and on tests/test_torch_call_stats.py's crafted batches (both
     settings; the tier and huge batches among them), timed at 2^21 (the
     wrapper, the kernels alone, the plain version on the card, the bound,
     no host synchronisation, the engine step's statistics stage through
     tools/profile_engine.py, the kernels alone on each population of
     tools/time_call_stats.py, held first, torch.searchsorted beside the
     run pass and torch.where beside the sort's keys, and each of the five
     kernels by torch.profiler beside its bound and ptxas's report);
     and at 2^21 signatures each kernel against
     its plain version on the card (bit for bit) and timed (CUDA events)
     beside its bound, the relaxation's rounds, the step's device time,
     signatures a second, peak device memory and host synchronisations
     (none inside the relaxation: set_sync_debug_mode("error")); the
     relaxation again on 2^21 slots of the tiled 36-link chain
     (sim.relax_chain_batch: the 32-round cap binds), held against its
     plain version (boundaries and rounds), timed beside it and its bound,
     with no host synchronisation; the tail's registers and spills from
     phase 1's ptxas report; the tail's run pass (tail_runs) alone on the
     step's 2^21 cluster ids, held bit for bit against tail_runs_plain,
     timed (torch.profiler and CUDA events) beside its byte bound and
     torch.searchsorted of the same ids.
  11. the port's benchmark and its differential fuzz, each in a child
     process: `python -m sniffles_tpu_torch.bench` with BENCH_CONTIGS=1,
     BENCH_PAIRS=1, BENCH_SKIP_SCALE=1 and BENCH_SKIP_COMBINE=1 (the quick
     leg on 1 contig of 1.2 Mb, the dense leg on phase 4's dense3, each
     host against the device path served by the port's daemon in one
     alternating pair after the warmups, then the engine legs at their full
     2^16 and 2^21 signatures): exit 0, one JSON line on stdout, every
     *_records_identical true, the device legs' medians, both engine rates
     and the host chain's rate above 0, the daemon on the card with merge
     sweeps launched, its "device" the card's nvidia-smi line; then
     `python -m sniffles_tpu_torch.tools.diff_fuzz 1 1000` (seed 1000: a
     CRAM at --tpu-mesh 2 and --threads 2), the device path against the
     host path on the card: every VCF and SNF equal (the fuzz's rules).
Then (5) the kernels' timings on the inputs of the main paths' largest
launches (CUDA events) beside their bounds and plain versions (the
greedy's: combine256's dispatch of the most candidates, the kernel against
the torch loop on the card; the segmented sorts' at the engine step's 2^21
signatures, beside one torch.sort of the same permutation, sort and
seed's gather (a random permutation), the resplit's (a local one) and a
call task's fold at n = 65,536, each beside index_select a column), the
sweep's device time on phase 2b's fuzz batches and chain, the fused
sweep of phase 2c's k = 4 stack against its k single sweeps, the host
synchronisations of call_task_packed and batched_call_task on the card
(torch.cuda.set_sync_debug_mode), one JSON line of kernel figures (the
launches are those of the threaded paths, 3b and 4b), the nvidia-smi
name and power-limit line, and, last, {"ok": true, "device": {...}}.
Without a card it exits non-zero before any of that.

    python3 chip_smoke.py --cli-child KEEP ARGS...

is the child of phases 4b and 9: the CLI with ARGS, every merge-sweep
launch kept and saved to KEEP (torch.save) when the CLI ends, every
edit-distance launch to KEEP.ed, and the payload of every mesh call step
to KEEP.mesh (pickle).

    python3 chip_smoke.py --daemon-child KEEP ARGS...

is phase 8's daemon: the port's device daemon with ARGS, every
merge-sweep and edit-distance launch kept and saved to KEEP when it ends.
"""
import concurrent.futures
import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
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
# phase 6: three samples of one contig, sim.dense_layout, seeds 31-33
MODES_SEEDS = (31, 32, 33)
MODES_REF_LEN = 2_000_000
MODES_DEPTH = 30
# config keys of the SNF header that differ between phase 6's runs of one
# sample (or one cohort) beside those of any two runs
# (sniffles_tpu_torch.io.snf_compare.RUN_KEYS_THAT_DIFFER), and why;
# every other key must be equal
SNF_OUTPUT_KEYS = {
    "snf": "each run writes an SNF of its own",
    "vcf": "each run writes a VCF of its own",
    "uncompressed_vcf_name": "the VCF's name without .gz, kept on the config",
    "dev_population_snf": "each combine writes a population SNF of its own",
}
# phase 7 (c): tests/test_local_asm_rescue.py's generator, an INS and a DEL
# at depth 18 that --minsupport 30 filters, so the rescue assembles both
LOCASM_SEED = 31
LOCASM_LAYOUT = ((40_000, "INS", 220), (80_000, "DEL", 300))
# cycles of the device sleep queued ahead of a timed sweep (about 1 ms)
SLEEP_CYCLES = 2_000_000
# int32 operations a live seed and pass of the partition's walk (the cut
# test: a compare of types, three differences, a min, a multiply, two
# compares), counted from csrc/merge_sweep.cu
CUTS_OPS_PER_SEED = 8
# phase 9: four genome shards on the one card
MESH_SHARDS = 4
MESH_DEVICES = ",".join(["cuda:0"] * MESH_SHARDS)
# the head masks of phase 9a (0xFF, every caller's but a mesh shard's, is phase 2b's)
MESH_HEAD_MASKS = (0x00, 0x0A, 0xF5)
# phase 10: the engine's sharded step as four shards on the one card
ENGINE_SHARDS = 4
# float32 operations a second outside the tensor cores (H100 SXM data sheet)
FP32_OPS_PER_S = 67e12
# int32 operations an element and round of the relaxation, counted from
# csrc/merge_relax.cu: its head's walk (a load, a multiply, an add, a min, a
# max, an or, the boundary test) and its share of the segment's stride picks
RELAX_OPS_PER_ELEMENT = 12
# float32 operations a candidate slot of the tail, counted from
# csrc/candidate_tail.cu: the probes' index arithmetic, five coverage means,
# the rescale, the likelihoods and their sort, and the QC cascade's tests
TAIL_OPS_PER_SLOT = 150
# operations an element of the call statistics, counted from
# csrc/call_stats.cu: each median's run tests (two compares, the run
# length, the kept test, the rank count) for svlen and pos, each trimmed
# stdev's centering, conversion, square and two adds, the read run test
# and count, the mapq conversion and add, the NM add, the strand test and
# count, the svtype max
CALL_STATS_OPS_PER_ELEMENT = 30
# bytes an element and slot of the call statistics as a function: the
# clustered batch's seven int32 columns, nm and valid read once (33), the
# 16 int32 rows written once (64)
CALL_STATS_BYTES = 33 + 64
# the same for the kernels after the sort (the entry point call_stats):
# the sorted keys and the int64 permutation of the one sort (12), svlen,
# pos, read id, mapq, strand, svtype and NM (28), the 16 rows (64)
CALL_STATS_KERNEL_BYTES = 12 + 28 + 64
# a kernel's reads of an element it gathers: its permutation entry and the
# seven columns (svlen, pos, read id, mapq, strand, svtype, NM)
CALL_STATS_GATHER_BYTES = 8 + 28
# int32 operations of a compare of a comparison sort of a cluster's list
# (the compare and the two moves), three lists sorted; a list of cnt
# elements needs about cnt * log2(cnt) compares, whatever the kernel's own
# network does (its bitonic network pads to a power of two and does
# log^2 steps: that is its cost, not the function's)
CALL_STATS_OPS_PER_COMPARE = 3 * 3
# int32 operations an element of the sort's keys (two range tests, the
# valid select, the add of n), and an item of the run pass's merge (the
# compare, the select, the store, the advance)
KEY_OPS = 4
RUN_OPS = 4
# the latency of a dependent float32 add on the H100 (cycles), at the 1.98
# GHz boost clock: a cluster's NM sum is a chain of cnt such adds in array
# order, which no kernel shortens (the plain version's arithmetic)
FADD_LATENCY_CYCLES = 4
SM_CLOCK_HZ = 1.98e9


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


T_START = time.perf_counter()


def header(*parts, **kw) -> None:
    """A phase's header line, with the seconds since the script started."""
    print(*parts, f"(at {time.perf_counter() - T_START:.1f} s)", **kw)


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

    held = []     # the timed call's result is the one held (3.8 s a call on the H100)
    plain_ms = cuda_ms(lambda: held.append(edit_distance_batch_plain(*inputs)), 1)
    plain = held[0]
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


# -- phase 2d: the combine greedy's kernels -----------------------------------

def greedy_err(got: dict, want: dict, keys, what: str) -> int:
    """max |kernel - plain| over `keys` of two greedy results (numpy);
    fails unless they are equal, bit for bit."""
    err = 0
    for k in keys:
        a, b = np.asarray(got[k], dtype=np.int64), np.asarray(want[k], dtype=np.int64)
        if a.shape != b.shape:
            fail(f"{what}: {k} is {a.shape} on the card, {b.shape} in the plain version")
        err = max(err, int(np.abs(a - b).max()) if a.size else 0)
        if not np.array_equal(a, b):
            fail(f"{what}: {k} differs from the plain version (max err {err})")
    return err


def check_greedy_kernels() -> int:
    """Phase 2d: the grid kernel on every payload of
    sim.greedy_task_payloads and the flush kernel on every case of
    sim.greedy_flush_payloads and sim.greedy_flush_wide_payloads (its
    state in global scratch) against the plain versions on CPU copies of
    the same inputs, bit for bit in assign, seg_flags and flags; one launch
    a payload. Returns the max |kernel - plain|."""
    from sniffles_tpu_torch.ops import combine_greedy as cg
    from sniffles_tpu_torch.sim import (greedy_flush_payloads, greedy_flush_wide_payloads,
                                        greedy_task_payloads)
    err, t0 = 0, time.perf_counter()
    tasks = greedy_task_payloads()
    flushes = greedy_flush_payloads() + greedy_flush_wide_payloads()
    cg.reset_counts()
    for label, payload, meta in tasks:
        got = cg.run_combine_greedy_task(payload, meta, "cuda")
        err = max(err, greedy_err(got, cg.run_combine_greedy_task(payload, meta, "cpu"),
                                  ("assign", "seg_flags"), f"grid greedy, {label} {meta}"))
    for j, (payload, meta) in enumerate(flushes):
        got = cg.run_combine_greedy(payload, meta, "cuda")
        err = max(err, greedy_err(got, cg.run_combine_greedy(payload, meta, "cpu"),
                                  ("assign", "flags"), f"flush greedy, case {j}"))
    if cg.COUNTS["launches"] != len(tasks) + len(flushes):
        fail(f"the greedy kernels launched {cg.COUNTS} for {len(tasks)} grid and "
             f"{len(flushes)} flush payloads")
    print(f"    {len(tasks)} grid payloads (fuzz, ties, thresholds, ED misses, a width-1 "
          f"table, overflow, one row of 2,048, 16,384 rows of one) and {len(flushes)} flush "
          f"payloads (the last 2 past a block's shared memory): each == plain (bit-exact), "
          f"one launch each ({cg.COUNTS}); {time.perf_counter() - t0:.1f} s", flush=True)
    return err


def hold_greedy_dispatches(kept, what) -> int:
    """Every kept whole-task greedy dispatch (its payload and the result
    the card gave; tools/time_combine_greedy.captured_dispatches) against
    the plain version on the CPU, bit for bit. Returns the max |kernel -
    plain|."""
    from sniffles_tpu_torch.ops import combine_greedy as cg
    err = 0
    for j, d in enumerate(kept):
        want = cg.run_combine_greedy_task(d["payload"], d["meta"], "cpu")
        err = max(err, greedy_err(d["result"], want, ("assign", "seg_flags"),
                                  f"{what}, greedy dispatch {j}"))
    return err


def check_greedy_counters(c, what) -> str:
    """A run's service or daemon counters: at least one launch of the
    greedy kernel wherever the run made a greedy dispatch. Returns them
    as text."""
    dispatches, launches = c.get("combine_greedy_dispatches", 0), c.get("kernel_combine_greedy")
    if dispatches >= 1 and (launches or 0) < 1:
        fail(f"{what}: {dispatches} greedy dispatches, {launches} greedy kernel launches")
    return f"greedy dispatches {dispatches}, greedy kernel launches {launches}"


def time_greedy_kernel(kept) -> dict:
    """Phase 5's greedy: the kernel (the wrapper's one launch, CUDA events,
    the card asleep ahead of the start) and the plain version on the card
    (the torch loop on the same CUDA tensors) on the main path's largest
    dispatch (the most candidates), each == the CPU's, and the bound
    (tools/time_combine_greedy.bound: the live candidates, the ED entries
    the steps read and the outputs at HBM_BYTES_PER_S, against the live
    slots' probes)."""
    from sniffles_tpu_torch.ops import combine_greedy as cg
    from sniffles_tpu_torch.tools import time_combine_greedy as tool
    d = max(kept, key=lambda d: int(np.asarray(d["payload"]["counts"]).sum()))
    row, b = tool.dispatch_row(d), tool.bound(d)
    args, kw, _ = tool.device_inputs(cg, d)
    want = cg.run_combine_greedy_task(d["payload"], d["meta"], "cpu")
    err, launches = 0, cg.COUNTS["launches"]
    for label, fn in (("kernel", cg._greedy_grid_loop), ("plain", cg.greedy_grid_plain)):
        assign, segflags = (t.cpu().numpy() for t in fn(*args, **kw))
        err = max(err, greedy_err({"assign": assign[:row["S"], :row["L"]],
                                   "seg_flags": segflags[:row["S"]]}, want,
                                  ("assign", "seg_flags"), f"phase 5 greedy ({label})"))
    if cg.COUNTS["launches"] != launches + 1:
        fail(f"phase 5 greedy: the kernel and the plain version counted "
             f"{cg.COUNTS['launches'] - launches} launches, not 1")
    kernel = tool.timed(lambda: cg._greedy_grid_loop(*args, **kw), sleep=True, profiled=False)
    plain = tool.timed(lambda: cg.greedy_grid_plain(*args, **kw), sleep=False)
    print(f"  greedy, combine256's largest dispatch: S {row['S']} (Sp {row['Sp']}), L "
          f"{row['L']} (Lp {row['Lp']}), {row['candidates']} candidates, {row['max_count']} "
          f"steps, ED width {row['ed_width']}, limit > 0 {row['limit_on']}: kernel "
          f"{kernel['ms']:.4f} ms (one launch, the wrapper's count; host "
          f"{kernel['host_ms']:.3f} ms), plain (the torch loop on the card) {plain['ms']:.2f} ms "
          f"({plain['launches']:g} launches by torch.profiler, host {plain['host_ms']:.2f} ms); "
          f"== plain (bit-exact); bound {b['bound_ms']:.6f} ms ({b['bound_by']}: "
          f"{b['bytes']} bytes {b['bytes_ms']:.6f} ms, {b['probes']} probes "
          f"{b['ops_ms']:.6f} ms), {b['bound_ms'] / kernel['ms']:.3%} of it; a chain of "
          f"{row['max_count']} dependent steps, {1e3 * kernel['ms'] / max(row['max_count'], 1):.3f}"
          f" us a step", flush=True)
    return {"ms": kernel["ms"], "plain_ms": plain["ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "max_abs_err": err}


# -- phase 2e: the clustering's segmented sorts ------------------------------

@contextlib.contextmanager
def captured_sorts():
    """Every seg_sort, gather_columns and stage-predicate call of the block
    (the callers look the wrappers up at each call) as host copies of its
    inputs and result: ("seg_sort", (seg_start, k1, k2, base, alone), perm),
    ("gather", (order, columns), out) and (the predicate's name, its
    arguments, its result)."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    seg_sort, gather = cso.seg_sort, cso.gather_columns
    marks = {k: getattr(cso, k) for k in ("seed_marks", "resplit_marks", "fold_marks")}
    kept = []

    def cpu(t):
        if isinstance(t, dict):
            return {k: cpu(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(cpu(v) for v in t)
        return t.cpu() if isinstance(t, torch.Tensor) else t

    def keep_marks(name):
        def run(*args):
            out = marks[name](*args)
            kept.append((name, tuple(cpu(a) for a in args), cpu(out)))
            return out
        return run

    def keep_sort(seg_start, k1, k2=None, base=None, alone=None):
        perm = seg_sort(seg_start, k1, k2, base, alone)
        kept.append(("seg_sort", tuple(cpu(t) for t in (seg_start, k1, k2, base, alone)),
                     perm.cpu()))
        return perm

    def keep_gather(order, columns):
        out = gather(order, columns)
        kept.append(("gather", (order.cpu(), {k: cpu(v) for k, v in columns.items()}),
                     {k: cpu(v) for k, v in out.items()}))
        return out

    cso.seg_sort, cso.gather_columns = keep_sort, keep_gather
    for name in marks:
        setattr(cso, name, keep_marks(name))
    try:
        yield kept
    finally:
        cso.seg_sort, cso.gather_columns = seg_sort, gather
        for name, fn in marks.items():
            setattr(cso, name, fn)


def hold_sorts(kept, what) -> tuple:
    """Each kept call's result == its plain version on the CPU copies of its
    inputs, bit for bit. Returns (seg_sort calls, gather calls, predicate
    calls, the largest segment a seg_sort held)."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    sorts = gathers = marks = largest = 0
    for kind, args, got in kept:
        if kind.endswith("_marks"):
            want = getattr(cso, kind + "_plain")(*args)
            pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
            if any(g.dtype != w.dtype or not torch.equal(g, w) for g, w in pairs):
                fail(f"{what}: {kind} call {marks} differs from its plain version")
            marks += 1
        elif kind == "seg_sort":
            want = cso.seg_sort_plain(*args)
            if got.dtype != torch.int64 or not torch.equal(got, want):
                fail(f"{what}: seg_sort call {sorts} differs from its plain version")
            heads = np.flatnonzero(args[0].numpy() | (np.arange(args[0].shape[0]) == 0))
            if heads.size:
                largest = max(largest, int(np.diff(np.r_[heads, args[0].shape[0]]).max()))
            sorts += 1
        else:
            want = cso.gather_columns_plain(*args)
            if set(got) != set(want) or any(
                    isinstance(v, torch.Tensor) and not torch.equal(got[k], v)
                    for k, v in want.items()):
                fail(f"{what}: gather_columns call {gathers} differs from its plain version")
            gathers += 1
    return sorts, gathers, marks, largest


def seg_sort_population(kind):
    """sim.seg_sort_batch's population as its callers build one: segment
    starts, the keys masked to INT32_MAX where not valid, the invalid
    elements."""
    from sniffles_tpu_torch.ops.clustering import _starts
    from sniffles_tpu_torch.sim import seg_sort_batch, seg_sort_width
    b = seg_sort_batch(kind, seg_sort_width(kind), 5)
    valid = torch.from_numpy(b["valid"])
    big = 2 ** 31 - 1
    return (_starts(torch.from_numpy(b["seg_id"])),
            torch.where(valid, torch.from_numpy(b["k1"]), big),
            torch.where(valid, torch.from_numpy(b["k2"]), big), ~valid)


def engine_batch(n, chain=False):
    """The engine's signatures at n (phase 10d's synthetic batch, or the
    tiled 36-link chain) on the card."""
    from sniffles_tpu_torch.signatures import synthetic_batch
    from sniffles_tpu_torch.sim import relax_chain_batch
    sig = (relax_chain_batch(n) if chain else synthetic_batch(
        n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict())
    return {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in sig.items()}


def check_cluster_sorts(meta):
    """Phase 2e (see the module's docstring)."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso, clustering as tc
    from sniffles_tpu_torch.sim import SEG_SORT_KINDS, edge_call_batches, fuzz_call_batch
    t0 = time.perf_counter()
    with captured_sorts() as kept:
        for kind in SEG_SORT_KINDS:
            seg_start, k1, k2, invalid = (t.cuda() for t in seg_sort_population(kind))
            base = torch.randperm(k1.shape[0], generator=torch.Generator().manual_seed(1)).cuda()
            inverse = torch.argsort(base)
            cso.seg_sort(seg_start, k1, k2)
            cso.seg_sort(seg_start, k1)
            cso.seg_sort(seg_start, k1, k2, alone=invalid)
            # every segment of one element alone too ("tiles": as a tile's last
            # and first elements)
            seg_id = torch.cumsum(seg_start.to(torch.int64), 0) - 1
            single = torch.bincount(seg_id)[seg_id] == 1
            cso.seg_sort(seg_start, k1, k2, alone=invalid | single)
            cso.seg_sort(seg_start, k1[inverse], k2[inverse], base, invalid[inverse])
            cso.seg_sort(seg_start, k1[inverse], k2[inverse], base, (invalid | single)[inverse])
        sorts, _, _, largest = hold_sorts(kept, "sim.seg_sort_batch")
    print(f"    sim.seg_sort_batch's populations {', '.join(SEG_SORT_KINDS)} (each with two "
          f"keys, one, the padding alone, every segment of one alone too, and through a base "
          f"permutation with both): {sorts} seg_sort calls == plain, "
          f"segments up to {largest} (tiers {cso.TIERS})", flush=True)
    callers = {f"fuzz n=32768 seed {seed}": fuzz_call_batch(seed, 32768) for seed in (1, 2)}
    callers.update((f"edge {k}", v) for k, v in edge_call_batches().items())
    for what, packed in callers.items():
        with captured_sorts() as kept:
            tc.call_task_packed(torch.as_tensor(packed).cuda(), **meta)
        sorts, gathers, marks, largest = hold_sorts(kept, f"call_task_packed ({what})")
        if (sorts, gathers, marks) != (5, 5, 2):
            fail(f"call_task_packed ({what}): {sorts} seg_sort, {gathers} gather and {marks} "
                 f"predicate calls, not 5, 5 and 2")
        print(f"    call_task_packed ({what}): its {sorts} seg_sort, {gathers} gather and {marks} "
              f"predicate calls == plain, segments up to {largest}", flush=True)
    for what, chain in (("the engine's 2^21 batch", False), ("chain2^21", True)):
        sig = engine_batch(1 << 21, chain)
        with captured_sorts() as kept:
            tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                  cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                  cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
        sorts, gathers, marks, largest = hold_sorts(kept, what)
        if (sorts, gathers, marks) != (2, 2, 2):
            fail(f"{what}: {sorts} seg_sort, {gathers} gather and {marks} predicate calls, "
                 f"not 2 each")
        print(f"    {what} (sort and seed, the relaxation, the resplit): {sorts} seg_sort, "
              f"{gathers} gather and {marks} predicate calls == plain, segments up to {largest}",
              flush=True)
    print(f"    phase 2e took {time.perf_counter() - t0:.1f} s", flush=True)


def check_sort_launches(launches, tasks, what):
    """A call task's five sorts and gathers (sort and seed, the fold, the
    resplit's child ids, the two tallies), one launch of the run pass and
    one of the tiers a sort, one gather launch a gather, and two predicates
    (the seeds, the fold), one launch each."""
    want = {"seg_sort": 5 * tasks, "gather_columns": 5 * tasks, "marks": 2 * tasks,
            "seg_runs": 5 * tasks, "seg_tiers": 5 * tasks, "seg_gather": 5 * tasks,
            "seg_marks": 2 * tasks}
    if launches != want:
        fail(f"{what}: the segmented sorts launched {launches}, want {want} for {tasks} tasks")


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
    writes), heads and counts == its plain version's, its candidate cuts in
    shared memory (the default) and in its global scratch (a threshold of
    0); then one sweep on the card from `state` (both kernels), held
    against the plain version (hold_against_plain). Returns the max
    |kernel - plain| over the float arrays."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = inputs["seed_type"].shape[0]
    nseeds = int(inputs["nseeds"][0])
    plain_cut, plain_heads, plain_counts = tc.sweep_cuts_plain(
        {k: v.cpu() for k, v in inputs.items()}, {k: v.cpu() for k, v in state.items()},
        **cuts_params(meta))
    plain_cut = plain_cut[:nseeds]
    for smem in (-1, 0):
        cut, heads, cut_counts = tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta),
                                                      smem_cands=smem)
        cut = cut.cpu()[:nseeds]
        heads = heads.cpu()[:int(plain_counts[2])].tolist()
        if (not torch.equal(cut, plain_cut) or heads != plain_heads.tolist()
                or not torch.equal(cut_counts.cpu(), plain_counts)):
            fail(f"sweep_cuts kernel ({'global scratch' if smem == 0 else 'shared memory'}) "
                 f"differs from its plain version on {label}: counts {cut_counts.tolist()} "
                 f"plain {plain_counts.tolist()}, {int((cut != plain_cut).sum())} cut flags differ")
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
    that changed, written once; nseeds and the head mask read and the
    iteration count written. A sweep that merges nothing reads 28 bytes a
    seed."""
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
            + 8 * picks + 4 * changed + 12)


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


# the XLA work each kernel of csrc/cluster_sorts.cu takes the place of: the
# resplit's lexsort of _cluster_body (where the run pass and the tiers are
# timed, beside one torch.sort of the same permutation), _apply_order (the
# gather, timed on sort and seed's), and the resplit's split predicate
# (where seg_marks is timed)
SORT_REPLACES = {"seg_runs": "sniffles_tpu/ops/clustering.py:775",
                 "seg_tiers": "sniffles_tpu/ops/clustering.py:775",
                 "seg_gather": "sniffles_tpu/ops/clustering.py:57",
                 "seg_marks": "sniffles_tpu/ops/clustering.py:788"}


def time_cluster_sorts() -> dict:
    """Phase 5's rows of the segmented sorts at the engine step's 2^21
    signatures (tools/time_cluster_sorts.kernel_rows: the resplit's sort and
    sort and seed's, sort and seed's gather (a random permutation) and the resplit's (a
    local one), and a call task's fold at dense3's width; each held against
    its plain version first): {kernel: row}."""
    from sniffles_tpu_torch.tools.time_cluster_sorts import TASK_N, kernel_rows
    rows = kernel_rows(1 << 21)
    where = {"seg_sort (sort and seed)": "at 2^21, the engine's sort and seed",
             "gather_columns (sort and seed)": "at 2^21, the engine's sort and seed",
             "gather_columns (resplit)": "at 2^21, the engine's resplit",
             "gather_columns (a call task)": f"at n = {TASK_N}, a call task's fold"}
    for name, r in rows.pop("wrappers").items():
        lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
        stage = where.get(name, "at 2^21, the engine's resplit")
        if "columns" in r:   # a gather
            print(f"  {name} ({stage}, {r['columns']} columns): {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, index_select a column {lib}, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bytes']} bytes at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {100 * r['bound_ms'] / r['ms']:.1f} % "
                  f"of it", flush=True)
            continue
        split = "".join(f", {k} {v:.4f} ms" for k, v in r.get("split", {}).items())
        runs = ""
        if "split" in r:   # a sort: (run pass, tiers) bytes
            runs_bound = r["bytes"][0] / HBM_BYTES_PER_S * 1e3
            runs = (f"; seg_runs with its memset against the run pass's bound "
                    f"{runs_bound:.5f} ms: {100 * runs_bound / r['split']['seg_runs']:.1f} %")
        print(f"  {name} ({stage}): the wrapper {r['ms']:.4f} ms{split}, "
              f"plain {r['plain_ms']:.4f} ms, one torch.sort {lib}, bound "
              f"{r['bound_ms']:.5f} ms ({sum(np.atleast_1d(r['bytes']))} bytes at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {100 * r['bound_ms'] / r['ms']:.1f} % of it"
              f"{runs}", flush=True)
    for name, r in rows.items():
        print(f"  {name}: {r['ms']:.4f} ms (CUDA events) against a bound of "
              f"{r['bound_ms']:.5f} ms, {100 * r['bound_ms'] / r['ms']:.1f} % of it", flush=True)
    return rows


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
    the float state, the CLI's input arguments, every sweep launch kept
    (inputs, state before and after, counts), the device path's wall)."""
    from sniffles_tpu_torch.ops import call_stats as cs, clustering as tc
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
    cs.reset_counts()
    tc.merge_sweep, tc.call_task_packed = keep_every, timed_step
    dev_stages, host_stages, stats_kept = {}, {}, []
    try:
        with stage_times(dev_stages), kept_call_stats(stats_kept):
            dev_wall, dev_counters = run_cli([*args, "--vcf", os.path.join(tmp, "device.vcf")],
                                             [], os.path.join(tmp, "k1.json"), "call_sample")
    finally:
        tc.merge_sweep, tc.call_task_packed = sweep, task_step
    launches = dict(tc.COUNTS, call_stats=cs.COUNTS["launches"])
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
    # the decode of every task but the first runs on the decode-ahead
    # thread, beside the other stages of the task before it; "rest" is the
    # wall less the other stages
    for label, stages, wall in (("device", dev_stages, dev_wall), ("host", host_stages,
                                                                 host_wall)):
        inline = {k: v for k, v in stages.items() if k != "decode+leads"}
        print(f"    {label} path stages (s): decode+leads {stages['decode+leads']:.3f} "
              f"(mostly on the decode-ahead thread, overlapped), " + ", ".join(
                  f"{k} {v:.3f}" for k, v in inline.items()) +
              f", rest {wall - sum(inline.values()):.3f}", flush=True)
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
    calls, stats_err = hold_kept_call_stats(stats_kept, "dense3's call tasks (unfused)")
    if calls != tasks or any(fused for _, _, fused in stats_kept):
        fail(f"call_sample: {calls} call-statistics calls for {tasks} device tasks")
    print(f"    [b] the call statistics of the {calls} call tasks (the folded children "
          f"through call_task_packed, unfused; widths "
          f"{[c['pos'].shape[0] for c, _, _ in stats_kept]}): kernels == plain version on "
          f"CPU copies on every key and slot, integer keys == plain version on the card; "
          f"float32 keys differ from the card's plain version by at most {stats_err:.3g}",
          flush=True)
    largest = max(kept, key=lambda launch: int(launch[0]["nseeds"][0]))
    return largest[:2], launches, err, args, kept, dev_wall, dev_stages


# -- phases 3b and 4b: the worker pool in a child process --------------------

# the wall splits of the child processes (wall_split), by their `what`
SPLITS = {}


def run_child(cli_args, counters_path, what, keep_path=None, env_extra=None):
    """The port's CLI in a child process: `python -m sniffles_tpu_torch`,
    or, with keep_path, this script's --cli-child, which runs the CLI the
    same way and keeps every merge-sweep launch; env_extra is added to
    its environment. Each line of its log is stamped on arrival (the
    child runs unbuffered), and its wall split goes into SPLITS[what]. Its
    log is printed only when the run fails. Returns (the wall from the
    start of the process to its end, its counters, the lines of its log
    that give the time of its analysis and of the device service's
    warmup)."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["SNIFFLES_TPU_COUNTERS_JSON"] = counters_path
    env["PYTHONUNBUFFERED"] = "1"
    env.pop("SNIFFLES_TPU_FORCE_CPU", None)
    env.update(env_extra or {})
    if os.path.exists(counters_path):
        os.unlink(counters_path)
    cmd = ([sys.executable, os.path.abspath(__file__), "--cli-child", keep_path] if keep_path
           else [sys.executable, "-m", "sniffles_tpu_torch"])
    cmd += [*cli_args, "--allow-overwrite"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env)
    watchdog = threading.Timer(400, proc.kill)
    watchdog.start()
    stamped = [(time.perf_counter(), line) for line in proc.stdout]
    rc = proc.wait()
    wall = time.perf_counter() - t0
    watchdog.cancel()
    text = "".join(line for _, line in stamped)
    if rc != 0:
        print(text[-6000:])
        fail(f"{what} in a child process exited {rc}")
    SPLITS[what] = wall_split(stamped, t0, t0 + wall)
    timing = [line.rstrip("\n").split(": ", 1)[-1] for _, line in stamped
              if "Analysis took" in line or "device warmup on" in line]
    with open(counters_path) as f:
        return wall, json.load(f), "; ".join(timing)


def wall_split(stamped, t0, t_end):
    """A CLI child's wall in parts, from the times its log lines arrived
    (seconds; the CLI itself has no timer): the interpreter's start and
    the imports, to "Running"; the configuration, the device check and
    the input's index check, to "Opening for writing"; the planning and
    the pool's start, to the start of the analysis ("Analysis took X s"
    less X); the analysis, of which the service's warmup ends at its
    "device warmup on" line (None when the run had no service of its
    own); the emission, to "called SVs to"; and the exit. None for a run
    that logged no analysis."""
    def at(marker):
        return next(((t, line) for t, line in stamped if marker in line), (None, ""))
    t_run, t_open = at("Running ")[0], at("Opening for writing")[0]
    t_took, took = at("Analysis took")
    t_warm, t_wrote = at("device warmup on")[0], at("called SVs to")[0]
    if None in (t_run, t_open, t_took, t_wrote):
        return None
    analysis = float(took.split("Analysis took ")[1].split("s")[0])
    return {"start, imports": t_run - t0,
            "configuration, device and index checks": t_open - t_run,
            "planning, pool start": t_took - analysis - t_open,
            "analysis": analysis,
            "  of which the service warmup": (None if t_warm is None
                                              else t_warm - (t_took - analysis)),
            "emission": t_wrote - t_took,
            "exit": t_end - t_wrote,
            "wall": t_end - t0}


def cli_child(keep_path, cli_args):
    """Phase 4b's child: the CLI as `python -m sniffles_tpu_torch ARGS`
    runs it, in this process, which has no CUDA context of its own; every
    merge-sweep launch of its device service is kept on the host (inputs,
    state before and after, counts; [k, n] tensors for a fused dispatch)
    and saved to keep_path when the CLI ends, every edit-distance launch
    (inputs, output) to KEEP.ed. The workers it forks never launch a
    kernel."""
    import runpy
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.ops import edit_distance_batch as ted
    from sniffles_tpu_torch.parallel import device_call
    sweep, kept = tc.merge_sweep, []
    ed, eds = ted.edit_distance_batch_device, []
    mesh_step, payloads = device_call.run_mesh_assign, []

    def keep_every(inputs, state, **params):
        before = {k: v.cpu() for k, v in state.items()}
        counts = sweep(inputs, state, **params)
        kept.append(({k: v.cpu() for k, v in inputs.items()}, before,
                     {k: v.cpu() for k, v in state.items()}, counts.cpu()))
        return counts

    def keep_ed(*inputs):
        out = ed(*inputs)
        if inputs[0].is_cuda:
            eds.append(([x.cpu() for x in inputs], out.cpu()))
        return out

    def keep_payload(payload, meta):
        payloads.append((payload, meta))
        return mesh_step(payload, meta)

    tc.merge_sweep, device_call.run_mesh_assign = keep_every, keep_payload
    ted.edit_distance_batch_device = keep_ed
    sys.argv = ["sniffles_tpu_torch", *cli_args]
    try:
        runpy.run_module("sniffles_tpu_torch", run_name="__main__", alter_sys=True)
    finally:
        torch.save(kept, keep_path)
        torch.save(eds, keep_path + ".ed")
        with open(keep_path + ".mesh", "wb") as f:
            pickle.dump(payloads, f)


def hold_launch(inputs, before, after, counts, meta, label):
    """A kept sweep launch, one task or a fused stack, against the plain
    version: each task's state and counts (hold_against_plain); a zero
    pad slot's state untouched. Returns the max |kernel - plain|."""
    from sniffles_tpu_torch.ops import clustering as tc
    if inputs["seed_type"].dim() == 1:
        return hold_against_plain(inputs, before, after, counts.tolist(), meta, label)
    err = 0.0
    for t in range(inputs["seed_type"].shape[0]):
        row_in, row_before, row_after = (tc._task_row(d, t) for d in (inputs, before, after))
        if int(row_in["nseeds"][0]) == 0:
            if any(not torch.equal(row_after[k], row_before[k]) for k in tc.SWEEP_STATE):
                fail(f"the sweep changed the state of the zero pad slot {t} of {label}")
            continue
        err = max(err, hold_against_plain(row_in, row_before, row_after, counts[t].tolist(),
                                          meta, f"{label}, slot {t}"))
    return err


def check_consumed(c, what):
    """A device run's counters: every child's statistics consumed, no
    route but BND's."""
    if c.get("engine_consumed", -1) != c.get("children_total", -2):
        fail(f"{what}: device statistics were not consumed by every child")
    routes = {k: c.get(k, 0) for k in ("fb_resplit", "fb_multi_fragment",
                                        "fb_support_collision", "fb_capacity")}
    if any(routes.values()):
        fail(f"{what}: exactness routes taken {routes}")


def check_threaded_counters(c, what, tasks=DENSE_CONTIGS):
    """A threaded run's counters: check_consumed, one device task a
    contig, and one launch of each sweep kernel a dispatch (a solo
    request, or a fused batch) plus one for the warmup's step on a zero
    batch. Returns the launches."""
    check_consumed(c, what)
    launches = {"launches": c["kernel_merge_sweep"], "sweep_cuts": c["kernel_sweep_cuts"]}
    dispatches = (c["service_requests"] - c["service_fusion_fused_requests"]
                  + c["service_fusion_batches"])
    if c.get("device_tasks", 0) != tasks or not (
            launches["launches"] == launches["sweep_cuts"] == dispatches + 1):
        fail(f"{what}: launches {launches}, {dispatches} dispatches, "
             f"{c.get('device_tasks')} device tasks")
    if c.get("kernel_call_stats", 0) < tasks:
        fail(f"{what}: {c.get('kernel_call_stats')} call-statistics launches for {tasks} tasks")
    return launches, dispatches


def run_dense_threaded(tmp, args, meta, threads0_wall):
    """Phase 4b: the dense leg with the default command line (4 workers)
    in a child process as users run it, for the records, the counters and
    the wall; again in a child that keeps every sweep launch of its parent
    (copied to the host before and after each launch), each held against
    the plain version; and with --threads 0 for the wall beside it.
    Returns (the parent's kernel launches in the first child, the max
    |kernel - plain|)."""
    reference = vcf_parts(os.path.join(tmp, "device.vcf"))
    if vcf_parts(os.path.join(tmp, "host.vcf")) != reference:
        fail("call_sample: phase 4's host VCF differs from its device VCF")
    t4 = os.path.join(tmp, "threads4.vcf")
    wall4, c4, timing4 = run_child([*args, "--vcf", t4], os.path.join(tmp, "k3.json"),
                                   "call_sample (default --threads)")
    t0 = os.path.join(tmp, "threads0.vcf")
    wall0, _, timing0 = run_child([*args, "--vcf", t0, "--threads", "0"],
                                  os.path.join(tmp, "k4.json"), "call_sample --threads 0")
    keep, tk = os.path.join(tmp, "kept.pt"), os.path.join(tmp, "threads4_kept.vcf")
    wallk, ck, _ = run_child([*args, "--vcf", tk], os.path.join(tmp, "k5.json"),
                             "call_sample (default --threads), every sweep kept",
                             keep_path=keep)
    service = {k: v for k, v in c4.items() if k.startswith(("service_", "kernel_"))}
    print(f"    threads 4 (default) {wall4:.2f} s ({timing4}), threads 0 {wall0:.2f} s "
          f"({timing0}), each a child process from start to end (the in-process device "
          f"path of phase 4: {threads0_wall:.2f} s)", flush=True)
    print(f"    service and parent {json.dumps(service, sort_keys=True)}", flush=True)
    print(f"    engine counters (threads 4) "
          + json.dumps({k: v for k, v in c4.items() if k not in service}, sort_keys=True))
    for vcf, what in ((t4, "--threads 4"), (t0, "--threads 0"),
                      (tk, "--threads 4 with every sweep kept")):
        if vcf_parts(vcf) != reference:
            fail(f"call_sample {what} in a child process: VCF differs from phase 4's "
                 f"device and host VCFs")
    launches, dispatches = check_threaded_counters(c4, "call_sample --threads 4")
    kept_launches, _ = check_threaded_counters(ck, "call_sample --threads 4, sweeps kept")
    kept = torch.load(keep)
    if kept_launches["launches"] != len(kept):
        fail(f"the child that keeps every sweep launched {kept_launches}, kept {len(kept)}")
    fused = sum(1 for launch in kept if launch[0]["seed_type"].dim() == 2)
    print(f"    {c4['children_total']} of {c4['children_total']} children consumed; "
          f"{launches['launches']} launches of each sweep kernel in the parent: "
          f"{dispatches} dispatches ({service['service_fusion_batches']} fused) and the "
          f"warmup's; threaded VCFs == phase 4's device and host VCFs", flush=True)
    print(f"    the child that keeps every sweep: {wallk:.2f} s (its host copies "
          f"included), {len(kept)} launches kept ({fused} fused), service "
          + json.dumps({k: v for k, v in ck.items() if k.startswith("service_")},
                       sort_keys=True), flush=True)
    err = 0.0
    for j, (inputs, before, after, counts) in enumerate(kept):
        err = max(err, hold_launch(inputs, before, after, counts, meta,
                                   f"threaded sweep {j} {tuple(inputs['seed_type'].shape)}"))
    return launches, err


# -- phase 2c ---------------------------------------------------------------

def check_batched_sweep(tasks, meta, label):
    """One launch of each kernel over a stack of k tasks of one width
    (`tasks`: [(inputs, state)] on the card): each slice's cut flags (its
    nseeds live ones), counts and 8 state arrays == the single-task
    kernel's and the plain version's, bit for bit; a zero pad slot's state
    untouched. Returns the max |kernel - plain|."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = tasks[0][0]["seed_type"].shape[0]
    inputs = tc._stack_tasks([t[0] for t in tasks])
    state = tc._stack_tasks([t[1] for t in tasks])
    cut, _, cut_counts = tc.launch_sweep_cuts(inputs, state, n, **cuts_params(meta))
    fused = {k: v.clone() for k, v in state.items()}
    before = dict(tc.COUNTS)
    counts = tc.merge_sweep(inputs, fused, **sweep_params(meta))
    torch.cuda.synchronize()
    if tc.COUNTS != {k: v + 1 for k, v in before.items()}:
        fail(f"the batched sweep of {label} launched {tc.COUNTS} after {before}")
    err = 0.0
    for t, (task_inputs, task_state) in enumerate(tasks):
        nseeds = int(task_inputs["nseeds"][0])
        single_cut, _, single_cut_counts = tc.launch_sweep_cuts(task_inputs, task_state, n,
                                                                **cuts_params(meta))
        plain_cut, _, plain_cut_counts = tc.sweep_cuts_plain(
            {k: v.cpu() for k, v in task_inputs.items()},
            {k: v.cpu() for k, v in task_state.items()}, **cuts_params(meta))
        row_cut = cut[t, :nseeds].cpu()
        if (not torch.equal(row_cut, single_cut[:nseeds].cpu())
                or not torch.equal(row_cut, plain_cut[:nseeds])
                or not torch.equal(cut_counts[t].cpu(), single_cut_counts.cpu())
                or not torch.equal(cut_counts[t].cpu(), plain_cut_counts)):
            fail(f"batched sweep_cuts differs on slot {t} of {label}")
        single = {k: v.clone() for k, v in task_state.items()}
        single_counts = tc.merge_sweep(task_inputs, single, **sweep_params(meta))
        row = tc._task_row(fused, t)
        for k in tc.SWEEP_STATE:
            if not torch.equal(row[k].view(torch.int32), single[k].view(torch.int32)):
                fail(f"batched merge_sweep differs from the single-task kernel in {k} on "
                     f"slot {t} of {label}")
        if not torch.equal(counts[t], single_counts):
            fail(f"batched merge_sweep counted {counts[t].tolist()}, the single-task kernel "
                 f"{single_counts.tolist()}, on slot {t} of {label}")
        if nseeds == 0:
            if any(not torch.equal(row[k], task_state[k]) for k in tc.SWEEP_STATE):
                fail(f"the batched sweep changed the zero pad slot {t} of {label}")
            print(f"  {label}, slot {t}: zero pad slot, state untouched, counts "
                  f"{counts[t].tolist()}", flush=True)
            continue
        err = max(err, hold_against_plain(task_inputs, task_state, row, counts[t].tolist(),
                                          meta, f"{label}, slot {t}"))
    print(f"  {label}: one launch of each kernel; every slot == the single-task kernel "
          f"(bit-exact)", flush=True)
    return err


def time_batched_sweep(tasks, meta, label):
    """Device time (device_ms) of the fused sweep of a stack of k tasks,
    both launches, against the k single-task sweeps, 2k launches back to
    back, from the same state."""
    from sniffles_tpu_torch.ops import clustering as tc
    n = tasks[0][0]["seed_type"].shape[0]
    inputs = tc._stack_tasks([t[0] for t in tasks])
    state = tc._stack_tasks([t[1] for t in tasks])
    params = sweep_params(meta)
    fused_ms, _, fused = device_ms(
        lambda st, _: tc.launch_merge_sweep(inputs, st, n, **params), state)
    singles_ms, _, singles = device_ms(
        lambda st, _: [tc.launch_merge_sweep(tc._task_row(inputs, t), tc._task_row(st, t), n,
                                             **params) for t in range(len(tasks))], state)
    if any(not torch.equal(fused[k].view(torch.int32), singles[k].view(torch.int32))
           for k in tc.SWEEP_STATE):
        fail(f"the fused sweep of {label} differs from its single sweeps")
    print(f"  fused sweep of {label} (one launch of each kernel) {fused_ms:.4f} ms; the "
          f"{len(tasks)} single sweeps ({2 * len(tasks)} launches) {singles_ms:.4f} ms",
          flush=True)
    return fused_ms, singles_ms

# -- phase 6 ----------------------------------------------------------------

def check_snfs(paths, what):
    """Every SNF equal to the first in the sense of
    sniffles_tpu_torch.io.snf_compare, apart from the config keys of any
    two runs and SNF_OUTPUT_KEYS. Returns the first's blocks."""
    from sniffles_tpu_torch.io.snf_compare import RUN_KEYS_THAT_DIFFER, snf_differences
    named = {**RUN_KEYS_THAT_DIFFER, **SNF_OUTPUT_KEYS}
    differed = set()
    for path in paths[1:]:
        found, differ, blocks = snf_differences(path, paths[0], named)
        if found:
            fail(f"{what}: {path} differs from {paths[0]} in " + "; ".join(found))
        differed |= differ
    with open(paths[0], "rb") as f:
        count = json.loads(f.readline())["snf_candidate_count"]
    print(f"    {what}: {len(paths)} SNFs equal ({len(blocks)} blocks, {count} candidates; "
          f"config keys that differ, all named: {sorted(differed)})", flush=True)
    return blocks


def records_of(path):
    """The record lines of a VCF, plain or bgzipped."""
    import gzip
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return [line for line in f if not line.startswith("#")]


def run_kept(args, counters_path, what, meta):
    """The CLI in process on the device path (run_cli), with the kernels'
    counts at 0 just before and read just after, and every merge-sweep
    launch kept and held against the plain version (hold_launch). Fails
    unless each sweep kernel was launched, once a sweep. Returns (wall,
    counters, the launches by count name, the max |kernel - plain|)."""
    from sniffles_tpu_torch.ops import clustering as tc
    sweep, kept = tc.merge_sweep, []

    def keep_every(inputs, state, **params):
        before = {k: v.cpu() for k, v in state.items()}
        counts = sweep(inputs, state, **params)
        kept.append(({k: v.cpu() for k, v in inputs.items()}, before,
                     {k: v.cpu() for k, v in state.items()}, counts.cpu()))
        return counts

    tc.reset_counts()
    tc.merge_sweep = keep_every
    try:
        wall, counters = run_cli(args, [], counters_path, what)
    finally:
        tc.merge_sweep = sweep
    launches = dict(tc.COUNTS)
    if not (launches["launches"] == launches["sweep_cuts"] == len(kept) >= 1):
        fail(f"{what}: sweep kernel launches {launches}, {len(kept)} sweeps kept")
    check_consumed(counters, what)
    err = 0.0
    for j, (inputs, before, after, counts) in enumerate(kept):
        err = max(err, hold_launch(inputs, before, after, counts, meta,
                                   f"{what}, sweep {j} n={inputs['seed_type'].shape[-1]}"))
    return wall, counters, launches, err


def hold_ed(kept, what):
    """Every kept edit-distance launch (host copies of its inputs and
    output) held against the plain version on the card, bit for bit; prints
    the launches' shapes and cells. Returns the max |kernel - plain|."""
    from sniffles_tpu_torch.ops import edit_distance_batch as ted
    err, cells = 0, 0
    for j, (inputs, out) in enumerate(kept):
        inputs, out = [x.cuda() for x in inputs], out.cuda()
        plain = ted.edit_distance_batch_plain(*inputs)
        e = int((out - plain).abs().max()) if out.numel() else 0
        err = max(err, e)
        if not torch.equal(out, plain):
            fail(f"{what}: edit-distance launch {j} {tuple(inputs[0].shape)} differs from "
                 f"its plain version (max err {e})")
        cells += int((inputs[2].long() * inputs[3].long()).sum())
    print(f"    {what}: {len(kept)} edit-distance launches, {cells} cells, each == plain "
          f"(bit-exact); a and b {[tuple(x[0][0].shape) for x in kept]}", flush=True)
    return err


def run_ed_held(args, extra, what):
    """The CLI in process (run_cli), with the edit-distance kernel's counts
    at 0 just before and read just after, and every launch kept (a host
    copy of its inputs and output) and then held against the plain
    version on the card, bit for bit. Fails unless every launch was held.
    The greedy kernel's launches over the run (its counts at 0 just before)
    go into the counters returned as kernel_combine_greedy.
    Returns (wall, counters, launches, cells, the max |kernel - plain|)."""
    from sniffles_tpu_torch.ops import combine_greedy as cg
    from sniffles_tpu_torch.ops import edit_distance_batch as ted
    wrapper, kept = ted.edit_distance_batch_device, []

    def keep_every(*inputs):
        out = wrapper(*inputs)
        if inputs[0].is_cuda:
            kept.append(([x.cpu() for x in inputs], out.cpu()))
        return out

    ted.reset_counts()
    cg.reset_counts()
    ted.edit_distance_batch_device = keep_every
    try:
        wall, counters = run_cli(args, extra, args[args.index("--vcf") + 1] + ".json", what)
    finally:
        ted.edit_distance_batch_device = wrapper
    launches, cells = ted.COUNTS["launches"], ted.COUNTS["cells"]
    counters["kernel_combine_greedy"] = cg.COUNTS["launches"]
    if len(kept) != launches:
        fail(f"{what}: {launches} edit-distance launches, {len(kept)} kept")
    return wall, counters, launches, cells, hold_ed(kept, what)


def run_modes(tmp, meta):
    """Phase 6 (see the module's docstring). Returns the max |kernel -
    plain| of the sweeps and that of the edit-distance launches held
    against the plain version."""
    from sniffles_tpu_torch.io.tabix import TabixFile
    from sniffles_tpu_torch.sim import dense_layout, write_dataset
    t_phase = time.perf_counter()
    samples = {}
    for seed in MODES_SEEDS:
        d = os.path.join(tmp, f"s{seed}")
        os.makedirs(d)
        samples[seed] = write_dataset(d, ref_len=MODES_REF_LEN, svs=dense_layout(MODES_REF_LEN),
                                      depth=MODES_DEPTH, read_len=12_000, seed=seed)
    print(f"    wrote {len(samples)} samples of {MODES_REF_LEN // 1_000_000} Mb at depth "
          f"{MODES_DEPTH} in {time.perf_counter() - t_phase:.1f} s", flush=True)
    err = 0.0

    print("  (a) --snf with --vcf", flush=True)
    out = {}
    for seed, (bam, fa) in samples.items():
        base = os.path.join(tmp, f"s{seed}")
        args = ["--input", bam, "--reference", fa, "--sample-id", f"S{seed}"]
        out[seed] = args
        wall, counters, launches, e = run_kept([*args, "--snf", base + ".snf", "--vcf",
                                                base + ".vcf"], base + ".json",
                                               f"--snf sample {seed}", meta)
        err = max(err, e)
        print(f"    sample {seed}, device path: {wall:.2f} s, {len(records_of(base + '.vcf'))} "
              f"records, sweep launches {launches}; every launch == plain (bit-exact)",
              flush=True)
    args, base = out[MODES_SEEDS[0]], os.path.join(tmp, f"s{MODES_SEEDS[0]}")
    host_wall, _ = run_cli([*args, "--snf", base + "_host.snf", "--vcf", base + "_host.vcf"],
                           ["--no-tpu"], base + "_host.json", "--snf (host path)")
    child_wall, c, timing = run_child([*args, "--snf", base + "_child.snf", "--vcf",
                                       base + "_child.vcf"], base + "_child.json",
                                      "--snf (default --threads)")
    child_launches, _ = check_threaded_counters(c, "--snf (default --threads)", tasks=1)
    print(f"    sample {MODES_SEEDS[0]}: host path {host_wall:.2f} s; default --threads in a "
          f"child {child_wall:.2f} s ({timing}), service and parent "
          + json.dumps({k: v for k, v in c.items() if k.startswith(("service_", "kernel_"))},
                       sort_keys=True), flush=True)
    check_snfs([base + ".snf", base + "_host.snf", base + "_child.snf"],
               f"sample {MODES_SEEDS[0]}, device, host and child")
    reference = vcf_parts(base + ".vcf")
    for suffix in ("_host.vcf", "_child.vcf"):
        if vcf_parts(base + suffix) != reference:
            fail(f"--snf: {base + suffix} differs from the device path's VCF")
    print(f"    sample {MODES_SEEDS[0]}: device, host and child VCFs equal "
          f"({len(reference[1])} records)", flush=True)

    print("  (b) combine to .vcf.gz with --dev-population-snf, then --combine-population",
          flush=True)
    snfs = [os.path.join(tmp, f"s{seed}.snf") for seed in MODES_SEEDS]
    cohort = os.path.join(tmp, "cohort")
    ed_err = 0
    for label, extra in (("device", []), ("host", ["--no-tpu"])):
        wall, counters, launches, cells, e = run_ed_held(
            ["--input", *snfs, "--vcf", f"{cohort}_{label}.vcf.gz", "--dev-population-snf",
             f"{cohort}_{label}_pop.snf"], extra, f"combine ({label} path)")
        ed_err = max(ed_err, e)
        print(f"    {label} path {wall:.2f} s; ED kernel launches {launches}, cells {cells}; "
              f"{check_greedy_counters(counters, label)}", flush=True)
    records = records_of(f"{cohort}_device.vcf.gz")
    if records_of(f"{cohort}_host.vcf.gz") != records or len(records) < 100:
        fail(f"combine: device and host .vcf.gz differ, or only {len(records)} records")
    reader = TabixFile(f"{cohort}_device.vcf.gz")
    fetched = [line + "\n" for contig in reader.contigs
               for line in reader.fetch(contig, 0, 2 ** 29)]
    if fetched != records:
        fail("combine: the records fetched through the .tbi index differ from the file's")
    print(f"    device .vcf.gz == host .vcf.gz ({len(records)} records), each contig's "
          f"records back from the index", flush=True)
    check_snfs([f"{cohort}_device_pop.snf", f"{cohort}_host_pop.snf"],
               "population SNFs, device and host")
    for label, extra in (("device", []), ("host", ["--no-tpu"])):
        wall, counters, launches, cells, e = run_ed_held(
            ["--input", *snfs, "--vcf", f"{cohort}_{label}_af.vcf", "--combine-population",
             f"{cohort}_device_pop.snf"], extra, f"--combine-population ({label} path)")
        ed_err = max(ed_err, e)
        print(f"    --combine-population, {label} path {wall:.2f} s; ED kernel launches "
              f"{launches}, cells {cells}; {check_greedy_counters(counters, label)}",
              flush=True)
    annotated = records_of(f"{cohort}_device_af.vcf")
    if records_of(f"{cohort}_host_af.vcf") != annotated or annotated != [
            line for line in annotated if "POPULATION_AF=" in line] or not annotated:
        fail("--combine-population: device and host records differ, or a record has no "
             "POPULATION_AF")
    print(f"    annotated device == host ({len(annotated)} records, POPULATION_AF on each)",
          flush=True)

    print("  (c) --genotype-vcf, plain and gzipped targets", flush=True)
    import gzip
    target = os.path.join(tmp, f"s{MODES_SEEDS[1]}.vcf")
    with open(target, "rb") as f, open(target + ".gz", "wb") as g:
        g.write(gzip.compress(f.read()))
    genotyped = {}
    for kind, path in (("plain", target), ("gz", target + ".gz")):
        gbase = os.path.join(tmp, f"g_{kind}")
        gargs = [*args, "--genotype-vcf", path]
        wall, counters, launches, e = run_kept([*gargs, "--vcf", gbase + ".vcf"],
                                               gbase + ".json", f"--genotype-vcf {kind}", meta)
        err = max(err, e)
        host_wall, _ = run_cli([*gargs, "--vcf", gbase + "_host.vcf"], ["--no-tpu"],
                               gbase + "_host.json", f"--genotype-vcf {kind} (host path)")
        child_wall, c, timing = run_child([*gargs, "--vcf", gbase + "_child.vcf"],
                                          gbase + "_child.json",
                                          f"--genotype-vcf {kind} (default --threads)")
        launched, dispatches = check_threaded_counters(
            c, f"--genotype-vcf {kind} (default --threads)", tasks=1)
        print(f"    {kind}: device path {wall:.2f} s (sweep launches {launches}, each == "
              f"plain), host path {host_wall:.2f} s, child {child_wall:.2f} s ({timing}); "
              f"child's parent: {launched} for {dispatches} dispatch(es) and the warmup, "
              f"service " + json.dumps({k: v for k, v in c.items()
                                        if k.startswith("service_")}, sort_keys=True),
              flush=True)
        for suffix in ("", "_host", "_child"):
            genotyped[f"{kind}{suffix}"] = records_of(gbase + suffix + ".vcf")
    reference = genotyped["plain"]
    hom = sum(1 for line in reference if line.rstrip("\n").split("\t")[9].startswith("1/1"))
    if any(v != reference for v in genotyped.values()) or len(reference) != len(
            records_of(target)):
        fail("--genotype-vcf: the records differ between runs, or not every target came back")
    print(f"    every genotyped VCF equal ({len(reference)} targets, {hom} of them 1/1); "
          f"phase 6 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return err, ed_err


# -- phase 7 ----------------------------------------------------------------

def run_dense_cram(tmp, args, meta, bam_wall, bam_stages):
    """Phases 7a and 7b (see the module's docstring) on phase 4's BAM and
    VCFs; bam_wall and bam_stages are phase 4's device path's. Returns
    the max |kernel - plain| of the CRAM run's sweeps."""
    import zlib
    from sniffles_tpu_torch.io import native
    from sniffles_tpu_torch.io.bam import AlignmentFile
    from sniffles_tpu_torch.sim import write_cram
    bam, fa = args[1], args[3]
    reference = vcf_parts(os.path.join(tmp, "device.vcf"))
    with open(bam, "rb") as f:
        raw = f.read()
    t0 = time.perf_counter()
    inflated = native.bgzf_inflate(raw)
    t_native = time.perf_counter() - t0
    # zlib a BGZF block at a time (gzip.decompress copies the rest of the
    # input at every member: minutes for a BAM of this size)
    t0 = time.perf_counter()
    view = memoryview(raw)
    plain = b"".join(zlib.decompress(view[off:off + bsize], 31)
                     for off, bsize, _ in native.walk_blocks(raw))
    t_zlib = time.perf_counter() - t0
    if inflated != plain:
        fail("the native library's BGZF inflate differs from zlib's in a process with a "
             "CUDA context")
    print(f"    native library {os.path.relpath(native.get_lib()._name)}, loaded beside "
          f"torch and a CUDA context: inflate of the {len(raw) / 1e6:.1f} MB BAM "
          f"({len(plain) / 1e6:.1f} MB) {t_native:.3f} s == zlib's ({t_zlib:.3f} s)",
          flush=True)

    t0 = time.perf_counter()
    cram = write_cram(bam, fa)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    bam_reader = AlignmentFile(bam, require_index=True)
    cram_reader = AlignmentFile(cram, require_index=True, reference_filename=fa)
    n_reads = 0
    for contig in bam_reader.references:
        want = [(r.query_name, r.reference_start, r.reference_end)
                for r in bam_reader.fetch(contig)]
        got = [(r.query_name, r.reference_start, r.reference_end)
               for r in cram_reader.fetch(contig)]
        if got != want:
            fail(f"CRAM: the reads of {contig} through the .crai differ from the BAM's "
                 f"({len(got)} against {len(want)})")
        n_reads += len(got)
    print(f"    wrote the CRAM ({os.path.getsize(cram) / 1e6:.1f} MB) in {t_write:.2f} s; "
          f"its {n_reads} reads, fetched per contig through the .crai, == the BAM's "
          f"(names, positions) in {time.perf_counter() - t0:.2f} s", flush=True)
    cram_args = ["--input", cram, "--reference", fa]
    cram_stages = {}
    with stage_times(cram_stages):
        wall, counters, launches, err = run_kept(
            [*cram_args, "--vcf", os.path.join(tmp, "cram.vcf")], os.path.join(tmp, "k6.json"),
            "CRAM (device path)", meta)
    if vcf_parts(os.path.join(tmp, "cram.vcf")) != reference:
        fail("CRAM: the device path's VCF differs from phase 4's BAM VCF")
    print(f"    CRAM, device path in process: {wall:.2f} s (the BAM's, phase 4: "
          f"{bam_wall:.2f} s); decode+leads {cram_stages['decode+leads']:.3f} s (the BAM's: "
          f"{bam_stages['decode+leads']:.3f} s); sweep launches {launches}, each == plain; "
          f"VCF == phase 4's ({len(reference[1])} records)", flush=True)
    child_vcf = os.path.join(tmp, "cram_child.vcf")
    child_wall, c, timing = run_child([*cram_args, "--vcf", child_vcf],
                                      os.path.join(tmp, "k7.json"), "CRAM (default --threads)")
    child_launches, dispatches = check_threaded_counters(c, "CRAM (default --threads)")
    if vcf_parts(child_vcf) != reference:
        fail("CRAM: the child's VCF differs from phase 4's BAM VCF")
    print(f"    CRAM, default --threads in a child: {child_wall:.2f} s ({timing}); "
          f"{child_launches} for {dispatches} dispatches and the warmup; VCF == phase 4's",
          flush=True)

    nn_stages = {}
    with stage_times(nn_stages):
        nn_wall, nn_counters = run_cli([*args, "--vcf", os.path.join(tmp, "no_native.vcf")],
                                       ["--no-native"], os.path.join(tmp, "k8.json"),
                                       "call_sample --no-native")
    check_consumed(nn_counters, "call_sample --no-native")
    if vcf_parts(os.path.join(tmp, "no_native.vcf")) != reference:
        fail("--no-native: the VCF differs from phase 4's")
    print(f"    --no-native (pure-Python scan), device path in process: {nn_wall:.2f} s, "
          f"decode+leads {nn_stages['decode+leads']:.3f} s; native scan (phase 4): "
          f"{bam_wall:.2f} s, decode+leads {bam_stages['decode+leads']:.3f} s; "
          f"VCF == phase 4's", flush=True)
    return err


def run_locasm(tmp, meta):
    """Phase 7c (see the module's docstring). Returns the max |kernel -
    plain| of its sweeps."""
    from sniffles_tpu_torch import local_asm
    from sniffles_tpu_torch.sim import PlantedSV, random_seq, write_dataset
    rng = np.random.default_rng(LOCASM_SEED)
    svs = [PlantedSV(pos=pos, svtype=kind, svlen=ln,
                     seq=random_seq(rng, ln) if kind == "INS" else "")
           for pos, kind, ln in LOCASM_LAYOUT]
    bam, fa = write_dataset(tmp, ref_len=120_000, depth=18, read_len=10_000,
                            seed=LOCASM_SEED, svs=svs)
    assembly, tally = local_asm.LocalAsm.assembly, []

    def counted(self, config, *a, **kw):
        rescued = assembly(self, config, *a, **kw)
        tally.append((self.sv.svtype, bool(rescued)))
        return rescued

    args = ["--input", bam, "--reference", fa, "--minsupport", "30", "--dev-locasm-do"]
    local_asm.LocalAsm.assembly = counted
    try:
        wall, _, launches, err = run_kept([*args, "--vcf", os.path.join(tmp, "device.vcf")],
                                          os.path.join(tmp, "l1.json"),
                                          "--dev-locasm-do (device path)", meta)
        device_tally, tally[:] = list(tally), []
        host_wall, _ = run_cli([*args, "--vcf", os.path.join(tmp, "host.vcf")], ["--no-tpu"],
                               os.path.join(tmp, "l2.json"), "--dev-locasm-do (host path)")
    finally:
        local_asm.LocalAsm.assembly = assembly
    device = vcf_parts(os.path.join(tmp, "device.vcf"))
    if vcf_parts(os.path.join(tmp, "host.vcf")) != device:
        fail("--dev-locasm-do: the device path's VCF differs from the host path's")
    if device_tally != tally or {kind for kind, _ in tally} != {"INS", "DEL"} or not any(
            ok for _, ok in tally):
        fail(f"--dev-locasm-do: assemblies (svtype, rescued) {device_tally} on the device "
             f"path, {tally} on the host path")
    rescued = sum(1 for line in device[1] if "LASM" in line.split("	")[7])
    print(f"    device path {wall:.2f} s (sweep launches {launches}, each == plain), host "
          f"path {host_wall:.2f} s; {len(tally)} assemblies ({sorted(tally)}), "
          f"{rescued} rescued calls in the VCF; device VCF == host VCF "
          f"({len(device[1])} records)", flush=True)
    if rescued < 1:
        fail("--dev-locasm-do: no call was rescued")
    return err


def run_dev_cache(tmp):
    """Phase 7d (see the module's docstring), on phase 6's sample 31."""
    from sniffles_tpu_torch.pipeline import tasks
    base = os.path.join(tmp, f"s{MODES_SEEDS[0]}")
    args = ["--input", os.path.join(base, "sim.bam"), "--reference",
            os.path.join(base, "ref.fa"), "--dev-cache", "--dev-cache-dir",
            os.path.join(tmp, "cache")]
    load, loads = tasks.Task._load_cached_leadtab, []

    def counted(self):
        loaded = load(self)
        loads.append(loaded)
        return loaded

    tasks.Task._load_cached_leadtab = counted
    walls = {}
    try:
        for label in ("first", "second"):
            walls[label], counters = run_cli([*args, "--vcf", f"{base}_cache_{label}.vcf"], [],
                                             f"{base}_cache_{label}.json",
                                             f"--dev-cache ({label} run)")
            check_consumed(counters, f"--dev-cache ({label} run)")
    finally:
        tasks.Task._load_cached_leadtab = load
    if loads != [False, True]:
        fail(f"--dev-cache: leadtab loads {loads}, not [False, True]")
    reference = records_of(base + ".vcf")
    for label in walls:
        if records_of(f"{base}_cache_{label}.vcf") != reference:
            fail(f"--dev-cache: the {label} run's records differ from phase 6's")
    print(f"    first run {walls['first']:.2f} s (leadtab saved), second {walls['second']:.2f} "
          f"s (leadtab loaded from the cache); both VCFs == phase 6's ({len(reference)} "
          f"records)", flush=True)


# -- phases 8a and 8: the wall split, and the device daemon -----------------

# directories whose blocks end before phase 8 runs their inputs again;
# removed when the script exits
_KEPT_DIRS = []


def kept_dir(prefix):
    """A temporary directory that outlives the block it is made for."""
    d = tempfile.TemporaryDirectory(prefix=prefix)
    _KEPT_DIRS.append(d)
    return contextlib.nullcontext(d.name)


def print_splits(columns):
    """The wall splits (wall_split) of SPLITS[what] for each (title, what)
    of `columns`, side by side, in seconds."""
    splits = [SPLITS.get(what) for _, what in columns]
    if any(split is None for split in splits):
        fail(f"no wall split for {[w for (_, w), x in zip(columns, splits) if x is None]}")
    print("    " + "part (s)".ljust(40) + "".join(title.rjust(16) for title, _ in columns))
    for part in splits[0]:
        print("    " + part.ljust(40) + "".join(
            ("-" if split[part] is None else f"{split[part]:.3f}").rjust(16)
            for split in splits), flush=True)


def daemon_child(keep_path, argv):
    """Phase 8's daemon: device_daemon.main(ARGV), as `python -m
    sniffles_tpu_torch.parallel.device_daemon ARGV` runs it, with every
    merge-sweep launch (inputs, state before and after, counts) and every
    edit-distance launch (inputs, output) of its dispatcher kept on the
    host and saved to keep_path when it ends."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.ops import edit_distance_batch as ted
    from sniffles_tpu_torch.parallel import device_daemon
    sweep, ed, sweeps, eds = tc.merge_sweep, ted.edit_distance_batch_device, [], []

    def keep_sweep(inputs, state, **params):
        before = {k: v.to("cpu", copy=True) for k, v in state.items()}
        counts = sweep(inputs, state, **params)
        sweeps.append(({k: v.cpu() for k, v in inputs.items()}, before,
                       {k: v.cpu() for k, v in state.items()}, counts.cpu()))
        return counts

    def keep_ed(*inputs):
        out = ed(*inputs)
        if inputs[0].is_cuda:
            eds.append(([x.cpu() for x in inputs], out.cpu()))
        return out

    tc.merge_sweep, ted.edit_distance_batch_device = keep_sweep, keep_ed
    code = device_daemon.main(argv)
    torch.save({"merge_sweep": sweeps, "ed_myers": eds}, keep_path)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def start_daemon(sock, args, log_path, keep_path=None):
    """A device daemon in a child process (phase 8's --daemon-child when
    keep_path is given, else `python -m`), with its log in log_path;
    returns it once it answers on its socket."""
    from sniffles_tpu_torch.parallel.device_daemon import answers
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SNIFFLES_TPU_FORCE_CPU", None)
    cmd = ([sys.executable, os.path.abspath(__file__), "--daemon-child", keep_path] if keep_path
           else [sys.executable, "-m", "sniffles_tpu_torch.parallel.device_daemon"])
    with open(log_path, "w") as log:
        proc = subprocess.Popen([*cmd, "--socket", sock, *args], stdout=log,
                                stderr=subprocess.STDOUT, env=env)
    deadline = time.monotonic() + 120
    while not answers(sock):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            with open(log_path) as log:
                print(log.read()[-6000:])
            fail("the device daemon never answered on its socket")
        time.sleep(0.05)
    return proc


def check_daemon_counters(c, what, tasks):
    """A served run's counters (the daemon's stats difference over the
    run): check_consumed, one device task a contig, and one launch of
    each sweep kernel a dispatch in the daemon (no warmup of its own).
    Returns the launches."""
    check_consumed(c, what)
    launches = {"launches": c["kernel_merge_sweep"], "sweep_cuts": c["kernel_sweep_cuts"]}
    dispatches = (c["service_requests"] - c["service_fusion_fused_requests"]
                  + c["service_fusion_batches"])
    if c.get("device_tasks", 0) != tasks or not (
            launches["launches"] == launches["sweep_cuts"] == dispatches):
        fail(f"{what}: launches {launches}, {dispatches} dispatches, "
             f"{c.get('device_tasks')} device tasks")
    if c.get("kernel_call_stats", 0) < tasks:
        fail(f"{what}: {c.get('kernel_call_stats')} call-statistics launches for {tasks} tasks")
    return launches


def run_daemon(tmp, meta, dense, combine, modes):
    """Phase 8 (see the module's docstring). dense: (tmp, args) of phase 4;
    combine: (the SNFs, the device VCF) of phase 3; modes: phase 6's
    directory. Returns (the daemon's kernel launches over the served runs,
    the max |kernel - plain| of its sweeps, that of its edit-distance
    launches)."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.ops.combine_greedy import run_combine_greedy
    from sniffles_tpu_torch.parallel import device_daemon as dd
    from sniffles_tpu_torch.sim import fuzz_call_batch, greedy_flush_payloads
    sock, keep = os.path.join(tmp, "d.sock"), os.path.join(tmp, "daemon_kept.pt")
    t0 = time.perf_counter()
    proc = start_daemon(sock, ["--idle-timeout", "900"], os.path.join(tmp, "daemon.log"), keep)
    try:
        client = dd.DaemonClient(sock)
        if not client.ping(timeout=300):
            fail("the device daemon did not answer its ping")
        with open(os.path.join(tmp, "daemon.log")) as log:
            warm = [line.split(": ", 1)[-1].strip() for line in log if "warmup" in line]
        print(f"    daemon started, its kernels loaded and warm, in "
              f"{time.perf_counter() - t0:.2f} s ({'; '.join(warm)})", flush=True)
        served = {"CUDA_VISIBLE_DEVICES": "", dd.ENV_SOCKET: sock}
        before = dd.daemon_stats(sock)

        dense_tmp, dense_args = dense
        reference = vcf_parts(os.path.join(dense_tmp, "device.vcf"))
        for threads in ("4", "0"):
            what = f"dense3 --threads {threads}, served"
            out = os.path.join(tmp, f"dense_t{threads}.vcf")
            wall, c, _ = run_child([*dense_args, "--vcf", out, "--threads", threads],
                                   out + ".json", what, env_extra=served)
            launches = check_daemon_counters(c, what, DENSE_CONTIGS)
            if vcf_parts(out) != reference:
                fail(f"{what}: VCF differs from phase 4's")
            print(f"    {what}: {wall:.2f} s; the daemon's launches {launches}, service "
                  + json.dumps({k: v for k, v in c.items() if k.startswith("service_")},
                               sort_keys=True) + "; VCF == phase 4's", flush=True)

        what = f"[9e] dense3 --tpu-mesh {MESH_SHARDS}, served"
        out = os.path.join(tmp, "dense_mesh.vcf")
        wall, c, _ = run_child([*dense_args, "--vcf", out, "--tpu-mesh", str(MESH_SHARDS)],
                               out + ".json", what, env_extra=served)
        check_mesh_counters(c, what)
        if vcf_parts(out) != reference:
            fail(f"{what}: VCF differs from phase 4's")
        print(f"    {what}: {wall:.2f} s; the daemon's launches of each sweep kernel "
              f"{c['kernel_merge_sweep']}, {c['kernel_sweep_cuts']} for "
              f"{c['service_requests']} mesh requests; VCF == phase 4's", flush=True)

        snfs, combine_vcf = combine
        what = "combine256 --threads 4, served"
        out = os.path.join(tmp, "combine_t4.vcf")
        wall, c, _ = run_child(["--input", *snfs, "--vcf", out, "--threads", "4"],
                               out + ".json", what, env_extra=served)
        if vcf_parts(out) != vcf_parts(combine_vcf) or c.get("kernel_ed_myers", 0) < 1:
            fail(f"{what}: VCF differs from phase 3's, or no edit-distance launch in the "
                 f"daemon ({c.get('kernel_ed_myers')})")
        print(f"    {what}: {wall:.2f} s; the daemon's edit-distance launches "
              f"{c['kernel_ed_myers']}, {check_greedy_counters(c, what)}; "
              f"VCF == phase 3's", flush=True)

        base = os.path.join(modes, f"s{MODES_SEEDS[0]}")
        args = ["--input", os.path.join(base, "sim.bam"), "--reference",
                os.path.join(base, "ref.fa"), "--sample-id", f"S{MODES_SEEDS[0]}"]
        what = f"sample {MODES_SEEDS[0]} --snf, served"
        out = os.path.join(tmp, "s31")
        wall, c, _ = run_child([*args, "--snf", out + ".snf", "--vcf", out + ".vcf"],
                               out + ".json", what, env_extra=served)
        check_daemon_counters(c, what, 1)
        check_snfs([base + ".snf", out + ".snf"], f"{what}, against phase 6's")
        if vcf_parts(out + ".vcf") != vcf_parts(base + ".vcf"):
            fail(f"{what}: VCF differs from phase 6's")
        what = f"sample {MODES_SEEDS[0]} --genotype-vcf, served"
        target = os.path.join(modes, f"s{MODES_SEEDS[1]}.vcf")
        gwall, c, _ = run_child([*args, "--genotype-vcf", target, "--vcf", out + "_gt.vcf"],
                                out + "_gt.json", what, env_extra=served)
        check_daemon_counters(c, what, 1)
        if records_of(out + "_gt.vcf") != records_of(os.path.join(modes, "g_plain.vcf")):
            fail(f"{what}: records differ from phase 6's")
        print(f"    sample {MODES_SEEDS[0]}: --snf {wall:.2f} s, SNF and VCF == phase 6's; "
              f"force calling {gwall:.2f} s, records == phase 6's", flush=True)

        def served_run(j):
            out = os.path.join(tmp, f"dense_both{j}.vcf")
            return out, run_child([*dense_args, "--vcf", out], out + ".json",
                                  f"dense3 --threads 4, served, client {j} of 2",
                                  env_extra=served)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = list(pool.map(served_run, (1, 2)))
        for j, (out, (wall, c, _)) in enumerate(runs, 1):
            check_consumed(c, f"client {j} of 2")
            if vcf_parts(out) != reference:
                fail(f"dense3, client {j} of 2 served at once: VCF differs from phase 4's")
        print(f"    two dense3 runs served at once: {time.perf_counter() - t1:.2f} s together "
              f"({runs[0][1][0]:.2f} s, {runs[1][1][0]:.2f} s); both VCFs == phase 4's; "
              f"service " + json.dumps({k: v for k, v in runs[1][1][1].items()
                                        if k.startswith("service_")}, sort_keys=True),
              flush=True)

        assign_meta = {k: meta[k] for k in ("cluster_r", "cluster_repeat_h",
                                            "cluster_repeat_h_max", "cluster_merge_bnd",
                                            "cluster_merge_len", "minsvlen", "binsize",
                                            "resplit_binsize")}
        for n, seed in ((32768, 1), (32768, 2), (65536, 5), (512, 3), (512, 4)):
            packed = np.ascontiguousarray(fuzz_call_batch(seed, n)[[0, 1, 2, 8, 4, 5]])
            got = client.cluster_assign(packed, assign_meta)
            want = tc.cluster_assign_packed(torch.from_numpy(packed), **assign_meta).numpy()
            if not np.array_equal(got, want):
                fail(f"cluster_assign on the card differs from its plain version on the CPU "
                     f"(fuzz n={n} seed {seed})")
        cases = greedy_flush_payloads()
        for j, (payload, gmeta) in enumerate(cases):
            got = client.request("combine_greedy", payload, gmeta)
            want = run_combine_greedy(payload, gmeta, "cpu")
            if any(not np.array_equal(got[k], want[k]) for k in ("assign", "flags")):
                fail(f"combine_greedy on the card differs from its plain version on the CPU "
                     f"(case {j})")
        print(f"    cluster_assign on 5 fuzz batches (n = 512-65,536) and combine_greedy on "
              f"{len(cases)} flush payloads (tests/test_combine_greedy_kernel.py's cases), "
              f"on the card through the daemon: each == its plain version on the CPU",
              flush=True)

        after = dd.daemon_stats(sock)
        launches = {k: after[k] - before[k] for k in ("kernel_merge_sweep", "kernel_sweep_cuts",
                                                      "kernel_ed_myers",
                                                      "kernel_combine_greedy")}
        if after["device"] != "cuda" or min(launches.values()) < 1:
            fail(f"the daemon on {after['device']} launched {launches} over the served runs")
        client.shutdown()
        if proc.wait(120) != 0:
            fail(f"the daemon exited {proc.returncode} on its shutdown request")
        client.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if os.path.exists(sock):
        fail("the daemon left its socket behind")
    print(f"    the daemon shut down on request; its kernel launches over the served runs "
          f"{launches}, since its start (the warm steps included) "
          + json.dumps({k: after[k] for k in launches}), flush=True)

    kept = torch.load(keep)
    if (len(kept["merge_sweep"]) != after["kernel_merge_sweep"]
            or len(kept["ed_myers"]) != after["kernel_ed_myers"]):
        fail(f"the daemon kept {len(kept['merge_sweep'])} sweeps and {len(kept['ed_myers'])} "
             f"edit-distance launches of {after}")
    sweep_err = 0.0
    for j, (inputs, before_state, after_state, counts) in enumerate(kept["merge_sweep"]):
        sweep_err = max(sweep_err, hold_launch(
            inputs, before_state, after_state, counts, meta,
            f"daemon sweep {j} {tuple(inputs['seed_type'].shape)}"))
    ed_err = hold_ed(kept["ed_myers"], "the daemon")
    print(f"    every launch in the daemon held against its plain version: "
          f"{len(kept['merge_sweep'])} sweeps, {len(kept['ed_myers'])} edit-distance launches, "
          f"each == plain (bit-exact)", flush=True)

    idle = os.path.join(tmp, "idle.sock")
    t0 = time.perf_counter()
    proc = start_daemon(idle, ["--idle-timeout", "2", "--no-warm-compile"],
                        os.path.join(tmp, "idle.log"))
    try:
        code = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if code != 0 or os.path.exists(idle):
        fail(f"the daemon with --idle-timeout 2 exited {code}, its socket "
             f"{'left behind' if os.path.exists(idle) else 'removed'}")
    print(f"    a second daemon with --idle-timeout 2 exited by itself after "
          f"{time.perf_counter() - t0:.2f} s (exit 0, socket removed)", flush=True)
    return launches, sweep_err, ed_err


# -- phase 9: the mesh ------------------------------------------------------

def check_mesh_counters(c, what, tasks=DENSE_CONTIGS):
    """A --tpu-mesh run's counters: every task through the mesh, none on
    the seam route, and, where the counters hold a service's launches, at
    least one launch of each sweep kernel a shard of each mesh request."""
    if c.get("mesh_tasks") != tasks or c.get("mesh_seam_host", 0) or c.get("fb_capacity", 0):
        fail(f"{what}: mesh_tasks {c.get('mesh_tasks')} (want {tasks}), mesh_seam_host "
             f"{c.get('mesh_seam_host', 0)}, fb_capacity {c.get('fb_capacity', 0)}")
    if "kernel_merge_sweep" in c and not (
            c["kernel_merge_sweep"] == c["kernel_sweep_cuts"]
            >= MESH_SHARDS * (c["service_requests"] - c.get("service_fusion_fused_requests", 0))):
        fail(f"{what}: sweep launches {c['kernel_merge_sweep']}, {c['kernel_sweep_cuts']} for "
             f"{c['service_requests']} requests")
    if "kernel_merge_sweep" in c and c["kernel_call_stats"] < MESH_SHARDS * (
            c["service_requests"] - c.get("service_fusion_fused_requests", 0)):
        fail(f"{what}: {c['kernel_call_stats']} call-statistics launches for "
             f"{c['service_requests']} requests")


def hold_kept(keep_path, meta, what):
    """Every sweep launch a --cli-child kept, held against the plain
    version. Returns (the launches, those whose head mask was neither 0 nor
    0xFF, the max |kernel - plain|)."""
    kept, err, mixed = torch.load(keep_path), 0.0, 0
    for j, (inputs, before, after, counts) in enumerate(kept):
        mixed += int(inputs["head_mask"].reshape(-1)[0]) not in (0, 0xFF)
        err = max(err, hold_launch(inputs, before, after, counts, meta,
                                   f"{what}, sweep {j} n={inputs['seed_type'].shape[-1]} "
                                   f"head mask {int(inputs['head_mask'].reshape(-1)[0]):#04x}"))
    return len(kept), mixed, err


def mesh_cohort(tmp):
    """tests/test_mesh_combine_cli.py's cohort: three samples sharing sites
    at slightly different breakpoints, and site pairs on either side of
    combine_match_max, called to .snf on the host path in process."""
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset
    snfs = []
    for i in range(3):
        rng = np.random.default_rng(100 + i)
        svs = [PlantedSV(pos=base + int(rng.integers(-30, 31)),
                         svtype=("INS", "DEL", "DUP", "INV")[base // 30_000 % 4],
                         svlen=150 + 40 * (base // 30_000))
               for base in (20_000, 50_000, 80_000, 110_000, 140_000, 170_000)]
        svs += [PlantedSV(pos=200_000, svtype="DEL", svlen=120),
                PlantedSV(pos=200_900, svtype="DEL", svlen=130),
                PlantedSV(pos=230_000, svtype="INS", svlen=90),
                PlantedSV(pos=231_140, svtype="INS", svlen=95)]
        d = os.path.join(tmp, f"s{i}")
        os.makedirs(d)
        bam, _ = write_dataset(d, ref_len=260_000, depth=18, read_len=12_000, seed=13 + i,
                               svs=sorted(svs, key=lambda sv: sv.pos))
        snfs.append(os.path.join(tmp, f"s{i}.snf"))
        run_cli(["--input", bam, "--snf", snfs[-1], "--sample-id", f"s{i}"], ["--no-tpu"],
                os.path.join(tmp, f"s{i}.json"), "mesh cohort --snf")
    return snfs


def run_mesh(tmp, meta, dense, combine):
    """Phase 9 but (e) (see the module's docstring). dense: (tmp, args) of
    phase 4; combine: (the SNFs, the device VCF) of phase 3. Returns (the
    phase's main-path sweep launches in the --threads 4 child's service,
    the sweeps' max |kernel - plain|, the edit-distance launches'
    max |kernel - plain|)."""
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.parallel import device_call as tdc
    from sniffles_tpu_torch.parallel import mesh as tmesh
    from sniffles_tpu_torch.sim import fuzz_call_batch

    header("[9a] the merge sweep with mixed head masks against its plain version", flush=True)
    err = 0.0
    for seed in (1, 2):
        packed = fuzz_call_batch(seed, 32768)
        for mask in MESH_HEAD_MASKS:
            s, b, bin_ = tc.sort_and_seed(tc.packed_signatures(
                torch.from_numpy(packed).cuda()), meta["binsize"])
            inputs, state = tc.sweep_inputs(s, b, bin_, meta["binsize"], mask)
            err = max(err, check_sweep_kernel(inputs, state, meta,
                                              f"fuzz n=32768 seed {seed} head mask {mask:#04x}"))
    stack = []
    for seed, mask in zip((3, 4, 5), MESH_HEAD_MASKS):
        s, b, bin_ = tc.sort_and_seed(tc.packed_signatures(
            torch.from_numpy(fuzz_call_batch(seed, 2048)).cuda()), meta["binsize"])
        stack.append(tc.sweep_inputs(s, b, bin_, meta["binsize"], mask))
    inputs, state = (tc._stack_tasks([t[j] for t in stack]) for j in (0, 1))
    after = {k: v.clone() for k, v in state.items()}
    counts = tc.merge_sweep(inputs, after, **sweep_params(meta))
    torch.cuda.synchronize()
    err = max(err, hold_launch({k: v.cpu() for k, v in inputs.items()},
                               {k: v.cpu() for k, v in state.items()},
                               {k: v.cpu() for k, v in after.items()}, counts.cpu(), meta,
                               "a stack of 3 tasks (n=2048, seeds 3-5), masks "
                               + ", ".join(f"{m:#04x}" for m in MESH_HEAD_MASKS)))

    dense_tmp, dense_args = dense
    reference = vcf_parts(os.path.join(dense_tmp, "device.vcf"))
    mesh_args = ["--tpu-mesh", str(MESH_SHARDS)]
    header(f"[9c] dense3 at --tpu-mesh {MESH_SHARDS} ({MESH_DEVICES}), --threads 0 and 4, in "
          f"children that keep every sweep launch", flush=True)
    launches = None
    for threads in ("0", "4"):
        what = f"dense3 --tpu-mesh {MESH_SHARDS} --threads {threads}"
        out, keep = (os.path.join(tmp, f"dense_mesh_t{threads}.{x}") for x in ("vcf", "pt"))
        wall, c, timing = run_child([*dense_args, "--vcf", out, "--threads", threads,
                                     *mesh_args], out + ".json", what, keep_path=keep)
        check_mesh_counters(c, what)
        if vcf_parts(out) != reference:
            fail(f"{what}: VCF differs from phase 4's")
        n_kept, mixed, e = hold_kept(keep, meta, what)
        err = max(err, e)
        if not n_kept >= MESH_SHARDS * DENSE_CONTIGS or mixed < 1:
            fail(f"{what}: {n_kept} sweeps kept, {mixed} with a mixed head mask")
        if threads == "4":
            launches = {"launches": c["kernel_merge_sweep"], "sweep_cuts": c["kernel_sweep_cuts"]}
        print(f"    {what}: {wall:.2f} s ({timing}); VCF == phase 4's "
              f"({len(reference[1])} records); counters " + json.dumps(
                  {k: c[k] for k in sorted(c) if k.startswith(("mesh", "device_tasks",
                                                               "engine", "children",
                                                               "fb_", "kernel_"))})
              + f"; {n_kept} sweeps kept, {mixed} with a mixed head mask, each == plain",
              flush=True)

    header(f"[9b] the mesh call step on dense3's largest task: {MESH_SHARDS} shards on "
          f"cuda:0 against {MESH_SHARDS} CPU shards", flush=True)
    with open(os.path.join(tmp, "dense_mesh_t0.pt.mesh"), "rb") as f:
        payloads = pickle.load(f)   # this script's own child wrote it
    payload, step_meta = max(payloads, key=lambda p: int((p[0]["shards"][:, 5] > 0).sum()))
    halo_w = np.full((MESH_SHARDS, 1), tdc.MESH_HALO_BP, dtype=np.int32)
    args = (payload["shards"], payload["offsets"], payload["window_len"], halo_w)
    walls = {}
    for where, devices in (("card", tmesh.mesh_devices(MESH_SHARDS)),
                           ("cpu", ["cpu"] * MESH_SHARDS)):
        t0 = time.perf_counter()
        walls[where] = (tmesh.build_sharded_assign(devices, **step_meta)(*args),
                        time.perf_counter() - t0)
    (on_card, card_s), (on_cpu, cpu_s) = walls["card"], walls["cpu"]
    if (not np.array_equal(on_card["rows"], on_cpu["rows"])
            or not np.array_equal(on_card["halo_overflow"], on_cpu["halo_overflow"])):
        bad = np.argwhere(on_card["rows"] != on_cpu["rows"])[:5].tolist()
        fail(f"the mesh call step on the card differs from the CPU's at {bad}")
    signatures = int((payload["shards"][:, 5] > 0).sum())
    print(f"    {signatures} signatures over {MESH_SHARDS} shards of width "
          f"{payload['shards'].shape[2]}: rows {tuple(on_card['rows'].shape)} and overflow "
          f"flags {on_card['halo_overflow'].tolist()} == the CPU's, bit for bit (card "
          f"{card_s:.3f} s, CPU {cpu_s:.3f} s, host clock, one call each)", flush=True)

    header(f"[9d] combine at --tpu-mesh {MESH_SHARDS}: the mesh cohort and combine256, in "
          f"children that keep every edit-distance launch", flush=True)
    cohort = mesh_cohort(tmp)
    ed_err = 0
    snfs, combine_vcf = combine
    for label, inputs, host_vcf in (("mesh cohort", cohort, None),
                                    ("combine256", snfs, combine_vcf)):
        if host_vcf is None:
            host_vcf = os.path.join(tmp, "cohort_host.vcf")
            run_cli(["--input", *inputs, "--vcf", host_vcf], ["--no-tpu"],
                    os.path.join(tmp, "cohort_host.json"), "mesh cohort")
        what = f"{label} --tpu-mesh {MESH_SHARDS}"
        out = os.path.join(tmp, f"{label.replace(' ', '_')}_mesh.vcf")
        keep = out + ".pt"
        wall, c, _ = run_child(["--input", *inputs, "--vcf", out, *mesh_args], out + ".json",
                               what, keep_path=keep)
        # every edit-distance launch of the child's service, at this path's
        # own per-flush shapes, against the plain version
        eds = torch.load(keep + ".ed")
        if len(eds) != c.get("kernel_ed_myers", 0):
            fail(f"{what}: {c.get('kernel_ed_myers', 0)} edit-distance launches, "
                 f"{len(eds)} kept")
        if label == "combine256" and not eds:
            fail(f"{what}: the edit-distance kernel never ran")
        ed_err = max(ed_err, hold_ed(eds, what))
        if vcf_parts(out) != vcf_parts(host_vcf):
            fail(f"{what}: VCF differs from its host VCF")
        if label == "mesh cohort" and c.get("combine_mesh_flushes", 0) < 1:
            fail(f"{what}: the mesh took no flush {c}")
        if c.get("combine_mesh_seam", 0):
            fail(f"{what}: {c['combine_mesh_seam']} flushes overflowed the halo")
        print(f"    {what}: {wall:.2f} s; {len(records_of(out))} records == the host VCF's; "
              f"{check_greedy_counters(c, what)}; "
              + json.dumps({k: c.get(k, 0) for k in ("combine_mesh_flushes",
                                                      "combine_mesh_skipped",
                                                      "combine_mesh_seam", "service_requests",
                                                      "kernel_ed_myers")}), flush=True)

    header("[9f] the multi-host run: two processes on the card, joined by "
          "SNIFFLES_TPU_COORDINATOR", flush=True)
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"

    def process(rank):
        out = os.path.join(tmp, f"host{rank}.vcf")
        return out, run_child([*dense_args, "--vcf", out, *mesh_args], out + ".json",
                              f"dense3 --tpu-mesh {MESH_SHARDS}, process {rank} of 2",
                              env_extra={"SNIFFLES_TPU_COORDINATOR": coordinator,
                                         "SNIFFLES_TPU_NUM_PROCESSES": "2",
                                         "SNIFFLES_TPU_PROCESS_ID": str(rank)})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        (out0, (wall0, c0, _)), (out1, (wall1, c1, _)) = pool.map(process, (0, 1))
    if vcf_parts(out0) != reference or os.path.exists(out1):
        fail("the multi-host run: process 0's VCF differs from phase 4's, or process 1 wrote "
             "one")
    tasks = (c0.get("mesh_tasks", 0), c1.get("mesh_tasks", 0))
    if sum(tasks) != DENSE_CONTIGS or min(tasks) < 1:
        fail(f"the multi-host run: mesh tasks by process {tasks}")
    print(f"    {time.perf_counter() - t0:.2f} s together ({wall0:.2f} s, {wall1:.2f} s); "
          f"mesh tasks by process {tasks}; process 0's VCF == phase 4's, process 1 wrote "
          f"none", flush=True)
    return launches, err, ed_err


# -- phase 10 ---------------------------------------------------------------

def queued_ms(fn, reps):
    """Device time of fn()'s launches between two CUDA events, the mean of
    `reps` runs after one that warms up; the card sleeps ahead of the start
    event, so the launches are queued before it reaches them and the
    host's time to make them stays out."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(reps + 1):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(stop)
    return total / reps


def engine_outputs_equal(ours, want, what, keys=None):
    """Fails unless every key (or `keys`) of two engine outputs is equal,
    float32 keys by their bits; `ours` on any device, `want` on the CPU
    (tensors or numpy arrays)."""
    for k in keys if keys is not None else want:
        a = ours[k].cpu().numpy() if isinstance(ours[k], torch.Tensor) else np.asarray(ours[k])
        b = want[k].numpy() if isinstance(want[k], torch.Tensor) else np.asarray(want[k])
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what}: {k} is {a.dtype} {a.shape} on the card, {b.dtype} {b.shape} on "
                 f"the CPU")
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        if not np.array_equal(a, b):
            fail(f"{what}: {k} differs between the card and the CPU in "
                 f"{int((a != b).sum())} slots")


def engine_step_pair(sig, coverage, params, what, region_offset=0):
    """The engine's step on the card and on the CPU (the plain versions),
    every key held bit for bit. Returns (the card's output, its relaxation
    rounds, CPU s, card s, the CPU's output)."""
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step
    t0 = time.perf_counter()
    want = call_pipeline_step(sig, coverage, params, region_offset, device="cpu")
    cpu_s = time.perf_counter() - t0
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = call_pipeline_step(sig, coverage, params, region_offset, device="cuda", info=info)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    engine_outputs_equal(got, want, what)
    return got, int(info["merge_rounds"]), cpu_s, card_s, want


def engine_flag_params(flags, coverage, nm_threshold):
    """default_params of the CLI's flag set, with the contig's mean coverage
    and regional NM as a call task has them."""
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.parallel.engine import default_params
    params = default_params(SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf", *flags))
    params["coverage_global"] = float(coverage.mean())
    params["qc_nm_threshold"] = float(nm_threshold)
    return params


def sharded_pair(sig, coverage, offsets, what, **kw):
    """build_sharded_step as ENGINE_SHARDS shards on cuda:0 against the same
    step on ENGINE_SHARDS CPU shards: integer outputs and halo_overflow
    equal. Returns (the card's output, card s, CPU s)."""
    from sniffles_tpu_torch.parallel.engine import default_params
    from sniffles_tpu_torch.parallel.mesh import build_sharded_step
    outs, secs = [], []
    for dev in ("cpu", "cuda:0"):
        t0 = time.perf_counter()
        outs.append(build_sharded_step([dev] * ENGINE_SHARDS, default_params(), **kw)(
            sig, coverage, offsets))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    want, got = outs
    engine_outputs_equal(got, want, what, [k for k, v in want.items() if v.dtype != np.float32])
    return got, secs[1], secs[0]


def dryrun_shards(tmp):
    """__graft_entry__.dryrun_multichip's recipe at ENGINE_SHARDS shards: a
    simulated BAM of 16,384 bp a shard, the real leads of each window as
    a batch of 256 slots, the real per-base coverage."""
    from sniffles_tpu_torch.signatures import from_leads
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset
    cov_per_dev, per_dev = 16384, 256
    ref_len = cov_per_dev * ENGINE_SHARDS
    svs = [PlantedSV(pos=int((i + 0.5) * ref_len / (2 * ENGINE_SHARDS)),
                     svtype=("INS", "DEL", "DUP", "INV")[i % 4], svlen=120 + 60 * (i % 4))
           for i in range(2 * ENGINE_SHARDS)]
    os.makedirs(tmp, exist_ok=True)
    bam, _ = write_dataset(tmp, ref_len=ref_len, depth=10, read_len=6000, seed=5, svs=svs)
    from sniffles_tpu_torch.tools.profile_engine import dense_chr1
    leads, coverage, _ = dense_chr1(bam)
    sig = {}
    for s in range(ENGINE_SHARDS):
        shard = [ld for ld in leads if s * cov_per_dev <= ld.ref_start < (s + 1) * cov_per_dev]
        for k, v in from_leads(shard, batch_size=per_dev).as_dict().items():
            sig.setdefault(k, []).append(v[:per_dev])
    return ({k: np.concatenate(v) for k, v in sig.items()}, coverage[:ref_len],
            np.arange(ENGINE_SHARDS, dtype=np.int32) * cov_per_dev)


def window_shards(leads, coverage, window):
    """A contig's leads as ENGINE_SHARDS windows of `window` bp, each padded
    to one width (a multiple of 1,024)."""
    from sniffles_tpu_torch.signatures import from_leads
    shards = [[ld for ld in leads if s * window <= ld.ref_start < (s + 1) * window]
              for s in range(ENGINE_SHARDS)]
    width = -(-max(len(s) for s in shards) // 1024) * 1024
    sig = {}
    for shard in shards:
        for k, v in from_leads(shard, batch_size=width).as_dict().items():
            sig.setdefault(k, []).append(v)
    cov = np.zeros(window * ENGINE_SHARDS, dtype=np.int32)
    cov[:min(len(coverage), len(cov))] = coverage[:len(cov)]
    return ({k: np.concatenate(v) for k, v in sig.items()}, cov,
            np.arange(ENGINE_SHARDS, dtype=np.int32) * window)


def relax_bytes(n):
    """Bytes the relaxation must move: each input read once (pos, svlen as
    float32, svtype, bin as int32, repeat, valid and the seed boundaries as
    bytes) and the boundaries written once."""
    return n * (4 * 4 + 3 + 1)


def tail_bytes(stats, coverage, region_offset, binsize=100):
    """Bytes the candidate tail must move: a slot's statistics (svtype,
    svlen, pos, support, lead_count, n_strands, stdev_pos, stdev_len,
    support_sa: 36 bytes), an element's nm, valid and cluster id (9), the
    distinct coverage entries its probes read in this run, and 60 bytes of
    outputs a slot."""
    n = stats["svtype"].shape[0]
    from sniffles_tpu_torch.ops.coverage import annotate_coverage
    cov = annotate_coverage(torch.arange(coverage.shape[0], dtype=torch.int32) + 1,
                            stats["svtype"].cpu(), stats["pos"].cpu(), stats["svlen"].cpu(),
                            torch.zeros(n, dtype=torch.bool), region_offset, binsize)
    probes = torch.cat([v for v in cov.values()])
    distinct = int(torch.unique(probes[probes > 0]).numel())
    return n * (36 + 9 + 60) + 4 * distinct


def relax_bound_ms(n, rounds):
    """(bound ms, int32 operations, "bytes" or "operations") of a
    relaxation over n slots that ran `rounds` rounds: each element walked
    once a round by its head, RELAX_OPS_PER_ELEMENT operations."""
    ops = RELAX_OPS_PER_ELEMENT * n * rounds
    by_bytes, by_ops = relax_bytes(n) / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ops, "bytes" if by_bytes >= by_ops else "operations"


def no_relax_sync(tmr, s, boundary, bin_, relax):
    """One relaxation under torch.cuda.set_sync_debug_mode("error"): a host
    synchronisation raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tmr.launch_merge_relax(s, boundary, bin_, **relax)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def kept_call_stats(store):
    """Keeps every call of the call-statistics wrapper on CUDA tensors
    while the block runs: (its inputs and its output, copies on the card,
    fused) appended to `store`. The wrapper is looked up at each call."""
    from sniffles_tpu_torch.ops import call_stats as cs
    wrapper = cs.call_statistics

    def keep(clustered, fused=False):
        out = wrapper(clustered, fused)
        if clustered["pos"].is_cuda:
            store.append(({k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in clustered.items()},
                          {k: v.clone() for k, v in out.items()}, fused))
        return out
    cs.call_statistics = keep
    try:
        yield store
    finally:
        cs.call_statistics = wrapper


def hold_call_stats(clustered, got, fused, what):
    """A call of the call-statistics kernels (inputs on the card, output)
    against call_statistics_plain: on CPU copies of the inputs every key
    and slot bit for bit; on the card, the same device, every integer key
    bit for bit. Returns the largest |kernel - plain on the card| of the
    float32 keys (the card's plain float sums add with atomics, in no
    fixed order)."""
    from sniffles_tpu_torch.ops import call_stats as cs
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in clustered.items()}
    engine_outputs_equal(got, cs.call_statistics_plain(cpu, fused),
                         f"call_stats {what}, against the plain version on CPU copies")
    on_card = cs.call_statistics_plain(clustered, fused)
    err = 0.0
    for k in cs.KEYS:
        if k in cs.FLOAT_KEYS:
            if got[k].numel():
                err = max(err, float((got[k] - on_card[k]).abs().nan_to_num(0.0).max()))
        elif not torch.equal(got[k], on_card[k]):
            fail(f"call_stats {what}: {k} differs from the plain version on the card in "
                 f"{int((got[k] != on_card[k]).sum())} slots")
    return err


def hold_kept_call_stats(kept, what):
    """hold_call_stats of every kept call; returns (calls, largest float32
    difference from the plain version on the card)."""
    err = 0.0
    for j, (clustered, got, fused) in enumerate(kept):
        err = max(err, hold_call_stats(clustered, got, fused,
                                       f"{what}, call {j} (n={clustered['pos'].shape[0]})"))
    return len(kept), err


def ptxas_summary(log, kernel):
    """ptxas's registers and spills of `kernel` from a -Xptxas -v build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            stats = []
            for ln in lines[i + 1:i + 6]:
                if "Compiling entry" in ln:
                    break
                if "registers" in ln or "spill" in ln:
                    stats.append(ln.split("info    :", 1)[-1].strip())
            return "; ".join(stats)
    return "not in the build log"


def time_engine_kernels(sig, coverage, params, ptxas_log, stats_ptxas_log, cpu_step):
    """(d): the two kernels' CUDA-event times on the step's 2^21 inputs, their
    plain versions on the card, their bounds; the step replayed as a CUDA
    graph held against `cpu_step`, the CPU step on those inputs, every key;
    then the eager body and the replayed step each: device time, the host's
    launches, signatures a second (bench.py's measure: 3 repeats of 10
    steps), peak device memory; the host synchronisations of the eager
    body. Returns the JSON rows."""
    from sniffles_tpu_torch.ops import candidate_tail as ct, clustering as tc
    from sniffles_tpu_torch.ops import merge_relax as tmr
    from sniffles_tpu_torch.ops.segments import seg_sum
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step, to_device
    sig, coverage = to_device(sig, coverage, "cuda")
    n = sig["pos"].shape[0]
    relax = {k: params[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                                    "cluster_merge_bnd")}
    relax.update(global_repeat=False, binsize=100)
    s, boundary, bin_ = tc.sort_and_seed(sig, 100)
    got, rounds = tmr.launch_merge_relax(s, boundary, bin_, **relax)
    want, want_rounds = tmr.merge_relax_plain(s, boundary, bin_, **relax)
    if not torch.equal(got, want) or int(rounds) != want_rounds:
        fail("merge_relax kernel differs from its plain version on the 2^21 step's inputs")
    relax_ms = queued_ms(lambda: tmr.launch_merge_relax(s, boundary, bin_, **relax), 10)
    relax_call_ms = cuda_ms(lambda: tmr.launch_merge_relax(s, boundary, bin_, **relax), 10)
    relax_plain_ms = cuda_ms(lambda: tmr.merge_relax_plain(s, boundary, bin_, **relax), 3)
    no_relax_sync(tmr, s, boundary, bin_, relax)
    relax_bound, relax_ops, relax_by = relax_bound_ms(n, want_rounds)
    print(f"  merge_relax n={n}: {want_rounds} rounds; kernel {relax_ms:.4f} ms on the device "
          f"(one cooperative launch of {tmr.resident_grid(boundary.device)} blocks; "
          f"{relax_call_ms:.4f} ms a call of the wrapper), plain {relax_plain_ms:.2f}"
          f" ms, == plain (bit-exact), no host synchronisation (sync debug mode 'error'); "
          f"bound {relax_bound * 1e3:.3f} us ({relax_bytes(n)} bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {relax_ops} int32 ops at "
          f"{INT32_OPS_PER_S / 1e12:.1f} Tops/s), {relax_bound / relax_ms:.3%} of it",
          flush=True)
    from sniffles_tpu_torch.sim import relax_chain_batch
    chain = {k: torch.as_tensor(v).cuda() for k, v in relax_chain_batch(n).items()}
    cs, cboundary, cbin = tc.sort_and_seed(chain, 100)
    got, rounds = tmr.launch_merge_relax(cs, cboundary, cbin, **relax)
    want, chain_rounds = tmr.merge_relax_plain(cs, cboundary, cbin, **relax)
    if (not torch.equal(got, want) or int(rounds) != chain_rounds
            or chain_rounds != tmr.MERGE_ITERS_MAX):
        fail(f"merge_relax kernel differs from its plain version on the tiled chain "
             f"({int(rounds)} rounds against {chain_rounds})")
    chain_ms = queued_ms(lambda: tmr.launch_merge_relax(cs, cboundary, cbin, **relax), 10)
    chain_plain_ms = cuda_ms(lambda: tmr.merge_relax_plain(cs, cboundary, cbin, **relax), 3)
    no_relax_sync(tmr, cs, cboundary, cbin, relax)
    chain_bound, chain_ops, chain_by = relax_bound_ms(n, chain_rounds)
    print(f"  merge_relax on the tiled chain n={n} ({int(chain['valid'].sum())} leads, "
          f"{int(cboundary.sum())} seed heads, {int(want.sum())} after): {chain_rounds} rounds, "
          f"== plain (bit-exact), no host synchronisation; kernel {chain_ms:.4f} ms, plain "
          f"{chain_plain_ms:.2f} ms; bound {chain_bound * 1e3:.3f} us ({chain_by}: "
          f"{chain_ops} int32 ops), {chain_bound / chain_ms:.3%} of it", flush=True)

    clustered = tc.cluster_signatures(sig, minsvlen=params["minsvlen"],
                                      cluster_merge_len=params["cluster_merge_len"],
                                      exact_sweep=False, **{k: v for k, v in relax.items()
                                                            if k != "global_repeat"})
    clustered.pop("merge_rounds")
    stats = tc.call_statistics(clustered, fused=True)
    support_sa = seg_sum((clustered["valid"] & (clustered["sa"] > 0)).to(torch.int32),
                         clustered["cluster_id"], n)
    tail = ct.launch_candidate_tail(stats, support_sa, coverage, clustered, params)
    # held against the plain version on CPU copies: on the card its NM sum
    # is an index_add_ of atomics, whose order is not the array's
    plain = ct.candidate_tail_plain(
        {k: v.cpu() for k, v in stats.items()}, support_sa.cpu(), coverage.cpu(),
        {k: v.cpu() for k, v in clustered.items()}, params)
    engine_outputs_equal(tail, plain, "candidate_tail against its plain version (2^21)")
    tail_ms = queued_ms(lambda: ct.launch_candidate_tail(stats, support_sa, coverage, clustered,
                                                         params), 10)
    tail_call_ms = cuda_ms(lambda: ct.launch_candidate_tail(stats, support_sa, coverage,
                                                            clustered, params), 10)
    tail_plain_ms = cuda_ms(lambda: ct.candidate_tail_plain(stats, support_sa, coverage,
                                                            clustered, params), 3)
    n_bytes = tail_bytes(stats, coverage, 0)
    tail_ops = TAIL_OPS_PER_SLOT * n
    tail_bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    tail_ops_ms = tail_ops / FP32_OPS_PER_S * 1e3
    tail_bound = max(tail_bytes_ms, tail_ops_ms)
    runs_row = time_tail_runs(clustered["cluster_id"], ptxas_log)
    print(f"  candidate_tail ptxas: {ptxas_summary(ptxas_log, 'candidate_tail_kernel')}",
          flush=True)
    print(f"  candidate_tail n={n}: kernel {tail_ms:.4f} ms on the device ({tail_call_ms:.4f} "
          f"ms a call of the wrapper), plain {tail_plain_ms:.2f} ms on "
          f"the card, == plain on the CPU copies (bit-exact); bound {tail_bound * 1e3:.3f} us ({n_bytes} bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {tail_ops} float32 ops at "
          f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s: {tail_ops_ms * 1e3:.3f} us), "
          f"{tail_bound / tail_ms:.3%} of it", flush=True)
    stats_rows = time_call_stats(clustered, chain, relax, params, stats_ptxas_log)

    from sniffles_tpu_torch.parallel import engine
    step = lambda: call_pipeline_step(sig, coverage, params)  # noqa: E731
    eager = lambda: engine._eager_step(sig, coverage, params, 0, 100, 20, None, None)  # noqa
    # the replayed step: a first sight (eager) and a capture before any timing
    engine.clear_graphs()
    before = dict(engine.COUNTS)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    step()
    step()
    torch.cuda.synchronize()
    pool = torch.cuda.memory_reserved() - reserved
    engine_outputs_equal(step(), cpu_step, "the replayed step at 2^21 against the CPU step")
    paths = {k: engine.COUNTS[k] - before[k] for k in ("eager", "captures", "replays")}
    if paths != {"eager": 1, "captures": 1, "replays": 1}:
        fail(f"the 2^21 step's first three calls went {paths}, not eager, capture, replay")
    timed = {}
    for name, fn in (("eager", eager), ("replayed", step)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step_ms = cuda_ms(fn, 10)
        peak = torch.cuda.max_memory_allocated() - base
        # the host's side of a step: where it comes near step_ms, the host
        # bounds the step and the card waits on its launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        enqueue_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            rates.append(n / ((time.perf_counter() - t0) / 10))
        timed[name] = (step_ms, enqueue_ms, rates, peak)
    replays = engine.COUNTS["replays"] - before["replays"] - 1
    if replays != 51 or engine.COUNTS["eager"] != before["eager"] + 1:
        fail(f"the timed replayed steps went {replays} of 51 calls to a replay")
    sites = sync_sites(eager)
    in_relax = sum(v for k, v in sites.items() if "merge_relax" in k)
    print(f"  the step n={n}: replayed as a CUDA graph == the CPU step on every key "
          f"(graph pool {pool / 2**20:.1f} MiB)", flush=True)
    for name, (step_ms, enqueue_ms, rates, peak) in timed.items():
        print(f"  the {name} step n={n}: {step_ms:.3f} ms a step between CUDA events, the "
              f"host's launches of a step {enqueue_ms:.3f} ms; {np.mean(rates):.4g} "
              f"signatures/s (bench.py's measure: 3 x 10 steps, host clock; "
              f"{', '.join(f'{r:.4g}' for r in rates)}); peak device memory of a step "
              f"{peak / 2**20:.1f} MiB above its inputs", flush=True)
    print(f"  host synchronisations of the eager step {sum(sites.values())}"
          + "".join(f"; {k} x{v}" for k, v in sorted(sites.items())), flush=True)
    engine.clear_graphs()
    if in_relax:
        fail(f"the relaxation synchronised with the host {in_relax} times")
    return ({"ms": relax_ms, "plain_ms": relax_plain_ms, "bound_ms": relax_bound,
             "bound_by": relax_by},
            {"ms": tail_ms, "plain_ms": tail_plain_ms, "bound_ms": tail_bound,
             "bound_by": "bytes" if tail_bytes_ms >= tail_ops_ms else "operations"},
            stats_rows, runs_row)


def time_tail_runs(cluster_id, ptxas_log):
    """The tail's run pass alone on the step's cluster ids: held bit for bit
    against tail_runs_plain (torch.searchsorted on the card), then its
    device time by torch.profiler (the JSON row's) and by CUDA events,
    beside its byte bound (the ids read once, the written starts), the
    plain version's time and torch.searchsorted's (the library call: its
    kernels by torch.profiler, and CUDA events). Returns the JSON row."""
    from sniffles_tpu_torch.ops import candidate_tail as ct
    from sniffles_tpu_torch.tools.time_call_stats import by_kernel
    cid = cluster_id.to(torch.int32).contiguous()
    n = cid.shape[0]
    want = ct.tail_runs_plain(cid)
    got = ct.launch_tail_runs(cid)[:want.shape[0]]
    if not torch.equal(got, want):
        fail(f"tail_runs differs from tail_runs_plain on the step's {n} cluster ids")
    run = lambda: ct.launch_tail_runs(cid)  # noqa: E731
    slots = torch.arange(want.shape[0], dtype=torch.int32, device=cid.device)
    search = lambda: torch.searchsorted(cid, slots, out_int32=True)  # noqa: E731
    us = launch_us(run, ("tail_runs",))["tail_runs"]
    events_ms = queued_ms(run, 10)
    search_us = sum(v[0] for v in by_kernel(search).values())
    search_ms = queued_ms(search, 10)
    plain_ms = cuda_ms(lambda: ct.tail_runs_plain(cid), 10)
    n_bytes = 4 * n + 4 * want.shape[0]
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  tail_runs<4> ptxas: {ptxas_summary(ptxas_log, 'tail_runsILi4')}", flush=True)
    print(f"  tail_runs n={n} ({want.shape[0]} starts): == tail_runs_plain (bit-exact); "
          f"{us / 1e3:.4f} ms on the device (torch.profiler; {events_ms:.4f} ms by CUDA "
          f"events), plain {plain_ms:.4f} ms; torch.searchsorted of the ids {search_us / 1e3:.4f}"
          f" ms (torch.profiler; {search_ms:.4f} ms by CUDA events); bound {bound * 1e3:.3f} us "
          f"({n_bytes} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), {bound * 1e3 / us:.3%} of it",
          flush=True)
    return {"ms": us / 1e3, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": search_us / 1e3, "max_abs_err": 0}


def call_stats_bound_ms(n, bytes_per_element):
    """(bound ms, "bytes" or "operations") of the call statistics over n
    slots: `bytes_per_element` a slot at the HBM rate, or
    CALL_STATS_OPS_PER_ELEMENT int32 operations a slot."""
    by_bytes = bytes_per_element * n / HBM_BYTES_PER_S
    by_ops = CALL_STATS_OPS_PER_ELEMENT * n / INT32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def call_stats_kernel_parts(counts, n):
    """{kernel: (bytes ms, operations ms, chain ms)} of each kernel of
    csrc/call_stats.cu on n slots whose clusters have `counts` elements
    (lead_count, numpy), split by the tiers of ops/call_stats.py: the bytes
    each must move (stat_keys: every element's cluster id and valid byte
    read, its key written; stat_runs: the sorted keys read, the n + 1 run
    starts and n invalid marks written; stat_slots: every slot's run start
    and invalid mark, the rows of the empty slots and of the thread tier's
    clusters, those clusters' gathers, the other live slots' list entries;
    stat_warps and stat_blocks: their clusters' runs, list entries, marks,
    gathers and rows) at the HBM rate, the operations
    (stat_keys: KEY_OPS an element; stat_runs: RUN_OPS an item of the merge
    of 2n slot ids and n keys; the tiers: CALL_STATS_OPS_PER_ELEMENT an
    element, and the cnt * log2(cnt) compares
    of a comparison sort of each cluster's lists,
    CALL_STATS_OPS_PER_COMPARE each) at the int32 rate, and the latency
    floor of the tier's longest sequential chain: its largest cluster's NM
    sum, cnt dependent float32 adds at FADD_LATENCY_CYCLES each."""
    from sniffles_tpu_torch.ops import call_stats as cs
    counts = counts.astype(np.int64)
    live = counts > 0
    tiers = {"stat_slots": live & (counts <= cs.TINY_MAX),
             "stat_warps": (counts > cs.TINY_MAX) & (counts <= cs.WARP_MAX),
             "stat_blocks": counts > cs.WARP_MAX}
    compares = counts * np.log2(np.maximum(counts, 1))

    def work(sel):
        elements = int(counts[sel].sum())
        return (elements * CALL_STATS_GATHER_BYTES + int(sel.sum()) * (8 + 4 + 1 + 64),
                elements * CALL_STATS_OPS_PER_ELEMENT
                + float(compares[sel].sum()) * CALL_STATS_OPS_PER_COMPARE)
    slots_bytes, slots_ops = work(tiers["stat_slots"])
    n_bytes = {"stat_keys": 9 * n, "stat_runs": 9 * n + 4,
               "stat_slots": 5 * n + 4 + 64 * int((~live).sum()) + slots_bytes - 13 * int(
                   tiers["stat_slots"].sum()) + 4 * int((live & ~tiers["stat_slots"]).sum()),
               "stat_warps": work(tiers["stat_warps"])[0],
               "stat_blocks": work(tiers["stat_blocks"])[0]}
    n_ops = {"stat_keys": KEY_OPS * n, "stat_runs": RUN_OPS * 3 * n,
             "stat_slots": slots_ops + 4 * n,
             "stat_warps": work(tiers["stat_warps"])[1],
             "stat_blocks": work(tiers["stat_blocks"])[1]}
    chain = {k: int(counts[sel].max()) if sel.any() else 0 for k, sel in tiers.items()}
    return {k: (n_bytes[k] / HBM_BYTES_PER_S * 1e3, n_ops[k] / INT32_OPS_PER_S * 1e3,
                chain.get(k, 0) * FADD_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3) for k in cs.KERNELS}


def call_stats_kernel_bounds(counts, n):
    """{kernel: (bound ms, "bytes" or "operations")}: the larger of
    call_stats_kernel_parts' three (a chain's latency is of operations)."""
    out = {}
    for k, (by_bytes, by_ops, by_chain) in call_stats_kernel_parts(counts, n).items():
        bound = max(by_bytes, by_ops, by_chain)
        out[k] = (bound, "bytes" if by_bytes >= bound else "operations")
    return out


def launch_us(fn, kernels, tries=5):
    """{kernel: device us of one launch} of kernels that fn() launches once
    each, from tools/time_call_stats.by_kernel: the mean over the launches
    the profiler recorded. It drops device events at times (a run that kept
    1 of 10 calls' kernels), so a launch's mean is read, not the sum over
    the calls; the profile is retaken while a kernel has no launch in it,
    and the script fails after `tries`."""
    from sniffles_tpu_torch.tools.time_call_stats import by_kernel
    for _ in range(tries):
        split = by_kernel(fn)
        seen = {k: [(us, n) for name, (us, n) in split.items() if k in name] for k in kernels}
        if all(sum(n for _, n in v) > 0 for v in seen.values()):
            return {k: sum(us for us, _ in v) / sum(n for _, n in v) for k, v in seen.items()}
    fail(f"torch.profiler recorded no launch of one of {kernels} in {tries} profiles")


def time_call_stats(clustered, chain, relax, params, ptxas_log):
    """(a) and (d) of the call statistics and their timing in [10d]: the
    kernels held against the plain version on the tiled chain's 2^21 slots
    (fused) and on the crafted batches of tests/test_torch_call_stats.py
    (both settings), the tier and huge batches among them; then, on the
    step's 2^21 clustered batch, the wrapper's and the kernels' CUDA-event
    times, the plain version's on the card, their bounds, no host
    synchronisation in the wrapper, and the engine step's statistics stage
    (tools/profile_engine.py: its kernels' device time and launches); the
    kernels alone on tools/time_call_stats.py's populations (each held
    first); each kernel's device time (torch.profiler) and bound, on the
    step's batch (stat_blocks on the tiled chain, whose clusters are its
    tier's), and ptxas's registers and spills. Returns the JSON rows
    {"call_stats": the wrapper's, kernel: its own}."""
    from sniffles_tpu_torch.ops import call_stats as tcs, clustering as tc
    from sniffles_tpu_torch.sim import call_stats_batch
    from sniffles_tpu_torch.spans import STATS
    from sniffles_tpu_torch.tools.profile_engine import profile
    from sniffles_tpu_torch.tools.time_call_stats import populations
    n = clustered["pos"].shape[0]
    chain_cl = tc.cluster_signatures(chain, minsvlen=params["minsvlen"],
                                     cluster_merge_len=params["cluster_merge_len"],
                                     exact_sweep=False, **{k: v for k, v in relax.items()
                                                           if k != "global_repeat"})
    chain_cl.pop("merge_rounds")
    err = hold_call_stats(chain_cl, tcs.launch_call_statistics(chain_cl, True), True,
                          f"the tiled chain n={n} (fused)")
    chain_counts = tcs.call_statistics_plain({k: v.cpu() for k, v in chain_cl.items()},
                                             True)["lead_count"].numpy()
    crafted = (("edge", 8192, 4), ("edge", 8192, 5), ("random", 8192, 3), ("tiers", 65536, 8),
               ("huge", 32768, 9), ("sums", 65536, 10))
    for kind, size, seed in crafted:
        b = {k: torch.as_tensor(v).cuda() for k, v in call_stats_batch(kind, size, seed).items()}
        for fused in (False, True):
            err = max(err, hold_call_stats(b, tcs.launch_call_statistics(b, fused), fused,
                                           f"{kind} {size} seed {seed} (fused={fused})"))
    print(f"  call_stats held against its plain version on the tiled chain n={n} (fused; "
          f"largest cluster {int(chain_counts.max())}) and on "
          f"{', '.join(f'{k} {z} seed {d}' for k, z, d in crafted)} (fused and unfused; tiers "
          f"{'/'.join(map(str, tcs.TIERS))}): == plain on CPU copies, every key "
          f"and slot; integer keys == plain on the card, float32 keys within {err:.3g} of it",
          flush=True)

    inputs = tcs.kernel_inputs(clustered)
    nc = clustered["n_clusters"]
    ms = queued_ms(lambda: tcs.launch_call_statistics(clustered, True), 10)
    kernels_ms = queued_ms(lambda: tcs.launch_kernels(inputs, nc, True), 10)
    call_ms = cuda_ms(lambda: tcs.launch_call_statistics(clustered, True), 10)
    plain_ms = cuda_ms(lambda: tcs.call_statistics_plain(clustered, True), 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tcs.launch_call_statistics(clustered, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    bound, bound_by = call_stats_bound_ms(n, CALL_STATS_BYTES)
    kbound, kbound_by = call_stats_bound_ms(n, CALL_STATS_KERNEL_BYTES)
    # the library call beside the run pass: every slot's run start by
    # torch.searchsorted of the sorted keys (the invalid marks aside); and
    # the parent's masking ahead of the sort, beside stat_keys
    keys_s = inputs["sort"][0]
    slot_ids = torch.arange(n + 1, dtype=torch.int32, device=keys_s.device)
    search_ms = queued_ms(lambda: torch.searchsorted(keys_s, slot_ids), 10)
    where_ms = queued_ms(lambda: torch.where(inputs["valid"], inputs["cluster_id"], 2 ** 31 - 1),
                         10)
    fig = profile(n, 1, "cuda")
    us, launches, _, _ = fig["split"].get(STATS, (0.0, 0.0, {}, 0.0))
    print(f"  call_stats n={n} ({int(nc)} clusters): the wrapper (the sort's keys, the sort, the "
          f"run pass, the slot pass, the warp and block tiers; no memset) {ms:.4f} ms on the "
          f"device ({call_ms:.4f} ms a call), the kernels after the sort {kernels_ms:.4f} ms; "
          f"torch.searchsorted of the sorted keys for 0..n {search_ms:.4f} ms, torch.where of "
          f"the ids {where_ms:.4f} ms; plain "
          f"{plain_ms:.2f} ms on the card; no host synchronisation (sync debug mode 'error'); "
          f"bound {bound * 1e3:.3f} us ({bound_by}: {CALL_STATS_BYTES * n} bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {CALL_STATS_OPS_PER_ELEMENT * n} int32 ops at "
          f"{INT32_OPS_PER_S / 1e12:.1f} Tops/s), {bound / ms:.3%} of it; the kernels' bound "
          f"{kbound * 1e3:.3f} us ({kbound_by}: {CALL_STATS_KERNEL_BYTES * n} bytes), "
          f"{kbound / kernels_ms:.3%} of it", flush=True)
    print(f"  the engine step's statistics stage (tools/profile_engine.py, 1 profiled step): "
          f"{us / 1e3:.4f} ms of kernels in {launches:.0f} launches; "
          f"the step between CUDA events "
          + ", ".join(f"{label} {min(w for w, _ in rows):.4f} ms"
                      for label, rows in fig["turns"].items()), flush=True)

    for case, c in populations(n, "cuda").items():
        hold_call_stats(c, tcs.launch_call_statistics(c, True), True, f"population {case}")
        c_inputs = tcs.kernel_inputs(c)
        c_ms = queued_ms(lambda: tcs.launch_kernels(c_inputs, c["n_clusters"], True), 10)
        print(f"    population {case}: == plain; the kernels alone {c_ms:.4f} ms", flush=True)

    # each kernel: its device time on the step's batch (stat_blocks: on the
    # tiled chain), beside its bound on the same data and the whole plain
    # version's time there
    counts = tcs.call_statistics_plain({k: v.cpu() for k, v in clustered.items()},
                                       True)["lead_count"].numpy()
    split = launch_us(lambda: tcs.launch_call_statistics(clustered, True), tcs.KERNELS)
    chain_split = launch_us(lambda: tcs.launch_call_statistics(chain_cl, True), tcs.KERNELS)
    chain_plain_ms = cuda_ms(lambda: tcs.call_statistics_plain(chain_cl, True), 3)
    bounds = call_stats_kernel_bounds(counts, n)
    chain_bounds = call_stats_kernel_bounds(chain_counts, n)
    parts = call_stats_kernel_parts(counts, n)
    chain_parts = call_stats_kernel_parts(chain_counts, n)
    rows = {"call_stats": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                           "bound_by": bound_by, "max_abs_err": 0}}
    for k in tcs.KERNELS:
        on_chain = k == "stat_blocks"
        k_us = (chain_split if on_chain else split)[k]
        k_bound, k_by = (chain_bounds if on_chain else bounds)[k]
        rows[k] = {"ms": k_us / 1e3, "plain_ms": chain_plain_ms if on_chain else plain_ms,
                   "bound_ms": k_bound, "bound_by": k_by, "max_abs_err": 0,
                   "library_ms": search_ms if k == "stat_runs" else None}
        by_bytes, by_ops, by_chain = (chain_parts if on_chain else parts)[k]
        print(f"  {k} ({'the tiled chain' if on_chain else 'the step batch'}, n={n}): "
              f"{k_us / 1e3:.4f} ms on the device (torch.profiler); bound "
              f"{k_bound * 1e3:.3f} us ({k_by}; the larger of bytes {by_bytes * 1e3:.3f} us, "
              f"operations {by_ops * 1e3:.3f} us and the longest chain's latency "
              f"{by_chain * 1e3:.3f} us), {k_bound * 1e3 / max(k_us, 1e-9):.3%} of it; the bytes "
              f"alone {by_bytes * 1e3 / max(k_us, 1e-9):.3%} of it; ptxas: "
              f"{ptxas_summary(ptxas_log, k)}", flush=True)
    # max_abs_err: against the plain version on the same inputs (CPU
    # copies), held bit for bit above
    return rows


def run_engine(tmp, dense_bam, ptxas_log, stats_ptxas_log):
    """Phase 10 (see the module's docstring). Returns (the kernels' launches
    on its main path, the timing rows of both kernels)."""
    from sniffles_tpu_torch.ops import call_stats as cs
    from sniffles_tpu_torch.ops import candidate_tail as ct, merge_relax as tmr
    from sniffles_tpu_torch.ops.qc_batch import FILTERS
    from sniffles_tpu_torch.parallel.engine import default_params
    from sniffles_tpu_torch.signatures import from_leads, synthetic_batch

    from sniffles_tpu_torch.ops import cluster_sorts as cso
    t_phase = time.perf_counter()
    tmr.reset_counts()
    ct.reset_counts()
    cs.reset_counts()
    cso.reset_counts()
    stats_launches = {}
    header("[10a] the whole step on the card against the CPU", flush=True)
    sizes = [("graft entry 4096", 4096, 64, 7), ("bench 2^16", 1 << 16, (1 << 16) // 40, 42),
             ("bench 2^21", 1 << 21, (1 << 21) // 40, 42)]
    params = default_params()
    coverage = np.full(1_000_000, 30, dtype=np.int32)
    big = None
    for label, n, ncl, seed in sizes:
        batch = synthetic_batch(n, ncl, seed=seed, genome_span=900_000, batch_size=n).as_dict()
        kept = []
        with kept_call_stats(kept):
            out, rounds, cpu_s, card_s, want = engine_step_pair(batch, coverage, params,
                                                                label)
        print(f"    {label}: {int(out['n_clusters'])} clusters, {rounds} relaxation rounds, "
              f"{int(out['cluster_valid'].sum())} valid, {int(out['qc'].sum())} PASS; card == "
              f"CPU on every key (CPU {cpu_s:.2f} s, card {card_s:.3f} s with the copies)",
              flush=True)
        calls, err = hold_kept_call_stats(kept, f"the engine's {label} (fused)")
        print(f"    [a] {label}: the step's {calls} call-statistics call held: kernels == plain "
              f"version on CPU copies, every key and slot; integer keys == plain on the card, "
              f"float32 keys within {err:.3g} of it", flush=True)
        big, big_want = batch, want
    stats_launches["10a"] = cs.COUNTS["launches"]

    header("[10b] dense3's chr1 signatures (the port's lead provider) under three flag sets",
          flush=True)
    t0 = time.perf_counter()
    from sniffles_tpu_torch.tools.profile_engine import dense_chr1
    leads, chr1_cov, nm = dense_chr1(dense_bam)
    sig = from_leads(leads).as_dict()
    print(f"    {len(leads)} leads in {sig['pos'].shape[0]} slots, coverage mean "
          f"{chr1_cov.mean():.2f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for flags in ([], ["--mosaic"], ["--minsupport", "auto", "--qc-nm"]):
        p = engine_flag_params(flags, chr1_cov, nm)
        out, rounds, cpu_s, card_s, _ = engine_step_pair(sig, chr1_cov, p,
                                                         f"dense3 chr1 {flags}")
        valid = out["cluster_valid"].cpu()
        codes = np.bincount(out["filter_code"].cpu()[valid].numpy(), minlength=len(FILTERS))
        print(f"    {' '.join(flags) or 'default'}: {int(out['n_clusters'])} clusters, "
              f"{int(valid.sum())} valid, {rounds} rounds; card == CPU on every key; filter "
              f"codes " + ", ".join(f"{FILTERS[i]} {c}" for i, c in enumerate(codes) if c),
              flush=True)
    stats_launches["10b"] = cs.COUNTS["launches"] - stats_launches["10a"]

    header(f"[10c] the sharded step, {ENGINE_SHARDS} shards on cuda:0 against "
          f"{ENGINE_SHARDS} CPU shards", flush=True)
    d_sig, d_cov, d_offs = dryrun_shards(os.path.join(tmp, "dryrun"))
    kept = []
    with kept_call_stats(kept):
        out, card_s, cpu_s = sharded_pair(d_sig, d_cov, d_offs, "dryrun_multichip's recipe",
                                          halo_bp=2000, halo_slots=64)
    print(f"    dryrun_multichip's recipe: clusters a shard {out['n_clusters'].tolist()}, "
          f"owned {int(out['cluster_valid'].sum())}, halo_overflow "
          f"{out['halo_overflow'].tolist()}; integer outputs == ({card_s:.3f} s card, "
          f"{cpu_s:.3f} s CPU)", flush=True)
    w_sig, w_cov, w_offs = window_shards(leads, chr1_cov, 500_000)
    with kept_call_stats(kept):
        out, card_s, cpu_s = sharded_pair(w_sig, w_cov, w_offs, "dense3 chr1 in 4 windows",
                                          halo_bp=5000, halo_slots=512)
    print(f"    dense3 chr1 in {ENGINE_SHARDS} windows of 500 kb "
          f"({w_sig['pos'].shape[0] // ENGINE_SHARDS} slots a shard): clusters a shard "
          f"{out['n_clusters'].tolist()}, owned {int(out['cluster_valid'].sum())}, "
          f"halo_overflow {out['halo_overflow'].tolist()}; integer outputs == "
          f"({card_s:.3f} s card, {cpu_s:.3f} s CPU)", flush=True)
    stats_launches["10c"] = cs.COUNTS["launches"] - stats_launches["10a"] - stats_launches["10b"]
    launches = {"merge_relax": tmr.COUNTS["launches"], "candidate_tail": ct.COUNTS["launches"],
                "call_stats": cs.COUNTS["launches"], **{k: cs.COUNTS[k] for k in cs.KERNELS},
                **{k: cso.COUNTS[k] for k in cso.KERNELS}}
    print(f"    the main path of [10a-c] launched {launches}; call_stats by part "
          f"{stats_launches}", flush=True)
    if min(launches.values()) < 1 or min(stats_launches.values()) < 1:
        fail(f"phase 10's main path left a kernel unlaunched: {launches}, {stats_launches}")
    calls, err = hold_kept_call_stats(kept, "the sharded step's shards (fused)")
    print(f"    [c] the sharded steps' {calls} call-statistics calls held: kernels == plain "
          f"version on CPU copies; integer keys == plain on the card, float32 keys within "
          f"{err:.3g} of it", flush=True)

    header("[10d] timings at 2^21 signatures", flush=True)
    rows = time_engine_kernels(big, coverage, params, ptxas_log, stats_ptxas_log, big_want)
    print(f"    phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, rows


# -- phase 11 ---------------------------------------------------------------

# the port's benchmark, cut to fit the smoke run (the full legs are a run
# of `python -m sniffles_tpu_torch.bench` of their own)
BENCH_SMOKE_ENV = {"BENCH_CONTIGS": "1", "BENCH_PAIRS": "1", "BENCH_SKIP_SCALE": "1",
                   "BENCH_SKIP_COMBINE": "1"}
FUZZ_SMOKE_ARGS = ("1", "1000")


def run_port_child(args, env_extra, timeout, what):
    """`python -m ARGS` in a child process with this checkout first on its
    path; returns its standard output. Fails, with the end of its error
    output, when it exits non-zero."""
    from sniffles_tpu_torch.bench import child_env
    env = child_env({"SNIFFLES_TPU_FORCE_CPU": None, **env_extra})
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, env=env,
                       timeout=timeout)
    print(f"    {what}: exit {p.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if p.returncode != 0:
        print(p.stdout[-3000:])
        print(p.stderr[-6000:])
        fail(f"{what} exited {p.returncode}")
    return p.stdout


def run_bench_and_fuzz(dense_tmp, smi):
    """Phase 11: the port's benchmark at the smoke run's cut, its dense leg
    on phase 4's dense3 files, then the 1-seed differential fuzz."""
    from sniffles_tpu_torch.bench import records_differ
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        out = run_port_child(["sniffles_tpu_torch.bench"],
                             {**BENCH_SMOKE_ENV, "TMPDIR": tmp, "BENCH_DENSE_DIR": dense_tmp},
                             900, "the bench")
    lines = out.splitlines()
    if len(lines) != 1:
        fail(f"the bench printed {len(lines)} lines on stdout, not one JSON line")
    r = json.loads(lines[0])
    for leg in ("e2e_pairs", "e2e_dense_pairs"):
        p = r[leg]
        print(f"    {leg}: host median {p['host_median']} s, device median {p['tpu_median']} "
              f"s, deltas {p['pair_deltas']}, device wins {p['tpu_wins']}, warmups "
              f"{p['warmup_runs']}", flush=True)
    print(f"    engine: {r['device_sig_per_sec_equal']:.4g} signatures/s at "
          f"{r['equal_workload_signatures']}, {r['device_sig_per_sec_peak']:.4g} at the peak "
          f"size; host chain {r['host_sig_per_sec_equal']:.4g}; daemon start-to-ping "
          f"{r['tpu_daemon_warm_s']} s; daemon stats {json.dumps(r['device_service_stats'])}",
          flush=True)
    differ = records_differ(r)
    if differ or not any(k.endswith("records_identical") for k in r):
        fail(f"the bench's device records differ from its host records: {differ}")
    for key in ("e2e_seconds_ours_tpu", "e2e_dense_seconds_ours_tpu", "e2e_seconds_ours",
                "e2e_dense_seconds_ours", "device_sig_per_sec_equal",
                "device_sig_per_sec_peak", "host_sig_per_sec_equal"):
        if not (r.get(key) or 0) > 0:
            fail(f"the bench's {key} is {r.get(key)!r}")
    stats = r["device_service_stats"]
    if stats["device"] != "cuda" or stats["kernel_merge_sweep"] < 1:
        fail(f"the bench's daemon did not serve its device legs on the card: {stats}")
    if r["device"] != smi:
        fail(f"the bench's device line {r['device']!r} is not nvidia-smi's {smi!r}")
    out = run_port_child(["sniffles_tpu_torch.tools.diff_fuzz", *FUZZ_SMOKE_ARGS], {}, 900,
                         "the differential fuzz, device path against host path")
    print("    " + out.strip().replace("\n", "\n    "), flush=True)
    if not out.strip().endswith(f"all {FUZZ_SMOKE_ARGS[0]} seeds OK"):
        fail("the differential fuzz did not end with every seed equal")
    print(f"    phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def sync_sites(fn):
    """Runs fn() on the card with torch.cuda.set_sync_debug_mode("warn")
    and returns the synchronising operations it reached, counted by the
    line of the port that called them."""
    import warnings
    from collections import Counter
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return Counter(f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
                   if "synchroniz" in str(w.message))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke run needs a card",
              file=sys.stderr)
        return 2
    os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
    # phase 9's shards, for every process of the script (a run without
    # --tpu-mesh never reads it)
    os.environ["SNIFFLES_TPU_MESH_DEVICES"] = MESH_DEVICES
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import call_stats as cs
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    from sniffles_tpu_torch.ops import combine_greedy as cg
    from sniffles_tpu_torch.ops import edit_distance_batch as ted
    from sniffles_tpu_torch.tools.time_combine_greedy import captured_dispatches

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    header(f"[1] card: {smi} | torch {torch.__version__} (CUDA {torch.version.cuda}) "
          f"| {name} | count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    # the native host library (host compiler) builds beside the nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(_build.build_host)
        logs = _build.build_all(ptxas_verbose=True)
        host_lib = host_build.result()
    header(f"[1] built {', '.join(logs)} and the native host library "
          f"{os.path.relpath(host_lib)} ({_build.host_cxx()}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    header("[2] edit-distance kernel against its plain version", flush=True)
    rng = np.random.default_rng(7)
    max_err = 0
    for L, B in ((128, 4096), (1024, 4096), (2560, 2048), (4096, 2048)):
        pairs = (random_pairs(rng, B // 2, L, related=False)
                 + random_pairs(rng, B - B // 2, L, related=True) + edge_pairs(L))
        pairs = [(x.encode(), y.encode()) for x, y in pairs]
        max_err = max(max_err, check_ed_kernel(pairs, L, f"L={L}", len(pairs) // 100))
    max_err = max(max_err, check_ed_kernel(special_pairs(rng), 4096,
                                           "word boundaries, alphabets, 60/4095 mix", 1))

    header("[2b] merge-sweep kernel against its plain version", flush=True)
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

    header("[2d] the combine greedy's kernels (grid and flush) against their plain versions",
          flush=True)
    greedy_max_err = check_greedy_kernels()

    header("[2e] the clustering's segmented sorts (csrc/cluster_sorts.cu) against their plain "
          "versions", flush=True)
    check_cluster_sorts(meta)

    header(f"[3] combine: {COHORT_SAMPLES}-sample cohort, 2 contigs of 1 Mb", flush=True)
    with kept_dir("chip_smoke_") as tmp:
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
        cg.reset_counts()
        ted.edit_distance_batch_device = keep_largest
        try:
            # every greedy dispatch kept: its payload and the card's result
            with captured_dispatches() as greedy_kept:
                dev_wall, dev_counters = run_cli(["--input", *snfs, "--vcf", dev_vcf], [],
                                                 os.path.join(tmp, "c1.json"), "combine")
        finally:
            ted.edit_distance_batch_device = wrapper
        launches, cells = ted.COUNTS["launches"], ted.COUNTS["cells"]
        greedy_counts = dict(cg.COUNTS)
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
        if not (greedy_counts["launches"] == len(greedy_kept)
                == dev_counters["combine_greedy_dispatches"]):
            fail(f"the greedy kernel launched {greedy_counts} for "
                 f"{dev_counters['combine_greedy_dispatches']} dispatches, {len(greedy_kept)} "
                 f"kept")
        greedy_max_err = max(greedy_max_err, hold_greedy_dispatches(greedy_kept, "combine256"))
        print(f"    device VCF == host VCF; {len(greedy_kept)} greedy dispatches, one kernel "
              f"launch each ({greedy_counts}), each == plain on the CPU (bit-exact)",
              flush=True)

        header("[3b] combine with --threads 4 in a child process (the worker pool and the "
              "parent's device service)", flush=True)
        t4_vcf, t0_vcf = os.path.join(tmp, "threads4.vcf"), os.path.join(tmp, "threads0.vcf")
        wall4, c4, timing4 = run_child(["--input", *snfs, "--vcf", t4_vcf, "--threads", "4"],
                                       os.path.join(tmp, "c3.json"), "combine --threads 4")
        ed_launches = c4.get("kernel_ed_myers", 0)
        greedy_launches = c4.get("kernel_combine_greedy", 0)
        wall0, _, timing0 = run_child(["--input", *snfs, "--vcf", t0_vcf, "--threads", "0"],
                                      os.path.join(tmp, "c4.json"), "combine --threads 0")
        print(f"    threads 4 {wall4:.2f} s ({timing4}), threads 0 {wall0:.2f} s ({timing0}), "
              f"each a child process from start to end (threads 0 in process: "
              f"{dev_wall:.2f} s)", flush=True)
        print(f"    service and parent " + json.dumps(
            {k: v for k, v in c4.items() if k.startswith(("service_", "kernel_"))},
            sort_keys=True), flush=True)
        print("    edit-distance batches, threads 0 | threads 4: " + ", ".join(
            f"{k} {dev_counters.get(k, 0)} | {c4.get(k, 0)}"
            for k in ("ed_device_batches", "ed_device_pairs", "ed_device_cells",
                      "ed_host_batches", "ed_host_pairs", "combine_greedy_dispatches")),
            flush=True)
        if vcf_parts(t4_vcf) != dev_parts or vcf_parts(t0_vcf) != dev_parts:
            fail("combine --threads 4 or 0 in a child process: VCF differs from the device "
                 "and host VCFs")
        if ed_launches < 1:
            fail("combine --threads 4: the parent never launched the edit-distance kernel")
        print(f"    threads-4 VCF == device VCF == host VCF; "
              f"{check_greedy_counters(c4, 'combine --threads 4')}", flush=True)

    header(f"[4] call_sample: {DENSE_CONTIGS} contigs of {DENSE_REF_LEN // 1_000_000} Mb, "
          f"depth {DENSE_DEPTH}, seed {DENSE_SEED} (the dense bench leg)", flush=True)
    with kept_dir("chip_smoke_call_") as tmp:
        dense_tmp = tmp
        cso.reset_counts()
        (sweep_largest, _, err, dense_args, dense_kept, dense_wall,
         dense_stages) = run_dense_call(tmp, meta)
        sort_launches = dict(cso.COUNTS)
        check_sort_launches(sort_launches, DENSE_CONTIGS, "call_sample (in process)")
        print(f"    the segmented sorts on the main path (the {DENSE_CONTIGS} call tasks): "
              f"{sort_launches}", flush=True)
        sweep_err = max(sweep_err, err)
        header("[4b] call_sample, the default command line (--threads 4), in a child "
              "process", flush=True)
        sweep_launches, err = run_dense_threaded(tmp, dense_args, meta, dense_wall)
        sweep_err = max(sweep_err, err)
        header("[7a] dense3 as a reference-based CRAM; [7b] dense3 with --no-native",
              flush=True)
        err = run_dense_cram(tmp, dense_args, meta, dense_wall, dense_stages)
    sweep_err = max(sweep_err, err)

    header("[2c] the batched merge sweep (k tasks of one width, one launch of each kernel) "
          "against the single-task kernel and the plain version", flush=True)
    dense32 = [tuple({k: v.cuda() for k, v in d.items()} for d in launch[:2])
               for launch in dense_kept if launch[0]["seed_type"].shape[0] == 32768]
    fuzz32 = [sweep_case(fuzz_call_batch(seed, 32768), meta) for seed in (1, 2)]
    pad32 = sweep_case(np.zeros((15, 32768), dtype=np.int32), meta)
    if len(dense32) != 2:
        fail(f"the dense leg gave {len(dense32)} sweeps of width 32768, not 2")
    stacks = {"k=2 fuzz seeds 1, 2": fuzz32,
              "k=2 dense tasks 0, 1": dense32,
              "k=4 fuzz seed 1, dense tasks 0, 1, zero pad": [fuzz32[0], *dense32, pad32],
              "k=4 fuzz seeds 1, 2, dense tasks 0, 1": [*fuzz32, *dense32]}
    for label, tasks in stacks.items():
        sweep_err = max(sweep_err, check_batched_sweep(tasks, meta, label))

    header(f"[6] the other run modes: --snf, .vcf.gz, population SNF and --genotype-vcf on "
          f"{len(MODES_SEEDS)} samples of {MODES_REF_LEN // 1_000_000} Mb at depth "
          f"{MODES_DEPTH}", flush=True)
    with kept_dir("chip_smoke_modes_") as tmp:
        modes_tmp = tmp
        err, ed_err = run_modes(tmp, meta)
        header(f"[7d] --dev-cache: sample {MODES_SEEDS[0]} twice", flush=True)
        run_dev_cache(tmp)
    sweep_err = max(sweep_err, err)
    max_err = max(max_err, ed_err)
    header("[7c] --dev-locasm-do: a filtered INS and DEL, device and host paths",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_locasm_") as tmp:
        sweep_err = max(sweep_err, run_locasm(tmp, meta))

    header("[8a] the wall of a child process in parts (its log lines stamped on arrival), "
          "phases 3b and 4b, before any daemon code ran", flush=True)
    columns = [("dense3 t4", "call_sample (default --threads)"),
               ("dense3 t0", "call_sample --threads 0"),
               ("combine256 t4", "combine --threads 4")]
    print_splits(columns)
    header("[8] the device daemon: one process that holds the card and serves the CLI runs "
          "(each with no card visible)", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_daemon_") as tmp:
        daemon_launches, err, e = run_daemon(tmp, meta, (dense_tmp, dense_args),
                                             (snfs, dev_vcf), modes_tmp)
    sweep_err = max(sweep_err, err)
    max_err = max(max_err, e)
    header("[8a] the same splits without and with the daemon (served: the runs of [8])",
          flush=True)
    print_splits([columns[0], ("served", "dense3 --threads 4, served"), columns[1],
                  ("served", "dense3 --threads 0, served"), columns[2],
                  ("served", "combine256 --threads 4, served")])

    header(f"[9] --tpu-mesh {MESH_SHARDS}: {MESH_SHARDS} genome shards on the card",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh_launches, err, e = run_mesh(tmp, meta, (dense_tmp, dense_args),
                                         (snfs, dev_vcf))
    sweep_err = max(sweep_err, err)
    max_err = max(max_err, e)
    print(f"    the mesh's main path (dense3 --tpu-mesh {MESH_SHARDS} --threads 4) launched "
          f"{mesh_launches}", flush=True)

    header("[10] the fused calling engine (parallel/engine.py) and its kernels (the relaxation, "
          "the call statistics, the candidate tail)", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as tmp:
        engine_launches, engine_rows = run_engine(tmp, dense_args[1], logs["candidate_tail"],
                                                  logs["call_stats"])

    header("[11] the port's benchmark (python -m sniffles_tpu_torch.bench, cut: quick leg on "
          f"{BENCH_SMOKE_ENV['BENCH_CONTIGS']} contig, {BENCH_SMOKE_ENV['BENCH_PAIRS']} pair, no "
          "scale or combine leg) and its differential fuzz, each in a child process",
          flush=True)
    run_bench_and_fuzz(dense_tmp, smi)

    header("[5] kernel timings on the main paths' largest launches", flush=True)
    timing = time_ed_kernel([x.cuda() for x in largest])
    max_err = max(max_err, timing["max_abs_err"])
    sweep_timing = time_sweep_kernel(*({k: v.cuda() for k, v in d.items()}
                                       for d in sweep_largest), meta)
    sweep_err = max(sweep_err, sweep_timing["max_abs_err"])
    cuts_timing = time_cuts_kernel(*({k: v.cuda() for k, v in d.items()}
                                     for d in sweep_largest), meta)
    for label, (inputs, state) in timed_cases.items():
        time_sweep_case(inputs, state, meta, label)
    greedy_timing = time_greedy_kernel(greedy_kept)
    greedy_max_err = max(greedy_max_err, greedy_timing.pop("max_abs_err"))
    fused_label = "k=4 fuzz seeds 1, 2, dense tasks 0, 1"
    time_batched_sweep(stacks[fused_label], meta, fused_label)
    sort_rows = time_cluster_sorts()
    from sniffles_tpu_torch.ops import clustering as tc
    from sniffles_tpu_torch.ops.transfer import to_device
    packed = [fuzz_call_batch(seed, 32768) for seed in (1, 2)]
    for what, fn in (("call_task_packed (fuzz n=32768 seed 1)",
                      lambda: tc.call_task_packed(to_device(packed[0], "cuda"), **meta)),
                     ("batched_call_task (k=2, fuzz seeds 1, 2)",
                      lambda: tc.batched_call_task(tuple(sorted(meta.items())),
                                                   to_device(np.stack(packed), "cuda")))):
        sites = sync_sites(fn)
        print(f"  host synchronisations of {what}: {sum(sites.values())}"
              + "".join(f"; {site} x{count}" for site, count in sorted(sites.items())),
              flush=True)
    kernels = [{
        "name": "edit_distance_myers", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/edit_distance.cu",
        "replaces": "sniffles_tpu/ops/edit_distance_jax.py:37",
        "launches": ed_launches, "max_abs_err": max_err,
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
        "library_ms": None}, {
        "name": "merge_relax", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/merge_relax.cu",
        "replaces": "sniffles_tpu/ops/clustering.py:709",
        "launches": engine_launches["merge_relax"], "max_abs_err": 0,
        **engine_rows[0], "library_ms": None}, {
        "name": "candidate_tail", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/candidate_tail.cu",
        "replaces": "sniffles_tpu/parallel/engine.py:133",
        "launches": engine_launches["candidate_tail"], "max_abs_err": 0,
        **engine_rows[1], "library_ms": None}, {
        "name": "tail_runs", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/candidate_tail.cu",
        "replaces": "sniffles_tpu/ops/clustering.py:1296",
        "launches": engine_launches["candidate_tail"], **engine_rows[3]}, {
        "name": "call_stats", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/call_stats.cu",
        "replaces": "sniffles_tpu/ops/clustering.py:1262",
        "launches": engine_launches["call_stats"],
        **engine_rows[2]["call_stats"], "library_ms": None}] + [{
        "name": k, "route": "cuda", "source": "sniffles_tpu_torch/csrc/call_stats.cu",
        "replaces": "sniffles_tpu/ops/clustering.py:1262", "launches": engine_launches[k],
        **engine_rows[2][k]} for k in cs.KERNELS] + [{
        "name": "combine_greedy", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/combine_greedy.cu",
        "replaces": "sniffles_tpu/ops/combine_greedy.py:180",
        "launches": greedy_launches, "max_abs_err": greedy_max_err, **greedy_timing,
        "library_ms": None}] + [{
        "name": k, "route": "cuda", "source": "sniffles_tpu_torch/csrc/cluster_sorts.cu",
        "replaces": SORT_REPLACES[k], "launches": sort_launches[k] + engine_launches[k],
        **sort_rows[k]} for k in cso.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-child"]:
        cli_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--daemon-child"]:
        daemon_child(sys.argv[2], sys.argv[3:])
    sys.exit(main())
