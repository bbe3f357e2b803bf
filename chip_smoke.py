#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sniffles_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. set-up: the card's name and power limit; build every CUDA kernel of
     the port from csrc/ (one nvcc per source, started together), with
     ptxas's register and shared-memory report;
  2. each kernel against its plain PyTorch version on the card, bit for
     bit, at the main path's shapes and edge cases (lengths at 32-bit word
     boundaries, alphabets beyond ACGT, a batch mixing 60 bp and 4,095 bp
     pairs), a subsample against the host Myers scan, and timings (CUDA
     events) beside the bound;
  3. the main path: a 256-sample cohort written by sniffles_tpu_torch.sim,
     combined into a multi-sample VCF on the card (the device greedy and
     the edit-distance kernel) and again on the host path (--no-tpu); the
     two VCFs must be identical, and the kernel must have been launched
     by the device run.
Then it prints one JSON line of kernel figures, the nvidia-smi name and
power-limit line, and, last, {"ok": true, "device": {...}}. Without a
card it exits non-zero before any of that.
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


def run_combine(snfs, vcf, extra, counters_path):
    """The port's CLI in this process; its log goes to a buffer that is
    printed only when the run fails."""
    from sniffles_tpu_torch import cli
    os.environ["SNIFFLES_TPU_COUNTERS_JSON"] = counters_path
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["--input", *snfs, "--vcf", vcf, "--threads", "0",
                       "--allow-overwrite", *extra])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-6000:])
        fail(f"combine {' '.join(extra) or '(device path)'} exited {rc}")
    counters = {}
    if os.path.exists(counters_path):   # written only when a task counted
        with open(counters_path) as f:
            counters = json.load(f)
    return wall, counters


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

    print(f"[3] main path: {COHORT_SAMPLES}-sample cohort, 2 contigs of 1 Mb", flush=True)
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
            dev_wall, dev_counters = run_combine(snfs, dev_vcf, [],
                                                 os.path.join(tmp, "c1.json"))
        finally:
            ted.edit_distance_batch_device = wrapper
        launches, cells = ted.COUNTS["launches"], ted.COUNTS["cells"]
        peak = torch.cuda.max_memory_allocated()
        host_wall, host_counters = run_combine(snfs, host_vcf, ["--no-tpu"],
                                               os.path.join(tmp, "c2.json"))
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

    timing = time_ed_kernel([x.cuda() for x in largest])
    max_err = max(max_err, timing["max_abs_err"])
    kernels = [{
        "name": "edit_distance_myers", "route": "cuda",
        "source": "sniffles_tpu_torch/csrc/edit_distance.cu",
        "replaces": "sniffles_tpu/ops/edit_distance_jax.py:37",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
