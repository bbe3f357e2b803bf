"""
Device-owned multi-sample combine grouping: an EXACT emulation of the
host's sequential greedy assignment (cluster.resolve_block_groups,
reference: cluster.py:356-390), in PyTorch on the run's device. The
port of sniffles_tpu/ops/combine_greedy.py::_greedy_grid_loop and its
dispatch (start_combine_greedy_task / run_combine_greedy_task), the
combine path's whole-task greedy, and of the sequential greedy of one
flush, _greedy_loop and run_combine_greedy, which the device service
answers as the combine_greedy request kind (no CLI path posts it, in
either package). Both loops take their step from _greedy_step.

The host greedy walks candidates in support-descending order; each
candidate joins the best existing group by
``dist = |pos_mean - pos| + |len_mean - |svlen||`` subject to
``dist <= combine_match * sqrt(min(len_mean, |svlen|))``, capped at
``combine_match_max``, a sequence-identity gate (edit distance of the
candidate alt against the GROUP HEAD's alt, sv.py:280-301), and strict
improvement (ties keep the earliest group in list order). Group means
evolve as candidates join (sv.py:303-313).

* Group state is kept as INTEGER sums (pos_sum, len_sum, n) in
  segment-local coordinates, so distances are exact rationals D/n.
* Cross-group comparisons use an int32-exact total-order key:
  ``key = (D//n) * 2^20 + ((D%n) * 2^20) // n``. Two distinct rational
  distances with denominators <= NMAX=1024 differ by >= 2^-20, so the
  floor-scaled fraction separates them; equal rationals map to equal
  keys; argmin's first-minimum tie-break is exactly the host's
  earliest-group-wins rule.
* The sqrt threshold (a correctly rounded float32 square root,
  ops/segments.sqrt_f32) and the identity-ratio gate are evaluated in
  float32 where the host uses float64; probes within a ~1e-5 relative
  window of either threshold raise the segment's `ambiguous` flag and
  the caller replays that segment on the exact host greedy. All float
  constants are float32 tensors, as JAX's weak types make them.
* The identity gate reads a PRECOMPUTED exact edit-distance table; a
  probe whose pair is missing raises the `ed_miss` flag.

`_greedy_grid_loop` and `_greedy_loop` are the wrappers: on CPU tensors
the plain versions (`greedy_grid_plain`, one step per candidate of the
longest segment, and `greedy_flush_plain`, one per candidate: Python
loops of tensor ops that take their bound from the host's counts), on
CUDA tensors one launch of csrc/combine_greedy.cu's kernel (`greedy_grid`,
a warp a segment row, each row run to its own count; `greedy_flush`, one
warp), on any other device an exception. The gates' float32 constants go
to the kernel as their bits, made by torch on the host (`gate_bits`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from sniffles_tpu_torch.ops._greedy_consts import (EPS, NMAX, SCALE, SEGF_AMBIGUOUS,
                                                   SEGF_ED_MISS, SEGF_N_OVERFLOW,
                                                   TASK_ED_HEADS)
from sniffles_tpu_torch.ops.segments import sqrt_f32

INT32_MAX = 2 ** 31 - 1

# Launches by the wrappers (_greedy_grid_loop, _greedy_loop), counted only
# where they launch the kernel: "launches" one a launch of either entry
# point, "segments" the rows it ran (a grid's S, a flush's one), "steps"
# the longest row's candidates (a grid's max_count, when its caller gives
# it; a flush's c_count).
COUNTS = {"launches": 0, "segments": 0, "steps": 0}

# The kernel keeps a row's state (a record of 8 int32 a slot: psum, lsum,
# n, head; hord, and the caches of the length mean, its root and the magic
# number of a division by n) in a block's shared memory, up to 64 KB: a
# grid row always (the packer's SEG_LMAX = 2,048 keeps L within it;
# grid_inputs refuses more), the flush's one row where its G slots fit,
# else a global scratch buffer the wrapper allocates.
STATE_WORDS = 8
SHARED_STATE_MAX = 64 * 1024
# lanes of a warp: the grid's ED column is shuffled from lanes k < K
MAX_ED_HEADS = 32
# the grid greedy's inputs, in _greedy_grid_loop's order (task_grids)
GRID_KEYS = ("c_pos", "c_len", "c_alt", "c_hord", "counts", "ed")
# the -D flag of the kernel's build that sums a step's cycles by part, and
# the parts (csrc/combine_greedy.cu Part; tools/time_combine_greedy.py --split)
STEP_CLOCKS = "-DGREEDY_STEP_CLOCKS"
STEP_PARTS = ("load", "probe", "reduce", "update")


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _pow2(x: int, floor: int) -> int:
    size = floor
    while size < x:
        size *= 2
    return size


class _Gates:
    """The float32 constants of the greedy's gates on one device: float
    constants are float32 tensors, as JAX's weak types make them."""

    def __init__(self, cm: int, cmm: int, limit: float, dev):
        f32 = torch.float32
        self.cmm, self.limit = cmm, limit
        self.cm_f = torch.tensor(cm, dtype=f32, device=dev)
        self.limit_f = torch.tensor(limit, dtype=f32, device=dev)
        self.eps_f = torch.tensor(EPS, dtype=f32, device=dev)
        self.one_f = torch.tensor(1.0, dtype=f32, device=dev)
        self.zero_f = torch.tensor(0.0, dtype=f32, device=dev)
        self.tiny_f = torch.tensor(1e-9, dtype=f32, device=dev)
        # the Python double 1 + 2 EPS rounded once to float32, as JAX does
        self.forced_at = (torch.tensor(cmm, dtype=f32, device=dev)
                          * torch.tensor(1.0 + 2.0 * EPS, dtype=f32, device=dev))
        self.pass_same = bool(limit < 1.0)
        self.big = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)


def _greedy_step(st: dict, pos, ln, aid, d_ed, upd, g: _Gates):
    """One step of the greedy, shared by both loops: row r's candidate
    (pos, ln, aid: (R, 1)) probes every group slot of its row (st's
    psum, lsum, n, head: (R, G); ngroups (R,)) and joins the best one or
    founds a group at slot ngroups; rows where `upd` (R,) is false stay
    as they are. `d_ed` (R, G) is the edit distance of each group head's
    alt to the candidate's (-1 = not tabulated), read only when the
    identity gate is on (limit > 0). Updates `st` in place and returns
    (tgt (R,) the slot joined or founded, create (R, G) the founded slot,
    bits (R,) this step's SEGF_* flags)."""
    i32, f32 = torch.int32, torch.float32
    n, psum, lsum = st["n"], st["psum"], st["lsum"]
    slots = torch.arange(n.shape[1], dtype=i32, device=n.device)[None, :]
    active = (slots < st["ngroups"][:, None]) & (n > 0)

    # exact rational distance D/n per group (local coordinates keep every
    # intermediate inside int32; guarded by the packer)
    D = (psum - pos * n).abs() + (lsum - ln * n).abs()
    nf = torch.clamp(n, min=1).to(f32)
    cap_ok = D <= n * g.cmm
    shorter_pos = (lsum > 0) & (ln > 0)

    # the sqrt-scaled match radius in float32 with an ambiguity margin,
    # forced to pass where it provably clears the cap
    lmf = lsum.to(f32) / nf
    shorter_f = torch.minimum(lmf, ln.to(f32))
    thr_f = g.cm_f * sqrt_f32(torch.maximum(shorter_f, g.zero_f))
    dist_f = D.to(f32) / nf
    forced = thr_f >= g.forced_at
    pass2 = (dist_f <= thr_f) | forced
    amb2 = ((dist_f - thr_f).abs() <= g.eps_f * torch.maximum(thr_f, g.one_f)) & ~forced

    pre = active & cap_ok & shorter_pos
    if g.limit > 0:
        same = st["head"] == aid
        have = d_ed >= 0
        ratio = (lmf - d_ed.to(f32)) / torch.maximum(lmf, g.tiny_f)
        pass3 = torch.where(same, g.pass_same, have & (ratio > g.limit_f))
        amb3 = ~same & have & ((ratio - g.limit_f).abs() <= g.eps_f)
        miss_hit = (pre & pass2 & ~same & ~have).any(dim=1)
        eligible = pre & pass2 & pass3
        amb_hit = (pre & (amb2 | amb3)).any(dim=1)
    else:
        miss_hit = torch.zeros_like(upd)
        eligible = pre & pass2
        amb_hit = (pre & amb2).any(dim=1)

    # the int32-exact total-order key of D/n; argmin's first minimum is
    # the host's earliest-group-wins tie-break
    nd = torch.clamp(n, min=1)
    q = torch.div(D, nd, rounding_mode="floor")
    r = D - q * nd
    key = q * SCALE + torch.div(r * SCALE, nd, rounding_mode="floor")
    key = torch.where(eligible, key, g.big)
    best = torch.argmin(key, dim=1).to(i32)
    found = key.min(dim=1).values < INT32_MAX

    tgt = torch.where(found, best, st["ngroups"])
    onehot = (slots == tgt[:, None]) & upd[:, None]
    over = (torch.where(onehot, n, 0).max(dim=1).values + 1 > NMAX) & upd
    bits = ((amb_hit & upd).to(i32) * SEGF_AMBIGUOUS
            + (miss_hit & upd).to(i32) * SEGF_ED_MISS
            + over.to(i32) * SEGF_N_OVERFLOW)

    create = onehot & ~(found | ~upd)[:, None]
    st["ngroups"] = st["ngroups"] + (upd & ~found).to(i32)
    st["psum"] = psum + torch.where(onehot, pos, 0)
    st["lsum"] = lsum + torch.where(onehot, ln, 0)
    st["n"] = n + onehot.to(i32)
    st["head"] = torch.where(create, aid, st["head"])
    return tgt, create, bits


def gate_bits(cm: int, cmm: int, limit: float) -> dict:
    """The kernel's float32 constants as int32 bits, made by torch on the
    host as _Gates makes them: cm_f, limit_f, eps_f, tiny_f and forced_at
    (float32(cmm) times float32(1 + 2 EPS), one rounding)."""
    f32 = torch.float32
    consts = torch.tensor([float(cm), float(limit), EPS, 1e-9], dtype=f32)
    forced_at = (torch.tensor(float(cmm), dtype=f32)
                 * torch.tensor(1.0 + 2.0 * EPS, dtype=f32)).reshape(1)
    bits = torch.cat([consts, forced_at]).view(torch.int32).tolist()
    return dict(zip(("cm_f", "limit_f", "eps_f", "tiny_f", "forced_at"), bits))


def div_magic(n: int) -> tuple:
    """The kernel's exact division by a group's size n (1 <= n < 2^31), the
    model the CPU tests hold to floor division: (m, s) with s =
    ceil(log2 n) and m = ceil(2^(31 + s) / n) < 2^32, so that x // n ==
    (x * m) >> (31 + s) for every 0 <= x < 2^31 (division by an invariant
    integer, Granlund and Montgomery: x (m n - 2^(31 + s)) / (n 2^(31 + s))
    stays below 1 / n). csrc/combine_greedy.cu caches m in each slot when
    lane 0 founds or joins it (its table for n <= SEG_LMAX)."""
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"div_magic: n = {n} is not in [1, 2^31)")
    s = (n - 1).bit_length()
    return -(-(1 << (31 + s)) // n), s


def magic_div(x, m: int, s: int):
    """x // n for 0 <= x < 2^31 by div_magic(n)'s (m, s), as the kernel
    computes it: the 64-bit product x * m shifted right by 31 + s (x an int
    or a uint64 numpy array)."""
    return (x * m) >> (31 + s)


def _kernel_gates(cm: int, cmm: int, limit: float) -> tuple:
    """The kernel's gate arguments: cmm, the five bits of gate_bits, and
    the flags limit > 0 (the identity gate) and limit < 1 (pass_same)."""
    bits = gate_bits(cm, cmm, limit)
    return (int(cmm), *(bits[k] for k in ("cm_f", "limit_f", "eps_f", "tiny_f", "forced_at")),
            int(limit > 0), int(limit < 1.0))


def _int32_input(name: str, t, dev, shape: tuple) -> torch.Tensor:
    """`t` as a contiguous int32 tensor of `shape` on `dev`; raises on
    another dtype, shape or device."""
    if t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != shape:
        raise ValueError(f"combine greedy: {name} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, want int32 {shape} on {dev}")
    return t.contiguous()


def grid_inputs(c_pos, c_len, c_alt, c_hord, counts, ed) -> dict:
    """The grid kernel's inputs: the (S, L) grids, counts (S,) and the ED
    table (S, K, W) as contiguous int32 tensors on c_pos's device, a row's
    state within SHARED_STATE_MAX, K at most a warp's lanes and W at least
    1; raises on anything else."""
    dev = c_pos.device
    S, L = c_pos.shape
    if 4 * STATE_WORDS * L > SHARED_STATE_MAX:
        raise ValueError(f"combine greedy: rows of {L} slots, past a block's shared memory "
                         f"({SHARED_STATE_MAX // (4 * STATE_WORDS)})")
    if ed.dim() != 3 or ed.shape[0] != S or not 1 <= ed.shape[1] <= MAX_ED_HEADS \
            or ed.shape[2] < 1:
        raise ValueError(f"combine greedy: ed is {tuple(ed.shape)}, want ({S}, K <= "
                         f"{MAX_ED_HEADS}, W >= 1)")
    grids = {k: _int32_input(k, t, dev, (S, L)) for k, t in
             (("c_pos", c_pos), ("c_len", c_len), ("c_alt", c_alt), ("c_hord", c_hord))}
    return {**grids, "counts": _int32_input("counts", counts, dev, (S,)),
            "ed": _int32_input("ed", ed, dev, tuple(ed.shape))}


def flush_inputs(c_pos, c_len, c_alt, g_psum, g_lsum, g_n, g_head, ed) -> dict:
    """The flush kernel's inputs: candidates (Cp,), group slots (G,) and
    the ED table (H, Cp) as contiguous int32 tensors on c_pos's device;
    raises on anything else."""
    dev = c_pos.device
    cp, G = c_pos.shape[0], g_psum.shape[0]
    if ed.dim() != 2 or ed.shape[0] < 1 or ed.shape[1] != cp:
        raise ValueError(f"combine greedy: ed is {tuple(ed.shape)}, want (H >= 1, {cp})")
    out = {k: _int32_input(k, t, dev, (cp,)) for k, t in
           (("c_pos", c_pos), ("c_len", c_len), ("c_alt", c_alt))}
    out.update((k, _int32_input(k, t, dev, (G,))) for k, t in
               (("g_psum", g_psum), ("g_lsum", g_lsum), ("g_n", g_n), ("g_head", g_head)))
    out["ed"] = _int32_input("ed", ed, dev, tuple(ed.shape))
    return out


def _entry(name: str, argtypes: list, defines: tuple = ()):
    """Entry point `name` of csrc/combine_greedy.cu, built with `defines` at
    first use."""
    from sniffles_tpu_torch.ops import _build
    fn = getattr(_build.load("combine_greedy", defines), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_void_p]   # the stream
    return fn


def launch_grid(inputs: dict, *, cm: int, cmm: int, limit: float, clocks: bool = False):
    """One launch of the grid kernel (greedy_grid) on grid_inputs' CUDA
    tensors, on the device's current stream (`clocks`: the STEP_CLOCKS
    build, a timing tool's). Returns (assign (S, L), segflags (S,)); counts
    nothing; raises when the launch is refused."""
    from sniffles_tpu_torch.ops.clustering import _launch
    c_pos, ed = inputs["c_pos"], inputs["ed"]
    dev = c_pos.device
    S, L = c_pos.shape
    assign = torch.empty((S, L), dtype=torch.int32, device=dev)
    segflags = torch.empty((S,), dtype=torch.int32, device=dev)
    fn = _entry("greedy_grid", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12,
                (STEP_CLOCKS,) if clocks else ())
    rc = _launch(fn, dev, *(inputs[k].data_ptr() for k in
                            ("c_pos", "c_len", "c_alt", "c_hord", "counts", "ed")),
                 assign.data_ptr(), segflags.data_ptr(), S, L, ed.shape[1], ed.shape[2],
                 *_kernel_gates(cm, cmm, limit))
    if rc != 0:
        raise RuntimeError(f"combine_greedy launch failed with CUDA error {rc}")
    return assign, segflags


def launch_flush(inputs: dict, c_count: int, n_groups0: int, *, cm: int, cmm: int,
                 limit: float):
    """One launch of the flush kernel (greedy_flush) on flush_inputs' CUDA
    tensors, on the device's current stream, its row's state in shared
    memory where its G slots fit SHARED_STATE_MAX, else in a global scratch
    buffer. Returns (assign (Cp,), flags (3,)); counts nothing; raises when
    the launch is refused."""
    from sniffles_tpu_torch.ops.clustering import _launch
    c_pos, ed = inputs["c_pos"], inputs["ed"]
    dev = c_pos.device
    cp, G = c_pos.shape[0], inputs["g_psum"].shape[0]
    assign = torch.empty((cp,), dtype=torch.int32, device=dev)
    flags = torch.empty((3,), dtype=torch.int32, device=dev)
    scratch = (None if 4 * STATE_WORDS * G <= SHARED_STATE_MAX
               else torch.empty((G, STATE_WORDS), dtype=torch.int32, device=dev))
    fn = _entry("greedy_flush", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 8)
    rc = _launch(fn, dev, *(inputs[k].data_ptr() for k in ("c_pos", "c_len", "c_alt")),
                 int(c_count), cp,
                 *(inputs[k].data_ptr() for k in ("g_psum", "g_lsum", "g_n", "g_head")),
                 G, ed.data_ptr(), ed.shape[0], int(n_groups0), assign.data_ptr(),
                 flags.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 *_kernel_gates(cm, cmm, limit))
    if rc != 0:
        raise RuntimeError(f"combine_greedy launch failed with CUDA error {rc}")
    return assign, flags


def _greedy_grid_loop(c_pos, c_len, c_alt, c_hord, counts, ed,
                      *, cm: int, cmm: int, limit: float, max_count: int = None):
    """The whole-task grid greedy of greedy_grid_plain: on CPU tensors the
    plain version, on CUDA tensors one launch of the kernel (each row runs
    to its own count, so max_count is not needed there and nothing is read
    from the card), on any other device an exception."""
    dev = c_pos.device
    if dev.type == "cpu":
        return greedy_grid_plain(c_pos, c_len, c_alt, c_hord, counts, ed, cm=cm, cmm=cmm,
                                 limit=limit, max_count=max_count)
    if dev.type != "cuda":
        raise ValueError(f"no combine greedy kernel for device {dev}")
    out = launch_grid(grid_inputs(c_pos, c_len, c_alt, c_hord, counts, ed),
                      cm=cm, cmm=cmm, limit=limit)
    COUNTS["launches"] += 1
    COUNTS["segments"] += c_pos.shape[0]
    COUNTS["steps"] += int(max_count or 0)
    return out


def _greedy_loop(c_pos, c_len, c_alt, c_count: int, g_psum, g_lsum, g_n, g_head,
                 ed, n_groups0: int, *, cm: int, cmm: int, limit: float):
    """The flush greedy of greedy_flush_plain: on CPU tensors the plain
    version, on CUDA tensors one launch of the kernel, on any other device
    an exception."""
    dev = c_pos.device
    if dev.type == "cpu":
        return greedy_flush_plain(c_pos, c_len, c_alt, c_count, g_psum, g_lsum, g_n, g_head,
                                  ed, n_groups0, cm=cm, cmm=cmm, limit=limit)
    if dev.type != "cuda":
        raise ValueError(f"no combine greedy kernel for device {dev}")
    out = launch_flush(flush_inputs(c_pos, c_len, c_alt, g_psum, g_lsum, g_n, g_head, ed),
                       c_count, n_groups0, cm=cm, cmm=cmm, limit=limit)
    COUNTS["launches"] += 1
    COUNTS["segments"] += 1
    COUNTS["steps"] += int(c_count)
    return out


def greedy_grid_plain(c_pos, c_len, c_alt, c_hord, counts, ed,
                      *, cm: int, cmm: int, limit: float, max_count: int = None):
    """Whole-task greedy as a SEGMENT-GRID lockstep loop.

    Combine tasks start with an empty frontier, and position gaps >
    combine_match_max split candidates into provably interaction-free
    segments (any cross-segment pos distance alone exceeds the match
    cap), so every segment's sequential trajectory is independent. The
    grid runs them all at once: row s is segment s, loop step i
    processes each segment's i-th candidate (its trajectory order = the
    host's flush-major support-descending order restricted to the
    segment).

    Inputs are int32 tensors on one device: (S, L) grids c_pos
    (segment-rebased local coordinates), c_len (|svlen|), c_alt
    (segment-local alt ids), c_hord (the candidate alt's row in the
    segment's potential-head ED table, -1 when not tabulated), counts
    (S,) per-segment candidate counts, and ed (S, K, W) exact edit
    distances (head table row x candidate, -1 = missing; W = L, or 1 for
    an all-missing table, whose one column every step reads).

    max_count: the largest count, when the caller has it on the host
    (else it is read from the device once, before the loop).

    Returns (assign (S, L) segment-local slot ids, segflags (S,) SEGF_*
    bitmasks).
    """
    S, L = c_pos.shape
    W = ed.shape[2]
    dev = c_pos.device
    i32 = torch.int32
    g = _Gates(cm, cmm, limit, dev)
    slots = torch.arange(L, dtype=i32, device=dev)[None, :]
    st = {"ngroups": torch.zeros((S,), dtype=i32, device=dev),
          "psum": torch.zeros((S, L), dtype=i32, device=dev),
          "lsum": torch.zeros((S, L), dtype=i32, device=dev),
          "n": torch.zeros((S, L), dtype=i32, device=dev),
          "head": torch.zeros((S, L), dtype=i32, device=dev)}
    hord = torch.full((S, L), -1, dtype=i32, device=dev)
    assign = torch.full((S, L), -1, dtype=i32, device=dev)
    segflags = torch.zeros((S,), dtype=i32, device=dev)

    if max_count is None:
        max_count = int(counts.max()) if S else 0   # the one host read
    for i in range(max_count):
        upd = i < counts                                     # (S,)
        d_ed = None
        if limit > 0:
            # a width-1 table is read at column 0 by every step (JAX's
            # dynamic slice clamps the index the same way)
            ed_i = ed[:, :, min(i, W - 1)]                   # (S, K)
            d_ed = torch.where(hord >= 0,
                               torch.gather(ed_i, 1, torch.clamp(hord, min=0).long()),
                               torch.full_like(hord, -1))
        tgt, create, bits = _greedy_step(st, c_pos[:, i:i + 1], c_len[:, i:i + 1],
                                         c_alt[:, i:i + 1], d_ed, upd, g)
        hord = torch.where(create, c_hord[:, i:i + 1], hord)
        assign = torch.where((slots == i) & upd[:, None], tgt[:, None], assign)
        segflags = segflags | bits
    return assign, segflags


def greedy_flush_plain(c_pos, c_len, c_alt, c_count: int, g_psum, g_lsum, g_n, g_head,
                       ed, n_groups0: int, *, cm: int, cmm: int, limit: float):
    """The sequential greedy of one flush (the JAX package's _greedy_loop,
    sniffles_tpu/ops/combine_greedy.py:61): candidates (Cp,) in processing
    order, of which the first c_count are real, against G group slots whose
    first n_groups0 hold the initial groups (integer sums g_psum, g_lsum,
    sizes g_n, head alt ids g_head); ed (H, Cp) the exact edit distance of
    alt id x candidate (-1 = missing). One step a candidate: the grid
    loop's step on a single row, with the identity gate reading the table
    at the group head's alt id.

    Returns (assign (Cp,) slot ids, < n_groups0 an initial group, else in
    creation order; flags (3,) int32: ambiguous, ed_miss, n_overflow)."""
    dev = c_pos.device
    H = ed.shape[0]
    g = _Gates(cm, cmm, limit, dev)
    st = {"ngroups": torch.full((1,), n_groups0, dtype=torch.int32, device=dev),
          "psum": g_psum[None, :], "lsum": g_lsum[None, :], "n": g_n[None, :],
          "head": g_head[None, :]}
    assign = torch.full_like(c_pos, -1)
    flags = torch.zeros((1,), dtype=torch.int32, device=dev)
    upd = torch.ones((1,), dtype=torch.bool, device=dev)
    for i in range(c_count):
        d_ed = (ed[:, i][torch.clamp(st["head"], 0, H - 1).long()] if limit > 0 else None)
        tgt, _, bits = _greedy_step(st, c_pos[i:i + 1, None], c_len[i:i + 1, None],
                                    c_alt[i:i + 1, None], d_ed, upd, g)
        assign[i:i + 1] = tgt
        flags = flags | bits
    flag_bits = (SEGF_AMBIGUOUS, SEGF_ED_MISS, SEGF_N_OVERFLOW)
    return assign, torch.cat([((flags & b) > 0).to(torch.int32) for b in flag_bits])


def start_combine_greedy_task(payload: dict, meta: dict, device):
    """Start the whole-task grid greedy for one (combine task, svtype) on
    `device` ("cuda", or "cpu" when the CPU was asked for) and return a
    finish() that waits for it and returns its result: on the card the
    loop's kernels and the copy of the result into pinned memory are
    queued on the current stream with no host synchronisation, so the
    device service can start the next request before it finishes this one.

    payload: the JAX package's dict — c_pos/c_len/c_alt/c_hord (S, L)
    int32 grids in segment-row layout (trimmed; padded to powers of two
    here, as the JAX package does), counts (S,), ed_segs, ed_rows (head
    table row), ed_cols, ed_vals (sparse exact ED entries).
    meta: cm, cmm, limit.

    finish() returns {"assign": (S, L) int32 segment-local slot ids,
    "seg_flags": (S,) int32 SEGF_* bitmasks} as numpy arrays.
    """
    from sniffles_tpu_torch.ops.transfer import to_device, to_host_async
    S, L = np.shape(payload["c_pos"])
    grids = task_grids(payload)
    assign, segflags = _greedy_grid_loop(
        *(to_device(grids[k], device) for k in GRID_KEYS),
        cm=int(meta["cm"]), cmm=int(meta["cmm"]), limit=float(meta["limit"]),
        max_count=int(grids["counts"].max()))
    fetch = to_host_async(assign, segflags)

    def finish():
        assign_h, segflags_h = fetch()
        return {"assign": assign_h[:S, :L], "seg_flags": segflags_h[:S]}
    return finish


def task_grids(payload: dict) -> dict:
    """A trimmed grid payload padded as the JAX package pads it: the (S, L)
    grids to (Sp, Lp), powers of two of at least 16 and 64 (c_hord with
    -1), counts to (Sp,), and the dense ED table (Sp, TASK_ED_HEADS, Lp),
    or (Sp, TASK_ED_HEADS, 1) when no entry is tabulated; numpy int32
    arrays under GRID_KEYS."""
    c_pos = np.asarray(payload["c_pos"], dtype=np.int32)
    S, L = c_pos.shape
    Sp = _pow2(max(S, 1), 16)
    Lp = _pow2(max(L, 1), 64)

    def pad_g(a, fill=0):
        out = np.full((Sp, Lp), fill, dtype=np.int32)
        out[:S, :L] = a
        return out

    counts = np.zeros(Sp, dtype=np.int32)
    counts[:S] = np.asarray(payload["counts"], dtype=np.int32)
    segs = np.asarray(payload["ed_segs"], dtype=np.int64)
    if len(segs):
        ed = np.full((Sp, TASK_ED_HEADS, Lp), -1, dtype=np.int32)
        ed[segs, np.asarray(payload["ed_rows"], dtype=np.int64),
           np.asarray(payload["ed_cols"], dtype=np.int64)] = \
            np.asarray(payload["ed_vals"], dtype=np.int32)
    else:
        # all-missing table: a width-1 grid reads the same -1 everywhere
        ed = np.full((Sp, TASK_ED_HEADS, 1), -1, dtype=np.int32)
    return {"c_pos": pad_g(c_pos),
            "c_len": pad_g(np.asarray(payload["c_len"], dtype=np.int32)),
            "c_alt": pad_g(np.asarray(payload["c_alt"], dtype=np.int32)),
            "c_hord": pad_g(np.asarray(payload["c_hord"], dtype=np.int32), fill=-1),
            "counts": counts, "ed": ed}


def run_combine_greedy_task(payload: dict, meta: dict, device) -> dict:
    """start_combine_greedy_task, waited for."""
    return start_combine_greedy_task(payload, meta, device)()


def run_combine_greedy(payload: dict, meta: dict, device) -> dict:
    """The sequential greedy of one (block, svtype) flush on `device`, the
    counterpart of the JAX package's run_combine_greedy
    (sniffles_tpu/ops/combine_greedy.py:395); payload arrays are trimmed
    and padded here as the JAX package pads them.

    payload: c_pos/c_len/c_alt (int32, local coords, processing order),
    g_psum/g_lsum/g_n/g_head (int32, K0 initial groups in list order),
    ed_rows/ed_cols/ed_vals (sparse exact ED table entries over
    (alt_id, candidate_index)), n_alts.
    meta: cm, cmm, limit.

    Returns {"assign": (C,) int32 (slot < K0 = initial group, else
    creation order K0, K0+1, ...), "flags": (3,) int32} as numpy arrays.
    """
    from sniffles_tpu_torch.ops.transfer import to_device, to_host_async
    c_pos = np.asarray(payload["c_pos"], dtype=np.int32)
    C = len(c_pos)
    K0 = len(payload["g_n"])
    Cp = _pow2(max(C, 1), 64)
    Kp = _pow2(max(K0, 1), 16)
    G = Cp + Kp

    def pad(a, size):
        out = np.zeros(size, dtype=np.int32)
        out[:len(a)] = a
        return to_device(out, device)

    Hp = _pow2(max(int(payload["n_alts"]), 1), 16)
    ed = np.full((Hp, Cp), -1, dtype=np.int32)
    rows = np.asarray(payload["ed_rows"], dtype=np.int64)
    if len(rows):
        ed[rows, np.asarray(payload["ed_cols"], dtype=np.int64)] = \
            np.asarray(payload["ed_vals"], dtype=np.int32)

    assign, flags = _greedy_loop(
        pad(c_pos, Cp), pad(np.asarray(payload["c_len"], dtype=np.int32), Cp),
        pad(np.asarray(payload["c_alt"], dtype=np.int32), Cp), C,
        *(pad(np.asarray(payload[k], dtype=np.int32), G)
          for k in ("g_psum", "g_lsum", "g_n", "g_head")),
        to_device(ed, device), K0,
        cm=int(meta["cm"]), cmm=int(meta["cmm"]), limit=float(meta["limit"]))
    assign_h, flags_h = to_host_async(assign, flags)()
    return {"assign": assign_h[:C], "flags": flags_h}
