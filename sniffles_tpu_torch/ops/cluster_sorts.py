"""
The clustering's segmented sorts (ops/clustering.py: sort_and_seed,
merge_inner_fold, resplit_child_ids, _resplit, phase_tallies), in place of
the JAX package's jnp.lexsort chains and the takes of every column through
their permutations.

Every one of those lexsorts but the first orders elements only inside
segments that are already contiguous in array order (a cluster, a merged
segment, a parent cluster, a child), and the invalid elements form a suffix
of segments of their own whose masked keys are all INT32_MAX. So
lexsort((k2, k1, masked segment id)) is the permutation of a stable sort of
each segment by (k1, k2): `seg_sort`. The first lexsort, by (svtype, bin,
tie), is one stable sort by an int64 (svtype, bin) key, whose runs are the
seeds, then `seg_sort` inside each run by the tie (ops/clustering.py).
`gather_columns` applies a permutation to every column of a stage's dict.
`seed_marks`, `resplit_marks` and `fold_marks` compute a stage's
per-element predicate on its sorted columns (the seeds of sort and seed,
the resplit's splits, the inner fold's merge flags).

Each is a wrapper: on CPU tensors the plain version (`seg_sort_plain`, the
ops/segments.lexsort chain of the segment ids and keys; `gather_columns_plain`,
an index a column), on CUDA tensors the kernels of csrc/cluster_sorts.cu,
on any other device an exception. The kernels: a run pass that finds the
segments and sorts those of at most TINY_MAX elements by a thread each
(`seg_runs`), a warp a segment up to WARP_MAX (segments of up to 32 dealt
several to a warp) and a block a larger one, in shared memory up to
BLOCK_MAX elements and in a global scratch buffer past it (`seg_tiers`,
one launch for both), a gather of up to 32 columns a launch that reads
the permutation once an element (`seg_gather`), and the predicates, one
launch each (`seg_marks`). No host synchronisation, no cap on a segment's
size.
The thresholds are built into the kernels (nvcc_defines), chosen on the card
by tools/time_cluster_sorts.py (PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from sniffles_tpu_torch.ops._call_consts import SVTYPE_CODES
from sniffles_tpu_torch.ops.segments import lexsort, segment_ids_from_boundaries, shift_prev

# Launches by the wrappers: "seg_sort", "gather_columns" and "marks" one a
# call, and one a launch of each kernel of csrc/cluster_sorts.cu (seg_gather
# once for every 32 columns); they add to them only where they launch the
# kernels.
KERNELS = ("seg_runs", "seg_tiers", "seg_gather", "seg_marks")
COUNTS = {"seg_sort": 0, "gather_columns": 0, "marks": 0, **{k: 0 for k in KERNELS}}

# the stage predicates of the seg_marks kernel (its MarkKind)
MARK_KINDS = {"seeds": 0, "resplit": 1, "fold": 2}
SVTYPE_INS, SVTYPE_DEL, SVTYPE_BND = (SVTYPE_CODES[k] for k in ("INS", "DEL", "BND"))

# The tiers by a segment's element count, built into the kernels as -D
# flags (nvcc_defines): a thread a segment up to TINY_MAX (at most 8, its
# keys in registers), a warp up to WARP_MAX (12 bytes an element of the
# warp's slice of shared memory), a block beyond, in dynamic shared memory
# up to BLOCK_MAX elements (12 bytes each) and in global scratch past it.
TINY_MAX = 8
WARP_MAX = 256
BLOCK_MAX = 8192
TIERS = (TINY_MAX, WARP_MAX, BLOCK_MAX)
# the elements of a run pass's tile (a block of seg_runs), built into the
# kernel as a -D flag (nvcc_defines) so that the tests' tile edges
# (sim.seg_sort_batch's "tiles") follow it
RUN_TILE = 4096

# element sizes the gather kernel moves, and the columns a launch takes
_GATHER_SIZES = (1, 4, 8)
_MAX_COLS = 32

# the CUDA events a timing tool gives launch_seg_sort (before the memset,
# after it, after the run pass, after the tiers) and the parts they bound;
# the -D flag of the build whose warp tier sums its cycles by phase; the
# parts of the run pass, and the -D flag of a variant that stops after the
# k-th of them (tools/time_cluster_sorts.py --split)
SORT_EVENT_PARTS = ("memset", "run pass", "tiers")
SORT_EVENTS = len(SORT_EVENT_PARTS) + 1
PHASE_CLOCKS = "-DSORT_PHASE_CLOCKS"
RUN_PARTS = ("heads", "next head", "appends", "thread tier")


def run_parts_define(k: int) -> str:
    """The -D flag of the run pass's variant that stops after its k-th part
    (1 to len(RUN_PARTS); the last is the whole pass)."""
    if not 1 <= k <= len(RUN_PARTS):
        raise ValueError(f"the run pass has parts 1 to {len(RUN_PARTS)}, not {k}")
    return f"-DSORT_RUN_PARTS={int(k)}"


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def nvcc_defines(tiers: tuple = TIERS) -> tuple:
    """The -D flags of csrc/cluster_sorts.cu for the thresholds (tiny, warp,
    block) and the run pass's tile (RUN_TILE); the kernel's static_asserts
    refuse a set that does not fit it."""
    names = ("SORT_TINY_MAX", "SORT_WARP_MAX", "SORT_BLOCK_MAX")
    return tuple(f"-D{k}={int(v)}" for k, v in zip(names, tiers, strict=True)) + (
        f"-DSORT_RUN_TILE={RUN_TILE}",)


def seg_heads(seg_start: torch.Tensor, alone: torch.Tensor | None = None) -> torch.Tensor:
    """The segment heads: seg_start, and with `alone` each element marked
    there and the one after it (an element alone is a segment of its own)."""
    if alone is None:
        return seg_start
    after = torch.zeros_like(alone)
    after[1:] = alone[:-1]
    return seg_start | alone | after


def seg_sort_plain(seg_start: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor | None = None,
                   base: torch.Tensor | None = None,
                   alone: torch.Tensor | None = None) -> torch.Tensor:
    """The permutation that sorts each contiguous segment (a segment starts
    where seg_start is set, and at element 0) stably by (k1, k2), ties by
    array index: lexsort((k2, k1, segment id)). With `base`, the element at
    position x is original element base[x], whose keys are k1[base[x]] and
    k2[base[x]], and the result is base composed with that permutation.
    With `alone` (bool, read through base), each marked element is a
    segment of its own and stays where it is: the callers mark their
    invalid suffix, which the lexsort leaves in place. int64."""
    if base is not None:
        k1 = k1[base]
        k2 = None if k2 is None else k2[base]
        alone = None if alone is None else alone[base]
    seg_id = segment_ids_from_boundaries(seg_heads(seg_start, alone))
    order = lexsort((k1, seg_id) if k2 is None else (k2, k1, seg_id))
    return order if base is None else base[order]


def on_card(t: torch.Tensor, what: str) -> bool:
    """Whether a wrapper or a stage on `t`'s device launches its kernels
    (True, a CUDA tensor) or runs its plain version (False, a CPU tensor);
    raises on any other device, naming `what`."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} kernel for device {t.device}")


def seg_sort(seg_start: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor | None = None,
             base: torch.Tensor | None = None, alone: torch.Tensor | None = None) -> torch.Tensor:
    """seg_sort_plain's permutation: on CPU tensors the plain version, on
    CUDA tensors the kernels (launch_seg_sort), on any other device an
    exception."""
    if not on_card(k1, "segmented-sort"):
        return seg_sort_plain(seg_start, k1, k2, base, alone)
    perm = launch_seg_sort(seg_start, k1, k2, base, alone)
    if k1.shape[0]:
        COUNTS["seg_sort"] += 1
        COUNTS["seg_runs"] += 1
        COUNTS["seg_tiers"] += 1
    return perm


def _checked(t: torch.Tensor, name: str, dtype: torch.dtype, n: int, dev) -> torch.Tensor:
    if t.device != dev or t.dim() != 1 or t.shape[0] != n or t.dtype != dtype:
        raise ValueError(f"seg_sort: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"want {dtype} ({n},) on {dev}")
    return t.contiguous()


def launch_seg_sort(seg_start, k1, k2=None, base=None, alone=None,
                    tiers: tuple = TIERS, events=None, clocks: bool = False,
                    run_parts: int | None = None) -> torch.Tensor:
    """The kernels' entry point seg_sort on CUDA tensors (a memset, the run
    pass, the tiers' one launch) on the current stream of their
    device; no launch for n = 0. `events`: None, or SORT_EVENTS recorded
    torch.cuda.Events that the entry point records again before the memset,
    after it, after the run pass and after the tiers; `clocks`: the build
    with PHASE_CLOCKS; `run_parts`: the variant whose run pass stops after
    that part (run_parts_define; its permutation is not complete). Both for
    tools/time_cluster_sorts.py.
    Counts nothing; raises on an input of another type, shape or device and
    when a launch fails."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    dev, n = k1.device, k1.shape[0]
    k1 = _checked(k1, "k1", torch.int32, n, dev)
    seg_start = _checked(seg_start, "seg_start", torch.bool, n, dev)
    k2 = None if k2 is None else _checked(k2, "k2", torch.int32, n, dev)
    base = None if base is None else _checked(base, "base", torch.int64, n, dev)
    alone = None if alone is None else _checked(alone, "alone", torch.bool, n, dev)
    perm = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return perm
    lists = torch.empty((2 * n,), dtype=torch.int32, device=dev)   # n entries of (head, count)
    counts = torch.empty((3,), dtype=torch.int32, device=dev)    # warp, block list; cursor
    scratch_k = torch.empty((n,), dtype=torch.int64, device=dev)   # a segment past BLOCK_MAX
    scratch_i = torch.empty((n,), dtype=torch.int32, device=dev)
    defines = (nvcc_defines(tiers) + ((PHASE_CLOCKS,) if clocks else ())
               + ((run_parts_define(run_parts),) if run_parts is not None else ()))
    fn = _build.load("cluster_sorts", defines).seg_sort
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    marks = (None if events is None
             else (ctypes.c_void_p * SORT_EVENTS)(*[e.cuda_event for e in events]))
    # a bool is one byte, 0 or 1: the kernel reads seg_start and alone as bytes
    rc = _launch(fn, dev, seg_start.view(torch.uint8).data_ptr(), k1.data_ptr(),
                 None if k2 is None else k2.data_ptr(),
                 None if base is None else base.data_ptr(),
                 None if alone is None else alone.view(torch.uint8).data_ptr(),
                 perm.data_ptr(), lists.data_ptr(),
                 counts.data_ptr(), scratch_k.data_ptr(), scratch_i.data_ptr(), n, marks)
    if rc != 0:
        raise RuntimeError(f"seg_sort launch failed with CUDA error {rc}")
    return perm


def _is_column(v, n: int) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == n


def gather_columns_plain(order: torch.Tensor, columns: dict) -> dict:
    """`columns` with every [n] tensor (n = len(order)) indexed by `order`;
    other entries (a 0-d count) as they are."""
    n = order.shape[0]
    return {k: v[order] if _is_column(v, n) else v for k, v in columns.items()}


def gather_columns(order: torch.Tensor, columns: dict) -> dict:
    """gather_columns_plain: on CPU tensors the plain version, on CUDA
    tensors the gather kernel (launch_gather), on any other device an
    exception."""
    if not on_card(order, "gather"):
        return gather_columns_plain(order, columns)
    out, launches = launch_gather(order, columns)
    if launches:
        COUNTS["gather_columns"] += 1
        COUNTS["seg_gather"] += launches
    return out


def launch_gather(order: torch.Tensor, columns: dict) -> tuple:
    """The kernels' entry point gather_columns on CUDA tensors: every [n]
    column of 1, 4 or 8 bytes an element (bool, int32, float32 as bits,
    int64), 32 columns a launch, on the current stream; other entries as
    they are. Returns (the gathered dict, the launches). Counts nothing;
    raises on a column of another element size or device, on n of 2^31 or
    more and when a launch fails."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    dev, n = order.device, order.shape[0]
    if order.dtype != torch.int64 or order.dim() != 1:
        raise ValueError(f"gather_columns: order is {order.dtype} {tuple(order.shape)}, "
                         f"want int64 [n]")
    if n >= 2 ** 31:
        raise ValueError(f"gather_columns: {n} elements, the kernel takes fewer than 2^31")
    order = order.contiguous()
    out, src, dst = {}, [], []
    for k, v in columns.items():
        if not _is_column(v, n):
            out[k] = v
            continue
        if v.device != dev or v.element_size() not in _GATHER_SIZES:
            raise ValueError(f"gather_columns: {k} is {v.dtype} on {v.device}, want 1, 4 or "
                             f"8 bytes an element on {dev}")
        v = v.contiguous()
        out[k] = torch.empty_like(v)   # new storage: 16-byte aligned, as the kernel stores
        src.append(v)
        dst.append(out[k])
    if n == 0 or not src:
        return out, 0
    fn = _build.load("cluster_sorts", nvcc_defines()).gather_columns
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    ptrs = ctypes.c_void_p * len(src)
    sizes = (ctypes.c_int32 * len(src))(*[v.element_size() for v in src])
    rc = _launch(fn, dev, order.data_ptr(), ptrs(*[v.data_ptr() for v in src]),
                 ptrs(*[v.data_ptr() for v in dst]), sizes, len(src), n)
    if rc != 0:
        raise RuntimeError(f"gather_columns launch failed with CUDA error {rc}")
    return out, -(-len(src) // _MAX_COLS)


# ---------------------------------------------------------------------------
# the stages' per-element predicates after their gathers (seg_marks)


def seed_marks_plain(svtype, pos, valid, binsize: int) -> tuple:
    """Sort and seed's seeds on the sorted columns: (boundary, bin): bin =
    pos // binsize (floor), a boundary at element 0, at a svtype or bin
    change and at the first invalid element after a valid one."""
    bin_ = torch.div(pos, binsize, rounding_mode="floor")
    first = torch.ones((1,), dtype=torch.bool, device=valid.device)
    change = ((svtype[1:] != svtype[:-1]) | (bin_[1:] != bin_[:-1])
              | (~valid[1:] & valid[:-1]))
    return torch.cat([first, change]), bin_


def resplit_marks_plain(seg, svbin, svtype, minsvlen, cluster_merge_len) -> torch.Tensor:
    """The resplit's splits on its sorted columns: element 0, a new merged
    segment, or (outside BND) a float32 gap |svbin - prev| above
    max(minsvlen, min(svbin, prev) * cluster_merge_len); minsvlen and
    cluster_merge_len float32 0-d tensors."""
    prev_bin = shift_prev(svbin)
    prev_seg = torch.cat([seg[:1] - 1, seg[:-1]])
    gap = (svbin - prev_bin).abs().to(torch.float32)
    thr = torch.maximum(minsvlen, torch.minimum(svbin, prev_bin).to(torch.float32)
                        * cluster_merge_len)
    split = (seg != prev_seg) | ((gap > thr) & (svtype != SVTYPE_BND))
    split[:1].fill_(True)
    return split


# the columns whose predecessors the fold's predicate reads
FOLD_COLUMNS = ("cluster_id", "read_id", "pos", "ref_end", "qry_start", "qry_end", "strand",
                "svtype")


def fold_marks_plain(s: dict, rep: torch.Tensor, t: int) -> torch.Tensor:
    """The inner fold's merge flags on the sorted columns of `s` (valid and
    FOLD_COLUMNS) and the cluster's repeat flag `rep`: same cluster and read
    as the predecessor, both valid, INS or DEL, and a repeat cluster or near
    (within t) with the same strand; never element 0."""
    valid, pos = s["valid"], s["pos"]
    prev = {k: shift_prev(s[k]) for k in ("valid",) + FOLD_COLUMNS}
    same_key = (valid & prev["valid"] & (s["cluster_id"] == prev["cluster_id"])
                & (s["read_id"] == prev["read_id"]))
    near = ((((pos - prev["ref_end"]).abs() < t)
             | ((pos - prev["pos"]).abs() < t))
            & (((s["qry_start"] - prev["qry_end"]).abs() < t)
               | ((s["qry_start"] - prev["qry_start"]).abs() < t)))
    foldable = (s["svtype"] == SVTYPE_INS) | (s["svtype"] == SVTYPE_DEL)
    merge = same_key & foldable & (rep | (near & (s["strand"] == prev["strand"])))
    merge[:1].fill_(False)
    return merge


def seed_marks(svtype, pos, valid, binsize: int) -> tuple:
    """seed_marks_plain: on CPU tensors the plain version, on CUDA tensors
    one seg_marks launch, on any other device an exception."""
    if not on_card(pos, "stage-predicate"):
        return seed_marks_plain(svtype, pos, valid, binsize)
    n = pos.shape[0]
    boundary = torch.empty((n,), dtype=torch.bool, device=pos.device)
    bin_ = torch.empty((n,), dtype=torch.int32, device=pos.device)
    launch_marks("seeds", [svtype, pos], [valid], (), bin_, boundary, int(binsize))
    return boundary, bin_


def resplit_marks(seg, svbin, svtype, minsvlen, cluster_merge_len) -> torch.Tensor:
    """resplit_marks_plain: on CPU tensors the plain version, on CUDA tensors
    one seg_marks launch, on any other device an exception."""
    if not on_card(svbin, "stage-predicate"):
        return resplit_marks_plain(seg, svbin, svtype, minsvlen, cluster_merge_len)
    split = torch.empty(svbin.shape, dtype=torch.bool, device=svbin.device)
    launch_marks("resplit", [seg, svbin, svtype], [], (minsvlen, cluster_merge_len), None,
                 split, 0)
    return split


def fold_marks(s: dict, rep: torch.Tensor, t: int) -> torch.Tensor:
    """fold_marks_plain: on CPU tensors the plain version, on CUDA tensors
    one seg_marks launch, on any other device an exception."""
    if not on_card(rep, "stage-predicate"):
        return fold_marks_plain(s, rep, t)
    merge = torch.empty(rep.shape, dtype=torch.bool, device=rep.device)
    launch_marks("fold", [s[k] for k in FOLD_COLUMNS], [s["valid"], rep], (), None, merge,
                 int(t))
    return merge


def launch_marks(kind: str, cols: list, bools: list, scalars: tuple, out_i, out_b,
                 iarg: int) -> None:
    """The kernels' entry point stage_marks on CUDA tensors of one shape:
    int32 columns, bool columns, float32 0-d scalars on the card, the int32
    and bool outputs (None where the kind writes none). Counts the launch;
    raises on an input of another type or device and when the launch
    fails."""
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops.clustering import _launch
    out = out_b if out_b is not None else out_i
    dev, n = out.device, out.shape[0]
    if n == 0:
        return
    cols = [_checked(c, f"{kind} column", torch.int32, n, dev) for c in cols]
    bools = [_checked(b, f"{kind} flag", torch.bool, n, dev) for b in bools]
    for f in scalars:
        if not (isinstance(f, torch.Tensor) and f.dim() == 0 and f.dtype == torch.float32
                and f.device == dev):
            raise ValueError(f"{kind} marks: a scalar must be a float32 0-d tensor on {dev}")
    fn = _build.load("cluster_sorts", nvcc_defines()).stage_marks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    col_ptrs = (ctypes.c_void_p * 8)(*[c.data_ptr() for c in cols])
    bool_ptrs = (ctypes.c_void_p * 2)(*[b.view(torch.uint8).data_ptr() for b in bools])
    f0, f1 = (scalars[0].data_ptr(), scalars[1].data_ptr()) if scalars else (None, None)
    rc = _launch(fn, dev, MARK_KINDS[kind], col_ptrs, bool_ptrs, f0, f1,
                 None if out_i is None else out_i.data_ptr(),
                 out_b.view(torch.uint8).data_ptr(), iarg, n)
    if rc != 0:
        raise RuntimeError(f"stage_marks launch failed with CUDA error {rc}")
    COUNTS["marks"] += 1
    COUNTS["seg_marks"] += 1

