"""
The parallel fixed-point relaxation of the fused calling engine: the
merge stage of sniffles_tpu/ops/clustering.py::_cluster_body with
exact_sweep=False (:709-758, merge_step :717-746, the while_loop capped
at MERGE_ITERS_MAX = 32 rounds, :48).

A round evaluates, at every seed boundary of the sorted batch, the
reference's three merge criteria (cluster.py:163-171) between the segment
that starts there and the one before it, under the metrics of the
round's segmentation, and clears the boundaries that merge (never the
first). The loop stops after a round that changed no boundary, or after
32 rounds. Boundaries only turn off, so a round that changes nothing is a
fixed point, and every later round would change nothing either.

`merge_relax` is the wrapper: on CPU tensors the plain version
(`merge_relax_plain`, the torch loop of JAX's merge_step with the port's
_segment_metrics, one host read of the boundary count a round for the
stop rule), on CUDA tensors the kernel of csrc/merge_relax.cu (one
persistent cooperative launch over the card's resident grid runs every
round over a list of the live segment heads and stops on the device; no
host synchronisation), or an exception.
"""
from __future__ import annotations

import ctypes

import torch

from sniffles_tpu_torch.ops.clustering import SVTYPE_BND, _clamped, _launch, _segment_metrics
from sniffles_tpu_torch.ops.segments import segment_ids_from_boundaries, seg_max, seg_min

MERGE_ITERS_MAX = 32

# Calls of the relaxation's kernel by the wrapper (merge_relax), one a
# relaxation; it adds to it only where it launches the kernel.
COUNTS = {"launches": 0}


def reset_counts() -> None:
    COUNTS["launches"] = 0


def merge_step_plain(s: dict, boundary: torch.Tensor, bin_: torch.Tensor, *, cluster_r,
                     cluster_repeat_h, cluster_repeat_h_max, cluster_merge_bnd,
                     global_repeat: bool, binsize: int) -> torch.Tensor:
    """One round of the relaxation (JAX's merge_step): the new boundaries.
    The float parameters are float32 0-d tensors (or floats, taken as
    float32), cluster_merge_bnd an int32 0-d tensor or an int."""
    f32, i32 = torch.float32, torch.int32
    dev = boundary.device
    valid, svtype = s["valid"], s["svtype"]
    n = valid.shape[0]
    arange_n = torch.arange(n, dtype=i32, device=dev)
    seg = segment_ids_from_boundaries(boundary)
    start_bp = seg_min(torch.where(valid, bin_ * binsize, 2 ** 31 - 1), seg, n)
    end_bp = seg_max(torch.where(valid, bin_ * binsize + binsize, -1), seg, n)
    mean_svlen, sd_start = _segment_metrics(seg, valid, s["pos"], s["svlen"], arange_n, n)
    has_repeat = seg_max(torch.where(valid, s["repeat"].to(i32), 0), seg, n) > 0

    prev = (seg - 1).clamp(0, n - 1)
    # int32 differences that wrap, as XLA's do
    inner = (_clamped(start_bp, seg).to(torch.int64) - _clamped(end_bp, prev)).to(i32)
    outer = (_clamped(end_bp, seg).to(torch.int64) - _clamped(start_bp, prev)).to(i32)
    sd_pair = torch.minimum(_clamped(sd_start, seg), _clamped(sd_start, prev))
    m1 = inner.to(f32) <= sd_pair * torch.as_tensor(cluster_r, dtype=f32, device=dev)
    rep_pair = _clamped(has_repeat, seg) | _clamped(has_repeat, prev) | bool(global_repeat)
    h_lim = torch.minimum(torch.as_tensor(cluster_repeat_h_max, dtype=f32, device=dev),
                          (_clamped(mean_svlen, seg).abs() + _clamped(mean_svlen, prev).abs())
                          * torch.as_tensor(cluster_repeat_h, dtype=f32, device=dev))
    m2 = rep_pair & (outer.to(f32) <= h_lim)
    m3 = (svtype == SVTYPE_BND) & (inner <= torch.as_tensor(cluster_merge_bnd, dtype=i32,
                                                            device=dev))
    same_type_prev = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                                svtype[1:] == svtype[:-1]])
    can_merge = boundary & same_type_prev & valid & (m1 | m2 | m3)
    can_merge[:1] = False   # keep_first
    return boundary & ~can_merge


def merge_relax_plain(s: dict, boundary: torch.Tensor, bin_: torch.Tensor,
                      **params) -> tuple[torch.Tensor, int]:
    """The relaxation with JAX's stop rule: rounds while fewer than 32 ran
    and the boundary count still changes. Returns (boundaries, rounds)."""
    rounds, n_bounds, prev_n = 0, int(boundary.sum()), -1
    while rounds < MERGE_ITERS_MAX and n_bounds != prev_n:
        boundary = merge_step_plain(s, boundary, bin_, **params)
        rounds, prev_n, n_bounds = rounds + 1, n_bounds, int(boundary.sum())
    return boundary, rounds


def merge_relax(s: dict, boundary: torch.Tensor, bin_: torch.Tensor, *, cluster_r,
                cluster_repeat_h, cluster_repeat_h_max, cluster_merge_bnd,
                global_repeat: bool, binsize: int):
    """The relaxation over the sorted batch `s` (pos, svlen, svtype,
    repeat, valid, sorted by svtype and seed bin, invalid slots last) from
    its seed boundaries. Returns (boundaries [n] bool, rounds): rounds an
    int on the CPU, an int32 0-d tensor on the card (read it after the
    step; the relaxation itself never waits for the device)."""
    params = dict(cluster_r=cluster_r, cluster_repeat_h=cluster_repeat_h,
                  cluster_repeat_h_max=cluster_repeat_h_max,
                  cluster_merge_bnd=cluster_merge_bnd, global_repeat=global_repeat,
                  binsize=binsize)
    dev = boundary.device
    if dev.type == "cpu":
        return merge_relax_plain(s, boundary, bin_, **params)
    if dev.type != "cuda":
        raise ValueError(f"no merge-relaxation kernel for device {dev}")
    out = launch_merge_relax(s, boundary, bin_, **params)
    COUNTS["launches"] += 1
    return out


def _scalar(v, dtype):
    """A parameter as a Python number of the kernel's type (a 0-d tensor
    of the step is read once, on the host: the engine keeps them there)."""
    v = v.item() if isinstance(v, torch.Tensor) else v
    return float(torch.tensor(v, dtype=torch.float32)) if dtype is float else int(v)


# the kernel's int32 control words (csrc/merge_relax.cu, kCtl): a change
# flag a round, two list counts, the long-segment queue's count, and last
# the round count
CTL_WORDS = MERGE_ITERS_MAX + 4
# the kernel's device time stamps (stamps=): the start, the head list, and
# two a round
STAMP_WORDS = 2 * MERGE_ITERS_MAX + 2


def relax_columns(s: dict, boundary: torch.Tensor, bin_: torch.Tensor, stamps=None) -> dict:
    """The kernel's inputs on the boundaries' device, checked: pos, svlen,
    svtype and bin as contiguous int32 [n] columns, repeat and valid as
    the bytes of contiguous bool [n] columns (a bool is one byte, 0 or 1;
    the kernel reads them as uint8), each starting on 16 bytes (the kernel
    reads 4 slots a load; a column that does not is copied). `stamps`:
    None or an int64 [STAMP_WORDS] tensor there. Raises ValueError on
    anything else."""
    dev = boundary.device
    n = boundary.shape[0]
    if boundary.dim() != 1 or n < 1:
        raise ValueError(f"merge_relax: the boundaries must be a non-empty [n] tensor, got "
                         f"{tuple(boundary.shape)}")
    cols = {"pos": s["pos"].to(torch.int32), "svlen": s["svlen"].to(torch.int32),
            "svtype": s["svtype"].to(torch.int32), "bin": bin_.to(torch.int32),
            "repeat": s["repeat"].to(torch.bool), "valid": s["valid"].to(torch.bool)}
    for k, v in cols.items():
        if v.device != dev or v.shape != (n,):
            raise ValueError(f"merge_relax: {k} must be a [{n}] tensor on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if stamps is not None and (stamps.device != dev or stamps.dtype != torch.int64
                               or stamps.shape != (STAMP_WORDS,)):
        raise ValueError(f"merge_relax: stamps must be an int64 [{STAMP_WORDS}] tensor on "
                         f"{dev}")
    cols = {k: v.contiguous() for k, v in cols.items()}
    cols = {k: v if v.data_ptr() % 16 == 0 else v.clone() for k, v in cols.items()}
    return {k: v.view(torch.uint8) if v.dtype == torch.bool else v for k, v in cols.items()}


def resident_grid(device) -> int:
    """The blocks of the kernel's cooperative launch on a CUDA device: its
    resident blocks a multiprocessor times the multiprocessor count (the
    library caches it per device; a host query that does not wait for the
    device). Raises when the device offers no cooperative launch."""
    from sniffles_tpu_torch.ops import _build
    fn = _build.load("merge_relax").merge_relax_grid
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"merge_relax: no resident grid on {device} (CUDA error {rc})")
    return blocks.value


def launch_merge_relax(s: dict, boundary: torch.Tensor, bin_: torch.Tensor, *, cluster_r,
                       cluster_repeat_h, cluster_repeat_h_max, cluster_merge_bnd,
                       global_repeat: bool, binsize: int, stamps=None):
    """The kernel's entry point merge_relax on CUDA tensors: a memset of its
    control words and one cooperative launch on the current stream of the
    tensors' device. With `stamps` (int64 [STAMP_WORDS] on the device) the
    kernel also writes its device time stamps there (the start, after the
    head list, after each round's metrics and merge phases). Returns
    (boundaries, rounds as an int32 0-d tensor); counts nothing; raises
    when the launch fails or is refused."""
    from sniffles_tpu_torch.ops import _build
    dev = boundary.device
    n = boundary.shape[0]
    cols = relax_columns(s, boundary, bin_, stamps)
    i32 = torch.int32
    bound = boundary.to(torch.bool).clone(memory_format=torch.contiguous_format)
    seg = torch.empty((n, 4), dtype=i32, device=dev)
    rep = torch.empty((n,), dtype=torch.uint8, device=dev)
    prev_head = torch.empty((n,), dtype=i32, device=dev)
    walk_round = torch.empty_like(prev_head)
    heads = torch.empty((2, n), dtype=i32, device=dev)
    ctl = torch.empty((CTL_WORDS,), dtype=i32, device=dev)
    lib = _build.load("merge_relax")
    lib.merge_relax_ctl_words.restype = ctypes.c_int
    if lib.merge_relax_ctl_words() != CTL_WORDS:
        raise RuntimeError("merge_relax: the library's control words differ from CTL_WORDS")
    fn = lib.merge_relax
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    rc = _launch(fn, dev, *(cols[k].data_ptr() for k in
                            ("pos", "svlen", "svtype", "bin", "repeat", "valid")),
                 bound.view(torch.uint8).data_ptr(), seg.data_ptr(), rep.data_ptr(),
                 prev_head.data_ptr(),
                 walk_round.data_ptr(), heads[0].data_ptr(), heads[1].data_ptr(),
                 ctl.data_ptr(), stamps.data_ptr() if stamps is not None else None, n,
                 int(binsize), _scalar(cluster_r, float), _scalar(cluster_repeat_h, float),
                 _scalar(cluster_repeat_h_max, float), _scalar(cluster_merge_bnd, int),
                 int(bool(global_repeat)))
    if rc != 0:
        raise RuntimeError(f"merge_relax launch failed with CUDA error {rc}")
    return bound, ctl[CTL_WORDS - 1]
