"""The yardstick of the roofline metrics: the H100's published peaks and
the operations and bytes each hand-written kernel must move, worked out
from the shapes of its launch.

Copied from the port's timers at commit fac8884: chip_smoke.py
(relax_bytes, relax_bound_ms, tail_bytes, TAIL_OPS_PER_SLOT,
RELAX_OPS_PER_ELEMENT),
tools/time_cluster_sorts.gather_bytes, tools/profile_engine.py's
tail_runs bound and PERF.md's table of kernels (stat_keys: 9 bytes an
element; seg_marks: its columns read, its flags written). Two departures:
candidate_tail_kernel's bytes leave out the distinct coverage entries
its probes read (at most 4 bytes a probe; the bound is lower by under
1 %, never higher), and every kernel's bound is taken launch by launch.

`recording` wraps the port's launch functions for the duration of a
traced window (its modules' attributes, never their code) and notes each
launch's shapes; `resolve` turns them into (kernel, bound seconds) once
the window has ended and the device values they need can be read.
"""
from __future__ import annotations

import contextlib

# H100 SXM at its full 700 W (NVIDIA's data sheet; the INT32 rate: 64
# lanes per SM x 132 SMs x 1.98 GHz boost, the Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
FP32_OPS_PER_S = 67e12

RELAX_OPS_PER_ELEMENT = 12   # a head's walk of an element, a round (csrc/merge_relax.cu)
TAIL_OPS_PER_SLOT = 150      # float32 operations of a candidate slot (csrc/candidate_tail.cu)

# the kernels of the roofline metric, by their CUDA function names
ENGINE_KERNELS = ("seg_gather", "seg_marks", "relax_kernel", "stat_keys", "tail_runs",
                  "candidate_tail_kernel")


def gather_bytes(order, columns: dict) -> int:
    """The permutation read once, each column's element read and written once."""
    n = order.shape[0]
    return n * 8 + sum(2 * n * v.element_size() for v in columns.values()
                       if hasattr(v, "dim") and v.dim() == 1 and v.shape[0] == n)


def marks_bytes(cols, bools, out_i, out_b) -> int:
    """A stage predicate's columns and flags read once, its outputs written once."""
    return (sum(c.numel() * c.element_size() for c in list(cols) + list(bools))
            + sum(o.numel() * o.element_size() for o in (out_i, out_b) if o is not None))


def relax_bound_s(n: int, rounds: int) -> float:
    """Each input read once and the boundaries written once (20 bytes an
    element), or RELAX_OPS_PER_ELEMENT int32 operations an element a round."""
    return max(n * 20 / HBM_BYTES_PER_S, RELAX_OPS_PER_ELEMENT * n * rounds / INT32_OPS_PER_S)


def tail_bound_s(n: int) -> float:
    """A slot's statistics (36 bytes), an element's nm, valid and cluster id
    (9), 60 bytes of outputs a slot; or TAIL_OPS_PER_SLOT float32 ops."""
    return max(n * (36 + 9 + 60) / HBM_BYTES_PER_S, TAIL_OPS_PER_SLOT * n / FP32_OPS_PER_S)


def tail_runs_bound_s(n: int, n_clusters: int) -> float:
    """The cluster ids read, a run start a cluster written."""
    return (4 * n + 4 * (n_clusters + 1)) / HBM_BYTES_PER_S


@contextlib.contextmanager
def recording(recorded: list):
    """Notes every launch of the roofline kernels in the block as
    (kernel, bound seconds or a function of device values to read later)."""
    from sniffles_tpu_torch.ops import call_stats, candidate_tail, cluster_sorts, merge_relax

    def gather(fn):
        def run(order, columns):
            recorded.append(("seg_gather", gather_bytes(order, columns) / HBM_BYTES_PER_S))
            return fn(order, columns)
        return run

    def marks(fn):
        def run(kind, cols, bools, scalars, out_i, out_b, iarg):
            recorded.append(("seg_marks", marks_bytes(cols, bools, out_i, out_b)
                             / HBM_BYTES_PER_S))
            return fn(kind, cols, bools, scalars, out_i, out_b, iarg)
        return run

    def relax(fn):
        def run(s, boundary, bin_, **kw):
            out = fn(s, boundary, bin_, **kw)
            n = boundary.shape[0]
            recorded.append(("relax_kernel", lambda r=out[1]: relax_bound_s(n, int(r))))
            return out
        return run

    def keys(fn):
        def run(clustered):
            if clustered["cluster_id"].is_cuda:
                recorded.append(("stat_keys", 9 * clustered["cluster_id"].shape[0]
                                 / HBM_BYTES_PER_S))
            return fn(clustered)
        return run

    def tail(fn):
        def run(stats, support_sa, coverage, elements, params, **kw):
            n = elements["cluster_id"].shape[0]
            recorded.append(("candidate_tail_kernel", tail_bound_s(n)))
            recorded.append(("tail_runs", lambda c=stats["n_clusters"]:
                             tail_runs_bound_s(n, int(c))))
            return fn(stats, support_sa, coverage, elements, params, **kw)
        return run

    targets = [(cluster_sorts, "launch_gather", gather), (cluster_sorts, "launch_marks", marks),
               (merge_relax, "launch_merge_relax", relax), (call_stats, "sort_keys", keys),
               (candidate_tail, "launch_candidate_tail", tail)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    try:
        for mod, attr, wrap in targets:
            setattr(mod, attr, wrap(getattr(mod, attr)))
        yield recorded
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def resolve(recorded: list) -> list:
    """[(kernel, bound seconds)] of the recorded launches (after the window)."""
    return [(k, b() if callable(b) else b) for k, b in recorded]


def roofline_pct(trace, kernels: tuple):
    """100 x the bound over the measured device time of `kernels`' launches
    in the trace. A kernel's bounds are scaled by the launches the profiler
    saw over those recorded, as the profiler can drop a launch. None when
    none of them ran."""
    import re
    bound = measured = 0.0
    for k in kernels:
        pat = re.compile(rf"\b{k}\s*[<(]")
        seen = [(e - s) / 1e6 for name, s, e in trace.kernels() if pat.search(name)]
        calls = [b for name, b in trace.bounds if name == k]
        if not seen or not calls:
            continue
        measured += sum(seen)
        bound += sum(calls) * len(seen) / len(calls)
    return 100.0 * bound / measured if measured > 0 else None
