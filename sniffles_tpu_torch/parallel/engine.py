"""
The fused device calling step: signatures -> clusters -> call statistics
-> coverage annotation -> genotypes -> QC, over one static-shaped batch
(the device-side replacement for the reference's per-object
cluster.resolve + sv.call_from + postprocessing chain).

Copied from sniffles_tpu/parallel/engine.py (default_params :25,
call_pipeline_step :90), where it is one jitted XLA program. Here the
sort, the seeds, the resplit and the call statistics are the torch ops of
ops/clustering.py, and the two stages that would be hundreds of small
launches as torch ops are hand-written kernels on the card: the
relaxation's rounds (ops/merge_relax.py, csrc/merge_relax.cu) and the
candidate tail (ops/candidate_tail.py, csrc/candidate_tail.cu). On CPU
tensors both wrappers take their plain versions.

A batch of N signature slots produces N candidate slots, with the
per-cluster results at cluster indices [0, n_clusters).

A step whose inputs repeat is replayed as one CUDA graph. The step makes
no host synchronisation and launches everything on the current stream,
with shapes fixed by the batch, so a caller that keeps its batches on
the card, or refills one batch's tensors in place, pays the host's
enqueue of its ~111 launches once. The graph is keyed on the inputs'
storage, so a caller that moves each batch from the host anew replays
only where the caching allocator hands back an earlier batch's storage:
on an H100, 10 of 12 such calls where the caller drops the last batch
and its outputs before moving the next, none where it still holds them
then (each call then runs the eager body after one key lookup). The rule
reads only what a call shows (`storage_key`, `launcher_key`, and the use
counts of the last replay's outputs): the first call with a storage key
runs eagerly (it warms the kernels), the second captures the step on a
side stream into a private memory pool and replays it, and later calls
replay it while no column of its previous outputs is held outside the
cache. Everything else, every call on the CPU among it, runs the eager
body (`_eager_step`). `COUNTS` counts the calls by the path that answered
them; a replay adds the captured step's launches to the ops modules'
COUNTS, so that those keep counting launches by kernel.
"""
from __future__ import annotations

import dis
import importlib
import inspect
import logging
import sys
import types
from collections import OrderedDict

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from sniffles_tpu_torch.config import torch_device
from sniffles_tpu_torch.ops import call_stats as _call_stats
from sniffles_tpu_torch.ops import candidate_tail as _candidate_tail
from sniffles_tpu_torch.ops import cluster_sorts as _cluster_sorts
from sniffles_tpu_torch.ops import clustering as _clustering
from sniffles_tpu_torch.ops import merge_relax as _merge_relax
from sniffles_tpu_torch.ops.candidate_tail import candidate_tail
from sniffles_tpu_torch.ops.clustering import call_statistics, cluster_signatures
from sniffles_tpu_torch.ops.segments import seg_sum
from sniffles_tpu_torch.spans import REPLAY, STATS, STEP, TAIL, span

log = logging.getLogger(__name__)

# Calls of call_pipeline_step by the path that answered them: "eager" the
# eager body (the CPU, a first sight, and the two below), "captures" and
# "replays" the graph path (a capture replays at once), "capture_fallbacks"
# a capture that raised (its key runs eagerly after), "held_outputs" a
# graph passed over because its last outputs were still held, "evictions"
# graphs dropped beyond MAX_GRAPHS.
COUNTS = {"eager": 0, "captures": 0, "replays": 0, "capture_fallbacks": 0,
          "held_outputs": 0, "evictions": 0}

# Graphs kept a device, the least recently used dropped first, and storage
# keys remembered a device. Each graph holds its step's memory in a pool of
# its own until it is dropped or clear_graphs() runs, its inputs freed or
# not: at most MAX_GRAPHS steps' footprints a device (about 470 MiB a step
# of 2^21 slots on an H100, so 3.7 GiB; four times that at 2^23).
MAX_GRAPHS = 8
MAX_SEEN = 64

# the modules whose launch counts a replay adds
COUNTED = (_cluster_sorts, _merge_relax, _call_stats, _candidate_tail, _clustering)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def default_params(config=None) -> dict:
    """Scalar parameter dict for the device pipeline, from a SnifflesConfig
    or reference defaults (reference: config.py:449-618)."""
    def g(name, dflt):
        return getattr(config, name, dflt) if config is not None else dflt

    minsupport = g("minsupport", "3")
    is_auto = minsupport == "auto"
    return {
        # clustering
        "cluster_r": float(g("cluster_r", 2.5)),
        "cluster_repeat_h": float(g("cluster_repeat_h", 1.5)),
        "cluster_repeat_h_max": float(g("cluster_repeat_h_max", 1000)),
        "cluster_merge_bnd": int(g("cluster_merge_bnd", 1000)),
        "cluster_merge_len": float(g("cluster_merge_len", 0.22)),
        "minsvlen": int(g("minsvlen", 50)),
        "minsvlen_screen": int(g("minsvlen_screen", 45)),
        "minsvlen_hard_cap": int(bool(g("minsvlen_hard_cap", True))),
        # genotyping
        "genotype_error": float(g("genotype_error", 0.05)),
        "ploidy": float(g("genotype_ploidy", 2)),
        "normalization_target": 250.0,
        "genotype_min_z_score": float(g("genotype_min_z_score", 5)),
        "long_ins_length": float(g("long_ins_length", 2500)),
        "rescale_base": float(g("long_ins_rescale_base", 1.66)),
        "rescale_mult": float(g("long_ins_rescale_mult", 0.33)),
        "detect_large_ins": int(bool(g("detect_large_ins", True))),
        # QC
        "qc_stdev": int(bool(g("qc_stdev", True))),
        "qc_stdev_abs_max": float(g("qc_stdev_abs_max", 500)),
        "qc_strand": int(bool(g("qc_strand", False))),
        "qc_bnd_filter_strand": int(bool(g("qc_bnd_filter_strand", True))),
        "qc_coverage": float(g("qc_coverage", 1)),
        "long_del_length": float(g("long_del_length", 50000)),
        "long_del_coverage": float(g("long_del_coverage", 0.66)),
        "long_dup_length": float(g("long_dup_length", 50000)),
        "long_dup_coverage": float(g("long_dup_coverage", 1.33)),
        "long_inv_length": float(g("long_inv_length", 10000)),
        "dev_longer_del": float(g("dev_longer_del", 200000)),
        "dev_longer_dup": float(g("dev_longer_dup", 200000)),
        "qc_nm": int(bool(g("qc_nm", False))),
        "qc_nm_threshold": float(g("qc_nm_threshold", 0.0)),
        "qc_nm_mult": float(g("qc_nm_mult", 1.66)),
        "dev_min_dup_vaf": float(g("dev_min_dup_vaf", 1 / 6.0)),
        "minsupport_is_auto": int(is_auto),
        "minsupport_const": float(minsupport if not is_auto else 0),
        "minsupport_auto_base": float(g("minsupport_auto_base", 1.5)),
        "minsupport_auto_mult": float(g("minsupport_auto_mult", 0.1)),
        "minsupport_auto_regional_coverage_weight": float(
            g("minsupport_auto_regional_coverage_weight", 0.75)),
        "coverage_global": 30.0,  # overwritten per shard at runtime
        # mosaic
        "mosaic": int(bool(g("mosaic", False))),
        "mosaic_af_min": float(g("mosaic_af_min", 0.05)),
        "mosaic_af_max": float(g("mosaic_af_max", 0.218)),
        "mosaic_min_reads": float(g("mosaic_min_reads", 3)),
        "mosaic_use_strand_thresholds": float(g("mosaic_use_strand_thresholds", 10)),
        "mosaic_qc_strand": int(bool(g("mosaic_qc_strand", True))),
        "mosaic_qc_invdup_min_length": float(g("mosaic_qc_invdup_min_length", 500)),
        "max_svlen_mosaic": float(g("max_svlen_mosaic", 50000)),
        "mosaic_include_germline": int(bool(g("mosaic_include_germline", False))),
    }


def step_device(coverage, device=None) -> torch.device:
    """The step's device: `device` when given, else the coverage tensor's,
    else the port's device path (the card; the CPU only with
    SNIFFLES_TPU_FORCE_CPU; with neither it raises)."""
    if device is not None:
        return torch.device(device)
    if isinstance(coverage, torch.Tensor):
        return coverage.device
    return torch.device(torch_device())


def to_device(sig: dict, coverage, device=None):
    """(sig, coverage) as tensors on the step's device (step_device)."""
    dev = step_device(coverage, device)
    sig = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
           .to(dev) for k, v in sig.items()}
    return sig, torch.as_tensor(coverage).to(dev)


def call_pipeline_step(sig: dict, coverage, params: dict, region_offset=0,
                       binsize: int = 100, resplit_binsize: int = 20, *, device=None,
                       info: dict | None = None) -> dict:
    """
    One fused calling step over a signature batch.

    sig: signature arrays (SignatureBatch.as_dict), tensors or numpy
         arrays; coverage: int32 coverage array for the batch's genome
         window; both go to the step's device (step_device)
    params: default_params() dict; coverage_global and qc_nm_threshold may
            be 0-d tensors of the step's device (a mesh's reductions)
    info: a dict that receives "merge_rounds", the relaxation's rounds
          (an int on the CPU, an int32 0-d tensor on the card)

    Returns candidate tensors [N] (valid for cluster ids < n_clusters):
    svtype, pos, end, svlen, support, qual, stdev_pos, stdev_len,
    gt_(a,b), gq, dr, dv, af, filter_code, qc, precise, ...
    A replayed step (the module's docstring) returns the same keys: each
    [N] column a new alias of the graph's storage, which the next replay
    overwrites unless it is still held; n_clusters and merge_rounds copies.
    """
    with span(STEP):
        args = (sig, coverage, params, region_offset, binsize, resplit_binsize, device)
        skey = storage_key(*args)
        if skey is None:
            COUNTS["eager"] += 1
            return _eager_step(*args, info)
        graphs = _GRAPHS.setdefault(skey[0], StepGraphs())
        key = (skey, launcher_key())
        action, graph = graphs.decide(key)
        if action == CAPTURE:
            graph = _capture(graphs, key, args)
        if graph is None:
            COUNTS["eager"] += 1
            return _eager_step(*args, info)
        COUNTS["captures" if action == CAPTURE else "replays"] += 1
        return graph.replay(info)


def _eager_step(sig, coverage, params, region_offset, binsize, resplit_binsize, device,
                info) -> dict:
    """The step's eager body: the stages on the step's device."""
    sig, coverage = to_device(sig, coverage, device)
    clustered = cluster_signatures(
        sig,
        cluster_r=params["cluster_r"],
        cluster_repeat_h=params["cluster_repeat_h"],
        cluster_repeat_h_max=params["cluster_repeat_h_max"],
        cluster_merge_bnd=params["cluster_merge_bnd"],
        cluster_merge_len=params["cluster_merge_len"],
        minsvlen=params["minsvlen"],
        binsize=binsize,
        resplit_binsize=resplit_binsize,
        # the fused path: the parallel relaxation (a documented deviation
        # of the JAX package); the production call path uses the exact sweep
        exact_sweep=False,
    )
    if info is not None:
        info["merge_rounds"] = clustered.pop("merge_rounds")
    else:
        clustered.pop("merge_rounds")

    with span(STATS):
        stats = call_statistics(clustered, fused=True)
    n = stats["svtype"].shape[0]

    with span(TAIL):
        # split-read support per cluster (reference: sv.py:580-581 counts
        # source != INLINE leads into SUPPORT_SA for the DEL genotyper)
        sa = clustered.get("sa")
        support_sa = (seg_sum((clustered["valid"] & (sa > 0)).to(torch.int32),
                              clustered["cluster_id"], n)
                      if sa is not None else torch.zeros_like(stats["support"]))
        tail = candidate_tail(stats, support_sa, coverage, clustered, params,
                              region_offset=region_offset, binsize=binsize)
    out = dict(stats)
    out.update(tail)
    return out


# -- the graph path ---------------------------------------------------------

EAGER, CAPTURE, REPLAY_STEP = "eager", "capture", "replay"
_NUMBERS = (bool, int, float, np.integer, np.floating)


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def storage_key(sig: dict, coverage, params: dict, region_offset=0, binsize: int = 100,
                resplit_binsize: int = 20, device=None):
    """What a captured step depends on besides the launchers (input_key),
    for inputs on a CUDA device; None where the call cannot replay: the
    coverage is no CUDA tensor (every CPU call), `device` names another
    device, an input is not on the coverage's device (input_key), or the
    stream is capturing already."""
    if not (isinstance(coverage, torch.Tensor) and coverage.is_cuda):
        return None
    dev = coverage.device
    if device is not None:
        want = torch.device(device)
        if want.type != "cuda" or want.index not in (None, dev.index):
            return None
    if torch.cuda.is_current_stream_capturing():
        return None
    return input_key(sig, coverage, params, region_offset, binsize, resplit_binsize)


def input_key(sig: dict, coverage, params: dict, region_offset=0, binsize: int = 100,
              resplit_binsize: int = 20):
    """(the coverage's device, (name, data_ptr, shape, stride, dtype) of
    every signature column in order, the coverage's layout, the parameters
    (a number by its type and value, a 0-d tensor by its layout),
    region_offset, binsize, resplit_binsize); None where a column, a
    tensor parameter or a tensor region_offset is not on the coverage's
    device, or a parameter is neither a number nor a 0-d tensor."""
    dev = coverage.device

    def on_dev(t) -> bool:
        return isinstance(t, torch.Tensor) and t.device == dev

    if not all(on_dev(v) for v in sig.values()):
        return None
    ps = []
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            if not on_dev(v) or v.dim() != 0:
                return None
            ps.append((k, _layout(v)))
        elif isinstance(v, _NUMBERS):
            ps.append((k, type(v), v))
        else:
            return None
    if isinstance(region_offset, torch.Tensor):
        if not on_dev(region_offset):
            return None
        offset = _layout(region_offset)
    elif isinstance(region_offset, _NUMBERS):
        offset = (type(region_offset), region_offset)
    else:
        return None
    return (dev, tuple((k, *_layout(v)) for k, v in sig.items()), _layout(coverage),
            tuple(ps), offset, int(binsize), int(resplit_binsize))


PACKAGE = __name__.split(".")[0]


def _ours(obj) -> bool:
    if isinstance(obj, types.ModuleType):
        return obj.__name__.startswith(PACKAGE + ".")
    return (isinstance(obj, types.FunctionType) or hasattr(obj, "__wrapped__")) and \
        getattr(obj, "__module__", "").startswith(PACKAGE + ".")


def _named(code: types.CodeType) -> tuple:
    """(the names in code and in the code nested in it, the modules of the
    port it imports)"""
    names, mods, codes = set(), [], [code]
    while codes:
        c = codes.pop()
        names.update(c.co_names)
        codes.extend(k for k in c.co_consts if isinstance(k, types.CodeType))
        where = None
        for ins in dis.get_instructions(c):
            if ins.opname == "IMPORT_NAME" and ins.argval.startswith(PACKAGE):
                where = importlib.import_module(ins.argval)
                mods.append(where)
            elif ins.opname == "IMPORT_FROM" and where is not None \
                    and not hasattr(where, ins.argval):
                try:
                    importlib.import_module(f"{where.__name__}.{ins.argval}")
                except ImportError:
                    pass
    return names, mods


def reached_slots(fn) -> tuple:
    """The (module, attribute) pairs through which fn, and every function
    of the port that it reaches so, finds a function of the port: each
    global name of a function's module, and each attribute of a module of
    the port that the function names or imports. Read from the names in
    the code, so it errs towards more pairs, never fewer."""
    slots, done, todo = {}, set(), [fn]
    while todo:
        f = inspect.unwrap(todo.pop())
        if f in done or not hasattr(f, "__code__"):
            continue
        done.add(f)
        names, mods = _named(f.__code__)
        home = sys.modules[f.__module__]
        mods = [home, *mods, *(v for v in vars(home).values() if _ours(v)
                               and isinstance(v, types.ModuleType))]
        mods += [v for m in list(mods) for n in sorted(names)
                 if isinstance(v := vars(m).get(n), types.ModuleType) and _ours(v)]
        for m in dict.fromkeys(mods):
            for n in sorted(names):
                v = vars(m).get(n)
                if not isinstance(v, types.ModuleType) and _ours(v):
                    slots[(m, n)] = None
                    todo.append(v)
    return tuple(slots)


def launcher_key() -> tuple:
    """The objects bound now to the LAUNCHERS slots, in order."""
    return tuple(d[name] for d, name in _SLOTS)


def _use_count(ref: StorageWeakRef) -> int:
    return torch._C._storage_Use_Count(ref.cdata)


class StepGraph:
    """One captured step: the graph (anything with replay()), its static
    outputs, the relaxation's rounds word, the launches a replay adds to
    the ops modules' COUNTS ({module: {key: launches}}), and the use count
    of each storage of its [N] columns at capture, with the cache's own
    references alone."""

    def __init__(self, graph, outputs: dict, rounds, launches: dict):
        self.graph, self.outputs, self.rounds, self.launches = graph, outputs, rounds, launches
        storages = {}
        for v in outputs.values():
            if v.dim():
                st = v.untyped_storage()
                storages.setdefault(st.data_ptr(), st)
        self.refs = [StorageWeakRef(st) for st in storages.values()]
        self.baseline = [_use_count(r) for r in self.refs]

    def held(self) -> bool:
        """Whether a tensor or view of the last outputs' columns is held
        outside the cache (a replay would overwrite it)."""
        return any(_use_count(r) > b for r, b in zip(self.refs, self.baseline))

    def replay(self, info: dict | None = None) -> dict:
        """Replays the step on the current stream: the outputs' keys, each
        column a new alias of the static storage, each 0-d output (and
        info's merge_rounds) a copy."""
        with span(REPLAY):
            self.graph.replay()
        for mod, launches in self.launches.items():
            for k, v in launches.items():
                mod.COUNTS[k] += v
        if info is not None:
            info["merge_rounds"] = self.rounds.clone()
        return {k: v.view_as(v) if v.dim() else v.clone() for k, v in self.outputs.items()}


class StepGraphs:
    """The graphs of one device by (storage key, launcher key), least
    recently used first, and the storage keys seen (the first sight of
    one runs eagerly)."""

    def __init__(self, max_graphs: int = MAX_GRAPHS, max_seen: int = MAX_SEEN):
        self.max_graphs, self.max_seen = max_graphs, max_seen
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()
        self.failed: OrderedDict = OrderedDict()
        # {shape_key: bytes a capture of those shapes made the allocator reserve}
        self.footprint: OrderedDict = OrderedDict()
        self.stream = None          # the side stream captures run on

    def decide(self, key: tuple) -> tuple:
        """(EAGER, None), (CAPTURE, None) or (REPLAY_STEP, graph) for a
        call with key (storage key, launcher key); notes the storage key
        as seen."""
        skey = key[0]
        first = skey not in self.seen
        self.seen[skey] = None
        self.seen.move_to_end(skey)
        while len(self.seen) > self.max_seen:
            self.seen.popitem(last=False)
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            if graph.held():
                COUNTS["held_outputs"] += 1
                return EAGER, None
            return REPLAY_STEP, graph
        if first or key in self.failed:
            return EAGER, None
        return CAPTURE, None

    def add(self, key: tuple, graph: StepGraph) -> None:
        self.graphs[key] = graph
        self.graphs.move_to_end(key)
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
            COUNTS["evictions"] += 1

    def fail(self, key: tuple) -> None:
        self.failed[key] = None
        while len(self.failed) > self.max_seen:
            self.failed.popitem(last=False)

    def note_footprint(self, shape: tuple, nbytes: int) -> None:
        self.footprint[shape] = nbytes
        while len(self.footprint) > self.max_seen:
            self.footprint.popitem(last=False)


def shape_key(skey: tuple) -> tuple:
    """A storage key without its pointers: the device, each column's name,
    shape, stride and dtype, and the coverage's (the step's allocations
    depend on these alone)."""
    return (skey[0], tuple(c[:1] + c[2:] for c in skey[1]), skey[2][1:])


# {device: StepGraphs}
_GRAPHS: dict = {}


def clear_graphs() -> None:
    """Drops every captured step and every storage key seen (the next call
    of each key is a first sight)."""
    _GRAPHS.clear()


def _capture(graphs: StepGraphs, key: tuple, args: tuple):
    """Captures the eager body on `args` into a graph of its own memory
    pool, on a side stream of the step's device, and files it under `key`.
    Where an earlier capture of its shape_key noted its pool's size, the
    pool reserves that as one block first.
    Returns the StepGraph, or None where the capture raised (counted; the
    key runs eagerly after)."""
    dev = key[0][0]
    shape = shape_key(key[0])
    reserve = graphs.footprint.get(shape)
    before = {mod: dict(mod.COUNTS) for mod in COUNTED}
    info: dict = {}
    try:
        if graphs.stream is None:
            graphs.stream = torch.cuda.Stream(dev)
        stream = graphs.stream
        current = torch.cuda.current_stream(dev)
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        with torch.cuda.device(dev):
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                # thread_local: the profiler's and a service's threads may
                # call the runtime meanwhile
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    if reserve:
                        # the pool's memory as one block, freed at once, which
                        # the allocator splits for the step: a cudaMalloc
                        # costs by the call (14-15 a 2^21 step), not the byte
                        torch.empty(reserve, dtype=torch.uint8, device=dev)
                    outputs = _eager_step(*args, info)
                finally:
                    graph.capture_end()
            current.wait_stream(stream)
        grown = torch.cuda.memory_reserved(dev) - reserved
    except Exception:
        log.warning("engine: a step's capture failed; these inputs run eagerly",
                    exc_info=True)
        for mod, counts in before.items():
            mod.COUNTS.update(counts)
        COUNTS["capture_fallbacks"] += 1
        graphs.fail(key)
        return None
    launches = {}
    for mod, counts in before.items():
        added = {k: v - counts.get(k, 0) for k, v in mod.COUNTS.items() if v != counts.get(k, 0)}
        if added:
            launches[mod] = added
    if grown > (reserve or 0):
        graphs.note_footprint(shape, grown)
    step = StepGraph(graph, outputs, info["merge_rounds"], launches)
    graphs.add(key, step)
    return step


# The slots the step reaches functions of the port through: a graph
# replays what they were bound to at its capture, so a call that finds one
# rebound (a test's double, a tool's or the benchmark's wrapper) captures
# anew.
LAUNCHERS = reached_slots(_eager_step)
_SLOTS = tuple((vars(mod), name) for mod, name in LAUNCHERS)
