"""Driver of the engine cells: the port's fused calling step,
sniffles_tpu_torch.parallel.engine.call_pipeline_step, over batches of
signature slots on the card.

Set-up makes the mix's `batches` distinct batches from the seed
(traffic/generate.signature_batches) and the contig's coverage on the
card, builds the kernels (the checkout's build cache), and runs one step
of each batch, which also reads each batch's cluster count. The window
enqueues steps back to back, batch i % B at step i; each step's candidate
rows [0, n_clusters) are stacked into an int32, a float32 and a bool
tensor and copied to pinned host memory without a synchronisation, as a
caller consumes them. The window ends in torch.cuda.synchronize(). The
check compares the rows of the steps the seed samples (and of each
batch's last step) with the plain reference (benchmark/reference/engine.py),
which works each batch out again from its signatures on the CPU.
"""
from __future__ import annotations

import time
import types

import numpy as np

from benchmark.harness import SPAN, Trace, note, profiled
from benchmark.metrics import _peaks
from benchmark.reference import engine as ref


def setup(run):
    import torch
    from benchmark.traffic.generate import coverage, signature_batches
    t0 = time.perf_counter()
    mix = run.cell.traffic
    batches = signature_batches(mix, run.seed)
    note("set-up: batches made", t0)
    if run.device == "cuda":
        from sniffles_tpu_torch.ops import _build
        _build.build_all()
    note("set-up: kernels built", t0)
    from sniffles_tpu_torch.parallel import engine
    conf = run.cell.config["engine"]
    params = engine.default_params(types.SimpleNamespace(**conf["params"]))
    params["coverage_global"] = float(conf["coverage_global"])
    cov = coverage(mix, run.device)
    on_dev = [engine.to_device(b, cov, run.device)[0] for b in batches]
    outs = [engine.call_pipeline_step(sig, cov, params) for sig in on_dev]
    n_clusters = [int(o["n_clusters"]) for o in outs]
    del outs
    pin = run.device == "cuda"

    def buffers(nc):
        return (torch.empty((len(ref.INT_KEYS), nc), dtype=torch.int32, pin_memory=pin),
                torch.empty((len(ref.FLOAT_KEYS), nc), dtype=torch.float32, pin_memory=pin),
                torch.empty((len(ref.BOOL_KEYS), nc), dtype=torch.bool, pin_memory=pin),
                torch.empty((1,), dtype=torch.int32, pin_memory=pin))

    check = run.cell.workload["check"]
    rng = np.random.default_rng([run.seed, 1])
    below = check["sample_below"] if not run.trace else run.cell.workload["trace_steps"]
    sampled = sorted(int(i) for i in rng.choice(below, size=min(check["sample_steps"], below),
                                                replace=False))
    state = {"engine": engine, "params": params, "batches": batches, "coverage": cov,
             "on_dev": on_dev, "n_clusters": n_clusters,
             "sampled": {i: buffers(n_clusters[i % len(batches)]) for i in sampled},
             "last": [buffers(nc) for nc in n_clusters], "steps": 0}
    # the consumption path too (its stacks and copies load kernels of their own)
    for i in range(len(batches)):
        _step(state, i)
    state["last_step"] = [None] * len(batches)
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    note("set-up: warm steps done", t0)
    return state


def _step(state, i: int) -> None:
    """Step i of the window: batch i % B, its rows copied to pinned memory."""
    import torch
    b = i % len(state["on_dev"])
    out = state["engine"].call_pipeline_step(state["on_dev"][b], state["coverage"],
                                             state["params"])
    nc = state["n_clusters"][b]
    dst = state["sampled"].get(i)
    if dst is None:
        dst = state["last"][b]
        state.setdefault("last_step", [None] * len(state["on_dev"]))[b] = i
    for rows, keys in zip(dst[:3], (ref.INT_KEYS, ref.FLOAT_KEYS, ref.BOOL_KEYS)):
        rows.copy_(torch.stack([out[k][:nc] for k in keys]), non_blocking=True)
    dst[3].copy_(out["n_clusters"].view(1).to(torch.int32), non_blocking=True)


def _sync(run):
    if run.device == "cuda":
        import torch
        torch.cuda.synchronize()


def window(run, state) -> dict:
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        _step(state, i)
        i += 1
    _sync(run)
    window_s = time.perf_counter() - t0
    state["steps"] = i
    n = run.cell.traffic["n_signatures"]
    return {"metrics": {"engine_signatures_per_s": i * n / window_s},
            "attempted": i, "failed": 0}


def traced(run, state) -> Trace:
    """trace_steps steps under the profiler, each call of the engine's
    step in a range of its own (its rows' copies outside it), with the
    bound of every launch of the roofline's kernels recorded from its
    arguments (metrics/_peaks.py)."""
    import torch
    steps = run.cell.workload["trace_steps"]
    recorded = []
    engine = state["engine"]

    def step(*args, **kwargs):
        with torch.profiler.record_function(SPAN + "step"):
            return engine.call_pipeline_step(*args, **kwargs)
    state["engine"] = types.SimpleNamespace(call_pipeline_step=step)
    try:
        with _peaks.recording(recorded):
            def go():
                for i in range(steps):
                    _step(state, i)
            _, trace = profiled(go, run.device == "cuda")
    finally:
        state["engine"] = engine
    state["steps"] = steps
    trace.units = steps
    trace.bounds = _peaks.resolve(recorded)
    return trace


def release(run, state) -> None:
    state.pop("on_dev")
    state.pop("engine")
    state.pop("coverage")
    if run.device == "cuda":
        import torch
        torch.cuda.empty_cache()


def _rows(dst) -> dict:
    """{key: numpy array [n_clusters]} of a step's copied rows; none where
    the step's own cluster count differs from the rows copied."""
    if int(dst[3][0]) != dst[0].shape[1]:
        return {k: np.zeros(0) for k in ref.INT_KEYS + ref.FLOAT_KEYS + ref.BOOL_KEYS}
    out = {}
    for rows, keys in zip(dst[:3], (ref.INT_KEYS, ref.FLOAT_KEYS, ref.BOOL_KEYS)):
        out.update(zip(keys, rows.numpy()))
    return out


def check(run, state) -> list:
    """[("rows_differ", n, limit), ("float_gap", g, limit),
    ("steps_unchecked", 0 or 1, 0)] over the checked steps: the rows whose
    integer or boolean keys differ from the reference's (every row of a
    step whose cluster count differs), and the widest relative gap of a
    float key (reference/engine.compare). With run.control the reference
    in bfloat16 stands in the program's place ("tail": its clustering in
    float32)."""
    from benchmark.traffic.generate import coverage
    limits = run.cell.config["limits"]
    params = ref.default_params(run.cell.config["engine"]["params"])
    params["coverage_global"] = float(run.cell.config["engine"]["coverage_global"])
    B = len(state["batches"])
    checked = {i: dst for i, dst in state["sampled"].items() if i < state["steps"]}
    for b, i in enumerate(state["last_step"]):
        if i is not None and i not in checked:
            checked[i] = state["last"][b]
    cov = coverage(run.cell.traffic)
    t0 = time.perf_counter()
    differ, gap, n_checked = 0, 0.0, 0
    for b in range(B):
        mine = [dst for i, dst in checked.items() if i % B == b]
        if not mine:
            continue
        want = ref.engine_step(state["batches"][b], cov, params)
        if run.control:
            got = ref.engine_step(state["batches"][b], cov, params, ref.bf16,
                                  ref.f32 if run.control == "tail" else None)
            results = [got] * len(mine)
        else:
            results = [_rows(dst) for dst in mine]
        for got in results:
            n_checked += 1
            c = ref.compare(got, want)
            differ += c["rows_differ"]
            gap = max(gap, c["float_gap"])
    note("check: reference run", t0)
    return [("rows_differ", differ, limits["rows_differ"]),
            ("float_gap", gap, limits["float_gap"]),
            ("steps_unchecked", 0 if n_checked else 1, 0)]
