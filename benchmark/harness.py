"""The benchmark's harness: finds a cell's files by the names in
BENCHMARK.json, runs its driver, reads its per-layer metrics, decides
`correct` and prints the result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in a file of its own under benchmark/, found by
its name:
  BENCHMARK.json's cell   -> workloads/<cell>.json (its driver, how many
                             steps or calls its traced run profiles, how
                             many answers its check samples)
  the cell's `config`     -> configs/<config>.json (sizes, parameters,
                             guarantees, the limits of the check)
  the cell's `traffic`    -> traffic/<traffic>.json (the generator and
                             its parameters; traffic/generate.py)
  the workload's driver   -> drivers/<driver>.py (the entry the window
                             drives: setup, window, traced, release, check)
  a per-layer metric      -> metrics/<metric>.py, whose read(trace)
                             returns the number or None
A later cell, configuration or metric is new files and entries.

A run: set-up (the inputs from the seed, the kernels from the checkout's
build cache, a warm call of the cell's own shape; `setup_s`), then with
--trace 0 the measured window and the end-to-end metrics, with --trace 1
a profiled window of a fixed count of steps or calls and the per-layer
metrics; then the device's peak memory, the program's state freed, and
the check against the plain reference (benchmark/reference), whose
numbers are printed beside their limits on stderr and, under "checks",
as the last key of the result line, the last line of stdout.
"""
from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "sniffles_tpu")
SPAN = "bench: "          # the prefix of the benchmark's own record_function ranges
EXIT_NO_PROGRAM, EXIT_NO_CARD, EXIT_BANNED = 3, 4, 5


@dataclass
class Cell:
    name: str
    entry: dict           # BENCHMARK.json's workload entry
    config: dict          # configs/<config>.json
    workload: dict        # workloads/<cell>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list       # BENCHMARK.json's per-layer metrics this cell reports
    root: str             # where BENCHMARK.json and the cell's files were found


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str           # "cuda", or "cpu" in the tests
    control: str | None = None   # None, or the control's form ("full", "tail")


@dataclass
class Trace:
    """What a traced window left to the per-layer metrics' readers."""
    window_s: float = 0.0
    units: int = 0                                     # steps or calls profiled
    device_events: list = field(default_factory=list)  # (name, start us, end us)
    host_events: list = field(default_factory=list)    # (name, start us, end us)
    window_us: tuple = (0.0, 0.0)
    failed: int = 0                                    # steps or calls that failed
    bounds: list = field(default_factory=list)         # (kernel name part, bound s)

    def kernels(self) -> list:
        """Device kernels (copies and fills left out)."""
        return [e for e in self.device_events if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        """Seconds in the window in which some operation ran on the device."""
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_events
                       if e > lo and s < hi)
        busy, end = 0.0, lo
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def idle_gaps(self, top: int = 10) -> list:
        """[(what the host was doing, seconds)] of the device's idle time
        in the window, by the innermost host range at each gap's middle."""
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_events
                       if e > lo and s < hi)
        gaps, end = [], lo
        for s, e in spans + [(hi, hi)]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        host = sorted(self.host_events, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: dict = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            inner = None
            for h in host[:bisect.bisect_right(starts, mid)]:
                if h[2] >= mid and (inner is None or h[2] - h[1] < inner[2] - inner[1]):
                    inner = h
            label = inner[0] if inner else "no host range"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.device_events:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def note(what: str, t0: float) -> None:
    """A line on stderr: what took how long since t0 (set-up's parts)."""
    print(f"benchmark: {what} {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def _find(root: str, *parts) -> str:
    """The file under `root`, or else the checkout's own (a tests' root
    holds only what it adds)."""
    path = os.path.join(root, *parts)
    return path if os.path.exists(path) else os.path.join(ROOT, *parts)


def _load_json(root: str, *parts) -> dict:
    with open(_find(root, *parts)) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """benchmark/<kind>/<name>.py under `root` (_find), loaded by its path."""
    path = _find(root, "benchmark", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root's BENCHMARK.json with its files."""
    bench = _load_json(root, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    reported = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in reported}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=name, entry=entry,
                config=_load_json(root, "benchmark", "configs", f"{entry['config']}.json"),
                workload=_load_json(root, "benchmark", "workloads", f"{name}.json"),
                traffic=_load_json(root, "benchmark", "traffic", f"{entry['traffic']}.json"),
                end_to_end=reported, per_layer=per_layer, root=root)


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into build/torch_kernels there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def device_info(run: Run, torch) -> dict:
    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.entry["chips"],
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def profiled(fn, on_card: bool):
    """fn() under torch.profiler (CPU and, on the card, CUDA activities)
    inside a range of the benchmark's own, the device synchronised at its
    end. Returns (fn's value, Trace with the events and the window)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN + "window"):
            out = fn()
            if on_card:
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    trace = Trace()
    for e in prof.events():
        ev = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if not e.name.startswith((SPAN, "Activity Buffer")):
                trace.device_events.append(ev)
        elif e.name == SPAN + "window":
            trace.window_us = ev[1:]
        else:
            trace.host_events.append(ev)
    trace.window_s = (trace.window_us[1] - trace.window_us[0]) / 1e6
    return out, trace


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", nargs="?", const="full", choices=("full", "tail"),
                    help="the cell's control in the program's place (configs: `control`); "
                         "its check must come out false. `tail`: the control's second form, "
                         "where the cell has one")
    return ap.parse_args(argv)


def main(argv=None, root: str = ROOT, require_card: bool = True) -> int:
    """One run of a cell (the module's docstring). `root` holds the
    BENCHMARK.json and files the cell is looked up in; `require_card`
    False (the CPU tests) runs on the CPU under SNIFFLES_TPU_FORCE_CPU."""
    args = _parse(argv)
    cell = load_cell(args.workload, root)
    if not os.path.isdir(os.path.join(ROOT, "sniffles_tpu_torch")):
        print("benchmark: the port (sniffles_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return EXIT_NO_PROGRAM
    import torch
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            print(f"benchmark: {cell.name} needs {cell.entry['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return EXIT_NO_CARD
        os.environ.pop("SNIFFLES_TPU_FORCE_CPU", None)
        device = "cuda"
    else:
        os.environ["SNIFFLES_TPU_FORCE_CPU"] = "1"
        device = "cpu"
    cache_env()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    driver = load_module(root, "drivers", cell.workload["driver"])
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, control=args.control)
    t0 = time.perf_counter()
    state = driver.setup(run)
    setup_s = time.perf_counter() - t0
    breakdown = None
    if run.trace:
        trace = driver.traced(run, state)
        metrics = {}
        for m in cell.per_layer:
            value = load_module(root, "metrics", m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = trace.units, trace.failed
        breakdown = {"device_ops": [list(x) for x in trace.device_ops()],
                     "idle_gaps": [list(x) for x in trace.idle_gaps()]}
    else:
        out = driver.window(run, state)
        out["metrics"]["setup_s"] = setup_s
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        attempted, failed = out["attempted"], out["failed"]
    device = device_info(run, torch)
    if run.trace:
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    driver.release(run, state)
    checks = driver.check(run, state)
    bad = banned_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; nothing it runs may",
              file=sys.stderr)
        return EXIT_BANNED
    correct = failed == 0 and all(value <= limit for _, value, limit in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
