"""The fused engine's graph path (sniffles_tpu_torch/parallel/engine.py) on
the CPU, where it never engages: its keys (storage_key, input_key,
launcher_key), its decisions (StepGraphs), a captured step's outputs and
counts (StepGraph, with a stand-in graph whose replay reruns the eager
body into the captured outputs), and call_pipeline_step's dispatch with
the key opened to CPU tensors. The card's own captures and replays:
tests/test_torch_gpu.py."""
import weakref

import pytest
import torch

from sniffles_tpu_torch import spans
from sniffles_tpu_torch.ops import merge_relax
from sniffles_tpu_torch.parallel import engine
from sniffles_tpu_torch.signatures import synthetic_batch
from sniffles_tpu_torch.tools.profile_engine import engine_inputs


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")


@pytest.fixture(autouse=True)
def fresh_cache():
    engine.clear_graphs()
    engine.reset_counts()
    yield
    engine.clear_graphs()


@pytest.fixture(scope="module")
def step_inputs():
    return engine_inputs(4096, "cpu")


def key_of(sig, coverage, params, **kw):
    return engine.input_key(sig, coverage, params, **kw)


class RerunGraph:
    """A graph's stand-in: replay() reruns the eager body on the inputs it
    was made with, into the captured outputs, in place."""

    def __init__(self, args):
        self.args, self.outputs, self.replays = args, None, 0

    def replay(self):
        self.replays += 1
        fresh = engine._eager_step(*self.args, None)
        for k, v in self.outputs.items():
            v.copy_(fresh[k])


def captured(args, launches=None) -> engine.StepGraph:
    graph = RerunGraph(args)
    info = {}
    outputs = engine._eager_step(*args, info)
    graph.outputs = outputs
    return engine.StepGraph(graph, outputs, torch.tensor(info["merge_rounds"]),
                            launches or {})


def step_args(step_inputs):
    sig, coverage, params = step_inputs
    return (sig, coverage, params, 0, 100, 20, None)


def test_cpu_tensors_never_engage_the_graph(step_inputs):
    sig, coverage, params = step_inputs
    assert engine.storage_key(sig, coverage, params) is None
    for _ in range(3):
        engine.call_pipeline_step(sig, coverage, params)
    assert engine.COUNTS == dict(engine.COUNTS, eager=3, captures=0, replays=0,
                                 capture_fallbacks=0)
    assert engine._GRAPHS == {}


def test_first_sight_is_eager_and_the_second_captures(step_inputs):
    graphs = engine.StepGraphs()
    key = (key_of(*step_inputs), engine.launcher_key())
    assert graphs.decide(key) == (engine.EAGER, None)
    assert graphs.decide(key) == (engine.CAPTURE, None)
    graph = captured(step_args(step_inputs))
    graphs.add(key, graph)
    assert graphs.decide(key) == (engine.REPLAY_STEP, graph)


def relaid(t: torch.Tensor, how: str) -> torch.Tensor:
    """t with one part of its layout changed, the others kept."""
    if how == "pointer":
        return t.clone()
    if how == "shape":
        return t[:-1]
    if how == "stride":
        return t.as_strided(t.shape, (0,))
    return t.view(torch.uint8 if t.dtype == torch.bool else torch.float32)


@pytest.mark.parametrize("how", ["pointer", "shape", "stride", "dtype"])
@pytest.mark.parametrize("column", ["pos", "valid", "coverage"])
def test_each_input_layout_makes_a_new_key(step_inputs, column, how):
    sig, coverage, params = step_inputs
    key = key_of(sig, coverage, params)
    assert key_of(dict(sig), coverage, dict(params)) == key
    if column == "coverage":
        other = key_of(sig, relaid(coverage, how), params)
    else:
        other = key_of({**sig, column: relaid(sig[column], how)}, coverage, params)
    assert other is not None and other != key


@pytest.mark.parametrize("change", ["a number", "a number's type", "a 0-d tensor", "binsize",
                                    "resplit_binsize", "region_offset", "a column's name"])
def test_each_scalar_makes_a_new_key(step_inputs, change):
    sig, coverage, params = step_inputs
    key = key_of(sig, coverage, params)
    kw = {}
    if change == "a number":
        params = dict(params, cluster_r=params["cluster_r"] + 0.5)
    elif change == "a number's type":
        params = dict(params, minsvlen=float(params["minsvlen"]))
    elif change == "a 0-d tensor":
        words = torch.tensor([30.0, 30.0])
        key = key_of(sig, coverage, dict(params, coverage_global=words[0]))
        params = dict(params, coverage_global=words[1])
    elif change == "a column's name":
        sig = {("pos2" if k == "pos" else k): v for k, v in sig.items()}
    else:
        kw[change] = 7
    other = key_of(sig, coverage, params, **kw)
    assert other is not None and other != key


def test_inputs_off_the_coverage_device_make_no_key(step_inputs):
    sig, coverage, params = step_inputs
    meta = torch.empty(4, device="meta")
    assert key_of({**sig, "pos": sig["pos"].numpy()}, coverage, params) is None
    assert key_of({**sig, "pos": meta}, coverage, params) is None
    assert key_of(sig, coverage, dict(params, coverage_global=meta[0])) is None
    assert key_of(sig, coverage, dict(params, coverage_global=[30.0])) is None
    assert key_of(sig, coverage, params, region_offset=meta[0]) is None


def test_a_rebound_launcher_makes_a_new_launcher_key(step_inputs, monkeypatch):
    graphs = engine.StepGraphs()
    skey, lkey = key_of(*step_inputs), engine.launcher_key()
    assert engine.launcher_key() == lkey
    assert graphs.decide((skey, lkey)) == (engine.EAGER, None)

    def double(*args, **kwargs):
        return merge_relax.launch_merge_relax(*args, **kwargs)
    monkeypatch.setattr(merge_relax, "launch_merge_relax", double)
    rebound = engine.launcher_key()
    assert rebound != lkey and double in rebound
    # the storage key was seen: the new launcher key captures at once
    assert graphs.decide((skey, rebound)) == (engine.CAPTURE, None)
    monkeypatch.undo()
    assert engine.launcher_key() == lkey


def test_the_launchers_are_the_step_s_entry_points():
    bound = {(mod.__name__.rsplit(".", 1)[-1], name) for mod, name in engine.LAUNCHERS}
    assert {("cluster_sorts", "launch_gather"), ("cluster_sorts", "launch_marks"),
            ("cluster_sorts", "launch_seg_sort"), ("merge_relax", "launch_merge_relax"),
            ("call_stats", "sort_keys"), ("call_stats", "launch_kernels"),
            ("candidate_tail", "launch_candidate_tail"), ("clustering", "_launch"),
            ("engine", "candidate_tail"), ("_build", "load")} <= bound
    for mod, name in engine.LAUNCHERS:
        assert callable(getattr(mod, name)), (mod.__name__, name)
    assert len(engine.launcher_key()) == len(engine.LAUNCHERS)


def test_the_launchers_cover_every_function_the_step_calls(step_inputs):
    """Every function of the port that an eager step calls, found by
    tracing the calls, is bound in a slot of LAUNCHERS (a nested
    function or a method is reached through one that is)."""
    import sys
    called = set()

    def note(frame, event, arg):
        if event == "call":
            called.add(frame.f_code)
    sys.setprofile(note)
    try:
        engine._eager_step(*step_args(step_inputs), None)
    finally:
        sys.setprofile(None)
    bound = {getattr(vars(mod)[name], "__code__", None) for mod, name in engine.LAUNCHERS}
    bound |= {getattr(getattr(vars(mod)[name], "__wrapped__", None), "__code__", None)
              for mod, name in engine.LAUNCHERS}
    ours = {c for c in called if c.co_filename.startswith(engine.__file__.rsplit("/", 2)[0])
            and "<" not in c.co_qualname and "." not in c.co_qualname}
    assert engine._eager_step.__code__ in ours and len(ours) > 20
    assert ours - bound == {engine._eager_step.__code__}


@pytest.mark.parametrize("module, name", [
    ("cluster_sorts", "launch_gather"), ("cluster_sorts", "launch_marks"),
    ("cluster_sorts", "launch_seg_sort"), ("merge_relax", "launch_merge_relax"),
    ("call_stats", "sort_keys"), ("candidate_tail", "launch_candidate_tail"),
    ("clustering", "_launch"), ("segments", "seg_sum")])
def test_rebinding_a_launcher_changes_the_launcher_key(module, name, monkeypatch):
    import importlib
    mod = importlib.import_module(f"sniffles_tpu_torch.ops.{module}")
    lkey = engine.launcher_key()
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: fn(*a, **k))
    assert engine.launcher_key() != lkey
    monkeypatch.undo()
    assert engine.launcher_key() == lkey


def test_the_roofline_recorder_s_wrappers_change_the_launcher_key():
    """The benchmark's roofline recorder rebinds launchers in slots of
    LAUNCHERS: a step inside it captures anew, and after it the key is
    the one before."""
    from benchmark.metrics._peaks import recording
    lkey = engine.launcher_key()
    with recording([]):
        rebound = engine.launcher_key()
        changed = {(m.__name__.rsplit(".", 1)[-1], n)
                   for (m, n), a, b in zip(engine.LAUNCHERS, lkey, rebound) if a is not b}
    assert changed == {("cluster_sorts", "launch_gather"), ("cluster_sorts", "launch_marks"),
                       ("merge_relax", "launch_merge_relax"), ("call_stats", "sort_keys"),
                       ("candidate_tail", "launch_candidate_tail")}
    assert engine.launcher_key() == lkey


@pytest.mark.parametrize("hold", ["column", "slice"])
def test_a_held_column_sends_the_call_down_the_eager_path(step_inputs, hold):
    graphs = engine.StepGraphs()
    key = (key_of(*step_inputs), engine.launcher_key())
    graph = captured(step_args(step_inputs))
    graphs.add(key, graph)
    assert not graph.held()
    out = graph.replay()
    kept = out["svlen"] if hold == "column" else out["qc"][10:20]
    del out
    assert graph.held()
    assert graphs.decide(key) == (engine.EAGER, None)
    assert engine.COUNTS["held_outputs"] == 1
    del kept
    assert not graph.held()
    assert graphs.decide(key) == (engine.REPLAY_STEP, graph)


def test_held_0d_outputs_and_internal_tensors_do_not_block(step_inputs):
    graph = captured(step_args(step_inputs))
    info = {}
    out = graph.replay(info)
    n_clusters, rounds = out["n_clusters"], info["merge_rounds"]
    assert n_clusters.dim() == 0 and n_clusters.data_ptr() != graph.outputs["n_clusters"].data_ptr()
    assert int(rounds) == int(graph.rounds)
    # a reference to the captured 0-d words themselves, as a recorder keeps
    internal = (graph.outputs["n_clusters"], graph.rounds)
    del out
    assert not graph.held()
    assert internal and int(n_clusters) > 0


def test_replays_alias_the_static_storage_and_follow_a_refill(step_inputs):
    sig, coverage, params = step_inputs
    sig = {k: v.clone() for k, v in sig.items()}
    args = (sig, coverage, params, 0, 100, 20, None)
    graph = captured(args)
    out = graph.replay()
    assert out.keys() == graph.outputs.keys()
    for k, v in out.items():
        if v.dim():
            assert v is not graph.outputs[k] and v.data_ptr() == graph.outputs[k].data_ptr()
    want = {k: v.clone() for k, v in out.items()}
    del out
    # a refill in place with another batch's contents
    b = synthetic_batch(4096, 90, seed=9, genome_span=900_000, batch_size=4096).as_dict()
    for k, v in sig.items():
        v.copy_(torch.as_tensor(b[k]))
    eager = engine._eager_step(*args, None)
    got = graph.replay()
    assert any(not torch.equal(want[k], eager[k]) for k in want)
    for k, v in eager.items():
        assert torch.equal(got[k], v), k


class Counted:
    """A module's stand-in: a COUNTS dict."""

    def __init__(self, **counts):
        self.COUNTS = counts


def test_a_replay_adds_the_captured_launches(step_inputs):
    mod = Counted(launches=0, seg_gather=2)
    graph = captured(step_args(step_inputs), {mod: {"launches": 3, "seg_gather": 1}})
    for _ in range(4):
        graph.replay()
    assert mod.COUNTS == {"launches": 12, "seg_gather": 6}
    assert graph.graph.replays == 4


def test_the_cache_evicts_beyond_its_constant(step_inputs):
    graphs = engine.StepGraphs()
    graph = captured(step_args(step_inputs))
    lkey = engine.launcher_key()
    keys = [(("skey", i), lkey) for i in range(engine.MAX_GRAPHS + 2)]
    gone = []
    for i, key in enumerate(keys):
        if i == engine.MAX_GRAPHS:
            graphs.decide(keys[0])      # key 0 used again: keys 1 and 2 are the oldest
        entry = engine.StepGraph(graph.graph, graph.outputs, graph.rounds, {})
        gone.append(weakref.ref(entry))
        graphs.add(key, entry)
        del entry
    assert len(graphs.graphs) == engine.MAX_GRAPHS
    assert engine.COUNTS["evictions"] == 2
    assert keys[0] in graphs.graphs and keys[1] not in graphs.graphs
    assert keys[2] not in graphs.graphs and keys[3] in graphs.graphs
    assert gone[1]() is None and gone[2]() is None and gone[0]() is not None


def test_the_shape_key_drops_the_pointers_alone(step_inputs):
    sig, coverage, params = step_inputs
    key = key_of(sig, coverage, params)
    moved = key_of({k: v.clone() for k, v in sig.items()}, coverage.clone(), params)
    assert moved != key and engine.shape_key(moved) == engine.shape_key(key)
    for other in (key_of({**sig, "pos": sig["pos"][:-1]}, coverage, params),
                  key_of({**sig, "nm": sig["nm"].view(torch.int32)}, coverage, params),
                  key_of(sig, coverage[:-1], params)):
        assert engine.shape_key(other) != engine.shape_key(key)
    graphs = engine.StepGraphs()
    for i in range(engine.MAX_SEEN + 3):
        graphs.note_footprint(("shape", i), i)
    assert len(graphs.footprint) == engine.MAX_SEEN and ("shape", 0) not in graphs.footprint


def test_the_seen_keys_are_bounded(step_inputs):
    graphs = engine.StepGraphs()
    lkey = engine.launcher_key()
    for i in range(engine.MAX_SEEN + 1):
        assert graphs.decide((("skey", i), lkey)) == (engine.EAGER, None)
    assert len(graphs.seen) == engine.MAX_SEEN
    assert graphs.decide((("skey", 0), lkey)) == (engine.EAGER, None)
    assert graphs.decide((("skey", engine.MAX_SEEN), lkey)) == (engine.CAPTURE, None)


def test_replay_span_is_the_shared_null_context_outside_a_profiler():
    assert spans.REPLAY == "engine.replay" and spans.REPLAY not in spans.STAGES
    assert spans.span(spans.REPLAY) is spans.span(spans.STEP)
    with spans.span(spans.REPLAY) as inner:
        assert inner is None


def open_to_cpu(monkeypatch) -> None:
    """call_pipeline_step's key opened to CPU tensors."""
    monkeypatch.setattr(engine, "storage_key",
                        lambda sig, coverage, params, region_offset, binsize,
                        resplit_binsize, device: engine.input_key(
                            sig, coverage, params, region_offset, binsize, resplit_binsize))


@pytest.fixture
def cpu_graphs(monkeypatch):
    """call_pipeline_step with its key opened to CPU tensors and captures
    made by RerunGraph."""
    open_to_cpu(monkeypatch)

    def capture(graphs, key, args):
        graph = captured(args)
        graphs.add(key, graph)
        return graph
    monkeypatch.setattr(engine, "_capture", capture)


def test_the_step_dispatches_eager_capture_replay(step_inputs, cpu_graphs):
    sig, coverage, params = step_inputs
    want = engine._eager_step(sig, coverage, params, 0, 100, 20, None, None)
    seen = []
    for _ in range(4):
        info = {}
        out = engine.call_pipeline_step(sig, coverage, params, info=info)
        seen.append(dict(engine.COUNTS))
        assert out.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(out[k], v), k
        assert int(info["merge_rounds"]) >= 1
        del out
    assert [(c["eager"], c["captures"], c["replays"]) for c in seen] == [
        (1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2)]
    kept = engine.call_pipeline_step(sig, coverage, params)["pos"]
    assert engine.call_pipeline_step(sig, coverage, params)["pos"].data_ptr() != kept.data_ptr()
    assert engine.COUNTS["held_outputs"] == 1 and engine.COUNTS["eager"] == 2


def test_a_capture_that_raises_falls_back_for_its_key(step_inputs, monkeypatch):
    """The real capture on the CPU raises (no CUDA graph there): the call
    runs eagerly, counted, the ops' counts as they were, and the key
    stays eager without another attempt."""
    open_to_cpu(monkeypatch)
    sig, coverage, params = step_inputs
    want = engine._eager_step(sig, coverage, params, 0, 100, 20, None, None)
    before = {mod: dict(mod.COUNTS) for mod in engine.COUNTED}
    for _ in range(3):
        out = engine.call_pipeline_step(sig, coverage, params)
        for k, v in want.items():
            assert torch.equal(out[k], v), k
    assert engine.COUNTS["capture_fallbacks"] == 1
    assert engine.COUNTS["eager"] == 3 and engine.COUNTS["captures"] == 0
    assert {mod: dict(mod.COUNTS) for mod in engine.COUNTED} == before
