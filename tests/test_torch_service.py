"""The port's parent-owned device service (sniffles_tpu_torch/parallel/
device_service.py) and the batched call step it runs on fused requests
(ops/clustering.batched_call_task), on the CPU, where the merge-sweep
wrapper takes its plain version task after task.

batched_call_task on stacks of k = 2 and 4 tasks of one width, a zero
slot included, must equal the port's call_task_packed of each task and
the JAX package's batched_call_task (its vmap, with the sequential sweep)
bit for bit. The DeviceServer must answer solo, fused and pipelined
requests with the single-task result, answer every request with the
warmup's error when warmup failed, serve the cluster_assign and
combine_greedy kinds, and refuse the request kinds it has not ported; the DeviceClient's post, wait, discard and timeout are held
to their contract."""
import os
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jc  # noqa: E402
from sniffles_tpu_torch.config import SnifflesConfig  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tc  # noqa: E402
from sniffles_tpu_torch.parallel import device_service as ds  # noqa: E402
from sniffles_tpu_torch.parallel.device_call import (compress_call_response,  # noqa: E402
                                                     pad_packed)
from sniffles_tpu_torch.sim import fuzz_call_batch, write_dataset, PlantedSV  # noqa: E402

# the default configuration's call_task_packed parameters
META = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
            cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50,
            cluster_merge_pos=150, global_repeat=False, binsize=100,
            resplit_binsize=20)
META_ITEMS = tuple(sorted(META.items()))


def jax_batched(stacked: np.ndarray, monkeypatch) -> np.ndarray:
    """The JAX package's batched_call_task (a jit of the vmap of
    call_task_packed) with its sequential sweep, traced afresh."""
    monkeypatch.setattr(jc, "_FORCE_SEQ_SWEEP", True)
    return np.asarray(jc.batched_call_task.__wrapped__(META_ITEMS)(jnp.asarray(stacked)))


def sim_batches():
    """Two packed tasks of the port's simulated BAMs, padded to one width."""
    import os
    import tempfile
    from sniffles_tpu_torch.io.bam import AlignmentFile
    from sniffles_tpu_torch.leads import LeadProvider
    from sniffles_tpu_torch.parallel.device_call import pack_task_batch, pad_packed
    from sniffles_tpu_torch.region import Region
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed, svs in ((11, [(30_000, "DEL", 120), (60_000, "INS", 150),
                                (90_000, "DUP", 900)]),
                          (7, [(40_000, "INS", 80), (70_000, "INV", 800),
                               (100_000, "DEL", 500)])):
            os.makedirs(f"{tmp}/{seed}")
            bam, fa = write_dataset(f"{tmp}/{seed}", ref_len=130_000, depth=20,
                                    read_len=12_000, seed=seed,
                                    svs=[PlantedSV(pos=p, svtype=t, svlen=ln)
                                         for p, t, ln in svs])
            config = SnifflesConfig("--input", bam, "--vcf", "x.vcf", "--reference", fa)
            config.input_mode = "rb"
            provider = LeadProvider(config, 0, "chr1")
            f = AlignmentFile(bam, "rb", require_index=True)
            provider.build_leadtab([Region("chr1", 0, f.get_reference_length("chr1") - 1)], f)
            out.append(pad_packed(pack_task_batch(provider, config, None)[0]))
    return out


STACKS = {
    "k2-fuzz-zero-slot": lambda: [fuzz_call_batch(11, 512), np.zeros((15, 512), np.int32)],
    "k4-fuzz-zero-slot": lambda: [fuzz_call_batch(13, 2048),
                                  fuzz_call_batch(15, 2048, svtypes=(4,)),
                                  fuzz_call_batch(16, 2048, svtypes=(1,)),
                                  np.zeros((15, 2048), np.int32)],
    "k2-sim": sim_batches,
}


@pytest.mark.parametrize("name", list(STACKS))
def test_batched_call_task_matches_single_tasks_and_jax(name, monkeypatch):
    tasks = STACKS[name]()
    stacked = np.stack(tasks)
    ours = tc.batched_call_task(META_ITEMS, torch.from_numpy(stacked))
    assert ours.dtype == torch.int32 and ours.shape[0] == len(tasks)
    for j, packed in enumerate(tasks):
        single = tc.call_task_packed(torch.from_numpy(packed), **META)
        assert torch.equal(ours[j], single), j
    theirs = jax_batched(stacked, monkeypatch)
    assert ours.numpy().tolist() == theirs.tolist()


def test_batched_sweep_leaves_a_zero_slot_untouched():
    """One sweep over a stack of three tasks (the middle one a zero pad
    slot): each task's state and counts equal its own sweep's, and the
    pad slot's state stays as it was, with no segment."""
    tasks = [fuzz_call_batch(21, 1024), np.zeros((15, 1024), np.int32),
             fuzz_call_batch(22, 1024, svtypes=(4,))]
    params = {k: META[k] for k in tc.SWEEP_PARAMS}
    staged = [tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(torch.from_numpy(p)),
                                                100), 100) for p in tasks]
    inputs = tc._stack_tasks([s[0] for s in staged])
    state = tc._stack_tasks([s[1] for s in staged])
    before = {k: v.clone() for k, v in state.items()}
    launches = dict(tc.COUNTS)
    counts = tc.merge_sweep(inputs, state, **params)
    assert tc.COUNTS == launches                  # no kernel on the CPU
    assert counts.shape == (3, len(tc.SWEEP_COUNTS))
    for j, (task_inputs, task_state) in enumerate(staged):
        own = {k: v.clone() for k, v in task_state.items()}
        assert counts[j].tolist() == tc.merge_sweep(task_inputs, own, **params).tolist()
        for k in tc.SWEEP_STATE:
            assert torch.equal(state[k][j].view(torch.int32) if state[k].is_floating_point()
                               else state[k][j],
                               own[k].view(torch.int32) if own[k].is_floating_point()
                               else own[k]), (j, k)
    assert int(inputs["nseeds"][1]) == 0 and counts[1].tolist() == [0, 0, 0, 1, 0]
    for k in tc.SWEEP_STATE:
        assert torch.equal(state[k][1], before[k][1]), k


# ---------------------------------------------------------------------------
# DeviceServer


def call_request(packed, req_id):
    n = int((packed[5] > 0).sum())
    return ds.DeviceRequest(kind="call_task", payload=packed[:, :n].copy(),
                            meta=dict(META), req_id=req_id)


def expected_response(request):
    """The single-task result of a call_task request, at its padded width."""
    padded = pad_packed(request.payload)
    out = tc.call_task_packed(torch.from_numpy(padded), **META).numpy()
    return compress_call_response(out, padded.shape[1])


def same_payload(got, want):
    assert got["nc"] == want["nc"] and got["slots"] == want["slots"]
    assert got["elems"].tolist() == want["elems"].tolist()
    assert got["stats"].tolist() == want["stats"].tolist()


def trimmed_fuzz(seed, size=1024):
    """A fuzz batch whose valid slots all come first (as the packer's
    trimmed payload), padded back to its width."""
    packed = fuzz_call_batch(seed, size)
    order = np.argsort(packed[5] == 0, kind="stable")
    packed = packed[:, order]
    packed[3] = np.where(packed[5] > 0, np.arange(size), 0)
    return packed


class Replies:
    def __init__(self):
        self.got = {}
        self.at = {}
        self.done = threading.Event()
        self.expect = 0

    def __call__(self, response):
        self.got[response.req_id] = response
        self.at[response.req_id] = time.monotonic()
        if len(self.got) >= self.expect:
            self.done.set()


def serve(server, requests, timeout=120, replies=None):
    """Queue every request, then start the dispatcher (so all of them are
    waiting when it starts) and collect the replies."""
    replies = replies or Replies()
    replies.expect = len(requests)
    for req in requests:
        server._queue.put((req, replies))
    server._last_arrival = time.monotonic()
    server.warm_async(SnifflesConfig("--input", "x.bam", "--vcf", "y.vcf"))
    assert replies.done.wait(timeout)
    server.stop()
    return replies.got


def test_server_answers_a_solo_request():
    request = call_request(trimmed_fuzz(31), 7)
    got = serve(ds.DeviceServer("cpu"), [request])
    assert got[7].error is None
    same_payload(got[7].payload, expected_response(request))


def test_server_fuses_requests_of_one_width(monkeypatch):
    """Three waiting call_task requests of one padded width and one of
    another: the three go as one fused step (3 tasks in 4 slots), the
    fourth alone; every reply equals the single-task result."""
    requests = [call_request(trimmed_fuzz(s), s) for s in (41, 42, 43)]
    requests.append(call_request(trimmed_fuzz(44, 8192 * 2), 44))
    server = ds.DeviceServer("cpu")
    calls = []
    real = tc.batched_call_task

    def spy(meta_items, stacked):
        calls.append(tuple(stacked.shape))
        return real(meta_items, stacked)
    monkeypatch.setattr(tc, "batched_call_task", spy)
    got = serve(server, requests)
    assert calls == [(4, 15, 8192)]
    assert server.counters["fusion_batches"] == 1
    assert server.counters["fusion_fused_requests"] == 3
    assert server.counters["requests"] == 4
    for request in requests:
        assert got[request.req_id].error is None
        same_payload(got[request.req_id].payload, expected_response(request))


def test_server_pipelines_responses(monkeypatch):
    """A pipelined request's result is fetched only after the next
    request's work has started (the one-deep response pipeline); the
    last one is finished when the queue goes quiet."""
    events = []
    real = ds.DeviceServer._start_call

    def start(self, batch):
        events.append(("start", batch[0][0].req_id))
        finish = real(self, batch)

        def traced():
            events.append(("finish", batch[0][0].req_id))
            finish()
        return traced
    monkeypatch.setattr(ds.DeviceServer, "_start_call", start)
    server = ds.DeviceServer("cpu")
    server.FUSION_WINDOW_S = 0.0        # no fusion: each request on its own
    widths = [trimmed_fuzz(51), trimmed_fuzz(52, 8192 * 2), trimmed_fuzz(53)]
    got = serve(server, [call_request(p, i) for i, p in enumerate(widths)])
    assert events == [("start", 0), ("start", 1), ("finish", 0), ("start", 2),
                      ("finish", 1), ("finish", 2)]
    assert all(got[i].error is None for i in range(3))


def test_server_answers_the_pending_response_before_a_fusion_window():
    """A call_task of width A, one of width B, another of width A, all
    waiting: the first goes alone (B does not fuse), B goes next and is
    pending when the third opens a fusion window on a warm queue. B's
    reply must not wait for that window."""
    server = ds.DeviceServer("cpu")
    server.FUSION_WINDOW_S, server.FUSION_HOT_S = 1.0, 600.0
    replies = Replies()
    got = serve(server, [call_request(trimmed_fuzz(71), 1),
                         call_request(trimmed_fuzz(72, 8192 * 2), 2),
                         call_request(trimmed_fuzz(73), 3)], replies=replies)
    assert all(got[i].error is None for i in (1, 2, 3))
    assert server.counters["fusion_window_waits"] >= 1
    assert server.counters["fusion_batches"] == 0
    assert replies.at[3] - replies.at[2] >= 0.9


def test_server_runs_combine_and_edit_distance_requests():
    from sniffles_tpu_torch.ops.combine_greedy import run_combine_greedy_task
    from sniffles_tpu_torch.ops.edit_distance import edit_distance
    rng = np.random.default_rng(3)
    S, L = 3, 9
    payload = {"c_pos": rng.integers(0, 300, (S, L)).astype(np.int32),
               "c_len": rng.integers(50, 400, (S, L)).astype(np.int32),
               "c_alt": np.zeros((S, L), np.int32), "c_hord": np.full((S, L), -1, np.int32),
               "counts": np.array([9, 4, 7], np.int32),
               "ed_segs": np.zeros(0, np.int32), "ed_rows": np.zeros(0, np.int32),
               "ed_cols": np.zeros(0, np.int32), "ed_vals": np.zeros(0, np.int32)}
    meta = {"cm": 500, "cmm": 1000, "limit": 0.0}
    pairs = [("ACGTTGCA" * 20, "ACGTAGCA" * 19), ("", "ACG"), ("GATTACA", "GCATGCT")]
    got = serve(ds.DeviceServer("cpu"), [
        ds.DeviceRequest("combine_greedy_task", payload, meta, 1),
        ds.DeviceRequest("ed_batch", pairs, {"max_len": None}, 2),
        ds.DeviceRequest("noop", None, {}, 3), ds.DeviceRequest("stats", None, {}, 4)])
    want = run_combine_greedy_task(payload, meta, "cpu")
    assert got[1].payload["assign"].tolist() == want["assign"].tolist()
    assert got[1].payload["seg_flags"].tolist() == want["seg_flags"].tolist()
    assert got[2].payload.tolist() == [edit_distance(a, b) for a, b in pairs]
    assert got[3].payload.tolist() == [0]
    assert got[4].payload["requests"] == 4


def test_server_warmup_failure_answers_every_request(monkeypatch):
    """The kernel build fails (no nvcc): the error is stored, and every
    request of every kind is answered with it — nothing runs elsewhere."""
    from sniffles_tpu_torch.ops import _build

    def no_nvcc(*args, **kwargs):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    monkeypatch.setattr(_build, "build_all", no_nvcc)
    server = ds.DeviceServer("cuda")
    packed = trimmed_fuzz(61)
    got = serve(server, [call_request(packed, 1), call_request(packed, 2),
                         ds.DeviceRequest("ed_batch", [("A", "C")], {}, 3),
                         ds.DeviceRequest("combine_greedy_task", {}, {}, 4),
                         ds.DeviceRequest("noop", None, {}, 5)])
    for i in range(1, 6):
        assert got[i].payload is None
        assert "device warmup failed" in got[i].error and "nvcc not found" in got[i].error
    assert not torch.cuda.is_initialized()


def mesh_request(kind):
    """A payload of each mesh kind (8 shards), and the step's answer in
    process."""
    from sniffles_tpu_torch.parallel import device_call, device_combine
    from sniffles_tpu_torch.parallel.combine_tensors import shard_candidate_tensors
    if kind == "call_task_mesh":
        packed = fuzz_call_batch(23, 1024)
        packed = packed[:, packed[5] > 0].copy()
        packed[3] = np.arange(packed.shape[1], dtype=np.int32)
        payload = device_call.pack_mesh_payload((packed, META, [None] * packed.shape[1], None),
                                                8)
        return payload, META, device_call.run_mesh_assign(payload, META)
    rng = np.random.default_rng(3)
    n = 300
    cand = {"pos": np.sort(rng.integers(0, 400_000, size=n)).astype(np.int32),
            "svlen": rng.integers(50, 900, size=n).astype(np.int32),
            "svtype": np.zeros(n, np.int32), "sample_id": np.zeros(n, np.int32),
            "support": np.zeros(n, np.int32), "qc": np.ones(n, bool),
            "valid": np.ones(n, bool), "orig_idx": np.arange(n, dtype=np.int32)}
    sharded, offsets, window_len = shard_candidate_tensors(cand, 8)
    payload = {"cand": sharded, "offsets": offsets, "window_len": window_len, "n_dev": 8}
    meta = {"combine_match": 250.0, "combine_match_max": 1001.0, "binsize": 100}
    return payload, meta, device_combine.run_mesh_combine(payload, meta)


@pytest.mark.parametrize("kind", ["cluster_assign", "combine_greedy", "call_task_mesh",
                                  "combine_mesh"])
def test_ported_request_kinds_are_served(kind, monkeypatch):
    """The kinds refused before their port: a cluster_assign request
    answers cluster_assign_packed's (3, N) assignment, a combine_greedy
    request run_combine_greedy's result, through the dispatcher and the
    client's methods; the mesh kinds (on 8 CPU shards) the mesh step's
    rows, and a halo that overflows at every width an answer the client
    turns into MeshHaloOverflow."""
    from sniffles_tpu_torch.ops.combine_greedy import run_combine_greedy
    from sniffles_tpu_torch.parallel import device_call
    if kind in ds.MESH_KINDS:
        monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")
        payload, meta, want = mesh_request(kind)
        got = serve(ds.DeviceServer("cpu"), [ds.DeviceRequest(kind, payload, meta, 5)])[5]
        assert got.error is None and device_call.mesh_result(got.payload).tolist() == want.tolist()
        if kind == "call_task_mesh":
            monkeypatch.setenv(device_call.ENV_FORCE_OVERFLOW, "1")
        else:
            payload = dict(payload, window_len=np.full(8, 1, np.int32))   # no admissible W
        got = serve(ds.DeviceServer("cpu"), [ds.DeviceRequest(kind, payload, meta, 6)])[6]
        assert got.error is None
        with pytest.raises(device_call.MeshHaloOverflow, match="halo overflow"):
            device_call.mesh_result(got.payload)
        return
    assign_meta = {k: META[k] for k in ("cluster_r", "cluster_repeat_h",
                                        "cluster_repeat_h_max", "cluster_merge_bnd",
                                        "cluster_merge_len", "minsvlen", "binsize",
                                        "resplit_binsize")}
    if kind == "cluster_assign":
        payload, meta = fuzz_call_batch(23, 1024)[[0, 1, 2, 8, 4, 5]], assign_meta
        want = tc.cluster_assign_packed(torch.from_numpy(payload), **meta).numpy()
    else:
        payload = {"c_pos": np.array([0, 10, 4000, 6], np.int32),
                   "c_len": np.array([100, 104, 100, 98], np.int32),
                   "c_alt": np.zeros(4, np.int32), "g_psum": np.array([20], np.int32),
                   "g_lsum": np.array([101], np.int32), "g_n": np.array([1], np.int32),
                   "g_head": np.zeros(1, np.int32), "n_alts": 1,
                   "ed_rows": np.zeros(0, np.int32), "ed_cols": np.zeros(0, np.int32),
                   "ed_vals": np.zeros(0, np.int32)}
        meta = {"cm": 250, "cmm": 1000, "limit": 0.0}
        want = run_combine_greedy(payload, meta, "cpu")
    got = serve(ds.DeviceServer("cpu"), [ds.DeviceRequest(kind, payload, meta, 5)])[5]
    assert got.error is None
    if kind == "cluster_assign":
        assert got.payload.tolist() == want.tolist()
        pipe = Pipe()
        client = ds.DeviceClient(pipe)
        threading.Timer(0.05, client.deliver,
                        [ds.DeviceResponse(payload=want, req_id=1)]).start()
        assert client.cluster_assign(payload, meta) is want
        assert pipe.sent[0].kind == "cluster_assign"
    else:
        assert got.payload["assign"].tolist() == want["assign"].tolist() == [0, 0, 1, 0]
        assert got.payload["flags"].tolist() == want["flags"].tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# DeviceClient


class Pipe:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


def test_client_post_wait_discard_and_timeout():
    pipe = Pipe()
    client = ds.DeviceClient(pipe)
    a = client.post("call_task", np.zeros((15, 3), np.int32), {"x": 1})
    b = client.post("ed_batch", [("A", "C")], {})
    assert (a, b) == (1, 2) and [m.req_id for m in pipe.sent] == [1, 2]
    assert pipe.sent[0].kind == "call_task" and pipe.sent[0].meta == {"x": 1}

    # a response delivered from another thread wakes the waiter
    threading.Timer(0.05, client.deliver,
                    [ds.DeviceResponse(payload=np.array([4]), req_id=b)]).start()
    assert client.wait(b, timeout=10).tolist() == [4]

    # an error response raises; nothing is rerouted
    client.deliver(ds.DeviceResponse(error="ValueError: boom", req_id=a))
    with pytest.raises(RuntimeError, match="device service error: ValueError: boom"):
        client.wait(a)

    # no answer within the timeout raises
    c = client.post("noop", None, {})
    with pytest.raises(TimeoutError, match=f"request {c}"):
        client.wait(c, timeout=0.05)

    # a discarded request's late response is dropped on arrival
    client.discard(c)
    client.deliver(ds.DeviceResponse(payload=np.array([1]), req_id=c))
    assert c not in client._responses and c not in client._abandoned
    # a response that arrived before the discard is dropped by it
    d = client.post("noop", None, {})
    client.deliver(ds.DeviceResponse(payload=np.array([1]), req_id=d))
    client.discard(d)
    assert d not in client._responses

    # a lost connection fails every wait at once, now and later
    e = client.post("noop", None, {})
    threading.Timer(0.05, client.lose, ["the connection was lost"]).start()
    with pytest.raises(RuntimeError, match="the connection was lost"):
        client.wait(e, timeout=10)
    with pytest.raises(RuntimeError, match="the connection was lost"):
        client.wait(client.post("noop", None, {}), timeout=10)


@pytest.mark.parametrize("env_ms, window_s", [(None, 0.0), ("25", 0.025)])
def test_fusion_window_default_and_environment(env_ms, window_s):
    """The fusion window is off unless SNIFFLES_TPU_FUSION_WINDOW_MS sets
    it (read when the module is imported, so in a process of its own)."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "SNIFFLES_TPU_FUSION_WINDOW_MS"}
    if env_ms is not None:
        env["SNIFFLES_TPU_FUSION_WINDOW_MS"] = env_ms
    out = subprocess.run(
        [sys.executable, "-c", "from sniffles_tpu_torch.parallel.device_service import "
         "DeviceServer; print(DeviceServer.FUSION_WINDOW_S)"],
        capture_output=True, text=True, env=env, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).stdout
    assert float(out) == window_s
