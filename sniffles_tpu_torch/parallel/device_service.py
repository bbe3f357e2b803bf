"""
Parent-owned device service: lets forked host workers use the card
without ever touching torch's device themselves.

A CUDA context must not be forked, so with ``--threads N`` the runtime
splits device work across the process boundary: workers decode BAM and
build signature tensors, then ship each packed batch to the parent over
their task pipe as a DeviceRequest; the parent owns the device (its
context is created strictly after all workers have been forked, on the
dispatcher thread) and answers with a DeviceResponse.

Copied from sniffles_tpu/parallel/device_service.py: DeviceRequest,
DeviceResponse, DeviceServer (its dispatcher thread, the adaptive fusion
window, the one-deep response pipeline) and DeviceClient. What differs:

* No per-shape compile. The kernels are built once by nvcc and torch
  runs any width, so the service is ready for every width once warmup
  has built the kernels and created the context: fusion engages for
  every padded width (the JAX package fuses only widths it compiled,
  which its in-CLI warmup never does). The side-thread compile
  (`_compile_async`) and its `midrun_compiles` counter have nothing to
  do here and are gone.
* No fallback. A warmup failure (nvcc, no card, a failed launch) is
  stored, and every request is answered with a DeviceResponse carrying
  it; a request whose dispatch fails is answered with its error. The
  client's `wait` raises on an error and on a request not answered
  within DeviceClient.TIMEOUT, so the task ends as an ErrorResult and
  the run exits non-zero. The hedge and the circuit breaker
  (`degraded`) of the JAX package are not ported: they hide the device.
* The one-deep response pipeline (the JAX package's copy_to_host_async
  and finish()): the dispatcher launches a request's work on its own
  CUDA stream, copies the result into pinned host memory with
  non_blocking=True and records an event (ops/transfer.py); finish()
  waits on that event and replies. The pipeline gains only where the
  launch itself does not wait for the card: the upload comes from
  pinned memory, every size call_task_packed needs is known on the
  host, and the combine greedy takes its loop bound from the host's
  counts. chip_smoke.py (phase 5) lists the synchronising operations
  that call_task_packed and batched_call_task still reach on the card
  (torch.cuda.set_sync_debug_mode). An ed_batch request is not
  pipelined: the edit-distance wrapper reads its lengths back to check
  them (edit_distance_batch_device), so the dispatcher finishes the
  pending response first.
* The fusion window is off by default (0 ms against the JAX package's
  12 ms; measured on the H100, see FUSION_WINDOW_S), and when it is set,
  the pending response is answered before the dispatcher waits in it
  (the JAX package's dispatcher holds it through the wait).
* The mesh's request kinds (call_task_mesh, combine_mesh) resolve the
  mesh's devices here, in the process that owns the card
  (parallel/mesh.py mesh_devices), and run on a stream of the service's
  on every CUDA device of the mesh. A halo that overflows at every
  admissible width is answered as a result (device_call.serve_mesh), so
  that the task takes its seam route; any other failure is an error.
* A stats answer also names the device and counts this process's
  kernel launches (`stats`), so a client of the device daemon
  (parallel/device_daemon.py) sees where its kernels ran.

Reference mapping: this replaces nothing in the reference (which is
CPU-only, parallel.py:585-807); it is the device-side equivalent of its
worker pool feeding a shared accelerator.
"""
from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)

# True once a DeviceServer of this process has touched a torch device
# (the card or, with SNIFFLES_TPU_FORCE_CPU, torch's CPU thread pools).
# fork() is only unsafe after that point; the runtime switches recycled
# workers to spawn when this is set.
DEVICE_LIVE = False

# the mesh's request kinds: the call step's and the combine segmentation's
MESH_KINDS = ("call_task_mesh", "combine_mesh")


@dataclass
class DeviceRequest:
    """Worker -> parent: run one device step on a batch."""
    kind: str                 # "call_task" | "combine_greedy_task" | "ed_batch" | ...
    payload: object           # packed ndarray, a payload dict, or string pairs
    meta: dict = field(default_factory=dict)   # static kernel params
    req_id: int = 0           # worker-scoped correlation id


@dataclass
class DeviceResponse:
    """Parent -> worker: the result (or error text)."""
    payload: object = None
    error: str = None
    req_id: int = 0


def _error_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class DeviceServer:
    """Parent-side dispatcher of device requests.

    Requests are processed on a dedicated thread (``submit``); the
    response is handed to the per-request ``reply`` callable from that
    thread, so the parent's poll loop never blocks on the card.
    ``warm_async`` starts the thread once every worker has forked; it
    builds the kernels and creates the context before serving requests,
    overlapping the workers' first BAM decode.

    call_task and combine_greedy_task requests join the response
    pipeline; ``handle`` answers every other kind at once, and every
    request once warmup failed.
    """

    # max call_task requests fused into one dispatch; padded to 2 or 4
    # task slots (the JAX package's shapes)
    MAX_FUSED = 4

    # adaptive dispatch window: when the queue is WARM (another request
    # arrived within FUSION_HOT_S — concurrent workers are decoding),
    # hold a fusable call_task for same-width companions instead of
    # dispatching it alone. Off by default (0 ms; the JAX package holds
    # 12 ms): on the H100, call tasks of one width that came after the
    # warmup arrived 84-917 ms apart, so a 12 or 50 ms window fused none
    # of them and 100 ms one pair (PERF.md, tools/fusion_window.py),
    # while a fused dispatch saves well under a millisecond of sweep.
    # Requests that queue (behind the warmup or a busy dispatcher) fuse
    # without a window. SNIFFLES_TPU_FUSION_WINDOW_MS sets the window.
    FUSION_WINDOW_S = float(os.environ.get(
        "SNIFFLES_TPU_FUSION_WINDOW_MS", "0")) / 1000.0
    FUSION_HOT_S = 0.25

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread = None
        self._warm_meta = None
        self._warm_full = False
        self._warm_error: str = None
        self._stream = None
        self._mesh_streams: dict = {}
        self.counters = {"requests": 0, "fusion_batches": 0,
                         "fusion_fused_requests": 0, "fusion_window_waits": 0}
        self._last_arrival = 0.0

    # -- threaded operation -------------------------------------------------

    def warm_async(self, config, full: bool = False) -> None:
        """Start the dispatcher thread; it builds the kernels, creates the
        context and runs the run's call step (`config`'s parameters) once
        on a zero batch of the floor width before serving requests; with
        full=True (the device daemon) also at 2, 4 and 8 times that
        width, and the fused steps of k = 2 and 4 tasks. With config None
        it runs no step. Call it after every worker has forked, before
        the first submit."""
        from sniffles_tpu_torch.parallel.device_call import standard_call_meta
        self._warm_meta = None if config is None else standard_call_meta(config)
        self._warm_full = full
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-dispatch")
        self._thread.start()

    def submit(self, request: DeviceRequest, reply) -> None:
        """Queue a request; ``reply(DeviceResponse)`` is called from the
        dispatcher thread when done."""
        self._last_arrival = time.monotonic()
        self._queue.put((request, reply))

    def stop(self, timeout: float = 60.0) -> None:
        """Finish every queued request, then end the dispatcher thread."""
        if self._thread is None:
            return
        self._queue.put((None, None))
        self._thread.join(timeout)
        self._thread = None

    def _run(self) -> None:
        self._warm()
        # 1-deep response pipeline: the dispatcher starts the next
        # request's work before finishing the previous response, so the
        # wait for one result overlaps the next one's kernels. When the
        # queue goes quiet the pending response is finished at once, so
        # an isolated request sees no added latency.
        pending = None
        while True:
            try:
                request, reply = self._queue.get_nowait()
            except queue.Empty:
                if pending is not None:
                    pending()
                    pending = None
                request, reply = self._queue.get()
            if request is None:
                if pending is not None:
                    pending()
                return

            # adaptive request fusion: drain same-width, same-meta
            # call_task requests already waiting (or arriving within the
            # window while the queue is warm) and dispatch them as ONE
            # batched call step. Payloads arrive TRIMMED
            # (device_call.pack_task_batch); requests fuse when their
            # PADDED widths match.
            batch = [(request, reply)]
            leftover = None
            if request.kind == "call_task" and self._warm_error is None:
                pw = self._padded(request)
                deadline = None
                while len(batch) < self.MAX_FUSED:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        now = time.monotonic()
                        if (self.FUSION_WINDOW_S <= 0
                                or now - self._last_arrival > self.FUSION_HOT_S):
                            break   # cold queue: never add solo latency
                        if deadline is None:
                            deadline = now + self.FUSION_WINDOW_S
                            self.counters["fusion_window_waits"] += 1
                            # answer the pending response before waiting: the
                            # window must not delay it (the JAX package's
                            # dispatcher holds it through the wait)
                            if pending is not None:
                                pending()
                                pending = None
                        remaining = deadline - now
                        if remaining <= 0:
                            break
                        try:
                            nxt = self._queue.get(timeout=remaining)
                        except queue.Empty:
                            break
                    if (nxt[0] is not None and nxt[0].kind == "call_task"
                            and nxt[0].meta == request.meta
                            and self._padded(nxt[0]) == pw):
                        batch.append(nxt)
                    else:
                        leftover = nxt
                        break
                if len(batch) > 1:
                    self.counters["fusion_batches"] += 1
                    self.counters["fusion_fused_requests"] += len(batch)

            self.counters["requests"] += len(batch)
            pending = self._dispatch_async(batch, pending)
            if leftover is not None:
                if leftover[0] is None:
                    # the stop sentinel: serve nothing after it
                    if pending is not None:
                        pending()
                    return
                self.counters["requests"] += 1
                pending = self._dispatch_async([leftover], pending)

    def _dispatch_async(self, batch, pending):
        """Start `batch` (one request, or fused call_task requests) and
        return the new pending finish(): a pipelined kind finishes the
        previous response after its own launch, any other kind finishes
        it first and is answered at once."""
        kind = batch[0][0].kind
        if self._warm_error is None and kind in ("call_task", "combine_greedy_task"):
            finish = (self._start_call(batch) if kind == "call_task"
                      else self._start_combine(*batch[0]))
            if pending is not None:
                pending()
            return finish
        if pending is not None:
            pending()
        request, reply = batch[0]
        self._safe_reply(reply, self.handle(request))
        return None

    @staticmethod
    def _padded(request) -> int:
        from sniffles_tpu_torch.parallel.device_call import padded_width
        return padded_width(int(np.shape(request.payload)[-1]))

    @staticmethod
    def _safe_reply(reply, response) -> None:
        try:
            reply(response)
        except Exception:
            # requester's pipe may be gone (dead worker); its task is
            # requeued by the heartbeat logic and re-posts elsewhere
            log.debug("could not deliver device response", exc_info=True)

    def _reply_error(self, batch, e: BaseException, what: str) -> None:
        log.error(f"device service: {what} failed", exc_info=e)
        for req, reply in batch:
            self._safe_reply(reply, DeviceResponse(error=_error_text(e), req_id=req.req_id))

    def _on_stream(self, devices=()):
        """The service's streams as the current ones: on its own device,
        and on each other CUDA device of `devices` (a mesh's) one stream
        of the service's, made at first use. The service's device is
        entered last, so it stays the current device."""
        import torch
        stack = contextlib.ExitStack()
        if self._stream is None:
            return stack
        own = self._stream.device
        for d in dict.fromkeys(torch.device(d) for d in devices):
            if d.type != "cuda" or (d.index if d.index is not None else own.index) == own.index:
                continue
            if d.index not in self._mesh_streams:
                self._mesh_streams[d.index] = torch.cuda.Stream(device=d)
            stack.enter_context(torch.cuda.stream(self._mesh_streams[d.index]))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _start_call(self, batch):
        """Launch one call step for one call_task request, or one batched
        call step for fused ones (k real tasks in 2 or 4 slots, the pad
        slots zero); returns a finish() that waits for the result and
        replies to each request, or None when the launch failed (already
        replied)."""
        global DEVICE_LIVE
        try:
            from sniffles_tpu_torch.ops.clustering import batched_call_task, call_task_packed
            from sniffles_tpu_torch.ops.transfer import to_device, to_host_async
            from sniffles_tpu_torch.parallel.device_call import (PACKED_ROWS,
                                                                 compress_call_response,
                                                                 pad_packed)
            DEVICE_LIVE = True
            pw = self._padded(batch[0][0])
            if len(batch) == 1:
                host = pad_packed(np.asarray(batch[0][0].payload))
            else:
                kp = 2 if len(batch) <= 2 else 4   # pad slots carry valid=0 rows only
                host = np.zeros((kp, PACKED_ROWS, pw), dtype=np.int32)
                for j, (req, _) in enumerate(batch):
                    host[j, :, :np.shape(req.payload)[-1]] = req.payload
            meta = batch[0][0].meta
            with self._on_stream():
                x = to_device(host, self.device)
                out = (call_task_packed(x, **meta) if len(batch) == 1
                       else batched_call_task(tuple(sorted(meta.items())), x))
                fetch = to_host_async(out)
        except Exception as e:  # noqa: BLE001 - errors cross the pipe as text
            self._reply_error(batch, e, "call_task dispatch")
            return None

        def finish():
            try:
                flat, = fetch()
                rows = [flat] if len(batch) == 1 else list(flat)
                for (req, reply), row in zip(batch, rows):
                    self._safe_reply(reply, DeviceResponse(
                        payload=compress_call_response(row, pw), req_id=req.req_id))
            except Exception as e:  # noqa: BLE001
                self._reply_error(batch, e, "call_task result")
        return finish

    def _start_combine(self, request, reply):
        """Launch the whole-task combine greedy; same finish() contract as
        _start_call."""
        global DEVICE_LIVE
        try:
            from sniffles_tpu_torch.ops.combine_greedy import start_combine_greedy_task
            DEVICE_LIVE = True
            with self._on_stream():
                fetch = start_combine_greedy_task(request.payload, request.meta, self.device)
        except Exception as e:  # noqa: BLE001
            self._reply_error([(request, reply)], e, "combine greedy dispatch")
            return None

        def finish():
            try:
                self._safe_reply(reply, DeviceResponse(payload=fetch(),
                                                       req_id=request.req_id))
            except Exception as e:  # noqa: BLE001
                self._reply_error([(request, reply)], e, "combine greedy result")
        return finish

    def _warm(self) -> None:
        """Build both kernel libraries, create the context (and the
        dispatcher's stream), and run the warm call steps on zero batches
        (warm_async). Nothing compiles in torch, but the first launches
        load the kernels' modules and fill the caching allocator. A
        failure is stored: every request then gets it."""
        global DEVICE_LIVE
        try:
            t0 = time.perf_counter()
            import torch
            if self.device == "cuda":
                from sniffles_tpu_torch.ops import _build
                _build.build_all()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            DEVICE_LIVE = True
            if self.device == "cuda":
                torch.cuda.init()
                self._stream = torch.cuda.Stream()
            from sniffles_tpu_torch.ops.clustering import batched_call_task, call_task_packed
            from sniffles_tpu_torch.parallel.device_call import (DEVICE_BATCH_FLOOR,
                                                                 PACKED_ROWS)
            meta = self._warm_meta
            widths, fused = [], []
            if meta is not None:
                widths = [DEVICE_BATCH_FLOOR]
                if self._warm_full:
                    widths += [2 * DEVICE_BATCH_FLOOR, 4 * DEVICE_BATCH_FLOOR,
                               8 * DEVICE_BATCH_FLOOR]
                    fused = [2, 4]
            with self._on_stream():
                for width in widths:
                    zero = torch.zeros((PACKED_ROWS, width), dtype=torch.int32,
                                       device=self.device)
                    call_task_packed(zero, **meta).cpu()
                for k in fused:
                    zero = torch.zeros((k, PACKED_ROWS, DEVICE_BATCH_FLOOR),
                                       dtype=torch.int32, device=self.device)
                    batched_call_task(tuple(sorted(meta.items())), zero).cpu()
            log.info(f"device warmup on {self.device}: kernels {build_s:.2f}s, context and "
                     f"{len(widths) + len(fused)} warm steps {time.perf_counter() - t0:.2f}s")
        except Exception as e:  # noqa: BLE001
            self._warm_error = f"device warmup failed: {_error_text(e)}"
            log.error(self._warm_error, exc_info=e)

    # -- dispatch -------------------------------------------------------------

    def stats(self) -> dict:
        """The service's counters, its device, and the kernel launches of
        this process (the names the CLI's counters give them)."""
        from sniffles_tpu_torch.ops import (call_stats, clustering, combine_greedy,
                                            edit_distance_batch)
        return {**self.counters, "device": self.device,
                "kernel_sweep_cuts": clustering.COUNTS["sweep_cuts"],
                "kernel_merge_sweep": clustering.COUNTS["launches"],
                "kernel_ed_myers": edit_distance_batch.COUNTS["launches"],
                "kernel_call_stats": call_stats.COUNTS["launches"],
                "kernel_combine_greedy": combine_greedy.COUNTS["launches"]}

    def handle(self, request: DeviceRequest) -> DeviceResponse:
        """Answer one request that is not pipelined (cluster_assign,
        combine_greedy, ed_batch, the mesh kinds, noop, stats), or any
        request with the warmup's error when it failed."""
        if self._warm_error is not None:
            return DeviceResponse(error=self._warm_error, req_id=request.req_id)
        try:
            return DeviceResponse(payload=self._dispatch(request), req_id=request.req_id)
        except Exception as e:  # noqa: BLE001 - errors cross the pipe as text
            log.error(f"device service: {request.kind} request failed", exc_info=e)
            return DeviceResponse(error=_error_text(e), req_id=request.req_id)

    def _dispatch(self, request: DeviceRequest):
        global DEVICE_LIVE
        if request.kind == "noop":
            # liveness probe: reaching here means warmup finished
            return np.zeros(1, dtype=np.int32)
        if request.kind == "stats":
            return self.stats()
        if request.kind in MESH_KINDS:
            DEVICE_LIVE = True
            from sniffles_tpu_torch.parallel import device_call, device_combine
            from sniffles_tpu_torch.parallel.mesh import mesh_devices
            run = (device_call.run_mesh_assign if request.kind == "call_task_mesh"
                   else device_combine.run_mesh_combine)
            with self._on_stream(mesh_devices(int(request.payload["n_dev"]))):
                return device_call.serve_mesh(run, request.payload, request.meta)
        if request.kind == "cluster_assign":
            DEVICE_LIVE = True
            from sniffles_tpu_torch.ops.clustering import cluster_assign_packed
            from sniffles_tpu_torch.ops.transfer import to_device
            with self._on_stream():
                packed = to_device(np.asarray(request.payload, dtype=np.int32), self.device)
                return cluster_assign_packed(packed, **request.meta).cpu().numpy()
        if request.kind == "combine_greedy":
            DEVICE_LIVE = True
            # the sequential greedy of one (block, svtype) flush
            from sniffles_tpu_torch.ops.combine_greedy import run_combine_greedy
            with self._on_stream():
                return run_combine_greedy(request.payload, request.meta, self.device)
        if request.kind == "ed_batch":
            DEVICE_LIVE = True
            # payload: list of (a, b) string pairs (combine identity gate)
            from sniffles_tpu_torch.ops.edit_distance_batch import device_edit_distance_batch
            with self._on_stream():
                return device_edit_distance_batch(request.payload, request.meta.get("max_len"),
                                                  device=self.device)
        raise ValueError(f"unknown device request kind: {request.kind}")


def stats_difference(before: dict, after: dict) -> dict:
    """The counters of a run from two stats answers (DeviceServer.stats):
    the service's counters as service_*, the kernel launches by their
    names, each after less before."""
    return {(k if k.startswith("kernel_") else f"service_{k}"): after[k] - before[k]
            for k in after if k != "device"}


class DeviceClient:
    """Worker-side proxy. ``post`` sends a DeviceRequest on the worker's
    task pipe and returns its id; ``wait`` blocks until the receive
    thread delivers the matching response. Multiple requests can be in
    flight (the decode-ahead prefetch posts the next task's batch while
    the current task computes), from any worker thread."""

    TIMEOUT = 600  # seconds: a first request waits for the kernel build

    def __init__(self, conn, send_lock: threading.Lock = None):
        self._conn = conn
        self._send_lock = send_lock or threading.Lock()
        self._cv = threading.Condition()
        self._responses: dict[int, tuple] = {}   # req_id -> (response, t_arrived)
        self._abandoned: dict[int, float] = {}   # req_id -> t_abandoned
        self._next_id = 1
        self._lost: str = None

    def lose(self, reason: str) -> None:
        """The connection is gone: every wait, now and later, raises
        RuntimeError(reason)."""
        with self._cv:
            self._lost = reason
            self._cv.notify_all()

    def deliver(self, response: DeviceResponse) -> None:
        """Called from the worker's pipe receive thread."""
        now = time.monotonic()
        with self._cv:
            if self._abandoned.pop(response.req_id, None) is None:
                self._responses[response.req_id] = (response, now)
            # prune responses nobody will ever wait() for (a task that
            # errored after posting) — without this a long-lived worker
            # leaks every orphaned payload
            for d in (self._responses, self._abandoned):
                stale = [rid for rid, v in d.items()
                         if now - (v[1] if isinstance(v, tuple) else v) > self.TIMEOUT]
                for rid in stale:
                    del d[rid]
            self._cv.notify_all()

    def discard(self, req_id: int) -> None:
        """Drop the response of a posted request the caller abandoned (an
        error path); a late arrival is dropped on delivery."""
        with self._cv:
            if self._responses.pop(req_id, None) is None:
                self._abandoned[req_id] = time.monotonic()

    def post(self, kind: str, payload, meta: dict) -> int:
        with self._cv:
            req_id = self._next_id
            self._next_id += 1
        with self._send_lock:
            self._conn.send(DeviceRequest(kind=kind, payload=payload,
                                          meta=meta, req_id=req_id))
        return req_id

    def wait(self, req_id: int, timeout: float = None):
        """The response's payload; raises RuntimeError on a response that
        carries an error or once the connection is lost (`lose`),
        TimeoutError when none came within `timeout` (TIMEOUT by
        default)."""
        timeout = timeout or self.TIMEOUT
        deadline = time.monotonic() + timeout
        with self._cv:
            while req_id not in self._responses:
                if self._lost is not None:
                    raise RuntimeError(self._lost)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    if req_id in self._responses:
                        break
                    raise TimeoutError(f"device service did not answer request "
                                       f"{req_id} within {timeout}s")
            response, _ = self._responses.pop(req_id)
        if response.error is not None:
            raise RuntimeError(f"device service error: {response.error}")
        return response.payload

    def request(self, kind: str, payload, meta: dict):
        return self.wait(self.post(kind, payload, meta))

    def cluster_assign(self, packed: np.ndarray, meta: dict) -> np.ndarray:
        return self.request("cluster_assign", packed, meta)
