"""
Host-side parallel runtime: the worker process pool with heartbeat
liveness, dead-worker task requeue and memory-pressure recycling
(reference: parallel.py:585-807), and the inline runtime of --threads 0.

Workers only do BAM decode and host compute; device work stays in the
parent process (a CUDA context must not be forked). Workers reach the
device through the parent-owned device service
(parallel/device_service.py): they ship packed batches over their task
pipe and wait for the result, so ``--threads N`` composes with the device
path — host parallelism for decode and compute, one device context in
the parent. With a device daemon (parallel/device_daemon.py) every
worker, and the inline worker, opens a connection of its own to the
daemon once it runs, and posts there. In a worker, config.device is
WORKER_DEVICE, on which any in-process device call raises.

Copied from sniffles_tpu/pipeline/runtime.py: SnifflesWorker (pipes,
heartbeat, requeue, recycling, the lookahead task, the receive thread
and the decode-ahead prefetch), _spawned_worker_main, the inline
SnifflesParentWorker with its decode-ahead, and their connections to
the device daemon (no fallback: a daemon that does not answer raises).
"""
from __future__ import annotations

import gc
import logging
import multiprocessing
import os
import sys
import threading
import time
from collections import deque
from typing import Union, Callable, TYPE_CHECKING

from sniffles_tpu_torch.pipeline.result import Result, ErrorResult
from sniffles_tpu_torch.pipeline.tasks import Task, ShutdownTask
from sniffles_tpu_torch.parallel import device_daemon
from sniffles_tpu_torch.parallel.device_service import (DeviceClient, DeviceRequest,
                                                        DeviceResponse)

if TYPE_CHECKING:
    from sniffles_tpu_torch.config import SnifflesConfig

log = logging.getLogger(__name__)


def _checked(result, task):
    """A task's result, or an ErrorResult for a task that returned none
    (GenotypeTask's bailout on a target without depth values). The JAX
    package's worker sends nothing for such a task, which leaves the
    parent waiting for it, and its inline run fails at emission; here the
    task fails and the run exits 1."""
    if result is None:
        return ErrorResult(f"{task} returned no result")
    return result


def _device_live() -> bool:
    """Whether this process has touched a torch device: the device
    service ran, or torch holds a CUDA context."""
    from sniffles_tpu_torch.parallel import device_service
    torch = sys.modules.get("torch")
    return device_service.DEVICE_LIVE or bool(torch is not None and torch.cuda.is_initialized())


class SnifflesWorker:
    """Handle for a worker process; exists in both parent and child after fork
    (reference: parallel.py:585-769)."""
    id: int
    externals: list = None
    recycle: bool = False
    task2 = None
    _recycle_flag: bool = False
    running = True
    pid: int = None
    daemon_socket: str = None
    _shutdown: threading.Event
    _heartbeat: float = 0
    HEARTBEAT_INTERVAL = 3   # seconds
    HEARTBEAT_TIMEOUT = 10   # seconds

    class Shutdown(Exception):
        """Indicates this worker process should shut down."""

    def __init__(self, process_id: int, config: 'SnifflesConfig', tasks: deque,
                 recycle_hint: Union[bool, Callable] = None,
                 peers: list['SnifflesWorker'] = None,
                 device_server=None, daemon_socket: str = None):
        self.id = process_id
        self.config = config
        self.tasks = tasks
        self.task = None
        self.task2 = None   # lookahead slot (decode-ahead; LOOKAHEAD_MODES)
        self.finished_tasks = []
        self.recycle = recycle_hint
        # shared parent-side dispatcher (parallel/device_service.py); its
        # thread and the device context start after all forks
        self.device_server = device_server
        # the device daemon's socket, when it serves the run's device work
        self.daemon_socket = daemon_socket
        # Peer pool visibility: an idle worker only shuts down when no peer
        # has an in-flight task, so a dead peer's requeued task still finds
        # a live worker. (The reference shuts down on an empty deque,
        # parallel.py:673-676, and loses requeued tasks in that race —
        # sniffles:535-542 then warns and writes partial results.)
        self.peers = peers if peers is not None else []

        self.pipe_main, self.pipe_worker = multiprocessing.Pipe()
        self.heartbeat_main, self.heartbeat_worker = multiprocessing.Pipe()
        # pipe_main is written by the parent poll loop (tasks) AND the
        # device dispatcher thread (responses); Connection.send is not
        # thread-safe, so both go through this lock
        self._send_lock = threading.Lock()

        self.process = self._make_process()

    def send_main(self, msg) -> None:
        with self._send_lock:
            self.pipe_main.send(msg)

    def _make_process(self) -> multiprocessing.Process:
        if _device_live():
            # This process has touched a torch device (a CUDA context, or
            # torch's CPU thread pools on the dispatcher thread): fork
            # would copy their locked state into the child. Recycled
            # workers therefore come from a clean spawned interpreter.
            ctx = multiprocessing.get_context("spawn")
            return ctx.Process(target=_spawned_worker_main,
                               args=(self.id, self.pipe_worker, self.heartbeat_worker,
                                     self.daemon_socket),
                               daemon=True)
        return multiprocessing.Process(target=self.run_worker, daemon=True)

    def __str__(self):
        return f'Worker {self.id} @ process {self.pid}'

    def start(self) -> None:
        self.running = True
        self.process.start()
        self._heartbeat = time.monotonic()

    def _recycle_wanted(self) -> bool:
        return bool(self.recycle(self.id, self.process.pid) if callable(self.recycle)
                    else self.recycle)

    def _do_recycle(self):
        log.info(f'Recycling worker {self.id}')
        self.send_main(ShutdownTask())
        self.process.join(2)
        # The old process may outlive the join (a loaded machine); its
        # receiver thread still reads its pipe, so the new process gets
        # pipes of its own and no later task can reach the old one.
        with self._send_lock:
            self.pipe_main, self.pipe_worker = multiprocessing.Pipe()
        self.heartbeat_main, self.heartbeat_worker = multiprocessing.Pipe()
        self.process = self._make_process()
        self.process.start()
        self._heartbeat = time.monotonic()

    def maybe_recycle(self):
        """Recycle this worker if requested (reference: parallel.py:633-650)."""
        if self._recycle_flag or self._recycle_wanted():
            self._recycle_flag = False
            self._do_recycle()

    # Modes in which the parent keeps a second task in flight per worker
    # so the worker can overlap the next task's BAM decode with the
    # current task's compute (the same decode-ahead as the inline
    # SnifflesParentWorker; the reference runtime has no such overlap).
    LOOKAHEAD_MODES = ("call_sample", "genotype_vcf")

    def run_parent(self) -> bool:
        """Parent-side poll step (reference: parallel.py:652-717)."""
        try:
            if self.task is None and self.task2 is not None:
                self.task, self.task2 = self.task2, None

            if self.task is None:
                if len(self.tasks) > 0:
                    self.maybe_recycle()
                    try:
                        self.task = self.tasks.popleft()
                    except IndexError:
                        log.debug(f'No more tasks to do for {self.id}')
                    else:
                        self.send_main(self.task)
                else:
                    peers_busy = any(p.task is not None for p in self.peers
                                     if p is not self and p.running)
                    if not peers_busy:
                        self.send_main(ShutdownTask())
                        self.running = False
            else:
                if (self.task2 is None and len(self.tasks) > 0
                        and not self._recycle_flag
                        and getattr(self.config, 'mode', None) in self.LOOKAHEAD_MODES):
                    try:
                        self.task2 = self.tasks.popleft()
                    except IndexError:
                        pass
                    else:
                        self.send_main(self.task2)

                if self.pipe_main.poll(0.01):
                    msg = self.pipe_main.recv()
                    if isinstance(msg, DeviceRequest):
                        # the worker asked for device work; the dispatcher
                        # thread answers on this worker's pipe when it is
                        # done, so the poll loop never blocks on the card
                        if self.device_server is None:
                            self.send_main(DeviceResponse(
                                error="this run has no device service (the device "
                                      "path is off)", req_id=msg.req_id))
                        else:
                            self.device_server.submit(msg, self.send_main)
                        return self.running
                    result: Result = msg

                    if result.error:
                        log.error(f'Worker {self.id} received error: {result}')

                    self.task.add_result(result)
                    self.finished_tasks.append(self.task)
                    self.task, self.task2 = self.task2, None
                    # evaluate the recycle hint at task boundaries (the
                    # reference cadence); with lookahead the worker never
                    # goes idle between tasks, so a positive hint stops the
                    # task2 refill and recycles once the worker drains
                    if len(self.tasks) > 0 and not self._recycle_flag:
                        self._recycle_flag = self._recycle_wanted()

                if self.heartbeat_main.poll():
                    self.heartbeat_main.recv()
                    self._heartbeat = time.monotonic()

                if self._heartbeat < time.monotonic() - self.HEARTBEAT_TIMEOUT:
                    log.debug(f'Worker {self.id} missed heartbeat!')
                    try:
                        self.process.join(0.2)
                    except Exception:
                        ...
                    if self.process.exitcode is not None:
                        log.warning(f'Worker {self.id}|{self.pid} found dead '
                                    f'(code {self.process.exitcode})!')
                        if self.task2:
                            self.tasks.appendleft(self.task2)
                        if self.task:
                            self.tasks.appendleft(self.task)
                        self.running = False
        except Exception:
            log.exception(f'Unhandled error in worker {self.id}. This may result in an '
                          f'orphaned worker process.')
            try:
                self.process.kill()
            except Exception:
                ...

        return self.running

    def finalize(self):
        self.process.join(10)

        if self.process.exitcode is None:
            log.warning(f'Worker {self.id} refused to shut down gracefully, killing it.')
            self.process.kill()
            self.process.join(2)

    @staticmethod
    def _adopt(task) -> None:
        """A received task's config in this worker: the device is the
        parent's, so config.device refuses any in-process device call, and
        a spawned worker re-establishes the config singleton that forked
        workers inherit."""
        cfg = getattr(task, "config", None)
        if cfg is None:
            return
        from sniffles_tpu_torch.config import WORKER_DEVICE, SnifflesConfig
        if hasattr(cfg, "device"):
            cfg.device = WORKER_DEVICE
        if getattr(SnifflesConfig, "GLOBAL", None) is not cfg:
            SnifflesConfig.GLOBAL = cfg

    def run_worker(self):
        """Worker-process main loop (reference: parallel.py:728-762).

        Unlike the reference (one task in flight, strict recv/execute/send),
        a receiver thread drains the task pipe into a local queue and starts
        a decode-ahead prefetch of the NEXT task's BAM scan while the main
        thread computes the current one (the parent keeps two tasks in
        flight per worker in LOOKAHEAD_MODES). Results are still produced
        strictly in task-send order, so the parent's FIFO result matching
        is unchanged."""
        import concurrent.futures

        self.pid = os.getpid()
        # Automatic generational GC is pure overhead for this workload:
        # a combine/call task materializes 10^5-10^6 mostly-acyclic
        # objects (SVCall/Lead), and every automatic gen-2 pass scans
        # them all. The explicit gc.collect() after each task below keeps
        # the reference's per-task collection semantics (parallel.py:760)
        # while the allocation storm runs collector-free.
        gc.disable()
        self._shutdown = threading.Event()
        # pipe_worker is written by the main loop (results) and by any
        # thread posting device requests (decode-ahead prefetch);
        # serialize sends through one lock shared with the DeviceClient
        self._worker_send_lock = threading.Lock()
        self.device_client = (device_daemon.connect(self.daemon_socket) if self.daemon_socket
                              else DeviceClient(self.pipe_worker,
                                                send_lock=self._worker_send_lock))

        t = threading.Thread(target=self.run_worker_heartbeats, daemon=True)
        t.start()

        pending: deque = deque()
        pending_cv = threading.Condition()
        prefetched: dict = {}
        prefetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f'w{self.id}-prefetch')

        def recv_loop():
            try:
                while not self._shutdown.is_set():
                    msg = self.pipe_worker.recv()
                    if isinstance(msg, DeviceResponse):
                        # the answer to a request of the execute thread or
                        # of the prefetch
                        self.device_client.deliver(msg)
                        continue
                    self._adopt(msg)
                    if (not isinstance(msg, ShutdownTask)
                            and getattr(msg, 'lead_provider', 1) is None
                            and hasattr(msg, 'build_leadtab')
                            and getattr(getattr(msg, 'config', None), 'mode', None)
                            in self.LOOKAHEAD_MODES):
                        prefetched[id(msg)] = prefetch_pool.submit(
                            self._prefetch_task, msg)
                    with pending_cv:
                        pending.append(msg)
                        pending_cv.notify()
            except (EOFError, OSError):
                with pending_cv:
                    pending.append(None)
                    pending_cv.notify()

        rt = threading.Thread(target=recv_loop, daemon=True)
        rt.start()

        while self.running:
            with pending_cv:
                while not pending:
                    pending_cv.wait()
                task = pending.popleft()
            if task is None:  # pipe closed by parent
                break

            fut = prefetched.pop(id(task), None)
            if fut is not None:
                try:
                    fut.result()
                except Exception:
                    log.exception('Decode-ahead prefetch failed; task will decode inline')

            try:
                result = task.execute(self)
            except self.Shutdown:
                self.running = False
                self._shutdown.set()
            except Exception as e:
                msg = f'Error in worker process while executing {task}: {type(e).__name__}: {e}'
                log.exception(msg)
                with self._worker_send_lock:
                    self.pipe_worker.send(ErrorResult(msg))
            else:
                with self._worker_send_lock:
                    self.pipe_worker.send(_checked(result, task))

            del task
            gc.collect()

        prefetch_pool.shutdown(wait=False, cancel_futures=True)
        if self.daemon_socket:
            self.device_client.close()
        t.join(1.0)

    def _prefetch_task(self, task):
        """Decode-ahead body: build the next task's leadtab on this
        background thread, then POST its device batch to the parent's
        device service so the device's work overlaps the current task's
        host compute (the execute thread later just waits for the
        response)."""
        task.build_leadtab()
        task.maybe_post_device(self.device_client)

    def run_worker_heartbeats(self):
        hb = 0
        while self.running:
            hb += 1
            self.heartbeat_worker.send(hb)
            self._shutdown.wait(self.HEARTBEAT_INTERVAL)


def _spawned_worker_main(worker_id: int, task_conn, heartbeat_conn,
                         daemon_socket: str = None) -> None:
    """Entry point for spawn-context worker processes (used once the
    parent has touched a torch device and fork is unsafe). Builds a bare
    worker shell around the inherited pipe ends and runs the loop."""
    shell = SnifflesWorker.__new__(SnifflesWorker)
    shell.id = worker_id
    shell.pipe_worker = task_conn
    shell.heartbeat_worker = heartbeat_conn
    shell.daemon_socket = daemon_socket
    shell.running = True
    shell.run_worker()


class SnifflesParentWorker:
    """Runs all tasks inline in the main process (--threads 0; reference:
    parallel.py:777-807). This is the mode in which tasks use the torch
    device directly, or, with a device daemon, post to it through
    `device_client`."""
    id: int = 0
    running = True
    device_client = None

    def __init__(self, config: 'SnifflesConfig', tasks: deque,
                 daemon_socket: str = None, **kwargs):  # noqa
        self.tasks = tasks
        self.task = None
        self.config = config
        self.daemon_socket = daemon_socket
        self.finished_tasks: list[Task] = []

    def start(self) -> None:
        if self.daemon_socket:
            self.device_client = device_daemon.connect(self.daemon_socket)

    def run_parent(self) -> bool:
        """Serial execution with decode-ahead: the next task's BAM scan
        overlaps the current task's compute. A scan keeps its regional NM
        statistic on its own lead provider (the reference writes it into
        the shared config), so two scans at once do not perturb QC."""
        import concurrent.futures

        tasks = list(self.tasks)
        count = len(tasks)
        can_prefetch = self.config.mode in SnifflesWorker.LOOKAHEAD_MODES

        # automatic generational GC passes over the 10^5-10^6 live task
        # objects of a combine run cost more than they free; collect once
        # per task instead (the same policy as the worker loop)
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
                next_fut = None
                for i, task in enumerate(tasks):
                    log.info(f'Executing {task} ({i + 1}/{count})')
                    if next_fut is not None:
                        next_fut.result()
                    next_fut = (pool.submit(tasks[i + 1].build_leadtab)
                                if can_prefetch and i + 1 < count else None)
                    task.add_result(_checked(task.execute(self), task))
                    self.finished_tasks.append(task)
                    gc.collect()
        finally:
            if gc_was_enabled:
                gc.enable()
        self.tasks.clear()
        return False

    def finalize(self):
        if self.device_client is not None:
            self.device_client.close()
