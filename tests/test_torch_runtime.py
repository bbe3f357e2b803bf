"""The port's worker pool (sniffles_tpu_torch/pipeline/runtime.py):
copies of the JAX package's fault-tolerance cases (tests/
test_fault_tolerance.py) — heartbeat death detection with task requeue,
recycling — plus the port's own rules: once this process has touched a
torch device, a recycled worker is spawned, not forked; and a worker's
config.device refuses any in-process device call."""
import multiprocessing
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from sniffles_tpu_torch.config import WORKER_DEVICE
from sniffles_tpu_torch.parallel import device_service
from sniffles_tpu_torch.pipeline.result import Result
from sniffles_tpu_torch.pipeline.runtime import SnifflesWorker


@dataclass
class DummyConfig:
    run_id: str = "test"
    threads: int = 2
    mode: str = "call_sample"
    device: str = "cpu"


@dataclass
class SimpleTask:
    id: int
    contig: str = "chr1"
    config: DummyConfig = field(default_factory=DummyConfig)
    result: object = None
    marker: str = ""

    def add_result(self, result):
        self.result = result

    def execute(self, worker=None):
        r = Result(self, [], 0)
        # what the worker saw: its pid, its config's device, its client
        r.seen = (os.getpid(), self.config.device, type(worker.device_client).__name__)
        return r


@dataclass
class CrashOnceTask(SimpleTask):
    """Kills its worker process on first execution; succeeds on retry."""

    def execute(self, worker=None):
        if not os.path.exists(self.marker):
            with open(self.marker, "w") as f:
                f.write("crashed")
            os._exit(17)
        return Result(self, [], 0)


@dataclass
class DeviceCallTask(SimpleTask):
    """Calls the device in process, as a path without its client would."""

    def execute(self, worker=None):
        from sniffles_tpu_torch.parallel.device_call import run_call_task
        run_call_task(np.zeros((15, 8), np.int32), {}, self.config.device)
        return Result(self, [], 0)


def drive(workers, tasks, timeout=60):
    for w in workers:
        w.start()
    t0 = time.monotonic()
    while any([w.run_parent() for w in workers if w.running]):
        time.sleep(0.02)
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("pool did not finish")
    finished = []
    for w in workers:
        w.finalize()
        finished.extend(w.finished_tasks)
    return finished


@pytest.fixture(autouse=True)
def _fork_method(monkeypatch):
    try:
        multiprocessing.set_start_method("fork")
    except RuntimeError:
        pass
    # an earlier test in this process may have run a device service
    monkeypatch.setattr(device_service, "DEVICE_LIVE", False)


def test_pool_runs_tasks():
    config = DummyConfig()
    tasks = deque(SimpleTask(id=i, config=config) for i in range(6))
    workers = [SnifflesWorker(process_id=i, config=config, tasks=tasks) for i in range(2)]
    finished = drive(workers, tasks)
    assert sorted(t.id for t in finished) == list(range(6))
    assert all(t.result is not None and not t.result.error for t in finished)
    # in the worker: another process, the worker device, a DeviceClient
    assert {t.result.seen[1:] for t in finished} == {(WORKER_DEVICE, "DeviceClient")}
    assert os.getpid() not in {t.result.seen[0] for t in finished}
    assert config.device == "cpu"       # the parent's own config is untouched


def test_dead_worker_task_requeued(tmp_path):
    """A worker dying mid-task is detected by heartbeat timeout; the task
    is requeued and completed by a surviving worker."""
    config = DummyConfig()
    marker = str(tmp_path / "crash.marker")
    tasks = deque()
    tasks.append(CrashOnceTask(id=0, marker=marker))
    for i in range(1, 4):
        tasks.append(SimpleTask(id=i))
    workers = []
    for i in range(2):
        workers.append(SnifflesWorker(process_id=i, config=config, tasks=tasks,
                                      peers=workers))
    for w in workers:
        w.HEARTBEAT_TIMEOUT = 3

    finished = drive(workers, tasks, timeout=90)
    assert os.path.exists(marker)  # the crash really happened
    assert sorted(t.id for t in finished) == [0, 1, 2, 3]
    assert all(t.result is not None for t in finished)
    assert sum(1 for w in workers if not w.running) == 2


def test_worker_recycling():
    """A recycle hint replaces the worker process between tasks; all tasks
    still complete."""
    config = DummyConfig()
    calls = {"n": 0}

    def recycle_hint(worker_id, pid):
        calls["n"] += 1
        return calls["n"] == 2  # recycle exactly once, after warm-up

    tasks = deque(SimpleTask(id=i) for i in range(5))
    workers = [SnifflesWorker(process_id=0, config=config, tasks=tasks,
                              recycle_hint=recycle_hint)]
    finished = drive(workers, tasks, timeout=60)
    assert sorted(t.id for t in finished) == list(range(5))
    assert calls["n"] >= 2
    assert len({t.result.seen[0] for t in finished}) == 2


@dataclass
class LingerTask(SimpleTask):
    """Leaves a thread behind that keeps its worker process alive for 4 s
    after the worker loop ends: longer than the recycle's 2 s join."""

    def execute(self, worker=None):
        threading.Thread(target=time.sleep, args=(4,)).start()
        return super().execute(worker)


def test_recycle_when_the_old_worker_is_slow_to_exit():
    """A recycled worker whose process outlives the recycle's join (a
    loaded machine) must not take the tasks meant for its successor: each
    process has pipes of its own, so every task completes, the tasks after
    the recycle in the new process."""
    config = DummyConfig()
    calls = {"n": 0}

    def recycle_hint(worker_id, pid):
        calls["n"] += 1
        return calls["n"] == 2

    tasks = deque([LingerTask(id=0, config=config)]
                  + [SimpleTask(id=i, config=config) for i in range(1, 5)])
    worker = SnifflesWorker(process_id=0, config=config, tasks=tasks,
                            recycle_hint=recycle_hint)
    finished = drive([worker], tasks, timeout=60)
    assert sorted(t.id for t in finished) == list(range(5))
    pids = [t.result.seen[0] for t in sorted(finished, key=lambda t: t.id)]
    assert len(set(pids)) == 2 and pids[-1] == worker.process.pid


def test_recycled_worker_is_spawned_once_the_device_is_live(monkeypatch):
    """After this process touched a torch device (DEVICE_LIVE), a recycled
    worker comes from a spawned interpreter; it runs the remaining tasks
    like a forked one."""
    config = DummyConfig()
    calls = {"n": 0}

    def recycle_hint(worker_id, pid):
        calls["n"] += 1
        if calls["n"] == 2:
            monkeypatch.setattr(device_service, "DEVICE_LIVE", True)
            return True
        return False

    tasks = deque(SimpleTask(id=i) for i in range(5))
    worker = SnifflesWorker(process_id=0, config=config, tasks=tasks,
                            recycle_hint=recycle_hint)
    first = worker.process
    finished = drive([worker], tasks, timeout=120)
    assert sorted(t.id for t in finished) == list(range(5))
    assert first._start_method is None           # the default (fork) context
    assert worker.process._start_method == "spawn"
    pids = [t.result.seen[0] for t in sorted(finished, key=lambda t: t.id)]
    assert len(set(pids)) == 2 and pids[-1] == worker.process.pid
    assert {t.result.seen[1:] for t in finished} == {(WORKER_DEVICE, "DeviceClient")}


def test_device_call_in_a_worker_raises():
    """A device call that reaches a worker without its client fails loudly
    (an ErrorResult naming the device), instead of running there."""
    config = DummyConfig()
    tasks = deque([DeviceCallTask(id=0, config=config), SimpleTask(id=1, config=config)])
    workers = [SnifflesWorker(process_id=0, config=config, tasks=tasks)]
    finished = sorted(drive(workers, tasks), key=lambda t: t.id)
    assert finished[0].result.error and not finished[1].result.error
    assert "Error in worker process while executing" in str(finished[0].result)
    assert "RuntimeError" in str(finished[0].result)
    with pytest.raises(RuntimeError):
        torch.zeros(1, device=WORKER_DEVICE)


def test_overlapping_scans_keep_their_own_regional_nm(tmp_path, monkeypatch):
    """Two contigs whose reads differ in NM. The decode-ahead may run the
    next task's scan beside the current one; here task 1's whole scan runs
    between the end of task 0's scan and task 0's read of its threshold.
    Each task still gets the regional NM of its own reads, the same as a
    scan alone, and the shared config is not written."""
    from sniffles_tpu_torch.config import SnifflesConfig
    from sniffles_tpu_torch.leads import LeadProvider
    from sniffles_tpu_torch.pipeline.tasks import CallTask
    from sniffles_tpu_torch.sim import write_dataset

    rates = (0.01, 0.08)
    bam, fasta = write_dataset(str(tmp_path), ref_len=40_000, depth=6, seed=3,
                               n_contigs=2, nm_rates=rates)

    def make_tasks():
        config = SnifflesConfig("--input", bam, "--vcf", str(tmp_path / "o.vcf"),
                                "--reference", fasta, "--qc-nm")
        config.input, config.input_mode = bam, "rb"
        config.task_read_id_offset_mult = 10 ** 6
        return config, [CallTask(id=i, contig=c, start=0, end=40_000, sv_id=0, config=config)
                        for i, c in enumerate(("chr1", "chr2"))]

    _, alone = make_tasks()
    for task in alone:
        task.build_leadtab()
    own = [task._nm_threshold for task in alone]

    config, tasks = make_tasks()
    before = dict(vars(config))
    mask = LeadProvider._mask_N_coverage

    def scan_the_next_task_first(provider, regions=None):
        mask(provider, regions)
        if provider.contig == "chr1":
            tasks[1].build_leadtab()

    monkeypatch.setattr(LeadProvider, "_mask_N_coverage", scan_the_next_task_first)
    tasks[0].build_leadtab()
    assert [task._nm_threshold for task in tasks] == own
    for got, rate in zip(own, rates):
        assert abs(got - rate) < 1e-3
    assert vars(config) == before
