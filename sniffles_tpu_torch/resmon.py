"""
Resource monitor: samples RSS of the parent and worker processes and
acts as a recycle hint when a worker exceeds the memory ceiling
(reference: utils/resmon.py:26-144). Uses /proc directly instead of
psutil so it has no external dependency.

A copy of sniffles_tpu/resmon.py.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger('sniffles_tpu_torch.resmon')

WORKER_RECYCLE_RSS = 2 * 1024 ** 3  # 2 GiB, same ceiling as reference resmon.py:42


def _read_rss(pid: int) -> int:
    """RSS of a process in bytes via /proc/<pid>/statm."""
    try:
        with open(f'/proc/{pid}/statm') as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf('SC_PAGE_SIZE')
    except (OSError, ValueError, IndexError):
        return 0


def _child_pids(pid: int) -> list[int]:
    children = []
    try:
        for tid in os.listdir(f'/proc/{pid}/task'):
            try:
                with open(f'/proc/{pid}/task/{tid}/children') as f:
                    children.extend(int(c) for c in f.read().split())
            except (OSError, ValueError):
                pass
    except OSError:
        pass
    return children


@dataclass
class MemoryUsage:
    timestamp: float
    total: int
    parent: int
    workers: dict


class ResourceMonitor:
    """Daemon thread sampling memory; callable as recycle hint
    (reference: resmon.py:35-144)."""

    def __init__(self, config, interval: Optional[int] = None):
        self.interval = interval if interval is not None else (config.dev_monitor_memory or 30)
        self.filename = getattr(config, 'dev_monitor_filename', None)
        if config.dev_monitor_memory and self.filename is None:
            self.filename = f'memory-{config.run_id}.csv'
        self._worker_rss: dict[int, int] = {}
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> MemoryUsage:
        parent_pid = os.getpid()
        parent = _read_rss(parent_pid)
        workers = {}
        for child in _child_pids(parent_pid):
            workers[child] = _read_rss(child)
        self._worker_rss = workers
        return MemoryUsage(timestamp=time.time(), total=parent + sum(workers.values()),
                           parent=parent, workers=workers)

    def _run(self):
        header_written = False
        while self._running:
            usage = self._sample()
            if self.filename:
                try:
                    with open(self.filename, 'a') as f:
                        if not header_written:
                            f.write('timestamp,total,parent,workers\n')
                            header_written = True
                        f.write(f'{usage.timestamp},{usage.total},{usage.parent},'
                                f'{";".join(str(v) for v in usage.workers.values())}\n')
                except OSError:
                    pass
            time.sleep(self.interval)

    def __call__(self, worker_id: int, worker_pid: int) -> bool:
        """Recycle hint: True when the worker exceeds the RSS ceiling."""
        rss = _read_rss(worker_pid)
        if rss > WORKER_RECYCLE_RSS:
            log.info(f'Worker {worker_id} ({worker_pid}) RSS {rss >> 20} MiB exceeds ceiling; '
                     f'flagging for recycle')
            return True
        return False

    def __bool__(self):
        return True

    def stop(self):
        self._running = False
