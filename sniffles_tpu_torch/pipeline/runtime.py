"""
Inline runtime: all tasks run in this process, in order (--threads 0;
reference: parallel.py:777-807). Copied from
sniffles_tpu/pipeline/runtime.py: SnifflesParentWorker only. The worker
pool and its parent-owned device service for --threads N are not part
of the combine slice; the CLI refuses --threads N with the device path.
"""
from __future__ import annotations

import gc
import logging
from collections import deque
from typing import TYPE_CHECKING

from sniffles_tpu_torch.pipeline.tasks import Task

if TYPE_CHECKING:
    from sniffles_tpu_torch.config import SnifflesConfig

log = logging.getLogger(__name__)


class SnifflesParentWorker:
    """Runs all tasks inline in the main process (--threads 0). This is
    the mode in which tasks use the torch device directly."""
    id: int = 0
    running = True

    def __init__(self, config: 'SnifflesConfig', tasks: deque, **kwargs):  # noqa
        self.tasks = tasks
        self.task = None
        self.config = config
        self.finished_tasks: list[Task] = []

    def start(self) -> None:
        ...

    def run_parent(self) -> bool:
        """Serial execution of every queued task."""
        tasks = list(self.tasks)
        count = len(tasks)

        # automatic generational GC passes over the 10^5-10^6 live task
        # objects of a combine run cost more than they free; collect once
        # per task instead (the same policy as the JAX package)
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            for i, task in enumerate(tasks):
                log.info(f'Executing {task} ({i + 1}/{count})')
                result = task.execute(self)
                task.add_result(result)
                self.finished_tasks.append(task)
                gc.collect()
        finally:
            if gc_was_enabled:
                gc.enable()
        self.tasks.clear()
        return False

    def finalize(self):
        ...
