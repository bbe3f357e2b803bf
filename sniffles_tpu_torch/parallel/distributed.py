"""
The multi-host run: several CLI processes, each on its own host (or its
own cards of one host), split one run's tasks and process 0 writes the
output.

    SNIFFLES_TPU_COORDINATOR=host0:29500 SNIFFLES_TPU_NUM_PROCESSES=2 \\
    SNIFFLES_TPU_PROCESS_ID=<0 or 1> python -m sniffles_tpu_torch ...

Every process plans the same task list and runs the tasks whose index %
num_processes == its process id (shard_assignment: no coordinator state);
then the processes join a torch.distributed process group over Gloo at
the coordinator's address, every process gathers every result
(all_gather_object), and only process 0 (is_emitter) opens and writes the
output files. The group is created after the worker pool has finished,
never before it forks: shard_assignment and is_emitter need only the rank
and the world size, which the environment gives.

Before any work, once each process has checked its own configuration,
input and mesh, the processes meet once at the coordinator (rendezvous: a
TCPStore, closed again before the pool forks), within
SNIFFLES_TPU_RENDEZVOUS_TIMEOUT_S seconds. A process that exits early (a
usage error, a refused mesh) so ends its peers with exit 1 within that
bound, not at the gather's. A process lost later, during its tasks, is
seen only at the gather (GATHER_TIMEOUT_S).

Copied from sniffles_tpu/parallel/distributed.py (:29-76) and the CLI's
_maybe_init_distributed, _RemoteTask and _exchange_results_multihost
(sniffles_tpu/cli.py:442-490). Without the variables the run is a
single-host one, as in the JAX package; JAX's TPU-pod autodetection has no
counterpart here. Partial variables are a usage error.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

log = logging.getLogger(__name__)

ENV_COORDINATOR = "SNIFFLES_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "SNIFFLES_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "SNIFFLES_TPU_PROCESS_ID"

# how long a process waits at the gather for the others' results
GATHER_TIMEOUT_S = 3600

# how long a process waits, before any work, for the others to arrive
# (seconds; the variable overrides the default)
ENV_RENDEZVOUS_TIMEOUT = "SNIFFLES_TPU_RENDEZVOUS_TIMEOUT_S"
RENDEZVOUS_TIMEOUT_S = 300


@dataclass(frozen=True)
class Runtime:
    """One process's place in a multi-host run."""
    coordinator: str
    world_size: int
    rank: int

    def shard_assignment(self, n_shards: int) -> list[int]:
        """Deterministic ownership of the run's tasks: task i belongs to
        process i % world_size."""
        return [i for i in range(n_shards) if i % self.world_size == self.rank]

    @property
    def is_emitter(self) -> bool:
        """Only process 0 writes the VCF/SNF output files."""
        return self.rank == 0


def from_environment() -> Runtime | None:
    """The multi-host runtime the environment announces, or None for a
    single-host run (no variable set, or one process). Raises ValueError
    when the variables are incomplete or out of range."""
    coordinator = os.environ.get(ENV_COORDINATOR, "").strip()
    num = os.environ.get(ENV_NUM_PROCESSES, "").strip()
    pid = os.environ.get(ENV_PROCESS_ID, "").strip()
    if not (coordinator or num):
        return None
    if not (coordinator and num and pid):
        raise ValueError(f"a multi-host run needs {ENV_COORDINATOR} (host:port), "
                         f"{ENV_NUM_PROCESSES} and {ENV_PROCESS_ID}; got "
                         f"{coordinator!r}, {num!r} and {pid!r}")
    world, rank = int(num), int(pid)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"{ENV_PROCESS_ID}={rank} is not in [0, {ENV_NUM_PROCESSES}={world})")
    if world == 1:
        return None
    return Runtime(coordinator=coordinator, world_size=world, rank=rank)


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def rendezvous(runtime: Runtime) -> None:
    """Waits until every process of the run has arrived here, at most the
    rendezvous timeout (ENV_RENDEZVOUS_TIMEOUT, else RENDEZVOUS_TIMEOUT_S):
    process 0 holds a TCPStore at the coordinator's address, every
    process sets its key and waits for all of them, and process 0 closes
    the store once every process has seen them all. Raises RuntimeError,
    naming the coordinator and the timeout, when a process does not
    arrive."""
    import datetime

    import torch.distributed as dist
    timeout_s = float(os.environ.get(ENV_RENDEZVOUS_TIMEOUT, "") or RENDEZVOUS_TIMEOUT_S)
    host, port = _init_method(runtime.coordinator).split("://", 1)[1].rsplit(":", 1)
    keys = range(runtime.world_size)
    try:
        store = dist.TCPStore(host, int(port), runtime.world_size,
                              is_master=runtime.rank == 0,
                              timeout=datetime.timedelta(seconds=timeout_s))
        store.set(f"arrived/{runtime.rank}", "1")
        store.wait([f"arrived/{r}" for r in keys])
        store.set(f"left/{runtime.rank}", "1")
        if runtime.rank == 0:
            # the server stays up until every client has seen every key
            store.wait([f"left/{r}" for r in keys])
        del store
    except RuntimeError as e:
        raise RuntimeError(f"multi-host run: not every one of the {runtime.world_size} "
                           f"processes reached {runtime.coordinator} within {timeout_s:g} s "
                           f"({ENV_RENDEZVOUS_TIMEOUT}); process {runtime.rank} stops: "
                           f"{e}") from e
    log.info(f"Multi-host runtime: process {runtime.rank}/{runtime.world_size} met the "
             f"others at {runtime.coordinator}")


@dataclass
class RemoteTask:
    """A result gathered from another process: just enough surface (id,
    result) for the ordered emission loop."""
    id: int
    result: object


def exchange_results(runtime: Runtime, finished_tasks: list) -> list:
    """Every process's (task id, result) pairs, gathered to every process
    and sorted by task id (the ordered emission of the multi-host run).
    Joins the Gloo process group at the coordinator, gathers, and leaves
    it again."""
    import datetime

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=_init_method(runtime.coordinator),
                            world_size=runtime.world_size, rank=runtime.rank,
                            timeout=datetime.timedelta(seconds=GATHER_TIMEOUT_S))
    try:
        log.info(f"Multi-host runtime: process {runtime.rank}/{runtime.world_size}, "
                 f"gathering {len(finished_tasks)} task results")
        gathered = [None] * runtime.world_size
        dist.all_gather_object(gathered, [(t.id, t.result) for t in finished_tasks])
    finally:
        dist.destroy_process_group()
    merged = [RemoteTask(task_id, result) for part in gathered for task_id, result in part]
    merged.sort(key=lambda t: t.id)
    return merged
