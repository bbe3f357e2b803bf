"""Host ranges of the port's layers, on the profiler's clock.

`span(name)` is a context manager. Outside a profiler it is one shared
null context: the hot path pays a flag read and nothing more, and no
option turns the spans on. Inside `torch.profiler.profile` (the
benchmark's traced run, tools/profile_engine.py, an operator's own) it is
a FUNCTION-scope RecordFunction: a host range on Kineto's clock, the
clock of the CUDA activity, that leaves no event on the device timeline
(a `record_function` range, of USER scope, is copied there as a
`gpu_user_annotation` and would read as device work). A range that opens
inside another has it as its parent in the profiler's tree.

The names are defined here alone; the benchmark's readers, the tools and
the tests import them.
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# parallel/engine.call_pipeline_step: the whole call, to_device included
STEP = "engine.step"
# its stages, in the order the step runs them
SORT_SEED = "clustering.sort_seed"    # ops/clustering.sort_and_seed
RELAX = "clustering.relax"            # ops/merge_relax.merge_relax (the engine's path)
RESPLIT = "clustering.resplit"        # ops/clustering._resplit and the cluster count
STATS = "engine.stats"                # ops/clustering.call_statistics
TAIL = "engine.tail"                  # the split-read support sum and ops/candidate_tail
STAGES = (SORT_SEED, RELAX, RESPLIT, STATS, TAIL)
# inside engine.step, in place of the stages: the replay of a captured step
REPLAY = "engine.replay"              # parallel/engine.StepGraph.replay

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named `name` while a profiler records, else the
    shared null context."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF
