"""The layout of the call step's packed input and flat output, shared by
the device step (ops/clustering) and its host packer and consumer
(parallel/device_call). This module imports no torch, so that a CLI run
served by the device daemon, which packs and decodes but launches
nothing, never imports it."""
from __future__ import annotations

import numpy as np

# svtype codes (order matches svcall.ALL_TYPES)
SVTYPE_NAMES = ["INS", "DEL", "DUP", "INV", "BND", "SINGLE_LEFT", "SINGLE_RIGHT"]
SVTYPE_CODES = {name: i for i, name in enumerate(SVTYPE_NAMES)}

STATS_ROWS = 21          # 9 calling stats + 9 phase tallies + parent +
                         # uncertain + counts — ALL PER RESPLIT CHILD
STATS_PARENT_ROW = 18    # child's parent (pre-resplit) cluster id
STATS_UNCERTAIN_ROW = 19  # parent's resplit float32-ambiguity flag
STATS_NC_ROW = 20        # slot 0 = n_children, slot 1 = n_clusters


def split_call_task_output(flat: np.ndarray, n: int):
    """Split the flat call_task_packed result back into (elements (3, N),
    stats (STATS_ROWS, SLOTS))."""
    elements = flat[:3 * n].reshape(3, n)
    stats = flat[3 * n:].reshape(STATS_ROWS, -1)
    return elements, stats
