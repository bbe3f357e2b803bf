"""The one generator of the benchmark's traffic: a traffic file
(benchmark/traffic/<name>.json) names its generator and holds its
parameters; the run's seed draws everything else.

    signature_batches(mix, seed) -> [batch]   (generator "signatures")
    coverage(mix) -> int32 array [contig_len] (the batches' per-base read depth)
"""
from __future__ import annotations

import numpy as np

GENERATORS = ("signatures",)
_SIGNATURE_KEYS = ("n_signatures", "contig_len", "min_spacing", "depth", "p_het", "svlen",
                   "svtypes", "pos_jitter", "len_jitter", "mapq_max_share", "mapq", "nm_max",
                   "p_repeat", "sa_min_len", "p_sa")


def signature_batches(mix: dict, seed: int) -> list[dict]:
    """The mix's `batches` distinct batches, batch b drawn from [seed, b]."""
    from benchmark.traffic.signatures import synthetic_batch
    if mix["generator"] != "signatures":
        raise ValueError(f"no generator {mix['generator']!r} (one of {GENERATORS})")
    params = {k: mix[k] for k in _SIGNATURE_KEYS}
    return [synthetic_batch(np.random.SeedSequence([seed, b]), **params)
            for b in range(mix["batches"])]


def coverage(mix: dict, device=None):
    """The contig's per-base read depth, `depth` everywhere: a numpy array,
    or with `device` a torch tensor made there."""
    if device is None:
        return np.full(mix["contig_len"], mix["depth"], dtype=np.int32)
    import torch
    return torch.full((mix["contig_len"],), mix["depth"], dtype=torch.int32, device=device)
