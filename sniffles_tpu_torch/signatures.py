"""
Signature tensorization: Lead objects <-> fixed-width struct-of-arrays
batches for the fused calling engine (parallel/engine.py; reference Lead
fields: leadprov.py:34-56).

Copied from sniffles_tpu/signatures.py, in numpy. One difference: read
names hash to ids with parallel/device_call.qname_hash31 (zlib.crc32),
deterministic across processes, where the JAX package takes Python's
salted hash(); engine outputs depend only on which leads share an id.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sniffles_tpu_torch.ops._call_consts import SVTYPE_CODES


@dataclass
class SignatureBatch:
    """Struct-of-arrays signature batch (padded to a static size)."""
    pos: np.ndarray        # int32 [N] ref_start
    svlen: np.ndarray      # int32 [N]
    svtype: np.ndarray     # int32 [N] (SVTYPE_CODES)
    read_id: np.ndarray    # int32 [N]
    strand: np.ndarray     # int32 [N] (+1 fwd / -1 rev)
    mapq: np.ndarray       # int32 [N]
    nm: np.ndarray         # float32 [N]
    repeat: np.ndarray     # bool [N] (within tandem-repeat annotation)
    sa: np.ndarray         # bool [N] (split-read evidence: lead source != INLINE)
    valid: np.ndarray      # bool [N]

    @property
    def size(self) -> int:
        return int(self.pos.shape[0])

    @property
    def count(self) -> int:
        return int(self.valid.sum())

    def as_dict(self) -> dict:
        return {"pos": self.pos, "svlen": self.svlen, "svtype": self.svtype,
                "read_id": self.read_id, "strand": self.strand, "mapq": self.mapq,
                "nm": self.nm, "repeat": self.repeat, "sa": self.sa,
                "valid": self.valid}


def _pad_to(n: int, batch_size: Optional[int]) -> int:
    if batch_size is not None:
        return max(batch_size, n)
    # round up to the next power of two (>= 1024) to bound the shapes
    size = 1024
    while size < n:
        size *= 2
    return size


def _empty(size: int) -> SignatureBatch:
    return SignatureBatch(
        pos=np.zeros(size, dtype=np.int32), svlen=np.zeros(size, dtype=np.int32),
        svtype=np.zeros(size, dtype=np.int32), read_id=np.zeros(size, dtype=np.int32),
        strand=np.ones(size, dtype=np.int32), mapq=np.zeros(size, dtype=np.int32),
        nm=np.zeros(size, dtype=np.float32), repeat=np.zeros(size, dtype=bool),
        sa=np.zeros(size, dtype=bool), valid=np.zeros(size, dtype=bool))


def from_leads(leads: list, tr_regions: Optional[list[tuple[int, int]]] = None,
               batch_size: Optional[int] = None) -> SignatureBatch:
    """
    Tensorize a list of Lead objects. Read names are hashed to int32 ids
    (support counting needs uniqueness, not identity). Leads with
    svlen=None (long-INS soft clips) are excluded — they feed the
    leads_long side channel handled host-side.
    """
    from sniffles_tpu_torch.parallel.device_call import qname_hash31

    usable = [ld for ld in leads if ld.svlen is not None]
    n = len(usable)
    batch = _empty(_pad_to(n, batch_size))
    batch.read_id[:n] = qname_hash31([ld.read_qname for ld in usable])
    for i, ld in enumerate(usable):
        batch.pos[i] = ld.ref_start
        batch.svlen[i] = ld.svlen
        batch.svtype[i] = SVTYPE_CODES.get(ld.svtype, 0)
        batch.strand[i] = 1 if ld.strand == "+" else -1
        batch.mapq[i] = ld.mapq if ld.mapq is not None else 0
        batch.nm[i] = ld.nm if ld.nm is not None and ld.nm >= 0 else 0.0
        batch.sa[i] = ld.source != "INLINE"
    batch.valid[:n] = True

    tr = sorted(tr_regions) if tr_regions else []
    if tr:
        tr_starts = np.array([s for s, e in tr], dtype=np.int64)
        tr_ends = np.array([e for s, e in tr], dtype=np.int64)
        pos = batch.pos[:n]
        idx = np.searchsorted(tr_starts, pos, side="right") - 1
        batch.repeat[:n] = (idx >= 0) & (pos < tr_ends[np.clip(idx, 0, len(tr_ends) - 1)])
    return batch


def synthetic_batch(n_signatures: int, n_clusters: int, seed: int = 0,
                    genome_span: int = 10_000_000, batch_size: Optional[int] = None,
                    reads_per_cluster: Optional[int] = None) -> SignatureBatch:
    """
    Synthetic signature batch for tests and the card's smoke run:
    n_clusters true SV sites with noisy supporting signatures. The same
    seed gives the JAX package's arrays byte for byte.
    """
    rng = np.random.default_rng(seed)
    batch = _empty(_pad_to(n_signatures, batch_size))

    centers = np.sort(rng.integers(10_000, genome_span, size=n_clusters))
    # keep clusters separated
    centers += np.arange(n_clusters) * 2000
    lens = rng.integers(60, 5000, size=n_clusters)
    types = rng.integers(0, 4, size=n_clusters)  # INS/DEL/DUP/INV

    assign = rng.integers(0, n_clusters, size=n_signatures)
    pos = centers[assign] + rng.integers(-15, 16, size=n_signatures)
    svl = lens[assign] + rng.integers(-5, 6, size=n_signatures)
    svl = np.where(types[assign] == 1, -svl, svl)  # DEL negative

    batch.pos[:n_signatures] = pos
    batch.svlen[:n_signatures] = svl
    batch.svtype[:n_signatures] = types[assign]
    batch.read_id[:n_signatures] = rng.integers(0, 1 << 30, size=n_signatures)
    batch.strand[:n_signatures] = rng.choice([-1, 1], size=n_signatures)
    batch.mapq[:n_signatures] = rng.integers(20, 60, size=n_signatures)
    batch.nm[:n_signatures] = rng.random(n_signatures, dtype=np.float32) * 0.05
    batch.valid[:n_signatures] = True
    return batch
