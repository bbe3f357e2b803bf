"""Signature batches for the engine cells: the SV signatures of one contig
of a sample, as struct-of-arrays numpy columns (the port's signature
batch: pos, svlen, svtype, read_id, strand, mapq, nm, repeat, sa, valid).

After the port's signatures.synthetic_batch (commit fac8884), with the
mix taken from the traffic file: sites spread over the contig at least
`min_spacing` apart, each het (VAF 0.5) or hom (VAF 1) and supported by a
binomial draw of `depth` reads at its VAF, so no site has more supporting
reads than the depth; lengths log-uniform over `svlen`; types drawn from
`svtypes`; breakpoints jittered; a share of sites in tandem repeats; split
reads behind a share of the long deletions' signatures. The batch holds
exactly `n_signatures` slots, every one valid, in random order.
"""
from __future__ import annotations

import numpy as np

COLUMNS = {"pos": np.int32, "svlen": np.int32, "svtype": np.int32, "read_id": np.int32,
           "strand": np.int32, "mapq": np.int32, "nm": np.float32, "repeat": bool,
           "sa": bool, "valid": bool}
SVTYPE_CODES = {"INS": 0, "DEL": 1, "DUP": 2, "INV": 3}


def synthetic_batch(seed, n_signatures: int, contig_len: int, min_spacing: int, depth: int,
                    p_het: float, svlen: list, svtypes: list, pos_jitter: int,
                    len_jitter: int, mapq_max_share: float, mapq: list, nm_max: float,
                    p_repeat: float, sa_min_len: int, p_sa: float) -> dict:
    """{column: array [n_signatures]} drawn from `seed`."""
    rng = np.random.default_rng(seed)
    n = n_signatures
    mean_reads = depth * (0.5 * p_het + (1 - p_het))
    m = int(n / mean_reads * 1.25) + 16
    het = rng.random(m) < p_het
    reads = rng.binomial(depth, np.where(het, 0.5, 1.0))
    reads = reads[reads > 0]
    total = np.cumsum(reads)
    k = int(np.searchsorted(total, n)) + 1
    if k > reads.shape[0]:
        raise ValueError("the mix's sites hold fewer signatures than the batch")
    reads = reads[:k].copy()
    reads[-1] -= total[k - 1] - n
    free = contig_len - 20_000 - k * min_spacing - svlen[1]
    if free <= 0:
        raise ValueError(f"{k} sites {min_spacing} bp apart do not fit on {contig_len} bp")
    centers = np.sort(rng.integers(0, free, size=k)) + np.arange(k) * min_spacing + 10_000
    lens = np.exp(rng.uniform(np.log(svlen[0]), np.log(svlen[1]), size=k)).astype(np.int64)
    types = np.array([SVTYPE_CODES[t] for t in svtypes])[rng.integers(0, len(svtypes), k)]
    repeat = rng.random(k) < p_repeat
    site = rng.permutation(np.repeat(np.arange(k), reads))

    out = {}
    out["pos"] = centers[site] + rng.integers(-pos_jitter, pos_jitter + 1, size=n)
    svl = np.maximum(lens[site] + rng.integers(-len_jitter, len_jitter + 1, size=n), 1)
    out["svlen"] = np.where(types[site] == SVTYPE_CODES["DEL"], -svl, svl)
    out["svtype"] = types[site]
    out["read_id"] = rng.integers(0, 1 << 30, size=n)
    out["strand"] = rng.choice(np.array([-1, 1]), size=n)
    out["mapq"] = np.where(rng.random(n) < mapq_max_share, mapq[1],
                           rng.integers(mapq[0], mapq[1], size=n))
    out["nm"] = rng.random(n, dtype=np.float32) * np.float32(nm_max)
    out["repeat"] = repeat[site]
    long_del = (types[site] == SVTYPE_CODES["DEL"]) & (lens[site] >= sa_min_len)
    out["sa"] = long_del & (rng.random(n) < p_sa)
    out["valid"] = np.ones(n, dtype=bool)
    return {k: np.ascontiguousarray(out[k], dtype=t) for k, t in COLUMNS.items()}
