"""
SNF -> candidate tensors for the sharded multi-sample combine step.

Bridges the SNF format (io/snf.py, indexed gzip blocks of pickled SVCall
candidates, reference: snf.py:91-224) to the mesh combine step
(parallel/mesh.py build_sharded_combine_step): each sample's candidates
are read block by block, as CombineTask does (pipeline/tasks.py
_bin_candidates), into the struct-of-arrays layout of _CAND_FIELDS, and
shard_candidate_tensors cuts them into contiguous genome windows.

Copied from sniffles_tpu/parallel/combine_tensors.py (:20, :66); numpy,
as there.
"""
from __future__ import annotations

import numpy as np

from sniffles_tpu_torch.ops._call_consts import SVTYPE_CODES


def snf_candidate_tensors(snf_paths: list[str], contig: str, config,
                          support_threshold: int = 0) -> dict:
    """Every candidate of `contig` in the .snf files, in the combine step's
    layout: a dict of [N] arrays pos, svlen, svtype, sample_id, support,
    qc, valid and orig_idx (the position in the read order), sorted by
    pos. A sample's internal id is its file's position in `snf_paths`
    (the CLI's snf_input_info order)."""
    from sniffles_tpu_torch.io import snf as snfmod

    cols = {"pos": [], "svlen": [], "svtype": [], "sample_id": [],
            "support": [], "qc": []}
    for sample_id, path in enumerate(snf_paths):
        handle = snfmod.SNFile(config, open(path, "rb"), filename=path)
        handle.read_header()
        index = handle.header["index"].get(contig, {})
        for block_start in sorted(int(b) for b in index):
            for block in handle.read_blocks(contig, int(block_start)) or []:
                for svtype, code in SVTYPE_CODES.items():
                    for cand in block.get(svtype, []):
                        if cand.support < support_threshold:
                            continue
                        cols["pos"].append(cand.pos)
                        cols["svlen"].append(cand.svlen)
                        cols["svtype"].append(code)
                        cols["sample_id"].append(sample_id)
                        cols["support"].append(cand.support)
                        cols["qc"].append(bool(cand.qc))
        handle.close()

    n = len(cols["pos"])
    out = {
        "pos": np.asarray(cols["pos"], dtype=np.int32),
        "svlen": np.asarray(cols["svlen"], dtype=np.int32),
        "svtype": np.asarray(cols["svtype"], dtype=np.int32),
        "sample_id": np.asarray(cols["sample_id"], dtype=np.int32),
        "support": np.asarray(cols["support"], dtype=np.int32),
        "qc": np.asarray(cols["qc"], dtype=bool),
        "valid": np.ones(n, dtype=bool),
        # provenance: the position in the pre-sort read order, so the
        # mesh's outputs map back to the candidates they came from
        "orig_idx": np.arange(n, dtype=np.int32),
    }
    order = np.argsort(out["pos"], kind="stable")
    return {k: v[order] for k, v in out.items()}


def shard_candidate_tensors(cand: dict, n_dev: int) -> tuple[dict, np.ndarray, np.ndarray]:
    """Split pos-sorted candidate tensors into n_dev contiguous genome
    windows, padded to a common per-shard size. Returns (the sharded dict,
    each array of length n_dev * S, offsets [n_dev], window_len [n_dev])
    for build_sharded_combine_step."""
    from sniffles_tpu_torch.parallel.mesh import genome_windows
    shard_of, offsets, window = genome_windows(cand["pos"], n_dev)
    per = max(int(np.bincount(shard_of, minlength=n_dev).max()) if len(shard_of) else 1, 1)
    out = {k: np.zeros((n_dev * per,) + v.shape[1:], dtype=v.dtype)
           for k, v in cand.items()}
    for s in range(n_dev):
        sel = np.nonzero(shard_of == s)[0]
        for k, v in cand.items():
            out[k][s * per:s * per + len(sel)] = v[sel]
    window_len = np.full(n_dev, window, dtype=np.int32)
    return out, offsets, window_len
