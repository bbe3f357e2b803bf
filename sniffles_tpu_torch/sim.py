"""
Synthetic multi-sample cohorts as SNF files: test and smoke-run tooling
for the combine mode (the counterpart of sniffles_tpu/sim.py, which
simulates BAMs for the call path).

`write_cohort` plants a shared population of SV sites and writes one SNF
per sample with this package's own SNF writer, holding the fields that
call_sample sets and combine reads. Site layout as the JAX package's
tools/bench_combine.py::plant_population: INS/DEL/INS/DEL/DUP/INV in
turn, lengths drawn from {60, 120, 300, 800, 2500}, and per sample 25 %
absent, 35 % homozygous, 40 % heterozygous. Each INS carrier's allele is
the site allele with seeded per-sample substitutions (about 2 %), which
stands for the consensus noise of long reads: carriers still group under
--combine-pctseq 0.7, and the combine's edit-distance tables are not
uniform, so the device edit-distance path runs.
"""
from __future__ import annotations

import io
import os

import numpy as np

from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.config import SnifflesConfig
from sniffles_tpu_torch.io import snf

_KINDS = ("INS", "DEL", "INS", "DEL", "DUP", "INV")
_LENGTHS = (60, 120, 300, 800, 2500)
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def plant_sites(rng, contigs, site_gap=(8_000, 14_000), lengths=_LENGTHS):
    """[(contig, pos, svtype, svlen, allele)] for every population site."""
    sites = []
    i = 0
    for contig, ref_len in contigs:
        pos = 20_000
        while pos < ref_len - 25_000:
            kind = _KINDS[i % len(_KINDS)]
            svlen = int(rng.choice(lengths))
            if kind in ("DUP", "INV"):
                svlen = max(svlen, 600)
            allele = (_BASES[rng.integers(0, 4, size=svlen)].tobytes().decode()
                      if kind == "INS" else "")
            sites.append((contig, pos, kind, svlen, allele))
            pos += int(rng.integers(site_gap[0], site_gap[1]))
            i += 1
    return sites


def _mutate(rng, allele: str, rate: float) -> str:
    """The allele with each base substituted, with probability `rate`,
    by one of the three other bases."""
    seq = np.frombuffer(allele.encode(), dtype=np.uint8).copy()
    hit = rng.random(len(seq)) < rate
    if hit.any():
        codes = np.searchsorted(_BASES, seq[hit])
        seq[hit] = _BASES[(codes + rng.integers(1, 4, size=int(hit.sum()))) % 4]
    return seq.tobytes().decode()


def _call(rng, contig, site_pos, kind, svlen, allele, het, depth, k, subst_rate):
    pos = site_pos + int(rng.integers(-10, 11))
    support = (int(rng.integers(depth // 2 - 3, depth // 2 + 4)) if het
               else int(rng.integers(depth - 4, depth + 1)))
    fwd = int(rng.integers(support // 3, support - support // 3 + 1))
    if kind == "INS":
        alt = _mutate(rng, allele, subst_rate)
        length, end = len(alt), pos
        info = {"SUPPORT_LONG": 0}
    else:
        alt = f"<{kind}>"
        length = -svlen if kind == "DEL" else svlen
        end = pos + svlen
        info = {"SUPPORT_SA": 0} if kind == "DEL" else {}
    info.update({"STDEV_POS": float(rng.random() * 5),
                 "STDEV_LEN": float(rng.random() * 3),
                 "PHASE": f"0,NULL,{support},{support},PASS,FAIL",
                 "VAF": support / depth})
    gq = int(rng.integers(20, 61))
    gt = (0, 1) if het else (1, 1)
    cov = int(rng.integers(depth - 3, depth + 4))
    return sv.SVCall(
        svtype=kind, svlen=length, end=end, contig=contig, pos=pos,
        ref="N", alt=alt, id=f"{kind}.{k:X}S0", qual=int(rng.integers(40, 61)),
        filter="PASS", info=info,
        genotypes={0: gt + (gq, depth - support, support, (None, None))},
        support=support, precise=bool(rng.random() < 0.9), qc=True, nm=-1,
        rnames=None, postprocess=None, fwd=fwd, rev=support - fwd,
        coverage_upstream=cov, coverage_start=cov, coverage_center=cov,
        coverage_end=cov, coverage_downstream=cov)


def write_snf(path: str, config: SnifflesConfig, calls: list, depth_of) -> None:
    """Write one sample's SNF: calls grouped into blocks per contig, each
    block with its downsampled coverage map (depth_of(contig, pos))."""
    index: dict = {}
    payloads = []
    offset = 0
    contigs = sorted({c.contig for c in calls})
    window = config.coverage_binsize_combine
    for contig in contigs:
        part = snf.SNFile(config, io.BytesIO())
        for call in calls:
            if call.contig == contig:
                part.store(call)
        for base, block in part.blocks.items():
            for probe in range(base, base + config.snf_block_size, window):
                block["_COVERAGE"][probe] = depth_of(contig, probe)
        part.write_and_index()
        index[contig] = {str(block): [(start + offset, length)]
                         for block, (start, length) in part.get_index().items()}
        offset += part.get_total_length()
        payloads.append(part.handle.getvalue())
    with open(path, "wb") as handle:
        writer = snf.SNFile(config, handle)
        writer.write_header(config, index, len(calls))
        for payload in payloads:
            handle.write(payload)


def write_cohort(dirpath: str, n_samples: int, seed: int,
                 contigs=(("chr1", 1_000_000), ("chr2", 1_000_000)),
                 site_gap=(8_000, 14_000), depth: int = 30,
                 subst_rate: float = 0.02, lengths=_LENGTHS) -> list[str]:
    """Write s000.snf ... into dirpath; returns their paths in order.
    `lengths` narrows the SV lengths drawn (small tests)."""
    os.makedirs(dirpath, exist_ok=True)
    sites = plant_sites(np.random.default_rng(seed), contigs, site_gap, lengths)
    config = SnifflesConfig("--input", "cohort.bam", "--snf", "cohort.snf")
    config.contig_lengths = [(name, length) for name, length in contigs]
    paths = []
    for idx in range(n_samples):
        rng = np.random.default_rng([seed, idx + 1])
        calls = []
        for contig, pos, kind, svlen, allele in sites:
            draw = rng.random()
            if draw < 0.25:
                continue  # absent in this sample
            calls.append(_call(rng, contig, pos, kind, svlen, allele,
                               het=draw >= 0.6, depth=depth, k=len(calls),
                               subst_rate=subst_rate))
        name = f"s{idx:03d}"
        config.sample_id = name
        depth_rng = np.random.default_rng([seed, idx + 1, 7])
        depths = depth_rng.integers(depth - 5, depth + 6, size=64)

        def depth_of(contig, probe, depths=depths):
            return int(depths[(probe // config.coverage_binsize_combine) % len(depths)])

        path = os.path.join(dirpath, f"{name}.snf")
        write_snf(path, config, calls, depth_of)
        paths.append(path)
    return paths
