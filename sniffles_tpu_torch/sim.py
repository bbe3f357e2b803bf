"""
Synthetic data for the tests and the smoke run: multi-sample cohorts as
SNF files for the combine mode, and simulated long-read alignments (BAM
+ reference FASTA) for the call path.

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

`write_dataset` (with PlantedSV, simulate and dense_layout) is a copy of
sniffles_tpu/sim.py: a random reference with planted INS/DEL (in the
reads' CIGARs) and DUP/INV (as split reads), long reads tiled over it,
written as a sorted, indexed BAM by io/bamwrite.py. For one seed it
writes the same bytes as the JAX package's.
"""
from __future__ import annotations

import io
import os
from dataclasses import dataclass

import numpy as np

from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.config import SnifflesConfig
from sniffles_tpu_torch.io import snf
from sniffles_tpu_torch.io.bamwrite import BamRecordSpec, write_bam

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


# ---------------------------------------------------------------------------
# Simulated alignments for the call path
# ---------------------------------------------------------------------------

@dataclass
class PlantedSV:
    pos: int          # reference position (0-based)
    svtype: str       # "INS" | "DEL" (CIGAR) or "DUP" | "INV" (split reads)
    svlen: int        # positive length
    seq: str = ""     # inserted sequence (INS); generated if empty
    vaf: float = 1.0  # fraction of reads carrying the SV
    support: int = 15  # split reads generated per DUP/INV site


def random_seq(rng, n: int) -> str:
    """n random bases; the same draws, and so the same string, as the JAX
    package's "".join(rng.choice(list("ACGT"), size=n)), without a Python
    string per base."""
    return _BASES[rng.integers(0, 4, size=n)].tobytes().decode()


def split_read_records(sv: PlantedSV, ref: str, contig: str, rng,
                       read_half: int = 4000) -> list[BamRecordSpec]:
    """
    Split-read (SA-tagged) alignments for DUP/INV events, the signature
    geometry classified by classify_splits (reference: sv.py:649-782).

    DUP: a read crossing the tandem junction maps forward twice —
    part 1 ends at the duplication end d2, part 2 restarts at d1
    (fwd/fwd, curr.ref_start <= last.ref_end -> DUP, sv.py:716-721).
    INV: part 1 maps forward up to the inversion start, part 2 maps
    reverse across the inverted segment (fwd then rev,
    curr.ref_end >= last.ref_end -> INV case A, sv.py:752-757).
    """
    records = []
    d1 = sv.pos
    d2 = sv.pos + sv.svlen
    for k in range(sv.support):
        jitter = int(rng.integers(0, 500))
        if sv.svtype == "DUP":
            # read: [x, d2) then [d1, y) — both forward
            x = d1 - read_half + jitter
            y = d1 + read_half - jitter
            len1 = d2 - x
            len2 = y - d1
            seq = ref[x:d2] + ref[d1:y]
            qname = f"dup{sv.pos}_{k:03d}"
            sa2 = f"{contig},{d1 + 1},+,{len1}S{len2}M,60,0;"
            sa1 = f"{contig},{x + 1},+,{len1}M{len2}S,60,0;"
            records.append(BamRecordSpec(qname=qname, flag=0, refid=0, pos=x, mapq=60,
                                         cigar=[("M", len1), ("S", len2)], seq=seq,
                                         tags={"NM": 0, "SA": sa2}))
            records.append(BamRecordSpec(qname=qname, flag=2048, refid=0, pos=d1, mapq=60,
                                         cigar=[("S", len1), ("M", len2)], seq=seq,
                                         tags={"NM": 0, "SA": sa1}))
        elif sv.svtype == "INV":
            # read: [x, d1) forward, then the inverted segment [d1, d2)
            # appears reverse-complemented in the read
            x = d1 - read_half + jitter
            len1 = d1 - x
            len2 = sv.svlen
            comp = str.maketrans("ACGTN", "TGCAN")
            seq = ref[x:d1] + ref[d1:d2].translate(comp)[::-1]
            qname = f"inv{sv.pos}_{k:03d}"
            # supplementary maps '-' over [d1, d2): its CIGAR is in ref
            # orientation with the clip for part 1 at the END
            sa2 = f"{contig},{d1 + 1},-,{len2}M{len1}S,60,0;"
            sa1 = f"{contig},{x + 1},+,{len1}M{len2}S,60,0;"
            records.append(BamRecordSpec(qname=qname, flag=0, refid=0, pos=x, mapq=60,
                                         cigar=[("M", len1), ("S", len2)], seq=seq,
                                         tags={"NM": 0, "SA": sa2}))
            rc_seq = seq.translate(comp)[::-1]
            records.append(BamRecordSpec(qname=qname, flag=16 | 2048, refid=0, pos=d1,
                                         mapq=60, cigar=[("M", len2), ("S", len1)],
                                         seq=rc_seq, tags={"NM": 0, "SA": sa1}))
    return records


def simulate(ref_len: int = 100_000, svs: list[PlantedSV] = (), depth: int = 20,
             read_len: int = 12_000, seed: int = 0, contig: str = "chr1",
             contig_len: int | None = None, phased: bool = False):
    """Returns (reference_seq, records). Reads tile the reference every
    read_len/depth bp; each read spanning a planted INS/DEL carries it in
    its CIGAR (and sequence, for INS) with probability sv.vaf. DUP/INV
    sites additionally emit SA-tagged split-read pairs."""
    rng = np.random.default_rng(seed)
    ref = random_seq(rng, ref_len)
    split_svs = [sv for sv in svs if sv.svtype in ("DUP", "INV")]
    svs = sorted((s for s in svs if s.svtype in ("INS", "DEL")), key=lambda s: s.pos)
    for sv in svs:
        if sv.svtype == "INS" and not sv.seq:
            sv.seq = random_seq(rng, sv.svlen)

    step = max(1, read_len // depth)
    records = []
    rid = 0
    for start in range(0, ref_len - read_len, step):
        end = start + read_len
        carries = [sv for sv in svs if start + 500 < sv.pos < end - 500]
        has = {id(sv): (rng.random() < sv.vaf) for sv in carries}

        cigar: list[tuple[str, int]] = []
        seq_parts: list[str] = []
        cursor = start
        nm = 0
        for sv in carries:
            if not has[id(sv)]:
                continue
            m = sv.pos - cursor
            if m <= 0:
                continue
            cigar.append(("M", m))
            seq_parts.append(ref[cursor:sv.pos])
            if sv.svtype == "INS":
                cigar.append(("I", sv.svlen))
                seq_parts.append(sv.seq)
                cursor = sv.pos
            else:  # DEL
                cigar.append(("D", sv.svlen))
                cursor = sv.pos + sv.svlen
            nm += sv.svlen
        if cursor < end:
            cigar.append(("M", end - cursor))
            seq_parts.append(ref[cursor:end])

        # merge adjacent M ops
        merged: list[tuple[str, int]] = []
        for op, ln in cigar:
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + ln)
            else:
                merged.append((op, ln))

        flag = 16 if (rid % 2) else 0
        tags = {"NM": nm}
        if phased:
            # reads carrying any SV are haplotype 1, the rest haplotype 2
            carried_any = any(has[id(sv)] for sv in carries)
            tags["HP"] = 1 if (carried_any or not carries) else 2
            tags["PS"] = 1000
        records.append(BamRecordSpec(
            qname=f"read{rid:06d}",
            flag=flag,
            refid=0,
            pos=start,
            mapq=60,
            cigar=merged,
            seq="".join(seq_parts),
            tags=tags,
        ))
        rid += 1

    for sv in split_svs:
        records.extend(split_read_records(sv, ref, contig, rng))
    records.sort(key=lambda r: r.pos)

    return ref, records


def write_dataset(tmpdir: str, ref_len: int = 100_000, svs: list[PlantedSV] = (),
                  depth: int = 20, read_len: int = 12_000, seed: int = 0,
                  contig: str = "chr1", contig_len: int | None = None,
                  phased: bool = False, n_contigs: int = 1):
    """Write reference FASTA + sorted/indexed BAM; returns (bam_path, fasta_path).

    contig_len pads the declared contig length (>= 1 Mbp so the default
    contig filter keeps it, reference: util.py:161). With n_contigs > 1
    the same SV layout is replicated on chr1..chrN (for multi-task /
    scaling tests; tasks are per-contig by default, sniffles:299-302)."""
    declared = contig_len or max(1_000_000, ref_len)
    contigs = [contig] if n_contigs == 1 else [f"chr{i + 1}" for i in range(n_contigs)]

    all_records = []
    refs = {}
    for ci, cname in enumerate(contigs):
        ref, records = simulate(ref_len=ref_len, svs=[PlantedSV(**vars(sv)) for sv in svs],
                                depth=depth, read_len=read_len, seed=seed + ci,
                                contig=cname, phased=phased)
        refs[cname] = ref
        for r in records:
            r.refid = ci
            if n_contigs > 1:
                r.qname = f"{cname}.{r.qname}"
        all_records.extend(records)

    fasta_path = os.path.join(tmpdir, "ref.fa")
    with open(fasta_path, "w") as f:
        for cname in contigs:
            f.write(f">{cname}\n")
            full = refs[cname] + "N" * (declared - len(refs[cname]))
            for i in range(0, len(full), 60):
                f.write(full[i:i + 60] + "\n")

    bam_path = os.path.join(tmpdir, "sim.bam")
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c}\tLN:{declared}\n" for c in contigs)
    write_bam(bam_path, [(c, declared) for c in contigs], all_records, sam_header=header)
    return bam_path, fasta_path


def dense_layout(ref_len: int) -> list[PlantedSV]:
    """High-SV-density layout (sites every 1.5-3 kb, the spacing of
    TR-rich regions and population call sets), where per-task compute —
    clustering, calling statistics, INS consensus, split-chain
    classification — outweighs decode. A copy of bench.py::_dense_layout
    (the JAX package's compute-dense bench leg, bench.py:288-313)."""
    rng = np.random.default_rng(13)
    svs = []
    pos = 12_000
    i = 0
    while pos < ref_len - 15_000:
        kind = ("INS", "DEL", "INS", "DUP", "INS", "DEL", "INV", "DEL")[i % 8]
        svlen = int(rng.choice((60, 90, 150, 300, 700)))
        vaf = float(rng.choice((1.0, 1.0, 0.6, 0.45)))
        if kind in ("DUP", "INV"):
            svlen, vaf = max(svlen, 600), 1.0
        svs.append(PlantedSV(pos=pos, svtype=kind, svlen=svlen, vaf=vaf))
        pos += int(rng.integers(1_500, 3_000))
        i += 1
    return svs


def fuzz_call_batch(seed: int, size: int, fill: float = 0.8,
                    svtypes=(0, 1, 2, 3, 4)) -> np.ndarray:
    """A packed (15, size) int32 call-task batch (the layout of
    parallel/device_call.pack_task_batch) whose seeds merge: runs of 3-30
    leads spread over 30-900 bp (several 100 bp bins whose start-position
    stdev reaches across their gaps), 40 % of runs in a tandem repeat,
    gaps between runs below and above the merge reaches (m2's 1,000 bp
    cap, BND's 1,500 bp), a run's svtype repeated with probability 1/2 so
    that same-type runs chain, fragmented reads (one read id on several
    leads) and phase tags with out-of-domain values. Positions start at
    10 kb; `fill` of the width is valid, the rest padding."""
    rng = np.random.default_rng(seed)
    target = int(size * fill)
    pos, kind, rep = [], [], []
    p = 10_000
    t = int(rng.choice(svtypes))
    while len(pos) < target:
        if rng.random() < 0.5:
            t = int(rng.choice(svtypes))
        run_len = int(rng.integers(3, 30))
        spread = int(rng.integers(30, 900))
        in_repeat = rng.random() < 0.4
        for _ in range(run_len):
            pos.append(p + int(rng.integers(0, spread)))
            kind.append(t)
            rep.append(in_repeat)
        p += spread + int(rng.choice((150, 400, 900, 1050, 1200, 1600, 2600, 4000)))
    n = target
    kind_a = np.array(kind[:n])
    svlen = rng.choice((60, 80, 100, 150, 300, 700), size=n) + rng.integers(-10, 11, size=n)
    packed = np.zeros((15, size), dtype=np.int32)
    packed[0, :n] = pos[:n]
    packed[1, :n] = np.where(kind_a == 1, -svlen, np.where(kind_a == 4, 0, svlen))
    packed[2, :n] = kind_a
    packed[3, :n] = rng.permutation(n)
    packed[4, :n] = rep[:n]
    packed[5, :n] = 1
    packed[6, :n] = rng.choice((1, -1), size=n)
    packed[7, :n] = rng.integers(0, 61, size=n)
    packed[8, :n] = rng.integers(0, max(1, n // 2), size=n)
    packed[9, :n] = rng.integers(0, 2, size=n)
    packed[10, :n] = packed[0, :n] + rng.integers(0, 50, size=n)
    packed[11, :n] = rng.integers(0, 5000, size=n)
    packed[12, :n] = packed[11, :n] + rng.integers(0, 300, size=n)
    packed[13, :n] = rng.choice((0, 1, 2, -9), size=n, p=(0.3, 0.3, 0.3, 0.1))
    packed[14, :n] = rng.choice((-1, 1000, 2000), size=n)
    return packed


def edge_call_batches() -> dict[str, np.ndarray]:
    """Packed (15, 512) call-task batches at the edges: no lead at all, one
    seed of 5 leads, and that seed with all 5 leads from one read
    fragmented over it (the inner fold merges them)."""
    empty = np.zeros((15, 512), dtype=np.int32)
    one = np.zeros((15, 512), dtype=np.int32)
    one[0, :5] = 50_000 + np.arange(5) * 7
    one[1, :5] = 300
    one[3, :5] = np.arange(5)
    one[5, :5] = 1
    one[6, :5] = 1
    frag = one.copy()
    frag[8, :5] = 77
    frag[10, :5] = frag[0, :5] + 5
    frag[11, :5] = np.arange(5) * 20
    frag[12, :5] = frag[11, :5] + 10
    return {"nseeds-0": empty, "one-seed": one, "fragmented-read": frag}


def _layout_batch(leads, size: int = 2048) -> np.ndarray:
    """A packed (15, size) call-task batch of (pos, svtype, repeat) leads:
    svlen 300 (-300 for DEL, 0 for BND), one read each, forward strand."""
    n = len(leads)
    packed = np.zeros((15, size), dtype=np.int32)
    pos, kind, rep = (np.array(col, dtype=np.int32) for col in zip(*leads))
    packed[0, :n] = pos
    packed[1, :n] = np.where(kind == 1, -300, np.where(kind == 4, 0, 300))
    packed[2, :n] = kind
    packed[3, :n] = np.arange(n)
    packed[4, :n] = rep
    packed[5, :n] = 1
    packed[6, :n] = 1
    packed[8, :n] = np.arange(n)
    packed[10, :n] = pos
    return packed


def sweep_layout_batches() -> dict[str, np.ndarray]:
    """Packed call-task batches laid out for the merge sweep's partition:
      - "head-alone": a DEL whose first seed stands alone in the first
        segment, then a segment of repeat-flagged seeds 300 bp apart that
        merge (the svtype's pointer reaches that segment's head at i = 1,
        the segment's own walk starts it at 2);
      - "bnd-chains": BND seeds 600-900 bp apart (merging by m3) in chains
        1,100-6,000 bp apart;
      - "cascade": 30 INS segments of spans 500, 600, 700, ... bp (seeds
        every 500 bp, all in a tandem repeat), the first gap 1,200 bp and
        each later one the largest bin gap under 2.5 x the span to its
        right: each pass of the cut fixpoint removes one cut, and each
        removal lets the next cut go, so the partition still changes
        after 24 passes and collapses."""
    head = [(10_050, 1, 0)]
    p = 11_450
    for k in range(6):
        head += [(p + 10 * j, 1, 1) for j in range(4)]
        p += 300 if k != 3 else 700
    rng = np.random.default_rng(5)
    bnd, p = [], 20_000
    for _ in range(40):
        for _ in range(int(rng.integers(2, 5))):
            bnd += [(p + int(x), 4, 0) for x in rng.integers(0, 100, size=3)]
            p += int(rng.choice((600, 700, 800, 900)))
        p += int(rng.choice((1_100, 1_500, 2_500, 6_000)))
    cascade, p = [], 50_000
    for k in range(30):
        span = 500 + 100 * k
        if k:
            p += 1_200 if k == 1 else (5 * span // 2 - 1) // 100 * 100
        for x in range(0, span - 99, 500):
            cascade += [(p + x + 17, 0, 1), (p + x + 60, 0, 1)]
        last = p + (span - 100) // 100 * 100
        cascade += [(last + 50, 0, 1)]
        p = last + 100
    return {"head-alone": _layout_batch(head), "bnd-chains": _layout_batch(bnd),
            "cascade": _layout_batch(cascade)}
