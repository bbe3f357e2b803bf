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
             contig_len: int | None = None, phased: bool = False, nm_rate: float = 0.0):
    """Returns (reference_seq, records). Reads tile the reference every
    read_len/depth bp; each read spanning a planted INS/DEL carries it in
    its CIGAR (and sequence, for INS) with probability sv.vaf. DUP/INV
    sites additionally emit SA-tagged split-read pairs. nm_rate adds
    round(nm_rate * read_len) mismatches to each tiled read's NM tag (its
    regional NM statistic; the sequence stays the reference's)."""
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
        tags = {"NM": nm + round(nm_rate * read_len)}
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
                  phased: bool = False, n_contigs: int = 1, nm_rates: tuple = ()):
    """Write reference FASTA + sorted/indexed BAM; returns (bam_path, fasta_path).

    contig_len pads the declared contig length (>= 1 Mbp so the default
    contig filter keeps it, reference: util.py:161). With n_contigs > 1
    the same SV layout is replicated on chr1..chrN (for multi-task /
    scaling tests; tasks are per-contig by default, sniffles:299-302).
    nm_rates gives each contig's nm_rate (simulate), 0 where absent."""
    declared = contig_len or max(1_000_000, ref_len)
    contigs = [contig] if n_contigs == 1 else [f"chr{i + 1}" for i in range(n_contigs)]

    all_records = []
    refs = {}
    for ci, cname in enumerate(contigs):
        ref, records = simulate(ref_len=ref_len, svs=[PlantedSV(**vars(sv)) for sv in svs],
                                depth=depth, read_len=read_len, seed=seed + ci,
                                contig=cname, phased=phased,
                                nm_rate=nm_rates[ci] if ci < len(nm_rates) else 0.0)
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


def write_cram(bam_path: str, fasta_path: str, cram_path: str = None) -> str:
    """The reads of an indexed BAM from write_dataset as a reference-based
    CRAM 3.0 beside it (sim.cram and its .crai, io/cramwrite.py); returns
    the CRAM's path."""
    from sniffles_tpu_torch.io.cramwrite import bam_to_cram
    cram_path = cram_path or os.path.splitext(bam_path)[0] + ".cram"
    bam_to_cram(bam_path, cram_path, reference_filename=fasta_path)
    return cram_path


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


def greedy_fuzz_payload(rng, S, L, n_sites=3, lens=(16, 60, 200), n_alts=6, table=0.8,
                        heads=8, span=3000, full=False) -> dict:
    """A payload of run_combine_greedy_task: S segment rows of up to L
    candidates (counts drawn from 1..L, or L each when `full`) with
    clustered positions and lengths (so exact and near ties are common),
    head ordinals assigned as the packer assigns them (at most `heads` a
    row), and a random sparse ED table (each head row x candidate with
    probability `table`)."""
    counts = (np.full(S, L, np.int32) if full
              else rng.integers(1, L + 1, size=S).astype(np.int32))
    c_pos = np.zeros((S, L), np.int32)
    c_len = np.zeros((S, L), np.int32)
    c_alt = np.zeros((S, L), np.int32)
    c_hord = np.full((S, L), -1, np.int32)
    segs, rows, cols, vals = [], [], [], []
    for s in range(S):
        sites = rng.integers(0, span, size=n_sites)
        site_len = rng.choice(lens, size=n_sites)
        ords = {}
        for j in range(int(counts[s])):
            k = int(rng.integers(0, n_sites))
            c_pos[s, j] = sites[k] + int(rng.integers(-30, 31))
            c_len[s, j] = max(1, int(site_len[k]) + int(rng.integers(-4, 5)))
            alt = int(rng.integers(0, n_alts))
            c_alt[s, j] = alt
            if alt not in ords and len(ords) < heads:
                ords[alt] = len(ords)
            c_hord[s, j] = ords.get(alt, -1)
        for h in range(len(ords)):
            for j in range(int(counts[s])):
                if rng.random() < table:
                    segs.append(s)
                    rows.append(h)
                    cols.append(j)
                    vals.append(int(rng.integers(0, 2 * int(c_len[s, j]) + 1)))
    as32 = lambda v: np.array(v, dtype=np.int32)  # noqa: E731
    return {"c_pos": c_pos, "c_len": c_len, "c_alt": c_alt, "c_hord": c_hord,
            "counts": counts, "ed_segs": as32(segs), "ed_rows": as32(rows),
            "ed_cols": as32(cols), "ed_vals": as32(vals)}


# the metas of the grid payloads' fuzz seeds: both branches of limit
GREEDY_FUZZ_METAS = ({"cm": 250, "cmm": 1000, "limit": 0.7},
                     {"cm": 10, "cmm": 120, "limit": 0.5},
                     {"cm": 250, "cmm": 1000, "limit": 0.0})


def _no_ed_table(payload: dict) -> dict:
    z = np.zeros(0, np.int32)
    return dict(payload, ed_segs=z, ed_rows=z, ed_cols=z, ed_vals=z)


def _sparse_ed(rng, hords: np.ndarray, c_len: np.ndarray, counts, table: float,
               top: float) -> dict:
    """The sparse ED entries of a grid payload: each head row used by a
    segment row (its c_hord ordinals) x candidate with probability `table`,
    the distance drawn from 0 to top times the candidate's |length|."""
    segs, rows, cols, vals = [], [], [], []
    for s in range(len(counts)):
        n = int(counts[s])
        for h in range(int(hords[s, :n].max(initial=-1)) + 1):
            for j in range(n):
                if rng.random() < table:
                    segs.append(s)
                    rows.append(h)
                    cols.append(j)
                    vals.append(int(rng.integers(0, int(top * abs(int(c_len[s, j]))) + 2)))
    as32 = lambda v: np.array(v, dtype=np.int32)  # noqa: E731
    return {"ed_segs": as32(segs), "ed_rows": as32(rows), "ed_cols": as32(cols),
            "ed_vals": as32(vals)}


def _head_ordinals(c_alt: np.ndarray, counts, heads: int = 8) -> np.ndarray:
    """c_hord as the packer assigns it: each row's first `heads` distinct
    alts in order, -1 for the others and past a row's count."""
    c_hord = np.full(c_alt.shape, -1, np.int32)
    for s in range(len(counts)):
        ords = {}
        for j in range(int(counts[s])):
            a = int(c_alt[s, j])
            if a not in ords and len(ords) < heads:
                ords[a] = len(ords)
            c_hord[s, j] = ords.get(a, -1)
    return c_hord


def greedy_group_counts_payload(rng, groups=(40, 70, 140), joins: int = 2) -> dict:
    """A grid payload whose row r founds groups[r] groups or more (one
    candidate a site first, sites 1,000 bp apart, lengths 80-120: at cm 10
    no candidate reaches another site's group), then joins them `joins`
    times each in a random order, alts from 4 (ED entries of 0 to 1.2
    times the length, so that some joins fail the identity gate at limit
    0.5 and found groups of their own): the live groups of its rows cross a
    warp's 32 slots, 64 and 128, the step's probe trips."""
    S = len(groups)
    L = max(g * (1 + joins) for g in groups)
    counts = np.array([g * (1 + joins) for g in groups], np.int32)
    c_pos = np.zeros((S, L), np.int32)
    c_len = np.zeros((S, L), np.int32)
    c_alt = np.zeros((S, L), np.int32)
    for s, g in enumerate(groups):
        site_len = rng.integers(80, 121, size=g)
        ks = np.r_[rng.permutation(g), rng.integers(0, g, size=g * joins)]
        c_pos[s, :len(ks)] = 500 + 1000 * ks + rng.integers(-20, 21, size=len(ks))
        c_len[s, :len(ks)] = site_len[ks] + rng.integers(-3, 4, size=len(ks))
        c_alt[s, :len(ks)] = rng.integers(0, 4, size=len(ks))
    c_hord = _head_ordinals(c_alt, counts)
    return {"c_pos": c_pos, "c_len": c_len, "c_alt": c_alt, "c_hord": c_hord,
            "counts": counts, **_sparse_ed(rng, c_hord, c_len, counts, 0.8, 1.2)}


def greedy_long_group_payload(rng) -> dict:
    """One row of NMAX + 40 candidates that join one group (alt 0, within
    15 bp and 5 bp of length 300) until its size passes NMAX, every 100th
    at a second site with alt 1: the group's cached mean, root and divisor
    change on every step, up to n = 1,054."""
    from sniffles_tpu_torch.ops._greedy_consts import NMAX
    L = NMAX + 40
    second = np.arange(L) % 100 == 99
    c_pos = np.where(second, 50_000, 1000) + rng.integers(-15, 16, size=L)
    c_len = 300 + rng.integers(-5, 6, size=L)
    c_alt = second.astype(np.int32)[None, :]
    counts = np.array([L], np.int32)
    c_hord = _head_ordinals(c_alt, counts)
    c_len = c_len.astype(np.int32)[None, :]
    return {"c_pos": c_pos.astype(np.int32)[None, :], "c_len": c_len, "c_alt": c_alt,
            "c_hord": c_hord, "counts": counts,
            **_sparse_ed(rng, c_hord, c_len, counts, 0.5, 0.3)}


def greedy_tiny_payload(rng) -> dict:
    """Rows whose candidates have lengths of 0, 1, 2 and below 0, so that a
    group's length mean is 0, negative or under 1: the identity ratio's
    denominator max(mean, tiny) at tiny, and a cached root of 0."""
    S, L = 3, 24
    c_pos = (rng.integers(0, 3, size=(S, 1)) * 5000 + rng.integers(-10, 11, size=(S, L)))
    c_len = rng.choice((0, 0, 1, 2, -5, 40), size=(S, L))
    c_alt = rng.integers(0, 3, size=(S, L)).astype(np.int32)
    counts = np.array([L, L - 5, 7], np.int32)
    c_hord = _head_ordinals(c_alt, counts)
    c_len = c_len.astype(np.int32)
    return {"c_pos": c_pos.astype(np.int32), "c_len": c_len, "c_alt": c_alt, "c_hord": c_hord,
            "counts": counts, **_sparse_ed(rng, c_hord, c_len, counts, 0.9, 1.0)}


def greedy_task_payloads() -> list[tuple[str, dict, dict]]:
    """(label, payload, meta) of the whole-task grid greedy
    (run_combine_greedy_task), which the CPU tests hold against the JAX
    package and the card holds its kernel against the plain version on:
      - "fuzz seed k": greedy_fuzz_payload on seeds 100..105 (S 1-19, L
        2-39), each under GREEDY_FUZZ_METAS;
      - "exact ties": two groups at the same rational distance from a
        probe, the earliest wins;
      - "near threshold": probes exactly on the float32 sqrt radius and on
        the identity ratio (the ambiguity flag);
      - "ed miss" (a sparse table) and "width-1 table" (no table at all:
        the ED grid is one column wide) at limit 0.7, and the width-1
        table at limit 0;
      - "group overflow": one group past NMAX members;
      - "one long segment": one row of SEG_LMAX = 2,048 candidates at 64
        sites (well over a warp's 32 groups), at limits 0.7 and 0;
      - "many segments": 16,384 rows of one candidate, at limits 0.7 and 0;
      - "group counts": rows whose live groups cross 32, 64 and 128
        (greedy_group_counts_payload), at cm 10 with limits 0.5 and 0;
      - "long group": one group joined until its size passes NMAX
        (greedy_long_group_payload), at limit 0.7 (the identity gate on;
        "group overflow" has limit 0);
      - "tiny ratios": group length means of 0, below 0 and under 1
        (greedy_tiny_payload), at limits 0.7 and 0.
    """
    from sniffles_tpu_torch.ops._greedy_consts import NMAX, SEG_LMAX
    out = []
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        payload = greedy_fuzz_payload(rng, S=int(rng.integers(1, 20)),
                                      L=int(rng.integers(2, 40)))
        out += [(f"fuzz seed {seed}", payload, dict(meta)) for meta in GREEDY_FUZZ_METAS]
    # alt 0 and alt 1 fail the identity gate against each other (ED 90 of
    # length 100) and so found two groups; alt 2 passes against both
    # heads, and the third candidate sits midway: distance 50 to each.
    # The fifth is nearer the second group's mean and joins it.
    i32 = lambda v: np.array(v, dtype=np.int32)  # noqa: E731
    out.append(("exact ties", {
        "c_pos": i32([[100, 200, 150, 150, 175]]), "c_len": i32([[100] * 5]),
        "c_alt": i32([[0, 1, 2, 2, 2]]), "c_hord": i32([[0, 1, -1, -1, -1]]),
        "counts": i32([5]), "ed_segs": i32([0] * 8), "ed_rows": i32([0, 0, 0, 0, 1, 1, 1, 1]),
        "ed_cols": i32([1, 2, 3, 4, 0, 2, 3, 4]), "ed_vals": i32([90, 5, 5, 5, 90, 5, 5, 5])},
        {"cm": 250, "cmm": 1000, "limit": 0.7}))
    # cm 10 at length 16 gives a radius of 40.0; (100 - 30) / 100 = 0.7
    out.append(("near threshold", {
        "c_pos": i32([[1000, 1040], [5000, 5010]]), "c_len": i32([[16, 16], [100, 100]]),
        "c_alt": i32([[0, 0], [0, 1]]), "c_hord": i32([[0, 0], [0, -1]]),
        "counts": i32([2, 2]), "ed_segs": i32([1]), "ed_rows": i32([0]),
        "ed_cols": i32([1]), "ed_vals": i32([30])},
        {"cm": 10, "cmm": 1000, "limit": 0.7}))
    sparse = greedy_fuzz_payload(np.random.default_rng(7), S=5, L=12, table=0.3)
    out.append(("ed miss", sparse, {"cm": 250, "cmm": 1000, "limit": 0.7}))
    out.append(("width-1 table", _no_ed_table(sparse), {"cm": 250, "cmm": 1000, "limit": 0.7}))
    out.append(("width-1 table", _no_ed_table(sparse), {"cm": 250, "cmm": 1000, "limit": 0.0}))
    n = NMAX + 3
    out.append(("group overflow", _no_ed_table({
        "c_pos": (np.arange(n, dtype=np.int32) % 3)[None, :],
        "c_len": np.full((1, n), 250, np.int32), "c_alt": np.zeros((1, n), np.int32),
        "c_hord": np.full((1, n), -1, np.int32), "counts": i32([n])}),
        {"cm": 250, "cmm": 1000, "limit": 0.0}))
    long = greedy_fuzz_payload(np.random.default_rng(11), S=1, L=SEG_LMAX, n_sites=64,
                               lens=(60, 200, 800), table=0.9, span=200_000, full=True)
    for limit in (0.7, 0.0):
        out.append(("one long segment", long, {"cm": 250, "cmm": 1000, "limit": limit}))
    rng = np.random.default_rng(12)
    S = 16_384
    many = {"c_pos": rng.integers(0, 1000, size=(S, 1)).astype(np.int32),
            "c_len": rng.integers(20, 900, size=(S, 1)).astype(np.int32),
            "c_alt": np.zeros((S, 1), np.int32), "c_hord": np.zeros((S, 1), np.int32),
            "counts": np.ones(S, np.int32)}
    for limit in (0.7, 0.0):
        out.append(("many segments", _no_ed_table(many), {"cm": 250, "cmm": 1000,
                                                          "limit": limit}))
    counts = greedy_group_counts_payload(np.random.default_rng(13))
    for limit in (0.5, 0.0):
        out.append(("group counts", counts, {"cm": 10, "cmm": 120, "limit": limit}))
    long_group = greedy_long_group_payload(np.random.default_rng(14))
    tiny = greedy_tiny_payload(np.random.default_rng(15))
    out.append(("long group", long_group, {"cm": 250, "cmm": 1000, "limit": 0.7}))
    for limit in (0.7, 0.0):
        out.append(("tiny ratios", tiny, {"cm": 250, "cmm": 1000, "limit": limit}))
    return out


def _flush_payload(cands, keeps) -> dict:
    """The payload of run_combine_greedy for one flush, packed as the JAX
    package's tests/test_combine_greedy_kernel.py::run_device packs it:
    local coordinates, integer group sums, an alt-id table and the exact
    edit distance of every (head alt id, candidate) pair of distinct
    alts. cands: [(pos, len, alt)] in processing order; keeps:
    [(pos_mean, len_mean, n, head_alt)]."""
    from sniffles_tpu_torch.ops.edit_distance import edit_distance
    base = int(min([p for p, _, _ in cands] + [kp for kp, _, _, _ in keeps]))
    alt_ids: dict = {}
    g_head = [alt_ids.setdefault(h, len(alt_ids)) for _, _, _, h in keeps]
    c_alt = [alt_ids.setdefault(a, len(alt_ids)) for _, _, a in cands]
    strings = {v: k for k, v in alt_ids.items()}
    rows, cols, vals = [], [], []
    for j, a_j in enumerate(c_alt):
        for h_id in set(alt_ids.values()):
            if h_id != a_j:
                rows.append(h_id)
                cols.append(j)
                vals.append(edit_distance(strings[h_id], strings[a_j]))
    i32 = lambda v: np.array(v, dtype=np.int32)  # noqa: E731
    return {"c_pos": i32([p - base for p, _, _ in cands]),
            "c_len": i32([ln for _, ln, _ in cands]), "c_alt": i32(c_alt),
            "g_psum": i32([round((p - base) * n) for p, _, n, _ in keeps]),
            "g_lsum": i32([round(ln * n) for _, ln, n, _ in keeps]),
            "g_n": i32([n for _, _, n, _ in keeps]), "g_head": i32(g_head),
            "n_alts": len(alt_ids), "ed_rows": i32(rows), "ed_cols": i32(cols),
            "ed_vals": i32(vals)}


def greedy_flush_payloads() -> list[tuple[dict, dict]]:
    """The (payload, meta) pairs of the JAX package's
    tests/test_combine_greedy_kernel.py, in its order: a basic trajectory,
    initial groups at a tie, the identity gate at limits 0, 0.7 and
    0.95, 40 fuzz seeds (clustered positions and lengths, initial groups
    with non-integral means), a group-size overflow and an empty ED table
    (ed_miss). The inputs of the combine_greedy request kind."""
    meta = {"cm": 250, "cmm": 1000, "limit": 0.0}
    out = []
    cands = [(1000, 100, "<DEL>"), (1010, 102, "<DEL>"), (5000, 100, "<DEL>"),
             (1004, 101, "<DEL>"), (5020, 400, "<DEL>"), (990, 99, "<DEL>")]
    out.append((_flush_payload(cands, []), meta))
    out.append((_flush_payload([(1010, 100, "<INS>")],
                               [(1000, 100, 1, "<INS>"), (1020, 100, 1, "<INS>")]), meta))
    rng = np.random.default_rng(7)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), size=n))
    s1 = seq(120)
    s2 = s1[:40] + seq(40) + s1[80:]
    s3 = s1[:115] + seq(5)
    cands = [(1000, 120, s1), (1004, 120, s2), (1008, 120, s3), (1002, 118, s2),
             (1001, 119, s1)]
    out += [(_flush_payload(cands, []), dict(meta, limit=limit)) for limit in (0.0, 0.7, 0.95)]
    for seed in range(40):
        rng = np.random.default_rng(2000 + seed)
        n_sites = int(rng.integers(2, 7))
        sites = [(int(rng.integers(0, 60_000)), int(rng.integers(50, 900)))
                 for _ in range(n_sites)]
        cands = []
        for _ in range(int(rng.integers(8, 60))):
            sp, sl = sites[int(rng.integers(0, n_sites))]
            cands.append((sp + int(rng.integers(-40, 41)),
                          max(20, sl + int(rng.integers(-10, 11))), "<DEL>"))
        keeps = []
        for _ in range(int(rng.integers(0, 4))):
            sp, sl = sites[int(rng.integers(0, n_sites))]
            n = int(rng.integers(1, 5))
            psum = sum(sp + int(rng.integers(-30, 31)) for _ in range(n))
            lsum = sum(max(20, sl + int(rng.integers(-8, 9))) for _ in range(n))
            keeps.append((psum / n, lsum / n, n, "<DEL>"))
        order = list(rng.permutation(len(cands)))
        out.append((_flush_payload([cands[i] for i in order], keeps), meta))
    out.append((_flush_payload([(1000, 100, "<INS>")] * 8,
                               [(1000.0, 100.0, 1020, "<INS>")]), meta))
    z = np.zeros(0, dtype=np.int32)
    out.append(({"c_pos": np.array([0, 4], np.int32), "c_len": np.array([100, 100], np.int32),
                 "c_alt": np.array([0, 1], np.int32), "g_psum": z, "g_lsum": z, "g_n": z,
                 "g_head": z, "n_alts": 2, "ed_rows": z, "ed_cols": z, "ed_vals": z},
                dict(meta, limit=0.7)))
    return out


def greedy_flush_wide_payloads() -> list[tuple[dict, dict]]:
    """(payload, meta) of run_combine_greedy whose one row does not fit a
    block's shared memory, so that the flush kernel keeps its state in
    global scratch: 2,100 initial groups 100 bp apart (G = 64 + 4,096
    slots, 133,120 bytes of slot records) and 60 candidates, at limits 0
    and 0.7.
    The groups' heads are three 40 bp alleles; a candidate carries one of
    them, a copy with one base changed, or a fourth allele, which fails
    the identity gate against every head (at 0.7 it founds a group). Every
    fourth candidate lies past the groups, at one of four sites, and
    founds a group there or joins one founded before it."""
    rng = np.random.default_rng(3000)
    alleles = [random_seq(rng, 40) for _ in range(4)]
    alts = alleles + [a[:20] + ("A" if a[20] != "A" else "C") + a[21:] for a in alleles[:3]]
    keeps = [(100.0 * k + 0.5 * (k % 3), float(rng.integers(36, 45)), int(rng.integers(1, 4)),
              alleles[int(rng.integers(0, 3))]) for k in range(2100)]
    cands = []
    for j in range(60):
        if j % 4 == 3:
            kp, kl = 215_000.0 + 3_000 * int(rng.integers(0, 4)), 40.0
        else:
            kp, kl, _, _ = keeps[int(rng.integers(0, len(keeps)))]
        cands.append((int(kp) + int(rng.integers(-20, 21)), int(kl) + int(rng.integers(-3, 4)),
                      alts[int(rng.integers(0, len(alts)))]))
    payload = _flush_payload(cands, keeps)
    return [(payload, {"cm": 250, "cmm": 1000, "limit": limit}) for limit in (0.0, 0.7)]


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


def relax_chain_positions(links: int = 36) -> list[int]:
    """Signature positions of one INS chain on which the fused engine's
    relaxation (ops/merge_relax.py) joins one link a round: runs of
    occupied 100 bp bins, one lead a bin (they coalesce in the first
    round), each gap wider than 2.5 times the start stdev of the run before
    it but not of everything before it, and each run wide enough not to be
    the pair's smaller stdev. Run k merges only once runs 0..k-1 have, so
    `links` links take links rounds: more than 32 and the cap binds."""
    def sd(a):
        a = np.asarray(a, dtype=np.float64)
        stride = max(len(a) // min(len(a), 100), 1)
        return a[::stride].std(ddof=1)
    pos, start, width = [], 100_000, 400
    for k in range(links):
        run = list(range(start, start + width + 1, 100))
        pos.extend(run)
        gap = (int(2.5 * sd(run) // 100) + (1 if k else 0)) * 100
        width = int(np.ceil(gap / 2.5 * np.sqrt(12) * 1.05 / 100)) * 100
        start = run[-1] + 100 + gap
    return pos


def relax_chain_batch(size: int, links: int = 36, spacing: int = 1_100_000) -> dict:
    """A signature batch (SignatureBatch.as_dict) of `size` slots holding
    as many whole copies of the relax_chain_positions(links) chain as fit,
    copy c shifted by c * spacing bp: INS of 100 bp, each lead a read of
    its own, the rest padding. The gap between two copies is wider than
    2.5 times the start stdev of a whole chain, so copies never merge:
    every copy takes `links` relaxation rounds (the 32-round cap binds
    above 32)."""
    from sniffles_tpu_torch.signatures import synthetic_batch
    chain = np.asarray(relax_chain_positions(links), dtype=np.int64)
    gap = spacing - (chain[-1] - chain[0])
    if gap <= 2.5 * chain.std(ddof=1):
        raise ValueError(f"a gap of {gap} bp lets copies of the {links}-link chain merge")
    copies = size // len(chain)
    pos = (chain[None, :] + spacing * np.arange(copies)[:, None]).reshape(-1)
    if copies and pos[-1] >= 2 ** 31:
        raise ValueError(f"{copies} chains {spacing} bp apart overflow int32 positions")
    sig = synthetic_batch(0, 1, seed=1, batch_size=size).as_dict()
    n = pos.size
    sig["pos"][:n], sig["svlen"][:n], sig["valid"][:n] = pos, 100, True
    sig["read_id"][:n] = np.arange(n)
    return sig


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def tail_run_layouts(n: int, seed: int = 7) -> dict[str, np.ndarray]:
    """{label: ascending cluster ids, int32} at the edges of the candidate tail's
    run pass (csrc/candidate_tail.cu tail_runs), n > 600 ids for the wide
    ones: one id (inside, past n, negative), a lane's ids and one, a chunk's
    less one, n just off a chunk, one cluster of n, a cluster an element
    (n + 1 starts), gaps, leading negative ids, all negative, ids at and
    past n up to INT32_MAX, every id past n, and one gap of n - 5 ids."""
    from sniffles_tpu_torch.ops.candidate_tail import RUN_CHUNK_IDS, RUN_LANE_IDS
    rng = np.random.default_rng(seed)
    off = n // RUN_CHUNK_IDS * RUN_CHUNK_IDS + 1
    cat = np.concatenate
    full = np.full
    layouts = {
        "n = 1": [0],
        "n = 1 past n": [3],
        "n = 1 negative": [-1],
        "a lane's ids and one": np.sort(rng.integers(0, 5, RUN_LANE_IDS + 1)),
        "a chunk's ids less one": np.sort(rng.integers(0, 40, RUN_CHUNK_IDS - 1)),
        "off the chunk": np.sort(rng.integers(0, off // 30, off)),
        "one cluster of n": np.zeros(n),
        "a cluster an element": np.arange(n),
        "gaps": np.cumsum(rng.integers(0, 2, n) * rng.choice([1, 1, 1, 5, 40], n)),
        "leading negative ids": cat([full(37, -7), full(3, -1),
                                     np.sort(rng.integers(0, n // 8, n - 40))]),
        "all negative": full(300, -2),
        "ids at and past n": cat([np.sort(rng.integers(0, n // 4, n - 60)), full(20, n),
                                  full(20, n + 3), full(20, _I32_MAX)]),
        "first id past n": full(n, n + 1),
        "one huge gap": cat([np.zeros(10), full(n - 10, n - 5)]),
    }
    return {k: np.asarray(v, dtype=np.int64).astype(np.int32) for k, v in layouts.items()}


def _stats_cluster(rng, size: int, center: int, spread: int, svlen: int, len_spread: int,
                   step: int = 1) -> dict:
    """One cluster's columns: positions and lengths about their centers,
    rounded to `step` (ties in the modes), reads from a pool smaller than
    the cluster (repeated reads), mapq, strand, one svtype, NM of a long
    read's rates."""
    def around(mid, half):
        if half == 0:
            return np.full(size, mid, dtype=np.int64)
        return mid + rng.integers(-half, half + 1, size) // step * step
    return {"pos": around(center, spread), "svlen": around(svlen, len_spread),
            "read_id": rng.integers(0, max(size * 2 // 3, 1), size),
            "mapq": rng.integers(0, 61, size), "strand": rng.integers(0, 2, size),
            "svtype": np.full(size, int(rng.integers(0, 7))),
            "nm": rng.random(size, dtype=np.float32) * np.float32(0.05)}


def _nm_binades(rng, size: int) -> np.ndarray:
    """NM rates across 40 binades (no subnormals): float32 sums that round."""
    return (rng.random(size, dtype=np.float32) + np.float32(0.5)) * (
        np.float32(2.0) ** rng.integers(-36, 4, size)).astype(np.float32)


EXACT_LIMIT = 1 << 24     # integer terms add exactly in float32 while their sums stay within it


def _window_values(rng, cnt: int, terms, base: int) -> np.ndarray:
    """cnt values whose sorted trimmed window (ranks [trim, cnt - trim),
    trim = cnt * 25 // 100) is base + terms (terms[0] == 0, the rest at
    least 0): the trimmed quarters strictly below and above it."""
    trim = cnt * 25 // 100
    terms = np.sort(np.asarray(terms, dtype=np.int64))
    if terms.size != cnt - 2 * trim or terms[0] != 0:
        raise ValueError(f"a window of {cnt} holds {cnt - 2 * trim} terms from 0")
    below = base - rng.integers(1, 1000, trim)
    above = base + terms[-1] + rng.integers(1, 1000, trim)
    return np.concatenate([below, base + terms, above])


def _abs_edge(k: int, past: bool) -> np.ndarray:
    """k window terms from 0 whose sum is 2^24 (one past it with `past`)."""
    q, r = divmod(EXACT_LIMIT, k - 1)
    terms = np.r_[0, np.full(k - 1, q)]
    terms[-1] += r + int(past)
    return terms


def _square_edge(k: int, past: bool) -> np.ndarray:
    """k window terms from 0 whose squares sum to 2^24 (one past it with
    `past`): m terms of 2^a with m 4^a = 2^24, the rest 0 (one of them 1)."""
    a = 7
    while (EXACT_LIMIT >> (2 * a)) > k - 2:
        a += 1
    m = EXACT_LIMIT >> (2 * a)
    terms = np.r_[np.zeros(k - m, np.int64), np.full(m, 1 << a)]
    terms[1] = int(past)
    return terms


def _sums_clusters(rng) -> list:
    """The "sums" batch's clusters. At sizes 40 (a warp's registers), 200 (a
    warp's shared memory), 1,000 (a block's shared memory) and 5,000 (a
    block's global scratch): four clusters whose pos and svlen windows put
    sum |x| and sum x^2 at 2^24 and one past it (each sum on its exact path
    at the limit, on its chain one past it), crossed between pos and
    svlen; at 1,000 and 5,000 a narrow spread (every sum exact) and a wide
    one (every window sum on its chain). Mapq 255 in clusters of 256 (the
    warp tier's largest); clusters of 40 and 300 whose mapq sum |q| is
    2^24 and one past it, and whose mapq terms of both signs near 2^24
    round in the float32 chain (its integer sum differs)."""
    out = []
    for cnt in (40, 200, 1000, 5000):
        k = cnt - 2 * (cnt * 25 // 100)
        edges = [(_abs_edge(k, False), _square_edge(k, False)),
                 (_abs_edge(k, True), _square_edge(k, True)),
                 (_square_edge(k, False), _abs_edge(k, False)),
                 (_square_edge(k, True), _abs_edge(k, True))]
        for pos_terms, len_terms in edges:
            c = _stats_cluster(rng, cnt, 0, 0, 0, 0)
            c["pos"] = _window_values(rng, cnt, pos_terms, int(rng.integers(10 ** 6, 10 ** 8)))
            c["svlen"] = _window_values(rng, cnt, len_terms, int(rng.integers(-5000, 5000)))
            c["nm"] = _nm_binades(rng, cnt)
            out.append(c)
        if cnt >= 1000:
            out.append(_stats_cluster(rng, cnt, 50_000_000, 20, 300, 10))
            out.append(_stats_cluster(rng, cnt, 90_000_000, 10 ** 6, -800, 10 ** 5))
    for _ in range(2):
        c = _stats_cluster(rng, 256, int(rng.integers(10 ** 6, 10 ** 8)), 300, 500, 30)
        c["mapq"][:] = 255
        out.append(c)
    for cnt in (40, 300):
        for past in (False, True):
            c = _stats_cluster(rng, cnt, int(rng.integers(10 ** 6, 10 ** 8)), 300, 500, 30)
            c["mapq"] = _abs_edge(cnt, past)
            out.append(c)
        c = _stats_cluster(rng, cnt, int(rng.integers(10 ** 6, 10 ** 8)), 300, 500, 30)
        mixed = np.zeros(cnt, np.int64)
        mixed[:4] = EXACT_LIMIT + 1, 1, -EXACT_LIMIT, 3
        c["mapq"] = mixed
        out.append(c)
    return out


def call_stats_batch(kind: str, size: int, seed: int) -> dict:
    """A clustered batch for call_statistics (the columns it reads, numpy,
    and n_clusters), in shuffled array order, so a cluster's elements are
    not contiguous. "random": clusters of 1 to 60 elements at genome
    positions, about 10 % invalid elements (some naming a live cluster,
    some the only element of their slot), skipped ids (empty slots).
    "edge" (size >= 8,192): clusters of 1 to 5 elements (the trim
    boundary), one of 5,000, ties in the modes, values at the int32 limits
    (the centering wraps), a cluster whose centered svlen spans 2^29, a
    mixed-svtype and a one-strand cluster, mapq 255, NM across 40
    binades, slots holding only invalid elements, and empty slots.
    "tiers" (size >= 65,536): a cluster of each size at the kernels' tier
    thresholds (ops/call_stats.py TINY_MAX, PAIR_MAX, WARP_MAX, BLOCK_MAX)
    and one above and below each, and of 1 and 2, with ties, NM across 40 binades,
    and int32 limits in the clusters at each threshold. "huge" (size >=
    32,768): one cluster of 25,000 elements, past a block's shared memory,
    with ties and values at the int32 limits, beside clusters of 1 to 60.
    "sums" (size >= 65,536): the edges of the kernels' exact sums
    (_sums_clusters)."""
    rng = np.random.default_rng(seed)
    clusters, invalid_only = [], []
    if kind == "random":
        free = size - size // 10
        while free > 60:
            k = int(min(rng.geometric(0.08), 60))
            free -= k
            clusters.append(_stats_cluster(rng, k, int(rng.integers(10 ** 6, 2 * 10 ** 8)),
                                           int(rng.integers(0, 600)),
                                           int(rng.choice([-1, 1]) * rng.integers(50, 5000)),
                                           int(rng.integers(0, 40)), int(rng.choice([1, 5]))))
    elif kind == "edge":
        if size < 8192:
            raise ValueError("the edge batch needs 8,192 slots")
        for k in (1, 2, 3, 4, 5):
            for _ in range(12):
                clusters.append(_stats_cluster(rng, k, int(rng.integers(10 ** 6, 10 ** 8)),
                                               int(rng.integers(0, 40)), 300, 20, 10))
        big = _stats_cluster(rng, 5000, 150_000_000, 3000, -400, 300, 1)
        clusters.append(big)
        # ties: every value twice, and two values three times against one
        tie = _stats_cluster(rng, 8, 5_000_000, 0, 100, 0)
        tie["pos"] = 5_000_000 + np.array([0, 0, 10, 10, 20, 20, 30, 30])
        tie["svlen"] = np.array([100, 100, 100, 200, 200, 200, 300, 400])
        clusters.append(tie)
        # the int32 limits: the centering wraps; the bounds overflow
        top = _stats_cluster(rng, 9, _I32_MAX - 50, 50, _I32_MIN + 20, 20)
        top["pos"][:3] = _I32_MAX
        top["svtype"][:] = 1
        clusters.append(top)
        wrap = _stats_cluster(rng, 7, 0, 0, 0, 0)
        wrap["pos"] = np.array([_I32_MIN, _I32_MIN + 1, 0, 5, _I32_MAX - 1, _I32_MAX, _I32_MAX])
        wrap["svlen"] = np.array([_I32_MAX, _I32_MIN, -1, 0, 1, _I32_MIN + 7, _I32_MAX])
        clusters.append(wrap)
        # centered svlen spanning 2^29: float32 sums that round
        wide = _stats_cluster(rng, 60, 40_000_000, 500, 0, 2 ** 28)
        clusters.append(wide)
        # mixed svtypes (the max), one strand, mapq at 255
        mixed = _stats_cluster(rng, 6, 60_000_000, 30, 500, 10)
        mixed["svtype"] = np.array([0, 4, 2, 6, 3, 1])
        mixed["strand"][:] = 1
        mixed["mapq"][:] = 255
        clusters.append(mixed)
        for c in clusters:
            c["nm"] = _nm_binades(rng, c["nm"].size)
        invalid_only = [int(x) for x in rng.integers(1, 6, 12)]
    elif kind == "tiers":
        from sniffles_tpu_torch.ops.call_stats import BLOCK_MAX, PAIR_MAX, TINY_MAX, WARP_MAX
        if size < 65536:
            raise ValueError("the tiers batch needs 65,536 slots")
        for at in (1, 2, TINY_MAX, PAIR_MAX, WARP_MAX, BLOCK_MAX):
            for k in sorted({at - 1, at, at + 1} - {0}):
                c = _stats_cluster(rng, k, int(rng.integers(10 ** 6, 2 * 10 ** 8)),
                                   int(rng.integers(0, 3000)),
                                   int(rng.choice([-1, 1]) * rng.integers(50, 5000)),
                                   int(rng.integers(0, 400)), int(rng.choice([1, 5])))
                if k == at and at > 2:  # the int32 limits: sentinels among the values
                    c["pos"][:2] = _I32_MAX, _I32_MIN
                    c["svlen"][-1] = _I32_MAX
                c["nm"] = _nm_binades(rng, k)
                clusters.append(c)
        invalid_only = [int(x) for x in rng.integers(1, 6, 8)]
    elif kind == "sums":
        if size < 65536:
            raise ValueError("the sums batch needs 65,536 slots")
        clusters = _sums_clusters(rng)
        invalid_only = [int(x) for x in rng.integers(1, 6, 6)]
    elif kind == "huge":
        if size < 32768:
            raise ValueError("the huge batch needs 32,768 slots")
        big = _stats_cluster(rng, 25_000, 80_000_000, 4000, -700, 600, 5)
        big["pos"][:3] = _I32_MAX
        big["pos"][3:5] = _I32_MIN
        big["svlen"][:4] = _I32_MAX
        big["nm"] = _nm_binades(rng, 25_000)
        clusters.append(big)
        for _ in range(40):
            clusters.append(_stats_cluster(rng, int(rng.integers(1, 61)),
                                           int(rng.integers(10 ** 6, 2 * 10 ** 8)),
                                           int(rng.integers(0, 600)), 300, 40))
        invalid_only = [int(x) for x in rng.integers(1, 6, 6)]
    else:
        raise ValueError(f"no call_stats batch of kind {kind!r}")

    # slot ids: one live cluster or invalid-only slot after another, with
    # skipped ids (empty slots) between some
    n_slots = len(clusters) + len(invalid_only)
    gaps = rng.random(n_slots) < 0.2
    ids = np.cumsum(1 + gaps) - 1
    kinds = rng.permutation(np.r_[np.zeros(len(clusters), bool), np.ones(len(invalid_only), bool)])
    cols = {k: [] for k in ("pos", "svlen", "read_id", "mapq", "strand", "svtype", "nm")}
    cid, valid = [], []
    it_c, it_i = iter(clusters), iter(invalid_only)
    for slot, only_invalid in zip(ids, kinds):
        c = (_stats_cluster(rng, next(it_i), 7_000_000, 100, 100, 10) if only_invalid
             else next(it_c))
        k = c["pos"].size
        for key in cols:
            cols[key].append(c[key])
        cid.append(np.full(k, slot))
        valid.append(np.full(k, not only_invalid))
    used = sum(x.size for x in cid)
    if used > size:
        raise ValueError(f"{used} elements do not fit {size} slots")
    # the rest: invalid padding, half naming live clusters' ids
    pad = size - used
    live = ids[~kinds]
    pad_c = _stats_cluster(rng, pad, 9_000_000, 1000, 200, 50)
    for key in cols:
        cols[key].append(pad_c[key])
    cid.append(np.where(rng.random(pad) < 0.5, rng.choice(live, pad), ids[-1] + 1 +
                        rng.integers(0, max(size - ids[-1] - 1, 1), pad)))
    valid.append(np.zeros(pad, bool))
    perm = rng.permutation(size)
    out = {k: np.concatenate(v)[perm].astype(np.float32 if k == "nm" else np.int32)
           for k, v in cols.items()}
    out["cluster_id"] = np.concatenate(cid)[perm].astype(np.int32)
    out["valid"] = np.concatenate(valid)[perm]
    out["n_clusters"] = np.int32(live.max() + 1 if live.size else 0)
    return out


SEG_SORT_KINDS = ("tiers", "random", "equal", "limits", "invalid", "huge", "packed", "tiles")


def seg_sort_width(kind: str) -> int:
    """The width the tests build each seg_sort_batch population at: 2^20 +
    8,192 for "huge", 62,302 for "tiles" (not a multiple of the run pass's
    tile, so that its last tile is partial), 65,536 for the others."""
    return {"huge": (1 << 20) + 8192, "tiles": 62_302}.get(kind, 65_536)


def _tile_edge_sizes(rng, valid_n: int) -> list:
    """The "tiles" population's segments: at the run pass's tile edges
    (ops/cluster_sorts.RUN_TILE elements a tile), a segment across a
    boundary; heads whose next head lies exactly WARP_MAX and WARP_MAX + 1
    past them across a boundary, from a tile's middle and from its last
    element; elements of their own as a tile's last and first elements; a
    thread-tier segment across a boundary; a head on a tile's first
    element; a segment longer than a tile; a warp segment that ends on a
    boundary. Fillers of 1 to 40 elements between them, up to valid_n."""
    from sniffles_tpu_torch.ops.cluster_sorts import RUN_TILE as T, TINY_MAX, WARP_MAX as W
    placed = [(T - 20, 50), (2 * T - 100, W), (3 * T - 100, W + 1), (4 * T - 1, W),
              (5 * T - 1, W + 1), (6 * T - 1, 1), (6 * T, 1), (7 * T - 2, 1), (7 * T - 1, 1),
              (7 * T, 1), (8 * T - 3, TINY_MAX), (9 * T, 40), (10 * T - 50, T + 100),
              (12 * T - W, W), (13 * T - 1, 2)]
    sizes, at = [], 0
    for start, k in placed:
        if start + k > valid_n:
            break
        while at < start:
            sizes.append(min(int(rng.integers(1, 41)), start - at))
            at += sizes[-1]
        sizes.append(k)
        at += k
    return sizes

# the "packed" population's fixed runs: 9-32-element segments whose sums fall
# on, just under and just over a warp's 32 lanes, single segments either
# side of 32 and 64, a 32 after a 1, and elements alone (segments of one)
# between packed segments
_PACKED_RUNS = ([16, 16], [9, 23], [10, 11, 11], [32], [15, 16], [10, 21], [9, 9, 9],
                [16, 17], [9, 24], [11, 11, 11], [32], [33], [64], [65], [1, 32],
                [12, 1, 12, 1, 20], [9, 1, 9, 1, 9, 1, 9])


def seg_sort_batch(kind: str, size: int, seed: int) -> dict:
    """A batch for the segmented sort (ops/cluster_sorts.seg_sort) as its
    callers build one, numpy: `seg_id`, int32 ids that ascend over
    contiguous segments; `valid`, False on a suffix made of whole segments
    (the padding); `k1` and `k2`, int32 keys. A caller sorts each segment by
    the keys masked to INT32_MAX where not valid. Kinds:
      "tiers": segments of 1 and 2 elements and of each tier threshold
        (ops/cluster_sorts.py TINY_MAX, WARP_MAX, BLOCK_MAX) and one either
        side of it, in a shuffled order, keys from a small range (ties),
        a tenth of the width invalid (size >= 65,536);
      "random": segments of geometric sizes (mean 40) up to 600, keys from
        a range of 64 (ties), some segments presorted, a tenth invalid;
      "equal": segments of 1 to BLOCK_MAX + 2 elements, every key equal
        (the order is the array's: stability);
      "limits": keys at and next to INT32_MIN, -1, 0, 1 and INT32_MAX, all
        valid, segments of 1 to 600;
      "invalid": every element invalid, segments of 1 to 300;
      "huge": one segment of 2^20 elements (size >= 2^20 + 4,096), keys
        from a range of 1,000, then small segments and an invalid tail;
      "packed": the warp tier's packing of small segments (_PACKED_RUNS,
        then segments of 9 to 32 elements up to the end, all valid: the
        last segments end at `size`), keys from a range of 64 (ties);
      "tiles": the run pass's tile edges (_tile_edge_sizes), then segments
        of 1 to 600, keys from a range of 64, a tenth invalid."""
    from sniffles_tpu_torch.ops.cluster_sorts import BLOCK_MAX, TINY_MAX, WARP_MAX
    rng = np.random.default_rng(seed)
    limits = np.array([_I32_MIN, _I32_MIN + 1, -1, 0, 1, _I32_MAX - 1, _I32_MAX], np.int64)
    sizes, presorted = [], []
    n_invalid = size // 10
    if kind == "tiers":
        if size < 65536:
            raise ValueError("the tiers batch needs 65,536 slots")
        for at in (1, 2, TINY_MAX, WARP_MAX, BLOCK_MAX):
            sizes += sorted({at - 1, at, at + 1} - {0})
        sizes = list(rng.permutation(sizes))
    elif kind == "huge":
        if size < (1 << 20) + 4096:
            raise ValueError("the huge batch needs 2^20 + 4,096 slots")
        sizes = [1 << 20]
        n_invalid = 1024
    elif kind == "invalid":
        n_invalid = size
    elif kind == "packed":
        sizes = [k for run in _PACKED_RUNS for k in run]
        n_invalid = 0
    elif kind == "tiles":
        sizes = _tile_edge_sizes(rng, size - n_invalid)
    elif kind not in ("random", "equal", "limits"):
        raise ValueError(f"no seg_sort batch of kind {kind!r}")
    if kind == "limits":
        n_invalid = 0
    free = size - n_invalid - sum(sizes)
    if free < 0:
        raise ValueError(f"the {kind} batch does not fit {size} slots")
    top = BLOCK_MAX + 2 if kind == "equal" else 600
    while free > 0:
        k = min(int(rng.geometric(1 / 40)) if kind in ("random", "huge") else
                int(rng.integers(9, 33)) if kind == "packed" else
                int(rng.integers(1, top + 1)), top, free)
        sizes.append(k)
        free -= k
    valid_n = size - n_invalid
    k1 = rng.integers(0, 1000 if kind == "huge" else 64, size)
    k2 = rng.integers(-3, 4, size)
    if kind == "equal":
        k1[:], k2[:] = 7, -7
    elif kind == "limits":
        k1, k2 = rng.choice(limits, size), rng.choice(limits, size)
    seg = np.repeat(np.arange(len(sizes)), sizes)
    if kind == "random":   # every fifth segment already in (k1, k2) order
        starts = np.r_[0, np.cumsum(sizes)[:-1]]
        for s0, k in zip(starts[::5], np.array(sizes)[::5]):
            o = np.lexsort((k2[s0:s0 + k], k1[s0:s0 + k]))
            k1[s0:s0 + k], k2[s0:s0 + k] = k1[s0:s0 + k][o], k2[s0:s0 + k][o]
    # the invalid suffix: segments of its own, of 1 to 300 elements
    tail = []
    while sum(tail) < n_invalid:
        tail.append(min(int(rng.integers(1, 301)), n_invalid - sum(tail)))
    seg_id = np.r_[seg, len(sizes) + np.repeat(np.arange(len(tail)), tail)]
    return {"seg_id": seg_id.astype(np.int32),
            "valid": np.arange(size) < valid_n,
            "k1": k1.astype(np.int32), "k2": k2.astype(np.int32)}
