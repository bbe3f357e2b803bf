"""
BAM writing with BAI index generation.

Used by the test/simulation harness to synthesize alignments with known
SVs (the reference has no BAM writer; its e2e coverage relies on
pre-made fixtures). Produces coordinate-sorted BAM + .bai compatible
with the reader in io/bam.py and with htslib. Copied from
sniffles_tpu/io/bamwrite.py.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from sniffles_tpu_torch.io.bgzf import BGZFWriter

CIGAR_OP_CODE = {op: i for i, op in enumerate("MIDNSHP=X")}
SEQ_NT16_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}

# byte -> 4-bit code lookup for vectorized sequence packing (case folded;
# anything unknown encodes as N=15)
_NT16_TABLE = None


def _nt16_table():
    global _NT16_TABLE
    if _NT16_TABLE is None:
        import numpy as np
        table = np.full(256, 15, dtype=np.uint8)
        for ch, code in SEQ_NT16_CODE.items():
            table[ord(ch)] = code
            table[ord(ch.lower())] = code
        _NT16_TABLE = table
    return _NT16_TABLE


def _pack_seq(seq: str) -> bytes:
    """4-bit-pack a sequence (two bases per byte, first base in the high
    nibble) with a vectorized table lookup — the per-character Python
    loop was the simulator's bottleneck (GB-scale datasets)."""
    import numpy as np
    codes = _nt16_table()[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


@dataclass
class BamRecordSpec:
    qname: str
    flag: int
    refid: int
    pos: int
    mapq: int
    cigar: list[tuple[str, int]]   # [("M", 100), ("D", 50), ...]
    seq: str
    tags: dict = field(default_factory=dict)  # {"NM": 5, "SA": "chr2,100,+,...,60,0;"}


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_record(rec: BamRecordSpec) -> bytes:
    name = rec.qname.encode("ascii") + b"\x00"
    cig = b"".join(struct.pack("<I", (ln << 4) | CIGAR_OP_CODE[op]) for op, ln in rec.cigar)
    l_seq = len(rec.seq)
    packed = _pack_seq(rec.seq)
    qual = b"\xff" * l_seq  # 0xFF = quality absent

    tags = b""
    for tag, val in rec.tags.items():
        t = tag.encode("ascii")
        if isinstance(val, int):
            tags += t + b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            tags += t + b"f" + struct.pack("<f", val)
        else:
            tags += t + b"Z" + str(val).encode("ascii") + b"\x00"

    ref_len = sum(ln for op, ln in rec.cigar if op in "MDN=X")
    bin_ = _reg2bin(rec.pos, max(rec.pos + 1, rec.pos + ref_len))

    body = struct.pack("<iiBBHHHiiii",
                       rec.refid, rec.pos, len(name), rec.mapq, bin_,
                       len(rec.cigar), rec.flag, l_seq, -1, -1, 0)
    body += name + cig + bytes(packed) + qual + tags
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, references: list[tuple[str, int]],
              records: list[BamRecordSpec], sam_header: str = "") -> str:
    """Write a coordinate-sorted BAM and its .bai; records must be sorted
    by (refid, pos). Returns the index path."""
    n_ref = len(references)

    with open(path, "wb") as f:
        w = BGZFWriter(f)
        text = sam_header.encode("ascii")
        w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        w.write(struct.pack("<i", n_ref))
        for name, length in references:
            nb = name.encode("ascii") + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))

        # per-ref index state
        bins: list[dict[int, list[list[int]]]] = [dict() for _ in range(n_ref)]
        intervals: list[list[int]] = [[] for _ in range(n_ref)]
        counts = [[0, 0] for _ in range(n_ref)]  # mapped, unmapped
        ref_span: list[list[int]] = [[-1, -1] for _ in range(n_ref)]

        for rec in records:
            voff_start = w.tell()
            w.write(_encode_record(rec))
            voff_end = w.tell()
            if rec.refid < 0:
                continue
            ref_len = sum(ln for op, ln in rec.cigar if op in "MDN=X")
            end = max(rec.pos + 1, rec.pos + ref_len)
            b = _reg2bin(rec.pos, end)
            chunk_list = bins[rec.refid].setdefault(b, [])
            if chunk_list and chunk_list[-1][1] == voff_start:
                chunk_list[-1][1] = voff_end
            else:
                chunk_list.append([voff_start, voff_end])
            if rec.flag & 0x4:
                counts[rec.refid][1] += 1
            else:
                counts[rec.refid][0] += 1
            iv = intervals[rec.refid]
            win_end = (end + 0x3FFF) >> 14
            while len(iv) < win_end:
                iv.append(0)
            for wdw in range(rec.pos >> 14, win_end):
                if iv[wdw] == 0 or voff_start < iv[wdw]:
                    iv[wdw] = voff_start
            if ref_span[rec.refid][0] == -1:
                ref_span[rec.refid][0] = voff_start
            ref_span[rec.refid][1] = voff_end
        w.close()

    bai_path = path + ".bai"
    with open(bai_path, "wb") as f:
        f.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for r in range(n_ref):
            n_bin = len(bins[r]) + (1 if counts[r][0] + counts[r][1] > 0 else 0)
            f.write(struct.pack("<i", n_bin))
            for b in sorted(bins[r]):
                chunks = bins[r][b]
                f.write(struct.pack("<Ii", b, len(chunks)))
                for cb, ce in chunks:
                    f.write(struct.pack("<QQ", cb, ce))
            if counts[r][0] + counts[r][1] > 0:
                # pseudo-bin 37450: ref span + mapped/unmapped counts
                f.write(struct.pack("<Ii", 37450, 2))
                f.write(struct.pack("<QQ", ref_span[r][0], ref_span[r][1]))
                f.write(struct.pack("<QQ", counts[r][0], counts[r][1]))
            f.write(struct.pack("<i", len(intervals[r])))
            for ioff in intervals[r]:
                f.write(struct.pack("<Q", ioff))
        f.write(struct.pack("<Q", 0))
    return bai_path
