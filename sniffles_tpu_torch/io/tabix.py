"""
bgzip compression + tabix (.tbi) index generation for VCF output.

Replaces pysam.tabix_index (reference: sniffles:573-584). Produces a
BGZF-compressed VCF and a TBI index using the standard tabix binning
scheme (min_shift=14, depth=5).

Copied from sniffles_tpu/io/tabix.py.
"""
from __future__ import annotations

import os
import struct

from sniffles_tpu_torch.io.bgzf import BGZFWriter


def _reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (tabix/BAI scheme)."""
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


class _TabixRef:
    def __init__(self):
        self.bins: dict[int, list[tuple[int, int]]] = {}
        self.intervals: list[int] = []

    def add(self, beg: int, end: int, voff_start: int, voff_end: int):
        b = _reg2bin(beg, end)
        self.bins.setdefault(b, []).append((voff_start, voff_end))
        win_start = beg >> 14
        win_end = max(win_start + 1, (end + 0x3FFF) >> 14)
        while len(self.intervals) < win_end:
            self.intervals.append(0)
        for w in range(win_start, win_end):
            if self.intervals[w] == 0 or voff_start < self.intervals[w]:
                self.intervals[w] = voff_start


def tabix_compress_and_index(vcf_path: str, out_path: str) -> str:
    """bgzip-compress vcf_path to out_path and write out_path+'.tbi'.

    The uncompressed input file is removed on success, matching the
    rename semantics of the reference's main script (sniffles:579-583).
    """
    refs_order: list[str] = []
    refs: dict[str, _TabixRef] = {}

    with open(vcf_path, "rb") as fin, open(out_path, "wb") as fout:
        writer = BGZFWriter(fout)
        for line in fin:
            voff_start = writer.tell()
            writer.write(line)
            voff_end = writer.tell()
            if line.startswith(b"#"):
                continue
            parts = line.split(b"\t", 4)
            if len(parts) < 4:
                continue
            chrom = parts[0].decode("ascii")
            pos = int(parts[1]) - 1
            end = pos + max(1, len(parts[3]))
            if chrom not in refs:
                refs_order.append(chrom)
                refs[chrom] = _TabixRef()
            refs[chrom].add(pos, end, voff_start, voff_end)
        writer.close()

    # Build .tbi (itself BGZF-compressed)
    names_blob = b"".join(n.encode("ascii") + b"\x00" for n in refs_order)
    body = bytearray()
    body += b"TBI\x01"
    body += struct.pack("<8i", len(refs_order), 2, 1, 2, 0, ord('#'), 0, len(names_blob))
    body += names_blob
    for name in refs_order:
        ref = refs[name]
        body += struct.pack("<i", len(ref.bins))
        for bin_id in sorted(ref.bins):
            chunks = ref.bins[bin_id]
            body += struct.pack("<Ii", bin_id, len(chunks))
            for cb, ce in chunks:
                body += struct.pack("<QQ", cb, ce)
        body += struct.pack("<i", len(ref.intervals))
        for ioff in ref.intervals:
            body += struct.pack("<Q", ioff)

    with open(out_path + ".tbi", "wb") as f:
        w = BGZFWriter(f)
        w.write(bytes(body))
        w.close()

    os.remove(vcf_path)
    return out_path


class TabixFile:
    """Query a bgzipped, tabix-indexed file (reader side of this module;
    the reference relies on pysam for this)."""

    def __init__(self, path: str, index_path: str | None = None):
        from sniffles_tpu_torch.io.bgzf import BGZFReader, decompress_all

        self.path = path
        self._reader = BGZFReader.from_file(path)
        idx = decompress_all(index_path or path + ".tbi")
        if idx[:4] != b"TBI\x01":
            raise ValueError(f"Not a tabix index: {index_path or path + '.tbi'}")
        (n_ref, self.format, self.col_seq, self.col_beg, self.col_end,
         self.meta_char, self.skip, l_nm) = struct.unpack_from("<8i", idx, 4)
        off = 36
        names = idx[off:off + l_nm].split(b"\x00")[:-1]
        off += l_nm
        self.contigs = [n.decode("ascii") for n in names]
        self._refs: dict[str, tuple[dict, list]] = {}
        for name in self.contigs:
            n_bin = struct.unpack_from("<i", idx, off)[0]
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", idx, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", idx, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", idx, off)[0]
            off += 4
            intervals = list(struct.unpack_from(f"<{n_intv}Q", idx, off))
            off += 8 * n_intv
            self._refs[name] = (bins, intervals)

    @staticmethod
    def _reg2bins(beg: int, end: int) -> list[int]:
        end -= 1
        bins = [0]
        bins += list(range(1 + (beg >> 26), 2 + (end >> 26)))
        bins += list(range(9 + (beg >> 23), 10 + (end >> 23)))
        bins += list(range(73 + (beg >> 20), 74 + (end >> 20)))
        bins += list(range(585 + (beg >> 17), 586 + (end >> 17)))
        bins += list(range(4681 + (beg >> 14), 4682 + (end >> 14)))
        return bins

    def fetch(self, contig: str, start: int, end: int):
        """Yield lines of records overlapping [start, end) (0-based).

        Records are position-sorted, so a single forward scan from the
        smallest candidate chunk offset is exact: stop at the first record
        starting at or past `end`, or on another contig (the JAX package's
        reader runs on into the next contig's records).
        """
        if contig not in self._refs:
            return
        bins, intervals = self._refs[contig]
        min_off = 0
        win = start >> 14
        if win < len(intervals):
            min_off = intervals[win]
        starts = [cb for b in self._reg2bins(start, end)
                  for cb, ce in bins.get(b, []) if ce > min_off]
        if not starts:
            return
        self._reader.seek(max(min_off, min(starts)))

        buf = b""
        while True:
            chunk = self._reader.read(1 << 16)
            data_end = not chunk
            buf += chunk
            lines = buf.split(b"\n")
            buf = b"" if data_end else lines.pop()
            for line in lines:
                if not line or line.startswith(b"#"):
                    continue
                parts = line.split(b"\t", 4)
                pos = int(parts[self.col_beg - 1]) - 1
                if pos >= end or parts[self.col_seq - 1].decode("ascii") != contig:
                    return
                rec_end = pos + max(1, len(parts[3])) if len(parts) > 3 else pos + 1
                if rec_end > start:
                    yield line.decode("ascii")
            if data_end:
                return
