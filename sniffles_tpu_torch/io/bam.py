"""
BAM container decoding with BAI/CSI index support.

Replaces pysam.AlignmentFile for the subset of functionality the caller
needs (reference: leadprov.py:488 bam.fetch, sniffles:170-178 index
checks, sniffles:313 get_index_statistics). Self-contained: BGZF via
io/bgzf.py, record decoding here (pure Python) or via the port's native
C++ decoder (csrc/host/bamcore.cc, io/native.py).

The decoder exposes two access styles:
  * `AlignmentFile.fetch(contig, start, end)` — per-record iteration,
    yielding lightweight `BamRead` objects (the pure-Python scan,
    --no-native, and the local-assembly rescue);
  * `BamFile.scan_region` — the native scan's columns per index chunk,
    which `leads.LeadProvider` turns into leads.

`AlignmentFile` opens a CRAM (mode 'rc' or a .cram path) as a
`io/cram.py::CramFile`. Copied from sniffles_tpu/io/bam.py.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from sniffles_tpu_torch.io.bgzf import BGZFReader

# CIGAR operations, same encoding as the BAM spec / pysam constants
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
CIGAR_OPS = "MIDNSHP=X"

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_SEQ_NT16_LUT = np.frombuffer(SEQ_NT16.encode("ascii"), dtype=np.uint8)

# (add_read, add_ref) per CIGAR op (reference: leadprov.py:180-195 OPTAB)
_CONSUME_READ = (1, 1, 0, 0, 1, 0, 0, 1, 1)
_CONSUME_REF = (1, 0, 1, 1, 0, 0, 0, 1, 1)


@dataclass
class BamRead:
    """A decoded BAM alignment record (subset of pysam.AlignedSegment API)."""
    query_name: str
    flag: int
    reference_id: int
    reference_start: int
    mapping_quality: int
    cigartuples: list[tuple[int, int]]
    tags: dict
    reference_name: str = None
    _seq_raw: bytes = None       # 4-bit packed sequence
    _l_seq: int = 0
    _seq_cache: Optional[str] = None

    # --- derived geometry, computed once at parse time ---
    reference_length: int = 0          # ref span of the alignment
    query_alignment_start: int = 0     # leading soft clip length
    query_alignment_length: int = 0    # aligned query bases (M/I/=/X)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def reference_end(self) -> int:
        return self.reference_start + self.reference_length

    @property
    def query_alignment_end(self) -> int:
        return self.query_alignment_start + self.query_alignment_length

    @property
    def query_length(self) -> int:
        """Length of SEQ; 0 if sequence not stored (pysam semantics)."""
        return self._l_seq

    @property
    def query_sequence(self) -> Optional[str]:
        if self._seq_cache is None:
            if self._l_seq == 0:
                return None
            raw = np.frombuffer(self._seq_raw, dtype=np.uint8)
            chars = np.empty(raw.shape[0] * 2, dtype=np.uint8)
            chars[0::2] = _SEQ_NT16_LUT[raw >> 4]
            chars[1::2] = _SEQ_NT16_LUT[raw & 0xF]
            self._seq_cache = chars[:self._l_seq].tobytes().decode("ascii")
        return self._seq_cache

    def has_tag(self, tag: str) -> bool:
        return tag in self.tags

    def get_tag(self, tag: str):
        return self.tags[tag]


def _parse_tags(buf: bytes) -> dict:
    tags = {}
    i = 0
    n = len(buf)
    while i + 3 <= n:
        tag = buf[i:i + 2].decode("ascii")
        typ = chr(buf[i + 2])
        i += 3
        if typ == 'A':
            tags[tag] = chr(buf[i]); i += 1
        elif typ == 'c':
            tags[tag] = struct.unpack_from('<b', buf, i)[0]; i += 1
        elif typ == 'C':
            tags[tag] = buf[i]; i += 1
        elif typ == 's':
            tags[tag] = struct.unpack_from('<h', buf, i)[0]; i += 2
        elif typ == 'S':
            tags[tag] = struct.unpack_from('<H', buf, i)[0]; i += 2
        elif typ == 'i':
            tags[tag] = struct.unpack_from('<i', buf, i)[0]; i += 4
        elif typ == 'I':
            tags[tag] = struct.unpack_from('<I', buf, i)[0]; i += 4
        elif typ == 'f':
            tags[tag] = struct.unpack_from('<f', buf, i)[0]; i += 4
        elif typ in 'ZH':
            end = buf.index(0, i)
            tags[tag] = buf[i:end].decode("ascii", "replace")
            i = end + 1
        elif typ == 'B':
            sub = chr(buf[i]); cnt = struct.unpack_from('<I', buf, i + 1)[0]
            i += 5
            fmt = {'c': 'b', 'C': 'B', 's': 'h', 'S': 'H', 'i': 'i', 'I': 'I', 'f': 'f'}[sub]
            sz = struct.calcsize(fmt)
            tags[tag] = list(struct.unpack_from(f'<{cnt}{fmt}', buf, i))
            i += cnt * sz
        else:
            break  # unknown tag type; stop parsing
    return tags


def parse_record(buf: bytes, refnames: list[str]) -> BamRead:
    """Decode one alignment record (without the leading block_size int32)."""
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    qname = buf[off:off + l_read_name - 1].decode("ascii")
    off += l_read_name
    cig = struct.unpack_from(f"<{n_cigar}I", buf, off)
    off += 4 * n_cigar
    cigartuples = [(c & 0xF, c >> 4) for c in cig]
    seq_bytes = (l_seq + 1) // 2
    seq_raw = buf[off:off + seq_bytes]
    off += seq_bytes + l_seq  # skip qual
    tags = _parse_tags(buf[off:])

    ref_len = 0
    qstart = 0
    qalen = 0
    seen_aligned = False
    for op, ln in cigartuples:
        ref_len += _CONSUME_REF[op] * ln
        if op in (CMATCH, CINS, CEQUAL, CDIFF):
            qalen += ln
            seen_aligned = True
        elif op == CSOFT_CLIP and not seen_aligned:
            qstart += ln

    return BamRead(
        query_name=qname,
        flag=flag,
        reference_id=ref_id,
        reference_start=pos,
        mapping_quality=mapq,
        cigartuples=cigartuples,
        tags=tags,
        reference_name=refnames[ref_id] if 0 <= ref_id < len(refnames) else None,
        _seq_raw=seq_raw,
        _l_seq=l_seq,
        reference_length=ref_len,
        query_alignment_start=qstart,
        query_alignment_length=qalen,
    )


# ---------------------------------------------------------------------------
# Index parsing: BAI and CSI
# ---------------------------------------------------------------------------

@dataclass
class RefIndex:
    bins: dict[int, list[tuple[int, int]]]   # bin -> [(chunk_beg, chunk_end)] voffsets
    loffsets: dict[int, int]                  # bin -> linear/loffset hint (CSI) ;
    intervals: list[int]                      # BAI 16kb linear index
    n_mapped: int = -1
    n_unmapped: int = -1


class BamIndex:
    """Parsed .bai or .csi index."""

    def __init__(self, min_shift: int, depth: int, refs: list[RefIndex], n_no_coor: int = 0):
        self.min_shift = min_shift
        self.depth = depth
        self.refs = refs
        self.n_no_coor = n_no_coor

    def reg2bins(self, beg: int, end: int) -> list[int]:
        """Bins overlapping [beg, end) for this index's binning scheme."""
        if end <= beg:
            return []
        end -= 1
        bins = []
        l, t, s = 0, 0, self.min_shift + self.depth * 3
        while l <= self.depth:
            b = t + (beg >> s)
            e = t + (end >> s)
            bins.extend(range(b, e + 1))
            s -= 3
            t += 1 << (l * 3)
            l += 1
        return bins

    def chunks_for_region(self, ref_id: int, beg: int, end: int) -> list[tuple[int, int]]:
        if ref_id < 0 or ref_id >= len(self.refs):
            return []
        ref = self.refs[ref_id]
        min_off = 0
        if ref.intervals:
            # BAI linear index: lowest voffset of records overlapping 16kb windows
            win = beg >> 14
            if win < len(ref.intervals):
                min_off = ref.intervals[win]
        chunks = []
        for b in self.reg2bins(beg, end):
            entry = ref.bins.get(b)
            if entry:
                for cb, ce in entry:
                    if ce > min_off:
                        chunks.append((max(cb, min_off), ce))
        chunks.sort()
        # merge adjacent/overlapping chunks
        merged: list[list[int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        return [(cb, ce) for cb, ce in merged]

    # Parsed-index cache: every task re-opens the BAM (one AlignmentFile
    # per task execution, reference opens per-worker too) and re-parsing
    # a whole-genome BAI is ~100k struct unpacks. Indexes are immutable
    # for a given (path, mtime, size), so share the parsed object.
    _CACHE: dict = {}

    @classmethod
    def load(cls, path: str) -> "BamIndex":
        try:
            st = os.stat(path)
            key = (os.path.realpath(path), st.st_mtime_ns, st.st_size)
        except OSError:
            key = None
        if key is not None and key in cls._CACHE:
            # true LRU: refresh recency on hit, else cyclic access over
            # more than 16 inputs degrades to 0% hit rate
            cls._CACHE[key] = cls._CACHE.pop(key)
            return cls._CACHE[key]
        idx = cls._load_uncached(path)
        if key is not None:
            if len(cls._CACHE) >= 16:  # long-lived processes, many inputs
                cls._CACHE.pop(next(iter(cls._CACHE)))
            cls._CACHE[key] = idx
        return idx

    @classmethod
    def _load_uncached(cls, path: str) -> "BamIndex":
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] == b"CSI\x01":
            return cls._parse_csi(raw)
        if raw[:4] == b"BAI\x01":
            return cls._parse_bai(raw)
        # CSI index files are BGZF compressed
        from sniffles_tpu_torch.io.bgzf import decompress_all
        data = decompress_all(path)
        if data[:4] == b"CSI\x01":
            return cls._parse_csi(data)
        if data[:4] == b"BAI\x01":
            return cls._parse_bai(data)
        raise ValueError(f"Unrecognized index format: {path}")

    @classmethod
    def _parse_csi(cls, d: bytes) -> "BamIndex":
        min_shift, depth, l_aux = struct.unpack_from("<iii", d, 4)
        off = 16 + l_aux
        n_ref = struct.unpack_from("<i", d, off)[0]
        off += 4
        pseudo = ((1 << 3 * (depth + 1)) - 1) // 7 + 1
        refs = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", d, off)[0]
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            loffsets: dict[int, int] = {}
            n_mapped = n_unmapped = -1
            for _ in range(n_bin):
                bin_id, loffset, n_chunk = struct.unpack_from("<IQi", d, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", d, off)
                    off += 16
                    chunks.append((cb, ce))
                if bin_id == pseudo:
                    if len(chunks) >= 2:
                        n_mapped, n_unmapped = chunks[1]
                else:
                    bins[bin_id] = chunks
                    loffsets[bin_id] = loffset
            refs.append(RefIndex(bins=bins, loffsets=loffsets, intervals=[],
                                 n_mapped=n_mapped, n_unmapped=n_unmapped))
        return cls(min_shift, depth, refs)

    @classmethod
    def _parse_bai(cls, d: bytes) -> "BamIndex":
        n_ref = struct.unpack_from("<i", d, 4)[0]
        off = 8
        refs = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", d, off)[0]
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            n_mapped = n_unmapped = -1
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", d, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", d, off)
                    off += 16
                    chunks.append((cb, ce))
                if bin_id == 37450:
                    if len(chunks) >= 2:
                        n_mapped, n_unmapped = chunks[1]
                else:
                    bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", d, off)[0]
            off += 4
            intervals = list(struct.unpack_from(f"<{n_intv}Q", d, off))
            off += 8 * n_intv
            refs.append(RefIndex(bins=bins, loffsets={}, intervals=intervals,
                                 n_mapped=n_mapped, n_unmapped=n_unmapped))
        n_no_coor = 0
        if off + 8 <= len(d):
            n_no_coor = struct.unpack_from("<Q", d, off)[0]
        return cls(14, 5, refs, n_no_coor)


@dataclass
class IndexStatistics:
    contig: str
    mapped: int
    unmapped: int
    total: int


def _bgzf_isize(raw: bytes, coffset: int) -> int:
    """ISIZE (uncompressed length) of the BGZF block at coffset."""
    xlen = struct.unpack_from("<H", raw, coffset + 10)[0]
    ext = coffset + 12
    ext_end = ext + xlen
    while ext + 4 <= ext_end:
        if raw[ext] == 66 and raw[ext + 1] == 67:
            bsize = struct.unpack_from("<H", raw, ext + 4)[0] + 1
            return struct.unpack_from("<I", raw, coffset + bsize - 4)[0]
        ext += 4 + struct.unpack_from("<H", raw, ext + 2)[0]
    raise ValueError("BGZF block missing BC subfield")


def normalize_fetch_args(contig, start, stop, end, region):
    """Shared fetch() argument normalization for BAM and CRAM readers."""
    if region is not None:
        from sniffles_tpu_torch.region import Region
        reg = Region.from_string(region)
        if reg is None:
            raise ValueError(f"invalid region string: {region!r}")
        contig, start, end = reg.contig, reg.start, reg.end
    if end is None:
        end = stop
    return contig, start, end


def filter_fetched(reads, rid: int, start: int, end: int):
    """Overlap filter over a coordinate-sorted record stream: yields
    records of contig `rid` overlapping [start, end) (pysam fetch
    semantics), stopping at the first record that proves nothing
    further can overlap."""
    for read in reads:
        if read.reference_id != rid:
            if read.reference_id > rid or read.reference_id < 0:
                return
            continue
        if read.reference_start >= end:
            return
        if read.reference_end > start or read.is_unmapped:
            yield read


def AlignmentFile(path: str, mode: str = "rb", require_index: bool = False,
                  reference_filename: Optional[str] = None):
    """pysam.AlignmentFile work-alike factory: returns a BamFile for BAM
    inputs or a CramFile (io/cram.py) for CRAM inputs (mode 'rc' or a
    .cram path), both presenting the same fetch/index API (the reference
    gets both formats through htslib, SURVEY §2.2)."""
    if mode == "rc" or path.endswith(".cram"):
        from sniffles_tpu_torch.io.cram import CramFile
        return CramFile(path, require_index=require_index,
                        reference_filename=reference_filename)
    return BamFile(path, mode, require_index, reference_filename)


class BamFile:
    """Indexed BAM reader (pysam.AlignmentFile work-alike for the caller's needs)."""

    def __init__(self, path: str, mode: str = "rb", require_index: bool = False,
                 reference_filename: Optional[str] = None):
        if mode not in ("rb",):
            raise NotImplementedError(f"unsupported AlignmentFile mode {mode!r}")
        self.path = path
        self._reader = BGZFReader.from_file(path)
        self._index: Optional[BamIndex] = None
        self._parse_header()
        if require_index and not self.check_index():
            raise ValueError(f"No index found for {path}")

    def _parse_header(self) -> None:
        r = self._reader
        r.seek(0)
        magic = r.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{self.path} is not a BAM file")
        l_text = struct.unpack("<i", r.read(4))[0]
        self.text = r.read(l_text).decode("ascii", "replace")
        n_ref = struct.unpack("<i", r.read(4))[0]
        self.references: list[str] = []
        self.lengths: list[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", r.read(4))[0]
            name = r.read(l_name)[:-1].decode("ascii")
            l_ref = struct.unpack("<i", r.read(4))[0]
            self.references.append(name)
            self.lengths.append(l_ref)
        self._data_voffset = r.tell()
        self._ref_by_name = {n: i for i, n in enumerate(self.references)}

    # --- index handling ---
    def _find_index(self) -> Optional[str]:
        for suffix in (".csi", ".bai"):
            p = self.path + suffix
            if os.path.exists(p):
                return p
        base, _ = os.path.splitext(self.path)
        for suffix in (".csi", ".bai"):
            p = base + suffix
            if os.path.exists(p):
                return p
        return None

    def check_index(self) -> bool:
        if self._index is not None:
            return True
        p = self._find_index()
        if p is None:
            return False
        self._index = BamIndex.load(p)
        return True

    @property
    def index(self) -> BamIndex:
        if self._index is None and not self.check_index():
            raise ValueError(f"No index for {self.path}")
        return self._index

    @property
    def mapped(self) -> int:
        return sum(max(0, r.n_mapped) for r in self.index.refs)

    @property
    def unmapped(self) -> int:
        return sum(max(0, r.n_unmapped) for r in self.index.refs)

    def get_index_statistics(self) -> list[IndexStatistics]:
        stats = []
        for i, name in enumerate(self.references):
            if i < len(self.index.refs):
                ref = self.index.refs[i]
                m, u = max(0, ref.n_mapped), max(0, ref.n_unmapped)
            else:
                m, u = 0, 0
            stats.append(IndexStatistics(contig=name, mapped=m, unmapped=u, total=m + u))
        return stats

    def get_reference_length(self, contig: str) -> int:
        return self.lengths[self._ref_by_name[contig]]

    def get_tid(self, contig: str) -> int:
        return self._ref_by_name.get(contig, -1)

    # --- record iteration ---
    def _iter_records_from(self, voffset: int) -> Iterator[BamRead]:
        r = self._reader
        r.seek(voffset)
        while True:
            hdr = r.read(4)
            if len(hdr) < 4:
                return
            block_size = struct.unpack("<i", hdr)[0]
            buf = r.read(block_size)
            if len(buf) < block_size:
                return
            yield parse_record(buf, self.references)

    def _records_in_chunks(self, chunks) -> Iterator[BamRead]:
        r = self._reader
        for cb, ce in chunks:
            r.seek(cb)
            while r.tell() < ce:
                hdr = r.read(4)
                if len(hdr) < 4:
                    return
                block_size = struct.unpack("<i", hdr)[0]
                buf = r.read(block_size)
                if len(buf) < block_size:
                    return
                yield parse_record(buf, self.references)

    def fetch(self, contig: Optional[str] = None, start: Optional[int] = None,
              stop: Optional[int] = None, end: Optional[int] = None,
              until_eof: bool = False, region: Optional[str] = None) -> Iterator[BamRead]:
        """Fetch records overlapping [start, end) of contig, in position order."""
        contig, start, end = normalize_fetch_args(contig, start, stop, end, region)
        if contig is None:
            yield from self._iter_records_from(self._data_voffset)
            return
        rid = self._ref_by_name[contig]
        if start is None:
            start = 0
        if end is None:
            end = self.lengths[rid]
        chunks = self.index.chunks_for_region(rid, start, end)
        yield from filter_fetched(self._records_in_chunks(chunks), rid, start, end)

    def close(self) -> None:
        self._reader = None

    # --- native fast path ---
    def scan_region(self, contig: str, start: int, end: int, min_event_len: int,
                    nm_adjust_oplen: int = 10):
        """
        Scan records overlapping [start, end) with the native decoder
        (csrc/host/bamcore.cc), yielding (ScanResult, region_mask) per
        index chunk. region_mask selects records of this contig
        overlapping the window (same semantics as fetch).
        """
        from sniffles_tpu_torch.io import native

        lib_raw = self._reader._raw
        rid = self._ref_by_name[contig]
        chunks = self.index.chunks_for_region(rid, start, end)

        for cb, ce in chunks:
            cb_block, cb_within = cb >> 16, cb & 0xFFFF
            ce_block, ce_within = ce >> 16, ce & 0xFFFF

            # exact decompressed size and end-cut from an ISIZE header walk
            # (one native call; the Python block walk where the native
            # one meets a header it cannot read), then a single native
            # inflate into the final buffer (no joins)
            measured = native.bgzf_measure(lib_raw, cb_block, ce_block, ce_within)
            if measured is not None:
                body_isize, range_end, ce_isize = measured
            else:
                body_isize = 0
                range_end = ce_block
                ce_isize = None
                for boff, bsize, isize in native.walk_blocks(lib_raw, cb_block):
                    if boff < ce_block:
                        body_isize += isize
                        range_end = boff + bsize
                    elif boff == ce_block and ce_within > 0:
                        body_isize += isize
                        range_end = boff + bsize
                        break
                    else:
                        break
            if body_isize == 0:
                continue
            # reuse=True: the buffer is valid until the next chunk scan,
            # which matches the generator consumption pattern here
            buf = native.bgzf_inflate_into(lib_raw, cb_block, range_end, body_isize,
                                           reuse=True)
            if ce_within == 0:
                limit = len(buf)
            else:
                if ce_isize is None or ce_isize < 0:
                    ce_isize = _bgzf_isize(lib_raw, ce_block)
                limit = body_isize - ce_isize + ce_within
            buf = buf[cb_within:limit]
            if buf.size == 0:
                continue

            res = native.scan_records(buf, min_event_len, nm_adjust_oplen)
            cols = res.cols
            mask = (cols["refid"] == rid) & (cols["pos"] < end) & \
                   ((cols["pos"] + cols["ref_len"] > start) | ((cols["flag"] & FUNMAP) != 0))
            yield res, mask
