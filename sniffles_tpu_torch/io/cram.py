"""
CRAM 3.0/3.1 container decoding with CRAI index support.

Replaces the htslib CRAM path of pysam.AlignmentFile (the reference
opens .cram inputs through pysam at leadprov.py:96-98 and
sniffles:170-178; SURVEY §2.2). Self-contained: containers, blocks,
compression headers, slice decoding and the record model are
implemented here; entropy codecs live in io/cram_codecs.py (3.0) and
io/cram31.py (3.1).

Supported on read: CRAM 3.0 and 3.1; block codecs
raw/gzip/bzip2/lzma/rANS4x8 plus the 3.1 set (rANS Nx16, adaptive
arithmetic, fqzcomp, tok3 — see io/cram31.py for the validation
caveat); encodings NULL, EXTERNAL, HUFFMAN, BYTE_ARRAY_LEN,
BYTE_ARRAY_STOP, BETA, GAMMA, SUBEXP; single- and multi-ref slices;
reference-based reads (via --reference FASTA + substitution matrix)
and referenceless reads ('b'/BA feature bases). Yields the same
BamRead objects as io/bam.py, so the calling pipeline is
format-agnostic. Copied from sniffles_tpu/io/cram.py; the ITF8 tokens
come from the port's native library (io/native.py).
"""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Iterator, Optional

from sniffles_tpu_torch.io.bam import (BamRead, IndexStatistics, FUNMAP, _CONSUME_REF,
                                       CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP,
                                       CHARD_CLIP, CPAD, CEQUAL, CDIFF)
from sniffles_tpu_torch.io.cram_codecs import (itf8_decode, ltf8_decode,
                                               decompress_block)

CRAM_MAGIC = b"CRAM"

# Block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

# CF (CRAM record flag) bits
CF_QS_PRESERVED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_UNKNOWN_BASES = 0x8

# MF (mate flag) bits
MF_MATE_REVERSE = 0x1
MF_MATE_UNMAPPED = 0x2

# v3 EOF container (spec section 9: special EOF container bytes)
EOF_MARKER = bytes.fromhex(
    "0f000000" "ffffffff0f" "e0454f46" "00" "00" "00" "00" "01" "00"
    "05bdd94f" "00" "01" "00" "06" "06" "010001000100" "ee63014b")

_SUB_BASES = "ACGTN"
# alternatives per reference base, in ACGTN order with the ref base removed
_SUB_ALTS = {r: [b for b in _SUB_BASES if b != r] for r in _SUB_BASES}


# ---------------------------------------------------------------------------
# Low-level stream pieces
# ---------------------------------------------------------------------------

@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes          # decompressed


def read_block(buf: bytes, off: int) -> tuple[Block, int]:
    import zlib
    start = off
    method = buf[off]
    content_type = buf[off + 1]
    off += 2
    content_id, off = itf8_decode(buf, off)
    comp_size, off = itf8_decode(buf, off)
    raw_size, off = itf8_decode(buf, off)
    if comp_size < 0 or off + comp_size + 4 > len(buf):
        raise ValueError("truncated CRAM block")
    # verify the CRC over the compressed bytes BEFORE handing them to a
    # codec: corrupt input must never reach the entropy decoders
    stored_crc = struct.unpack_from("<I", buf, off + comp_size)[0]
    if stored_crc != (zlib.crc32(bytes(buf[start:off + comp_size])) & 0xFFFFFFFF):
        raise ValueError("CRAM block CRC32 mismatch (corrupt file)")
    data = decompress_block(bytes(buf[off:off + comp_size]), method, raw_size)
    off += comp_size + 4
    if len(data) != raw_size:
        raise ValueError("CRAM block raw size mismatch")
    return Block(method, content_type, content_id, data), off


@dataclass
class ContainerHeader:
    length: int               # byte length of container data (blocks)
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: list[int]
    header_size: int          # bytes consumed by this header
    file_offset: int = 0      # absolute offset of the header in the file

    @property
    def is_eof(self) -> bool:
        return self.ref_seq_id == -1 and self.start == 4542278 and self.n_records == 0


def read_container_header(buf: bytes, off: int) -> ContainerHeader:
    import zlib
    base = off
    length = struct.unpack_from("<i", buf, off)[0]
    off += 4
    ref_seq_id, off = itf8_decode(buf, off)
    start, off = itf8_decode(buf, off)
    span, off = itf8_decode(buf, off)
    n_records, off = itf8_decode(buf, off)
    record_counter, off = ltf8_decode(buf, off)
    bases, off = ltf8_decode(buf, off)
    n_blocks, off = itf8_decode(buf, off)
    n_landmarks, off = itf8_decode(buf, off)
    landmarks = []
    for _ in range(n_landmarks):
        v, off = itf8_decode(buf, off)
        landmarks.append(v)
    stored_crc = struct.unpack_from("<I", buf, off)[0]
    if stored_crc != (zlib.crc32(bytes(buf[base:off])) & 0xFFFFFFFF):
        raise ValueError("CRAM container header CRC32 mismatch (corrupt file)")
    off += 4
    return ContainerHeader(length, ref_seq_id, start, span, n_records,
                           record_counter, bases, n_blocks, landmarks,
                           header_size=off - base)


class _BitReader:
    """MSB-first bit reader over the core data block."""
    __slots__ = ("data", "byte", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.byte = 0
        self.bit = 7

    def read_bit(self) -> int:
        b = (self.data[self.byte] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.byte += 1
        else:
            self.bit -= 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


class _ByteCursor:
    __slots__ = ("data", "pos", "_tok_vals", "_tok_ends", "_tok_idx")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._tok_vals = None   # None: not tokenized yet
        self._tok_ends = None
        self._tok_idx = 0

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_itf8(self) -> int:
        # Per-int ITF8 parsing dominates CRAM record decode; tokenize the
        # whole stream once (native bamcore_itf8_bulk) on first use and
        # serve values by index. Mixed streams (byte/array reads moving
        # `pos` between int reads) self-resync on the token boundaries and
        # fall back to direct decode off-boundary, so semantics are
        # position-exact either way.
        vals = self._tok_vals
        if vals is None:
            from sniffles_tpu_torch.io import native
            vals, self._tok_ends = native.itf8_bulk(self.data)
            self._tok_vals = vals
            self._tok_idx = 0
        ends = self._tok_ends
        i = self._tok_idx
        if i < len(vals) and self.pos == (ends[i - 1] if i else 0):
            self.pos = ends[i]
            self._tok_idx = i + 1
            return vals[i]
        # resync: the token starting exactly at pos, if any
        import bisect
        j = bisect.bisect_right(ends, self.pos)
        if j < len(vals) and self.pos == (ends[j - 1] if j else 0):
            self.pos = ends[j]
            self._tok_idx = j + 1
            return vals[j]
        v, self.pos = itf8_decode(self.data, self.pos)
        self._tok_idx = len(vals)  # off the token grid; resync next time
        return v

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.pos)
        b = self.data[self.pos:end]
        self.pos = end + 1
        return b


# ---------------------------------------------------------------------------
# Encodings (CRAM 3.0 section 12)
# ---------------------------------------------------------------------------

EN_NULL = 0
EN_EXTERNAL = 1
EN_GOLOMB = 2
EN_HUFFMAN = 3
EN_BYTE_ARRAY_LEN = 4
EN_BYTE_ARRAY_STOP = 5
EN_BETA = 6
EN_SUBEXP = 7
EN_GOLOMB_RICE = 8
EN_GAMMA = 9


class Encoding:
    """A parsed data-series encoding; reads ints / bytes from a slice's
    core bit stream + external byte streams."""

    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        c = _ByteCursor(params)
        if codec in (EN_NULL,):
            pass
        elif codec == EN_EXTERNAL:
            self.content_id = c.read_itf8()
        elif codec == EN_HUFFMAN:
            n = c.read_itf8()
            self.symbols = [c.read_itf8() for _ in range(n)]
            n2 = c.read_itf8()
            self.bitlens = [c.read_itf8() for _ in range(n2)]
            self._build_huffman()
        elif codec == EN_BYTE_ARRAY_LEN:
            len_codec = c.read_itf8()
            len_plen = c.read_itf8()
            self.len_enc = Encoding(len_codec, c.read_bytes(len_plen))
            val_codec = c.read_itf8()
            val_plen = c.read_itf8()
            self.val_enc = Encoding(val_codec, c.read_bytes(val_plen))
        elif codec == EN_BYTE_ARRAY_STOP:
            self.stop = c.read_byte()
            self.content_id = c.read_itf8()
        elif codec == EN_BETA:
            self.offset = c.read_itf8()
            self.nbits = c.read_itf8()
        elif codec == EN_SUBEXP:
            self.offset = c.read_itf8()
            self.k = c.read_itf8()
        elif codec == EN_GAMMA:
            self.offset = c.read_itf8()
        else:
            raise ValueError(f"unsupported CRAM encoding codec {codec}")

    def _build_huffman(self) -> None:
        # canonical Huffman: sort by (bit length, symbol); assign
        # incrementing codes, left-shifted when the length grows
        pairs = sorted(zip(self.bitlens, self.symbols))
        self._codes: dict[tuple[int, int], int] = {}
        code = 0
        prev_len = 0
        for blen, sym in pairs:
            code <<= (blen - prev_len)
            self._codes[(blen, code)] = sym
            code += 1
            prev_len = blen
        self._const = pairs[0][1] if len(pairs) == 1 and pairs[0][0] == 0 else None
        self._max_len = pairs[-1][0] if pairs else 0

    def read_int(self, core: _BitReader, ext: dict[int, _ByteCursor]) -> int:
        c = self.codec
        if c == EN_EXTERNAL:
            return ext[self.content_id].read_itf8()
        if c == EN_HUFFMAN:
            if self._const is not None:
                return self._const
            code = 0
            blen = 0
            while blen <= self._max_len:
                code = (code << 1) | core.read_bit()
                blen += 1
                sym = self._codes.get((blen, code))
                if sym is not None:
                    return sym
            raise ValueError("bad Huffman code in core stream")
        if c == EN_BETA:
            return core.read_bits(self.nbits) - self.offset
        if c == EN_GAMMA:
            n = 0
            while core.read_bit() == 0:
                n += 1
            v = (1 << n) | core.read_bits(n)
            return v - self.offset
        if c == EN_SUBEXP:
            i = 0
            while core.read_bit() == 1:
                i += 1
            if i == 0:
                n = core.read_bits(self.k)
            else:
                n = core.read_bits(i + self.k - 1) + (1 << (i + self.k - 1))
            return n - self.offset
        raise ValueError(f"encoding {c} cannot produce ints")

    def read_byte(self, core: _BitReader, ext: dict[int, _ByteCursor]) -> int:
        if self.codec == EN_EXTERNAL:
            return ext[self.content_id].read_byte()
        return self.read_int(core, ext)

    def read_array(self, core: _BitReader, ext: dict[int, _ByteCursor]) -> bytes:
        c = self.codec
        if c == EN_BYTE_ARRAY_LEN:
            n = self.len_enc.read_int(core, ext)
            ve = self.val_enc
            if ve.codec == EN_EXTERNAL:
                return ve_read_bytes(ve, ext, n)
            return bytes(ve.read_byte(core, ext) for _ in range(n))
        if c == EN_BYTE_ARRAY_STOP:
            return ext[self.content_id].read_until(self.stop)
        raise ValueError(f"encoding {c} cannot produce byte arrays")


def ve_read_bytes(enc: Encoding, ext: dict[int, _ByteCursor], n: int) -> bytes:
    return ext[enc.content_id].read_bytes(n)


# ---------------------------------------------------------------------------
# Compression header
# ---------------------------------------------------------------------------

@dataclass
class CompressionHeader:
    rn_included: bool = True
    ap_delta: bool = True
    ref_required: bool = True
    sub_matrix: bytes = b"\x1b\x1b\x1b\x1b\x1b"
    tag_dict: list[list[tuple[str, str]]] = field(default_factory=list)
    ds_encodings: dict[str, Encoding] = field(default_factory=dict)
    tag_encodings: dict[int, Encoding] = field(default_factory=dict)

    @classmethod
    def parse(cls, data: bytes) -> "CompressionHeader":
        h = cls()
        c = _ByteCursor(data)
        # preservation map
        c.read_itf8()  # size in bytes
        n = c.read_itf8()
        for _ in range(n):
            key = c.read_bytes(2).decode("ascii")
            if key == "RN":
                h.rn_included = bool(c.read_byte())
            elif key == "AP":
                h.ap_delta = bool(c.read_byte())
            elif key == "RR":
                h.ref_required = bool(c.read_byte())
            elif key == "SM":
                h.sub_matrix = c.read_bytes(5)
            elif key == "TD":
                blen = c.read_itf8()
                blob = c.read_bytes(blen)
                h.tag_dict = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    entries = []
                    for i in range(0, len(line), 3):
                        entries.append((line[i:i + 2].decode("ascii"),
                                        chr(line[i + 2])))
                    h.tag_dict.append(entries)
            else:
                raise ValueError(f"unknown preservation map key {key}")
        # data series encodings
        c.read_itf8()
        n = c.read_itf8()
        for _ in range(n):
            key = c.read_bytes(2).decode("ascii")
            codec = c.read_itf8()
            plen = c.read_itf8()
            h.ds_encodings[key] = Encoding(codec, c.read_bytes(plen))
        # tag encodings
        c.read_itf8()
        n = c.read_itf8()
        for _ in range(n):
            key = c.read_itf8()
            codec = c.read_itf8()
            plen = c.read_itf8()
            h.tag_encodings[key] = Encoding(codec, c.read_bytes(plen))
        return h


@dataclass
class SliceHeader:
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: list[int]
    embedded_ref_id: int
    ref_md5: bytes

    @classmethod
    def parse(cls, data: bytes) -> "SliceHeader":
        c = _ByteCursor(data)
        ref_seq_id = c.read_itf8()
        start = c.read_itf8()
        span = c.read_itf8()
        n_records = c.read_itf8()
        record_counter, c.pos = ltf8_decode(c.data, c.pos)
        n_blocks = c.read_itf8()
        n_ids = c.read_itf8()
        content_ids = [c.read_itf8() for _ in range(n_ids)]
        embedded_ref_id = c.read_itf8()
        ref_md5 = c.read_bytes(16)
        return cls(ref_seq_id, start, span, n_records, record_counter,
                   n_blocks, content_ids, embedded_ref_id, ref_md5)


# ---------------------------------------------------------------------------
# Tag value decoding (BAM representation, without tag id / type char)
# ---------------------------------------------------------------------------

def decode_tag_value(type_char: str, raw: bytes):
    if type_char == 'A':
        return chr(raw[0])
    if type_char == 'c':
        return struct.unpack("<b", raw)[0]
    if type_char == 'C':
        return raw[0]
    if type_char == 's':
        return struct.unpack("<h", raw)[0]
    if type_char == 'S':
        return struct.unpack("<H", raw)[0]
    if type_char == 'i':
        return struct.unpack("<i", raw)[0]
    if type_char == 'I':
        return struct.unpack("<I", raw)[0]
    if type_char == 'f':
        return struct.unpack("<f", raw)[0]
    if type_char in 'ZH':
        end = raw.find(0)
        if end < 0:
            end = len(raw)
        return raw[:end].decode("ascii", "replace")
    if type_char == 'B':
        sub = chr(raw[0])
        cnt = struct.unpack_from("<I", raw, 1)[0]
        fmt = {'c': 'b', 'C': 'B', 's': 'h', 'S': 'H', 'i': 'i', 'I': 'I', 'f': 'f'}[sub]
        return list(struct.unpack_from(f"<{cnt}{fmt}", raw, 5))
    raise ValueError(f"unknown tag type {type_char}")


TAG_FIXED_SIZE = {'A': 1, 'c': 1, 'C': 1, 's': 2, 'S': 2, 'i': 4, 'I': 4, 'f': 4}


# ---------------------------------------------------------------------------
# Record decoding
# ---------------------------------------------------------------------------

def _cigar_geometry(cigartuples: list[tuple[int, int]]) -> tuple[int, int, int]:
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
    return ref_len, qstart, qalen


class SliceDecoder:
    """Decodes all records of one slice into BamRead objects."""

    def __init__(self, comp: CompressionHeader, sheader: SliceHeader,
                 core: bytes, external: dict[int, bytes],
                 refnames: list[str], reference=None, embedded_ref=None):
        self.h = comp
        self.s = sheader
        self.core = _BitReader(core)
        self.ext = {cid: _ByteCursor(d) for cid, d in external.items()}
        self.refnames = refnames
        self.reference = reference   # FastaFile or None
        # embedded reference bases for this slice (spec 8.5: block id in
        # the slice header; covers [start-1, start-1+span) of the contig)
        self.embedded_ref = embedded_ref
        self._ref_cache: tuple[int, int, str] | None = None
        self.last_ap = sheader.start
        self.record_index = 0
        self._int_next = self._build_int_fastpaths(comp, external)

    # data-series access kinds are fixed by the spec / decode_record:
    # these are consumed as single raw bytes, everything else that is
    # not a byte array is an ITF8 int
    _BYTE_KEYS = frozenset(("FC", "BA", "QS"))

    def _build_int_fastpaths(self, comp: CompressionHeader,
                             external: dict[int, bytes]) -> dict:
        """For external blocks consumed exclusively as ITF8 ints, tokenize
        the whole stream once (native bamcore_itf8_bulk) and serve the
        values through a shared iterator per block — this removes the
        4-deep per-int call chain that dominates record decode. Blocks
        touched by any byte/array access keep the position-exact cursor
        path."""
        from sniffles_tpu_torch.io import native

        usage: dict[int, set] = {}

        def note(enc, kind):
            if enc is None:
                return
            c = enc.codec
            if c == EN_EXTERNAL:
                usage.setdefault(enc.content_id, set()).add(kind)
            elif c == EN_BYTE_ARRAY_LEN:
                # array lengths read through Encoding.read_int directly
                # (not _read_int), so their blocks must keep the cursor
                note(enc.len_enc, "len")
                note(enc.val_enc, "bytes")
            elif c == EN_BYTE_ARRAY_STOP:
                usage.setdefault(enc.content_id, set()).add("bytes")

        for key, enc in comp.ds_encodings.items():
            note(enc, "byte" if key in self._BYTE_KEYS else "int")
        for enc in comp.tag_encodings.values():
            note(enc, "bytes")

        out: dict[str, object] = {}
        iters: dict[int, object] = {}
        for key, enc in comp.ds_encodings.items():
            if (enc.codec != EN_EXTERNAL or key in self._BYTE_KEYS
                    or usage.get(enc.content_id) != {"int"}):
                continue
            cid = enc.content_id
            nxt = iters.get(cid)
            if nxt is None:
                data = external.get(cid)
                if data is None:
                    continue
                tok = native.itf8_bulk(data)
                # only a full tokenization (no truncated tail) is usable
                if tok[1] and tok[1][-1] != len(data):
                    continue
                iters[cid] = nxt = iter(tok[0]).__next__
            out[key] = nxt
        return out

    def _ds(self, key: str) -> Encoding:
        enc = self.h.ds_encodings.get(key)
        if enc is None:
            raise ValueError(f"data series {key} required but not encoded")
        return enc

    def _read_int(self, key: str) -> int:
        nxt = self._int_next.get(key)
        if nxt is not None:
            return nxt()
        return self._read_int_slow(key)

    def _read_int_slow(self, key: str) -> int:
        return self._ds(key).read_int(self.core, self.ext)

    def _read_byte(self, key: str) -> int:
        return self._ds(key).read_byte(self.core, self.ext)

    def _read_array(self, key: str) -> bytes:
        return self._ds(key).read_array(self.core, self.ext)

    def _ref_base(self, ref_id: int, pos0: int) -> str:
        """Reference base at 0-based pos (for substitution / implicit match)."""
        if self.embedded_ref is not None:
            idx = pos0 - (self.s.start - 1)
            if 0 <= idx < len(self.embedded_ref):
                return chr(self.embedded_ref[idx]).upper()
            return "N"
        if self.reference is None:
            return "N"
        name = self.refnames[ref_id]
        cache = self._ref_cache
        if cache is None or cache[0] != ref_id or not (cache[1] <= pos0 < cache[1] + len(cache[2])):
            seg_start = max(0, pos0 - 1000)
            seg = self.reference.fetch(name, seg_start, pos0 + 100_000).upper()
            cache = self._ref_cache = (ref_id, seg_start, seg)
        idx = pos0 - cache[1]
        if 0 <= idx < len(cache[2]):
            return cache[2][idx]
        return "N"

    def _ref_run(self, ref_id: int, pos0: int, n: int) -> str:
        if self.embedded_ref is not None:
            base = self.s.start - 1
            lo = pos0 - base
            hi = lo + n
            seg = self.embedded_ref[max(0, lo):max(0, hi)]
            out = seg.decode("ascii").upper()
            return ("N" * min(n, max(0, -lo))) + out + "N" * (n - len(out) - min(n, max(0, -lo)))
        if self.reference is None:
            return "N" * n
        # slice the cached segment in one go (this is the hot path of
        # reference-based decode: one implicit-match run per aligned
        # stretch of every read)
        cache = self._ref_cache
        if (cache is None or cache[0] != ref_id or pos0 < cache[1]
                or pos0 + n > cache[1] + len(cache[2])):
            name = self.refnames[ref_id]
            seg_start = max(0, pos0 - 1000)
            seg = self.reference.fetch(name, seg_start,
                                       max(pos0 + n, pos0 + 100_000)).upper()
            cache = self._ref_cache = (ref_id, seg_start, seg)
        lo = pos0 - cache[1]
        out = cache[2][lo:lo + n]
        if len(out) < n:   # off the contig end
            out += "N" * (n - len(out))
        return out

    def decode_record(self) -> BamRead:
        h = self.h
        bf = self._read_int("BF")
        cf = self._read_int("CF")
        if self.s.ref_seq_id == -2:
            ref_id = self._read_int("RI")
        else:
            ref_id = self.s.ref_seq_id
        rl = self._read_int("RL")
        ap = self._read_int("AP")
        if h.ap_delta:
            ap += self.last_ap
            self.last_ap = ap
        self._read_int("RG")
        qname = None
        if h.rn_included:
            qname = self._read_array("RN").decode("ascii")
        mf = 0
        if cf & CF_DETACHED:
            mf = self._read_int("MF")
            if not h.rn_included:
                qname = self._read_array("RN").decode("ascii")
            self._read_int("NS")
            self._read_int("NP")
            self._read_int("TS")
        elif cf & CF_MATE_DOWNSTREAM:
            self._read_int("NF")
        if qname is None:
            qname = f"record_{self.s.record_counter + self.record_index}"

        tags = {}
        tl = self._read_int("TL")
        if h.tag_dict:
            for tag, tchar in h.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(tchar)
                raw = h.tag_encodings[key].read_array(self.core, self.ext)
                tags[tag] = decode_tag_value(tchar, raw)

        flag = bf
        if cf & CF_DETACHED:
            if mf & MF_MATE_REVERSE:
                flag |= 0x20
            if mf & MF_MATE_UNMAPPED:
                flag |= 0x8

        cigartuples: list[tuple[int, int]] = []
        seq_parts: list[str] = []
        have_seq = not (cf & CF_UNKNOWN_BASES)

        def push_op(op: int, ln: int) -> None:
            if ln <= 0:
                return
            if cigartuples and cigartuples[-1][0] == op:
                cigartuples[-1] = (op, cigartuples[-1][1] + ln)
            else:
                cigartuples.append((op, ln))

        if not (bf & FUNMAP):
            fn = self._read_int("FN")
            fpos = 0          # 1-based read coordinate of last feature
            q = 0             # 0-based read bases consumed
            ref_cursor = ap - 1   # 0-based reference position of next aligned base
            sub = h.sub_matrix
            for _ in range(fn):
                fc = chr(self._read_byte("FC"))
                fdelta = self._read_int("FP")
                fpos += fdelta
                gap = (fpos - 1) - q
                if gap > 0:
                    # implicit reference match
                    if have_seq:
                        seq_parts.append(self._ref_run(ref_id, ref_cursor, gap))
                    push_op(CMATCH, gap)
                    q += gap
                    ref_cursor += gap
                if fc == 'b':
                    bases = self._read_array("BB")
                    if have_seq:
                        seq_parts.append(bases.decode("ascii"))
                    push_op(CMATCH, len(bases))
                    q += len(bases)
                    ref_cursor += len(bases)
                elif fc == 'X':
                    code = self._read_int("BS")
                    if have_seq:
                        refb = self._ref_base(ref_id, ref_cursor)
                        alts = _SUB_ALTS.get(refb, _SUB_ALTS["N"])
                        smb = sub["ACGTN".index(refb if refb in "ACGTN" else "N")]
                        base = "N"
                        for j, alt in enumerate(alts):
                            if ((smb >> (6 - 2 * j)) & 3) == code:
                                base = alt
                                break
                        seq_parts.append(base)
                    push_op(CMATCH, 1)
                    q += 1
                    ref_cursor += 1
                elif fc == 'B':
                    base = self._read_byte("BA")
                    self._read_byte("QS")
                    if have_seq:
                        seq_parts.append(chr(base))
                    push_op(CMATCH, 1)
                    q += 1
                    ref_cursor += 1
                elif fc == 'I':
                    bases = self._read_array("IN")
                    if have_seq:
                        seq_parts.append(bases.decode("ascii"))
                    push_op(CINS, len(bases))
                    q += len(bases)
                elif fc == 'i':
                    base = self._read_byte("BA")
                    if have_seq:
                        seq_parts.append(chr(base))
                    push_op(CINS, 1)
                    q += 1
                elif fc == 'S':
                    bases = self._read_array("SC")
                    if have_seq:
                        seq_parts.append(bases.decode("ascii"))
                    push_op(CSOFT_CLIP, len(bases))
                    q += len(bases)
                elif fc == 'D':
                    ln = self._read_int("DL")
                    push_op(CDEL, ln)
                    ref_cursor += ln
                elif fc == 'N':
                    ln = self._read_int("RS")
                    push_op(CREF_SKIP, ln)
                    ref_cursor += ln
                elif fc == 'H':
                    ln = self._read_int("HC")
                    push_op(CHARD_CLIP, ln)
                elif fc == 'P':
                    ln = self._read_int("PD")
                    push_op(CPAD, ln)
                elif fc == 'Q':
                    self._read_byte("QS")
                elif fc == 'q':
                    self._read_array("QQ")
                else:
                    raise ValueError(f"unknown CRAM feature code {fc!r}")
            if q < rl:
                tail = rl - q
                if have_seq:
                    seq_parts.append(self._ref_run(ref_id, ref_cursor, tail))
                push_op(CMATCH, tail)
            mapq = self._read_int("MQ")
        else:
            mapq = 0
            if have_seq:
                ba = self._ds("BA")
                if ba.codec == EN_EXTERNAL:
                    seq_parts.append(self.ext[ba.content_id].read_bytes(rl).decode("ascii"))
                else:
                    seq_parts.append("".join(chr(ba.read_byte(self.core, self.ext))
                                             for _ in range(rl)))
        if cf & CF_QS_PRESERVED:
            qs = self._ds("QS")
            if qs.codec == EN_EXTERNAL:
                self.ext[qs.content_id].read_bytes(rl)
            else:
                for _ in range(rl):
                    qs.read_byte(self.core, self.ext)

        seq = "".join(seq_parts) if have_seq else None
        ref_len, qstart, qalen = _cigar_geometry(cigartuples)
        self.record_index += 1
        return BamRead(
            query_name=qname,
            flag=flag,
            reference_id=ref_id,
            reference_start=ap - 1,
            mapping_quality=mapq,
            cigartuples=cigartuples,
            tags=tags,
            reference_name=self.refnames[ref_id] if 0 <= ref_id < len(self.refnames) else None,
            _seq_cache=seq,
            _l_seq=len(seq) if seq is not None else 0,
            reference_length=ref_len,
            query_alignment_start=qstart,
            query_alignment_length=qalen,
        )


# ---------------------------------------------------------------------------
# CRAI index
# ---------------------------------------------------------------------------

@dataclass
class CraiEntry:
    ref_seq_id: int
    start: int       # 1-based alignment start
    span: int
    container_offset: int
    slice_offset: int
    slice_size: int


def read_crai(path: str) -> list[CraiEntry]:
    with gzip.open(path, "rt") as f:
        entries = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            entries.append(CraiEntry(int(parts[0]), int(parts[1]), int(parts[2]),
                                     int(parts[3]), int(parts[4]), int(parts[5])))
    return entries


# ---------------------------------------------------------------------------
# CramFile reader
# ---------------------------------------------------------------------------

class CramFile:
    """Indexed CRAM reader presenting the io/bam.py AlignmentFile API."""

    def __init__(self, path: str, mode: str = "rc", require_index: bool = False,
                 reference_filename: Optional[str] = None):
        import mmap
        self.path = path
        # mmap, never slurp: a 30x genome CRAM is tens of GB and every
        # pipeline task opens its own handle (same rationale as
        # BGZFReader.from_file for BAM)
        self._file = open(path, "rb")
        try:
            self._raw = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._raw = b""
        if self._raw[:4] != CRAM_MAGIC:
            raise ValueError(f"{path} is not a CRAM file")
        self.major, self.minor = self._raw[4], self._raw[5]
        if self.major != 3:
            # 2.x containers lack the v3 CRC fields; parsing them with the
            # v3 layout would misread every offset
            raise ValueError(f"unsupported CRAM major version {self.major} "
                             "(CRAM 3.0 and 3.1 are supported)")
        if self._raw[-len(EOF_MARKER):] != EOF_MARKER:
            # htslib likewise treats a missing v3 EOF block as truncation
            raise ValueError(f"{path} is truncated (missing CRAM v3 EOF marker)")
        self.file_id = self._raw[6:26].rstrip(b"\x00").decode("ascii", "replace")
        off = 26
        hdr = read_container_header(self._raw, off)
        hdr.file_offset = off
        block, _ = read_block(self._raw, off + hdr.header_size)
        if block.content_type != CT_FILE_HEADER:
            raise ValueError("first CRAM container is not the file header")
        text_len = struct.unpack_from("<i", block.data, 0)[0]
        self.text = block.data[4:4 + text_len].decode("ascii", "replace")
        self._data_start = off + hdr.header_size + hdr.length
        self.references: list[str] = []
        self.lengths: list[int] = []
        for line in self.text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(p.split(":", 1) for p in line.split("\t")[1:] if ":" in p)
                self.references.append(fields["SN"])
                self.lengths.append(int(fields.get("LN", 0)))
        self._ref_by_name = {n: i for i, n in enumerate(self.references)}
        self.reference = None
        if reference_filename:
            from sniffles_tpu_torch.io.fasta import FastaFile
            self.reference = FastaFile(reference_filename)
        self._crai: Optional[list[CraiEntry]] = None
        self._container_stats: Optional[list[tuple[int, int]]] = None
        if require_index and not self.check_index():
            raise ValueError(f"No index found for {path}")

    # --- index handling ---
    def _find_index(self) -> Optional[str]:
        p = self.path + ".crai"
        if os.path.exists(p):
            return p
        base, _ = os.path.splitext(self.path)
        p = base + ".crai"
        if os.path.exists(p):
            return p
        return None

    def check_index(self) -> bool:
        if self._crai is not None:
            return True
        p = self._find_index()
        if p is None:
            return False
        self._crai = read_crai(p)
        return True

    @property
    def index(self) -> list[CraiEntry]:
        if self._crai is None and not self.check_index():
            raise ValueError(f"No index for {self.path}")
        return self._crai

    def _scan_container_stats(self) -> list[tuple[int, int]]:
        """(ref_seq_id, n_records) per data container, from headers only."""
        if self._container_stats is None:
            stats = []
            off = self._data_start
            n = len(self._raw)
            while off < n:
                hdr = read_container_header(self._raw, off)
                if hdr.is_eof:
                    break
                stats.append((hdr.ref_seq_id, hdr.n_records))
                off += hdr.header_size + hdr.length
            self._container_stats = stats
        return self._container_stats

    @property
    def mapped(self) -> int:
        return sum(n for ref, n in self._scan_container_stats() if ref >= 0)

    @property
    def unmapped(self) -> int:
        return sum(n for ref, n in self._scan_container_stats() if ref == -1)

    def get_index_statistics(self) -> list[IndexStatistics]:
        per_ref = [0] * len(self.references)
        for ref, n in self._scan_container_stats():
            if 0 <= ref < len(per_ref):
                per_ref[ref] += n
        return [IndexStatistics(contig=name, mapped=per_ref[i], unmapped=0,
                                total=per_ref[i])
                for i, name in enumerate(self.references)]

    def get_reference_length(self, contig: str) -> int:
        return self.lengths[self._ref_by_name[contig]]

    def get_tid(self, contig: str) -> int:
        return self._ref_by_name.get(contig, -1)

    # --- container / slice decoding ---
    def _decode_container_at(self, off: int) -> Iterator[BamRead]:
        hdr = read_container_header(self._raw, off)
        if hdr.is_eof:
            return
        boff = off + hdr.header_size
        block, boff = read_block(self._raw, boff)
        if block.content_type != CT_COMPRESSION_HEADER:
            raise ValueError("container does not start with a compression header")
        comp = CompressionHeader.parse(block.data)
        end = off + hdr.header_size + hdr.length
        while boff < end:
            block, boff = read_block(self._raw, boff)
            if block.content_type != CT_SLICE_HEADER:
                raise ValueError("expected slice header block")
            sheader = SliceHeader.parse(block.data)
            core = b""
            external: dict[int, bytes] = {}
            for _ in range(sheader.n_blocks):
                b, boff = read_block(self._raw, boff)
                if b.content_type == CT_CORE:
                    core = b.data
                elif b.content_type == CT_EXTERNAL:
                    external[b.content_id] = b.data
            embedded_ref = None
            if sheader.embedded_ref_id >= 0:
                embedded_ref = external.get(sheader.embedded_ref_id)
            if (comp.ref_required and embedded_ref is None
                    and self.reference is None and sheader.ref_seq_id != -1):
                raise ValueError(
                    f"{self.path} stores reads against a reference (RR=true); "
                    "pass the reference FASTA (--reference) to decode it")
            dec = SliceDecoder(comp, sheader, core, external,
                               self.references, self.reference,
                               embedded_ref=embedded_ref)
            for _ in range(sheader.n_records):
                yield dec.decode_record()

    def _iter_containers(self) -> Iterator[int]:
        off = self._data_start
        n = len(self._raw)
        while off < n:
            hdr = read_container_header(self._raw, off)
            if hdr.is_eof:
                return
            yield off
            off += hdr.header_size + hdr.length

    def fetch(self, contig: Optional[str] = None, start: Optional[int] = None,
              stop: Optional[int] = None, end: Optional[int] = None,
              until_eof: bool = False, region: Optional[str] = None) -> Iterator[BamRead]:
        """Fetch records overlapping [start, end) of contig, in position order."""
        from sniffles_tpu_torch.io.bam import normalize_fetch_args, filter_fetched
        contig, start, end = normalize_fetch_args(contig, start, stop, end, region)
        if contig is None:
            for off in self._iter_containers():
                yield from self._decode_container_at(off)
            return
        rid = self._ref_by_name[contig]
        if start is None:
            start = 0
        if end is None:
            end = self.lengths[rid]
        offsets: list[int] = []
        seen = set()
        for e in self.index:
            if e.ref_seq_id != rid and e.ref_seq_id != -2:
                continue
            if e.ref_seq_id == rid and (e.start - 1 >= end or e.start - 1 + e.span <= start):
                continue
            if e.container_offset not in seen:
                seen.add(e.container_offset)
                offsets.append(e.container_offset)
        offsets.sort()

        def reads():
            for off in offsets:
                yield from self._decode_container_at(off)

        yield from filter_fetched(reads(), rid, start, end)

    def close(self) -> None:
        if not isinstance(self._raw, bytes):
            self._raw.close()
        self._raw = b""
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
