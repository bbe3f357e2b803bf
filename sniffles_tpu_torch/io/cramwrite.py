"""
CRAM 3.0 writing with CRAI index generation.

Counterpart of io/cram.py; used to convert BAM inputs to CRAM and by
the test harness (the reference has no CRAM writer of its own — it
relies on htslib; SURVEY §2.2). Produces version 3.0 or 3.1 files: one slice
per container, all data series in external blocks (rANS order-0 for
integer series, rANS order-1 for sequence bytes, gzip for names),
referenceless ('b' feature) or reference-based (implicit match +
substitution codes) base encoding. Copied from
sniffles_tpu/io/cramwrite.py; sim.write_cram reaches it.
"""
from __future__ import annotations

import gzip
import os
import struct
import zlib
from typing import Optional

import numpy as np

from sniffles_tpu_torch.io.bam import (BamRead, CMATCH, CINS, CDEL, CREF_SKIP,
                                       CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF,
                                       FUNMAP, _CONSUME_READ)
from sniffles_tpu_torch.io.cram import (CT_FILE_HEADER, CT_COMPRESSION_HEADER,
                                        CT_SLICE_HEADER, CT_EXTERNAL, CT_CORE,
                                        CF_DETACHED, CF_UNKNOWN_BASES,
                                        MF_MATE_REVERSE, MF_MATE_UNMAPPED,
                                        EN_EXTERNAL, EN_BYTE_ARRAY_LEN,
                                        EN_BYTE_ARRAY_STOP, EOF_MARKER, _SUB_ALTS)
from sniffles_tpu_torch.io.cram_codecs import (itf8_encode, ltf8_encode,
                                               compress_block, METHOD_RAW,
                                               METHOD_GZIP, METHOD_RANS,
                                               METHOD_RANS_NX16, METHOD_FQZCOMP,
                                               METHOD_TOK3)

# fixed external-block content ids for the data series this writer emits
CID = {"BF": 1, "CF": 2, "RL": 3, "AP": 4, "RG": 5, "RN": 6, "MF": 7,
       "NS": 8, "NP": 9, "TS": 10, "TL": 11, "FN": 12, "FC": 13, "FP": 14,
       "DL": 15, "BA": 16, "BS": 17, "HC": 18, "PD": 19, "RS": 20, "MQ": 21,
       "IN_len": 22, "IN_val": 23, "SC_len": 24, "SC_val": 25,
       "BB_len": 26, "BB_val": 27, "QS": 28}
TAG_CID_BASE = 100
EMBEDDED_REF_CID = 90

# int-like series stored as ITF8 streams
_INT_SERIES = ["BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "TL",
               "FN", "FP", "DL", "BS", "HC", "PD", "RS", "MQ"]
_IDENTITY_SM = b"\x1b\x1b\x1b\x1b\x1b"


def _enc_external(cid: int) -> tuple[int, bytes]:
    return EN_EXTERNAL, itf8_encode(cid)


def _enc_byte_array_stop(stop: int, cid: int) -> tuple[int, bytes]:
    return EN_BYTE_ARRAY_STOP, bytes((stop,)) + itf8_encode(cid)


def _enc_byte_array_len(len_cid: int, val_cid: int) -> tuple[int, bytes]:
    lc, lp = _enc_external(len_cid)
    vc, vp = _enc_external(val_cid)
    params = (itf8_encode(lc) + itf8_encode(len(lp)) + lp +
              itf8_encode(vc) + itf8_encode(len(vp)) + vp)
    return EN_BYTE_ARRAY_LEN, params


def _serialize_encoding_map(entries: list[tuple[bytes, int, bytes]]) -> bytes:
    body = bytearray(itf8_encode(len(entries)))
    for key, codec, params in entries:
        body += key
        body += itf8_encode(codec)
        body += itf8_encode(len(params))
        body += params
    return bytes(itf8_encode(len(body)) + body)


def _tag_type_char(val) -> str:
    if isinstance(val, bool):
        return 'i'
    if isinstance(val, int):
        return 'i'
    if isinstance(val, float):
        return 'f'
    if isinstance(val, list):
        return 'B'
    return 'Z'


def _tag_value_bytes(tchar: str, val) -> bytes:
    if tchar == 'i':
        return struct.pack("<i", int(val))
    if tchar == 'f':
        return struct.pack("<f", float(val))
    if tchar == 'Z':
        return str(val).encode("ascii") + b"\x00"
    if tchar == 'B':
        if val and isinstance(val[0], float):
            return b"f" + struct.pack("<I", len(val)) + struct.pack(f"<{len(val)}f", *val)
        return b"i" + struct.pack("<I", len(val)) + struct.pack(f"<{len(val)}i", *[int(v) for v in val])
    raise ValueError(f"unsupported tag type {tchar}")


def _read_len_from_cigar(cigartuples) -> int:
    return sum(ln for op, ln in cigartuples if _CONSUME_READ[op])


class _Buffers(dict):
    def __missing__(self, key):
        b = bytearray()
        self[key] = b
        return b


class CramWriter:
    """Writes a coordinate-sorted CRAM 3.0 or 3.1 file + .crai index
    (3.1 adds the rANS Nx16 / tok3 / fqzcomp block codecs to the
    per-block codec choice). Records must be appended in (ref_id, pos)
    order (unmapped last)."""

    def __init__(self, path: str, references: list[str], lengths: list[int],
                 sam_header: str = "", reference=None,
                 records_per_slice: int = 10000, embed_reference: bool = False,
                 version: tuple = (3, 0)):
        if tuple(version) not in ((3, 0), (3, 1)):
            raise ValueError(f"unsupported CRAM version {version}")
        self.version = tuple(version)
        self.path = path
        self.references = references
        self.lengths = lengths
        self.reference = reference       # FastaFile for reference-based bases
        # embed each slice's reference segment as a slice block (spec 8.5),
        # so the file decodes without the external FASTA
        self.embed_reference = embed_reference and reference is not None
        self.records_per_slice = records_per_slice
        self._f = open(path, "wb")
        self._crai: list[tuple[int, int, int, int, int, int]] = []
        self._pending: list[BamRead] = []
        self._pending_ref = None
        self._record_counter = 0
        self._ref_cache: tuple[str, int, str] | None = None

        file_id = os.path.basename(path).encode("ascii", "replace")[:20]
        self._f.write(b"CRAM" + bytes(self.version) + file_id.ljust(20, b"\x00"))

        text = sam_header
        if "@SQ" not in text:
            sq = "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(references, lengths))
            text = (text + sq) if text else sq
        self.text = text
        raw = struct.pack("<i", len(text.encode("ascii"))) + text.encode("ascii")
        block = self._block_bytes(METHOD_RAW, CT_FILE_HEADER, 0, raw, len(raw))
        self._write_container(-1, 0, 0, 0, 0, [block], landmarks=[0])

    # --- low-level emitters ---
    def _block_bytes(self, method: int, ctype: int, cid: int, payload: bytes,
                     raw_size: int) -> bytes:
        head = bytes((method, ctype)) + itf8_encode(cid) + \
            itf8_encode(len(payload)) + itf8_encode(raw_size)
        crc = zlib.crc32(head + payload) & 0xFFFFFFFF
        return head + payload + struct.pack("<I", crc)

    def _compress(self, cid_name: str, data: bytes) -> tuple[int, bytes]:
        """Adaptive per-block codec choice (htslib picks per-block codecs
        the same way): try the plausible codecs and keep the smallest.
        gzip wins on cross-read redundancy (overlapping referenceless
        reads), rANS on entropy-limited series."""
        if len(data) < 32:
            return METHOD_RAW, data
        candidates = [(METHOD_GZIP, compress_block(data, METHOD_GZIP))]
        order1_series = cid_name in ("BB_val", "SC_val", "IN_val", "BA", "QS")
        if order1_series:
            candidates.append((METHOD_RANS, compress_block(data, METHOD_RANS, rans_order=1)))
        else:
            candidates.append((METHOD_RANS, compress_block(data, METHOD_RANS, rans_order=0)))
        if self.version >= (3, 1):
            from sniffles_tpu_torch.io.cram31 import (
                      rans_nx16_encode, tok3_encode, fqzcomp_encode,
                      RANS_NX16_ORDER1, RANS_NX16_PACK, RANS_NX16_RLE)
            flags = (RANS_NX16_ORDER1 if order1_series else 0) | RANS_NX16_PACK | RANS_NX16_RLE
            candidates.append((METHOD_RANS_NX16, rans_nx16_encode(data, flags)))
            if cid_name == "RN":
                candidates.append((METHOD_TOK3, tok3_encode(data)))
            if cid_name == "QS" and len(data) <= 65536:
                # the QS series is a byte stream here; encode as one record
                candidates.append((METHOD_FQZCOMP, fqzcomp_encode(data, [len(data)])))
        method, payload = min(candidates, key=lambda mp: len(mp[1]))
        if len(payload) >= len(data):
            return METHOD_RAW, data
        return method, payload

    def _write_container(self, ref_seq_id: int, start: int, span: int,
                         n_records: int, bases: int, blocks: list[bytes],
                         landmarks: list[int]) -> int:
        data = b"".join(blocks)
        head = struct.pack("<i", len(data))
        head += itf8_encode(ref_seq_id) + itf8_encode(start) + itf8_encode(span)
        head += itf8_encode(n_records) + ltf8_encode(self._record_counter)
        head += ltf8_encode(bases) + itf8_encode(len(blocks))
        head += itf8_encode(len(landmarks))
        for lm in landmarks:
            head += itf8_encode(lm)
        head += struct.pack("<I", zlib.crc32(head) & 0xFFFFFFFF)
        offset = self._f.tell()
        self._f.write(head + data)
        return offset

    # --- reference cache for reference-based encoding ---
    def _ref_seg(self, contig: str, pos0: int, n: int) -> str:
        cache = self._ref_cache
        if (cache is None or cache[0] != contig or pos0 < cache[1]
                or pos0 + n > cache[1] + len(cache[2])):
            seg_start = max(0, pos0 - 1000)
            seg = self.reference.fetch(contig, seg_start,
                                       max(pos0 + n, pos0 + 100_000)).upper()
            cache = self._ref_cache = (contig, seg_start, seg)
        return cache[2][pos0 - cache[1]:pos0 - cache[1] + n]

    # --- record appending ---
    def write(self, read: BamRead) -> None:
        ref = read.reference_id
        if self._pending and (ref != self._pending_ref
                              or len(self._pending) >= self.records_per_slice):
            self._flush_slice()
        self._pending_ref = ref
        self._pending.append(read)

    def _features(self, read: BamRead) -> list[tuple[str, int, object]]:
        """(code, 1-based read pos, value) features for a mapped read."""
        seq = read.query_sequence
        feats: list[tuple[str, int, object]] = []
        q = 0
        refpos = read.reference_start
        use_ref = self.reference is not None and seq is not None
        seq_arr = (np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
                   if use_ref else None)
        for op, ln in read.cigartuples:
            if op in (CMATCH, CEQUAL, CDIFF):
                if seq is None:
                    pass  # implicit match; bases unknown (CF flag set)
                elif use_ref:
                    refseg = self._ref_seg(read.reference_name, refpos, ln)
                    rf = np.frombuffer(refseg.encode("ascii"), dtype=np.uint8)
                    if rf.shape[0] < ln:   # off the contig end: pad with N
                        rf = np.concatenate(
                            [rf, np.full(ln - rf.shape[0], ord("N"), np.uint8)])
                    rd = seq_arr[q:q + ln]
                    # per-base scan only at the (rare) mismatch positions
                    for k in np.nonzero(rd != rf)[0].tolist():
                        rb = chr(rf[k])
                        db = chr(rd[k])
                        alts = _SUB_ALTS.get(rb if rb in "ACGTN" else "N")
                        if db in alts:
                            # substitution code from the identity matrix
                            feats.append(('X', q + k + 1, alts.index(db)))
                        else:
                            feats.append(('B', q + k + 1, db))
                else:
                    feats.append(('b', q + 1, seq[q:q + ln]))
                q += ln
                refpos += ln
            elif op == CINS:
                feats.append(('I', q + 1, seq[q:q + ln] if seq else "N" * ln))
                q += ln
            elif op == CSOFT_CLIP:
                feats.append(('S', q + 1, seq[q:q + ln] if seq else "N" * ln))
                q += ln
            elif op == CDEL:
                feats.append(('D', q + 1, ln))
                refpos += ln
            elif op == CREF_SKIP:
                feats.append(('N', q + 1, ln))
                refpos += ln
            elif op == CHARD_CLIP:
                feats.append(('H', q + 1, ln))
            elif op == CPAD:
                feats.append(('P', q + 1, ln))
            else:
                raise ValueError(f"unsupported CIGAR op {op} for CRAM")
        return feats

    def _flush_slice(self) -> None:
        records = self._pending
        self._pending = []
        if not records:
            return
        ref_id = self._pending_ref
        ext = _Buffers()
        tag_lines: list[tuple] = []
        tag_line_index: dict[tuple, int] = {}
        tag_keys: dict[tuple[str, str], int] = {}   # (tag, type) -> order

        mapped_pos = [r.reference_start for r in records
                      if r.reference_id >= 0 and r.reference_start >= 0]
        slice_start0 = min(mapped_pos) if mapped_pos else 0
        slice_end0 = max((r.reference_end for r in records
                          if r.reference_id >= 0 and r.reference_start >= 0),
                         default=slice_start0)
        start_1 = (slice_start0 + 1) if ref_id >= 0 and mapped_pos else 0
        span = (slice_end0 - slice_start0) if ref_id >= 0 and mapped_pos else 0
        # decoder seeds its AP-delta accumulator from the slice header start
        last_ap = start_1
        total_bases = 0

        # first pass: tag dictionary
        for read in records:
            sig = tuple((t, _tag_type_char(v)) for t, v in read.tags.items())
            if sig not in tag_line_index:
                tag_line_index[sig] = len(tag_lines)
                tag_lines.append(sig)
                for key in sig:
                    if key not in tag_keys:
                        tag_keys[key] = len(tag_keys)

        def put_int(name: str, v: int) -> None:
            ext[CID[name]] += itf8_encode(v)

        def put_array(name_len: str, name_val: str, data: bytes) -> None:
            ext[CID[name_len]] += itf8_encode(len(data))
            ext[CID[name_val]] += data

        for read in records:
            seq = read.query_sequence
            have_seq = seq is not None and len(seq) > 0
            if have_seq:
                rl = len(seq)
            elif read.cigartuples:
                rl = _read_len_from_cigar(read.cigartuples)
            else:
                rl = 0
            total_bases += rl
            flag = read.flag
            bf = flag & ~0x28
            cf = CF_DETACHED | (0 if have_seq else CF_UNKNOWN_BASES)
            put_int("BF", bf)
            put_int("CF", cf)
            put_int("RL", rl)
            ap = read.reference_start + 1
            put_int("AP", ap - last_ap)
            last_ap = ap
            put_int("RG", -1)
            ext[CID["RN"]] += read.query_name.encode("ascii") + b"\x00"
            mf = (MF_MATE_REVERSE if flag & 0x20 else 0) | \
                 (MF_MATE_UNMAPPED if flag & 0x8 else 0)
            put_int("MF", mf)
            put_int("NS", -1)
            put_int("NP", 0)
            put_int("TS", 0)
            sig = tuple((t, _tag_type_char(v)) for t, v in read.tags.items())
            put_int("TL", tag_line_index[sig])
            for (tag, tchar) in sig:
                raw = _tag_value_bytes(tchar, read.tags[tag])
                k = tag_keys[(tag, tchar)]
                ext[TAG_CID_BASE + 2 * k] += itf8_encode(len(raw))
                ext[TAG_CID_BASE + 2 * k + 1] += raw

            if not (flag & FUNMAP):
                feats = self._features(read)
                put_int("FN", len(feats))
                fprev = 0
                for code, fpos, val in feats:
                    ext[CID["FC"]].append(ord(code))
                    put_int("FP", fpos - fprev)
                    fprev = fpos
                    if code == 'b':
                        put_array("BB_len", "BB_val", val.encode("ascii"))
                    elif code == 'X':
                        put_int("BS", val)
                    elif code == 'B':
                        ext[CID["BA"]].append(ord(val))
                        ext[CID["QS"]].append(0xFF)  # quality absent
                    elif code == 'I':
                        put_array("IN_len", "IN_val", val.encode("ascii"))
                    elif code == 'S':
                        put_array("SC_len", "SC_val", val.encode("ascii"))
                    elif code == 'D':
                        put_int("DL", val)
                    elif code == 'N':
                        put_int("RS", val)
                    elif code == 'H':
                        put_int("HC", val)
                    elif code == 'P':
                        put_int("PD", val)
                put_int("MQ", read.mapping_quality)
            else:
                if have_seq:
                    ext[CID["BA"]] += seq.encode("ascii")

        # compression header
        pres = bytearray()
        td = bytearray()
        for line in tag_lines:
            for tag, tchar in line:
                td += tag.encode("ascii") + tchar.encode("ascii")
            td += b"\x00"
        entries = [(b"RN", bytes((1,))), (b"AP", bytes((1,))),
                   (b"RR", bytes((1 if self.reference is not None else 0,))),
                   (b"SM", _IDENTITY_SM),
                   (b"TD", itf8_encode(len(td)) + bytes(td))]
        pres += itf8_encode(len(entries))
        for key, val in entries:
            pres += key + val
        pres = itf8_encode(len(pres)) + pres

        ds = []
        for name in _INT_SERIES:
            codec, params = _enc_external(CID[name])
            ds.append((name.encode("ascii"), codec, params))
        ds.append((b"RN", *_enc_byte_array_stop(0, CID["RN"])))
        ds.append((b"FC", *_enc_external(CID["FC"])))
        ds.append((b"BA", *_enc_external(CID["BA"])))
        ds.append((b"QS", *_enc_external(CID["QS"])))
        ds.append((b"IN", *_enc_byte_array_len(CID["IN_len"], CID["IN_val"])))
        ds.append((b"SC", *_enc_byte_array_len(CID["SC_len"], CID["SC_val"])))
        ds.append((b"BB", *_enc_byte_array_len(CID["BB_len"], CID["BB_val"])))
        ds_map = _serialize_encoding_map(ds)

        tenc = []
        for (tag, tchar), k in tag_keys.items():
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(tchar)
            codec, params = _enc_byte_array_len(TAG_CID_BASE + 2 * k,
                                                TAG_CID_BASE + 2 * k + 1)
            tenc.append((itf8_encode(key), codec, params))
        tag_map = _serialize_encoding_map(tenc)

        comp_data = bytes(pres) + ds_map + tag_map
        comp_block = self._block_bytes(METHOD_RAW, CT_COMPRESSION_HEADER, 0,
                                       comp_data, len(comp_data))

        # external blocks (always materialize the declared series so
        # zero-length arrays still find their value block)
        all_cids = sorted(set(CID.values()) |
                          {TAG_CID_BASE + 2 * k + j for k in tag_keys.values() for j in (0, 1)})
        data_blocks = [self._block_bytes(METHOD_RAW, CT_CORE, 0, b"", 0)]
        content_ids = []
        embedded_ref_id = -1
        if self.embed_reference and ref_id >= 0 and mapped_pos:
            refseg = self._ref_seg(self.references[ref_id], slice_start0,
                                   slice_end0 - slice_start0).encode("ascii")
            method, payload = self._compress("BB_val", refseg)
            data_blocks.append(self._block_bytes(method, CT_EXTERNAL,
                                                 EMBEDDED_REF_CID, payload,
                                                 len(refseg)))
            content_ids.append(EMBEDDED_REF_CID)
            embedded_ref_id = EMBEDDED_REF_CID
        for cid in all_cids:
            buf = bytes(ext.get(cid, b""))
            name = next((n for n, c in CID.items() if c == cid), "tag")
            method, payload = self._compress(name, buf)
            data_blocks.append(self._block_bytes(method, CT_EXTERNAL, cid,
                                                 payload, len(buf)))
            content_ids.append(cid)

        shead = itf8_encode(ref_id) + itf8_encode(start_1) + itf8_encode(span)
        shead += itf8_encode(len(records)) + ltf8_encode(self._record_counter)
        shead += itf8_encode(len(data_blocks))
        shead += itf8_encode(len(content_ids))
        for cid in content_ids:
            shead += itf8_encode(cid)
        shead += itf8_encode(embedded_ref_id)
        shead += bytes(16)             # reference MD5 unset
        slice_block = self._block_bytes(METHOD_RAW, CT_SLICE_HEADER, 0,
                                        shead, len(shead))

        blocks = [comp_block, slice_block] + data_blocks
        landmark = len(comp_block)
        slice_size = len(slice_block) + sum(len(b) for b in data_blocks)
        offset = self._write_container(ref_id, start_1, span, len(records),
                                       total_bases, blocks,
                                       landmarks=[landmark])
        self._crai.append((ref_id, start_1, span, offset, landmark, slice_size))
        self._record_counter += len(records)

    def close(self) -> Optional[str]:
        self._flush_slice()
        self._f.write(EOF_MARKER)
        self._f.close()
        crai_path = self.path + ".crai"
        with gzip.open(crai_path, "wt") as f:
            for entry in self._crai:
                f.write("\t".join(str(v) for v in entry) + "\n")
        return crai_path


def bam_to_cram(bam_path: str, cram_path: str,
                reference_filename: Optional[str] = None,
                records_per_slice: int = 10000,
                embed_reference: bool = False,
                version: tuple = (3, 0)) -> str:
    """Convert an indexed BAM to CRAM 3.0/3.1 + .crai; returns the index path."""
    from sniffles_tpu_torch.io.bam import AlignmentFile
    bam = AlignmentFile(bam_path)
    reference = None
    if reference_filename:
        from sniffles_tpu_torch.io.fasta import FastaFile
        reference = FastaFile(reference_filename)
    w = CramWriter(cram_path, bam.references, bam.lengths,
                   sam_header=bam.text, reference=reference,
                   records_per_slice=records_per_slice,
                   embed_reference=embed_reference, version=version)
    for read in bam.fetch():
        w.write(read)
    return w.close()
