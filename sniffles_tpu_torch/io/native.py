"""
ctypes bindings for the port's native host library (csrc/host/bamcore.cc
and poacore.cc), built by the host C++ compiler at first use
(ops/_build.py::build_host) into build/torch_kernels/.

The fast path of the per-read scan hot loop (reference:
leadprov.py:488-571), the CRAM codecs' ITF8 tokens and rANS, the INS
consensus and the graph POA of the local-assembly rescue. Copied from
sniffles_tpu/io/native.py, which loads the JAX package's own build under
native/; this module loads only the port's build, and a build that
fails raises: no caller falls back to Python because the library is
missing (only --no-native selects the pure-Python scan).
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Optional

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()


class _RecordCols(ctypes.Structure):
    _fields_ = [
        ("offset", ctypes.c_void_p), ("rec_len", ctypes.c_void_p),
        ("refid", ctypes.c_void_p), ("pos", ctypes.c_void_p),
        ("flag", ctypes.c_void_p), ("mapq", ctypes.c_void_p),
        ("ref_len", ctypes.c_void_p), ("qstart", ctypes.c_void_p),
        ("qalen", ctypes.c_void_p), ("l_seq", ctypes.c_void_p),
        ("nm", ctypes.c_void_p), ("hp", ctypes.c_void_p),
        ("ps", ctypes.c_void_p), ("sa_off", ctypes.c_void_p),
        ("sa_len", ctypes.c_void_p), ("large_indel_sum", ctypes.c_void_p),
        ("name_off", ctypes.c_void_p), ("name_len", ctypes.c_void_p),
        ("seq_off", ctypes.c_void_p),
    ]


class _EventCols(ctypes.Structure):
    _fields_ = [
        ("rec_index", ctypes.c_void_p), ("op", ctypes.c_void_p),
        ("oplen", ctypes.c_void_p), ("pos_ref", ctypes.c_void_p),
        ("pos_read", ctypes.c_void_p),
    ]


class _SplitCols(ctypes.Structure):
    _fields_ = [
        ("bnd_ok", ctypes.c_void_p), ("split_err", ctypes.c_void_p),
        ("bnd_anchor", ctypes.c_void_p), ("bnd_is_first", ctypes.c_void_p),
        ("bnd_mate_is_reverse", ctypes.c_void_p), ("bnd_same_strand", ctypes.c_void_p),
        ("bnd_mate_off", ctypes.c_void_p), ("bnd_mate_len", ctypes.c_void_p),
        ("bnd_mate_anchor", ctypes.c_void_p), ("bnd_sa_nm", ctypes.c_void_p),
        ("h_read", ctypes.c_void_p), ("h_type", ctypes.c_void_p),
        ("h_start", ctypes.c_void_p), ("h_svlen", ctypes.c_void_p),
        ("h_ctg_off", ctypes.c_void_p), ("h_ctg_len", ctypes.c_void_p),
        ("h_strand", ctypes.c_void_p), ("h_mapq", ctypes.c_void_p),
        ("h_source", ctypes.c_void_p), ("h_qry_start", ctypes.c_void_p),
        ("h_qry_end", ctypes.c_void_p), ("h_seq_a", ctypes.c_void_p),
        ("h_seq_b", ctypes.c_void_p),
    ]


def get_lib() -> ctypes.CDLL:
    """The port's native library, built at the first call in the process
    (the decode-ahead thread and the task's own thread may ask at once)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from sniffles_tpu_torch.ops import _build
            _LIB = _load(_build.build_host())
    return _LIB


def _load(path: str) -> ctypes.CDLL:
    # RTLD_DEEPBIND: a library loaded earlier in the process may export
    # its own zlib symbols RTLD_GLOBAL, and default lookup would rebind
    # this library's inflate() to theirs (measured 35x slower in the JAX
    # package). The build also links zlib statically (ops/_build.py).
    mode = os.RTLD_LOCAL | os.RTLD_DEEPBIND if hasattr(os, "RTLD_DEEPBIND") \
        else ctypes.DEFAULT_MODE
    lib = ctypes.CDLL(path, mode=mode)
    i64, i32, ptr, cp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_char_p
    signatures = {
        "bamcore_bgzf_inflate": (ctypes.c_int, [cp, i64, ptr, i64, ctypes.POINTER(i64)]),
        "bamcore_bgzf_inflate_mt": (ctypes.c_int, [cp, ptr, ptr, ptr, i64, ptr, i64, i32]),
        "bamcore_bgzf_walk": (i64, [cp, i64, ptr, ptr, ptr, i64]),
        "bamcore_bgzf_measure": (i64, [ptr, i64, i64, i64, i32, ctypes.POINTER(i64),
                                       ctypes.POINTER(i64), ctypes.POINTER(i32)]),
        "bamcore_scan_records": (i64, [ptr, i64, i32, i32, ctypes.POINTER(_RecordCols), i64,
                                       ctypes.POINTER(_EventCols), i64,
                                       ctypes.POINTER(i64)]),
        "bamcore_scan_splits": (i64, [ptr, i64, ptr, ptr, ptr, i64, cp, i32, ctypes.c_double,
                                      i32, i32, ctypes.c_double, i32, i32,
                                      ctypes.POINTER(_SplitCols), i64, ctypes.POINTER(i64)]),
        "bamcore_decode_seq": (None, [ptr, i64, i64, i64, cp]),
        "bamcore_coverage_add": (None, [ptr, ptr, i64, ptr, i64, i64]),
        "bamcore_edit_distance_k": (i64, [cp, i64, cp, i64, i64]),
        "bamcore_rans_compress": (i64, [cp, i64, i32, ptr, i64]),
        "bamcore_rans_uncompress": (i64, [cp, i64, ptr, i64]),
        "bamcore_itf8_bulk": (i64, [cp, i64, ptr, ptr, i64]),
        "bamcore_consensus_novel": (ctypes.c_int, [cp, i64, cp, ptr, i32, i32, i32, i32, ptr]),
        "poacore_consensus": (i64, [cp, ptr, i64, i32, i32, i32, i32, i32, i32, ptr, i64]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def itf8_bulk(data: bytes):
    """Tokenize a whole ITF8 stream (CRAM external block) in one native
    call; returns (values, token_end_offsets) as Python-int lists. A
    truncated tail is left unparsed — ends[-1] < len(data) then, and the
    caller's per-token path takes over there."""
    lib = get_lib()
    n = len(data)
    if n == 0:
        return [], []
    vals = np.empty(n, dtype=np.int32)     # <= 1 token per byte
    ends = np.empty(n, dtype=np.int32)
    count = lib.bamcore_itf8_bulk(data, n, _ptr(vals), _ptr(ends), n)
    return vals[:count].tolist(), ends[:count].tolist()


def walk_blocks(raw, start: int = 0, end: int | None = None):
    """Walk BGZF block headers; yields (coffset, bsize, isize) without
    decompressing (BSIZE from the BC subfield, ISIZE from the trailer)."""
    if end is None:
        end = len(raw)
    off = start
    while off + 18 <= end:
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize = None
        ext = off + 12
        ext_end = ext + xlen
        while ext + 4 <= ext_end:
            si1, si2 = raw[ext], raw[ext + 1]
            slen = struct.unpack_from("<H", raw, ext + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, ext + 4)[0] + 1
                break
            ext += 4 + slen
        if bsize is None or off + bsize > end:
            break
        isize = struct.unpack_from("<I", raw, off + bsize - 4)[0]
        yield off, bsize, isize
        off += bsize


_INFLATE_TLS = threading.local()


def bgzf_inflate_into(raw, start: int, end: int, total_isize: int,
                      reuse: bool = False, n_threads: int | None = None) -> np.ndarray:
    """Decompress BGZF blocks raw[start:end] into an exact-size buffer.

    With reuse=True the returned array is a view into a THREAD-LOCAL
    scratch buffer (avoids cold page faults on repeated large scans) and
    is only valid until the next reuse=True call on the same thread —
    thread-local because the decode-ahead prefetch thread and the main
    thread decode concurrently. Blocks are inflated in parallel
    (independent deflate streams) when large enough to amortize thread
    startup.
    """
    lib = get_lib()
    if reuse:
        buf = getattr(_INFLATE_TLS, "buf", None)
        if buf is None or buf.shape[0] < total_isize:
            buf = np.empty(max(total_isize, 1 << 26), dtype=np.uint8)
            _INFLATE_TLS.buf = buf
        out = buf
    else:
        out = np.empty(total_isize, dtype=np.uint8)
    chunk = bytes(raw[start:end]) if not isinstance(raw, bytes) else raw[start:end]

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    # enumerate blocks natively when available (one C pass instead of a
    # per-header struct.unpack walk), dropping empty blocks (the BGZF
    # EOF marker has ISIZE 0 and would land exactly at out_cap)
    blocks = None
    # thread-local reusable arrays; typical BGZF blocks are ~4-64 KB,
    # so start from a realistic estimate and regrow on truncation
    # (the C walker stops at cap without consuming the rest)
    cap = max(len(chunk) // 2048 + 16, 64)
    while True:
        bufs = getattr(_INFLATE_TLS, "walk", None)
        if bufs is None or bufs[0].shape[0] < cap:
            bufs = (np.empty(cap, dtype=np.int64),
                    np.empty(cap, dtype=np.int32),
                    np.empty(cap, dtype=np.int32))
            _INFLATE_TLS.walk = bufs
        offs_b, bsz_b, isz_b = bufs
        cap = offs_b.shape[0]
        nb = lib.bamcore_bgzf_walk(chunk, len(chunk), _ptr(offs_b),
                                   _ptr(bsz_b), _ptr(isz_b), cap)
        if nb < 0:
            break  # malformed header: python walker raises the error
        if nb == cap and int(offs_b[nb - 1]) + int(bsz_b[nb - 1]) < len(chunk):
            cap = cap * 4
            _INFLATE_TLS.walk = None
            continue
        keep = isz_b[:nb] > 0
        blocks = (offs_b[:nb][keep], bsz_b[:nb][keep], isz_b[:nb][keep])
        break
    if blocks is None:
        walked = [b for b in walk_blocks(chunk) if b[2] > 0]
        blocks = (np.array([b[0] for b in walked], dtype=np.int64),
                  np.array([b[1] for b in walked], dtype=np.int32),
                  np.array([b[2] for b in walked], dtype=np.int32))
    offs, bsz, isz = blocks
    n_blocks = len(offs)
    if n_threads > 1 and n_blocks >= 4 and total_isize > (1 << 22):
        out_off = np.zeros(n_blocks, dtype=np.int64)
        np.cumsum(isz[:-1], dtype=np.int64, out=out_off[1:])
        ret = lib.bamcore_bgzf_inflate_mt(chunk, _ptr(offs), _ptr(bsz),
                                          _ptr(out_off), n_blocks, _ptr(out),
                                          out.shape[0], n_threads)
        if ret != 0:
            raise ValueError(f"bamcore_bgzf_inflate_mt failed: {ret}")
        produced = int(out_off[-1]) + int(isz[-1])
        return out[:produced]

    out_len = ctypes.c_int64(0)
    ret = lib.bamcore_bgzf_inflate(chunk, len(chunk), _ptr(out), out.shape[0],
                                   ctypes.byref(out_len))
    if ret != 0:
        raise ValueError(f"bamcore_bgzf_inflate failed: {ret}")
    return out[:out_len.value]


def coverage_add(starts: np.ndarray, ends: np.ndarray, coverage: np.ndarray,
                 lo: int, hi: int) -> None:
    """cov[lo:hi] += interval coverage of [starts, ends) in one native
    pass (clamped to [lo, hi], uint16 wraparound) — replaces the numpy
    diff-array + add.at + prefix chain of the region scan."""
    if not (starts.dtype == ends.dtype == np.int64 and coverage.dtype == np.uint16
            and starts.flags.c_contiguous and ends.flags.c_contiguous
            and coverage.flags.c_contiguous and starts.shape == ends.shape):
        raise ValueError("coverage_add takes contiguous int64 starts and ends of one "
                         "length and a contiguous uint16 coverage track")
    get_lib().bamcore_coverage_add(_ptr(starts), _ptr(ends), starts.shape[0],
                                   coverage[lo:].ctypes.data_as(ctypes.c_void_p),
                                   lo, hi)


def bgzf_measure(raw, cb: int, ce: int, ce_within: int):
    """(body_isize, range_end, ce_isize) for the block range [cb, ce] of
    a BGZF stream — the region scan's chunk measure, one native call
    instead of a Python per-block header walk. None when the walk hits a
    malformed header (callers then walk with walk_blocks, which raises
    the error)."""
    lib = get_lib()
    buf = np.frombuffer(raw, dtype=np.uint8)   # no-copy view (mmap/bytes)
    body = ctypes.c_int64(0)
    rend = ctypes.c_int64(0)
    ceis = ctypes.c_int32(-1)
    ret = lib.bamcore_bgzf_measure(_ptr(buf), buf.shape[0], cb, ce, ce_within,
                                   ctypes.byref(body), ctypes.byref(rend),
                                   ctypes.byref(ceis))
    if ret < 0:
        return None
    return body.value, rend.value, ceis.value


def consensus_novel(best: bytes, others: list[bytes], klen: int, skip: int,
                    skip_repetitive: int):
    """Native k-mer-anchor INS consensus (bamcore_consensus_novel; exact
    port of consensus.novel_from_reads_spec). Returns the consensus str,
    or None for parameters the native path does not take (klen > 8) or
    a status other than 0 — callers then take the numpy path."""
    if not (0 < klen <= 8) or skip < 1 or skip_repetitive < 1:
        return None
    lib = get_lib()
    n = len(others)
    off = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum([len(s) for s in others], out=off[1:])
    concat = b"".join(others)
    out = np.empty(len(best), dtype=np.uint8)
    rc = lib.bamcore_consensus_novel(
        best, len(best), concat, _ptr(off), n,
        klen, skip, skip_repetitive, _ptr(out))
    if rc != 0:
        return None
    return out.tobytes().decode("ascii")


def poa_consensus(sequences: list[str], match: int = 10, mismatch: int = -10,
                  gap_open: int = -20, gap_extend: int = 0,
                  min_coverage: int = 1, band_slack: int = 256):
    """Graph-based partial-order alignment consensus (csrc/host/poacore.cc),
    replacing SPOA (reference: local_asm.py:17,287-291). Returns the
    consensus string, or None when poacore_consensus fails (a graph
    cycle, or a consensus past the output buffer)."""
    lib = get_lib()
    seqs = [s.encode("ascii") for s in sequences]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    concat = b"".join(seqs)
    out_cap = int(lens.max(initial=1)) * 2 + 64
    out = np.empty(out_cap, dtype=np.uint8)
    n = lib.poacore_consensus(concat, _ptr(lens), len(seqs),
                              match, mismatch, gap_open, gap_extend,
                              min_coverage, band_slack, _ptr(out), out_cap)
    if n < 0:
        return None
    return out[:n].tobytes().decode("ascii")


def bgzf_inflate(raw: bytes) -> bytes:
    """Decompress consecutive BGZF blocks via the native lib."""
    total = sum(isize for _, _, isize in walk_blocks(raw))
    return bgzf_inflate_into(raw, 0, len(raw), total).tobytes()


class ScanResult:
    """Columns produced by one native record scan (views into numpy arrays)."""

    def __init__(self, n: int, cols: dict, n_events: int, events: dict, buf: np.ndarray):
        self.n = n
        self.cols = {k: v[:n] for k, v in cols.items()}
        self.n_events = n_events
        self.events = {k: v[:n_events] for k, v in events.items()}
        self.buf = buf

    def name(self, i: int) -> str:
        off = int(self.cols["name_off"][i])
        ln = int(self.cols["name_len"][i])
        return self.buf[off:off + ln].tobytes().decode("ascii")

    def sa(self, i: int) -> Optional[str]:
        off = int(self.cols["sa_off"][i])
        if off < 0:
            return None
        ln = int(self.cols["sa_len"][i])
        return self.buf[off:off + ln].tobytes().decode("ascii")

    def seq_slice(self, i: int, start: int, end: int) -> str:
        """Decode query_sequence[start:end] for record i."""
        lib = get_lib()
        l_seq = int(self.cols["l_seq"][i])
        start = max(0, min(start, l_seq))
        end = max(start, min(end, l_seq))
        out = ctypes.create_string_buffer(end - start)
        packed_off = int(self.cols["seq_off"][i])
        lib.bamcore_decode_seq(
            ctypes.c_void_p(self.buf.ctypes.data + packed_off),
            l_seq, start, end, out)
        return out.raw.decode("ascii")

    def record_bytes(self, i: int) -> bytes:
        off = int(self.cols["offset"][i])
        ln = int(self.cols["rec_len"][i])
        return self.buf[off:off + ln].tobytes()


_SCAN_TLS = threading.local()

_COL_DTYPES = {
    "offset": np.int64, "rec_len": np.int32, "refid": np.int32, "pos": np.int32,
    "flag": np.int32, "mapq": np.int32, "ref_len": np.int32, "qstart": np.int32,
    "qalen": np.int32, "l_seq": np.int32, "nm": np.int32, "hp": np.int32,
    "ps": np.int32, "sa_off": np.int64, "sa_len": np.int32,
    "large_indel_sum": np.int32, "name_off": np.int64, "name_len": np.int32,
    "seq_off": np.int64,
}
_EV_DTYPES = {
    "rec_index": np.int32, "op": np.int32, "oplen": np.int32,
    "pos_ref": np.int32, "pos_read": np.int32,
}


def _scan_scratch(rec_cap: int, ev_cap: int):
    """Thread-local column/event buffers, reused across scans. The native
    scanner writes every field of every produced record (bamcore.cc sets
    sa_off=-1 explicitly when absent), so the buffers need no zeroing —
    and keeping them hot avoids re-faulting tens of MB of fresh pages on
    every chunk. Lifetime contract matches the inflate scratch above:
    the returned ScanResult is valid until the next scan_records call on
    the same thread."""
    st = getattr(_SCAN_TLS, "scratch", None)
    if st is None or st["rec_cap"] < rec_cap or st["ev_cap"] < ev_cap:
        rec_cap = max(rec_cap, st["rec_cap"] if st else 0)
        ev_cap = max(ev_cap, st["ev_cap"] if st else 0)
        st = {
            "rec_cap": rec_cap,
            "ev_cap": ev_cap,
            "cols": {k: np.empty(rec_cap, dtype=dt) for k, dt in _COL_DTYPES.items()},
            "events": {k: np.empty(ev_cap, dtype=dt) for k, dt in _EV_DTYPES.items()},
        }
        _SCAN_TLS.scratch = st
    return st["cols"], st["events"]


_SPLIT_COL_DTYPES = {
    "bnd_ok": np.int32, "split_err": np.int32, "bnd_anchor": np.int32,
    "bnd_is_first": np.int32, "bnd_mate_is_reverse": np.int32,
    "bnd_same_strand": np.int32, "bnd_mate_off": np.int64,
    "bnd_mate_len": np.int32, "bnd_mate_anchor": np.int32,
    "bnd_sa_nm": np.int32,
}
_HINT_COL_DTYPES = {
    "h_read": np.int32, "h_type": np.int32, "h_start": np.int32,
    "h_svlen": np.int32, "h_ctg_off": np.int64, "h_ctg_len": np.int32,
    "h_strand": np.int32, "h_mapq": np.int32, "h_source": np.int32,
    "h_qry_start": np.int32, "h_qry_end": np.int32,
    "h_seq_a": np.int32, "h_seq_b": np.int32,
}


def scan_splits(buf: np.ndarray, rec_off: np.ndarray, rec_len: np.ndarray,
                want: np.ndarray, region_contig: str, *, minsvlen: int,
                long_ins_half: float, seq_cap: int, max_splits_base: int,
                max_splits_kb: float, mapq_min: int, keep_lowqual: bool):
    """Native SA-chain parse + split classification for a subset of
    scanned records (bamcore_scan_splits). Returns (bnd_cols, hint_cols)
    dicts of numpy arrays; a read the scanner cannot parse is flagged in
    bnd_ok / split_err, and callers take the per-read Python path for it.

    `want` per read: bit0 = extract the BND lead, bit1 = classify the
    split chain (primary alignments only)."""
    lib = get_lib()
    n = len(rec_off)
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    rec_len = np.ascontiguousarray(rec_len, dtype=np.int32)
    want = np.ascontiguousarray(want, dtype=np.uint8)
    bnd = {k: np.empty(max(n, 1), dtype=dt) for k, dt in _SPLIT_COL_DTYPES.items()}
    hint_cap = max(64, 4 * n)
    while True:
        hints = {k: np.empty(hint_cap, dtype=dt) for k, dt in _HINT_COL_DTYPES.items()}
        sc = _SplitCols(**{k: _ptr(v).value for k, v in {**bnd, **hints}.items()})
        n_hints = ctypes.c_int64(0)
        rc = lib.bamcore_scan_splits(
            ctypes.c_void_p(buf.ctypes.data), buf.shape[0],
            _ptr(rec_off), _ptr(rec_len), _ptr(want), n,
            region_contig.encode("ascii"),
            minsvlen, long_ins_half, seq_cap, max_splits_base,
            max_splits_kb, mapq_min, 1 if keep_lowqual else 0,
            ctypes.byref(sc), hint_cap, ctypes.byref(n_hints))
        if rc == -9:
            hint_cap *= 4
            continue
        if rc < 0:
            raise ValueError(f"bamcore_scan_splits failed: {rc}")
        nh = int(n_hints.value)
        return {k: v[:n] for k, v in bnd.items()}, {k: v[:nh] for k, v in hints.items()}


def scan_records(decompressed: np.ndarray, min_event_len: int,
                 nm_adjust_oplen: int = 10) -> ScanResult:
    """Run the native record scan over a decompressed BAM record stream.

    The returned ScanResult's columns live in thread-local scratch and
    are only valid until the next scan_records call on this thread
    (matching bgzf_inflate_into(reuse=True), which backs res.buf)."""
    lib = get_lib()
    n_bytes = decompressed.shape[0]
    rec_cap = max(1024, n_bytes // 600)   # long reads: >> 600 B/record
    ev_cap = max(4096, rec_cap * 64)

    while True:
        cols, events = _scan_scratch(rec_cap, ev_cap)
        rc = _RecordCols(**{k: _ptr(v).value for k, v in cols.items()})
        ec = _EventCols(**{k: _ptr(v).value for k, v in events.items()})
        n_events = ctypes.c_int64(0)
        nrec = lib.bamcore_scan_records(
            ctypes.c_void_p(decompressed.ctypes.data), n_bytes,
            min_event_len, nm_adjust_oplen,
            ctypes.byref(rc), rec_cap, ctypes.byref(ec), ev_cap,
            ctypes.byref(n_events))
        if nrec == -9:
            rec_cap *= 4
            continue
        if nrec == -10:
            ev_cap *= 4
            continue
        if nrec < 0:
            raise ValueError(f"bamcore_scan_records failed: {nrec}")
        return ScanResult(int(nrec), cols, int(n_events.value), events, decompressed)
