"""
CRAM 3.0 primitive codecs: ITF8/LTF8 varints and the rANS 4x8 entropy
codec (CRAM compression method 4), encoder and decoder.

The reference reads CRAM through htslib (SURVEY §2.2; pysam
AlignmentFile at leadprov.py:96-98); this module is part of the
self-contained replacement. The rANS implementation follows the CRAM
3.0 specification (section 13 "rANS codec"): 4 interleaved rANS states,
12-bit normalized frequencies, order-0 and order-1 contexts, with the
frequency-table serialization's run-length scheme for consecutive
symbols. Copied from sniffles_tpu/io/cram_codecs.py; rANS 4x8 runs in
the port's native library (io/native.py), its pure-Python version
beside it (rans_encode_plain, rans_decode_plain).
"""
from __future__ import annotations

import bz2
import lzma
import struct
import zlib

# ---------------------------------------------------------------------------
# ITF8 / LTF8 integer varints
# ---------------------------------------------------------------------------


def itf8_decode(buf, off: int) -> tuple[int, int]:
    """Decode one ITF8 (signed int32) at buf[off]; returns (value, new_off)."""
    b0 = buf[off]
    if b0 < 0x80:
        v = b0
        off += 1
    elif b0 < 0xC0:
        v = ((b0 & 0x7F) << 8) | buf[off + 1]
        off += 2
    elif b0 < 0xE0:
        v = ((b0 & 0x3F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        off += 3
    elif b0 < 0xF0:
        v = ((b0 & 0x1F) << 24) | (buf[off + 1] << 16) | (buf[off + 2] << 8) | buf[off + 3]
        off += 4
    else:
        v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) | (buf[off + 2] << 12) | \
            (buf[off + 3] << 4) | (buf[off + 4] & 0x0F)
        off += 5
    if v & 0x80000000:
        v -= 1 << 32
    return v, off


def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes((v,))
    if v < 0x4000:
        return bytes((0x80 | (v >> 8), v & 0xFF))
    if v < 0x200000:
        return bytes((0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF))
    if v < 0x10000000:
        return bytes((0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))
    return bytes((0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F))


def ltf8_decode(buf, off: int) -> tuple[int, int]:
    """Decode one LTF8 (signed int64) at buf[off]; returns (value, new_off)."""
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[off + 1], off + 2
    if b0 < 0xE0:
        return ((b0 & 0x3F) << 16) | (buf[off + 1] << 8) | buf[off + 2], off + 3
    if b0 < 0xF0:
        v = ((b0 & 0x1F) << 24) | (buf[off + 1] << 16) | (buf[off + 2] << 8) | buf[off + 3]
        return v, off + 4
    n_extra = 4
    if b0 >= 0xF8:
        n_extra = 5
    if b0 >= 0xFC:
        n_extra = 6
    if b0 >= 0xFE:
        n_extra = 7
    if b0 >= 0xFF:
        n_extra = 8
    top_bits = {4: b0 & 0x07, 5: b0 & 0x03, 6: b0 & 0x01, 7: 0, 8: 0}[n_extra]
    v = top_bits
    for k in range(n_extra):
        v = (v << 8) | buf[off + 1 + k]
    if n_extra == 8:
        # full 64-bit payload; first prefix byte contributes nothing
        v &= (1 << 64) - 1
    if v & (1 << 63):
        v -= 1 << 64
    return v, off + 1 + n_extra


def ltf8_encode(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes((v,))
    if v < 0x4000:
        return bytes((0x80 | (v >> 8), v & 0xFF))
    if v < 0x200000:
        return bytes((0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF))
    if v < 0x10000000:
        return bytes((0xE0 | (v >> 24),)) + v.to_bytes(4, "big")[1:]
    if v < 0x8_0000_0000:
        return bytes((0xF0 | (v >> 32),)) + (v & 0xFFFFFFFF).to_bytes(4, "big")
    if v < 0x400_0000_0000:
        return bytes((0xF8 | (v >> 40),)) + (v & 0xFF_FFFFFFFF).to_bytes(5, "big")
    if v < 0x2_0000_0000_0000:
        return bytes((0xFC | (v >> 48),)) + (v & 0xFFFF_FFFFFFFF).to_bytes(6, "big")
    if v < 0x100_0000_0000_0000:
        return bytes((0xFE,)) + v.to_bytes(7, "big")
    return bytes((0xFF,)) + v.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0 codec 4)
# ---------------------------------------------------------------------------

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT          # 4096
RANS_BYTE_L = 1 << 23


def _normalize_freqs(counts: list[int], total_target: int = TOTFREQ) -> list[int]:
    """Scale symbol counts so they sum exactly to total_target, keeping
    every observed symbol's frequency >= 1."""
    total = sum(counts)
    if total == 0:
        return counts
    freqs = [0] * len(counts)
    used = [i for i, c in enumerate(counts) if c]
    acc = 0
    for i in used:
        f = max(1, (counts[i] * total_target) // total)
        freqs[i] = f
        acc += f
    # fix rounding drift on the most frequent symbol
    imax = max(used, key=lambda i: freqs[i])
    freqs[imax] += total_target - acc
    if freqs[imax] < 1:
        # pathological: too many rare symbols; redistribute deterministically
        deficit = 1 - freqs[imax]
        freqs[imax] = 1
        for i in used:
            while deficit > 0 and freqs[i] > 1:
                take = min(deficit, freqs[i] - 1)
                freqs[i] -= take
                deficit -= take
        if deficit > 0:
            raise ValueError("cannot normalize frequency table")
    return freqs


def _write_freqs_0(freqs: list[int]) -> bytearray:
    """Order-0 frequency table serialization (spec 13.5): symbol bytes with
    a run-length byte after the second of a consecutive run; frequencies
    as 1 byte (<128) or 2 bytes (0x80 | hi, lo); 0x00 terminator."""
    out = bytearray()
    rle = 0
    for j in range(256):
        if not freqs[j]:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and freqs[j - 1]:
                k = j + 1
                while k < 256 and freqs[k]:
                    k += 1
                rle = k - (j + 1)
                out.append(rle)
        f = freqs[j]
        if f < 128:
            out.append(f)
        else:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)
    return out


def _read_freqs_0(buf, off: int) -> tuple[list[int], list[int], int]:
    """Returns (freqs, cumulative, new_off)."""
    freqs = [0] * 256
    rle = 0
    j = buf[off]
    off += 1
    while True:
        f = buf[off]
        off += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | buf[off]
            off += 1
        freqs[j] = f
        if not rle and off < len(buf) and buf[off] == j + 1:
            j = buf[off]
            off += 1
            rle = buf[off]
            off += 1
        elif rle:
            rle -= 1
            j += 1
        else:
            j = buf[off]
            off += 1
            if j == 0:
                break
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    if cum[256] != TOTFREQ:
        # the 12-bit decode slots assume an exactly-normalized table;
        # reject corrupt/malicious tables instead of mis-decoding
        raise ValueError("rANS frequency table does not sum to 4096")
    return freqs, cum[:256], off


class _RansEncoder:
    """One rANS state emitting bytes backwards into a shared list."""
    __slots__ = ("x", "out")

    def __init__(self, out: list[int]):
        self.x = RANS_BYTE_L
        self.out = out  # bytes appended here are in REVERSE stream order

    def put(self, start: int, freq: int) -> None:
        x = self.x
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * freq
        while x >= x_max:
            self.out.append(x & 0xFF)
            x >>= 8
        self.x = ((x // freq) << TF_SHIFT) + (x % freq) + start


    def flush(self) -> None:
        # 4 bytes little-endian; appended in reverse stream order
        x = self.x
        self.out.append((x >> 24) & 0xFF)
        self.out.append((x >> 16) & 0xFF)
        self.out.append((x >> 8) & 0xFF)
        self.out.append(x & 0xFF)


def rans_encode(data: bytes, order: int = 0) -> bytes:
    """Compress with rANS 4x8. Output: 1-byte order, uint32le compressed
    size (frequency table + rANS stream), uint32le raw size, payload.

    The C implementation in csrc/host/bamcore.cc (io/native.py), which
    is bitstream-identical to rans_encode_plain, the pure-Python
    exactness reference; that one takes a stream the C encoder does
    not."""
    import ctypes
    from sniffles_tpu_torch.io import native
    n = len(data)
    if order == 1 and n < 4:
        order = 0
    cap = 9 + 2 * n + (257 * 771 if order else 771) + 64
    out = ctypes.create_string_buffer(cap)
    size = native.get_lib().bamcore_rans_compress(data, n, order, out, cap)
    if size > 0:
        return out.raw[:size]
    return rans_encode_plain(data, order)


def rans_encode_plain(data: bytes, order: int = 0) -> bytes:
    """rans_encode in pure Python."""
    n = len(data)
    if order == 1 and n < 4:
        order = 0
    if order == 0:
        payload = _rans_encode_0(data)
    else:
        payload = _rans_encode_1(data)
    return struct.pack("<BII", order, len(payload), n) + payload


def _rans_encode_0(data: bytes) -> bytes:
    n = len(data)
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freqs = _normalize_freqs(counts)
    cum = [0] * 256
    acc = 0
    for s in range(256):
        cum[s] = acc
        acc += freqs[s]
    table = _write_freqs_0(freqs)
    if n == 0:
        return bytes(table)

    rev: list[int] = []
    states = [_RansEncoder(rev) for _ in range(4)]
    # tail: positions not covered by the 4-aligned main loop
    i = n & 3
    if i >= 3:
        s = data[n - (i - 2)]
        states[2].put(cum[s], freqs[s])
    if i >= 2:
        s = data[n - (i - 1)]
        states[1].put(cum[s], freqs[s])
    if i >= 1:
        s = data[n - i]
        states[0].put(cum[s], freqs[s])
    i = n & ~3
    while i > 0:
        for k in (3, 2, 1, 0):
            s = data[i - 4 + k]
            states[k].put(cum[s], freqs[s])
        i -= 4
    for k in (3, 2, 1, 0):
        states[k].flush()
    rev.reverse()
    return bytes(table) + bytes(rev)


def _rans_decode_0(buf, out_size: int) -> bytearray:
    if out_size == 0:
        return bytearray()
    freqs, cum, off = _read_freqs_0(buf, 0)
    # symbol lookup per 12-bit slot
    ssym = bytearray(TOTFREQ)
    for s in range(256):
        f = freqs[s]
        if f:
            c = cum[s]
            for k in range(c, c + f):
                ssym[k] = s
    out = bytearray(out_size)
    if out_size == 0:
        return out
    x = list(struct.unpack_from("<4I", buf, off))
    off += 16
    nbuf = len(buf)
    mask = TOTFREQ - 1
    main = out_size & ~3
    i = 0
    while i < main:
        for k in range(4):
            xk = x[k]
            m = xk & mask
            s = ssym[m]
            out[i + k] = s
            xk = freqs[s] * (xk >> TF_SHIFT) + m - cum[s]
            while xk < RANS_BYTE_L and off < nbuf:
                xk = (xk << 8) | buf[off]
                off += 1
            x[k] = xk
        i += 4
    k = 0
    while i < out_size:
        xk = x[k]
        m = xk & mask
        s = ssym[m]
        out[i] = s
        xk = freqs[s] * (xk >> TF_SHIFT) + m - cum[s]
        while xk < RANS_BYTE_L and off < nbuf:
            xk = (xk << 8) | buf[off]
            off += 1
        x[k] = xk
        i += 1
        k += 1
    return out


def _rans_encode_1(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    counts = [None] * 256  # lazy per-context count rows
    totals = [0] * 256

    def bump(ctx: int, sym: int) -> None:
        row = counts[ctx]
        if row is None:
            row = counts[ctx] = [0] * 256
        row[sym] += 1
        totals[ctx] += 1

    for q in range(4):
        bump(0, data[q * isz4])
    for i in range(1, n):
        bump(data[i - 1], data[i])

    freqs = [None] * 256
    cums = [None] * 256
    table = bytearray()
    rle_i = 0
    for i in range(256):
        if not totals[i]:
            continue
        if rle_i:
            rle_i -= 1
        else:
            table.append(i)
            if i and totals[i - 1]:
                k = i + 1
                while k < 256 and totals[k]:
                    k += 1
                rle_i = k - (i + 1)
                table.append(rle_i)
        f = _normalize_freqs(counts[i])
        freqs[i] = f
        c = [0] * 256
        acc = 0
        for s in range(256):
            c[s] = acc
            acc += f[s]
        cums[i] = c
        table.extend(_write_freqs_0(f))
    table.append(0)

    rev: list[int] = []
    states = [_RansEncoder(rev) for _ in range(4)]
    # quarter boundaries; state k encodes data[k*isz4 : (k+1)*isz4),
    # state 3 additionally takes the remainder at the end
    i3 = n - 2
    l3 = data[n - 1] if n else 0
    while i3 > 4 * isz4 - 2:
        ctx = data[i3]
        states[3].put(cums[ctx][l3], freqs[ctx][l3])
        l3 = ctx
        i3 -= 1
    idx = [1 * isz4 - 2, 2 * isz4 - 2, 3 * isz4 - 2, i3]
    last = [data[idx[k] + 1] for k in range(4)]
    while idx[0] >= 0:
        for k in (3, 2, 1, 0):
            ctx = data[idx[k]]
            states[k].put(cums[ctx][last[k]], freqs[ctx][last[k]])
            last[k] = ctx
            idx[k] -= 1
    for k in (3, 2, 1, 0):
        states[k].put(cums[0][last[k]], freqs[0][last[k]])
    for k in (3, 2, 1, 0):
        states[k].flush()
    rev.reverse()
    return bytes(table) + bytes(rev)


def _rans_decode_1(buf, out_size: int) -> bytearray:
    if out_size == 0:
        return bytearray()
    freqs = [None] * 256
    cums = [None] * 256
    ssyms = [None] * 256
    off = 0
    rle_i = 0
    i = buf[off]
    off += 1
    while True:
        f, c, off = _read_freqs_0(buf, off)
        freqs[i] = f
        cums[i] = c
        lut = bytearray(TOTFREQ)
        for s in range(256):
            fs = f[s]
            if fs:
                base = c[s]
                for k in range(base, base + fs):
                    lut[k] = s
        ssyms[i] = lut
        if not rle_i and off < len(buf) and buf[off] == i + 1:
            i = buf[off]
            off += 1
            rle_i = buf[off]
            off += 1
        elif rle_i:
            rle_i -= 1
            i += 1
        else:
            i = buf[off]
            off += 1
            if i == 0:
                break

    out = bytearray(out_size)
    if out_size == 0:
        return out
    x = list(struct.unpack_from("<4I", buf, off))
    off += 16
    nbuf = len(buf)
    mask = TOTFREQ - 1
    isz4 = out_size >> 2
    pos = [0, isz4, 2 * isz4, 3 * isz4]
    last = [0, 0, 0, 0]
    for _ in range(isz4):
        for k in range(4):
            xk = x[k]
            m = xk & mask
            lk = last[k]
            s = ssyms[lk][m]
            out[pos[k]] = s
            pos[k] += 1
            xk = freqs[lk][s] * (xk >> TF_SHIFT) + m - cums[lk][s]
            while xk < RANS_BYTE_L and off < nbuf:
                xk = (xk << 8) | buf[off]
                off += 1
            x[k] = xk
            last[k] = s
    # remainder decoded by state 3
    while pos[3] < out_size:
        xk = x[3]
        m = xk & mask
        lk = last[3]
        s = ssyms[lk][m]
        out[pos[3]] = s
        pos[3] += 1
        xk = freqs[lk][s] * (xk >> TF_SHIFT) + m - cums[lk][s]
        while xk < RANS_BYTE_L and off < nbuf:
            xk = (xk << 8) | buf[off]
            off += 1
        x[3] = xk
        last[3] = s
    return out


def rans_decode(data: bytes) -> bytes:
    """Decompress rANS 4x8 with the C implementation in
    csrc/host/bamcore.cc (io/native.py); rans_decode_plain is its
    pure-Python exactness reference."""
    order, _comp_size, raw_size = struct.unpack_from("<BII", data, 0)
    if order not in (0, 1):
        raise ValueError(f"unknown rANS order {order}")
    import ctypes
    from sniffles_tpu_torch.io import native
    out = ctypes.create_string_buffer(max(1, raw_size))
    data_b = bytes(data) if not isinstance(data, bytes) else data
    size = native.get_lib().bamcore_rans_uncompress(data_b, len(data_b), out, raw_size)
    if size == raw_size:
        return out.raw[:raw_size]
    raise ValueError("native rANS decode failed")


def rans_decode_plain(data: bytes) -> bytes:
    """rans_decode in pure Python."""
    order, _comp_size, raw_size = struct.unpack_from("<BII", data, 0)
    payload = memoryview(data)[9:]
    if order == 0:
        return bytes(_rans_decode_0(payload, raw_size))
    if order == 1:
        return bytes(_rans_decode_1(payload, raw_size))
    raise ValueError(f"unknown rANS order {order}")


# ---------------------------------------------------------------------------
# Block compression method dispatch (CRAM 3.0 block header byte 0)
# ---------------------------------------------------------------------------

METHOD_RAW = 0
METHOD_GZIP = 1
METHOD_BZIP2 = 2
METHOD_LZMA = 3
METHOD_RANS = 4
METHOD_RANS_NX16 = 5   # CRAM 3.1
METHOD_ARITH = 6       # CRAM 3.1
METHOD_FQZCOMP = 7     # CRAM 3.1
METHOD_TOK3 = 8        # CRAM 3.1


def compress_block(data: bytes, method: int, rans_order: int = 0) -> bytes:
    if method == METHOD_RAW:
        return data
    if method == METHOD_GZIP:
        # compressobj: zlib.compress only grew a wbits argument in 3.11,
        # and pyproject supports 3.10
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        return co.compress(data) + co.flush()
    if method == METHOD_BZIP2:
        return bz2.compress(data)
    if method == METHOD_LZMA:
        return lzma.compress(data)
    if method == METHOD_RANS:
        return rans_encode(data, rans_order)
    if method == METHOD_RANS_NX16:
        from sniffles_tpu_torch.io.cram31 import rans_nx16_encode
        return rans_nx16_encode(data, rans_order)  # rans_order carries Nx16 flags
    if method == METHOD_ARITH:
        from sniffles_tpu_torch.io.cram31 import arith_encode
        return arith_encode(data, rans_order)
    if method == METHOD_TOK3:
        from sniffles_tpu_torch.io.cram31 import tok3_encode
        return tok3_encode(data)
    raise ValueError(f"unsupported CRAM compression method {method}")


def decompress_block(data: bytes, method: int, raw_size: int) -> bytes:
    if method == METHOD_RAW:
        return data
    if method == METHOD_GZIP:
        return zlib.decompress(data, wbits=47)
    if method == METHOD_BZIP2:
        return bz2.decompress(data)
    if method == METHOD_LZMA:
        return lzma.decompress(data)
    if method == METHOD_RANS:
        out = rans_decode(data)
        if len(out) != raw_size:
            raise ValueError("rANS raw size mismatch")
        return out
    if method == METHOD_RANS_NX16:
        from sniffles_tpu_torch.io.cram31 import rans_nx16_decode
        out = rans_nx16_decode(data, expected_len=raw_size)
        if len(out) != raw_size:
            raise ValueError("rANS Nx16 raw size mismatch")
        return out
    if method == METHOD_ARITH:
        from sniffles_tpu_torch.io.cram31 import arith_decode
        out = arith_decode(data, expected_len=raw_size)
        if len(out) != raw_size:
            raise ValueError("arith raw size mismatch")
        return out
    if method == METHOD_FQZCOMP:
        from sniffles_tpu_torch.io.cram31 import fqzcomp_decode
        out = fqzcomp_decode(data)
        if len(out) != raw_size:
            raise ValueError("fqzcomp raw size mismatch")
        return out
    if method == METHOD_TOK3:
        from sniffles_tpu_torch.io.cram31 import tok3_decode
        out = tok3_decode(data)
        if len(out) != raw_size:
            raise ValueError("tok3 raw size mismatch")
        return out
    raise ValueError(f"unsupported CRAM compression method {method}")
