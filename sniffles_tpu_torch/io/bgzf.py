"""
BGZF (blocked gzip) reader/writer.

The reference delegates BGZF to htslib via pysam (reference:
leadprov.py:96-98 uses pysam.AlignmentFile). This environment has no
htslib, so sniffles-tpu ships its own implementation: a pure-Python
zlib-based codec. Copied from sniffles_tpu/io/bgzf.py.

Virtual file offsets follow the htslib convention:
    voffset = compressed_block_offset << 16 | within_block_offset
"""
from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Optional

BGZF_HEADER = b"\x1f\x8b\x08\x04"
# Fixed 18-byte BGZF member header template; BSIZE filled per block
_BLOCK_HEADER = struct.Struct("<4sBBBBIBBHBBHH")
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")

MAX_BLOCK_SIZE = 65536


def _read_block_at(raw: bytes, coffset: int) -> tuple[bytes, int]:
    """Decompress the BGZF block starting at coffset; returns (data, next_coffset)."""
    if coffset >= len(raw):
        return b"", coffset
    # Parse gzip member header with FEXTRA to find BSIZE
    if raw[coffset:coffset + 4] != BGZF_HEADER:
        raise ValueError(f"Not a BGZF block at offset {coffset}")
    xlen = struct.unpack_from("<H", raw, coffset + 10)[0]
    extra = raw[coffset + 12:coffset + 12 + xlen]
    bsize = None
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
        if si1 == 66 and si2 == 67:  # 'B','C'
            bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            break
        i += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing BC subfield")
    cdata_start = coffset + 12 + xlen
    cdata_end = coffset + bsize - 8
    data = zlib.decompress(raw[cdata_start:cdata_end], wbits=-15)
    return data, coffset + bsize


class BGZFReader:
    """
    Random-access BGZF reader over an in-memory or mmap'ed file.

    Supports sequential read() and seek() by virtual offset, with a
    small decompressed-block cache.
    """

    def __init__(self, data: bytes):
        self._raw = data
        self._coffset = 0         # compressed offset of current block
        self._block: bytes = b""
        self._block_next = 0      # compressed offset of next block
        self._within = 0          # offset within current decompressed block
        self._cache: dict[int, tuple[bytes, int]] = {}
        self._load_block(0)

    @classmethod
    def from_file(cls, path: str) -> "BGZFReader":
        """Memory-map the file: random access without loading it (a 30x
        genome BAM is ~100 GB; htslib seeks, so must we)."""
        import mmap
        f = open(path, "rb")
        try:
            raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            raw = b""
        return cls(raw)

    def _load_block(self, coffset: int) -> None:
        cached = self._cache.get(coffset)
        if cached is None:
            cached = _read_block_at(self._raw, coffset)
            if len(self._cache) > 64:
                self._cache.clear()
            self._cache[coffset] = cached
        self._block, self._block_next = cached
        self._coffset = coffset
        self._within = 0

    def tell(self) -> int:
        # Canonical form: an offset at the end of a block is reported as the
        # start of the next block, matching htslib voffsets so that values
        # are comparable with index chunk bounds.
        if self._within >= len(self._block) and self._block_next < len(self._raw):
            return self._block_next << 16
        return (self._coffset << 16) | self._within

    def seek(self, voffset: int) -> None:
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        if coffset != self._coffset:
            self._load_block(coffset)
        self._within = within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block) - self._within
            if avail == 0:
                if self._block_next >= len(self._raw):
                    break
                self._load_block(self._block_next)
                if len(self._block) == 0 and self._block_next >= len(self._raw):
                    break
                continue
            take = min(avail, n)
            out += self._block[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_all_from(self, voffset: int = 0) -> bytes:
        """Decompress everything from voffset to EOF (streaming use)."""
        self.seek(voffset)
        chunks = [self._block[self._within:]]
        coff = self._block_next
        while coff < len(self._raw):
            data, coff = _read_block_at(self._raw, coff)
            chunks.append(data)
        self._within = len(self._block)
        self._block_next = len(self._raw)
        return b"".join(chunks)


def decompress_all(path: str) -> bytes:
    """Decompress a whole BGZF file into one bytes object."""
    return BGZFReader.from_file(path).read_all_from(0)


class BGZFWriter:
    """BGZF writer producing ~64KB independently-compressed blocks."""

    def __init__(self, handle: BinaryIO, compresslevel: int = 6):
        self.handle = handle
        self.level = compresslevel
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes written so far

    def tell(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, data: bytes) -> None:
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        crc = zlib.crc32(data) & 0xFFFFFFFF
        # BSIZE = total block length - 1; block = 18B header + cdata + 8B trailer
        header = (BGZF_HEADER + b"\x00\x00\x00\x00\x00\xff\x06\x00" + b"BC" + b"\x02\x00"
                  + struct.pack("<H", len(cdata) + 25))
        block = header + cdata + struct.pack("<II", crc, len(data) & 0xFFFFFFFF)
        self.handle.write(block)
        self._coffset += len(block)

    def flush(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self.handle.write(BGZF_EOF)
        self._coffset += len(BGZF_EOF)
        self.handle.flush()
