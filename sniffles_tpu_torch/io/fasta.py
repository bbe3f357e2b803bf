"""
FASTA random access with .fai index (pysam.FastaFile work-alike).

Used for DEL sequence resolution and anchor bases in VCF output
(reference: vcf.py:108-119, 304-342). Supports plain FASTA; generates a
.fai on demand like pysam.faidx. Copied from sniffles_tpu/io/fasta.py.
"""
from __future__ import annotations

import os
from typing import Optional


def build_fai(path: str) -> str:
    """Generate a .fai index for a plain FASTA file; returns index path."""
    fai_path = path + ".fai"
    entries = []
    with open(path, "rb") as f:
        name = None
        seq_len = 0
        seq_offset = 0
        line_blen = 0
        line_len = 0
        offset = 0
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, seq_len, seq_offset, line_blen, line_len))
                name = line[1:].split()[0].decode("ascii")
                offset += len(line)
                seq_offset = offset
                seq_len = 0
                line_blen = 0
                line_len = 0
            else:
                blen = len(line.rstrip(b"\r\n"))
                if line_blen == 0:
                    line_blen = blen
                    line_len = len(line)
                seq_len += blen
                offset += len(line)
        if name is not None:
            entries.append((name, seq_len, seq_offset, line_blen, line_len))
    with open(fai_path, "w") as f:
        for name, ln, off, bl, ll in entries:
            f.write(f"{name}\t{ln}\t{off}\t{bl}\t{ll}\n")
    return fai_path


class FastaFile:
    """Random-access FASTA reader via .fai index."""

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path)
        self._index: dict[str, tuple[int, int, int, int]] = {}
        self.references: list[str] = []
        with open(fai) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                name, ln, off, bl, ll = parts[0], int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4])
                self._index[name] = (ln, off, bl, ll)
                self.references.append(name)
        self._handle = open(path, "rb")

    def fetch(self, reference: str, start: Optional[int] = None,
              end: Optional[int] = None) -> str:
        if reference not in self._index:
            raise KeyError(reference)
        ln, off, bl, ll = self._index[reference]
        if start is None:
            start = 0
        if end is None:
            end = ln
        start = max(0, start)
        end = min(ln, end)
        if end <= start:
            raise ValueError(f"Invalid region {reference}:{start}-{end}")
        byte_start = off + (start // bl) * ll + (start % bl)
        byte_end = off + ((end - 1) // bl) * ll + ((end - 1) % bl) + 1
        self._handle.seek(byte_start)
        raw = self._handle.read(byte_end - byte_start)
        # Case is preserved (soft-masked references stay lowercase), matching
        # pysam.FastaFile.fetch semantics relied on by the reference caller.
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii")

    def close(self) -> None:
        self._handle.close()
