"""SNF candidate-file format (binary intermediate for multi-sample calling).

On-disk layout is kept wire-compatible with the reference format
(reference: snf.py:29-287): a JSON header line
{config, index, snf_candidate_count} followed by gzip-compressed pickled
blocks of 10^5 bp keyed [contig][block_start] -> [(offset, len)], with
per-block downsampled coverage in a "_COVERAGE" sub-dict.  A renaming
unpickler loads reference-written SNF blocks into the equivalent
sniffles_tpu classes.
"""
from __future__ import annotations

import gzip
import io
import json
import logging
import os
import pickle
from functools import cached_property
from typing import Optional

import numpy as np

from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.config import SnifflesConfig

log = logging.getLogger(__name__)

# First build whose SNF files need no re-QC (reference: snf.py:68-81).
_REQC_BUILD_FLOOR = '2.5.3'

# SNF files written by the reference implementation pickle its class
# paths; remap them so reference-generated .snf inputs load into the
# equivalent sniffles_tpu classes (field layouts mirror the reference).
_MODULE_RENAMES = {
    "sniffles.sv": "sniffles_tpu_torch.svcall",
    "sniffles.leadprov": "sniffles_tpu_torch.leads",
    "sniffles.cluster": "sniffles_tpu_torch.cluster",
    "sniffles.snfp": "sniffles_tpu_torch.io.snfp",
    "sniffles.region": "sniffles_tpu_torch.region",
}

_FIND_CLASS_CACHE: dict = {}


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _FIND_CLASS_CACHE.get((module, name))
        if cls is None:
            cls = super().find_class(_MODULE_RENAMES.get(module, module), name)
            _FIND_CLASS_CACHE[(module, name)] = cls
        return cls


def _compat_loads(data: bytes):
    return _CompatUnpickler(io.BytesIO(data)).load()


def _empty_block() -> dict:
    block = {svtype: [] for svtype in sv.TYPES}
    block["_COVERAGE"] = {}
    return block


class SNFileBase:
    """One SNF file bound to a handle, for writing (store/write_and_index),
    assembling (write_results) or random-access reading (read_blocks)
    (reference: snf.py:29-245)."""

    header_length: int
    _header: Optional[dict]

    def __init__(self, config: SnifflesConfig, handle, filename=None):
        self.config, self.handle, self.filename = config, handle, filename
        self.blocks = {}
        self.total_length = 0
        self._header, self._index, self._results = None, {}, []

    @classmethod
    def open(cls, filename: str) -> 'SNFileBase':
        snf = cls(SnifflesConfig.GLOBAL, open(filename, 'rb'), filename)
        snf.read_header()
        return snf

    # -- handle lifecycle --------------------------------------------------

    def is_open(self) -> bool:
        return self.handle is not False

    def _open(self):
        if self.is_open():
            self.close()
        self.handle = open(self.filename, "rb")

    def _ensure_open(self):
        if not self.is_open():
            self._open()

    def _release(self):
        """Drop the handle after each access when merging more samples than
        the OS allows open files for (--combine-close-handles)."""
        if self.config.combine_close_handles:
            self.close()

    def close(self) -> None:
        if self.is_open():
            self.handle.close()
            self.handle = False

    # -- header / metadata -------------------------------------------------

    index = property(lambda self: self._index)
    header = property(lambda self: self._header)

    @cached_property
    def reqc(self) -> bool:
        """Whether candidates loaded from this file must be re-QCed
        (files from builds before 2.5.3) (reference: snf.py:68-81)."""
        if self.config.reqc != 'auto':
            return self.config.reqc
        try:
            build = self.header['config']['build'].partition('-')[0]
        except (KeyError, AttributeError):
            log.warning(f'Unable to determine version of SNF file {self.filename} for auto-reqc')
            return True
        return build < _REQC_BUILD_FLOOR

    def read_header(self):
        self._ensure_open()
        try:
            line = self.handle.readline()
            self.header_length = len(line)
            self._header = json.loads(line.strip())
        except Exception as e:
            print(f"Error when reading SNF header from '{self.filename}': {e}. The file may "
                  f"not be a valid .snf file or could have been corrupted.")
            raise e
        self._index = self._header["index"]
        self._release()

    # -- block storage (writer side) ---------------------------------------

    def store(self, svcand):
        base = int(svcand.pos / self.config.snf_block_size) * self.config.snf_block_size
        block = self.blocks.get(base)
        if block is None:
            block = self.blocks[base] = _empty_block()
        if not self.config.output_rnames:
            svcand.rnames = None
        if svcand.svtype in sv.TYPES:
            block[svcand.svtype].append(svcand)

    def serialize_block(self, block_id):
        return pickle.dumps(self.blocks[block_id])

    def unserialize_block(self, data: bytes):
        return _compat_loads(data)

    def write_and_index(self):
        self._ensure_open()
        offset = 0
        for block_id in sorted(self.blocks):
            payload = gzip.compress(self.serialize_block(block_id))
            self.handle.write(payload)
            self._index[block_id] = (offset, len(payload))
            offset += len(payload)
            self.total_length += len(payload)
        self._release()

    # -- block access (reader side) ----------------------------------------

    def read_blocks(self, contig, block_index):
        self._ensure_open()
        spans = None
        if contig in self.index:
            spans = self.index[contig].get(str(block_index))
        if spans is None:
            self._release()
            return None

        loaded = []
        for span_offset, span_length in spans:
            try:
                self.handle.seek(self.header_length + span_offset)
                raw = gzip.decompress(self.handle.read(span_length))
                loaded.append(self.unserialize_block(raw))
            except Exception as e:
                print(f"Error when reading block '{contig}.{block_index}' from "
                      f"'{self.filename}': {e}.")
                self._release()
                raise e
        self._release()
        return loaded

    def get_index(self):
        return self.index

    def get_total_length(self):
        return self.total_length

    def get_all_blocks(self, contig: str) -> dict:
        if contig not in self.index:
            return {}
        return {start: self.read_blocks(contig, start)[0]
                for start in self.index[contig]}

    def get_full_coverage(self, contig: str):
        coverage = {}
        for block in self.get_all_blocks(contig).values():
            coverage.update(block['_COVERAGE'])
        return coverage

    # -- final assembly from per-task temp SNFs ----------------------------

    def add_result(self, result):
        if result.has_snf:
            self._results.append(result)

    def _calculate_contig_coverages(self, contigs: list[str]) -> dict[str, float]:
        per_contig: dict[str, list[float]] = {c: [] for c in contigs}
        for r in self._results:
            per_contig[r.contig].append(r.coverage_average_total)
        return {contig: (sum(vals) / len(vals) if vals else 0)
                for contig, vals in per_contig.items()}

    def _create_header(self, config: SnifflesConfig, main_index: dict, snf_candidate_count: int) -> dict:
        return {"config": config.__dict__, "index": main_index,
                "snf_candidate_count": snf_candidate_count}

    def write_header(self, config: SnifflesConfig, main_index: dict,
                     snf_candidate_count: int) -> None:
        """The JSON header line; block payloads follow it, at the offsets
        main_index gives relative to the end of this line
        (reference: snf.py:194-224)."""
        header = self._create_header(config, main_index, snf_candidate_count)
        self.handle.write(
            (json.dumps(header, default=lambda obj: "<Unstored_Object>") + "\n").encode())

    def write_results(self, config: SnifflesConfig, contigs: list[str]) -> int:
        """Concatenate the per-task temp SNFs in task order, rebasing each
        part's block offsets by the bytes written before it
        (reference: snf.py:194-224)."""
        parts = sorted(self._results, key=lambda r: r.task_id)
        candidate_count = sum(r.snf_candidate_count for r in self._results)

        merged_index: dict = {}
        rebase = 0
        for part in parts:
            contig_index = merged_index.setdefault(part.contig, {})
            for block, (start, length) in part.snf_index.items():
                contig_index.setdefault(block, []).append((start + rebase, length))
            rebase += part.snf_total_length

        config.contig_coverages = self._calculate_contig_coverages(contigs)
        self.write_header(config, merged_index, candidate_count)

        for part in parts:
            with open(part.snf_filename, "rb") as part_handle:
                self.handle.write(part_handle.read())
            os.remove(part.snf_filename)

        return candidate_count


class SNFile(SNFileBase):
    def annotate_block_coverages(self, lead_provider):
        """Add downsampled (500bp-mean) coverage to all stored blocks
        (reference: snf.py:249-267)."""
        window = self.config.coverage_binsize_combine
        block_size = self.config.snf_block_size
        samples_per_block = block_size // window

        # The reference (snf.py:258) pads and downsamples the FULL contig
        # coverage array per task, to then read back only the blocks that
        # hold candidates. Blocks are exact multiples of the coverage bin
        # (10^5 / 500), so windows never straddle blocks and per-block
        # slices are numerically identical.
        assert block_size % window == 0
        track = lead_provider.coverage
        for base in self.blocks:
            chunk = track[base:base + block_size]
            if len(chunk) == 0:
                continue
            tail = -len(chunk) % window
            if tail:
                chunk = np.pad(chunk, (0, tail), mode='constant')
            means = chunk.reshape(-1, window).mean(axis=1)
            depth_map = self.blocks[base]['_COVERAGE']
            for i in range(min(samples_per_block, len(means))):
                depth_map[base + i * window] = round(means[i])
