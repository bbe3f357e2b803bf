"""Result transport: task results, each knowing how to emit itself into
the output VCF (reference: result.py:23-299). Copied from
sniffles_tpu/pipeline/result.py: the combine results; the call-path,
force-calling and population-SNF results are not part of the combine
slice.
"""
from __future__ import annotations

import logging
import os

from sniffles_tpu_torch.config import SnifflesConfig
from sniffles_tpu_torch.svcall import SVCall

log = logging.getLogger(__name__)


class Result:
    """Base task result: carries calls and emits them in order
    (reference: result.py:23-65)."""

    error: bool = False

    def __init__(self, task, svcalls: list[SVCall], candidates_processed: int):
        self.task_id, self.contig = task.id, task.contig
        self.run_id = task.config.run_id
        self.processed_read_count = candidates_processed
        self.svcount = len(svcalls)
        self.store_calls(svcalls)

    def store_calls(self, svcalls: list[SVCall]) -> None:
        self.svcalls = svcalls

    def emit(self, vcf_out=None, **kwargs) -> int:
        if vcf_out is None:
            return 0
        for call in self.svcalls:
            vcf_out.write_call(call)
        return len(self.svcalls)


class CombineResult(Result):
    """Multi-sample result held in memory, kept sorted by position
    (reference: result.py:133-161)."""

    def store_calls(self, svcalls: list[SVCall]) -> None:
        batch = (sorted(svcalls, key=lambda call: call.pos)
                 if SnifflesConfig.GLOBAL.sort else svcalls)
        try:
            self.svcalls.extend(batch)
        except AttributeError:
            self.svcalls = list(batch)

    def finalize(self):
        if SnifflesConfig.GLOBAL.sort:
            self.svcalls.sort(key=lambda call: call.pos)

    def __str__(self):
        return f'CombineResult #{self.task_id}'


class CombineResultTmpFile(CombineResult):
    """Multi-sample result spilled to a per-task part-VCF so >20-sample
    merges don't hold all calls in memory; out-of-order late calls go to a
    separate unsorted spill (reference: result.py:164-242)."""

    _highest_position_call: int = -1
    unsorted: bool = False
    _initialized: bool = False

    def _part_path(self, tag: str = "") -> str:
        return os.path.join(SnifflesConfig.GLOBAL.tmp_dir,
                            f'result-{self.run_id}-{self.task_id:04}{tag}.part.vcf')

    @property
    def tmpfile_name(self) -> str:
        return self._part_path()

    @property
    def tmpfile_unsorted(self) -> str:
        return self._part_path("-unsorted")

    def store_calls(self, svcalls):
        from sniffles_tpu_torch.io.vcf import VCF
        config = SnifflesConfig.GLOBAL
        late = 0

        if not self._initialized:
            if os.path.exists(self.tmpfile_name):
                self.cleanup()
            self._initialized = True

        if config.sort and svcalls:
            svcalls = sorted(svcalls, key=lambda call: call.pos)
            # calls before the frontier of the previous batch would break
            # the part file's ordering; divert them
            while late < len(svcalls) and svcalls[late].pos < self._highest_position_call:
                log.debug(f'Unsorted call detected: {self._highest_position_call} > {svcalls[0]}')
                late += 1
            if late:
                self.unsorted = True
                with open(self.tmpfile_unsorted, 'a') as f:
                    spill = VCF(config, f)
                    for call in svcalls[:late]:
                        spill.write_call(call)
            self._highest_position_call = svcalls[-1].pos

        with open(self.tmpfile_name, 'a') as f:
            part = VCF(config, f)
            part.open_reference(generate_index=False)
            for call in svcalls[late:]:
                part.write_call(call)

    def finalize(self):
        ...

    def emit(self, vcf_out=None, **kwargs) -> int:
        lines = 0
        try:
            with open(self.tmpfile_name, 'r') as f:
                for line in f:
                    vcf_out.handle.write(line)
                    lines += 1
        except FileNotFoundError:
            pass
        vcf_out.call_count += lines
        self.cleanup()
        return lines

    def cleanup(self):
        try:
            os.unlink(self.tmpfile_name)
        except FileNotFoundError:
            ...
