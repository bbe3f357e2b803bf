"""Result transport: task results, each knowing how to emit itself into
the output VCF/SNF (reference: result.py:23-299). Copied from
sniffles_tpu/pipeline/result.py.
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


class CallResult(Result):
    """call_sample result: calls + optional per-task temp-SNF metadata and
    candidate CSV (reference: result.py:68-110)."""

    coverage_average_total: float
    candidate_filename = None
    # per-task device engine-stat consumption split, set by
    # CallTask.execute; None on host-path runs
    engine_counters: dict = None

    # temp-SNF part metadata (set by CallTask when --snf is active)
    has_snf = False
    snf_filename = snf_index = None
    snf_total_length = snf_candidate_count = None

    @staticmethod
    def _write_csv_rows(handle, candidates, attr):
        for cand in candidates:
            row = getattr(cand, attr)
            if not row:
                continue
            try:
                handle.write(','.join(row) + '\n')
            except Exception:
                kind = ' for single break' if attr == 'csv_line_single' else ''
                log.exception(f'Error writing CSV line{kind} for {cand}')

    def store_candidates(self, candidates: list[SVCall]) -> None:
        cfg = SnifflesConfig.GLOBAL
        if not cfg.dev_output_candidates:
            return
        self.candidate_filename = os.path.join(
            cfg.tmp_dir, f'candidates.tmp-{self.run_id}-{self.task_id}.csv')
        with open(self.candidate_filename, "w") as f:
            self._write_csv_rows(f, candidates, 'csv_line')
            self._write_csv_rows(f, candidates, 'csv_line_single')

    def emit(self, **kwargs) -> int:
        written = super().emit(**kwargs)
        if snf_out := kwargs.get('snf_out'):
            snf_out.add_result(self)
        return written


class GenotypeResult(Result):
    """Force-calling result: re-emits the input VCF's lines in input order
    with refreshed genotype columns (reference: result.py:113-130)."""

    def emit(self, vcf_out=None, snf_out=None, **kwargs) -> int:
        if vcf_out is not None:
            by_line = {call.raw_vcf_line_index: call for call in self.svcalls}
            for lineindex in kwargs['genotype_lineindex_order']:
                if lineindex in by_line:
                    vcf_out.rewrite_genotype(by_line[lineindex])
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


class CombineResultTmpFilePopulationSNF(CombineResultTmpFile):
    """Tmp-file combine result that additionally builds a per-task
    population-SNF part (reference: result.py:245-285)."""

    has_snf = True
    snf_candidate_count: int = 0
    snf_index: dict
    snf_total_length: int
    svcalls: list = None

    @property
    def snf_filename(self) -> str:
        return os.path.join(SnifflesConfig.GLOBAL.tmp_dir,
                            f'result-{self.run_id}-{self.task_id:04}.part.snf')

    def store_calls(self, svcalls: list[SVCall]) -> None:
        super().store_calls(svcalls)
        self.svcalls = (self.svcalls or []) + list(svcalls)

    def finalize(self):
        from sniffles_tpu_torch.io.snfp import PopulationSNF
        with open(self.snf_filename, 'wb') as handle:
            psnf = PopulationSNF(SnifflesConfig.GLOBAL, handle)
            stored = sum(1 for call in self.svcalls if psnf.store(call))
            psnf.write_and_index()
        self.snf_index = psnf.get_index()
        self.snf_total_length = psnf.get_total_length()
        self.snf_candidate_count = stored

    def emit(self, vcf_out=None, **kwargs) -> int:
        written = super().emit(vcf_out=vcf_out, **kwargs)
        if psnf_out := kwargs.get('psnf_out'):
            psnf_out.add_result(self)
        return written


class ErrorResult:
    """Worker-side failure marker; emitting just logs the error (the CLI
    exits non-zero when any task ended in one)."""
    error = True

    def __init__(self, msg: str):
        self.message = msg

    def __str__(self):
        return str(self.message)

    def emit(self, **kwargs) -> int:
        log.error(str(self.message))
        return 0
