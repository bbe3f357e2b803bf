"""CLI entry point for the combine mode, organized as a pipeline of stages:
mode detection, input validation, output opening, task planning, inline
execution, and ordered result emission (reference:
src/sniffles/sniffles:64-650).

Copied from sniffles_tpu/cli.py, combine mode only. The other run modes
and the options this slice has not ported stop with an error that says
so. The device path (on unless --no-tpu) runs on the card, or on the
CPU when SNIFFLES_TPU_FORCE_CPU=1 asks for it (config.torch_device).
"""
from __future__ import annotations

import logging.config
import logging
import os
import time
import sys
from collections import deque
from typing import Optional

from sniffles_tpu_torch import util
from sniffles_tpu_torch.config import SnifflesConfig, torch_device

log = logging.getLogger('sniffles_tpu_torch.main')


def _not_ported(what: str) -> None:
    util.fatal_error_main(f"{what} is not yet ported to sniffles_tpu_torch; "
                         f"use the sniffles_tpu package for it")


# --------------------------------------------------------------------------
# Stage 1: mode detection + input validation


def _detect_mode(config: SnifflesConfig) -> list[str]:
    """Choose the run mode from the input file extensions; returns the
    lowercased extension list (reference: sniffles:98-129)."""
    exts = [name.rsplit(".", 1)[-1].lower() for name in config.input]
    distinct = set(exts)
    if len(distinct) > 1:
        util.fatal_error_main(
            "Please specify either: A single .bam/.cram file - OR - one or more .snf files - OR "
            "- a single .tsv file containing a list of .snf files and optional sample ids as "
            f"input. (supplied were: {list(distinct)})")

    if distinct & {"bam", "cram"}:
        _not_ported("The call_sample and genotype_vcf modes (.bam/.cram input)")
    elif distinct & {"snf", "tsv"}:
        config.mode = "combine"
    else:
        util.fatal_error_main(
            "Failed to determine run mode from input. Please specify either: A single .bam file "
            "- OR - one or more .snf files - OR - a single .tsv file as input.")

    if config.snf is not None:
        util.fatal_error_main(f"--snf cannot be used with run mode {config.mode}")
    if config.vcf is None:
        util.fatal_error_main("Please specify at least one of: --vcf or --snf for output")

    config.sample_id = None
    config.sample_ids_vcf = [(0, "CONSENSUS")] if config.combine_consensus else []
    return exts


def _refuse_unported(config: SnifflesConfig) -> None:
    """Options of the combine mode that this slice has not ported."""
    if config.vcf_output_bgz:
        _not_ported(".vcf.gz (bgzip + tabix) output")
    if config.combine_population or config.dev_population_snf:
        _not_ported("Population SNF input/output")
    if int(config.tpu_mesh or 0) > 1:
        _not_ported("--tpu-mesh")
    if config.dev_monitor_memory:
        _not_ported("--dev-monitor-memory")
    if config.threads and config.tpu_combine:
        _not_ported("--threads N with the device path (the parent-owned device "
                    "service); use --threads 0, or --no-tpu for the host path,")


# --------------------------------------------------------------------------
# Stage 2: outputs


def _guard_overwrite(path: str, config, what: str = "Output file"):
    if os.path.exists(path) and not config.allow_overwrite:
        util.fatal_error_main(f"{what} '{path}' already exists! Use "
                              f"--allow-overwrite to ignore this check.")


def _open_vcf_out(config: SnifflesConfig):
    from sniffles_tpu_torch.io import vcf as vcfmod
    _guard_overwrite(config.vcf, config)
    parent_dir = os.path.dirname(os.path.abspath(config.uncompressed_vcf_name))
    if not os.path.exists(parent_dir):
        util.fatal_error_main(f"Directory {parent_dir} does not exist.")

    vcf_out = vcfmod.VCF(config, open(config.uncompressed_vcf_name, "w"))
    vcf_out.open_reference()
    log.info(f"Opening for writing: {config.vcf}")
    return vcf_out


# --------------------------------------------------------------------------
# Stage 3: task planning


def _resolve_snf_inputs(config, exts) -> list[tuple[str, Optional[str]]]:
    """The .snf file list, either given directly or via a .tsv sample
    sheet (reference: sniffles:380-404)."""
    if len(config.input) == 1 and exts[0] == "tsv":
        pairs = []
        with open(config.input[0], "r") as sheet:
            for line_no, line in enumerate(sheet.readlines()):
                row = line.strip()
                if not row or row.startswith("#"):
                    continue
                cols = row.split("\t")
                if len(cols) in (1, 2):
                    pairs.append((cols[0], cols[1] if len(cols) == 2 else None))
                else:
                    util.fatal_error_main(
                        f"Invalid sample list .tsv: {config.input[0]}: Line {line_no + 1}")
        return pairs
    if exts[0] == "snf":
        return [(item, None) for item in config.input]
    util.fatal_error_main("Failed to determine .snf files to be combined.")


def _plan_combine_tasks(config, exts, start_task_id):
    """Validate input SNFs, register sample ids, and scatter per-contig
    combine tasks (reference: sniffles:406-483)."""
    from sniffles_tpu_torch.io import snf as snfmod
    from sniffles_tpu_torch.pipeline import tasks as taskmod

    config.snf_input_info = []
    inputs = _resolve_snf_inputs(config, exts)

    contig_lengths = []
    for internal_id, (filename, sample_id) in enumerate(inputs):
        snf_in = snfmod.SNFile(config, open(filename, "rb"), filename=filename)
        snf_in.read_header()
        snf_config = snf_in.header["config"]
        # NB like the reference, the last input's contig table wins
        contig_lengths = snf_config["contig_lengths"]
        if not config.dev_skip_snf_validation:
            if config.snf_block_size != snf_config["snf_block_size"]:
                util.fatal_error_main(f"SNF block size differs for {filename}")
            if config.snf_format_version != snf_config["snf_format_version"]:
                util.fatal_error_main(f"SNF format version for {filename} is not supported")
        if sample_id is None:
            sample_id = (snf_config["sample_id"] if snf_config["sample_id"] is not None
                         else os.path.splitext(os.path.basename(filename))[0])
        config.snf_input_info.append({"internal_id": internal_id, "sample_id": sample_id,
                                      "filename": filename})
        snf_in.close()
        log.info(f"    {filename} (sample ID in output VCF='{sample_id}')")

    if not config.combine_consensus:
        config.sample_ids_vcf.extend(
            (info["internal_id"], info["sample_id"]) for info in config.snf_input_info)

    if wanted := (config.contig or config.regions_by_contig):
        contig_lengths = [(name, length) for name, length in contig_lengths
                          if name in wanted]

    result_class = None
    if len(inputs) > config.combine_max_inmemory_results:
        from sniffles_tpu_torch.pipeline.result import CombineResultTmpFile
        result_class = CombineResultTmpFile

    tasks = deque()
    task_id = start_task_id
    for contig, length in contig_lengths:
        combine = taskmod.CombineTask(
            id=task_id, contig=contig, start=0, end=length - 1,
            assigned_process_id=None, sv_id=0, config=config,
            result_class=result_class,
            regions=config.regions_by_contig.get(contig))
        tasks.extend(combine.scatter())
        task_id = tasks[-1].id + 1
    return tasks, contig_lengths


# --------------------------------------------------------------------------
# Stage 4: execution + emission


def _run_pool(config, tasks, processes):
    """Run every task inline (reference: sniffles:495-542). Without the
    device path, --threads N runs inline too: the worker pool is not
    ported, and its output is the inline output by construction."""
    from sniffles_tpu_torch.pipeline import runtime
    processes.append(runtime.SnifflesParentWorker(config=config, tasks=tasks))

    started = time.monotonic()
    while any([p.run_parent() for p in processes if p.running]):
        time.sleep(0.01)

    finished_tasks = []
    for p in processes:
        p.finalize()
        finished_tasks.extend(p.finished_tasks)
    log.info(f"Analysis took {time.monotonic() - started:.2f}s.")

    # Deterministic emission in task-id order (reference: sniffles:544-547)
    finished_tasks.sort(key=lambda task: task.id)
    _report_engine_counters(finished_tasks)
    return finished_tasks


def _report_engine_counters(finished_tasks) -> None:
    """Aggregate the per-task combine counters (device greedy dispatches,
    flagged segments, edit-distance batch routes) across the run; logged,
    and written as JSON when SNIFFLES_TPU_COUNTERS_JSON names a path."""
    totals: dict = {}
    seen = False
    for t in finished_tasks:
        counters = getattr(t.result, "engine_counters", None)
        if counters is None:
            continue
        seen = True
        for k, v in counters.items():
            totals[k] = totals.get(k, 0) + v
    if not seen:
        return
    log.info(f"Combine counters: {totals}")
    path = os.environ.get("SNIFFLES_TPU_COUNTERS_JSON")
    if path:
        try:
            import json
            with open(path, "w") as f:
                json.dump(totals, f)
        except OSError:
            log.warning(f"could not write engine counters to {path}")


def main_with_config(config: SnifflesConfig, processes: list) -> int:
    if config.no_progress:
        logging.getLogger('sniffles_tpu_torch.progress').setLevel(logging.CRITICAL)
    if config.dev_debug_log:
        logging.getLogger().setLevel(logging.DEBUG)

    exts = _detect_mode(config)
    _refuse_unported(config)
    log.info(f"Running {config.version}, build {config.build}")
    log.info(f"  Run Mode: {config.mode}")
    if config.tpu_combine:
        config.device = torch_device()
        log.info(f"  Device: {config.device}")

    vcf_out = _open_vcf_out(config)
    tasks, contig_lengths = _plan_combine_tasks(config, exts, start_task_id=0)
    vcf_out.write_header(contig_lengths)

    finished_tasks = _run_pool(config, tasks, processes)

    for t in finished_tasks:
        t.result.emit(vcf_out=vcf_out)

    vcf_out.close()
    log.info(f"Wrote {vcf_out.call_count} called SVs to {config.vcf}")
    if len(tasks) > 0:
        log.error(f"{len(tasks)} task(s) unprocessed; output is partial.")
        return 1
    return 0


_LOG_FORMAT = '%(asctime)s %(levelname)s %(name)s (%(process)d): %(message)s'
_LOGGING_CONFIG = {
    'version': 1,
    'disable_existing_loggers': False,
    'formatters': {'default': {'format': _LOG_FORMAT}},
    'handlers': {'console': {'class': 'logging.StreamHandler',
                             'formatter': 'default',
                             'stream': 'ext://sys.stdout'}},
    'loggers': {'sniffles_tpu_torch.progress': {'level': logging.WARNING}},
    'root': {'level': logging.INFO, 'handlers': ['console']},
}


def main(args: list[str] = None) -> int:
    """Run the CLI. Usage errors return their exit code; any other
    failure (a missing card included) propagates."""
    processes: list = []
    logging.config.dictConfig(_LOGGING_CONFIG)
    try:
        config = SnifflesConfig(*(args or []))
        return main_with_config(config, processes) or 0
    except (util.SnifflesTPUExit, SystemExit) as exit_code:
        return getattr(exit_code, 'code', 1) or 0


if __name__ == "__main__":
    sys.exit(main())
