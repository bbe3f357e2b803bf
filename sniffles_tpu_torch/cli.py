"""CLI entry point, organized as a pipeline of stages: mode detection,
input validation, output opening, task planning, execution (the worker
pool for --threads N, inline for --threads 0), and ordered result
emission (reference: src/sniffles/sniffles:64-650).

Copied from sniffles_tpu/cli.py: the four run modes, call_sample (one
.bam or .cram -> VCF and/or .snf), genotype_vcf (force calling against a
--genotype-vcf), combine (.snf inputs -> multi-sample VCF) and its
population SNF (--dev-population-snf, --combine-population), with .vcf.gz
output, the local-assembly rescue (--dev-locasm-do), the leadtab cache
(--dev-cache), --tpu-mesh N (the genome-sharded device steps over N
devices, parallel/mesh.py; a mesh that cannot be placed ends the run
before any task) and the multi-host run (SNIFFLES_TPU_COORDINATOR,
SNIFFLES_TPU_NUM_PROCESSES, SNIFFLES_TPU_PROCESS_ID: each process runs
its share of the tasks and process 0 writes the output,
parallel/distributed.py). --combine-consensus, which crashes in the JAX
package (ROADMAP C1), stops with a usage error. The native host library
(csrc/host/, io/native.py) is built here, before any worker forks. The
device path (on unless --no-tpu) runs on the card, or on the CPU
when SNIFFLES_TPU_FORCE_CPU=1 asks for it (config.torch_device). With
--threads N (4 by default) the workers reach it through the device
service the parent owns (parallel/device_service.py), whose context is
created after every worker has forked. When SNIFFLES_TPU_DEVICE_SOCKET
names the socket of a device daemon (parallel/device_daemon.py), the
run's device work goes to the daemon instead: this process creates no
service and no CUDA context, and a socket that does not answer ends the
run (no fallback). --no-tpu never connects.
"""
from __future__ import annotations

import logging.config
import logging
import math
import multiprocessing
import os
import time
import sys
from collections import deque
from typing import Optional

from sniffles_tpu_torch import util
from sniffles_tpu_torch.config import SnifflesConfig, torch_device

log = logging.getLogger('sniffles_tpu_torch.main')


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
        if len(config.input) > 1:
            util.fatal_error_main("Please specify max 1 .bam/.cram file as input")
        config.input = config.input[0]
        config.mode = "genotype_vcf" if config.genotype_vcf is not None else "call_sample"
        config.input_is_cram = "cram" in distinct
        config.input_mode = "rc" if config.input_is_cram else "rb"
    elif distinct & {"snf", "tsv"}:
        config.mode = "combine"
    else:
        util.fatal_error_main(
            "Failed to determine run mode from input. Please specify either: A single .bam file "
            "- OR - one or more .snf files - OR - a single .tsv file as input.")

    if config.mode != "call_sample" and config.snf is not None:
        util.fatal_error_main(f"--snf cannot be used with run mode {config.mode}")
    if config.vcf is None and config.snf is None:
        util.fatal_error_main("Please specify at least one of: --vcf or --snf for output")

    if config.mode == "call_sample":
        config.sample_ids_vcf = [(0, config.sample_id or "SAMPLE")]
    elif config.mode == "combine":
        config.sample_id = None
        config.sample_ids_vcf = []
    return exts


def _refuse_unsupported(config: SnifflesConfig) -> None:
    """--combine-consensus, whose genotype merge unpacks combine's 7-field
    genotypes into 5 names and raises in the JAX package as in this one."""
    if config.mode == "combine" and config.combine_consensus:
        util.fatal_error_main("--combine-consensus is not supported by sniffles_tpu_torch: "
                              "its genotype merge fails on combine's genotypes (the "
                              "sniffles_tpu package exits with a ValueError there too)")


def _open_alignments(config: SnifflesConfig):
    """Open + index-check the BAM/CRAM input (reference: sniffles:170-186)."""
    from sniffles_tpu_torch.io.bam import AlignmentFile
    log.info(f"Opening for reading: {config.input}")
    try:
        bam_in = AlignmentFile(config.input, config.input_mode)
    except FileNotFoundError:
        util.fatal_error_main(f"Input file '{config.input}' not found.")
    except (ValueError, NotImplementedError) as e:
        util.fatal_error_main(f"Unable to open input file '{config.input}': {e}")
    if not bam_in.check_index():
        util.fatal_error_main(
            f"Unable to load index for input file '{config.input}'. Please verify that your "
            f"input file is sorted + indexed.")
    return bam_in


def _load_genotype_targets(config: SnifflesConfig):
    """Parse the --genotype-vcf input for force calling
    (reference: sniffles:191-214)."""
    from sniffles_tpu_torch.io import vcf as vcfmod
    ext = os.path.splitext(config.genotype_vcf)[1].lower()
    if ext == ".gz":
        import gzip
        handle = gzip.open(config.genotype_vcf, "rt")
    elif ext == ".vcf":
        handle = open(config.genotype_vcf, "r")
    else:
        util.fatal_error_main("Expected a .vcf or .vcf.gz file for --genotype-vcf")
    vcf_in = vcfmod.VCF(config, handle)

    lineindex_order = []
    by_contig = {}
    for svc in vcf_in.read_svs_iter():
        lineindex_order.append(svc.raw_vcf_line_index)
        by_contig.setdefault(svc.contig, []).append(svc)
    log.info(f"Read {len(lineindex_order)} SVs to be genotyped")
    return vcf_in, lineindex_order, by_contig


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
    if config.mode in ("call_sample", "combine"):
        vcf_out.open_reference()
    log.info(f"Opening for writing: {config.vcf}")
    return vcf_out


def _open_snf_out(config: SnifflesConfig):
    from sniffles_tpu_torch.io import snf as snfmod
    _guard_overwrite(config.snf, config)
    return snfmod.SNFile(config, open(config.snf, "wb"))


def _open_psnf_out(config: SnifflesConfig):
    name = config.dev_population_snf
    if os.path.exists(name) and not config.allow_overwrite:
        util.fatal_error_main(f'Population SNF {name} already exists!')
    from sniffles_tpu_torch.io.snfp import PopulationSNF
    return PopulationSNF(config, open(name, 'wb'))


# --------------------------------------------------------------------------
# Stage 3: task planning


def _plan_interval_tasks(config, bam_in, tandem_repeats, genotype_contig_svs):
    """Split each kept contig into read-count-balanced interval tasks
    (reference: sniffles:289-358).  Returns (tasks, contigs,
    contig_lengths)."""
    from sniffles_tpu_torch.pipeline import tasks as taskmod
    task_class = (taskmod.GenotypeTask if config.mode == "genotype_vcf"
                  else taskmod.CallTask)

    total_mapped = bam_in.mapped
    single_task_per_contig = ((config.threads == 1 and not config.low_memory)
                              or config.task_count_multiplier == 0)
    if single_task_per_contig:
        task_max_reads = total_mapped
    else:
        task_max_reads = max(1, math.floor(
            total_mapped / (config.threads * config.task_count_multiplier)))

    config.task_read_id_offset_mult = (
        10 ** 9 if total_mapped == 0
        else 10 ** math.ceil(math.log(total_mapped) + 1))

    tasks = deque()
    contigs = []
    contig_lengths = []
    task_id = 0
    tr_annotated = 0
    for stat in bam_in.get_index_statistics():
        contig = str(stat.contig)
        length = bam_in.get_reference_length(contig)
        if not util.should_process_contig(contig, length, config):
            continue

        contigs.append(contig)
        contig_lengths.append((contig, length))
        tr_annotated += contig in tandem_repeats

        pieces = 1 if task_max_reads == 0 else max(
            1, math.ceil(stat.mapped / float(task_max_reads)))
        step = math.floor(length / float(pieces))
        targets = genotype_contig_svs.get(contig, []) if genotype_contig_svs is not None else None

        lo = 0
        while lo < length - 1:
            hi = min(length - 1, lo + step)
            window_svs = ([t for t in targets if lo <= t.pos < hi]
                          if targets is not None else None)
            tasks.append(task_class(
                id=task_id, contig=contig, start=lo, end=hi,
                assigned_process_id=None,
                tandem_repeats=tandem_repeats.get(contig),
                genotype_svs=window_svs, sv_id=0, config=config,
                regions=config.regions_by_contig.get(contig)))
            lo += step
            task_id += 1

    config.contig_lengths = contig_lengths
    if config.tandem_repeats is not None and tr_annotated < len(contig_lengths):
        if tr_annotated == 0:
            util.fatal_error_main(
                "A tandem repeat annotations file was provided, but no matching annotations "
                "were found for any contig in the sample input file.")
    return tasks, contigs, contig_lengths


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

    config.sample_ids_vcf.extend(
        (info["internal_id"], info["sample_id"]) for info in config.snf_input_info)

    if wanted := (config.contig or config.regions_by_contig):
        contig_lengths = [(name, length) for name, length in contig_lengths
                          if name in wanted]

    result_class = None
    if len(inputs) > config.combine_max_inmemory_results:
        from sniffles_tpu_torch.pipeline.result import CombineResultTmpFile
        result_class = CombineResultTmpFile
        if config.sort and config.vcf_output_bgz:
            config.vcf = config.uncompressed_vcf_name
            config.no_sort = True
    if config.dev_population_snf:
        from sniffles_tpu_torch.pipeline.result import CombineResultTmpFilePopulationSNF
        result_class = CombineResultTmpFilePopulationSNF

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


def _uses_device(config) -> bool:
    """Whether this run takes the device path: the call path's flag for
    the two modes that call from a BAM, combine's for combine."""
    return config.tpu_call if config.mode in ("call_sample", "genotype_vcf") else config.tpu_combine


def _daemon_socket(config) -> Optional[str]:
    """The device daemon's socket, when the run takes the device path and
    SNIFFLES_TPU_DEVICE_SOCKET names one."""
    from sniffles_tpu_torch.parallel.device_daemon import ENV_SOCKET
    return (os.environ.get(ENV_SOCKET) or None) if _uses_device(config) else None


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _run_pool(config, tasks, processes, monitor, daemon_socket=None):
    """Run the worker pool (or the inline parent worker for --threads 0)
    to completion (reference: sniffles:495-542). With the device path, the
    pool's workers reach the device through one DeviceServer of this
    process, whose dispatcher thread creates the device context only after
    every worker has forked; or, with `daemon_socket`, every worker (and
    the inline worker) through a connection of its own to the device
    daemon."""
    from sniffles_tpu_torch.parallel import device_daemon, device_service
    from sniffles_tpu_torch.pipeline import runtime
    device_server = None
    use_device = _uses_device(config)
    if config.threads:
        if use_device and daemon_socket is None:
            device_server = device_service.DeviceServer(config.device)
            # the workers are forked from this process: it must not hold a
            # CUDA context (torch_device asks NVML, which creates none)
            if _cuda_initialized():
                raise RuntimeError("this process holds a CUDA context before forking its "
                                   "workers; run the CLI in a process of its own")
        for pnum in range(config.threads):
            processes.append(runtime.SnifflesWorker(
                process_id=pnum, config=config, tasks=tasks,
                recycle_hint=monitor, peers=processes,
                device_server=device_server, daemon_socket=daemon_socket))
    else:
        processes.append(runtime.SnifflesParentWorker(config=config, tasks=tasks,
                                                      daemon_socket=daemon_socket))

    # the service's counters and kernel launches before the run (the
    # daemon's also count its warmup and any other client's work)
    stats = ((lambda: device_daemon.daemon_stats(daemon_socket)) if daemon_socket
             else device_server.stats if device_server is not None else None)
    before = stats() if stats else None
    started = time.monotonic()
    for p in processes:
        p.start()

    if device_server is not None:
        # all workers are forked: build the kernels and create the context
        # on the dispatcher thread now, overlapping the workers' first
        # BAM decode
        device_server.warm_async(config)

    try:
        while any([p.run_parent() for p in processes if p.running]):
            time.sleep(0.01)
    finally:
        if device_server is not None:
            device_server.stop()

    finished_tasks = []
    for p in processes:
        p.finalize()
        finished_tasks.extend(p.finished_tasks)
    log.info(f"Analysis took {time.monotonic() - started:.2f}s.")

    # Deterministic emission in task-id order (reference: sniffles:544-547)
    finished_tasks.sort(key=lambda task: task.id)
    service = device_service.stats_difference(before, stats()) if stats else None
    if daemon_socket:
        service["service_requests"] -= 1   # the stats request that read the counters
    _report_engine_counters(finished_tasks, service)
    return finished_tasks


def _report_engine_counters(finished_tasks, service=None) -> None:
    """Aggregate the per-task device counters across the run (call path:
    engine-stat consumption and its exactness routes; combine: device
    greedy dispatches, flagged segments, edit-distance batch routes),
    plus, for a worker pool on the device path, the device service's
    counters and its kernel launches (`service`); logged, and written as
    JSON when SNIFFLES_TPU_COUNTERS_JSON names a path."""
    totals: dict = {}
    seen = False
    for t in finished_tasks:
        counters = getattr(t.result, "engine_counters", None)
        if counters is None:
            continue
        seen = True
        for k, v in counters.items():
            totals[k] = totals.get(k, 0) + v
    if not seen and service is None:
        return
    totals.update(service or {})
    log.info(f"Device counters: {totals}")
    path = os.environ.get("SNIFFLES_TPU_COUNTERS_JSON")
    if path:
        try:
            import json
            with open(path, "w") as f:
                json.dump(totals, f)
        except OSError:
            log.warning(f"could not write engine counters to {path}")


def _merge_candidate_csvs(config, finished_tasks):
    """Concatenate per-task candidate CSVs (reference: sniffles:549-558)."""
    from shutil import copyfileobj
    with open(config.dev_output_candidates, "w") as merged:
        merged.write('svtype,orientation_start,contig_start,pos_start,orientation_end,contig_end,'
                     'pos_end,filter,support_inline,support_split,support_ref\n')
        for t in finished_tasks:
            part = t.result.candidate_filename
            if part and os.path.exists(part):
                with open(part, "r") as f:
                    copyfileobj(f, merged)
                os.unlink(part)


def _attach_remote_debugger(port: int) -> None:
    """--dev-debug PORT: attach to an IDE debug server on localhost
    (reference: sniffles:70-81 via pydevd_pycharm; copied from the JAX
    package's cli.py). Tries pydevd_pycharm, pydevd, then debugpy; logs a
    warning and continues when none is importable or the connection
    fails."""
    try:
        try:
            import pydevd_pycharm
            pydevd_pycharm.settrace('localhost', port=port, stdoutToServer=True,
                                    stderrToServer=True)
            return
        except ImportError:
            pass
        try:
            import pydevd
            pydevd.settrace('localhost', port=port, stdout_to_server=True,
                            stderr_to_server=True)
            return
        except ImportError:
            pass
        import debugpy
        debugpy.connect(("localhost", port))
        log.info(f"Attached debugpy client to localhost:{port}")
    except Exception as e:
        log.warning(f"--dev-debug {port}: could not attach a remote debugger "
                    f"(pydevd_pycharm/pydevd/debugpy): {e}")


def main_with_config(config: SnifflesConfig, processes: list) -> int:
    from sniffles_tpu_torch.resmon import ResourceMonitor

    if getattr(config, "dev_debug", None):
        _attach_remote_debugger(config.dev_debug)
    if config.no_progress:
        logging.getLogger('sniffles_tpu_torch.progress').setLevel(logging.CRITICAL)
    if config.dev_debug_log:
        logging.getLogger().setLevel(logging.DEBUG)

    if sys.platform in ("darwin", "linux"):
        try:
            multiprocessing.set_start_method("fork")
        except RuntimeError:
            pass

    exts = _detect_mode(config)
    _refuse_unsupported(config)
    from sniffles_tpu_torch.parallel import distributed
    try:
        multihost = distributed.from_environment()
    except ValueError as e:
        util.fatal_error_main(str(e))
    emit_here = multihost is None or multihost.is_emitter
    # the native host library, built once in this process before the
    # worker pool forks (a failed build raises)
    from sniffles_tpu_torch.io import native
    native.get_lib()
    log.info(f"Running {config.version}, build {config.build}")
    log.info(f"  Run Mode: {config.mode}")
    daemon_socket = _daemon_socket(config)
    if daemon_socket is not None:
        # the daemon's device; this process makes no device check of its own
        from sniffles_tpu_torch.parallel.device_daemon import daemon_stats
        try:
            config.device = daemon_stats(daemon_socket)["device"]
        except (RuntimeError, TimeoutError) as e:
            util.fatal_error_main(str(e))
        log.info(f"  Device: {config.device}, through the device daemon on {daemon_socket}")
    elif _uses_device(config):
        config.device = torch_device()
        log.info(f"  Device: {config.device}")
        if int(config.tpu_mesh or 0) > 1:
            # the mesh is placed here, before any task (NVML: no context);
            # the device service resolves it again in its own thread
            from sniffles_tpu_torch.parallel.mesh import mesh_devices
            try:
                devices = mesh_devices(int(config.tpu_mesh))
            except RuntimeError as e:
                util.fatal_error_main(str(e))
            log.info(f"  Mesh: {config.tpu_mesh} shards on {', '.join(devices)}")

    rkwargs = {}
    bam_in = None
    vcf_in = None
    tandem_repeats = {}
    genotype_contig_svs = None
    if config.mode in ("call_sample", "genotype_vcf"):
        bam_in = _open_alignments(config)
        if config.tandem_repeats is not None:
            tandem_repeats = util.load_tandem_repeats(
                config.tandem_repeats, config.tandem_repeat_region_pad)

    if config.mode == "genotype_vcf":
        vcf_in, lineindex_order, genotype_contig_svs = _load_genotype_targets(config)
        rkwargs['genotype_lineindex_order'] = lineindex_order

    if multihost is not None:
        # every process has checked its configuration, input and mesh: meet
        # the others before any output is opened or any task runs
        try:
            distributed.rendezvous(multihost)
        except RuntimeError as e:
            util.fatal_error_main(str(e))

    # only the emitter process of a multi-host run touches output files
    vcf_out = _open_vcf_out(config) if (config.vcf is not None and emit_here) else None
    snf_out = _open_snf_out(config) if (config.snf is not None and emit_here) else None
    psnf_out = None
    if config.dev_population_snf and emit_here:
        psnf_out = _open_psnf_out(config)
        rkwargs['psnf_out'] = psnf_out

    contigs = []
    if config.mode == "combine":
        tasks, contig_lengths = _plan_combine_tasks(config, exts, start_task_id=0)
    else:
        tasks, contigs, contig_lengths = _plan_interval_tasks(
            config, bam_in, tandem_repeats, genotype_contig_svs)

    if config.mode == "genotype_vcf" and vcf_out is not None:
        vcf_out.rewrite_header_genotype(vcf_in.header_str)
    elif vcf_out is not None:
        vcf_out.write_header(contig_lengths)

    if multihost is not None:
        # every process plans the same task list and runs its own share
        own = set(multihost.shard_assignment(len(tasks)))
        tasks = deque(t for i, t in enumerate(tasks) if i in own)

    monitor = ResourceMonitor(config)
    try:
        finished_tasks = _run_pool(config, tasks, processes, monitor, daemon_socket)
    finally:
        monitor.stop()

    if multihost is not None:
        # after the pool: the process group is never created before a fork
        finished_tasks = distributed.exchange_results(multihost, finished_tasks)
        if not emit_here:
            return _exit_code(finished_tasks, tasks)

    for t in finished_tasks:
        t.result.emit(vcf_out=vcf_out, snf_out=snf_out, **rkwargs)

    if config.dev_output_candidates and config.mode == "call_sample":
        _merge_candidate_csvs(config, finished_tasks)

    if snf_out:
        stored = snf_out.write_results(config, contigs)
        snf_out.close()
        log.info(f"Wrote {stored} SV candidates to {config.snf}")

    if psnf_out:
        stored = psnf_out.write_results(config, contigs)
        psnf_out.close()
        log.info(f'Wrote {stored} SVs to population SNF.')

    if vcf_out is not None:
        vcf_out.close()
        if config.vcf_output_bgz:
            from sniffles_tpu_torch.io.tabix import tabix_compress_and_index
            tabix_compress_and_index(config.uncompressed_vcf_name, config.vcf)
        if config.mode in ("call_sample", "combine"):
            log.info(f"Wrote {vcf_out.call_count} called SVs to {config.vcf}")
    return _exit_code(finished_tasks, tasks)


def _exit_code(finished_tasks, unprocessed) -> int:
    """1 when a task failed (in any process of a multi-host run) or was
    left unprocessed here, else 0. A task that failed in a worker (a
    device error included) ends as an ErrorResult; the reference only
    logs it, and so does the JAX package's runtime, but the run must not
    look like a success."""
    n_errors = sum(1 for t in finished_tasks if getattr(t.result, "error", False))
    if n_errors or len(unprocessed) > 0:
        log.error(f"{n_errors} task(s) failed, {len(unprocessed)} task(s) unprocessed; "
                  f"output is partial.")
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
    failure (a missing card included) propagates. Worker processes still
    running on the way out are stopped."""
    processes: list = []
    logging.config.dictConfig(_LOGGING_CONFIG)
    try:
        config = SnifflesConfig(*(args or []))
        return main_with_config(config, processes) or 0
    except (util.SnifflesTPUExit, SystemExit) as exit_code:
        return getattr(exit_code, 'code', 1) or 0
    finally:
        for proc in processes:
            process = getattr(proc, "process", None)
            if process is not None and process.is_alive():
                process.terminate()
                process.join(2)


if __name__ == "__main__":
    sys.exit(main())
