"""Task types: CallTask (single-sample calling), GenotypeTask (force
calling), CombineTask (multi-sample SNF merge).

Tasks are the unit of genome-space sharding — one per contig interval
(call/genotype) or per SNF-block shard (combine).  Behavior matches the
reference task semantics (reference: parallel.py:42-572).  Copied from
sniffles_tpu/pipeline/tasks.py.

In a worker process (--threads N) a task reaches the device through the
parent's device service: the runtime attaches the worker's DeviceClient
as `device_service` at execute time, and the decode-ahead thread posts
the next call task's batch ahead of its execution (maybe_post_device).

Unlike the JAX package, a failure of the device path raises here: it is
never caught and replaced by the host path. The exactness routes stay
(in the call path: the per-child consumption gate, BND's host resplit,
the stats-capacity route of a task to the host sweep, and under
--tpu-mesh the seam route of a task whose cluster is wider than the
mesh's halo (MeshHaloOverflow, mesh_seam_host); in combine: segments the
device greedy flags are replayed on the host, a packer guard returns
None, an edit-distance batch under DEVICE_MIN_CELLS runs the host Myers
scan, and under --tpu-mesh a flush the mesh cannot take, or whose halo
overflows, takes the host-vectorized segmentation), and each is counted
in the task's engine or combine counters.
"""
from __future__ import annotations

import copy
import logging
import math
import os
from dataclasses import dataclass
from typing import Optional, TYPE_CHECKING

from sniffles_tpu_torch import cluster
from sniffles_tpu_torch import leads as leadprov
from sniffles_tpu_torch import postprocess as postprocessing
from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.io import snf
from sniffles_tpu_torch.region import Region
from sniffles_tpu_torch.pipeline.result import (Result, CallResult, GenotypeResult,
                                                CombineResult)

if TYPE_CHECKING:
    from sniffles_tpu_torch.config import SnifflesConfig

log = logging.getLogger(__name__)


def _traced_reads(leads_list, config):
    """Read names among `leads_list` selected by --dev-trace-read."""
    return [ld.read_qname for ld in leads_list if ld.read_qname in config.dev_trace_read]


@dataclass
class Task:
    """A unit of work (reference: parallel.py:42-249)."""
    contig: str
    start: int
    end: int
    id: int
    sv_id: int
    config: 'SnifflesConfig'

    assigned_process_id: Optional[int] = None
    tandem_repeats: list = None
    regions: list[Region] = None
    genotype_svs: list = None
    lead_provider: leadprov.LeadProvider = None
    bam: object = None
    result: Result = None

    _prefetched: Optional[tuple] = None
    _nm_threshold: Optional[float] = None
    # worker-local DeviceClient proxy; attached at execute time, never
    # pickled with the task
    device_service: object = None
    # (req_id, pack) of a device request posted by the decode-ahead
    # thread (runtime._prefetch_task); worker-local, never pickled
    _device_posted: Optional[tuple] = None

    def __str__(self):
        return f'Task #{self.id}'

    @property
    def done(self) -> bool:
        return self.result is not None

    success = property(lambda self: self.done and not self.result.error)

    def add_result(self, result: Result) -> None:
        self.result = result

    def execute(self, worker=None) -> Optional[Result]:
        raise NotImplementedError

    # -- lead extraction ----------------------------------------------------

    def _cache_filename(self) -> str:
        """Leadtab cache path (reference: leadprov.py:672-678)."""
        cache_dir = self.config.dev_cache_dir or os.path.join(self.config.tmp_dir,
                                                              "sniffles_tpu_cache")
        os.makedirs(cache_dir, exist_ok=True)
        base = os.path.basename(self.config.input)
        return os.path.join(cache_dir, f"{base}_{self.contig}_{self.start}_{self.end}.pickle")

    def _load_cached_leadtab(self) -> bool:
        """The leadtab of an earlier run with --dev-cache, when its file
        exists. The task's regional NM statistic comes back with its lead
        provider (average_regional_nm), as a scan leaves it; nothing is
        written to the shared config."""
        import pickle
        path = self._cache_filename()
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            self.lead_provider, self._nm_threshold, self._prefetched = pickle.load(f)
        self.lead_provider.config = self.config  # nulled before pickling
        log.info(f"{self}: leadtab loaded from the cache {path}")
        return True

    def _save_cached_leadtab(self):
        import pickle
        lp_config = self.lead_provider.config
        self.lead_provider.config = None  # config is not picklable state
        try:
            with open(self._cache_filename(), "wb") as f:
                pickle.dump((self.lead_provider, self._nm_threshold, self._prefetched), f)
        finally:
            self.lead_provider.config = lp_config

    def build_leadtab(self):
        # a decode-ahead prefetch (pipeline/runtime.py) may have already
        # built the leadtab on a background thread
        if self._prefetched is not None:
            return self._prefetched
        config = self.config
        if config.dev_cache and self._load_cached_leadtab():
            return self._prefetched
        from sniffles_tpu_torch.io.bam import AlignmentFile
        self.bam = AlignmentFile(config.input, config.input_mode, require_index=True,
                                 reference_filename=config.reference)
        self.lead_provider = leadprov.LeadProvider(
            config, self.id * config.task_read_id_offset_mult, self.contig)
        span = self.regions if self.regions else [Region(self.contig, self.start, self.end)]
        externals = self.lead_provider.build_leadtab(span, self.bam)
        # the per-task regional NM statistic, from this task's own scan
        # (the reference reads it back from the shared config,
        # leadprov.py:577-578; a decode-ahead scan of the next task runs
        # beside this one)
        self._nm_threshold = self.lead_provider.average_regional_nm
        self._prefetched = (externals, self.lead_provider.read_count)

        if config.dev_cache:
            self._save_cached_leadtab()
        return self._prefetched

    def maybe_post_device(self, device_client) -> None:
        """Pack this task's signature batch and post it to the parent's
        device service ahead of execution (called from the decode-ahead
        thread), so the device's work overlaps the preceding task's host
        compute. No-op without the device path, a client or a leadtab."""
        config = self.config
        if (device_client is None or self.lead_provider is None
                or not getattr(config, "tpu_call", False)):
            return
        from sniffles_tpu_torch.parallel.device_call import pack_mesh_payload, pack_task_batch
        pack = pack_task_batch(self.lead_provider, config, self.tandem_repeats)
        if pack is None:
            self._device_posted = (None, None)
            return
        mesh_n = int(getattr(config, "tpu_mesh", 0) or 0)
        if mesh_n > 1:
            req_id = device_client.post("call_task_mesh", pack_mesh_payload(pack, mesh_n),
                                        pack[1])
        else:
            req_id = device_client.post("call_task", pack[0], pack[1])
        self._device_posted = (req_id, pack)

    # -- candidate generation ----------------------------------------------

    def _iter_clusters(self, config):
        """Device sort-and-segment clusters on the device path (in process,
        or through the device service in a worker process), host sweep
        for the rest, and for a task past the device stats capacity or,
        under --tpu-mesh, one whose cluster is wider than the mesh's halo
        (MeshHaloOverflow: the seam route, counted as mesh_seam_host).
        Any other device error propagates."""
        host_types = sv.ALL_TYPES
        if config.tpu_call:
            from sniffles_tpu_torch.parallel.device_call import (device_clusters,
                                                                 MeshHaloOverflow,
                                                                 _DEVICE_TYPES)
            posted, self._device_posted = self._device_posted, None
            counters = self.engine_counters = {}
            try:
                made = device_clusters(self.lead_provider, config, self.tandem_repeats,
                                       device=self.device_service, posted=posted,
                                       counters=counters)
            except MeshHaloOverflow as e:
                log.info(f"{self}: {e}")
                counters["mesh_seam_host"] = counters.get("mesh_seam_host", 0) + 1
                made = None
            if made is not None:
                yield from made
                host_types = [t for t in sv.ALL_TYPES if t not in _DEVICE_TYPES]
                log.debug(
                    f"{self}: device engine stats consumed by "
                    f"{counters.get('engine_consumed', 0)}/"
                    f"{counters.get('children_total', 0)} children of "
                    f"{counters.get('clusters_total', 0)} clusters "
                    f"(fallbacks: bnd={counters.get('fb_bnd', 0)}, "
                    f"multi_fragment={counters.get('fb_multi_fragment', 0)}, "
                    f"resplit={counters.get('fb_resplit', 0)}, "
                    f"collision={counters.get('fb_support_collision', 0)})")
        for svtype in host_types:
            yield from cluster.resolve(svtype, self.lead_provider, config, self.tandem_repeats)

    def call_candidates(self, keep_qc_fails, config) -> list[sv.SVCall]:
        """Clusters -> preliminary calls + span coverage
        (reference: parallel.py:104-127)."""
        candidates = []
        for svcluster in self._iter_clusters(config):
            svcluster.get_sa_count()
            for svc in sv.call_from(svcluster, config, keep_qc_fails, self):
                if config.dev_trace_read:
                    if traced := _traced_reads(svcluster.leads, config):
                        print(f"[DEV_TRACE_READ] [3/4] [Task.call_candidates] Read "
                              f"{','.join(traced)} -> Cluster {svcluster.id} -> "
                              f"preliminary SVCall {svc.svtype} {svc.contig}:{svc.pos} "
                              f"svlen={svc.svlen} support={svc.support}")
                candidates.append(svc)

        self.coverage_average_total = postprocessing.coverage(candidates, self.lead_provider)
        return candidates

    # -- finalization -------------------------------------------------------

    def _snapshot_csv_lines(self, svc):
        try:
            # snapshot CSV lines while postprocess info is attached
            svc.csv_line = svc._to_csv_line()
            svc.csv_line_single = svc._to_csv_line(single_break=True)
        except Exception:
            log.exception(f'Error generating CSV line for {svc}')

    def _try_phasing_rescue(self, svc, config):
        """Allelic-imbalance HET rescue gate (reference: parallel.py:178-184)."""
        eligible = (svc.svtype not in ("BND",)
                    and abs(svc.svlen) <= config.dev_maxsvlen_extra
                    and svc.support >= int(config.dev_minreads_extra * 0.60))
        if config.phase and not svc.qc and eligible:
            try:
                self.rescue_phasing(svc)
            except Exception:
                log.warning(f'Error while rescue phasing for {svc}')

    def finalize_candidates(self, candidates: list['sv.SVCall'], keep_qc_fails, config):
        """QC screens, annotation, genotype, rescue passes
        (reference: parallel.py:129-201)."""
        finalized = []
        for svc in candidates:
            svc.qc = svc.qc and postprocessing.qc_sv(svc, config)
            if not config.mosaic and svc.qc:
                svc.qc = svc.qc and postprocessing.qc_sv_support(
                    svc, self.coverage_average_total, config)

            postprocessing.annotate_sv(svc, config)
            svc.qc = svc.qc and postprocessing.qc_sv_post_annotate(
                svc, config, self.coverage_average_total, nm_threshold=self._nm_threshold)

            if config.dev_trace_read and svc.postprocess is not None:
                if traced := _traced_reads(svc.postprocess.cluster.leads, config):
                    print(f"[DEV_TRACE_READ] [4/4] [Task.finalize_candidates] Read "
                          f"{','.join(traced)} -> Cluster {svc.postprocess.cluster.id} -> "
                          f"finalized SVCall, QC={svc.qc}: {svc.svtype} {svc.contig}:"
                          f"{svc.pos} filter={svc.filter}")

            if config.dev_output_candidates:
                self._snapshot_csv_lines(svc)

            self._try_phasing_rescue(svc, config)
            self._try_local_assembly(svc, config)

            svc.finalize()
            finalized.append(svc)
        return finalized

    def _try_local_assembly(self, svc, config):
        """Assembly-rescue gate for filtered INS/DEL (reference: parallel.py:186-196)."""
        keep_as_is = (("PASS", "GT", "MOSAIC_VAF") if config.dev_locasm_skip_mosaic
                      else ("PASS", "GT"))
        wanted = (config.dev_locasm_do and not svc.qc
                  and svc.filter not in keep_as_is and svc.svtype in ("INS", "DEL")
                  and abs(svc.svlen) <= config.dev_maxsvlen_extra
                  and (svc.support >= config.dev_minreads_extra
                       or len(svc.rnames) > config.dev_minreads_extra))
        if wanted:
            from sniffles_tpu_torch.local_asm import LocalAsm
            LocalAsm(svc).assembly(self.config)

    def rescue_phasing(self, svc: sv.SVCall, min_rnames_in_phase: float = 0.75,
                       min_reads_cover: int = 3) -> bool:
        """Rescue a mosaic-VAF-filtered call whose supporting reads nearly
        all share one haplotype (reference: parallel.py:203-249)."""
        if self.config.mode != "call_sample":
            return False
        import numpy as np
        nm_vals = [ld.nm for ld in svc.postprocess.cluster.leads]
        if np.nanmean(nm_vals) > self.config.genotype_error or len(nm_vals) <= min_reads_cover:
            return False

        phase_info = svc.info.get("PHASE")
        if phase_info is None:
            return False
        hp, _, hp_reads, _, hp_filter, _ = phase_info.split(",")
        if hp_filter != "PASS":
            return False

        # hap_counts = (sv hap0/1/2, all-reads hap0/1/2)
        _, sv1, sv2, _, all1, all2 = svc.postprocess.cluster.hap_counts
        by_hap = {1: (all1, sv1), 2: (all2, sv2)}
        if int(hp) not in by_hap:
            return False
        total_in_phase, sv_in_phase = by_hap[int(hp)]
        if total_in_phase == 0:
            return False

        if sv_in_phase / float(total_in_phase) >= min_rnames_in_phase:
            if svc.filter == "MOSAIC_VAF":
                svc.filter = "PASS"
                a, b, gq, dr, dv, p = svc.genotypes[0]
                svc.genotypes[0] = (a, 1, gq, dr, dv, p)
                svc.qc = True
                return True
        return False


class CallTask(Task):
    """Single-sample SV calling for one contig interval
    (reference: parallel.py:252-297)."""

    def _write_temp_snf(self, result, svcandidates, config):
        """Per-task temp SNF part for later assembly (reference:
        parallel.py:279-293)."""
        part_name = f"{config.snf}.tmp_{self.id}.snf"
        with open(part_name, "wb") as handle:
            part = snf.SNFile(config, handle)
            for cand in svcandidates:
                part.store(cand)
            # downsampled depth rides along in every block for combine-time
            # 0/0-vs-./. decisions
            part.annotate_block_coverages(self.lead_provider)
            part.write_and_index()
        result.has_snf = True
        result.snf_filename = part_name
        result.snf_index = part.get_index()
        result.snf_total_length = part.get_total_length()
        result.snf_candidate_count = len(svcandidates)

    def execute(self, worker=None) -> CallResult:
        config = self.config
        self.device_service = getattr(worker, "device_client", None)
        qc = not (config.snf is not None or config.no_qc)

        read_count = self.build_leadtab()[1]
        phase_before = dict(postprocessing.PHASE_COUNTERS)
        svcandidates = self.call_candidates(qc, config)
        svcalls = self.finalize_candidates(svcandidates, not qc, config)
        if not config.no_qc:
            svcalls = [call for call in svcalls if call.qc]
        if config.sort:
            svcalls.sort(key=lambda call: call.pos)

        result = CallResult(self, svcalls, read_count)
        result.engine_counters = getattr(self, "engine_counters", None)
        if result.engine_counters is not None:
            # device phase-tally consumption during THIS task's annotate
            # (module counters; per-task delta)
            for k, v in postprocessing.PHASE_COUNTERS.items():
                d = v - phase_before.get(k, 0)
                if d:
                    result.engine_counters[k] = result.engine_counters.get(k, 0) + d
        if config.dev_output_candidates:
            result.store_candidates(svcandidates)
        if config.snf is not None:
            self._write_temp_snf(result, svcandidates, config)
        result.coverage_average_total = self.coverage_average_total
        return result


class GenotypeTask(Task):
    """Force calling against a known-SV VCF (reference: parallel.py:300-369)."""

    _BINSIZE = 5000

    def _bin_targets(self):
        """Index the target SVs by svtype and 5kb position bin; targets near
        a bin edge register in the neighbor bin too
        (reference: parallel.py:309-330)."""
        edge = self._BINSIZE // 10
        table = {svtype: {} for svtype in sv.TYPES}
        for target in self.genotype_svs:
            target.genotype_match_sv = None
            target.genotype_match_dist = math.inf
            if target.svtype not in table:
                log.warning(f'Unsupported SVTYPE: {target.svtype}')
                continue
            home = int(target.pos / self._BINSIZE) * self._BINSIZE
            slots = [home]
            offset = target.pos % self._BINSIZE
            if offset < edge:
                slots.append(home - self._BINSIZE)
            if offset > self._BINSIZE - edge:
                slots.append(home + self._BINSIZE)
            for slot in slots:
                table[target.svtype].setdefault(slot, []).append(target)
        return table

    def _match_candidates(self, svcandidates, table, config):
        """Greedy nearest-target assignment per candidate
        (reference: parallel.py:337-358)."""
        for cand in svcandidates:
            if cand.svtype.startswith('SINGLE'):
                continue
            slot = int(cand.pos / self._BINSIZE) * self._BINSIZE
            targets = table[cand.svtype].get(slot)
            if targets is None:
                continue
            if cand.svtype == "BND":
                for target in targets:
                    dist = abs(target.pos - cand.pos)
                    if (dist < target.genotype_match_dist
                            and dist <= config.cluster_merge_bnd
                            and cand.bnd_info.mate_contig == target.bnd_info.mate_contig):
                        target.genotype_match_sv = cand
                        target.genotype_match_dist = dist
            else:
                for target in targets:
                    dist = (abs(target.pos - cand.pos)
                            + abs(abs(target.svlen) - abs(cand.svlen)))
                    shorter = float(min(abs(target.svlen), abs(cand.svlen)))
                    if (shorter > 0 and dist < target.genotype_match_dist
                            and dist <= config.combine_match * math.sqrt(shorter)
                            and dist <= config.combine_match_max):
                        target.genotype_match_sv = cand
                        target.genotype_match_dist = dist

    def execute(self, worker=None) -> Optional[GenotypeResult]:
        config = self.config
        self.device_service = getattr(worker, "device_client", None)
        read_count = self.build_leadtab()[1]
        svcandidates = self.call_candidates(False, config=config)
        self.finalize_candidates(svcandidates, True, config=config)

        table = self._bin_targets()
        self._match_candidates(svcandidates, table, config)
        postprocessing.coverage(self.genotype_svs, self.lead_provider)

        # Unmatched input SVs genotype as 0/0 (covered) or ./. (uncovered)
        # (reference: parallel.py:356-366, incl. the mid-loop bailout when a
        # target has no usable depth values)
        for target in self.genotype_svs:
            depths = [d for d in (target.coverage_start, target.coverage_center,
                                  target.coverage_end) if d is not None]
            if not depths:
                return
            depth = round(sum(depths) / len(depths))
            target.genotypes = {0: ((0, 0, 0, depth, 0, (None, None)) if depth > 0
                                    else config.genotype_none)}

        result = GenotypeResult(self, self.genotype_svs, read_count)
        # the device path's consumption counters, as a call task reports them
        result.engine_counters = getattr(self, "engine_counters", None)
        return result


class CombineTask(Task):
    """Merge multiple SNF files into a multi-sample VCF
    (reference: parallel.py:372-572)."""
    TARGET_WORK_PER_TASK = 10000

    result_class = CombineResult
    block_indices: list[int] = None
    # Scatter-seam handoff (see scatter()/clone()): non-first shards
    # reprocess the previous shard's last TWO blocks (a group's members
    # span at most two adjacent blocks since combine_match_max << block
    # size) to rebuild its frontier; closes inside the overlap are
    # suppressed (the previous shard emitted them identically), as are
    # "ghost" groups confined to the overlap's older block. Non-last
    # shards hand off tail groups touching their last block instead of
    # flushing them.
    overlap_nblocks: int = 0
    suppress_tail: bool = False

    def __init__(self, *args, **kwargs):
        override = kwargs.pop('result_class', None)
        if override is not None:
            self.result_class = override
        super().__init__(*args, **kwargs)
        self.generate_blocks()

    def generate_blocks(self):
        step = self.config.snf_block_size
        if self.regions:
            wanted = set()
            for r in self.regions:
                first = r.start // step * step
                wanted.update(range(first, r.end + step, step))
            self.block_indices = sorted(wanted)
        else:
            self.block_indices = list(range(self.start, self.end + step, step))

    def __str__(self):
        if not self.block_indices:
            return f'Task {self.id} [no blocks available]'
        return (f'Task {self.id} Contig {self.contig} [{self.start} ({self.block_indices[0]}) '
                f'.. {self.end} ({self.block_indices[-1]})]')

    def clone(self, first_block: int, block_count: int, new_id: int = None) -> 'CombineTask':
        shard = copy.copy(self)
        if new_id is not None:
            shard.id = new_id
        # This realizes the handoff the reference only describes in a
        # comment (parallel.py:425-429).
        shard.overlap_nblocks = min(2, first_block)
        shard.block_indices = self.block_indices[first_block - shard.overlap_nblocks:
                                                 first_block + block_count]
        shard.suppress_tail = (first_block + block_count) < len(self.block_indices)
        shard.start = shard.block_indices[0]
        shard.end = shard.block_indices[-1] + shard.config.snf_block_size
        return shard

    def scatter(self) -> list['CombineTask']:
        """Scatter on block level (reference: parallel.py:422-442)."""
        total_work = len(self.block_indices) * len(self.config.sample_ids_vcf)
        if total_work <= self.TARGET_WORK_PER_TASK or self.config.threads <= 1:
            return [self]
        # >= 2 blocks per shard: the overlap-block handoff is exactly-once
        # when a group's members cannot span a whole shard (production
        # sizing gives >= 100 blocks/shard; the floor guards degenerate
        # configurations)
        per_shard = max(2, total_work // self.TARGET_WORK_PER_TASK)
        return [self.clone(first, per_shard, new_id=self.id + i + 1)
                for i, first in enumerate(range(0, len(self.block_indices), per_shard))]

    # -- input plumbing -----------------------------------------------------

    def _open_sample_snfs(self):
        handles = {}
        for info in self.config.snf_input_info:
            snf_in = snf.SNFile(self.config, open(info["filename"], "rb"),
                                filename=info["filename"])
            snf_in.read_header()
            handles[info["internal_id"]] = snf_in
            if self.config.combine_close_handles:
                snf_in.close()
        return handles

    def _attach_population(self):
        if not self.config.combine_population:
            return
        from sniffles_tpu_torch.io.snfp import PopulationSNF
        # tasks share the config in inline (--threads 0) mode; only the
        # first task replaces the filename with the opened handle
        if isinstance(self.config.combine_population, str):
            self.config.combine_population = PopulationSNF.open(self.config.combine_population)

    def _bin_candidates(self, svtype, sample_snfs, samples_blocks):
        """Collect this block's support-screened candidates per 100bp-scale
        bin; returns (bins, #raw candidates seen)
        (reference: parallel.py:489-511)."""
        bin_width = self.config.combine_min_size
        threshold = self.config.combine_support_threshold
        bins: dict[int, list] = {}
        seen = 0
        for sample_id, sample_snf in sample_snfs.items():
            blocks = samples_blocks[sample_id]
            if blocks is None:
                continue
            reqc = sample_snf.reqc
            for block in blocks:
                for cand in block[svtype]:
                    if cand.support < threshold:
                        continue
                    if reqc:
                        postprocessing.genotype_sv(cand, self.config)
                    cand.sample_internal_id = sample_id
                    slot = int(cand.pos / bin_width) * bin_width
                    bins.setdefault(slot, []).append(cand)
                seen += len(block[svtype])
        return bins, seen

    def _prefill_ed_cache(self, svcands, keep, ed_cache, config):
        """Batch the INS identity-gate distances for this flush on the
        device ED kernel (ops/edit_distance_batch.py) before the greedy
        runs. Pairs are restricted to the greedy's actual probe set —
        (potential group lead alt x candidate alt) within the pos+len
        match radius (reference: cluster.py:373-385) — so the batch stays
        proportional to real work; below the device cells threshold the
        lazy host Myers fill wins and nothing is precomputed."""
        if ed_cache is None or not getattr(config, "tpu_combine", False):
            return
        from sniffles_tpu_torch.ops.edit_distance_batch import (edit_distance_batch,
                                                                DEVICE_MIN_CELLS)
        max_len = 1023
        leads = [(g.candidates[0].alt, g.pos_mean, abs(g.len_mean)) for g in keep]
        cands = [(c.alt, c.pos, abs(c.svlen)) for c in svcands]
        # any candidate can become a group lead for later candidates;
        # 2x radius absorbs group-mean drift as members join
        radius = 2.0 * config.combine_match_max
        pairs = set()
        for lead_alt, lead_pos, lead_len in leads + cands:
            if not lead_alt or len(lead_alt) > max_len:
                continue
            for cand_alt, cand_pos, cand_len in cands:
                if (cand_alt and cand_alt != lead_alt and len(cand_alt) <= max_len
                        and abs(lead_pos - cand_pos) + abs(lead_len - cand_len) <= radius):
                    pairs.add((lead_alt, cand_alt))
        pairs = [p for p in pairs if p not in ed_cache]
        if not pairs:
            return
        if sum(len(a) * len(b) for a, b in pairs) < DEVICE_MIN_CELLS:
            return
        dists = edit_distance_batch(pairs, device=config.device,
                                    counters=self.combine_counters,
                                    service=self.device_service)
        for pair, dist in zip(pairs, dists):
            ed_cache[pair] = int(dist)

    def _bump(self, key):
        self.combine_counters[key] = self.combine_counters.get(key, 0) + 1

    def _group_batch(self, svtype, svcands, keep, ed_cache):
        """Greedy group assignment: under --tpu-mesh N the mesh-sharded
        safe-cut segmentation (byte-exact: the exact host greedy runs per
        gathered segment, parallel/device_combine.mesh_block_groups), the
        host-vectorized segmented exact greedy on the device path, or the
        plain host greedy. A flush the mesh does not take (BND, under 4
        candidates, or mesh_block_groups' None) is counted as
        combine_mesh_skipped, one whose halo overflows as
        combine_mesh_seam; both go on to the device path's segmentation."""
        self._prefill_ed_cache(svcands, keep, ed_cache, self.config)
        if int(getattr(self.config, "tpu_mesh", 0) or 0) > 1:
            from sniffles_tpu_torch.parallel.device_call import MeshHaloOverflow
            from sniffles_tpu_torch.parallel.device_combine import mesh_block_groups
            try:
                out = (mesh_block_groups(svtype, svcands, keep, self.config, ed_cache,
                                         device=self.device_service)
                       if svtype != "BND" and len(svcands) >= 4 else None)
            except MeshHaloOverflow as e:
                log.info(f"{self}: {e}; host-vectorized segmentation for this flush")
                self._bump("combine_mesh_seam")
            else:
                if out is not None:
                    self._bump("combine_mesh_flushes")
                    return out
                self._bump("combine_mesh_skipped")
        use_device = (getattr(self.config, "tpu_combine", False)
                      and svtype != "BND" and len(svcands) >= 4)
        if use_device:
            from sniffles_tpu_torch.parallel.device_combine import device_block_groups
            return device_block_groups(svtype, svcands, keep, self.config, ed_cache)
        return cluster.resolve_block_groups(svtype, svcands, keep, self.config, ed_cache)

    # candidate cap for pre-materializing a whole task's blocks (the
    # whole-task device greedy); beyond it the streaming host path runs
    PREPLAN_MAX_RAW = 2_000_000

    def _block_flushes(self, bins, batch_trigger, bin_width):
        """The (batch, curr_bin, span) flush partition of one block's
        bins — depends only on candidate counts, never on grouping, so
        it is precomputable for the whole task."""
        config = self.config
        flushes = []
        if not bins:
            return flushes
        batch, span = [], 0
        ordered_bins = sorted(bins)
        final_bin = ordered_bins[-1]
        for curr_bin in ordered_bins:
            batch.extend(bins[curr_bin])
            span += bin_width
            flush = ((not config.combine_exhaustive and len(batch) >= batch_trigger)
                     or curr_bin == final_bin)
            if not flush:
                continue
            if not batch:
                span = 0
                continue
            flushes.append((batch, curr_bin, span))
            span = 0
            batch = []
        return flushes

    def _preplan_device(self, sample_snfs, batch_trigger, bin_width):
        """Whole-task device combine: read every block up front, compute
        each (block, svtype)'s flush partition, and dispatch ONE device
        greedy per svtype covering the entire task
        (parallel/combine_device_greedy.pack_task_assignments), not one
        per block. Returns None when the task is too large to
        pre-materialize (streaming path).  Reference analogue: the whole combine hot loop,
        parallel.py:444-566."""
        from sniffles_tpu_torch.parallel import combine_device_greedy as cdg
        config = self.config
        blocks = []
        total_raw = 0
        for block_index in self.block_indices:
            samples_blocks = {sid: snf_file.read_blocks(self.contig, block_index)
                              for sid, snf_file in sample_snfs.items()}
            for blks in samples_blocks.values():
                if blks:
                    total_raw += sum(len(b[svt]) for b in blks
                                     for svt in sv.TYPES)
            if total_raw > self.PREPLAN_MAX_RAW:
                return None
            blocks.append(samples_blocks)

        flushes_by = {}
        seen_total = 0
        for svtype in sv.TYPES:
            per_block = []
            for samples_blocks in blocks:
                bins, seen = self._bin_candidates(svtype, sample_snfs,
                                                  samples_blocks)
                seen_total += seen
                per_block.append(self._block_flushes(bins, batch_trigger,
                                                     bin_width))
            flushes_by[svtype] = per_block

        ctxs, ed_caches = {}, {}
        for svtype in sv.TYPES:
            flat = [f for flushes in flushes_by[svtype] for f in flushes]
            ed_caches[svtype] = ({} if (svtype == "INS"
                                        and config.combine_pctseq) else None)
            ctx = None
            if flat and svtype != "BND":
                ctx = cdg.pack_task_assignments(
                    svtype, flat, config, counters=self.combine_counters,
                    service=self.device_service)
            ctxs[svtype] = ctx
        return {"blocks": blocks, "flushes": flushes_by, "ctx": ctxs,
                "ed_caches": ed_caches, "seen": seen_total}

    def _fold_uncovered_depths(self, group, samples_blocks, all_sample_ids):
        """For samples without a candidate in this group, look up the
        block's downsampled depth at the group position
        (reference: parallel.py:537-551)."""
        window = self.config.coverage_binsize_combine
        probe = int(group.pos_mean / window) * window
        for absent in all_sample_ids - group.included_samples:
            blocks = samples_blocks[absent]
            depth = 0
            if blocks is not None and probe in blocks[0]["_COVERAGE"]:
                depth = blocks[0]["_COVERAGE"][probe]
            prior = group.coverages_nonincluded.get(absent)
            group.coverages_nonincluded[absent] = (depth if prior is None
                                                   else max(depth, prior))

    def _drop_ghosts(self, groups):
        """Groups confined to the overlap's older block belong to the
        previous shard."""
        if not self.overlap_nblocks:
            return groups
        limit = self.block_indices[self.overlap_nblocks - 1]
        return [g for g in groups if any(c.pos >= limit for c in g.candidates)]

    def execute(self, worker=None):
        config = self.config
        self.device_service = getattr(worker, "device_client", None)
        self.combine_counters = {}
        sample_snfs = self._open_sample_snfs()
        self._attach_population()
        result = self.result_class(self, [], 0)

        batch_trigger = max(25, int(len(config.snf_input_info) * 0.5))
        overlap_abs = config.combine_overlap_abs
        bin_width = config.combine_min_size
        all_sample_ids = set(sample_snfs.keys())

        candidates_processed = 0
        groups_keep = {svtype: [] for svtype in sv.TYPES}
        calls = []

        # whole-task device combine (--tpu-combine): pre-read every
        # block, dispatch ONE greedy kernel per svtype covering the
        # entire task, and replay the assignment through the real
        # SVGroup objects below — float statistics, frontier closure and
        # emission order stay host-exact (guards + exactness argument:
        # parallel/combine_device_greedy.py). The device path always sets
        # tpu_combine here, so under --tpu-mesh N the preplan is skipped
        # and every streaming flush goes through _group_batch's mesh
        # segmentation: the JAX package's routing for --tpu-mesh N without
        # --tpu-combine, the only one in which its mesh grouping runs.
        # Every route is host-exact, so the VCF is the same either way.
        preplan = None
        if (getattr(config, "tpu_combine", False)
                and int(getattr(config, "tpu_mesh", 0) or 0) <= 1):
            preplan = self._preplan_device(sample_snfs, batch_trigger,
                                           bin_width)
            if preplan is None:
                self.combine_counters["combine_preplan_streaming"] = 1
        if preplan is not None:
            candidates_processed += preplan["seen"]

        from sniffles_tpu_torch.parallel import combine_device_greedy as cdg

        for cur, block_index in enumerate(self.block_indices):
            if calls:
                result.store_calls(calls)
                calls = []

            if preplan is not None:
                samples_blocks = preplan["blocks"][cur]
            else:
                samples_blocks = {sample_id: sample_snf.read_blocks(self.contig, block_index)
                                  for sample_id, sample_snf in sample_snfs.items()}

            for svtype in sv.TYPES:
                task_ctx = None
                if preplan is not None:
                    flushes = preplan["flushes"][svtype][cur]
                    task_ctx = preplan["ctx"][svtype]
                else:
                    bins, seen = self._bin_candidates(svtype, sample_snfs, samples_blocks)
                    candidates_processed += seen
                    flushes = self._block_flushes(bins, batch_trigger,
                                                  bin_width)
                if not flushes:
                    continue
                keep = groups_keep[svtype]

                for fbatch, curr_bin, fspan in flushes:
                    svgroups = None
                    if task_ctx is not None:
                        svgroups = cdg.replay_flush_task(
                            task_ctx, keep, config,
                            preplan["ed_caches"][svtype])
                    if svgroups is None:
                        # memoizes edit distances across group probes
                        # within this batch: filled eagerly by the device
                        # ED kernel for large flushes (_prefill_ed_cache,
                        # radius-gated to the greedy's actual probe set),
                        # lazily by the host Myers scan below the device
                        # cells threshold
                        ed_cache = ({} if (svtype == "INS"
                                           and config.combine_pctseq) else None)
                        svgroups = self._group_batch(svtype, fbatch, keep,
                                                     ed_cache)

                    closing = []
                    keep = []
                    for group in svgroups:
                        self._fold_uncovered_depths(group, samples_blocks, all_sample_ids)
                        # sliding frontier: a group still within reach of the
                        # current bin may yet gain candidates
                        if abs(group.pos_mean - curr_bin) < max(fspan * 0.5, overlap_abs):
                            keep.append(group)
                        else:
                            closing.append(group)
                    if task_ctx is not None:
                        task_ctx["closed"].update(id(g) for g in closing)

                    if cur >= self.overlap_nblocks:
                        # (closes inside the overlap were emitted by the
                        # previous shard: same candidates, same greedy)
                        closing = self._drop_ghosts(closing)
                        calls.extend(sv.call_groups(closing, config, self))

                groups_keep[svtype] = keep

            if preplan is not None:
                # bound memory: candidates still alive are held by their
                # groups; the block's raw lists and coverage maps are done
                preplan["blocks"][cur] = None

        # Tail flush. Ghosts belong to the previous shard; groups touching
        # this shard's last block are handed to the next shard when one
        # exists (it rebuilds them fully from its two-block overlap).
        last_block = self.block_indices[-1]
        for svtype, groups in groups_keep.items():
            groups = self._drop_ghosts(groups)
            if self.suppress_tail:
                groups = [g for g in groups
                          if not any(c.pos >= last_block for c in g.candidates)]
            calls.extend(sv.call_groups(groups, config, self))

        if len(calls) > 0:
            result.store_calls(calls)
        if self.combine_counters:
            # aggregated by cli._report_engine_counters alongside the
            # call-path engine counters; landed in the bench JSON
            result.engine_counters = dict(self.combine_counters)
        result.finalize()

        return result


class ShutdownTask:
    """Poison pill: executing it raises Shutdown inside the worker loop."""
    id = None

    def __str__(self):
        return 'Shutdown Request'

    def execute(self, *args, **kwargs):
        from sniffles_tpu_torch.pipeline.runtime import SnifflesWorker
        raise SnifflesWorker.Shutdown
