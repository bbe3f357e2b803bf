"""Task types: CombineTask (multi-sample SNF merge).

Tasks are the unit of genome-space sharding — one per SNF-block shard
of a contig.  Behavior matches the reference task semantics (reference:
parallel.py:372-572).  Copied from sniffles_tpu/pipeline/tasks.py: the
Task base and CombineTask; the call-path tasks are not part of the
combine slice.

Unlike the JAX package, a failure of the device path raises here: it is
never caught and replaced by the host greedy. The exactness routes stay
(segments the device greedy flags are replayed on the host, a packer
guard returns None, an edit-distance batch under DEVICE_MIN_CELLS runs
the host Myers scan), and each is counted in the task's combine
counters.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, TYPE_CHECKING

from sniffles_tpu_torch import cluster
from sniffles_tpu_torch import postprocess as postprocessing
from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.io import snf
from sniffles_tpu_torch.region import Region
from sniffles_tpu_torch.pipeline.result import Result, CombineResult

if TYPE_CHECKING:
    from sniffles_tpu_torch.config import SnifflesConfig


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
    regions: list[Region] = None
    result: Result = None

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
                                    counters=self.combine_counters)
        for pair, dist in zip(pairs, dists):
            ed_cache[pair] = int(dist)

    def _group_batch(self, svtype, svcands, keep, ed_cache):
        """Greedy group assignment: the host-vectorized segmented exact
        greedy on the device path, or the plain host greedy."""
        self._prefill_ed_cache(svcands, keep, ed_cache, self.config)
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
                    svtype, flat, config, counters=self.combine_counters)
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
        self.combine_counters = {}
        sample_snfs = self._open_sample_snfs()
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
        # parallel/combine_device_greedy.py)
        preplan = None
        if getattr(config, "tpu_combine", False):
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
