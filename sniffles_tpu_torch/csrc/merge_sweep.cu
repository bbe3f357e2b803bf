// The exact cluster merge sweep of k call tasks on Hopper (sm_90a), as two
// kernels on one stream: sweep_cuts partitions each task's seed clusters at
// sound cuts, then merge_sweep walks each segment with a thread of its own.
// The result is, per task, the host's sequential backtracking sweep
// (reference: cluster.py:277-308), every state word bit for bit.
//
// Tasks: every array below is [k, n], task t's row at offset t * n (nseeds
// [k], counts [k, 5]); the device service fuses up to 4 tasks of one padded
// width into one dispatch (the vmap of sniffles_tpu/ops/clustering.py:1155,
// batched_call_task), and a single task is the case k = 1 of the same
// kernels. sweep_cuts runs one block per task (blockIdx.x = t), merge_sweep
// a grid row of blocks per task (blockIdx.y = t). A task with nseeds = 0 (a
// fused dispatch's zero pad slot) writes no cut flag and no head, counts 0
// segments, and its sweep threads exit, so its state stays as it was.
//
// Replaces two XLA programs of sniffles_tpu/ops/clustering.py:
//   - _exact_merge_sweep (:90), the sequential lax.while_loop (body
//     :194-252, range_metrics :153-173): merge_sweep runs that loop body
//     with its arithmetic unchanged;
//   - the cut fixpoint of _exact_merge_sweep_grid (:339-373, the same as
//     _exact_merge_sweep_auto :600-628): sweep_cuts. The grid's lockstep
//     lanes and their range metrics (cumsum differences, other float32
//     roundings) are not ported; each segment gets the sequential sweep's
//     own arithmetic instead, so there is one formulation and no switch.
//
// State of a task, in the JAX package's layout (one slot per seed cluster,
// n slots, the first nseeds live; ops/clustering.py::sweep_inputs builds it with
// torch ops and the threads update it in place in global memory):
//   nxt, prv      the doubly linked list of surviving clusters (n = none)
//   hi, end_bp    the cluster's element range end and its last bin's end
//   rep           the cluster's tandem-repeat flag
//   msv, sd       compute_metrics of the cluster: subsampled mean svlen,
//                 sample stdev of the subsampled start positions
//   alive         0 once the cluster was merged into its left neighbour
// counts (int32[5] a task, the layout of SWEEP_COUNTS in ops/clustering.py):
// total iterations, the longest segment's iterations (depth), segments,
// fixpoint passes, and 1 if the fixpoint collapsed.
//
// The partition (sweep_cuts, one block of 1,024 threads a task; any n). A cut
// before seed j is sound when no merge can cross it at any stage of
// accretion (the JAX package's proof, clustering.py:281-311): the pair's
// inner distance at the cut stays the raw gap between the two seeds' bins;
// m3 and m2 need it within max(cluster_merge_bnd, cluster_repeat_h_max);
// m1 needs it within cluster_r times a stdev, and a cluster's stdev stays
// below its segment's span. Initial cuts: every svtype's first seed and
// every gap beyond both caps. A pass keeps a non-type cut while
// gap > cluster_r * min(span_left, span_right) in float32, every cut
// judged on the previous pass's partition; removing a cut only widens
// spans, so the passes shrink the cut set to a fixpoint. After 24 passes
// that still changed it, only the type cuts stay. A segment's span is
// end_bp[last] - start_bp[first]: within a svtype the seeds are one bin
// each, in bin order. The JAX lines take the left span from the per-slot
// span array at index segid - 1, which is the left segment's span only
// where every earlier segment is one seed; the proof needs the left
// segment's, and that is the span taken here. Each thread owns a
// contiguous chunk of the live slots; a block-wide max scan of the chunks'
// last cuts and a reversed min scan of their first cuts give each chunk
// the cut before it and the cut after it, and the thread judges its own
// cuts in one walk. The cut flags double-buffer in global memory, where
// each thread only ever touches its own chunk, and the passes run with no
// host synchronisation. Only the nseeds live flags are written: the sweep
// reads a flag only at a live slot.
//
// The sweep (merge_sweep, a thread per segment, each task's grid row sized
// from n; threads past the task's segment count exit). Each thread runs the sequential
// loop body from its segment's head, with the grid's lane rules
// (clustering.py:489-562), which give the sequential sweep's states:
//   - i starts at 0 only at a svtype's first seed, and there only when
//     the task's head mask has that svtype's bit (head_mask[t] bit s for
//     svtype s, clamped to 0-7; the JAX package's head_freeze[s],
//     clustering.py:112-114, :142-146, :174-176, and the grid's
//     :333-337, :469-472); at 2 elsewhere. A mesh shard clears svtype s's
//     bit when it does not hold the svtype's task-global first element
//     (parallel/mesh.py); every other caller passes 0xFF. The sequential
//     pointer reaches a later segment's head with i >= 1, and i only
//     decides between i == 0, i == 1 and a backtrack; at a head the
//     backtrack fails (below), so 1 and 2 act alike there.
//   - A pair whose right cluster heads the next segment is not evaluated
//     (by the proof it cannot merge); the thread retires when its pointer
//     leaves the segment. The sequential sweep evaluates that pair, finds
//     no merge and walks on, changing no state.
//   - A backtrack needs the left neighbour in the same segment, which is
//     the case exactly when the current cluster is not a segment head: the
//     slots between a cluster and its left neighbour were merged into that
//     neighbour, and merges never cross a cut. At a head the pointer stays
//     put with i unchanged. The sequential sweep would step back across
//     the cut, evaluate the pair (no merge) and come back with i restored:
//     the same state, two iterations more. So the per-segment iterations
//     add up to at most the sequential count.
// Shared words: a thread reads and writes only its own segment's slots,
// with one exception. When a segment's last cluster absorbs its right
// neighbour, the sequential sweep writes prv[rn] = c, and rn may be the
// next segment's head. That write is kept (the final prv is compared bit
// for bit); no other thread writes that word, and the next segment's
// thread never reads it, because it reads prv only off a cluster that is
// not its head. No other word is touched by two threads.
//
// Arithmetic: the criteria and the metrics are float32 as in the JAX
// package, written with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never
// contracts into an FMA, so that every rounding is the plain version's, and
// with IEEE division and square root (no fast math). The sums of the stride
// picks of positions and lengths (integer-valued terms) and of the squared
// deviations accumulate in double in index order and round once to float,
// as the plain version does (merge_sweep_plain): the integer-valued sums
// are exact in double, so their order cannot matter.
//
// Bound: latency. A segment is a chain of dependent steps (about one a
// seed plus two a merge, each a handful of dependent loads, a merge also
// its range metrics over up to 199 picks); bytes and operations are far
// below a microsecond. The sweep takes the longest segment's chain (the
// depth) where the single thread took the task's, plus the fixpoint's
// passes, each a walk of one chunk and two block scans.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "range_metrics.cuh"

namespace {

using sniffles::clamp_slot;
using sniffles::kPickCap;
using sniffles::range_metrics;

constexpr int kSvtypeBnd = 4;
constexpr int kCutThreads = 1024;   // sweep_cuts' block, one a task
constexpr int kMaxPasses = 24;
constexpr int kSweepThreads = 128;
// every svtype's head frozen (a single device, no mesh shard)
constexpr int kAllHeads = 0xFF;
// the slots of counts (SWEEP_COUNTS in ops/clustering.py)
constexpr int kIterations = 0, kDepth = 1, kSegments = 2, kPasses = 3, kCollapsed = 4;
constexpr int kCounts = 5;

using BlockScan = cub::BlockScan<int, kCutThreads>;

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

__device__ __forceinline__ bool type_cut(const int32_t* __restrict__ seed_type, int j) {
  return j == 0 || seed_type[j] != seed_type[j - 1];
}

// Whether the cut before seed c survives a pass, given the cuts before
// (prev) and after (next: a cut slot, or nseeds) it.
__device__ __forceinline__ bool keep_cut(const int32_t* __restrict__ seed_type,
                                         const int32_t* __restrict__ start_bp,
                                         const int32_t* __restrict__ end_bp, int c, int prev,
                                         int next, float cluster_r, float const_gap) {
  if (type_cut(seed_type, c)) return true;
  const float gap = __int2float_rn(start_bp[c] - end_bp[c - 1]);
  const float span_l = __int2float_rn(end_bp[c - 1] - start_bp[prev]);
  const float span_r = __int2float_rn(end_bp[next - 1] - start_bp[c]);
  return gap > const_gap && gap > __fmul_rn(cluster_r, fminf(span_l, span_r));
}

__global__ void __launch_bounds__(kCutThreads) sweep_cuts_kernel(
    const int32_t* __restrict__ seed_type, const int32_t* __restrict__ start_bp,
    const int32_t* __restrict__ end_bp, const int32_t* __restrict__ nseeds_ptr,
    uint8_t* cut, uint8_t* spare, int32_t* heads, int32_t* counts, int n, float cluster_r,
    float const_gap) {
  // this block's task
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  seed_type += row;
  start_bp += row;
  end_bp += row;
  nseeds_ptr += blockIdx.x;
  cut += row;
  spare += row;
  heads += row;
  counts += blockIdx.x * kCounts;
  __shared__ typename BlockScan::TempStorage scan;
  __shared__ int mirror[kCutThreads];
  const int t = threadIdx.x;
  const int live = min(max(*nseeds_ptr, 0), n);
  const int chunk = (live + kCutThreads - 1) / kCutThreads;
  const int a = min(t * chunk, live), b = min(a + chunk, live);

  // initial cuts: a svtype's first seed, a gap beyond both caps
  int first = live, last = -1;
  for (int j = a; j < b; ++j) {
    const bool c = type_cut(seed_type, j) ||
                   __int2float_rn(start_bp[j] - end_bp[j - 1]) > const_gap;
    cut[j] = c;
    if (c) {
      first = min(first, j);
      last = j;
    }
  }

  uint8_t* cur = cut;
  uint8_t* out = spare;
  int passes = 0;
  bool changed = true;
  while (changed && passes < kMaxPasses) {
    ++passes;
    // the last cut before this chunk, and the first cut after it (a scan
    // of the chunks in reverse order, through `mirror`)
    int before, after, reversed;
    BlockScan(scan).ExclusiveScan(last, before, -1, MaxOp());
    mirror[kCutThreads - 1 - t] = first;
    __syncthreads();
    BlockScan(scan).ExclusiveScan(mirror[t], reversed, live, MinOp());
    __syncthreads();
    mirror[kCutThreads - 1 - t] = reversed;
    __syncthreads();
    after = mirror[t];

    // judge each cut of the chunk once its next cut is known
    bool dropped = false;
    int prev = before, pending = -1, pending_prev = -1;
    first = live;
    last = -1;
    for (int j = a; j <= b; ++j) {
      if (j < b && !cur[j]) {
        out[j] = 0;
        continue;
      }
      if (pending >= 0) {
        const bool keep = keep_cut(seed_type, start_bp, end_bp, pending, pending_prev,
                                   j < b ? j : after, cluster_r, const_gap);
        out[pending] = keep;
        dropped |= !keep;
        if (keep) {
          first = min(first, pending);
          last = pending;
        }
      }
      pending_prev = prev;
      pending = prev = j;
    }
    changed = __syncthreads_or(dropped);
    uint8_t* swap = cur;
    cur = out;
    out = swap;
  }

  // the final cut flags of the live slots into `cut`; after a collapse,
  // the type cuts only
  for (int j = a; j < b; ++j) {
    if (changed) {
      cut[j] = type_cut(seed_type, j);
    } else if (cur != cut) {
      cut[j] = cur[j];
    }
  }

  // the segment heads, in order
  int count = 0;
  for (int j = a; j < b; ++j) count += cut[j];
  int offset, segments;
  BlockScan(scan).ExclusiveSum(count, offset, segments);
  for (int j = a; j < b; ++j) {
    if (cut[j]) heads[offset++] = j;
  }
  if (t == 0) {
    counts[kIterations] = 0;
    counts[kDepth] = 0;
    counts[kSegments] = segments;
    counts[kPasses] = passes;
    counts[kCollapsed] = changed;
  }
}

__global__ void __launch_bounds__(kSweepThreads) merge_sweep_kernel(
    const int32_t* __restrict__ seed_type, const int32_t* __restrict__ start_bp,
    const int32_t* __restrict__ lo, const float* __restrict__ posf,
    const float* __restrict__ svlenf, const uint8_t* __restrict__ cut,
    const int32_t* __restrict__ heads, const int32_t* __restrict__ head_mask, int32_t* counts,
    int32_t* nxt, int32_t* prv, int32_t* hi, int32_t* end_bp, int32_t* rep, float* msv,
    float* sd, int32_t* alive, int n, float cluster_r, float repeat_h, float repeat_h_max,
    float merge_bnd, int global_repeat) {
  // this grid row's task
  const size_t row = static_cast<size_t>(blockIdx.y) * n;
  seed_type += row;
  start_bp += row;
  lo += row;
  posf += row;
  svlenf += row;
  cut += row;
  heads += row;
  counts += blockIdx.y * kCounts;
  nxt += row;
  prv += row;
  hi += row;
  end_bp += row;
  rep += row;
  msv += row;
  sd += row;
  alive += row;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= counts[kSegments]) return;
  const int sent = n;
  const int head = heads[g];
  const int ct = seed_type[head];
  const int64_t max_iters = 4LL * n + 8;
  const int hbit = ct < 0 ? 0 : (ct > 7 ? 7 : ct);
  const bool frozen = ((head_mask[blockIdx.y] & kAllHeads) >> hbit) & 1;
  int c = head, i = type_cut(seed_type, head) && frozen ? 0 : 2;
  int64_t it = 0;
  while (it < max_iters) {
    ++it;
    const int r = nxt[c];
    // the right neighbour is in this segment unless it heads the next one
    const bool in_seg = r < sent && !cut[r];
    bool merge = false;
    if (in_seg) {
      // criteria, as the host evaluates them (cluster.py:266-275)
      const float inner = static_cast<float>(start_bp[r] - end_bp[c]);
      const float outer = static_cast<float>(end_bp[r] - start_bp[c]);
      const bool m1 = inner <= __fmul_rn(fminf(sd[c], sd[r]), cluster_r);
      const bool rep_pair = rep[c] > 0 || rep[r] > 0 || global_repeat != 0;
      const float h_lim = fminf(repeat_h_max,
                                __fmul_rn(__fadd_rn(fabsf(msv[c]), fabsf(msv[r])), repeat_h));
      const bool m2 = rep_pair && outer <= h_lim;
      const bool m3 = ct == kSvtypeBnd && inner <= merge_bnd;
      merge = m1 || m2 || m3;
    }
    if (!merge) {
      if (!in_seg) break;
      c = r;
      ++i;
      continue;
    }
    const int new_hi = hi[r];
    float mean_new, sd_new;
    range_metrics(posf, svlenf, n, lo[c], new_hi, &mean_new, &sd_new);
    const int rn = nxt[r];
    hi[c] = new_hi;
    end_bp[c] = end_bp[r];
    rep[c] = rep[c] | rep[r];
    msv[c] = mean_new;
    sd[c] = sd_new;
    nxt[c] = rn;
    if (rn < sent) prv[rn] = c;   // rn may head the next segment: see the header
    alive[r] = 0;
    // pointer transition (host: i = max(0, i-2) + 1 after a merge):
    // i == 0 -> the node after the merged head; i == 1 -> the merged node
    // itself; i >= 2 -> the node before it (backtrack), which is in this
    // segment unless c heads it, and then the pointer stays
    if (i == 0) {
      c = rn;
      i = 1;
      if (rn >= sent || cut[rn]) break;
    } else if (i >= 2 && !cut[c]) {
      c = prv[c];
      --i;
    }
  }
  atomicAdd(&counts[kIterations], static_cast<int32_t>(it));
  atomicMax(&counts[kDepth], static_cast<int32_t>(it));
}

}  // namespace

// Both entry points take k tasks of n slots each ([k, n] arrays, nseeds
// [k], counts [k, 5]; merge_sweep also head_mask [k]); k = 1 is a single
// task. sweep_cuts takes no head mask: a type change is an unconditional
// cut (the JAX package's proof, clustering.py:296-311, holds whatever the
// head's pointer start), so the partition does not depend on it.
extern "C" int sweep_cuts(const int32_t* seed_type, const int32_t* start_bp,
                          const int32_t* end_bp, const int32_t* nseeds, uint8_t* cut,
                          uint8_t* spare, int32_t* heads, int32_t* counts, int n, int k,
                          float cluster_r, float const_gap, cudaStream_t s) {
  if (n <= 0 || k <= 0 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  sweep_cuts_kernel<<<k, kCutThreads, 0, s>>>(seed_type, start_bp, end_bp, nseeds, cut, spare,
                                              heads, counts, n, cluster_r, const_gap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int merge_sweep(const int32_t* seed_type, const int32_t* start_bp,
                           const int32_t* lo, const float* posf, const float* svlenf,
                           const uint8_t* cut, const int32_t* heads,
                           const int32_t* head_mask, int32_t* counts, int32_t* nxt,
                           int32_t* prv, int32_t* hi, int32_t* end_bp, int32_t* rep,
                           float* msv, float* sd, int32_t* alive, int n, int k,
                           float cluster_r, float repeat_h, float repeat_h_max,
                           float merge_bnd, int global_repeat, cudaStream_t s) {
  if (n <= 0 || k <= 0 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kSweepThreads - 1) / kSweepThreads, k);
  merge_sweep_kernel<<<grid, kSweepThreads, 0, s>>>(
      seed_type, start_bp, lo, posf, svlenf, cut, heads, head_mask, counts, nxt, prv, hi,
      end_bp, rep, msv, sd, alive, n, cluster_r, repeat_h, repeat_h_max, merge_bnd,
      global_repeat);
  return static_cast<int>(cudaGetLastError());
}
