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
// segment's, and that is the span taken here. Only an initial cut can
// survive a pass, so the block stages the initial cuts (candidates) once,
// from the live seeds' columns read with coalesced loads: each one's
// start_bp, the end_bp of the seed before it and its slot, 12 bytes, in
// shared memory up to kSmemCands of them (past it, in the task's global
// scratch, the same code on other pointers). The partition is a bit a
// candidate; a pass finds each cut's neighbours from the bits of its word
// and, across words, from a block scan of the words' last and first cuts
// (warp shuffles and one exchange of the warp totals; the first pass, every
// candidate alive, needs none), judges the cuts a warp a word, and writes
// the next bits by ballots: three barriers a pass (one on the first), no
// read of global memory but the cuts' own columns where they lie there.
// The passes run with no host synchronisation. Only the nseeds live flags
// are written (the sweep reads a flag only at a live slot), and the heads,
// in order, from the bits by popcounts.
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
// depth) where the single thread took the task's, plus the partition's
// staging and passes, each three barriers and a word a warp.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "range_metrics.cuh"

namespace {

using sniffles::clamp_slot;
using sniffles::kPickCap;
using sniffles::range_metrics;

constexpr int kSvtypeBnd = 4;
constexpr int kCutThreads = 1024;   // sweep_cuts' block, one a task
// the most candidate cuts a task holds in shared memory (cand_ints(18,432)
// ints: 230,400 bytes of the H100's 232,448 a block); past it, in global
// scratch
constexpr int kSmemCands = 18432;
constexpr int kStageItems = 4;      // consecutive seeds a thread stages at a time
constexpr int kMaxPasses = 24;
constexpr int kSweepThreads = 128;
// every svtype's head frozen (a single device, no mesh shard)
constexpr int kAllHeads = 0xFF;
// the slots of counts (SWEEP_COUNTS in ops/clustering.py)
constexpr int kIterations = 0, kDepth = 1, kSegments = 2, kPasses = 3, kCollapsed = 4;
constexpr int kCounts = 5;
constexpr unsigned kFull = 0xffffffffu;

// The partition's cycles by part, in a build with -DCUTS_CLOCKS only
// (tools/time_merge_sweep.py --split): a barrier ahead of each stamp, then
// thread 0 adds the clock64() cycles since the last stamp to the part's sum
// (kInitial: the staging of the candidate cuts; kScans: a pass's scan of
// the words; kWalk: a pass's judging and its __syncthreads_or; kCopy: the
// collapse; kHeads: the count, its scan, the flags and the heads), and at
// the end its sums and one task to g_cuts_clocks. The build also has an empty kernel of the
// same block (cuts_empty), the launch floor. Without the flag the stamps are
// empty and the file compiles to the same code.
enum CutPart { kInitial, kScans, kWalk, kCopy, kHeads, kCutParts };
#ifdef CUTS_CLOCKS
__device__ unsigned long long g_cuts_clocks[kCutParts + 1];  // the parts, then the tasks
struct CutClock {
  long long t;
  unsigned long long sum[kCutParts];
  __device__ __forceinline__ void start() {
    __syncthreads();
    t = clock64();
    for (int p = 0; p < kCutParts; ++p) sum[p] = 0;
  }
  __device__ __forceinline__ void stamp(int p) {
    __syncthreads();
    const long long now = clock64();
    sum[p] += static_cast<unsigned long long>(now - t);
    t = now;
  }
  __device__ __forceinline__ void flush() {
    if (threadIdx.x != 0) return;
    for (int p = 0; p < kCutParts; ++p) atomicAdd(&g_cuts_clocks[p], sum[p]);
    atomicAdd(&g_cuts_clocks[kCutParts], 1ULL);
  }
};
#else
struct CutClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stamp(int) {}
  __device__ __forceinline__ void flush() {}
};
#endif

__device__ __forceinline__ bool type_cut(const int32_t* __restrict__ seed_type, int j) {
  return j == 0 || seed_type[j] != seed_type[j - 1];
}

// A task's candidate cuts, in slot order: the initial cuts (the only cuts
// a pass can keep): S the start_bp of the candidate's seed, E the end_bp of
// the seed before it, P its slot, with bit 31 set at a type cut; and 32
// candidates a word: A the alive bits (this pass's partition), N the next
// pass's; Bf and Af a word's last alive candidate before it (-1 for none)
// and first after it (INT_MAX for none). cand_ints(cap) ints hold cap
// candidates, in shared memory or in the task's global scratch.
struct Cands {
  int* S;
  int* E;
  int* P;
  unsigned* A;
  unsigned* N;
  int* Bf;
  int* Af;
};

__host__ __device__ constexpr size_t cand_words(long long cap) {
  return static_cast<size_t>((cap + 31) / 32);
}
__host__ __device__ constexpr size_t cand_ints(long long cap) {
  return 3 * static_cast<size_t>(cap) + 4 * cand_words(cap);
}

__device__ __forceinline__ Cands cands_at(int* base, int cap) {
  const size_t words = cand_words(cap);
  unsigned* w = reinterpret_cast<unsigned*>(base + 3 * static_cast<size_t>(cap));
  return Cands{base, base + cap, base + 2 * static_cast<size_t>(cap), w, w + words,
               reinterpret_cast<int*>(w + 2 * words), reinterpret_cast<int*>(w + 3 * words)};
}

// The exclusive sum of x over the block's threads before this one, and
// (*total) over all of them: warp shuffles, then the warp totals through
// wsum, scanned by shuffles in every warp. A barrier inside; a caller
// reusing wsum puts a barrier between two calls.
__device__ __forceinline__ int block_excl_sum(int x, int* total, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  const int w = lane < warps ? wsum[lane] : 0;
  int winc = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, winc, o);
    if (lane >= o) winc += v;
  }
  *total = __shfl_sync(kFull, winc, 31);
  return __shfl_sync(kFull, winc - w, warp) + inc - x;
}

// kStageItems consecutive values of a column from j0 on (j0 a multiple of
// kStageItems), 0 past `live`: one 16-byte load where the column is 16-byte
// aligned, else one load a value.
__device__ __forceinline__ int4 stage_load(const int32_t* __restrict__ col, int j0, int live,
                                           bool vec) {
  if (vec && j0 + kStageItems <= live) return *reinterpret_cast<const int4*>(col + j0);
  return make_int4(j0 < live ? col[j0] : 0, j0 + 1 < live ? col[j0 + 1] : 0,
                   j0 + 2 < live ? col[j0 + 2] : 0, j0 + 3 < live ? col[j0 + 3] : 0);
}

// The candidates among the live seeds, every seed read once (coalesced:
// kStageItems consecutive seeds a thread, by 16-byte loads where the
// columns are aligned; a seed's predecessor from the lane before, the
// first lane's by a load of its own): a svtype's first seed, or a gap
// beyond both caps in float32. Writes the first `cap` of them, in order,
// into c (S, E, and P with the type cut in bit 31), and a 0 cut flag for
// every live seed; returns how many there are.
__device__ __forceinline__ int stage_cands(const Cands& c, int cap,
                                           const int32_t* __restrict__ seed_type,
                                           const int32_t* __restrict__ start_bp,
                                           const int32_t* __restrict__ end_bp, uint8_t* cut,
                                           int live, float const_gap, int* wsum) {
  static_assert(kStageItems == 4, "a thread stages one int4 of each column");
  const int lane = threadIdx.x & 31;
  const uintptr_t at = reinterpret_cast<uintptr_t>(seed_type) |
                       reinterpret_cast<uintptr_t>(start_bp) | reinterpret_cast<uintptr_t>(end_bp);
  const bool vec = (at & 15) == 0;
  int m = 0;
  for (int base = 0; base < live; base += blockDim.x * kStageItems) {
    const int j0 = base + threadIdx.x * kStageItems;
    const int4 sv = stage_load(start_bp, j0, live, vec);
    const int4 tv = stage_load(seed_type, j0, live, vec);
    const int4 ev = stage_load(end_bp, j0, live, vec);
    // the seed before j0: the lane before's last, the first lane's loaded
    int tp = __shfl_up_sync(kFull, tv.w, 1), ep = __shfl_up_sync(kFull, ev.w, 1);
    if (lane == 0) {
      tp = j0 > 0 && j0 < live ? seed_type[j0 - 1] : 0;
      ep = j0 > 0 && j0 < live ? end_bp[j0 - 1] : 0;
    }
    const int sj[kStageItems] = {sv.x, sv.y, sv.z, sv.w};
    const int ty[kStageItems] = {tv.x, tv.y, tv.z, tv.w};
    const int ej[kStageItems] = {ep, ev.x, ev.y, ev.z};  // the end_bp before each seed
    const int tq[kStageItems] = {tp, tv.x, tv.y, tv.z};  // and the svtype
    unsigned cand = 0, type = 0;
#pragma unroll
    for (int u = 0; u < kStageItems; ++u) {
      const int j = j0 + u;
      if (j >= live) continue;
      const bool t = j == 0 || ty[u] != tq[u];
      type |= static_cast<unsigned>(t) << u;
      cand |= static_cast<unsigned>(t || __int2float_rn(sj[u] - ej[u]) > const_gap) << u;
      cut[j] = 0;
    }
    int total;
    int k = m + block_excl_sum(__popc(cand), &total, wsum);
#pragma unroll
    for (int u = 0; u < kStageItems; ++u) {
      if (!((cand >> u) & 1)) continue;
      if (k < cap) {
        c.S[k] = sj[u];
        c.E[k] = ej[u];
        c.P[k] = (j0 + u) | static_cast<int>(((type >> u) & 1) << 31);
      }
      ++k;
    }
    m += total;
    __syncthreads();  // wsum is read before the next tile writes it
  }
  return m;
}

// A pass's neighbours across words: each word's last alive candidate
// before it (Bf) and first after it (Af). Each thread takes a run of words:
// their last and first alive candidates, scanned across the block by warp
// shuffles and one exchange of the warp totals (wa, wb). Two barriers.
__device__ __forceinline__ void find_neighbours(const Cands& c, int words, int* wa, int* wb,
                                                CutClock& clk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int per = (words + warps * 32 - 1) / (warps * 32);
  const int w0 = min(static_cast<int>(threadIdx.x) * per, words), w1 = min(w0 + per, words);
  int last = -1, first = INT_MAX;
  for (int w = w0; w < w1; ++w) {
    const unsigned a = c.A[w];
    if (a && first == INT_MAX) first = 32 * w + __ffs(a) - 1;
    if (a) last = 32 * w + 31 - __clz(a);
  }
  int mx = last, mn = first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, mx, o), down = __shfl_down_sync(kFull, mn, o);
    if (lane >= o) mx = max(mx, up);
    if (lane + o < 32) mn = min(mn, down);
  }
  if (lane == 31) wa[warp] = mx;
  if (lane == 0) wb[warp] = mn;
  __syncthreads();
  // the warps' totals, scanned the same way in every warp
  int va = lane < warps ? wa[lane] : -1, vb = lane < warps ? wb[lane] : INT_MAX;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, va, o), down = __shfl_down_sync(kFull, vb, o);
    if (lane >= o) va = max(va, up);
    if (lane + o < 32) vb = min(vb, down);
  }
  const int ahead = __shfl_sync(kFull, va, (warp + 31) & 31);
  const int behind = __shfl_sync(kFull, vb, (warp + 1) & 31);
  int before = __shfl_up_sync(kFull, mx, 1), after = __shfl_down_sync(kFull, mn, 1);
  if (lane == 0) before = -1;
  if (lane == 31) after = INT_MAX;
  if (warp > 0) before = max(before, ahead);
  if (warp + 1 < warps) after = min(after, behind);
  for (int w = w0; w < w1; ++w) {
    c.Bf[w] = before;
    const unsigned a = c.A[w];
    if (a) before = 32 * w + 31 - __clz(a);
  }
  for (int w = w1 - 1; w >= w0; --w) {
    c.Af[w] = after;
    const unsigned a = c.A[w];
    if (a) after = 32 * w + __ffs(a) - 1;
  }
  __syncthreads();
  clk.stamp(kScans);
}

// One pass over the m candidates (words of them): a cut that is not a type
// cut is kept while gap > cluster_r * min(span_left, span_right) in float32,
// the spans those of the segments either side of it in this pass's partition
// (A); writes the next partition into N. The neighbours across words come
// from find_neighbours (the first pass, every candidate alive, needs none);
// then a warp a word, a lane a candidate, the neighbours inside the word
// from its bits. Three barriers (one on the first pass); returns whether
// any cut was dropped (block-uniform).
__device__ __forceinline__ bool cut_pass(const Cands& c, int m, int words, int e_last,
                                         float cluster_r, bool first_pass, int* wa, int* wb,
                                         CutClock& clk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (!first_pass) find_neighbours(c, words, wa, wb, clk);

  bool dropped = false;
  for (int w = warp; w < words; w += warps) {
    const int k = 32 * w + lane;
    const unsigned a = first_pass ? __ballot_sync(kFull, k < m) : c.A[w];
    bool keep = (a >> lane) & 1;
    if (keep && c.P[k] >= 0) {  // alive, and not a type cut
      // a type cut (candidate 0 is one) lies before every other cut
      const unsigned lower = a & ((1u << lane) - 1);
      const unsigned upper = lane == 31 ? 0u : a & ~((2u << lane) - 1);
      // the first pass: every candidate alive, the neighbours k -/+ 1
      const int prev = first_pass ? k - 1 : lower ? 32 * w + 31 - __clz(lower) : c.Bf[w];
      const int next = first_pass ? k + 1 : upper ? 32 * w + __ffs(upper) - 1 : c.Af[w];
      const int s_k = c.S[k], e_k = c.E[k];
      const float gap = __int2float_rn(s_k - e_k);
      const float span_l = __int2float_rn(e_k - c.S[prev]);
      const float span_r = __int2float_rn((next < m ? c.E[next] : e_last) - s_k);
      keep = gap > __fmul_rn(cluster_r, fminf(span_l, span_r));
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    if (lane == 0) c.N[w] = kept;
    dropped |= kept != a;
  }
  dropped = __syncthreads_or(dropped);
  clk.stamp(kWalk);
  return dropped;
}

// The passes over a task's m staged candidates and its outputs: the cut
// flags (1 at each final cut; stage_cands wrote the 0s), the heads in
// order (a warp a word: each word's offset from a scan of the words'
// counts, by every warp itself up to 32 words, else by the block; a lane a
// cut), the counts. Inlined once for shared memory
// and once for the global scratch, so that each copy addresses its own
// memory.
__device__ __forceinline__ void partition(Cands c, int m, int e_last, uint8_t* cut,
                                          int32_t* heads, int32_t* counts, float cluster_r,
                                          int* wsum, int* wa, int* wb, CutClock& clk) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const int words = static_cast<int>(cand_words(m));
  clk.stamp(kInitial);

  int passes = 0;
  bool changed = true;
  while (changed && passes < kMaxPasses) {
    ++passes;
    changed = cut_pass(c, m, words, e_last, cluster_r, passes == 1, wa, wb, clk);
    unsigned* swap = c.A;
    c.A = c.N;
    c.N = swap;
  }
  // after a collapse, the type cuts only (a warp a word)
  if (changed) {
    for (int w = warp; w < words; w += warps) {
      const int k = 32 * w + lane;
      const unsigned type = __ballot_sync(kFull, k < m && c.P[k] < 0);
      if (lane == 0) c.A[w] = type;
    }
    __syncthreads();
  }
  clk.stamp(kCopy);

  // each word's first head, then a warp a word writes its heads
  int segments;
  if (words <= 32) {
    // up to 32 words: every warp scans their counts itself, no barrier
    const unsigned mine = lane < words ? c.A[lane] : 0u;
    int inc = __popc(mine);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += v;
    }
    segments = __shfl_sync(kFull, inc, 31);
    const int first = inc - __popc(mine);
    for (int w = warp; w < words; w += warps) {
      const unsigned a = __shfl_sync(kFull, mine, w);
      const int at = __shfl_sync(kFull, first, w);
      if ((a >> lane) & 1) {
        const int slot = c.P[32 * w + lane] & INT_MAX;
        cut[slot] = 1;
        heads[at + __popc(a & ((1u << lane) - 1))] = slot;
      }
    }
  } else {
    // a thread's run of words, its offset from the block's sum of their
    // counts (into Bf, free after the passes)
    const int per = (words + warps * 32 - 1) / (warps * 32);
    const int w0 = min(t * per, words), w1 = min(w0 + per, words);
    int count = 0;
    for (int w = w0; w < w1; ++w) count += __popc(c.A[w]);
    int offset = block_excl_sum(count, &segments, wsum);
    for (int w = w0; w < w1; ++w) {
      c.Bf[w] = offset;
      offset += __popc(c.A[w]);
    }
    __syncthreads();
    for (int w = warp; w < words; w += warps) {
      const unsigned a = c.A[w];
      if ((a >> lane) & 1) {
        const int slot = c.P[32 * w + lane] & INT_MAX;
        cut[slot] = 1;
        heads[c.Bf[w] + __popc(a & ((1u << lane) - 1))] = slot;
      }
    }
  }
  if (t == 0) {
    counts[kIterations] = 0;
    counts[kDepth] = 0;
    counts[kSegments] = segments;
    counts[kPasses] = passes;
    counts[kCollapsed] = changed;
  }
  clk.stamp(kHeads);
}

// The partition of one task a block. A candidate cut (an initial cut: a
// svtype's first seed, or a gap beyond both caps) is the only kind of cut a
// pass can keep, so the passes run over the candidates alone, staged once
// from the live seeds' columns by coalesced loads into shared memory (up to
// smem_cap of them; past it, staged again into the task's global scratch:
// the same code on other pointers). The cut flags are bits, one word a 32
// candidates; a pass judges every cut on the last pass's bits (see
// cut_pass) with three barriers, and nothing is read back from global
// memory. Only the final flags (0 for every live seed, then 1 at each cut)
// and the heads are written; after kMaxPasses passes that still changed the
// partition, the type cuts only.
__global__ void __launch_bounds__(kCutThreads) sweep_cuts_kernel(
    const int32_t* __restrict__ seed_type, const int32_t* __restrict__ start_bp,
    const int32_t* __restrict__ end_bp, const int32_t* __restrict__ nseeds_ptr, uint8_t* cut,
    int32_t* scratch, int32_t* heads, int32_t* counts, int n, int smem_cap, float cluster_r,
    float const_gap) {
  extern __shared__ int smem[];
  __shared__ int wsum[32], wa[32], wb[32];
  // this block's task
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  seed_type += row;
  start_bp += row;
  end_bp += row;
  nseeds_ptr += blockIdx.x;
  cut += row;
  heads += row;
  scratch += static_cast<size_t>(blockIdx.x) * cand_ints(n);
  counts += blockIdx.x * kCounts;
  CutClock clk;
  clk.start();

  const int live = min(max(*nseeds_ptr, 0), n);
  const int e_last = live > 0 ? end_bp[live - 1] : 0;  // in flight during the staging
  const int m = stage_cands(cands_at(smem, smem_cap), smem_cap, seed_type, start_bp, end_bp,
                            cut, live, const_gap, wsum);
  if (m <= smem_cap) {
    partition(cands_at(smem, smem_cap), m, e_last, cut, heads, counts, cluster_r, wsum, wa, wb,
              clk);
  } else {
    stage_cands(cands_at(scratch, n), n, seed_type, start_bp, end_bp, cut, live, const_gap,
                wsum);
    partition(cands_at(scratch, n), m, e_last, cut, heads, counts, cluster_r, wsum, wa, wb, clk);
  }
  clk.flush();
}

#ifdef CUTS_CLOCKS
__global__ void __launch_bounds__(kCutThreads) empty_kernel() {}
#endif

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

// sweep_cuts' largest dynamic shared memory (kSmemCands candidates), its
// attribute set once a device: a launch past 48 KB needs it
cudaError_t cuts_smem() {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(sweep_cuts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cand_ints(kSmemCands) * sizeof(int)));
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

}  // namespace

// Both entry points take k tasks of n slots each ([k, n] arrays, nseeds
// [k], counts [k, 5]; merge_sweep also head_mask [k]); k = 1 is a single
// task. sweep_cuts takes no head mask: a type change is an unconditional
// cut (the JAX package's proof, clustering.py:296-311, holds whatever the
// head's pointer start), so the partition does not depend on it. Its
// scratch holds cand_ints(n) ints a task ([k, cand_ints(n)]), read only by a
// task with more candidates than shared memory takes: min(smem_cands,
// kSmemCands) of them (smem_cands < 0: kSmemCands).
extern "C" int sweep_cuts(const int32_t* seed_type, const int32_t* start_bp,
                          const int32_t* end_bp, const int32_t* nseeds, uint8_t* cut,
                          int32_t* scratch, int32_t* heads, int32_t* counts, int n, int k,
                          float cluster_r, float const_gap, int smem_cands, cudaStream_t s) {
  if (n <= 0 || k <= 0 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = std::min(n, smem_cands < 0 ? kSmemCands : std::min(smem_cands, kSmemCands));
  const size_t bytes = cand_ints(cap) * sizeof(int);
  const cudaError_t err = cuts_smem();
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  sweep_cuts_kernel<<<k, kCutThreads, bytes, s>>>(seed_type, start_bp, end_bp, nseeds, cut,
                                                  scratch, heads, counts, n, cap, cluster_r,
                                                  const_gap);
  return static_cast<int>(cudaGetLastError());
}

#ifdef CUTS_CLOCKS
// The partition's cycles by part and its tasks summed since the last call
// (kCutParts + 1 words to out, on the host), then zeroed; and k blocks of an
// empty kernel of sweep_cuts' block on stream s. A -DCUTS_CLOCKS build only.
extern "C" int cuts_clocks(uint64_t* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_cuts_clocks, sizeof(g_cuts_clocks));
  static const unsigned long long zero[kCutParts + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_cuts_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}

extern "C" int cuts_empty(int k, cudaStream_t s) {
  if (k <= 0 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<k, kCutThreads, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
#endif

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
