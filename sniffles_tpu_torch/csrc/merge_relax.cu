// The parallel fixed-point relaxation of the fused calling engine on Hopper
// (sm_90a): the merge stage of the JAX package's _cluster_body with
// exact_sweep=False.
//
// Replaces the XLA program of sniffles_tpu/ops/clustering.py:709-758: a
// lax.while_loop (at most MERGE_ITERS_MAX = 32 rounds, :48) of merge_step
// (:717-746), which segments the sorted batch at its boundaries, computes
// each segment's start and end bp, tandem-repeat flag and compute_metrics
// (subsampled mean svlen, stdev of the start positions), and clears every
// boundary whose segment merges into the one before it (the reference's
// criteria m1, m2, m3, cluster.py:163-171; same svtype, valid, never the
// first). It stops after a round that changed no boundary or after 32.
//
// Design: one persistent cooperative launch runs every round, over a list
// of the live segment heads rather than over the slots.
//   * The grid is the card's resident grid (the occupancy of relax_kernel
//     times the SM count, cached per device), launched with
//     cudaLaunchCooperativeKernel; the phases meet at grid barriers
//     (cooperative_groups' grid.sync(), which needs no relocatable device
//     code since CUDA 11). A round is the metrics phase, a barrier, the
//     merge phase and a barrier; every block reads the round's change flag
//     after the second and leaves the loop after the first round that
//     changed nothing, or after 32. The kernel writes the round count JAX's
//     loop runs itself. No host synchronisation: the occupancy query and
//     the attribute read are host calls that do not wait for the device.
//   * The head list: built once from the seed boundaries (4 slots a thread,
//     one atomicAdd a block: a counter bumped by every warp held the 2^21
//     slots' list to one increment at a time), then rebuilt by each merge
//     phase from the heads that kept their boundary, into the other of two
//     buffers. Its order does not matter: a head writes only its own slot
//     and prev_head of the head after it, and in the merge phase only its
//     own boundary and walk_round of the head before it. Only valid heads
//     are listed: a segment is all valid or all invalid (invalid slots sort
//     last and the seed boundary before the first of them is never cleared,
//     since a merge needs a valid head), no invalid head merges, and a
//     valid head's predecessor is valid, so nothing reads an invalid head's
//     metrics.
//   * A head's segment is walked again only in the round after a merge
//     joined its successor to it (walk_round[h] == r; every head in round
//     0). A pair whose two segments did not change gives the same criteria
//     as before, and the merge phase still evaluates every live head, so
//     each round's boundaries are JAX's.
//   * The metrics phase gives each thread a head: a segment of up to
//     kLaneWalk slots it walks (to the next boundary: a segment is its
//     head's contiguous run, so no scan of segment ids is needed) and takes
//     range_metrics (range_metrics.cuh) serially. A longer one goes to a
//     queue, and after a barrier a tile of lanes walks each queued segment:
//     a whole warp when there are no more queued segments than warps (the
//     long chains of the last rounds), else kSmallTile lanes (the many
//     short segments of the first round); a lane reads 4 slots with one
//     vector load a column, a ballot finds the next boundary, min, max and
//     or are tile reductions, and the stride picks are spread over the
//     lanes. The pick sums of svlen and pos add at most 256 float32 values
//     of integers below 2^31 in double: every partial sum is an integer
//     below 2^40, exact in any order, so a tile reduction gives the serial
//     sum's bits. The sum of the squared deviations is not exact in any
//     order: the lanes write the float32 squares to shared memory and the
//     tile's first lane adds them in pick order, as range_metrics does (a
//     first lane that loads and squares the picks itself, in order, was
//     slower on the H100).
//     (On the H100, a lane's serial walk is one dependent load a slot, and
//     a round waits for its longest; a whole warp for each of the first
//     round's tens of thousands of short segments leaves the grid queued
//     behind a few walks a warp. sniffles_tpu_torch/tools/time_merge_relax.py
//     splits a run's time by round.)
//   * Slots written by other blocks within the launch (boundaries, metrics,
//     prev_head, the lists and counters) are read with ld.global.cg (L2,
//     never a stale L1 line); the sorted inputs never change and go
//     through the read-only path. Boolean columns are the bytes of torch
//     bool tensors, and positions and lengths are read as int32 and taken
//     as float32 in the kernel (round to nearest, as torch's .to(float32)):
//     the wrapper converts nothing.
// A merge_relax call is the memset of the control words and the one
// launch; a refused cooperative launch (cudaErrorCooperativeLaunchTooLarge)
// or any launch error is returned, never retried another way.
//
// Float32 arithmetic through __f*_rn (never contracted into an FMA), as the
// plain version (ops/merge_relax.py::merge_step_plain) rounds it; int32
// differences wrap, as XLA's do.
//
// Bound: latency, not bytes (relax_bytes in chip_smoke.py: 20 bytes a slot
// read once). A round costs two or three grid barriers, the longest
// segment's walk (kWarpChunks vector loads a lane and iteration), and one
// pass over the live heads.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>

#include "range_metrics.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 32;     // MERGE_ITERS_MAX
constexpr int kSvtypeBnd = 4;
constexpr int kLaneWalk = 2;    // a lane walks a segment of up to this many slots
constexpr int kWarpChunks = 4;  // a tile's walk reads 4 vector chunks an iteration
constexpr int kSmallTile = 8;   // lanes a long segment when there are more than warps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// the control words: a change flag a round, the two head lists' counts, the
// long-segment queue's count and the round count
constexpr int kCount = kRounds, kLong = kRounds + 2, kRoundsOut = kRounds + 3,
              kCtl = kRounds + 4;

struct RelaxArgs {
  const int32_t* pos;      // [n] the sorted batch's positions and lengths (int32,
  const int32_t* svlen;    //     taken as float32 where the metrics need them)
  const int32_t* svtype;
  const int32_t* bin;
  const uint8_t* repeat;   // [n] bool bytes
  const uint8_t* valid;    // [n] bool bytes
  uint8_t* bound;          // [n] bool bytes: the seed boundaries in, the final ones out
  int4* seg;               // [n] a head's start_bp, end_bp, mean svlen, start stdev
  uint8_t* rep;            // [n] a head's repeat flag
  int32_t* prev_head;      // [n] the head before a head
  int32_t* walk_round;     // [n] the round in which a head's segment is walked
  int32_t* heads0;         // [n] the two head lists; the one a round builds
  int32_t* heads1;         //     first holds its queue of long segments
  int32_t* ctl;            // [kCtl] the control words, zero on entry
  long long* stamps;       // [2 * kRounds + 2] device time stamps, or null
  int n, binsize;
  float cluster_r, repeat_h, repeat_h_max;
  int merge_bnd, global_repeat;
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// %globaltimer of block 0's first thread into stamps[k], when asked for
__device__ __forceinline__ void stamp(const RelaxArgs& a, int k) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[k] = static_cast<long long>(t);
  }
}

__device__ __forceinline__ void write_segment(const RelaxArgs& a, int h, int e, int lo,
                                              int hi, bool any_rep, float msv, float sd) {
  if (e < a.n) a.prev_head[e] = h;
  a.seg[h] = make_int4(lo, hi, __float_as_int(msv), __float_as_int(sd));
  a.rep[h] = any_rep ? 1 : 0;
}

// A lane's walk of the segment at head h: the whole segment when it ends
// within kLaneWalk slots (returns false), else nothing written (true: the
// segment is long).
__device__ bool lane_walk(const RelaxArgs& a, int h) {
  int lo = INT_MAX, hi = INT_MIN;
  uint8_t any_rep = 0;
  int e = h;
  do {
    const int b = wrap_mul(__ldg(a.bin + e), a.binsize);
    lo = min(lo, b);
    hi = max(hi, wrap_add(b, a.binsize));
    any_rep |= __ldg(a.repeat + e);
    ++e;
  } while (e < a.n && !__ldcg(a.bound + e) && e - h < kLaneWalk);
  if (e < a.n && !__ldcg(a.bound + e)) return true;
  float msv, sd;
  sniffles::range_metrics(a.pos, a.svlen, a.n, h, e, &msv, &sd);
  write_segment(a, h, e, lo, hi, any_rep != 0, msv, sd);
  return false;
}

// Slots j..j+3 (j a multiple of 4): a bit a slot that ends the segment at
// head h (the next boundary, or past the last slot), their bins and their
// repeat flags (a byte each). Vector loads where all four slots exist.
__device__ __forceinline__ void load4(const RelaxArgs& a, int j, int h, unsigned* ends,
                                      int4* bins, unsigned* reps) {
  unsigned bnd = 0, rep = 0;
  if (j + 3 < a.n) {
    bnd = __ldcg(reinterpret_cast<const unsigned*>(a.bound + j));
    rep = __ldg(reinterpret_cast<const unsigned*>(a.repeat + j));
    *bins = __ldg(reinterpret_cast<const int4*>(a.bin + j));
  } else {
    int b[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < a.n) {
        bnd |= static_cast<unsigned>(__ldcg(a.bound + j + q)) << (8 * q);
        rep |= static_cast<unsigned>(__ldg(a.repeat + j + q)) << (8 * q);
        b[q] = __ldg(a.bin + j + q);
      } else {
        bnd |= 1u << (8 * q);  // past the last slot: an end
      }
    }
    *bins = make_int4(b[0], b[1], b[2], b[3]);
  }
  unsigned e = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (j + q > h && ((bnd >> (8 * q)) & 0xffu)) e |= 1u << q;
  }
  *ends = e;
  *reps = rep;
}

__device__ __forceinline__ int lane_of(const int4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// A tile of G lanes walks the segment at head h (h the same in each of its
// lanes): range_metrics' result bit for bit (see the note above); `sq` is
// the tile's shared buffer of sniffles::kPickCap floats. Each lane reads 4
// slots a vector chunk, kWarpChunks chunks an iteration.
template <int G>
__device__ void tile_walk(const RelaxArgs& a, int h, float* sq, cg::thread_block_tile<G> tile) {
  constexpr int kSpan = 4 * G;
  const int t = static_cast<int>(tile.thread_rank());
  int lo = INT_MAX, hi = INT_MIN;
  unsigned any_rep = 0;
  int e = -1;
  for (int j0 = h & ~3; e < 0; j0 += kWarpChunks * kSpan) {
    unsigned ends[kWarpChunks], reps[kWarpChunks];
    int4 bins[kWarpChunks];
#pragma unroll
    for (int c = 0; c < kWarpChunks; ++c) {
      load4(a, j0 + c * kSpan + 4 * t, h, &ends[c], &bins[c], &reps[c]);
    }
#pragma unroll
    for (int c = 0; c < kWarpChunks; ++c) {
      if (e >= 0) break;  // the same in every lane of the tile
      const int j = j0 + c * kSpan + 4 * t;
      const unsigned m = tile.ballot(ends[c] != 0);
      const int mine = ends[c] ? j + __ffs(ends[c]) - 1 : INT_MAX;
      const int first = m ? tile.shfl(mine, __ffs(m) - 1) : INT_MAX;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j + q >= h && j + q < first) {
          const int b = wrap_mul(lane_of(bins[c], q), a.binsize);
          lo = min(lo, b);
          hi = max(hi, wrap_add(b, a.binsize));
          any_rep |= (reps[c] >> (8 * q)) & 0xffu;
        }
      }
      if (m) e = first;
    }
  }
  lo = cg::reduce(tile, lo, cg::less<int>());
  hi = cg::reduce(tile, hi, cg::greater<int>());
  any_rep = cg::reduce(tile, any_rep, cg::bit_or<unsigned>());

  // range_metrics over [h, e): the same picks, stride and divisions
  const int L = e - h;
  const int nn = L < 100 ? L : 100;
  const int q = L / (nn > 1 ? nn : 1);
  const int stride = q > 1 ? q : 1;
  const int npicks = min((L + stride - 1) / stride, sniffles::kPickCap);
  double sum_sv = 0.0, sum_ps = 0.0;
  for (int k = t; k < npicks; k += G) {
    const int idx = sniffles::clamp_slot(h + k * stride, a.n);
    sum_sv += static_cast<double>(static_cast<float>(__ldg(a.svlen + idx)));
    sum_ps += static_cast<double>(static_cast<float>(__ldg(a.pos + idx)));
  }
  for (int o = G / 2; o > 0; o >>= 1) {
    sum_sv += tile.shfl_xor(sum_sv, o);
    sum_ps += tile.shfl_xor(sum_ps, o);
  }
  const float msv = __fdiv_rn(static_cast<float>(sum_sv), static_cast<float>(nn > 1 ? nn : 1));
  const float mean_ps = __fdiv_rn(static_cast<float>(sum_ps),
                                  static_cast<float>(npicks > 1 ? npicks : 1));
  for (int k = t; k < npicks; k += G) {
    const float dev = __fsub_rn(
        static_cast<float>(__ldg(a.pos + sniffles::clamp_slot(h + k * stride, a.n))), mean_ps);
    sq[k] = __fmul_rn(dev, dev);
  }
  tile.sync();
  if (t == 0) {
    // in pick order, four loads ahead of the adds
    double ss = 0.0;
    int k = 0;
    for (; k + 4 <= npicks; k += 4) {
      const float x0 = sq[k], x1 = sq[k + 1], x2 = sq[k + 2], x3 = sq[k + 3];
      ss += static_cast<double>(x0);
      ss += static_cast<double>(x1);
      ss += static_cast<double>(x2);
      ss += static_cast<double>(x3);
    }
    for (; k < npicks; ++k) ss += static_cast<double>(sq[k]);
    const float sd = npicks >= 2
                         ? __fsqrt_rn(__fdiv_rn(static_cast<float>(ss),
                                                static_cast<float>(npicks - 1 > 1 ? npicks - 1
                                                                                  : 1)))
                         : 0.0f;
    write_segment(a, h, e, lo, hi, any_rep != 0, msv, sd);
  }
  tile.sync();  // before the tile's next segment overwrites sq
}

// The queued long segments, a tile of G lanes each; `sq` is the block's
// shared buffers, one a tile.
template <int G>
__device__ void walk_queue(const RelaxArgs& a, const int32_t* queue, int queued,
                           float (*sq)[sniffles::kPickCap]) {
  const cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int tiles = gridDim.x * (kThreads / G);
  for (int k = (blockIdx.x * kThreads + threadIdx.x) / G; k < queued; k += tiles) {
    tile_walk<G>(a, __ldcg(queue + k), sq[threadIdx.x / G], tile);
  }
}

// Appends the block's heads to list (count at *count): bit q of `heads`
// stands for the head first + q, a thread's in ascending order, the
// threads' in a run each; one atomicAdd a block. Every thread of the block
// calls it; `warp_off` and `base` are the block's shared words.
__device__ __forceinline__ void block_append(unsigned heads, int first, int32_t* list,
                                             int32_t* count, int* warp_off, int* base) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mine = __popc(heads);
  int incl = mine;  // the warp's inclusive scan of the counts
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_off[w] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int c = warp_off[i];
      warp_off[i] = total;
      total += c;
    }
    *base = total ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  int at = *base + warp_off[w] + incl - mine;
  for (unsigned m = heads; m; m &= m - 1) list[at++] = first + __ffs(m) - 1;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) relax_kernel(const RelaxArgs a) {
  __shared__ float sq[kThreads / kSmallTile][sniffles::kPickCap];
  __shared__ int warp_off[kWarps], block_base;
  cg::grid_group grid = cg::this_grid();
  const int nwarps = gridDim.x * kWarps;
  const int stride = gridDim.x * kThreads;
  stamp(a, 0);

  // the valid seed heads, each walked in round 0: 4 slots a thread
  for (int base = blockIdx.x * kThreads * 4; base < a.n; base += stride * 4) {
    const int i = base + 4 * threadIdx.x;
    unsigned heads = 0;
    if (i + 3 < a.n) {
      const unsigned b = __ldcg(reinterpret_cast<const unsigned*>(a.bound + i)) &
                         __ldg(reinterpret_cast<const unsigned*>(a.valid + i));
#pragma unroll
      for (int q = 0; q < 4; ++q) heads |= ((b >> (8 * q)) & 1u) << q;
    } else {
      for (int q = 0; q < 4 && i + q < a.n; ++q)
        heads |= static_cast<unsigned>(__ldcg(a.bound + i + q) && __ldg(a.valid + i + q)) << q;
    }
    for (unsigned m = heads; m; m &= m - 1) a.walk_round[i + __ffs(m) - 1] = 0;
    block_append(heads, i, a.heads0, a.ctl + kCount, warp_off, &block_base);
  }
  grid.sync();
  stamp(a, 1);

  int rounds = kRounds;
  for (int r = 0; r < kRounds; ++r) {
    const int cur = r & 1, nxt = cur ^ 1;
    const int32_t* list = cur ? a.heads1 : a.heads0;
    int32_t* next = cur ? a.heads0 : a.heads1;
    const int cnt = __ldcg(a.ctl + kCount + cur);

    // metrics: a lane a head whose segment grew; long segments queued
    for (int base = blockIdx.x * kThreads; base < cnt; base += stride) {
      const int k = base + threadIdx.x;
      const int h = k < cnt ? __ldcg(list + k) : -1;
      const bool walk = h >= 0 && __ldcg(a.walk_round + h) == r;
      const bool longer = walk && lane_walk(a, h);
      block_append(longer ? 1u : 0u, h, next, a.ctl + kLong, warp_off, &block_base);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[kCount + nxt] = 0;
    grid.sync();
    const int queued = __ldcg(a.ctl + kLong);
    if (queued > 0) {  // the same in every thread
      if (queued <= nwarps) {
        walk_queue<32>(a, next, queued, sq);
      } else {
        walk_queue<kSmallTile>(a, next, queued, sq);
      }
      grid.sync();
    }
    stamp(a, 2 * r + 2);

    // merge: a lane a head; the heads that keep their boundary listed anew
    bool merged = false;
    for (int base = blockIdx.x * kThreads; base < cnt; base += stride) {
      const int k = base + threadIdx.x;
      const int h = k < cnt ? __ldcg(list + k) : -1;
      bool keep = h >= 0;
      if (h > 0 && __ldg(a.svtype + h) == __ldg(a.svtype + h - 1)) {
        const int p = __ldcg(a.prev_head + h);
        const int4 si = __ldcg(a.seg + h), sp = __ldcg(a.seg + p);
        const int inner = wrap_sub(si.x, sp.y);
        const int outer = wrap_sub(si.y, sp.x);
        const float sd_pair = fminf(__int_as_float(si.w), __int_as_float(sp.w));
        const bool m1 = static_cast<float>(inner) <= __fmul_rn(sd_pair, a.cluster_r);
        const bool rep_pair = __ldcg(a.rep + h) || __ldcg(a.rep + p) || a.global_repeat;
        const float h_lim = fminf(
            a.repeat_h_max, __fmul_rn(__fadd_rn(fabsf(__int_as_float(si.z)),
                                                fabsf(__int_as_float(sp.z))),
                                      a.repeat_h));
        const bool m2 = rep_pair && static_cast<float>(outer) <= h_lim;
        const bool m3 = __ldg(a.svtype + h) == kSvtypeBnd && inner <= a.merge_bnd;
        if (m1 || m2 || m3) {
          a.bound[h] = 0;
          a.walk_round[p] = r + 1;
          keep = false;
          merged = true;
        }
      }
      block_append(keep ? 1u : 0u, h, next, a.ctl + kCount + nxt, warp_off, &block_base);
    }
    if (__syncthreads_or(merged) && threadIdx.x == 0) a.ctl[r] = 1;
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[kLong] = 0;
    grid.sync();
    stamp(a, 2 * r + 3);
    if (__ldcg(a.ctl + r) == 0) {  // the same in every thread
      rounds = r + 1;
      break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[kRoundsOut] = rounds;
}

int g_grid[kMaxDevices];  // the resident grid of each device, 0 until asked

}  // namespace

// The resident grid of relax_kernel on the current device (its blocks a SM
// times the SM count), computed once a device. Returns a CUDA error, or 0.
extern "C" int merge_relax_grid(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_grid[dev] == 0) {
    int coop = 0, per_sm = 0, sms = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_kernel, kThreads, 0);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
    if (err != cudaSuccess) return static_cast<int>(err);
    g_grid[dev] = per_sm * sms;
  }
  *blocks = g_grid[dev];
  return 0;
}

// The number of int32 control words merge_relax takes (ctl).
extern "C" int merge_relax_ctl_words() { return kCtl; }

// One relaxation over n sorted slots, one cooperative launch: pos, svlen,
// svtype and bin are int32 [n], repeat and valid bool bytes [n] (every
// column 16-byte aligned); bound (bool bytes [n]) holds the seed boundaries
// on entry and the final ones on return;
// seg (int32 [n, 4]), rep (uint8 [n]), prev_head, walk_round, heads0 and
// heads1 (int32 [n]) are scratch; ctl is int32 [merge_relax_ctl_words()],
// of which ctl[kRounds + 3] receives the rounds JAX's loop runs; stamps is
// int64 [2 * 32 + 2] or null. Returns the first CUDA error, or 0.
extern "C" int merge_relax(const int32_t* pos, const int32_t* svlen, const int32_t* svtype,
                           const int32_t* bin, const uint8_t* repeat, const uint8_t* valid,
                           uint8_t* bound, int32_t* seg, uint8_t* rep, int32_t* prev_head,
                           int32_t* walk_round, int32_t* heads0, int32_t* heads1,
                           int32_t* ctl, long long* stamps, int n, int binsize,
                           float cluster_r, float repeat_h, float repeat_h_max, int merge_bnd,
                           int global_repeat, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  int rc = merge_relax_grid(&blocks);
  if (rc != 0) return rc;
  cudaError_t err = cudaMemsetAsync(ctl, 0, kCtl * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  RelaxArgs a{pos,       svlen,   svtype, bin,    repeat,    valid,
              bound,     reinterpret_cast<int4*>(seg), rep, prev_head, walk_round,
              heads0,    heads1,  ctl,    stamps, n,         binsize,
              cluster_r, repeat_h, repeat_h_max, merge_bnd, global_repeat};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)relax_kernel, dim3(blocks),
                                    dim3(kThreads), args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
