// The per-cluster calling statistics on Hopper (sm_90a): a run pass over
// the sorted cluster ids, then each live cluster sorted and summed on chip
// by a thread, a warp or a block, by its size.
//
// Replaces the XLA program of the JAX package's jitted call_statistics
// (sniffles_tpu/ops/clustering.py:1262) and the segment statistics it
// calls (ops/stats.py seg_median_modes, seg_trimmed_stdev; ops/segments.py
// seg_stdev, seg_mean, unique_count_per_segment). The plain version
// (ops/call_stats.py::call_statistics_plain) holds the JAX package's CPU
// arithmetic bit for bit; these kernels repeat it:
//   * util.median_modes: the runs of equal values of the sorted list, the
//     longest run's count, the runs within 2 of it kept, the upper median
//     of the kept values (rank n_kept / 2 among them; no cap on the
//     list's length);
//   * the trimmed sample stdev: ranks [cnt * 25 / 100, cnt - trim) of the
//     sorted list, centered on the window's minimum with int32 wrap, then
//     converted to float32; s1 and s2 added term by term in float32 in
//     sorted order, as XLA's scatter-add adds them; the numerator
//     s2 - (cnt * mean) * mean rounded at each step, or with `fused` one
//     fused multiply-add, as the jitted fused step; __fsqrt_rn;
//   * every float32 operation through __f*_rn intrinsics, never contracted;
//   * the mapq and NM means: float32 sums in array order (the cluster's
//     run in the stable sort by cluster id), over max(cnt, 1); mapq is
//     integer-valued, its sum exact below 2^24 in any order, NM's is not
//     (rates across many binades), so both add in the CPU's order; the
//     floor of the mapq mean cast to int32 as the CPU's cvttss2si;
//   * support: the distinct read ids of the cluster;
//   * svtype: the max of the valid elements' svtypes and -1 where an
//     invalid element names the slot (the plain version's seg_max over the
//     raw ids), INT32_MIN where nothing does; pos_min and pos_max the ends
//     of the sorted pos list (INT32_MAX and INT32_MIN for an empty slot);
//   * the bounds (calculate_bounds) in int32 arithmetic that wraps.
// Input: one stable sort of the keys of stat_keys (a valid element's
// cluster id c in [0, n) as c, an invalid element's raw id r in [0, n) as
// n + r, any other INT32_MAX): its sorted keys and permutation, which give
// each cluster's elements in array order, and the raw columns. Every key
// below n is a valid element's, so a run of them is a cluster; a key in
// [n, 2n) marks slot key - n as named by an invalid element; ids outside
// [0, n) are ignored, as the segment ops drop them.
//
// The run pass (stat_runs) merges the slot ids 0..2n-1 with the sorted keys
// along the merge path, in tiles of equal work whatever the gaps between the
// keys, and writes every slot's run start (n + 1 of them: slot c's run is
// [start[c], start[c + 1])) and every invalid mark, each once: nothing is
// zeroed ahead of it.
//
// Each live cluster gathers its svlen, pos and read ids through the
// permutation and sorts them itself: a sort of a cluster's values gives
// the same sorted list whatever the order of equal values, so no global
// sort by value is needed, and every statistic reads the sorted lists on
// chip. Valid values may be INT32_MAX or INT32_MIN; the comparisons are
// signed int32.
//
// The trimmed windows' s1 and s2 are exact integer reductions where their
// terms allow (sum |x| <= 2^24 for s1, sum x^2 <= 2^24 for s2: every
// partial sum of the float32 chain is then an integer that float32 holds,
// so the chain gives the integer sum in any order), else the chain itself,
// term by term in sorted order; so is the block tier's mapq sum (sum |q|
// <= 2^24). NM's sum is always its chain in array order.
//
// Tiers by the cluster's size cnt (the thresholds are build-time constants,
// -DSTAT_TINY_MAX, -DSTAT_PAIR_MAX, -DSTAT_WARP_MAX, -DSTAT_BLOCK_MAX from
// ops/call_stats.py TINY_MAX, PAIR_MAX, WARP_MAX, BLOCK_MAX):
//   * stat_slots, a thread a slot over all n slots (a resident grid,
//     coalesced; its run from two neighbouring starts): an empty slot gets
//     the identities of the plain version's reductions; a cluster of
//     cnt <= kTinyMax (<= kTinyCap) is done in the thread, its values in
//     registers, sorted by a fixed network of 19 compare-exchanges; each
//     larger cluster's entry (slot, run, count, invalid mark) goes to the
//     warp or the block list (a warp's appends by one atomic);
//   * stat_warps, a warp a cluster of the warp list, the next one's entry
//     and permutation entries loaded while it works: up to kPairMax elements
//     in two registers a lane (a coalesced gather), svlen and pos sorted by
//     shuffles (a network of 32 up to 32 elements), the read ids counted
//     unsorted by __match_any_sync, the medians from 64-bit masks of the
//     runs' ends, the windows' and mapq's sums by __reduce_add_sync, NM's
//     chain from the warp's slice of shared memory, four terms a load; past
//     that, the lists in the warp's slice, sorted by a bitonic network
//     there; the row by 16 lanes, its divisions and roots once a warp;
//   * stat_blocks, a block a cluster of cnt > kWarpMax: its lists (svlen,
//     pos, read ids, a scratch list) in dynamic shared memory up to
//     kBlockMax elements (16 bytes each; three blocks an SM), past it in a
//     global scratch buffer at the cluster's run. Seven warps gather, count
//     the distinct read ids by a hash table (no sort), then radix-sort pos
//     and svlen at once (5-bit digits counted in registers by ballots, only
//     the passes each list's range needs: no padding, a few barriers a
//     pass), then take the extents, the windows' sums in int64 and the
//     medians of both lists in one set of passes. The last warp meanwhile
//     sums NM in array order straight through the permutation, its 32 lanes
//     loading kAhead batches ahead of the adds, then runs pos's window
//     chains, where their test fails, once pos is sorted (a named barrier
//     the sorting warps arrive at).
//
// Bound: bytes. An element's cluster id and valid byte are read and its key
// written (9 bytes, stat_keys); its sorted key and permutation (12), its
// svlen, pos, read id, mapq, strand, svtype and NM (28) are read, a slot's
// run start and mark written and read back (10), and 64 bytes a slot
// written; the operations (a few dozen
// an element, the sorts' steps on chip) are below the card's integer rate.
// Most slots are empty (the live ones are the low ids), so their rows are
// written a thread a slot, coalesced. A chain's sum is sequential (one
// dependent float32 add an element), which bounds a large cluster by
// latency: NM's on the block's last warp takes two instructions a term
// (a shuffle, an add), its loads far ahead.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#if !defined(STAT_TINY_MAX) || !defined(STAT_PAIR_MAX) || !defined(STAT_WARP_MAX) || \
    !defined(STAT_BLOCK_MAX)
#error "build with the tier thresholds of ops/call_stats.py (its nvcc_defines)"
#endif

// A timing tool's variant of the entry point (tools/time_call_stats.py):
// -DSTAT_RUN_PARTS=1 returns after the run pass (ops/call_stats.RUN_PARTS),
// so that its time is the run pass's alone. 0, the default, launches
// everything. Only a timing tool builds a variant; its rows are not written.
#ifndef STAT_RUN_PARTS
#define STAT_RUN_PARTS 0
#endif

namespace {

constexpr int kThreads = 256;       // stat_slots' and stat_warps' blocks
constexpr int kKeyThreads = 256;    // stat_keys' blocks,
constexpr int kKeyItems = 4;        // and a thread's elements a round
constexpr int kRunThreads = 256;    // stat_runs' blocks,
constexpr int kRunItems = 16;       // a thread's merge steps a tile,
constexpr int kRunTile = kRunThreads * kRunItems;  // a tile's diagonals of the merge
constexpr int kProbes = 4;          // a lane's probes a round of a block's first split
constexpr int kWinLoads = (kRunTile + kRunThreads) / kRunThreads;  // a thread's of a window
// the words of a tile's keys (kRunTile + 1) and of its slots (kRunTile) in
// shared memory, one word skipped every 32 (pad): a warp's lanes, about
// kRunItems keys or slots apart, then read and write distinct banks
constexpr int kWinPad = kRunTile + 1 + (kRunTile + 1) / 32 + 1;
constexpr int kRunPad = kRunTile + kRunTile / 32;
__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }
constexpr int kMaxSlots = 1 << 30;  // n below it: the keys of the invalid marks, n + r, fit int32
constexpr int kBlockThreads = 256;  // stat_blocks: a block a cluster
constexpr int kSortWarps = kBlockThreads / 32 - 1;  // its last warp sums the NM chain
constexpr int kSortThreads = kSortWarps * 32;
constexpr int kTinyCap = 8;         // the most elements a thread sorts in registers
constexpr int kTinyMax = STAT_TINY_MAX;    // the thread tier's largest cluster
constexpr int kPairMax = STAT_PAIR_MAX;    // a warp's largest in registers (0: none)
constexpr int kWarpMax = STAT_WARP_MAX;    // the warp tier's largest cluster
constexpr int kBlockMax = STAT_BLOCK_MAX;  // a block's largest in shared memory
static_assert(kTinyMax >= 0 && kTinyMax <= kTinyCap, "a thread sorts at most kTinyCap");
static_assert(kPairMax == 0 || kPairMax == 64, "a warp's two registers a lane hold 64");
static_assert(kWarpMax >= kTinyMax && kWarpMax >= 1 && kBlockMax >= kWarpMax,
              "the tiers ascend");
constexpr int kBatch = 8;           // a lane's chain terms loaded ahead of their adds
constexpr int kAhead = 8;           // the NM chain's batches of 32 loaded ahead of their adds
constexpr int kWarpLists = 5;       // a warp's slice: svlen, pos, read ids; NM, mapq
constexpr int kDigitBits = 5;       // a radix pass's digit: 5 bits, a lane a digit
constexpr int kRadixChunks = 4;     // a radix pass's chunks of 32 a warp takes at a time
constexpr int kDigits = 1 << kDigitBits;
constexpr int kBlockLists = 4;      // a block's: svlen, pos, read ids, the sort's scratch
constexpr unsigned kExact = 1u << 24;  // integer terms add exactly in float32 up to it
constexpr unsigned kClamp = 1u << 25;  // a test's term, clamped past kExact
constexpr unsigned kFull = 0xffffffffu;
constexpr int INS = 0, DEL = 1;
constexpr int kRunParts = STAT_RUN_PARTS;
static_assert(kRunParts == 0 || kRunParts == 1, "the entry point's parts up to the run pass: one");

// A cluster's cycles by part in each of the warp and block tiers, in a
// build with -DSTAT_CLOCKS only (tools/time_call_stats.py --split): the
// warp's lane 0, or the block's thread 0, sums the clock64() cycles between
// its stamps by part (kEntry: the list entries and permutation entries;
// kGather: the columns through the permutation; kSort; kMedians: the
// medians, the support count and the extent; kChains: the float32 sums;
// kWrite: the row; kWait: a block's barriers) and adds them, and its count
// of clusters, to g_stat_clocks when it ends. In a block, the chains run
// beside the sort and the medians on a warp of their own: its lane 0 adds
// only its kChains cycles, thread 0 every other part. A stamp after
// settle(v) waits for v. Without the flag the stamps are empty and the file
// compiles to the same code.
enum Part { kEntry, kGather, kSort, kMedians, kChains, kWrite, kWait, kParts };
enum Tier { kWarpTier, kBlockTier, kTiers };
constexpr int kClockWords = kParts + 1;  // a tier's parts, then its clusters
#ifdef STAT_CLOCKS
__device__ unsigned long long g_stat_clocks[kTiers * kClockWords + 1];  // + a sink word
struct StatClock {
  long long t;
  unsigned long long sum[kParts];
  unsigned long long clusters;
  unsigned sink;
  __device__ __forceinline__ void start() {
    t = clock64();
    for (int p = 0; p < kParts; ++p) sum[p] = 0;
    clusters = 0;
    sink = 0;
  }
  __device__ __forceinline__ void stamp(int p) {
    const long long now = clock64();
    sum[p] += static_cast<unsigned long long>(now - t);
    t = now;
  }
  __device__ __forceinline__ void settle(int v) {
    asm volatile("xor.b32 %0, %0, %1;" : "+r"(sink) : "r"(v));
  }
  __device__ __forceinline__ void cluster() { ++clusters; }
  // adds the parts of `parts` (a bit a part), and the clusters where kEntry
  // is among them
  __device__ __forceinline__ void flush(Tier tier, unsigned parts) {
    unsigned long long* g = g_stat_clocks + tier * kClockWords;
    for (int p = 0; p < kParts; ++p)
      if ((parts >> p) & 1) atomicAdd(&g[p], sum[p]);
    if (clusters && ((parts >> kEntry) & 1)) atomicAdd(&g[kParts], clusters);
    atomicXor(&g_stat_clocks[kTiers * kClockWords], static_cast<unsigned long long>(sink));
  }
};
#else
struct StatClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stamp(int) {}
  __device__ __forceinline__ void settle(int) {}
  __device__ __forceinline__ void cluster() {}
  __device__ __forceinline__ void flush(Tier, unsigned) {}
};
#endif
constexpr unsigned kAllParts = (1u << kParts) - 1;

// the order of ops/call_stats.KEYS
enum Row { kSvtype, kSvlen, kPos, kEnd, kRawPos, kPosMin, kPosMax, kStdevPos, kStdevLen,
           kSupport, kLeadCount, kQual, kFwd, kRev, kNm, kNStrands, kRows };

// the raw columns of the clustered batch and the cid sort's permutation
struct Columns {
  const int64_t* order;
  const int32_t* svlen;
  const int32_t* pos;
  const int32_t* read_id;
  const int32_t* mapq;
  const int32_t* strand;
  const int32_t* svtype;
  const float* nm;
  const uint8_t* marks;  // the invalid marks: an invalid element names the slot
};

// what a live slot's row is made of
struct Stats {
  int cnt, sv, fwd, support, svlen_c, pos_c, pos_min, pos_max;
  float stdev_len, stdev_pos, mapq_sum, nm_sum;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// int32 abs as XLA's and torch's: INT32_MIN stays INT32_MIN
__device__ __forceinline__ int wrap_abs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

// a float cast to int32 as the CPU's cvttss2si: NaN and out of range give
// INT32_MIN
__device__ __forceinline__ int to_i32(float x) {
  return (x != x || x >= 2147483648.0f || x < -2147483648.0f) ? INT_MIN
                                                               : static_cast<int>(x);
}

// the trim of util.trim: cnt * 25 // 100 in int32 arithmetic (it wraps)
__device__ __forceinline__ int trim_of(int cnt) {
  const int prod = static_cast<int>(static_cast<unsigned>(cnt) * 25u);
  return prod / 100 - (prod % 100 < 0 ? 1 : 0);
}

// util.stdev of a window of k terms from its float32 sums
__device__ __forceinline__ float stdev_of(float s1, float s2, int k, bool fused) {
  if (k < 2) return 0.0f;
  const float c = __int2float_rn(k);
  const float mean = __fdiv_rn(s1, c);
  const float cm = __fmul_rn(c, mean);
  const float num = fused ? __fmaf_rn(-cm, mean, s2) : __fsub_rn(s2, __fmul_rn(cm, mean));
  float var = __fdiv_rn(num, __fsub_rn(c, 1.0f));
  var = var < 0.0f ? 0.0f : var;
  return __fsqrt_rn(var);
}

// the integer row values of a live slot, in the order of Row (the float
// keys' rows and qual left to the caller)
__device__ __forceinline__ void int_rows(const Stats& t, int (&v)[kRows]) {
  const int rev = t.cnt - t.fwd;
  const bool is_ins = t.sv == INS, is_del = t.sv == DEL;
  v[kSvtype] = t.sv;
  v[kSvlen] = t.svlen_c;
  v[kPos] = is_del ? wrap_add(t.pos_c, t.svlen_c) : t.pos_c;
  v[kEnd] = (is_ins || is_del) ? t.pos_c : wrap_add(t.pos_c, wrap_abs(t.svlen_c));
  v[kRawPos] = t.pos_c;
  v[kPosMin] = t.pos_min;
  v[kPosMax] = t.pos_max;
  v[kSupport] = t.support;
  v[kLeadCount] = t.cnt;
  v[kFwd] = t.fwd;
  v[kRev] = rev;
  v[kNStrands] = (t.fwd > 0 && rev > 0) ? 2 : 1;
}

// the row values of a live slot, in the order of Row
__device__ __forceinline__ void row_values(const Stats& t, int (&v)[kRows]) {
  const float div = __int2float_rn(t.cnt);
  int_rows(t, v);
  v[kStdevPos] = __float_as_int(t.stdev_pos);
  v[kStdevLen] = __float_as_int(t.stdev_len);
  v[kQual] = to_i32(floorf(__fdiv_rn(t.mapq_sum, div)));
  v[kNm] = __float_as_int(__fdiv_rn(t.nm_sum, div));
}

// a live slot's row by one thread
__device__ void write_live(int32_t* __restrict__ out, int n, int c, const Stats& t) {
  int v[kRows];
  row_values(t, v);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * n + c] = v[r];
}

// A live slot's row by a warp, lane r < kRows storing row r, from t (its
// stdev fields unused) and the windows' sums (s1 and s2 of svlen, then of
// pos): the float keys' divisions and roots made once for the warp, each
// lane on its own operands (the stdevs on lanes kStdevLen and kStdevPos,
// the means on kQual and kNm).
__device__ __forceinline__ void write_rows(int32_t* __restrict__ out, int n, int c,
                                          const Stats& t, const float (&sums)[4], bool fused,
                                          int lane) {
  const bool len_lane = lane == kStdevLen;
  const float sd = stdev_of(len_lane ? sums[0] : sums[2], len_lane ? sums[1] : sums[3],
                            t.cnt - 2 * trim_of(t.cnt), fused);
  const float mean = __fdiv_rn(lane == kQual ? t.mapq_sum : t.nm_sum, __int2float_rn(t.cnt));
  int v[kRows];
  int_rows(t, v);
  v[kStdevPos] = v[kStdevLen] = __float_as_int(sd);
  v[kQual] = to_i32(floorf(mean));
  v[kNm] = __float_as_int(mean);
  int mine = v[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) mine = lane == r ? v[r] : mine;
  if (lane < kRows) out[static_cast<size_t>(lane) * n + c] = mine;
}

// |d| as unsigned (INT32_MIN: 2^31), clamped to kClamp
__device__ __forceinline__ unsigned abs_term(int d) {
  const unsigned a = d < 0 ? 0u - static_cast<unsigned>(d) : static_cast<unsigned>(d);
  return min(a, kClamp);
}

// d^2 from abs_term(d), clamped to kClamp
__device__ __forceinline__ unsigned sq_term(unsigned a) { return a <= 4096u ? a * a : kClamp; }

// ---- a thread a cluster: registers ----------------------------------------

__device__ __forceinline__ void cx(int (&v)[kTinyCap], int a, int b) {
  const int lo = min(v[a], v[b]), hi = max(v[a], v[b]);
  v[a] = lo;
  v[b] = hi;
}

// Batcher's odd-even merge sort of 8: 19 compare-exchanges
__device__ __forceinline__ void sort_tiny(int (&v)[kTinyCap]) {
  static_assert(kTinyCap == 8, "the network sorts 8");
  cx(v, 0, 1); cx(v, 2, 3); cx(v, 4, 5); cx(v, 6, 7);
  cx(v, 0, 2); cx(v, 1, 3); cx(v, 4, 6); cx(v, 5, 7);
  cx(v, 1, 2); cx(v, 5, 6);
  cx(v, 0, 4); cx(v, 1, 5); cx(v, 2, 6); cx(v, 3, 7);
  cx(v, 2, 4); cx(v, 3, 5);
  cx(v, 1, 2); cx(v, 3, 4); cx(v, 5, 6);
}

// the first four of v, by Batcher's network of 5 compare-exchanges
__device__ __forceinline__ void sort_four(int (&v)[kTinyCap]) {
  cx(v, 0, 1); cx(v, 2, 3);
  cx(v, 0, 2); cx(v, 1, 3);
  cx(v, 1, 2);
}

// util.median_modes of the sorted v[0, cnt)
__device__ __forceinline__ int tiny_median_modes(const int (&v)[kTinyCap], int cnt) {
  int len[kTinyCap];
  bool ends[kTinyCap];
  int top = 0;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) {
    if (j == 0) {
      len[j] = 1;
    } else {
      len[j] = v[j] == v[j - 1] ? len[j - 1] + 1 : 1;
    }
    if (j + 1 < kTinyCap) {
      ends[j] = j < cnt && (j + 1 == cnt || v[j + 1] != v[j]);
    } else {
      ends[j] = j < cnt;
    }
    if (ends[j]) top = max(top, len[j]);
  }
  int kept = 0;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) kept += ends[j] && top - len[j] < 3;
  const int target = kept / 2;
  int seen = 0, med = 0;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) {
    if (ends[j] && top - len[j] < 3) {
      if (seen == target) med = v[j];
      ++seen;
    }
  }
  return med;
}

// util.stdev(util.trim(v[0, cnt))) of the sorted v
__device__ __forceinline__ float tiny_stdev(const int (&v)[kTinyCap], int cnt, bool fused) {
  const int lo = trim_of(cnt), hi = cnt - lo;
  int shift = v[0];
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j)
    if (j == lo) shift = v[j];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) {
    if (j >= lo && j < hi) {  // in sorted order, term by term
      const float x = __int2float_rn(wrap_sub(v[j], shift));
      s1 = __fadd_rn(s1, x);
      s2 = __fadd_rn(s2, __fmul_rn(x, x));
    }
  }
  return stdev_of(s1, s2, hi - lo, fused);
}

// the cluster of slot c, its run [s, s + cnt) (0 < cnt <= kTinyCap), by one
// thread: every load is issued before the first sum needs one
__device__ void tiny_slot(const Columns& col, int32_t* __restrict__ out, int n, bool fused,
                          int c, int s, int cnt) {
  int64_t o[kTinyCap];
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) o[j] = j < cnt ? col.order[s + j] : 0;
  int len_v[kTinyCap], pos_v[kTinyCap], read_v[kTinyCap], q[kTinyCap];
  float x[kTinyCap];
  Stats t;
  t.cnt = cnt;
  t.sv = col.marks[c] ? -1 : INT_MIN;
  t.fwd = 0;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) {
    len_v[j] = pos_v[j] = read_v[j] = INT_MAX;  // the padding sorts last
    q[j] = 0;
    x[j] = 0.0f;
    if (j < cnt) {
      len_v[j] = col.svlen[o[j]];
      pos_v[j] = col.pos[o[j]];
      read_v[j] = col.read_id[o[j]];
      q[j] = col.mapq[o[j]];
      x[j] = col.nm[o[j]];
      t.fwd += col.strand[o[j]] > 0;
      t.sv = max(t.sv, col.svtype[o[j]]);
    }
  }
  t.mapq_sum = 0.0f;
  t.nm_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) {
    if (j < cnt) {  // in array order, term by term
      t.mapq_sum = __fadd_rn(t.mapq_sum, __int2float_rn(q[j]));
      t.nm_sum = __fadd_rn(t.nm_sum, x[j]);
    }
  }
  if (cnt > 4) {
    sort_tiny(len_v);
    sort_tiny(pos_v);
    sort_tiny(read_v);
  } else if (cnt > 1) {  // the padding of 4-7 stays in place
    sort_four(len_v);
    sort_four(pos_v);
    sort_four(read_v);
  }
  t.support = 1;
  t.pos_max = pos_v[0];
#pragma unroll
  for (int j = 1; j < kTinyCap; ++j) {
    if (j < cnt) {
      t.support += read_v[j] != read_v[j - 1];
      t.pos_max = pos_v[j];
    }
  }
  t.pos_min = pos_v[0];
  t.svlen_c = tiny_median_modes(len_v, cnt);
  t.pos_c = tiny_median_modes(pos_v, cnt);
  t.stdev_len = tiny_stdev(len_v, cnt, fused);
  t.stdev_pos = tiny_stdev(pos_v, cnt, fused);
  write_live(out, n, c, t);
}

// ---- a warp or a block a cluster: lists on chip ---------------------------

// A warp's cluster of more than kPairMax elements: its lists at L (list r
// at L + r * stride: svlen, pos and the read ids to sort; NM and mapq as
// float32 in array order), gathered through the permutation, a lane two
// elements an iteration in array order (both elements' loads issued before
// the stores); the lane's share of the strand count, the svtype max and the
// mapq sums (sum q; sum |q|, clamped a term: abs_term).
__device__ void warp_gather(const Columns& col, int s, int cnt, int* L, size_t stride, int lane,
                            int& fwd, int& sv, int& qs, unsigned& qa) {
  for (int i = lane; i < cnt; i += 64) {
    const int i2 = i + 32;
    const bool two = i2 < cnt;
    const int64_t o = col.order[s + i], o2 = two ? col.order[s + i2] : o;
    const int a = col.svlen[o], b = col.pos[o], r = col.read_id[o], q = col.mapq[o];
    const int a2 = col.svlen[o2], b2 = col.pos[o2], r2 = col.read_id[o2];
    const int q2 = two ? col.mapq[o2] : 0;
    const float x = col.nm[o], x2 = col.nm[o2];
    fwd += (col.strand[o] > 0) + (two && col.strand[o2] > 0);
    sv = max(sv, max(col.svtype[o], two ? col.svtype[o2] : INT_MIN));
    qs = wrap_add(qs, wrap_add(q, q2));
    qa = min(qa + min(abs_term(q) + abs_term(q2), kClamp), kClamp);
    L[i] = a;
    L[stride + i] = b;
    L[2 * stride + i] = r;
    L[3 * stride + i] = __float_as_int(x);
    L[4 * stride + i] = __float_as_int(__int2float_rn(q));
    if (two) {
      L[i2] = a2;
      L[stride + i2] = b2;
      L[2 * stride + i2] = r2;
      L[3 * stride + i2] = __float_as_int(x2);
      L[4 * stride + i2] = __float_as_int(__int2float_rn(q2));
    }
  }
}

// The float32 sum of src[0, cnt) term by term from 0, as the plain version
// adds it, on every lane (src 16-byte aligned in shared memory: a load
// broadcasts four terms).
__device__ float list_chain(const float* src, int cnt) {
  const float4* v = reinterpret_cast<const float4*>(src);
  float acc = 0.0f;
  int j = 0;
  for (; j + 16 <= cnt; j += 16) {
    const float4 a = v[j / 4], b = v[j / 4 + 1], c = v[j / 4 + 2], d = v[j / 4 + 3];
    const float x[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                         c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; j < cnt; ++j) acc = __fadd_rn(acc, src[j]);
  return acc;
}

// One step of the bitonic network (every comparator ascending) on a warp's
// 64 elements in the pair (v0, v1), element i in register i / 32 of lane
// i % 32: a merge of width k, elements j apart (the mirror step
// where j == k / 2).
__device__ __forceinline__ void pair_step(int& v0, int& v1, int k, int j, int lane) {
  if (j == 32 && k == 64) {  // the mirror step of k = 64: element i against 63 - i
    const int w0 = __shfl_xor_sync(kFull, v1, 31), w1 = __shfl_xor_sync(kFull, v0, 31);
    v0 = min(v0, w0);
    v1 = max(v1, w1);
  } else if (j == 32) {  // a later step of a wider merge: element i against i + 32
    const int w = v0;
    v0 = min(w, v1);
    v1 = max(w, v1);
  } else {
    const int m = j == (k >> 1) ? k - 1 : j;
    const bool lower = (lane & j) == 0;
    const int w0 = __shfl_xor_sync(kFull, v0, m), w1 = __shfl_xor_sync(kFull, v1, m);
    v0 = lower ? min(v0, w0) : max(v0, w0);
    v1 = lower ? min(v1, w1) : max(v1, w1);
  }
}

// The same step on 32 elements, element i in lane i.
__device__ __forceinline__ void lane_step(int& v, int k, int j, int lane) {
  const int m = j == (k >> 1) ? k - 1 : j;
  const int w = __shfl_xor_sync(kFull, v, m);
  v = (lane & j) == 0 ? min(v, w) : max(v, w);
}

// Two lists' bitonic sorts at once, unrolled: of 32 elements (a0, b0), or of
// 64 in pairs (a0, a1), (b0, b1).
__device__ __forceinline__ void sort32x2(int& a0, int& b0, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      lane_step(a0, k, j, lane);
      lane_step(b0, k, j, lane);
    }
  }
}

__device__ __forceinline__ void sort64x2(int& a0, int& a1, int& b0, int& b1, int lane) {
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      pair_step(a0, a1, k, j, lane);
      pair_step(b0, b1, k, j, lane);
    }
  }
}

// One comparator step of the bitonic sort of a warp's lists 0-2 in memory: a
// merge of width k, elements j apart (j >= 64). A comparator whose upper
// element lies past cnt is skipped (the virtual padding is INT32_MAX).
__device__ void memory_step(int* L, size_t stride, int cnt, int p, int k, int j, int lane) {
  for (int t = lane; t < (p >> 1); t += 32) {
    const int q = t & (j - 1), head = 2 * (t - q);
    const int lo = head + q;
    const int hi = j == (k >> 1) ? head + 2 * j - 1 - q : lo + j;
    if (hi < cnt) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        int* v = L + r * stride;
        const int a = v[lo], b = v[hi];
        if (b < a) {
          v[lo] = b;
          v[hi] = a;
        }
      }
    }
  }
}

// The steps of a merge of width k (from the one of width `from`: 2 for a
// whole sort of each chunk) that lie within chunks of 64 elements, in
// registers: the warp loads each chunk of lists 0-2 (INT32_MAX past cnt),
// runs the steps and stores the elements before cnt.
__device__ void chunk_steps(int* L, size_t stride, int cnt, int p, int from, int k, int lane) {
  for (int base = 0; base < p; base += 64) {
    const int i0 = base + lane, i1 = i0 + 32;
    int v[3][2];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      v[r][0] = i0 < cnt ? L[r * stride + i0] : INT_MAX;
      v[r][1] = i1 < cnt ? L[r * stride + i1] : INT_MAX;
    }
    for (int kk = from; kk <= k; kk <<= 1) {
      for (int j = min(kk, 64) >> 1; j > 0; j >>= 1) {
#pragma unroll
        for (int r = 0; r < 3; ++r) pair_step(v[r][0], v[r][1], kk, j, lane);
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (i0 < cnt) L[r * stride + i0] = v[r][0];
      if (i1 < cnt) L[r * stride + i1] = v[r][1];
    }
  }
}

// The bitonic sort of a warp's lists 0-2 (svlen, pos, read), each of cnt
// elements, every comparator ascending: the first step of a merge of width
// k pairs mirrored elements, the later ones elements j apart. The steps
// within chunks of 64 run in registers (each chunk whole first, then the
// last six steps of each wider merge), the others in memory.
__device__ void sort_lists(int* L, size_t stride, int cnt, int lane) {
  int p = 1;
  while (p < cnt) p <<= 1;
  chunk_steps(L, stride, cnt, p, 2, min(p, 64), lane);
  __syncwarp();
  for (int k = 128; k <= p; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      memory_step(L, stride, cnt, p, k, j, lane);
      __syncwarp();
    }
    chunk_steps(L, stride, cnt, p, k, k, lane);
    __syncwarp();
  }
}

// the lane of the (k+1)-th set bit of m (m has more than k set bits)
__device__ __forceinline__ int nth_set(unsigned m, int k) {
  for (int j = 0; j < k; ++j) m &= m - 1;
  return __ffs(m) - 1;
}

// One chunk of 32 elements, at base, of a sorted list v[0, cnt): the lane's
// element i = base + lane, its value, whether it ends a run of equal values
// and the length of that run (from the last start at or before it, by a
// ballot of the starts); `open` carries the start of the run open at the
// chunk's last element into the next chunk.
struct Chunk {
  int value;
  bool ends;
  int len;
};

__device__ __forceinline__ Chunk chunk_at(const int* v, int cnt, int base, int lane, int& open) {
  const int i = base + lane;
  const bool in = i < cnt;
  Chunk c;
  c.value = in ? v[i] : 0;
  const int up = __shfl_up_sync(kFull, c.value, 1), down = __shfl_down_sync(kFull, c.value, 1);
  const int before = lane == 0 ? (in && i > 0 ? v[i - 1] : 0) : up;
  const int after = lane == 31 ? (i + 1 < cnt ? v[i + 1] : 0) : down;
  const bool starts = in && (i == 0 || before != c.value);
  c.ends = in && (i + 1 == cnt || after != c.value);
  const unsigned m = __ballot_sync(kFull, starts);
  const unsigned upto = m & (kFull >> (31 - lane));
  c.len = i - (upto ? base + 31 - __clz(upto) : open) + 1;
  open = m ? base + 31 - __clz(m) : open;
  return c;
}

// util.median_modes of the sorted list v[0, cnt), by a warp: three passes
// (the longest run; the kept runs; the one of rank n_kept / 2)
__device__ int median_modes(const int* v, int cnt, int lane) {
  int top = 0, open = 0;
  for (int base = 0; base < cnt; base += 32) {
    const Chunk c = chunk_at(v, cnt, base, lane, open);
    top = max(top, __reduce_max_sync(kFull, c.ends ? c.len : 0));
  }
  int kept = 0;
  open = 0;
  for (int base = 0; base < cnt; base += 32) {
    const Chunk c = chunk_at(v, cnt, base, lane, open);
    kept += __popc(__ballot_sync(kFull, c.ends && top - c.len < 3));
  }
  const int target = kept / 2;
  int seen = 0;
  open = 0;
  for (int base = 0; base < cnt; base += 32) {
    const Chunk c = chunk_at(v, cnt, base, lane, open);
    const unsigned m = __ballot_sync(kFull, c.ends && top - c.len < 3);
    const int here = __popc(m);
    if (seen + here > target) return __shfl_sync(kFull, c.value, nth_set(m, target - seen));
    seen += here;
  }
  return 0;  // not reached: a list keeps its longest run of equal values
}

// the distinct values of the sorted list v[0, cnt), by a warp
__device__ int distinct(const int* v, int cnt, int lane) {
  int count = 0;
  for (int base = 0; base < cnt; base += 32) {
    const int i = base + lane;
    count += __popc(__ballot_sync(kFull, i < cnt && (i == 0 || v[i - 1] != v[i])));
  }
  return count;
}

// ---- the trimmed windows' sums: exact reductions, or the chains ----------
// The window is ranks [lo, hi) = [trim, cnt - trim) of the sorted list,
// its terms d = v - v[lo] (int32 wrap). Where sum |d| <= 2^24, every
// partial sum of the float32 chain is an integer of at most 2^24, so every
// add is exact and the chain gives the integer sum in any order; where
// sum d^2 <= 2^24, so does s2's chain (each square too is exact). The
// tests' terms are clamped to kClamp, past 2^24, so their sums cannot wrap.

// The window's sums from a warp's lanes' shares (sd: sum d with int32 wrap;
// a and q: sums of abs_term and sq_term, each at most kClamp): s1 and s2,
// and the sums that must run their chains (bit 0 s1, bit 1 s2).
__device__ __forceinline__ unsigned warp_window_sums(int sd, unsigned a, unsigned q, float& s1,
                                                     float& s2) {
  const unsigned A = __reduce_add_sync(kFull, a), Q = __reduce_add_sync(kFull, q);
  s1 = __int2float_rn(__reduce_add_sync(kFull, sd));
  s2 = __uint2float_rn(Q);
  return (A > kExact ? 1u : 0u) | (Q > kExact ? 2u : 0u);
}

// the window of the sorted list v[0, cnt) in shared memory, by a warp
__device__ unsigned list_window(const int* v, int cnt, int lane, float& s1, float& s2) {
  const int lo = trim_of(cnt), hi = cnt - lo;
  s1 = s2 = 0.0f;
  if (hi - lo < 2) return 0;
  const int shift = v[lo];
  int sd = 0;
  unsigned a = 0, q = 0;
  for (int i = lo + lane; i < hi; i += 32) {
    const int d = wrap_sub(v[i], shift);
    const unsigned ad = abs_term(d);
    sd = wrap_add(sd, d);
    a = min(a + ad, kClamp);
    q = min(q + sq_term(ad), kClamp);
  }
  return warp_window_sums(sd, a, q, s1, s2);
}

// the window of a sorted pair (cnt <= 64; lo <= 16, so v[lo] is in v0)
__device__ __forceinline__ unsigned pair_window(int v0, int v1, int cnt, int lane, float& s1,
                                                float& s2) {
  const int lo = trim_of(cnt), hi = cnt - lo;
  s1 = s2 = 0.0f;
  if (hi - lo < 2) return 0;
  const int shift = __shfl_sync(kFull, v0, lo);
  const int d0 = lane >= lo && lane < hi ? wrap_sub(v0, shift) : 0;
  const int d1 = lane + 32 >= lo && lane + 32 < hi ? wrap_sub(v1, shift) : 0;
  const unsigned a0 = abs_term(d0), a1 = abs_term(d1);
  return warp_window_sums(wrap_add(d0, d1), min(a0 + a1, kClamp),
                          min(sq_term(a0) + sq_term(a1), kClamp), s1, s2);
}

// The chains of the window sums flagged in `chains` (bit l on lane l: 0 and
// 1 s1 and s2 of the svlen window, 2 and 3 those of pos), a lane each, in
// lockstep: term by term in sorted order from 0, as the plain version adds
// them, from the sorted lists len and pos. Returns the lane's sum (0 on the
// other lanes).
__device__ float window_chain(const int* len, const int* pos, int cnt, int lane,
                              unsigned chains) {
  const int trim = trim_of(cnt), k = cnt - 2 * trim;
  const bool square = lane & 1;
  const int n_terms = lane < 4 && ((chains >> lane) & 1) ? k : 0;
  const int* src = (lane < 2 ? len : pos) + trim;
  const int shift = n_terms ? src[0] : 0;
  float acc = 0.0f;
  int j = 0;
  for (; j + kBatch <= n_terms; j += kBatch) {  // a batch's terms ahead of its adds
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float y = __int2float_rn(wrap_sub(src[j + u], shift));
      x[u] = square ? __fmul_rn(y, y) : y;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; j < n_terms; ++j) {
    const float y = __int2float_rn(wrap_sub(src[j], shift));
    acc = __fadd_rn(acc, square ? __fmul_rn(y, y) : y);
  }
  return acc;
}

// ---- a block's cluster: a sorting group of kSortWarps warps -------------
// Warp w of them takes the chunks of 32 [w * per, (w + 1) * per) of a list,
// and meets the others at a named barrier (the block's last warp sums the
// NM chain meanwhile, so __syncthreads is not theirs).

// the barrier of the block's warps 0 .. kSortWarps - 1 (named barrier 1)
__device__ __forceinline__ void group_bar() {
  asm volatile("bar.sync 1, %0;" ::"r"(kSortThreads) : "memory");
}

// named barrier 2 of the whole block: the sorting warps arrive (the pos
// list sorted and its window tested), the last warp waits for them
__device__ __forceinline__ void pos_ready_arrive() {
  asm volatile("bar.arrive 2, %0;" ::"r"(kBlockThreads) : "memory");
}
__device__ __forceinline__ void pos_ready_wait() {
  asm volatile("bar.sync 2, %0;" ::"r"(kBlockThreads) : "memory");
}

// the first index of the run of equal values that holds v[i] (v sorted)
__device__ __forceinline__ int run_start(const int* v, int i) {
  const int x = v[i];
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// [first, last) of the warp's chunks of a list of cnt elements
__device__ __forceinline__ void warp_range(int cnt, int warp, int& first, int& last) {
  const int per = ((cnt + 31) / 32 + kSortWarps - 1) / kSortWarps;
  first = min(cnt, warp * per * 32);
  last = min(cnt, (warp + 1) * per * 32);
}

// the sum of every sorting warp's x (sh: kSortWarps ints of scratch)
__device__ __forceinline__ int block_sum(int x, int warp, int lane, int* sh) {
  if (lane == 0) sh[warp] = x;
  group_bar();
  int total = 0;
  for (int w = 0; w < kSortWarps; ++w) total += sh[w];
  group_bar();  // before sh is written again
  return total;
}

// util.median_modes of the sorted lists a[0, cnt) and b[0, cnt) at once,
// as median_modes, by the sorting warps (warp w of them takes the chunks of
// 32 [w * per, (w + 1) * per) of each list): the first pass stores each
// run's length at its end (0 elsewhere) in la and lb (free lists), so that
// the later passes read it; the medians on each of their threads (sh:
// 2 * kSortWarps + 2 ints).
__device__ void block_median_modes2(const int* a, const int* b, int* la, int* lb, int cnt,
                                    int warp, int lane, int* sh, int& med_a, int& med_b) {
  int first, last;
  warp_range(cnt, warp, first, last);
  int open_a = first < last ? run_start(a, first) : 0;
  int open_b = first < last ? run_start(b, first) : 0;
  int top_a = 0, top_b = 0;
#pragma unroll 2
  for (int base = first; base < last; base += 32) {
    const Chunk ca = chunk_at(a, cnt, base, lane, open_a);
    const Chunk cb = chunk_at(b, cnt, base, lane, open_b);
    const int i = base + lane, len_a = ca.ends ? ca.len : 0, len_b = cb.ends ? cb.len : 0;
    if (i < last) {
      la[i] = len_a;
      lb[i] = len_b;
    }
    top_a = max(top_a, len_a);
    top_b = max(top_b, len_b);
  }
  top_a = __reduce_max_sync(kFull, top_a);
  top_b = __reduce_max_sync(kFull, top_b);
  if (lane == 0) {
    sh[warp] = top_a;
    sh[kSortWarps + warp] = top_b;
  }
  group_bar();
  top_a = top_b = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    top_a = max(top_a, sh[w]);
    top_b = max(top_b, sh[kSortWarps + w]);
  }
  group_bar();
  int kept_a = 0, kept_b = 0;  // the runs kept: within 2 of the longest
#pragma unroll 4
  for (int i = first + lane; i < last; i += 32) {
    const int x = la[i], y = lb[i];
    kept_a += x > 0 && top_a - x < 3;
    kept_b += y > 0 && top_b - y < 3;
  }
  kept_a = __reduce_add_sync(kFull, kept_a);
  kept_b = __reduce_add_sync(kFull, kept_b);
  if (lane == 0) {
    sh[warp] = kept_a;
    sh[kSortWarps + warp] = kept_b;
  }
  group_bar();
  int before_a = 0, total_a = 0, before_b = 0, total_b = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    before_a += w < warp ? sh[w] : 0;
    total_a += sh[w];
    before_b += w < warp ? sh[kSortWarps + w] : 0;
    total_b += sh[kSortWarps + w];
  }
  group_bar();  // before sh is written again
  // the kept end of rank n_kept / 2, by the warp that holds it
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int* v = l == 0 ? a : b;
    const int* lens = l == 0 ? la : lb;
    const int top = l == 0 ? top_a : top_b, before = l == 0 ? before_a : before_b;
    const int target = (l == 0 ? total_a : total_b) / 2;
    if (target >= before && target < before + (l == 0 ? kept_a : kept_b)) {
      int seen = before;
      for (int base = first; base < last; base += 32) {
        const int i = base + lane, x = i < last ? lens[i] : 0;
        const unsigned m = __ballot_sync(kFull, x > 0 && top - x < 3);
        const int here = __popc(m);
        if (seen + here > target) {
          const int at = base + nth_set(m, target - seen);
          if (lane == 0) sh[2 * kSortWarps + l] = v[at];
          break;
        }
        seen += here;
      }
    }
  }
  group_bar();
  med_a = sh[2 * kSortWarps];
  med_b = sh[2 * kSortWarps + 1];
  group_bar();
}

// A block's cluster's run permutation entries copied to list 3 at R (as
// int32: n < 2^31) by the sorting warps, coalesced, eight loads ahead of
// their stores.
__device__ void block_entries(const Columns& col, int s, int cnt, int* idx, int tid) {
  for (int i0 = tid; i0 < cnt; i0 += 8 * kSortThreads) {
    int64_t o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kSortThreads;
      o[u] = i < cnt ? col.order[s + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kSortThreads;
      if (i < cnt) idx[i] = static_cast<int>(o[u]);
    }
  }
}

// A block's cluster's columns through its permutation entries idx, by the
// sorting warps, four elements a thread at a time (every load issued before
// the first store): with kReads, the read ids to list 2 at R and the
// thread's share of the strand count, the svtype max and the mapq sums (sum
// q; sum |q|, clamped a term); else svlen and pos to lists 0 and 1.
template <bool kReads>
__device__ void block_gather(const Columns& col, int cnt, const int* idx, int* R, size_t stride,
                             int tid, int& fwd, int& sv, long long& qs, unsigned long long& qa) {
  constexpr int kU = 4;
  for (int i0 = tid; i0 < cnt; i0 += kU * kSortThreads) {
    int o[kU], a[kU], b[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kSortThreads;
      o[u] = i < cnt ? idx[i] : -1;
    }
    if (kReads) {
      int q[kU], f[kU], v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool in = o[u] >= 0;
        a[u] = in ? col.read_id[o[u]] : 0;
        q[u] = in ? col.mapq[o[u]] : 0;
        f[u] = in && col.strand[o[u]] > 0;
        v[u] = in ? col.svtype[o[u]] : INT_MIN;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (o[u] >= 0) R[2 * stride + i0 + u * kSortThreads] = a[u];
        fwd += f[u];
        sv = max(sv, v[u]);
        qs += q[u];
        qa += abs_term(q[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool in = o[u] >= 0;
        a[u] = in ? col.svlen[o[u]] : 0;
        b[u] = in ? col.pos[o[u]] : 0;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (o[u] >= 0) {
          R[i0 + u * kSortThreads] = a[u];
          R[stride + i0 + u * kSortThreads] = b[u];
        }
      }
    }
  }
}

// the min and the max of every sorting warp's lo and hi (sh: 2 * kSortWarps
// ints of scratch), on each of their threads
__device__ __forceinline__ void group_min_max(int& lo, int& hi, int warp, int lane, int* sh) {
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    sh[warp] = lo;
    sh[kSortWarps + warp] = hi;
  }
  group_bar();
  for (int w = 0; w < kSortWarps; ++w) {
    lo = min(lo, sh[w]);
    hi = max(hi, sh[kSortWarps + w]);
  }
  group_bar();  // before sh is written again
}

// the digit of a radix pass: (v - lo) as unsigned (the order of the signed
// values), kDigitBits bits from shift
__device__ __forceinline__ int key_digit(int v, int lo, int shift) {
  return static_cast<int>(((static_cast<unsigned>(v) - static_cast<unsigned>(lo)) >> shift) &
                          (kDigits - 1));
}

// From a chunk's ballots of its digits' bits (bits[k]: the lanes whose digit
// has bit k), the lanes (of `valid`) whose digit is d.
__device__ __forceinline__ unsigned digit_lanes(const unsigned (&bits)[kDigitBits], int d,
                                                unsigned valid) {
  unsigned m = valid;
#pragma unroll
  for (int k = 0; k < kDigitBits; ++k) m &= ((d >> k) & 1) ? bits[k] : ~bits[k];
  return m;
}

// the lanes of chunk u of a radix pass's group at base (kRadixChunks chunks
// of 32) that lie before last
__device__ __forceinline__ unsigned chunk_lanes(int base, int u, int last) {
  const int left = last - base - 32 * u;
  return left >= 32 ? kFull : left > 0 ? (1u << left) - 1 : 0u;
}

// A radix pass's counts of a warp's range [first, last) of src: lane d's
// count of digit d, kRadixChunks chunks at a time (their loads first).
__device__ __forceinline__ int radix_counts(const int* __restrict__ src, int first, int last,
                                            int lo, int shift, int lane) {
  int run = 0;
  for (int base = first; base < last; base += 32 * kRadixChunks) {
    int d[kRadixChunks];
#pragma unroll
    for (int u = 0; u < kRadixChunks; ++u) {
      const int i = base + 32 * u + lane;
      d[u] = i < last ? key_digit(src[i], lo, shift) : 0;
    }
#pragma unroll
    for (int u = 0; u < kRadixChunks; ++u) {
      unsigned bits[kDigitBits];
#pragma unroll
      for (int k = 0; k < kDigitBits; ++k) bits[k] = __ballot_sync(kFull, (d[u] >> k) & 1);
      run += __popc(digit_lanes(bits, lane, chunk_lanes(base, u, last)));
    }
  }
  return run;
}

// A radix pass's scatter of a warp's range [first, last) of src into dst,
// lane d's run the next slot of digit d: an element's slot is its digit's
// next one (a shuffle from lane digit) plus its rank among the chunk's
// lanes of that digit; kRadixChunks chunks at a time (their loads first).
__device__ __forceinline__ void radix_scatter(const int* __restrict__ src, int* __restrict__ dst,
                                              int first, int last, int lo, int shift, int lane,
                                              int run) {
  const unsigned below = (1u << lane) - 1;
  for (int base = first; base < last; base += 32 * kRadixChunks) {
    int x[kRadixChunks];
#pragma unroll
    for (int u = 0; u < kRadixChunks; ++u) {
      const int i = base + 32 * u + lane;
      x[u] = i < last ? src[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kRadixChunks; ++u) {
      const unsigned valid = chunk_lanes(base, u, last);
      const int d = key_digit(x[u], lo, shift);
      unsigned bits[kDigitBits];
#pragma unroll
      for (int k = 0; k < kDigitBits; ++k) bits[k] = __ballot_sync(kFull, (d >> k) & 1);
      const int at = __shfl_sync(kFull, run, d) + __popc(digit_lanes(bits, d, valid) & below);
      if ((valid >> lane) & 1) dst[at] = x[u];
      run += __popc(digit_lanes(bits, lane, valid));
    }
  }
}

// The sorts of two lists, a[0, cnt) and b[0, cnt), ascending, by the
// sorting warps at once (their passes share the barriers and the scans, and
// each warp's chunks of the two interleave): an LSD radix sort of the keys
// v - min (as unsigned, so the order is the signed order), kDigitBits-bit
// digits (a lane a digit: kDigits == 32), only as many passes as each
// list's range max - min needs (none for a list of equal values), between
// the list and its scratch list (sa, sb). A pass: each warp counts the
// digits of its contiguous range, lane d the count of digit d in a register
// (from kDigitBits ballots a chunk of 32: no atomics, no counts in shared
// memory); one scan of the counts (digit-major, then by warp, a sorting
// thread an entry); each warp scatters its range in order, an element's
// slot its digit's next one plus its rank among the chunk's lanes of its
// digit (stable, so the passes compose). sh: 2 * kSortWarps +
// 2 * kSortThreads ints of shared memory. a and b end as the lists that
// hold the sorted values, sa and sb as the free ones.
__device__ void block_sort2(int*& a, int*& sa, int*& b, int*& sb, int cnt, int tid, int warp,
                            int lane, int* sh) {
  static_assert(kDigits == 32 && kDigits * kSortWarps == kSortThreads, "a lane a digit");
  int lo_a = INT_MAX, hi_a = INT_MIN, lo_b = INT_MAX, hi_b = INT_MIN;
  for (int i = tid; i < cnt; i += kSortThreads) {
    lo_a = min(lo_a, a[i]);
    hi_a = max(hi_a, a[i]);
    lo_b = min(lo_b, b[i]);
    hi_b = max(hi_b, b[i]);
  }
  group_min_max(lo_a, hi_a, warp, lane, sh);
  group_min_max(lo_b, hi_b, warp, lane, sh);
  const unsigned range_a = static_cast<unsigned>(hi_a) - static_cast<unsigned>(lo_a);
  const unsigned range_b = static_cast<unsigned>(hi_b) - static_cast<unsigned>(lo_b);
  int first, last;
  warp_range(cnt, warp, first, last);
  int* totals = sh;                      // the scans' warp totals: a's, then b's
  int* counts = sh + 2 * kSortWarps;     // a's, then b's: digit d, warp w at d * kSortWarps + w
  for (int shift = 0; shift < 32 && ((range_a | range_b) >> shift) != 0; shift += kDigitBits) {
    const bool pass_a = (range_a >> shift) != 0, pass_b = (range_b >> shift) != 0;
    if (pass_a) counts[lane * kSortWarps + warp] = radix_counts(a, first, last, lo_a, shift, lane);
    if (pass_b)
      counts[kSortThreads + lane * kSortWarps + warp] = radix_counts(b, first, last, lo_b, shift,
                                                                     lane);
    group_bar();
    {  // the exclusive scans of the counts, a sorting thread an entry of each
      const int x = pass_a ? counts[tid] : 0, y = pass_b ? counts[kSortThreads + tid] : 0;
      int ix = x, iy = y;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ux = __shfl_up_sync(kFull, ix, d), uy = __shfl_up_sync(kFull, iy, d);
        if (lane >= d) {
          ix += ux;
          iy += uy;
        }
      }
      if (lane == 31) {
        totals[warp] = ix;
        totals[kSortWarps + warp] = iy;
      }
      group_bar();
      int bx = ix - x, by = iy - y;
      for (int k = 0; k < warp; ++k) {
        bx += totals[k];
        by += totals[kSortWarps + k];
      }
      counts[tid] = bx;
      counts[kSortThreads + tid] = by;
      group_bar();
    }
    if (pass_a) radix_scatter(a, sa, first, last, lo_a, shift, lane, counts[lane * kSortWarps + warp]);
    if (pass_b)
      radix_scatter(b, sb, first, last, lo_b, shift, lane,
                    counts[kSortThreads + lane * kSortWarps + warp]);
    group_bar();
    if (pass_a) {
      int* t = a;
      a = sa;
      sa = t;
    }
    if (pass_b) {
      int* t = b;
      b = sb;
      sb = t;
    }
  }
}

// The distinct values of v[0, cnt) (unsorted) by the sorting warps: each
// inserted into a hash table of 2 * cnt slots (tab0, then tab1: cnt each,
// two free lists) by atomicCAS with linear probing, a thread's four inserts
// in flight at once, INT32_MIN marking an empty slot (the value INT32_MIN
// itself counted apart); the inserts that found their slot empty, summed
// (sh: kSortWarps ints).
__device__ int hashed_distinct(const int* v, int cnt, int* tab0, int* tab1, int tid, int warp,
                               int lane, int* sh) {
  for (int t = tid; t < cnt; t += kSortThreads) {
    tab0[t] = INT_MIN;
    tab1[t] = INT_MIN;
  }
  group_bar();  // the table's slots are empty before any insert
  const unsigned size = 2u * static_cast<unsigned>(cnt);
  int fresh = 0;
  bool has_min = false;
  constexpr int kU = 4;  // a thread's inserts in flight at once
  for (int i0 = tid; i0 < cnt; i0 += kU * kSortThreads) {
    int x[kU];
    unsigned t[kU];
    bool open[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kSortThreads;
      x[u] = i < cnt ? v[i] : INT_MIN;
      has_min |= i < cnt && x[u] == INT_MIN;
      open[u] = x[u] != INT_MIN;
      t[u] = static_cast<unsigned>(
          (static_cast<unsigned long long>(static_cast<unsigned>(x[u]) * 0x9E3779B1u) * size) >>
          32);
    }
    bool any = true;
    while (any) {  // a probe of every open insert at once
      any = false;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!open[u]) continue;
        int* slot = t[u] < static_cast<unsigned>(cnt) ? tab0 + t[u] : tab1 + (t[u] - cnt);
        const int old = atomicCAS(slot, INT_MIN, x[u]);
        if (old == INT_MIN || old == x[u]) {
          fresh += old == INT_MIN;
          open[u] = false;
        } else {
          t[u] = t[u] + 1 == size ? 0 : t[u] + 1;
          any = true;
        }
      }
    }
  }
  return block_sum(__reduce_add_sync(kFull, fresh), warp, lane, sh) +
         (block_sum(__any_sync(kFull, has_min), warp, lane, sh) > 0);
}

// sd, a and q summed over the sorting warps, on each of their threads (sh64:
// 3 * kSortWarps of scratch)
__device__ __forceinline__ void group_sum3(long long& sd, unsigned long long& a,
                                           unsigned long long& q, int warp, int lane,
                                           long long* sh64) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sd += __shfl_xor_sync(kFull, sd, d);
    a += __shfl_xor_sync(kFull, a, d);
    q += __shfl_xor_sync(kFull, q, d);
  }
  if (lane == 0) {
    sh64[3 * warp] = sd;
    sh64[3 * warp + 1] = static_cast<long long>(a);
    sh64[3 * warp + 2] = static_cast<long long>(q);
  }
  group_bar();
  sd = 0;
  a = q = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    sd += sh64[3 * w];
    a += static_cast<unsigned long long>(sh64[3 * w + 1]);
    q += static_cast<unsigned long long>(sh64[3 * w + 2]);
  }
  group_bar();  // before sh64 is written again
}

// the window of the sorted list v[0, cnt) by the sorting warps, in int64
__device__ unsigned block_window(const int* v, int cnt, int tid, int warp, int lane,
                                 long long* sh64, float& s1, float& s2) {
  const int lo = trim_of(cnt), hi = cnt - lo;
  s1 = s2 = 0.0f;
  if (hi - lo < 2) return 0;
  const int shift = v[lo];
  long long sd = 0;
  unsigned long long a = 0, q = 0;
  for (int i = lo + tid; i < hi; i += kSortThreads) {
    const int d = wrap_sub(v[i], shift);
    const unsigned ad = abs_term(d);
    sd += d;
    a += ad;
    q += sq_term(ad);
  }
  group_sum3(sd, a, q, warp, lane, sh64);
  s1 = __ll2float_rn(sd);
  s2 = __ull2float_rn(q);
  return (a > kExact ? 1u : 0u) | (q > kExact ? 2u : 0u);
}

// a chain's term from its element's index o in the columns: NM, or mapq
// as float32 (0 where o < 0: past the run)
__device__ __forceinline__ float chain_term(const Columns& col, int64_t o, bool nm) {
  if (o < 0) return 0.0f;
  return nm ? col.nm[o] : __int2float_rn(col.mapq[o]);
}

// the permutation entry of element i of the run at s (-1 past cnt)
__device__ __forceinline__ int64_t run_entry(const Columns& col, int s, int i, int cnt) {
  return i < cnt ? col.order[s + i] : -1;
}

// The float32 sum of a cluster's NM (nm) or mapq terms in array order, term
// by term from 0, as the plain version adds them, by a warp: lane l loads
// the term of element base + l, its permutation entry 2 * kAhead batches of
// 32 ahead of the adds and the term kAhead ahead, so that neither load
// waits; every lane makes the adds from shuffles (two instructions a term
// in a whole batch; the same sum on every lane).
__device__ float array_chain(const Columns& col, int s, int cnt, int lane, bool nm) {
  int64_t ord[kAhead];
  float buf[kAhead];
#pragma unroll
  for (int b = 0; b < kAhead; ++b) buf[b] = chain_term(col, run_entry(col, s, b * 32 + lane, cnt), nm);
#pragma unroll
  for (int b = 0; b < kAhead; ++b) ord[b] = run_entry(col, s, (b + kAhead) * 32 + lane, cnt);
  float acc = 0.0f;
  for (int base = 0; base < cnt; base += 32 * kAhead) {
#pragma unroll
    for (int b = 0; b < kAhead; ++b) {
      const float x = buf[b];
      buf[b] = chain_term(col, ord[b], nm);
      ord[b] = run_entry(col, s, base + (b + 2 * kAhead) * 32 + lane, cnt);
      const int here = cnt - base - b * 32;
      if (here >= 32) {
#pragma unroll
        for (int u = 0; u < 32; ++u) acc = __fadd_rn(acc, __shfl_sync(kFull, x, u));
      } else {
        for (int u = 0; u < here; ++u) acc = __fadd_rn(acc, __shfl_sync(kFull, x, u));
      }
    }
  }
  return acc;
}

// ---- a warp's cluster ----------------------------------------------------

// util.median_modes of a sorted pair (cnt <= 64, element i in register i /
// 32 of lane i % 32): the runs' ends as a mask of 64 bits, a run's length
// from the end before it, the kept runs' ends by ballots, and the kept end
// of rank n_kept / 2
__device__ __forceinline__ int run_len(unsigned long long ends, int i) {
  const unsigned long long below = ends & ((1ull << i) - 1);
  return below ? i - (63 - __clzll(below)) : i + 1;
}

// the lane whose bit of m is its (k+1)-th set bit (-1 where none is)
__device__ __forceinline__ int nth_lane(unsigned m, int k, int lane) {
  const bool hit = ((m >> lane) & 1) && __popc(m & ((1u << lane) - 1)) == k;
  return __ffs(__ballot_sync(kFull, hit)) - 1;
}

__device__ __forceinline__ int pair_median_modes(int v0, int v1, int cnt, int lane) {
  const int first1 = __shfl_sync(kFull, v1, 0);
  const int dn0 = __shfl_down_sync(kFull, v0, 1), dn1 = __shfl_down_sync(kFull, v1, 1);
  const bool e0 = lane < cnt && (lane + 1 == cnt || (lane == 31 ? first1 : dn0) != v0);
  const bool e1 = lane + 32 < cnt && (lane + 33 == cnt || dn1 != v1);
  const unsigned long long ends =
      __ballot_sync(kFull, e0) | (static_cast<unsigned long long>(__ballot_sync(kFull, e1)) << 32);
  const int l0 = run_len(ends, lane), l1 = run_len(ends, lane + 32);
  const int top = __reduce_max_sync(kFull, max(e0 ? l0 : 0, e1 ? l1 : 0));
  const unsigned m0 = __ballot_sync(kFull, e0 && top - l0 < 3);
  const unsigned m1 = __ballot_sync(kFull, e1 && top - l1 < 3);
  const int n0 = __popc(m0), target = (n0 + __popc(m1)) / 2;
  const int t0 = nth_lane(m0, target, lane), t1 = nth_lane(m1, target - n0, lane);
  const int a = __shfl_sync(kFull, v0, t0 & 31), b = __shfl_sync(kFull, v1, t1 & 31);
  return target < n0 ? a : b;
}

// the distinct values among a pair's elements before cnt, unsorted: equal
// values within a register by __match_any_sync (the lowest lane of each
// counts), and the second register's against all 32 of the first
__device__ __forceinline__ int pair_distinct(int r0, int r1, int cnt, int lane) {
  const bool in0 = lane < cnt, in1 = lane + 32 < cnt;
  const unsigned below = (1u << lane) - 1;
  const unsigned m0 = __match_any_sync(kFull, r0) & __ballot_sync(kFull, in0);
  const unsigned m1 = __match_any_sync(kFull, r1) & __ballot_sync(kFull, in1);
  bool seen = false;
  if (cnt > 32) {  // every lane's first element is valid
#pragma unroll
    for (int l = 0; l < 32; ++l) seen |= __shfl_sync(kFull, r0, l) == r1;
  }
  return __popc(__ballot_sync(kFull, in0 && (m0 & below) == 0)) +
         __popc(__ballot_sync(kFull, in1 && (m1 & below) == 0 && !seen));
}

// A warp's cluster of cnt <= kPairMax elements, its permutation entries
// o0 (element lane) and o1 (element lane + 32) loaded: its columns
// gathered into registers; the strand count, the svtype max and the mapq
// sum by reductions (mapq's chain where sum |q| passes 2^24); NM's chain
// from the warp's slice in array order; svlen and pos sorted by shuffles
// (a network of 32 for up to 32 elements), the read ids counted unsorted;
// the medians, the support, the extent and the windows' sums in registers.
// Returns the window sums that must run their chains (window_chain's
// bits), whose lists it has then stored to the slice L.
__device__ unsigned pair_cluster(const Columns& col, int64_t o0, int64_t o1, int cnt, int* L,
                                 size_t stride, int lane, Stats& t, float (&sums)[4],
                                 StatClock& clk) {
  const bool in0 = lane < cnt, in1 = lane + 32 < cnt;
  int a0 = in0 ? col.svlen[o0] : INT_MAX, a1 = in1 ? col.svlen[o1] : INT_MAX;
  int b0 = in0 ? col.pos[o0] : INT_MAX, b1 = in1 ? col.pos[o1] : INT_MAX;
  const int r0 = in0 ? col.read_id[o0] : 0, r1 = in1 ? col.read_id[o1] : 0;
  const int q0 = in0 ? col.mapq[o0] : 0, q1 = in1 ? col.mapq[o1] : 0;
  const float x0 = in0 ? col.nm[o0] : 0.0f, x1 = in1 ? col.nm[o1] : 0.0f;
  const int f = (in0 && col.strand[o0] > 0) + (in1 && col.strand[o1] > 0);
  const int sv = max(in0 ? col.svtype[o0] : INT_MIN, in1 ? col.svtype[o1] : INT_MIN);
  float* nm = reinterpret_cast<float*>(L + 3 * stride);
  float* mq = reinterpret_cast<float*>(L + 4 * stride);
  if (in0) nm[lane] = x0;
  if (in1) nm[lane + 32] = x1;
  t.fwd = __reduce_add_sync(kFull, f);
  t.sv = __reduce_max_sync(kFull, sv);
  const unsigned qa = __reduce_add_sync(kFull, min(abs_term(q0) + abs_term(q1), kClamp));
  const int qs = __reduce_add_sync(kFull, wrap_add(q0, q1));
  if (qa > kExact) {  // mapq's own chain
    if (in0) mq[lane] = __int2float_rn(q0);
    if (in1) mq[lane + 32] = __int2float_rn(q1);
  }
  __syncwarp();
  clk.settle(a0 ^ a1 ^ b0 ^ b1 ^ r0 ^ r1);
  clk.stamp(kGather);
  t.nm_sum = list_chain(nm, cnt);
  t.mapq_sum = qa > kExact ? list_chain(mq, cnt) : __int2float_rn(qs);
  clk.settle(__float_as_int(t.nm_sum) ^ __float_as_int(t.mapq_sum));
  clk.stamp(kChains);
  if (cnt <= 32) {
    sort32x2(a0, b0, lane);
  } else {
    sort64x2(a0, a1, b0, b1, lane);
  }
  clk.settle(a0 ^ a1 ^ b0 ^ b1);
  clk.stamp(kSort);
  t.support = pair_distinct(r0, r1, cnt, lane);
  t.svlen_c = pair_median_modes(a0, a1, cnt, lane);
  t.pos_c = pair_median_modes(b0, b1, cnt, lane);
  t.pos_min = __shfl_sync(kFull, b0, 0);
  t.pos_max = cnt > 32 ? __shfl_sync(kFull, b1, cnt - 33) : __shfl_sync(kFull, b0, cnt - 1);
  clk.settle(t.support ^ t.svlen_c ^ t.pos_c ^ t.pos_min ^ t.pos_max);
  clk.stamp(kMedians);
  const unsigned chains = pair_window(a0, a1, cnt, lane, sums[0], sums[1]) |
                          (pair_window(b0, b1, cnt, lane, sums[2], sums[3]) << 2);
  if (chains) {  // the sorted lists the chains read
    if (in0) {
      L[lane] = a0;
      L[stride + lane] = b0;
    }
    if (in1) {
      L[lane + 32] = a1;
      L[stride + lane + 32] = b1;
    }
    __syncwarp();
  }
  return chains;
}

// A warp's cluster of more than kPairMax elements: its lists gathered into
// the warp's slice L (warp_gather); the NM and mapq sums (mapq's exact
// where sum |q| <= 2^24, else its chain); svlen, pos and the read ids
// sorted there; the medians, the support and the extent from the sorted
// lists; the windows' sums by the lanes. Returns the window sums that must
// run their chains.
__device__ unsigned list_cluster(const Columns& col, int s, int cnt, int* L, size_t stride,
                                 int lane, Stats& t, float (&sums)[4], StatClock& clk) {
  int fwd = 0, sv = INT_MIN, qs = 0;
  unsigned qa = 0;
  warp_gather(col, s, cnt, L, stride, lane, fwd, sv, qs, qa);
  t.fwd = __reduce_add_sync(kFull, fwd);
  t.sv = __reduce_max_sync(kFull, sv);
  qa = __reduce_add_sync(kFull, qa);
  qs = __reduce_add_sync(kFull, qs);
  __syncwarp();
  clk.stamp(kGather);
  t.nm_sum = list_chain(reinterpret_cast<const float*>(L + 3 * stride), cnt);
  t.mapq_sum = qa > kExact ? list_chain(reinterpret_cast<const float*>(L + 4 * stride), cnt)
                           : __int2float_rn(qs);
  clk.stamp(kChains);
  sort_lists(L, stride, cnt, lane);
  clk.stamp(kSort);
  t.support = distinct(L + 2 * stride, cnt, lane);
  t.svlen_c = median_modes(L, cnt, lane);
  t.pos_c = median_modes(L + stride, cnt, lane);
  t.pos_min = L[stride];
  t.pos_max = L[stride + cnt - 1];
  clk.settle(t.pos_min ^ t.pos_max);
  clk.stamp(kMedians);
  return list_window(L, cnt, lane, sums[0], sums[1]) |
         (list_window(L + stride, cnt, lane, sums[2], sums[3]) << 2);
}

// The sort's keys, ahead of the wrapper's one stable sort (a thread four
// elements, a grid-stride loop, coalesced): a valid element of id c in
// [0, n) keys c, an invalid one of raw id r in [0, n) keys n + r, any other
// INT32_MAX (n < 2^30, so 2n - 1 < INT32_MAX). Sorted, the keys below n are
// the clusters' runs, each in array order, and those in [n, 2n) the invalid
// elements by raw id: the run pass reads both from the one sorted array.
__global__ void __launch_bounds__(kKeyThreads)
stat_keys(const int32_t* __restrict__ cluster_id, const uint8_t* __restrict__ valid,
          int32_t* __restrict__ keys, int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += kKeyItems * stride) {
    int c[kKeyItems];
    bool v[kKeyItems];
#pragma unroll
    for (int u = 0; u < kKeyItems; ++u) {  // every load issued before the first store
      const int e = i + u * stride;
      c[u] = e < n ? cluster_id[e] : -1;
      v[u] = e < n && valid[e];
    }
#pragma unroll
    for (int u = 0; u < kKeyItems; ++u) {
      const int e = i + u * stride;
      if (e < n) keys[e] = c[u] < 0 || c[u] >= n ? INT_MAX : v[u] ? c[u] : n + c[u];
    }
  }
}

// The merge of the slots 0..2n-1 (A, implicit: A[i] = i) with the n sorted
// keys (B), a slot ahead of an equal key: slot c < n is taken when lower_bound
// of c has been passed, so the B index at which it is taken is its run's start
// (start[n] included), and slot n + r finds key n + r there exactly when an
// invalid element names r. The split at diagonal d (the slots among the first
// d items of the merge) is the least i in [max(0, d - n), min(d, 2n)] that is
// not ahead of B[d - 1 - i]. first_split finds it for a block's first tile, by
// a warp: kProbes * 32 probes a round, about three rounds at n = 2^21.
__device__ int first_split(const int32_t* __restrict__ keys, int n, long long d, int lane) {
  constexpr int kWidth = 32 * kProbes;
  long long lo = max(0LL, d - n), hi = min(d, 2LL * n);
  while (lo < hi) {
    const long long step = (hi - lo + kWidth - 1) / kWidth;
    bool before[kProbes];  // every probe's load issued before the first ballot
#pragma unroll
    for (int q = 0; q < kProbes; ++q) {
      const long long p = lo + (q * 32 + lane) * step;
      before[q] = p < hi && p <= keys[d - 1 - p];
    }
    int ahead = 0;
#pragma unroll
    for (int q = 0; q < kProbes; ++q) ahead += __popc(__ballot_sync(kFull, before[q]));
    // probes in order: the first `ahead` of them are ahead of their keys
    if (ahead == 0) {
      hi = lo;
    } else {
      const long long last = lo + (ahead - 1) * step;
      hi = min(hi, last + step);
      lo = last + 1;
    }
  }
  return static_cast<int>(lo);
}

// The split at diagonal dt of a tile whose window `win` holds the keys from
// j0 on (nb of them before the merge's end; key k at word pad(k)) and whose
// slots start at i0 (na of them), by binary search in shared memory.
__device__ __forceinline__ int tile_split(const int* win, int i0, int na, int nb, int dt) {
  int lo = max(0, dt - nb), hi = min(dt, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (i0 + mid <= win[pad(dt - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A tile's window, the keys from j0 on (dn + 1 of them, INT32_MAX past the
// n keys), loaded into registers: every load issued before the first use.
__device__ __forceinline__ void load_window(const int32_t* __restrict__ keys, int n, int j0,
                                            int dn, int (&v)[kWinLoads]) {
#pragma unroll
  for (int q = 0; q < kWinLoads; ++q) {
    const int k = threadIdx.x + q * kRunThreads;
    v[q] = k <= dn && k < n - j0 ? keys[j0 + k] : INT_MAX;
  }
}

// The run pass: every slot's run start (starts[c], c = 0..n; slot c's run is
// [starts[c], starts[c + 1])) and invalid mark (marks[r], r < n), each written
// once, so nothing is zeroed ahead of it; and the two list counts zeroed.
// Balanced by the merge path: the 3n items of the merge above are cut into
// tiles of kRunTile diagonals, and a block takes a contiguous range of them,
// whatever the gaps between the keys (all invalid: every slot's start is 0;
// K a slot: one gap of nearly n slots). Its first tile's split comes from a
// warp's search (first_split); a tile's window, the kRunTile + 1 keys from
// its start split, goes to shared memory (coalesced loads, the next tile's
// in flight while this one merges), its end split and each thread's split
// at its kRunItems diagonals are found there by binary search, and the
// thread merges kRunItems steps, a shared-memory access a step (a key read
// as the merge passes it, or a slot's start written); the slots' starts and
// marks go out from shared memory, coalesced. The next tile starts at this
// one's end split.
__global__ void __launch_bounds__(kRunThreads)
stat_runs(const int32_t* __restrict__ keys, int32_t* __restrict__ starts,
          uint8_t* __restrict__ marks, int32_t* __restrict__ counts, int n, long long tiles) {
  __shared__ int win[kWinPad];  // the tile's keys, and the one after them (padded)
  // each of the tile's slots (padded): the B index at which it is taken,
  // and in bit 31 whether the key there equals it
  __shared__ int tslot[kRunPad];
  __shared__ int split;  // the slots before the block's first tile
  const int t = threadIdx.x;
  const long long total = 3LL * n;
  const long long first = tiles * blockIdx.x / gridDim.x;
  const long long last = tiles * (blockIdx.x + 1) / gridDim.x;
  if (blockIdx.x == 0 && t < 2) counts[t] = 0;
  if (first >= last) return;
  long long d0 = first * kRunTile;
  if (t < 32) {
    const int i = first_split(keys, n, d0, t);
    if (t == 0) split = i;
  }
  __syncthreads();
  int i0 = split;
  int j0 = static_cast<int>(d0 - i0);
  int dn = static_cast<int>(min(static_cast<long long>(kRunTile), total - d0));
  int v[kWinLoads];
  load_window(keys, n, j0, dn, v);
  for (long long tile = first; tile < last; ++tile) {
#pragma unroll
    for (int q = 0; q < kWinLoads; ++q) {
      const int k = t + q * kRunThreads;
      if (k <= dn) win[pad(k)] = v[q];
    }
    __syncthreads();
    const int nb = min(dn, n - j0), na = static_cast<int>(min(static_cast<long long>(dn),
                                                              2LL * n - i0));
    // the tile's end split (every thread, the same reads), then the next
    // tile's window in flight
    const int taken = tile_split(win, i0, na, nb, dn);
    const int i1 = i0 + taken, j1 = j0 + dn - taken;
    const int dn1 = static_cast<int>(min(static_cast<long long>(kRunTile), total - d0 - dn));
    if (tile + 1 < last) load_window(keys, n, j1, dn1, v);
    const int dt = min(t * kRunItems, dn), de = min(dt + kRunItems, dn);
    int i = tile_split(win, i0, na, nb, dt), j = dt - i;
    int b = win[pad(j)];
    for (int step = dt; step < de; ++step) {
      if (i < na && i0 + i <= b) {
        tslot[pad(i)] = (j0 + j) | (static_cast<int>(i0 + i == b) << 31);
        ++i;
      } else {
        b = win[pad(++j)];
      }
    }
    __syncthreads();
    for (int k = t; k < taken; k += kRunThreads) {
      const int a = i0 + k, s = tslot[pad(k)];
      if (a <= n) starts[a] = s & INT_MAX;
      if (a >= n) marks[a - n] = static_cast<unsigned>(s) >> 31;
    }
    i0 = i1;
    j0 = j1;
    d0 += dn;
    dn = dn1;
    __syncthreads();  // the window and the tile's slots are read before the next tile's
  }
}

// A resident grid, a thread a slot (warp w takes slots w*32 + W*32*k, W
// warps in the grid, coalesced): an empty slot gets the identities of the
// plain version's reductions (0, +0.0f, svtype -1 or INT32_MIN, pos_min
// INT32_MAX, pos_max INT32_MIN); a cluster of at most kTinyMax elements is
// done by its thread; larger clusters are appended to the warp list
// (lists[0, counts[0])) or the block list (from lists[n - 1] down,
// counts[1] of them), a warp's appends by one atomic: an entry (slot, run
// start, count, invalid mark) each.
__global__ void __launch_bounds__(kThreads)
stat_slots(Columns col, const int32_t* __restrict__ starts, int4* __restrict__ lists,
           int32_t* __restrict__ counts, int32_t* __restrict__ out, int n, bool fused) {
  const int lane = threadIdx.x & 31;
  const int threads = gridDim.x * blockDim.x;
  const unsigned below = (1u << lane) - 1;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n; base += threads) {
    const int c = base + lane;
    int s = 0, cnt = 0;
    if (c < n) {  // two neighbouring starts, coalesced
      s = starts[c];
      cnt = starts[c + 1] - s;
    }
    const bool to_warp = cnt > kTinyMax && cnt <= kWarpMax;
    const bool to_block = cnt > kWarpMax;
    const unsigned mw = __ballot_sync(kFull, to_warp), mb = __ballot_sync(kFull, to_block);
    int at_w = 0, at_b = 0;
    if (lane == 0 && mw) at_w = atomicAdd(&counts[0], __popc(mw));
    if (lane == 0 && mb) at_b = atomicAdd(&counts[1], __popc(mb));
    at_w = __shfl_sync(kFull, at_w, 0);
    at_b = __shfl_sync(kFull, at_b, 0);
    if (to_warp || to_block) {
      const int4 entry = make_int4(c, s, cnt, col.marks[c]);
      if (to_warp) lists[at_w + __popc(mw & below)] = entry;
      if (to_block) lists[n - 1 - (at_b + __popc(mb & below))] = entry;
    }
    if (c >= n) continue;
    if (cnt == 0) {
      const int v[kRows] = {col.marks[c] ? -1 : INT_MIN, 0, 0, 0, 0, INT_MAX, INT_MIN,
                            0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * n + c] = v[r];
    } else if (cnt <= kTinyMax) {
      tiny_slot(col, out, n, fused, c, s, cnt);
    }
  }
}

// A resident grid, a warp a cluster of the warp list, the next cluster's
// entry and permutation entries loaded while it works on one (and the
// entry after it, so that only its columns' loads wait); its lists in
// registers up to kPairMax elements, past it in the warp's slice of the
// dynamic shared memory (kWarpLists * stride ints, stride kWarpMax rounded
// up to 4 ints, a kernel argument all the same: as a constant, ptxas gave
// the PR 14 kernel 48 registers and spills, 4 % slower); the row by 16
// lanes.
__global__ void __launch_bounds__(kThreads)
stat_warps(Columns col, const int4* __restrict__ lists, const int32_t* __restrict__ counts,
           int32_t* __restrict__ out, int n, bool fused, int stride) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5, per_block = blockDim.x >> 5;
  int* L = smem + static_cast<size_t>(wib) * kWarpLists * stride;
  const int total = counts[0], warps = gridDim.x * per_block;
  const int4 none = make_int4(0, 0, 0, 0);
  int w = blockIdx.x * per_block + wib;
  int4 next = w < total ? lists[w] : none;
  int4 after = w + warps < total ? lists[w + warps] : none;
  int64_t o0 = kPairMax && lane < next.z ? col.order[next.y + lane] : 0;
  int64_t o1 = kPairMax && lane + 32 < next.z ? col.order[next.y + lane + 32] : 0;
  StatClock clk;
  clk.start();
  for (; w < total; w += warps) {
    const int4 e = next;
    const int64_t p0 = o0, p1 = o1;
    next = after;
    after = w + 2 * warps < total ? lists[w + 2 * warps] : none;
    o0 = kPairMax && lane < next.z ? col.order[next.y + lane] : 0;
    o1 = kPairMax && lane + 32 < next.z ? col.order[next.y + lane + 32] : 0;
    const int c = e.x, s = e.y, cnt = e.z;
    Stats t;
    t.cnt = cnt;
    clk.stamp(kEntry);
    float sums[4];
    const unsigned chains = kPairMax && cnt <= kPairMax
                                ? pair_cluster(col, p0, p1, cnt, L, stride, lane, t, sums, clk)
                                : list_cluster(col, s, cnt, L, stride, lane, t, sums, clk);
    t.sv = max(t.sv, e.w ? -1 : INT_MIN);
    if (chains) {
      const float acc = window_chain(L, L + stride, cnt, lane, chains);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = __shfl_sync(kFull, acc, q);
        if ((chains >> q) & 1) sums[q] = x;
      }
    }
    clk.stamp(kChains);
    write_rows(out, n, c, t, sums, fused, lane);
    __syncwarp();  // the slice is read before the next cluster writes it
    clk.stamp(kWrite);
    clk.cluster();
  }
  if (lane == 0) clk.flush(kWarpTier, kAllParts);
}

// what a block's warps share of its cluster
struct BlockShared {
  int fwd, sv, svlen_c, pos_c, support, pos_min, pos_max;
  unsigned chains;                 // the window sums that must run their chains
  int svlen_at, pos_at;            // the sorted svlen and pos lists' offsets from R
  unsigned long long mapq_a;       // sum |q| (clamped a term)
  long long mapq_s;                // sum q
  float sums[4];                   // the windows' s1 and s2 (svlen, pos)
  float nm, mapq;                  // the array-order chains
};

// The cluster of entry e (slot c, run [s, s + cnt), invalid mark), by the
// block, its lists at R (list r at R + r * stride: svlen, pos, read ids and
// a scratch list). The sorting warps copy the run's permutation entries to
// list 3, gather the read ids (and count strands, the svtype max and the
// mapq sums), count the distinct read ids by a hash table in lists 0 and 1,
// gather svlen and pos there, sort both at once (lists 2 and 3 their
// scratch), then take pos's extent and both windows' exact sums (pos's
// first: the last warp may then run its chains) and both medians.
// Meanwhile the last warp sums NM in array order through the permutation,
// then pos's window chains. The svlen window's chains that fail their
// test, and the mapq sum where sum |q| passes 2^24, run on the last warp at
// the end. Inlined once, for lists in shared memory or in global scratch
// alike (a copy for each would double the kernel's code).
__device__ __forceinline__ void block_cluster(const Columns& col, int4 e, int* R, size_t stride,
                                              int32_t* __restrict__ out, int n, bool fused,
                                              BlockShared& bs, int* sh, long long* sh64,
                                              StatClock& clk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = e.x, s = e.y, cnt = e.z;
  if (threadIdx.x == 0) {
    bs.fwd = 0;
    bs.sv = INT_MIN;
    bs.mapq_s = 0;
    bs.mapq_a = 0;
  }
  clk.settle(cnt);
  clk.stamp(kEntry);
  __syncthreads();
  clk.stamp(kWait);
  if (warp < kSortWarps) {
    const int tid = threadIdx.x;
    int fwd = 0, sv = INT_MIN;
    long long qs = 0;
    unsigned long long qa = 0;
    block_entries(col, s, cnt, R + 3 * stride, tid);
    group_bar();
    block_gather<true>(col, cnt, R + 3 * stride, R, stride, tid, fwd, sv, qs, qa);
    fwd = __reduce_add_sync(kFull, fwd);
    sv = __reduce_max_sync(kFull, sv);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      qs += __shfl_xor_sync(kFull, qs, d);
      qa += __shfl_xor_sync(kFull, qa, d);
    }
    if (lane == 0) {
      atomicAdd(&bs.fwd, fwd);
      atomicMax(&bs.sv, sv);
      atomicAdd(reinterpret_cast<unsigned long long*>(&bs.mapq_s),
                static_cast<unsigned long long>(qs));
      atomicAdd(&bs.mapq_a, qa);
    }
    clk.stamp(kGather);
    group_bar();
    clk.stamp(kWait);
    // the read ids' distinct values by a hash table in lists 0 and 1, then
    // svlen and pos gathered there
    const int support = hashed_distinct(R + 2 * stride, cnt, R, R + stride, tid, warp, lane, sh);
    clk.stamp(kMedians);
    block_gather<false>(col, cnt, R + 3 * stride, R, stride, tid, fwd, sv, qs, qa);
    group_bar();
    clk.stamp(kGather);
    // pos and svlen sorted at once, the read ids' list and list 3 their
    // scratch; then each one's statistics
    int *pos = R + stride, *pos_free = R + 3 * stride, *len = R, *len_free = R + 2 * stride;
    block_sort2(pos, pos_free, len, len_free, cnt, tid, warp, lane, sh);
    clk.stamp(kSort);
    float s1, s2;
    unsigned chains = block_window(pos, cnt, tid, warp, lane, sh64, s1, s2) << 2;
    if (threadIdx.x == 0) {
      bs.pos_min = pos[0];
      bs.pos_max = pos[cnt - 1];
      bs.pos_at = static_cast<int>(pos - R);
      bs.sums[2] = s1;
      bs.sums[3] = s2;
      bs.chains = chains;  // pos's, for the last warp's chains
    }
    pos_ready_arrive();
    chains |= block_window(len, cnt, tid, warp, lane, sh64, s1, s2);
    int pos_c, svlen_c;
    block_median_modes2(pos, len, pos_free, len_free, cnt, warp, lane, sh, pos_c, svlen_c);
    if (threadIdx.x == 0) {
      bs.pos_c = pos_c;
      bs.svlen_c = svlen_c;
      bs.svlen_at = static_cast<int>(len - R);
      bs.sums[0] = s1;
      bs.sums[1] = s2;
      bs.support = support;
      bs.chains = chains;
    }
    clk.stamp(kMedians);
  } else {  // the NM sum needs no sort
    const float nm = array_chain(col, s, cnt, lane, true);
    if (lane == 0) bs.nm = nm;
    // pos's window chains once its list is sorted, beside the other sorts
    pos_ready_wait();
    const unsigned pos_chains = bs.chains & 0xCu;
    if (pos_chains) {
      const int* pos = R + bs.pos_at;
      const float acc = window_chain(pos, pos, cnt, lane, pos_chains);
#pragma unroll
      for (int q = 2; q < 4; ++q) {
        const float x = __shfl_sync(kFull, acc, q);
        if (lane == 0 && ((pos_chains >> q) & 1)) bs.sums[q] = x;
      }
    }
    clk.settle(__float_as_int(nm));
    clk.stamp(kChains);
  }
  __syncthreads();
  clk.stamp(kWait);
  const unsigned chains = bs.chains & 0x3u;  // svlen's: pos's ran beside the sorts
  const bool mapq_exact = bs.mapq_a <= kExact;
  if (chains || !mapq_exact) {  // the chains the tests left, on the last warp
    if (warp == kSortWarps) {
      if (chains) {
        const float acc = window_chain(R + bs.svlen_at, R + bs.pos_at, cnt, lane, chains);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = __shfl_sync(kFull, acc, q);
          if (lane == 0 && ((chains >> q) & 1)) bs.sums[q] = x;
        }
      }
      if (!mapq_exact) {
        const float mq = array_chain(col, s, cnt, lane, false);
        if (lane == 0) bs.mapq = mq;
      }
      clk.stamp(kChains);
    }
    __syncthreads();
    clk.stamp(kWait);
  }
  if (warp == 0) {
    Stats t;
    t.cnt = cnt;
    t.fwd = bs.fwd;
    t.sv = max(bs.sv, e.w ? -1 : INT_MIN);
    t.svlen_c = bs.svlen_c;
    t.pos_c = bs.pos_c;
    t.support = bs.support;
    t.pos_min = bs.pos_min;
    t.pos_max = bs.pos_max;
    t.mapq_sum = mapq_exact ? __ll2float_rn(bs.mapq_s) : bs.mapq;
    t.nm_sum = bs.nm;
    const float sums[4] = {bs.sums[0], bs.sums[1], bs.sums[2], bs.sums[3]};
    write_rows(out, n, c, t, sums, fused, lane);
  }
  clk.stamp(kWrite);
  __syncthreads();  // the lists and bs are read before the next cluster writes them
  clk.stamp(kWait);
  clk.cluster();
}

// A block a cluster of the block list: its four lists in the dynamic
// shared memory (cnt <= kBlockMax, kBlockLists * cnt ints) or, past it, in
// the scratch rows at the cluster's run (scratch + r * n + s).
__global__ void __launch_bounds__(kBlockThreads)
stat_blocks(Columns col, const int4* __restrict__ lists, const int32_t* __restrict__ counts,
            int32_t* scratch, int32_t* __restrict__ out, int n, bool fused) {
  extern __shared__ int smem[];
  __shared__ BlockShared bs;
  __shared__ int sh[2 * kSortWarps + 2 * kSortThreads];  // warps' values; the radix counts
  __shared__ long long sh64[3 * kSortWarps];
  const int total = counts[1];
  StatClock clk;
  clk.start();
  for (int b = blockIdx.x; b < total; b += gridDim.x) {
    const int4 e = lists[n - 1 - b];
    const bool on_chip = e.z <= kBlockMax;
    block_cluster(col, e, on_chip ? smem : scratch + e.y, static_cast<size_t>(on_chip ? e.z : n),
                  out, n, fused, bs, sh, sh64, clk);
  }
  // thread 0 the block's path, the last warp's lane 0 its chains
  if (threadIdx.x == 0) clk.flush(kBlockTier, kAllParts & ~(1u << kChains));
  if (threadIdx.x == kSortWarps * 32) clk.flush(kBlockTier, 1u << kChains);
}

// the dynamic shared memory of a stat_warps block and of a stat_blocks block
// a warp's list stride: kWarpMax rounded up to 4 ints, so that every list
// of its slice is 16-byte aligned (list_chain's loads)
constexpr int kWarpStride = (kWarpMax + 3) & ~3;
constexpr size_t kWarpSmem = sizeof(int) * kWarpLists * static_cast<size_t>(kWarpStride) *
                             (kThreads / 32);
constexpr size_t kBlockSmem = sizeof(int) * kBlockLists * static_cast<size_t>(kBlockMax);

// What the launches on one device need: its SMs, the blocks of each kernel
// one SM holds at once, after the warp and block tiers' shared memory
// attributes are set. Cached by device, since the queries cost host time on
// every call otherwise.
struct Config {
  int dev = -1, sms = 0, keys = 0, runs = 0, slots = 0, warps = 0, blocks = 0;
};

cudaError_t make_config(int dev, Config* c) {
  const size_t warp_smem = kWarpSmem, block_smem = kBlockSmem;
  cudaError_t err = cudaFuncSetAttribute(stat_warps, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(warp_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stat_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(block_smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->keys, stat_keys, kKeyThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->runs, stat_runs, kRunThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->slots, stat_slots, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->warps, stat_warps, kThreads,
                                                        warp_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->blocks, stat_blocks, kBlockThreads,
                                                        block_smem);
  if (err != cudaSuccess) return err;
  // a tier whose shared memory no SM holds
  if (c->keys < 1 || c->runs < 1 || c->slots < 1 || c->warps < 1 || c->blocks < 1)
    return cudaErrorInvalidConfiguration;
  c->dev = dev;
  return cudaSuccess;
}

cudaError_t config_for(Config* out) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static Config cache[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Config fresh;
  Config& c = dev < kDevices ? cache[dev] : fresh;
  if (c.dev != dev) {
    c = Config();
    err = make_config(dev, &c);
    if (err != cudaSuccess) {
      c = Config();
      return err;
    }
  }
  *out = c;
  return cudaSuccess;
}

// a resident grid: `per_sm` blocks on each of `sms` SMs, at least one, no
// more than `most`
int grid(int sms, int per_sm, long long most) {
  return static_cast<int>(std::max(1LL, std::min(static_cast<long long>(sms) * per_sm, most)));
}

int launch_all(const int32_t* keys, const Columns& col, int32_t* runs, int32_t* lists,
               uint8_t* marks, int32_t* lists_big, int32_t* out, int n, bool fused,
               cudaStream_t s) {
  Config cfg;
  cudaError_t err = config_for(&cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (3LL * n + kRunTile - 1) / kRunTile;
  int32_t* counts = runs + n + 1;
  stat_runs<<<grid(cfg.sms, cfg.runs, tiles), kRunThreads, 0, s>>>(keys, runs, marks, counts, n,
                                                                   tiles);
  err = cudaGetLastError();
  if (kRunParts == 1 || err != cudaSuccess) return static_cast<int>(err);

  stat_slots<<<grid(cfg.sms, cfg.slots, (n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      col, runs, reinterpret_cast<int4*>(lists), counts, out, n, fused);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most n / (kTinyMax + 1) clusters reach the warp list, n / (kWarpMax + 1) the block list
  const long long warp_clusters = n / (kTinyMax + 1);
  stat_warps<<<grid(cfg.sms, cfg.warps, (warp_clusters + kThreads / 32 - 1) / (kThreads / 32)),
               kThreads, kWarpSmem, s>>>(col, reinterpret_cast<const int4*>(lists), counts, out,
                                         n, fused, kWarpStride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_blocks<<<grid(cfg.sms, cfg.blocks, n / (kWarpMax + 1)), kBlockThreads, kBlockSmem, s>>>(
      col, reinterpret_cast<const int4*>(lists), counts, lists_big, out, n, fused);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef STAT_CLOCKS
// The warp and block tiers' cycles by part and their clusters summed since
// the last call (kTiers * kClockWords words to out, on the host: each
// tier's kParts parts, then its clusters), then zeroed; a build with
// -DSTAT_CLOCKS only. Synchronous.
extern "C" int stat_clocks(uint64_t* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_stat_clocks, kTiers * kClockWords * sizeof(uint64_t));
  static const unsigned long long zero[kTiers * kClockWords + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stat_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

// The sort's keys (the kernel stat_keys) of n elements: cluster_id (int32)
// and valid (bool bytes) [n] to keys int32 [n], on stream s; n < 2^30.
// Returns the launch's error.
extern "C" int sort_keys(const int32_t* cluster_id, const uint8_t* valid, int32_t* keys, int n,
                         cudaStream_t s) {
  if (n <= 0 || n >= kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  Config cfg;
  cudaError_t err = config_for(&cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const long long rounds = (n + kKeyThreads * kKeyItems - 1) / (kKeyThreads * kKeyItems);
  stat_keys<<<grid(cfg.sms, cfg.keys, rounds), kKeyThreads, 0, s>>>(cluster_id, valid, keys, n);
  return static_cast<int>(cudaGetLastError());
}

// The statistics of n slots (n < 2^30): the sort of stat_keys' keys, its
// sorted keys [n] (int32) and permutation [n] (int64), and the raw columns
// svlen, pos, read_id, mapq, strand, svtype (int32) and nm (float) [n];
// scratch: runs int32 [n + 3] (the n + 1 run starts, then the two list
// counts), lists int32 [4n] (16-byte aligned, an entry of four ints a listed
// slot), marks uint8 [n] (the invalid marks), lists_big int32 [4, n] (the
// lists of a cluster past kBlockMax); out int32 [16, n] in the rows of
// ops/call_stats.KEYS (float rows as bits). The run pass writes every start,
// mark and count before the tiers read them: no memset. The tiers: a thread
// a cluster of at most kTinyMax (<= 8) elements, a warp one of at most
// kWarpMax, a block a larger one, in shared memory up to kBlockMax. Four
// launches on stream s; returns the first error (a shared memory size the
// card refuses included).
extern "C" int call_stats(const int32_t* keys, const int64_t* order, const int32_t* svlen,
                          const int32_t* pos, const int32_t* read_id, const int32_t* mapq,
                          const int32_t* strand, const int32_t* svtype, const float* nm,
                          int32_t* runs, int32_t* lists, uint8_t* marks, int32_t* lists_big,
                          int32_t* out, int n, int fused, cudaStream_t s) {
  if (n <= 0 || n >= kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_all(
      keys, Columns{order, svlen, pos, read_id, mapq, strand, svtype, nm, marks}, runs, lists,
      marks, lists_big, out, n, fused != 0, s);
  // a refused attribute or occupancy query leaves its error behind as the
  // last error; clear it, so that it is not read after a later launch
  if (err != 0) cudaGetLastError();
  return err;
}
