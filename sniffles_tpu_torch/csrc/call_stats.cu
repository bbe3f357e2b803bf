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
// Input: one stable sort by the masked cluster id (INT32_MAX where not
// valid): its sorted ids and permutation, which give each cluster's
// elements in array order, and the raw columns. Every element of a masked
// id in [0, n) is valid, so a run of the sorted ids is a cluster; ids
// outside [0, n) are ignored, as the segment ops drop them.
//
// Each live cluster gathers its svlen, pos and read ids through the
// permutation and sorts them itself: a sort of a cluster's values gives
// the same sorted list whatever the order of equal values, so no global
// sort by value is needed, and every statistic reads the sorted lists on
// chip. The sorts are bitonic networks with every comparator ascending
// (the first step of each merge compares mirrored pairs), padded with
// INT32_MAX past cnt, which sorts last and is never read: in registers the
// padding is real; in memory it is virtual (a comparator whose upper
// element lies past cnt would keep INT32_MAX there and is skipped). Valid
// values may be INT32_MAX or INT32_MIN; the comparisons are signed int32.
//
// Tiers by the cluster's size cnt (the thresholds are build-time constants,
// -DSTAT_TINY_MAX, -DSTAT_PAIR_MAX, -DSTAT_WARP_MAX, -DSTAT_BLOCK_MAX from
// ops/call_stats.py TINY_MAX, PAIR_MAX, WARP_MAX, BLOCK_MAX):
//   * stat_slots, a thread a slot over all n slots (a resident grid,
//     coalesced): an empty slot gets the identities of the plain version's
//     reductions; a cluster of cnt <= kTinyMax (<= kTinyCap) is done in the
//     thread, its values in registers, sorted by a fixed network of 19
//     compare-exchanges; each larger cluster's entry (slot, run, count,
//     invalid mark) goes to the warp or the block list (a warp's appends by
//     one atomic);
//   * stat_warps, a warp a cluster of cnt <= kWarpMax, the next cluster's
//     entry and permutation entries loaded while it works on one: up to
//     kPairMax elements in two registers a lane, sorted by shuffles, the
//     medians and the support count by ballots and scans over them; past
//     that, the lists in the warp's slice of shared memory, sorted as the
//     block's below. Then the six float32 chains (s1 and s2 of svlen and of
//     pos, the mapq and NM sums) are each summed by a lane of its own, term
//     by term from shared memory, in lockstep;
//   * stat_blocks, a block a cluster of cnt > kWarpMax: five lists (svlen,
//     pos, read, sorted; mapq and NM as float32 in array order) in dynamic
//     shared memory up to kBlockMax elements (20 bytes each), past it in a
//     global scratch buffer at the cluster's run. The block sorts them:
//     each chunk of 64 in registers, then each wider merge's steps of 64
//     apart or more in memory and its last six in registers, by all warps
//     but the last, whose lanes meanwhile sum the mapq and NM chains (array
//     order needs no sort). Then those warps take the medians and the
//     support count (a range of the list each, meeting at a named barrier)
//     while the last one's lanes sum the trimmed windows' four chains.
//
// Bound: bytes. An element's masked id and permutation (12 bytes), its
// cluster id, valid byte, svlen, pos, read id, mapq, strand, svtype and NM
// (33) are read, and 64 bytes a slot written; the operations (a few dozen
// an element, the sorts' log^2 steps on chip) are below the card's integer
// rate. Most slots are empty (the live ones are the low ids), so their rows
// are written a thread a slot, coalesced. A chain's sum is sequential (one
// dependent float32 add an element), which bounds a large cluster by
// latency, not by bytes: the lanes that hold the six chains run them at
// once, a batch of kBatch terms loaded and converted ahead of their adds.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#if !defined(STAT_TINY_MAX) || !defined(STAT_PAIR_MAX) || !defined(STAT_WARP_MAX) || \
    !defined(STAT_BLOCK_MAX)
#error "build with the tier thresholds of ops/call_stats.py (its nvcc_defines)"
#endif

namespace {

constexpr int kThreads = 256;       // stat_slots' and stat_warps' blocks
constexpr int kRunThreads = 256;    // stat_runs: a thread an element
constexpr int kBlockThreads = 512;  // stat_blocks: a block a cluster
constexpr int kMedianWarps = kBlockThreads / 32 - 1;  // its last warp sums the chains
constexpr int kTinyCap = 8;         // the most elements a thread sorts in registers
constexpr int kTinyMax = STAT_TINY_MAX;    // the thread tier's largest cluster
constexpr int kPairMax = STAT_PAIR_MAX;    // a warp's largest in registers (0: none)
constexpr int kWarpMax = STAT_WARP_MAX;    // the warp tier's largest cluster
constexpr int kBlockMax = STAT_BLOCK_MAX;  // a block's largest in shared memory
static_assert(kTinyMax >= 0 && kTinyMax <= kTinyCap, "a thread sorts at most kTinyCap");
static_assert(kPairMax == 0 || kPairMax == 64, "a warp's two registers a lane hold 64");
static_assert(kWarpMax >= kTinyMax && kWarpMax >= 1 && kBlockMax >= kWarpMax,
              "the tiers ascend");
constexpr int kBatch = 8;           // a chain's terms loaded ahead of their adds
constexpr int kLists = 5;           // svlen, pos, read (sorted); mapq, NM (array order)
// the lanes of chain_sum's chains: s1 and s2 of svlen and pos (sorted
// order), the mapq and NM sums (array order)
constexpr unsigned kSortedChains = 0x0F, kArrayChains = 0x30,
                   kAllChains = kSortedChains | kArrayChains;
constexpr unsigned kFull = 0xffffffffu;
constexpr int INS = 0, DEL = 1;

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
  const uint8_t* has_invalid;
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

__device__ void write_live(int32_t* __restrict__ out, int n, int c, const Stats& t) {
  const float div = __int2float_rn(t.cnt);
  const int rev = t.cnt - t.fwd;
  const bool is_ins = t.sv == INS, is_del = t.sv == DEL;
  int v[kRows];
  v[kSvtype] = t.sv;
  v[kSvlen] = t.svlen_c;
  v[kPos] = is_del ? wrap_add(t.pos_c, t.svlen_c) : t.pos_c;
  v[kEnd] = (is_ins || is_del) ? t.pos_c : wrap_add(t.pos_c, wrap_abs(t.svlen_c));
  v[kRawPos] = t.pos_c;
  v[kPosMin] = t.pos_min;
  v[kPosMax] = t.pos_max;
  v[kStdevPos] = __float_as_int(t.stdev_pos);
  v[kStdevLen] = __float_as_int(t.stdev_len);
  v[kSupport] = t.support;
  v[kLeadCount] = t.cnt;
  v[kQual] = to_i32(floorf(__fdiv_rn(t.mapq_sum, div)));
  v[kFwd] = t.fwd;
  v[kRev] = rev;
  v[kNm] = __float_as_int(__fdiv_rn(t.nm_sum, div));
  v[kNStrands] = (t.fwd > 0 && rev > 0) ? 2 : 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * n + c] = v[r];
}

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
  t.sv = col.has_invalid[c] ? -1 : INT_MIN;
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

// The lists of a cluster: list r at L + r * stride, elements [0, cnt).
// Gathers them through the permutation, a thread (of `step`) two elements
// an iteration in array order (both elements' loads issued before the
// stores), and returns the thread's share of the strand count and of the
// svtype max.
__device__ void gather(const Columns& col, int s, int cnt, int* L, size_t stride, int tid,
                       int step, int& fwd, int& sv) {
  for (int i = tid; i < cnt; i += 2 * step) {
    const int i2 = i + step;
    const bool two = i2 < cnt;
    const int64_t o = col.order[s + i], o2 = two ? col.order[s + i2] : o;
    const int a = col.svlen[o], b = col.pos[o], r = col.read_id[o], q = col.mapq[o];
    const int a2 = col.svlen[o2], b2 = col.pos[o2], r2 = col.read_id[o2], q2 = col.mapq[o2];
    const float x = col.nm[o], x2 = col.nm[o2];
    const int f = col.strand[o] > 0, f2 = two && col.strand[o2] > 0;
    sv = max(sv, max(col.svtype[o], two ? col.svtype[o2] : INT_MIN));
    fwd += f + f2;
    L[i] = a;
    L[stride + i] = b;
    L[2 * stride + i] = r;
    L[3 * stride + i] = __float_as_int(__int2float_rn(q));
    L[4 * stride + i] = __float_as_int(x);
    if (two) {
      L[i2] = a2;
      L[stride + i2] = b2;
      L[2 * stride + i2] = r2;
      L[3 * stride + i2] = __float_as_int(__int2float_rn(q2));
      L[4 * stride + i2] = __float_as_int(x2);
    }
  }
}

// the barrier of the block's warps 0 .. kMedianWarps - 1 (named barrier 1)
__device__ __forceinline__ void median_bar() {
  asm volatile("bar.sync 1, %0;" ::"r"(kMedianWarps * 32) : "memory");
}

// who works together on a cluster's lists
enum Group { kWarp, kMedianGroup };

__device__ __forceinline__ void sync_group(Group group) {
  if (group == kWarp) {
    __syncwarp();
  } else {
    median_bar();
  }
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

// One comparator step of the bitonic sort of lists 0-2 in memory: a merge
// of width k, elements j apart (j >= 64), by `step` threads. A comparator
// whose upper element lies past cnt is skipped (the virtual padding is
// INT32_MAX).
__device__ void memory_step(int* L, size_t stride, int cnt, int p, int k, int j, int tid,
                            int step) {
  for (int t = tid; t < (p >> 1); t += step) {
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
// registers: warp w of `warps` loads chunk w, w + warps, ... of lists 0-2
// (INT32_MAX past cnt), runs the steps and stores the elements before cnt.
__device__ void chunk_steps(int* L, size_t stride, int cnt, int p, int from, int k, int warp,
                            int warps, int lane) {
  for (int base = warp * 64; base < p; base += warps * 64) {
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

// The bitonic sort of lists 0-2 (svlen, pos, read), each of cnt elements,
// by `warps` warps (a warp, or the block's median warps), every comparator
// ascending: the first step of a merge of width k pairs mirrored elements,
// the later ones elements j apart. The steps within chunks of 64 run in
// registers (each chunk whole first, then the last six steps of each wider
// merge), the others in memory.
__device__ void sort_lists(int* L, size_t stride, int cnt, int warp, int warps, int lane,
                           Group group) {
  int p = 1;
  while (p < cnt) p <<= 1;
  chunk_steps(L, stride, cnt, p, 2, min(p, 64), warp, warps, lane);
  sync_group(group);
  for (int k = 128; k <= p; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      memory_step(L, stride, cnt, p, k, j, warp * 32 + lane, warps * 32);
      sync_group(group);
    }
    chunk_steps(L, stride, cnt, p, k, k, warp, warps, lane);
    sync_group(group);
  }
}

// inclusive max over lanes 0..lane
__device__ __forceinline__ int scan_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// the lane of the (k+1)-th set bit of m (m has more than k set bits)
__device__ __forceinline__ int nth_set(unsigned m, int k) {
  for (int j = 0; j < k; ++j) m &= m - 1;
  return __ffs(m) - 1;
}

// One chunk of 32 elements, at base, of a sorted list v[0, cnt): the lane's
// element i = base + lane, its value, whether it ends a run of equal values
// and the length of that run; `open` carries the start of the run open at
// the chunk's first element into the next chunk.
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
  const bool starts = in && (i == 0 || v[i - 1] != c.value);
  c.ends = in && (i + 1 == cnt || v[i + 1] != c.value);
  const int rs = max(scan_max(starts ? i : -1, lane), open);
  c.len = i - rs + 1;
  open = __shfl_sync(kFull, rs, 31);
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

// ---- a block's cluster: the medians and the support by kMedianWarps -----
// Warp w of them takes the chunks of 32 [w * per, (w + 1) * per) of the
// list, and meets the others at a named barrier (the last warp of the
// block sums the chains meanwhile, so __syncthreads is not theirs).

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
  const int per = ((cnt + 31) / 32 + kMedianWarps - 1) / kMedianWarps;
  first = min(cnt, warp * per * 32);
  last = min(cnt, (warp + 1) * per * 32);
}

// the sum of every median warp's x (sh: kMedianWarps ints of scratch)
__device__ __forceinline__ int block_sum(int x, int warp, int lane, int* sh) {
  if (lane == 0) sh[warp] = x;
  median_bar();
  int total = 0;
  for (int w = 0; w < kMedianWarps; ++w) total += sh[w];
  median_bar();  // before sh is written again
  return total;
}

// util.median_modes of the sorted list v[0, cnt), as median_modes, by the
// median warps; the value on each of their threads (sh: kMedianWarps + 1 ints)
__device__ int block_median_modes(const int* v, int cnt, int warp, int lane, int* sh) {
  int first, last;
  warp_range(cnt, warp, first, last);
  const int start = first < last ? run_start(v, first) : 0;
  int top = 0, open = start;
  for (int base = first; base < last; base += 32) {
    const Chunk c = chunk_at(v, cnt, base, lane, open);
    top = max(top, __reduce_max_sync(kFull, c.ends ? c.len : 0));
  }
  if (lane == 0) sh[warp] = top;
  median_bar();
  top = 0;
  for (int w = 0; w < kMedianWarps; ++w) top = max(top, sh[w]);
  median_bar();
  int kept = 0;
  open = start;
  for (int base = first; base < last; base += 32) {
    const Chunk c = chunk_at(v, cnt, base, lane, open);
    kept += __popc(__ballot_sync(kFull, c.ends && top - c.len < 3));
  }
  if (lane == 0) sh[warp] = kept;
  median_bar();
  int before = 0, total = 0;
  for (int w = 0; w < kMedianWarps; ++w) {
    before += w < warp ? sh[w] : 0;
    total += sh[w];
  }
  const int target = total / 2;
  if (target >= before && target < before + kept) {  // the warp that holds it
    int seen = before;
    open = start;
    for (int base = first; base < last; base += 32) {
      const Chunk c = chunk_at(v, cnt, base, lane, open);
      const unsigned m = __ballot_sync(kFull, c.ends && top - c.len < 3);
      const int here = __popc(m);
      if (seen + here > target) {
        const int med = __shfl_sync(kFull, c.value, nth_set(m, target - seen));
        if (lane == 0) sh[kMedianWarps] = med;
        break;
      }
      seen += here;
    }
  }
  median_bar();
  const int med = sh[kMedianWarps];
  median_bar();
  return med;
}

// the distinct values of the sorted list v[0, cnt), by the median warps
__device__ int block_distinct(const int* v, int cnt, int warp, int lane, int* sh) {
  int first, last;
  warp_range(cnt, warp, first, last);
  int count = 0;
  for (int base = first; base < last; base += 32) {
    const int i = base + lane;
    count += __popc(__ballot_sync(kFull, i < cnt && (i == 0 || v[i - 1] != v[i])));
  }
  return block_sum(count, warp, lane, sh);
}

// ---- a warp's cluster of at most kPairMax elements: registers ------------
// Element i of a list is in register i / 32 of lane i % 32 (as pair_step);
// the padding past cnt is INT32_MAX.

// whether each of the pair's elements starts a run of equal values (its
// predecessor differs); only elements before cnt
__device__ __forceinline__ void pair_starts(int v0, int v1, int cnt, int lane, bool& s0,
                                            bool& s1) {
  const int up0 = __shfl_up_sync(kFull, v0, 1), up1 = __shfl_up_sync(kFull, v1, 1);
  const int last0 = __shfl_sync(kFull, v0, 31);
  s0 = lane < cnt && (lane == 0 || up0 != v0);
  s1 = lane + 32 < cnt && (lane == 0 ? last0 : up1) != v1;
}

// util.median_modes of a sorted pair, as median_modes
__device__ __forceinline__ int pair_median_modes(int v0, int v1, int cnt, int lane) {
  bool s0, s1;
  pair_starts(v0, v1, cnt, lane, s0, s1);
  const int i0 = lane, i1 = lane + 32;
  const int dn0 = __shfl_down_sync(kFull, v0, 1), dn1 = __shfl_down_sync(kFull, v1, 1);
  const int first1 = __shfl_sync(kFull, v1, 0);
  const bool e0 = i0 < cnt && (i0 + 1 == cnt || (lane == 31 ? first1 : dn0) != v0);
  const bool e1 = i1 < cnt && (i1 + 1 == cnt || dn1 != v1);
  const int rs0 = scan_max(s0 ? i0 : -1, lane);
  const int rs1 = max(scan_max(s1 ? i1 : -1, lane), __shfl_sync(kFull, rs0, 31));
  const int l0 = i0 - rs0 + 1, l1 = i1 - rs1 + 1;
  const int top = __reduce_max_sync(kFull, max(e0 ? l0 : 0, e1 ? l1 : 0));
  const unsigned m0 = __ballot_sync(kFull, e0 && top - l0 < 3);
  const unsigned m1 = __ballot_sync(kFull, e1 && top - l1 < 3);
  const int n0 = __popc(m0), target = (n0 + __popc(m1)) / 2;
  return target < n0 ? __shfl_sync(kFull, v0, nth_set(m0, target))
                     : __shfl_sync(kFull, v1, nth_set(m1, target - n0));
}

// A warp's cluster of cnt <= kPairMax elements, its permutation entries
// o0 (element lane) and o1 (element lane + 32) loaded: gathered into
// registers, sorted by shuffles; the sorted svlen and pos lists and the
// mapq and NM terms (array order) stored to the warp's lists for the chains.
__device__ void pair_cluster(const Columns& col, int64_t o0, int64_t o1, int cnt, int* L,
                             size_t stride, int lane, Stats& t) {
  const bool in0 = lane < cnt, in1 = lane + 32 < cnt;
  int v[3][2];
  v[0][0] = in0 ? col.svlen[o0] : INT_MAX;
  v[0][1] = in1 ? col.svlen[o1] : INT_MAX;
  v[1][0] = in0 ? col.pos[o0] : INT_MAX;
  v[1][1] = in1 ? col.pos[o1] : INT_MAX;
  v[2][0] = in0 ? col.read_id[o0] : INT_MAX;
  v[2][1] = in1 ? col.read_id[o1] : INT_MAX;
  const int q0 = in0 ? col.mapq[o0] : 0, q1 = in1 ? col.mapq[o1] : 0;
  const float x0 = in0 ? col.nm[o0] : 0.0f, x1 = in1 ? col.nm[o1] : 0.0f;
  const int f = (in0 && col.strand[o0] > 0) + (in1 && col.strand[o1] > 0);
  const int sv = max(in0 ? col.svtype[o0] : INT_MIN, in1 ? col.svtype[o1] : INT_MIN);
  if (in0) {
    L[3 * stride + lane] = __float_as_int(__int2float_rn(q0));
    L[4 * stride + lane] = __float_as_int(x0);
  }
  if (in1) {
    L[3 * stride + lane + 32] = __float_as_int(__int2float_rn(q1));
    L[4 * stride + lane + 32] = __float_as_int(x1);
  }
  t.fwd = __reduce_add_sync(kFull, f);
  t.sv = __reduce_max_sync(kFull, sv);
  int p = 1;
  while (p < cnt) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < 3; ++r) pair_step(v[r][0], v[r][1], k, j, lane);
    }
  }
  bool s0, s1;
  pair_starts(v[2][0], v[2][1], cnt, lane, s0, s1);
  t.support = __popc(__ballot_sync(kFull, s0)) + __popc(__ballot_sync(kFull, s1));
  t.svlen_c = pair_median_modes(v[0][0], v[0][1], cnt, lane);
  t.pos_c = pair_median_modes(v[1][0], v[1][1], cnt, lane);
  t.pos_min = __shfl_sync(kFull, v[1][0], 0);
  t.pos_max = cnt > 32 ? __shfl_sync(kFull, v[1][1], cnt - 33) : __shfl_sync(kFull, v[1][0], cnt - 1);
  if (in0) {
    L[lane] = v[0][0];
    L[stride + lane] = v[1][0];
  }
  if (in1) {
    L[lane + 32] = v[0][1];
    L[stride + lane + 32] = v[1][1];
  }
  __syncwarp();
}

// a chain's term: a centered int32 value as float32 (squared for s2), or a
// float32 from its bits
__device__ __forceinline__ float chain_term(int w, int shift, bool centered, bool square) {
  const float x = centered ? __int2float_rn(wrap_sub(w, shift)) : __int_as_float(w);
  return square ? __fmul_rn(x, x) : x;
}

// The six float32 chains of a cluster's lists, a lane each, in lockstep:
// lanes 0 and 1 s1 and s2 of the trimmed svlen window, 2 and 3 those of
// pos (sorted order), lane 4 the mapq sum and lane 5 the NM sum (array
// order); term by term from 0, as the plain version adds them. Only the
// lanes of the mask `lanes` sum. Returns the lane's sum (0 on the other
// lanes, and on 0-3 for a window under 2).
__device__ float chain_sum(const int* L, size_t stride, int cnt, int lane, unsigned lanes) {
  const int trim = trim_of(cnt), k = cnt - 2 * trim;
  const bool centered = lane < 4, square = centered && (lane & 1);
  const int list = centered ? lane >> 1 : (lane == 4 ? 3 : 4);
  const int len = !((lanes >> lane) & 1) ? 0 : centered ? (k < 2 ? 0 : k) : cnt;
  const int* src = L + list * stride + (centered ? trim : 0);
  const int shift = centered && len ? src[0] : 0;  // the window's minimum
  float acc = 0.0f;
  int j = 0;
  for (; j + kBatch <= len; j += kBatch) {  // a batch's terms ahead of its adds
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[u] = chain_term(src[j + u], shift, centered, square);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; j < len; ++j) acc = __fadd_rn(acc, chain_term(src[j], shift, centered, square));
  return acc;
}

// The statistics of a chain_sum's lanes, on every lane of the warp.
__device__ void chain_stats(float acc, int cnt, bool fused, Stats& t) {
  const float s = __shfl_sync(kFull, acc, 0), s2 = __shfl_sync(kFull, acc, 1);
  const float p = __shfl_sync(kFull, acc, 2), p2 = __shfl_sync(kFull, acc, 3);
  t.mapq_sum = __shfl_sync(kFull, acc, 4);
  t.nm_sum = __shfl_sync(kFull, acc, 5);
  const int k = cnt - 2 * trim_of(cnt);
  t.stdev_len = stdev_of(s, s2, k, fused);
  t.stdev_pos = stdev_of(p, p2, k, fused);
}

// A run pass, a thread an element: the ends of each slot's run of the
// sorted masked ids (runs[c] = start, runs[n + c] = end; zero for an empty
// slot, set by the memset before), and the slots that an invalid element
// names.
__global__ void stat_runs(const int32_t* __restrict__ cid_sorted,
                          const int32_t* __restrict__ cluster_id,
                          const uint8_t* __restrict__ valid, int32_t* __restrict__ runs,
                          uint8_t* __restrict__ has_invalid, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cid_sorted[i];
  if (c >= 0 && c < n) {
    if (i == 0 || cid_sorted[i - 1] != c) runs[c] = i;
    if (i + 1 == n || cid_sorted[i + 1] != c) runs[n + c] = i + 1;
  }
  if (!valid[i]) {
    const int r = cluster_id[i];
    if (r >= 0 && r < n) has_invalid[r] = 1;  // every writer writes 1
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
stat_slots(Columns col, const int32_t* __restrict__ runs, int4* __restrict__ lists,
           int32_t* __restrict__ counts, int32_t* __restrict__ out, int n, bool fused) {
  const int lane = threadIdx.x & 31;
  const int threads = gridDim.x * blockDim.x;
  const unsigned below = (1u << lane) - 1;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n; base += threads) {
    const int c = base + lane;
    int s = 0, cnt = 0;
    if (c < n) {
      s = runs[c];
      cnt = runs[n + c] - s;
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
      const int4 entry = make_int4(c, s, cnt, col.has_invalid[c]);
      if (to_warp) lists[at_w + __popc(mw & below)] = entry;
      if (to_block) lists[n - 1 - (at_b + __popc(mb & below))] = entry;
    }
    if (c >= n) continue;
    if (cnt == 0) {
      const int v[kRows] = {col.has_invalid[c] ? -1 : INT_MIN, 0, 0, 0, 0, INT_MAX, INT_MIN,
                            0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * n + c] = v[r];
    } else if (cnt <= kTinyMax) {
      tiny_slot(col, out, n, fused, c, s, cnt);
    }
  }
}

// A resident grid, a warp a cluster of the warp list, its five lists in
// the warp's slice of the dynamic shared memory (kLists * stride ints;
// stride is kWarpMax, a kernel argument all the same: as a constant, ptxas
// gives the kernel 48 registers and spills, 4 % slower, PERF.md).
__global__ void __launch_bounds__(kThreads)
stat_warps(Columns col, const int4* __restrict__ lists, const int32_t* __restrict__ counts,
           int32_t* __restrict__ out, int n, bool fused, int stride) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5, per_block = blockDim.x >> 5;
  int* L = smem + static_cast<size_t>(wib) * kLists * stride;
  const int total = counts[0], warps = gridDim.x * per_block;
  const int4 none = make_int4(0, 0, 0, 0);
  int w = blockIdx.x * per_block + wib;
  // ahead of the cluster in hand: the next one's entry and permutation
  // entries, and the entry after it, so that only its columns' loads wait
  int4 next = w < total ? lists[w] : none;
  int4 after = w + warps < total ? lists[w + warps] : none;
  int64_t o0 = kPairMax && lane < next.z ? col.order[next.y + lane] : 0;
  int64_t o1 = kPairMax && lane + 32 < next.z ? col.order[next.y + lane + 32] : 0;
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
    if (cnt <= kPairMax) {
      pair_cluster(col, p0, p1, cnt, L, stride, lane, t);
    } else {
      int fwd = 0, sv = INT_MIN;
      gather(col, s, cnt, L, stride, lane, 32, fwd, sv);
      t.fwd = __reduce_add_sync(kFull, fwd);
      t.sv = __reduce_max_sync(kFull, sv);
      __syncwarp();
      sort_lists(L, stride, cnt, 0, 1, lane, kWarp);
      t.support = distinct(L + 2 * stride, cnt, lane);
      t.svlen_c = median_modes(L, cnt, lane);
      t.pos_c = median_modes(L + stride, cnt, lane);
      t.pos_min = L[stride];
      t.pos_max = L[stride + cnt - 1];
    }
    t.sv = max(t.sv, e.w ? -1 : INT_MIN);
    chain_stats(chain_sum(L, stride, cnt, lane, kAllChains), cnt, fused, t);
    if (lane == 0) write_live(out, n, c, t);
    __syncwarp();  // the slice is read before the next cluster writes it
  }
}

// The cluster of entry e (slot c, run [s, s + cnt), invalid mark), by the
// block: its five lists at L (list r at L + r * stride), gathered by every
// thread; the median warps sort them while the last warp's lanes 4 and 5
// sum the mapq and NM chains (array order); then the median warps take the
// svlen and pos medians and the support count while its lanes 0-3 sum the
// trimmed windows' chains. Inlined twice, for lists in shared memory and
// in global scratch, so that each copy knows its lists' memory.
__device__ __forceinline__ void block_cluster(const Columns& col, int4 e, int* L, size_t stride,
                                              int32_t* __restrict__ out, int n, bool fused,
                                              int* ints, float* sums, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = e.x, s = e.y, cnt = e.z;
  if (threadIdx.x == 0) {
    ints[0] = 0;
    ints[1] = INT_MIN;
  }
  __syncthreads();
  int fwd = 0, sv = INT_MIN;
  gather(col, s, cnt, L, stride, threadIdx.x, blockDim.x, fwd, sv);
  fwd = __reduce_add_sync(kFull, fwd);
  sv = __reduce_max_sync(kFull, sv);
  if (lane == 0) {
    atomicAdd(&ints[0], fwd);
    atomicMax(&ints[1], sv);
  }
  __syncthreads();
  if (warp < kMedianWarps) {
    sort_lists(L, stride, cnt, warp, kMedianWarps, lane, kMedianGroup);
  } else {  // the mapq and NM sums need no sort
    const float acc = chain_sum(L, stride, cnt, lane, kArrayChains);
    if ((kArrayChains >> lane) & 1) sums[lane] = acc;
  }
  __syncthreads();
  if (warp < kMedianWarps) {
    const int svlen_c = block_median_modes(L, cnt, warp, lane, sh);
    const int pos_c = block_median_modes(L + stride, cnt, warp, lane, sh);
    const int support = block_distinct(L + 2 * stride, cnt, warp, lane, sh);
    if (threadIdx.x == 0) {
      ints[2] = svlen_c;
      ints[3] = pos_c;
      ints[4] = support;
    }
  } else {
    const float acc = chain_sum(L, stride, cnt, lane, kSortedChains);
    if ((kSortedChains >> lane) & 1) sums[lane] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats t;
    t.cnt = cnt;
    t.fwd = ints[0];
    t.sv = max(ints[1], e.w ? -1 : INT_MIN);
    t.svlen_c = ints[2];
    t.pos_c = ints[3];
    t.support = ints[4];
    t.pos_min = L[stride];
    t.pos_max = L[stride + cnt - 1];
    const int k = cnt - 2 * trim_of(cnt);
    t.stdev_len = stdev_of(sums[0], sums[1], k, fused);
    t.stdev_pos = stdev_of(sums[2], sums[3], k, fused);
    t.mapq_sum = sums[4];
    t.nm_sum = sums[5];
    write_live(out, n, c, t);
  }
  __syncthreads();  // the lists and ints are read before the next cluster writes them
}

// A block a cluster of the block list: its five lists in the dynamic
// shared memory (cnt <= kBlockMax, kLists * cnt ints) or, past it, in the
// scratch rows at the cluster's run (scratch + r * n + s).
__global__ void __launch_bounds__(kBlockThreads)
stat_blocks(Columns col, const int4* __restrict__ lists, const int32_t* __restrict__ counts,
            int32_t* scratch, int32_t* __restrict__ out, int n, bool fused) {
  extern __shared__ int smem[];
  __shared__ int ints[5];  // the strand count, svtype max, the medians, support
  __shared__ float sums[6];
  __shared__ int sh[kMedianWarps + 1];
  const int total = counts[1];
  for (int b = blockIdx.x; b < total; b += gridDim.x) {
    const int4 e = lists[n - 1 - b];
    if (e.z <= kBlockMax) {
      block_cluster(col, e, smem, static_cast<size_t>(e.z), out, n, fused, ints, sums, sh);
    } else {
      block_cluster(col, e, scratch + e.y, static_cast<size_t>(n), out, n, fused, ints, sums,
                    sh);
    }
  }
}

// the dynamic shared memory of a stat_warps block and of a stat_blocks block
constexpr size_t kWarpSmem = sizeof(int) * kLists * static_cast<size_t>(kWarpMax) *
                             (kThreads / 32);
constexpr size_t kBlockSmem = sizeof(int) * kLists * static_cast<size_t>(kBlockMax);

// What the launches on one device need: its SMs, the blocks of each kernel
// one SM holds at once, after the warp and block tiers' shared memory
// attributes are set. Cached by device, since the queries cost host time on
// every call otherwise.
struct Config {
  int dev = -1, sms = 0, slots = 0, warps = 0, blocks = 0;
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->slots, stat_slots, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->warps, stat_warps, kThreads,
                                                        warp_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->blocks, stat_blocks, kBlockThreads,
                                                        block_smem);
  if (err != cudaSuccess) return err;
  // a tier whose shared memory no SM holds
  if (c->slots < 1 || c->warps < 1 || c->blocks < 1) return cudaErrorInvalidConfiguration;
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

int launch_all(const int32_t* cid_sorted, const int64_t* order, const int32_t* cluster_id,
               const uint8_t* valid, const Columns& col, int32_t* runs, int32_t* lists,
               uint8_t* has_invalid, int32_t* lists_big, int32_t* out, int n, bool fused,
               cudaStream_t s) {
  Config cfg;
  cudaError_t err = config_for(&cfg);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(runs, 0, sizeof(int32_t) * (2 * static_cast<size_t>(n) + 2), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(has_invalid, 0, static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_runs<<<(n + kRunThreads - 1) / kRunThreads, kRunThreads, 0, s>>>(
      cid_sorted, cluster_id, valid, runs, has_invalid, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int32_t* counts = runs + 2 * static_cast<size_t>(n);
  stat_slots<<<grid(cfg.sms, cfg.slots, (n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      col, runs, reinterpret_cast<int4*>(lists), counts, out, n, fused);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most n / (kTinyMax + 1) clusters reach the warp list, n / (kWarpMax + 1) the block list
  const long long warp_clusters = n / (kTinyMax + 1);
  stat_warps<<<grid(cfg.sms, cfg.warps, (warp_clusters + kThreads / 32 - 1) / (kThreads / 32)),
               kThreads, kWarpSmem, s>>>(col, reinterpret_cast<const int4*>(lists), counts, out,
                                         n, fused, kWarpMax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_blocks<<<grid(cfg.sms, cfg.blocks, n / (kWarpMax + 1)), kBlockThreads, kBlockSmem, s>>>(
      col, reinterpret_cast<const int4*>(lists), counts, lists_big, out, n, fused);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The statistics of n slots: the cid sort's sorted masked ids [n] (int32)
// and permutation [n] (int64), the raw cluster_id, valid (bool bytes),
// svlen, pos, read_id, mapq, strand, svtype (int32) and nm (float) [n];
// scratch: runs int32 [2n + 2] (the runs, then the two list counts), lists
// int32 [4n] (16-byte aligned, an entry of four ints a listed slot),
// has_invalid uint8 [n], lists_big int32 [5, n] (the lists of a cluster
// past kBlockMax); out int32 [16, n] in the rows of
// ops/call_stats.KEYS (float rows as bits). The tiers: a thread a cluster
// of at most kTinyMax (<= 8) elements, a warp one of at most kWarpMax, a
// block a larger one, in shared memory up to kBlockMax. Two memsets and
// four launches on stream s; returns the first error (a shared memory size
// the card refuses included).
extern "C" int call_stats(const int32_t* cid_sorted, const int64_t* order,
                          const int32_t* cluster_id, const uint8_t* valid, const int32_t* svlen,
                          const int32_t* pos, const int32_t* read_id, const int32_t* mapq,
                          const int32_t* strand, const int32_t* svtype, const float* nm,
                          int32_t* runs, int32_t* lists, uint8_t* has_invalid,
                          int32_t* lists_big, int32_t* out, int n, int fused,
                          cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_all(cid_sorted, order, cluster_id, valid,
                             Columns{order, svlen, pos, read_id, mapq, strand, svtype, nm,
                                     has_invalid},
                             runs, lists, has_invalid, lists_big, out, n, fused != 0, s);
  // a refused attribute, memset or occupancy query leaves its error behind
  // as the last error; clear it, so that it is not read after a later launch
  if (err != 0) cudaGetLastError();
  return err;
}
