// The per-cluster calling statistics on Hopper (sm_90a): a run pass over
// the sorted cluster ids, then one resident grid that writes the empty
// slots' identities, a thread a slot, and walks each live cluster slot
// with a warp, once for each statistic.
//
// Replaces the XLA program of the JAX package's jitted call_statistics
// (sniffles_tpu/ops/clustering.py:1262) and the segment statistics it
// calls (ops/stats.py seg_median_modes, seg_trimmed_stdev; ops/segments.py
// seg_stdev, seg_mean, unique_count_per_segment). The plain version
// (ops/call_stats.py::call_statistics_plain) holds the JAX package's CPU
// arithmetic bit for bit; this kernel repeats it:
//   * util.median_modes: the runs of equal values of the sorted run, the
//     longest run's count, the runs within 2 of it kept, the upper median
//     of the kept values (rank n_kept / 2 among them, a warp-wide prefix
//     count over the run's chunks; no cap on the run's length);
//   * the trimmed sample stdev: ranks [cnt * 25 / 100, cnt - trim) of the
//     sorted run, centered on the window's minimum with int32 wrap, then
//     converted to float32; s1 and s2 added term by term in float32 in the
//     run's sorted order, as XLA's scatter-add adds them; the numerator
//     s2 - (cnt * mean) * mean rounded at each step, or with `fused` one
//     fused multiply-add, as the jitted fused step; __fsqrt_rn;
//   * every float32 operation through __f*_rn intrinsics, never contracted;
//   * the mapq and NM means: float32 sums in array order (the cluster's
//     run in the stable sort by cluster id alone), over max(cnt, 1); mapq
//     is integer-valued, its sum exact below 2^24 in any order, NM's is not
//     (rates across many binades), so both add in the CPU's order; the
//     floor of the mapq mean cast to int32 as the CPU's cvttss2si;
//   * support: the distinct read ids of the run sorted by (cluster, read);
//   * svtype: the max of the valid elements' svtypes and -1 where an
//     invalid element names the slot (the plain version's seg_max over the
//     raw ids), INT32_MIN where nothing does; pos_min and pos_max the ends
//     of the pos-sorted run (INT32_MAX and INT32_MIN for an empty slot);
//   * the bounds (calculate_bounds) in int32 arithmetic that wraps.
// Inputs: the three (cluster, value) sorts as their sorted int64 keys
// ((masked cid << 32) | (masked value ^ 0x80000000)), the sorted masked
// cluster ids of the cid-only sort and its permutation, the raw columns.
// Every element of a masked id in [0, n) is valid, and the four sorts
// give the same sequence of masked ids, so one run [start, end) a slot
// indexes all four; ids outside [0, n) are ignored, as the segment ops
// drop them.
//
// Bound: bytes. An element's three keys, its masked id and permutation
// (32 bytes), its cluster id, valid byte, mapq, strand, svtype and NM (21)
// are read, and 64 bytes a slot written; the operations, a few dozen an
// element and statistic pass, are far below the card's integer rate. Most
// slots are empty (the live ones are the low ids): a warp launched for
// each would leave the card waiting on each one's loads, so a resident
// grid writes the empty slots' rows a thread a slot, coalesced, and hands
// only the live slots to warps. A warp reads its run in coalesced chunks
// of 32; a run's sums are sequential (one dependent float32 add an
// element), which bounds a large cluster's warp by latency, not by bytes
// (later work: a block per large cluster, or a segmented in-cluster sort
// in shared memory that removes the global sorts).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // call_stats_kernel's blocks
constexpr int kRunThreads = 256;  // stat_runs: a thread an element
constexpr unsigned kFull = 0xffffffffu;
constexpr int INS = 0, DEL = 1;

// the order of ops/call_stats.KEYS
enum Row { kSvtype, kSvlen, kPos, kEnd, kRawPos, kPosMin, kPosMax, kStdevPos, kStdevLen,
           kSupport, kLeadCount, kQual, kFwd, kRev, kNm, kNStrands, kRows };

__device__ __forceinline__ int value_of(long long key) {
  return static_cast<int>(static_cast<unsigned>(key) ^ 0x80000000u);
}

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

__device__ __forceinline__ int warp_max(int v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
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

// One chunk of 32 elements, at base, of a sorted run [s, e): the lane's
// element i = base + lane, its key, whether it starts and whether it ends a
// run of equal keys (equal values: the run's cid is one), and the length of
// the run that ends there; `open` carries the start of the run open at the
// chunk's first element into the next chunk.
struct Chunk {
  long long key;
  bool starts, ends;
  int len;
};

__device__ __forceinline__ Chunk chunk_at(const long long* __restrict__ key, int s, int e,
                                          int base, int lane, int& open) {
  const int i = base + lane;
  const bool in = i < e;
  Chunk c;
  c.key = in ? key[i] : 0;
  long long prev = __shfl_up_sync(kFull, c.key, 1);
  long long next = __shfl_down_sync(kFull, c.key, 1);
  if (lane == 0 && in && i > s) prev = key[i - 1];
  if (lane == 31 && i + 1 < e) next = key[i + 1];
  c.starts = in && (i == s || prev != c.key);
  c.ends = in && (i + 1 == e || next != c.key);
  const int rs = max(scan_max(c.starts ? i : -1, lane), open);
  c.len = i - rs + 1;
  open = __shfl_sync(kFull, rs, 31);
  return c;
}

// util.median_modes of the run [s, e) of a (cluster, value) sort: three
// passes (the longest run; the kept runs; the one of rank n_kept / 2)
__device__ int median_modes(const long long* __restrict__ key, int s, int e, int lane) {
  int top = 0, open = s;
  for (int base = s; base < e; base += 32) {
    const Chunk c = chunk_at(key, s, e, base, lane, open);
    top = max(top, warp_max(c.ends ? c.len : 0));
  }
  int kept = 0;
  open = s;
  for (int base = s; base < e; base += 32) {
    const Chunk c = chunk_at(key, s, e, base, lane, open);
    kept += __popc(__ballot_sync(kFull, c.ends && top - c.len < 3));
  }
  const int target = kept / 2;
  int seen = 0;
  open = s;
  for (int base = s; base < e; base += 32) {
    const Chunk c = chunk_at(key, s, e, base, lane, open);
    const unsigned m = __ballot_sync(kFull, c.ends && top - c.len < 3);
    const int here = __popc(m);
    if (seen + here > target)
      return value_of(__shfl_sync(kFull, c.key, nth_set(m, target - seen)));
    seen += here;
  }
  return 0;  // not reached: a run keeps its longest run of equal values
}

// util.stdev(util.trim(values)) of the run [s, s + cnt) of a sort
__device__ float trimmed_stdev(const long long* __restrict__ key, int s, int cnt, int lane,
                               bool fused) {
  // int32 arithmetic as the plain version's: cnt * 25 wraps, // floors
  const int prod = static_cast<int>(static_cast<unsigned>(cnt) * 25u);
  const int trim = prod / 100 - (prod % 100 < 0 ? 1 : 0);
  const int lo = s + trim, hi = s + cnt - trim, k = hi - lo;
  if (k < 2) return 0.0f;
  const int shift = value_of(key[lo]);  // the window's minimum: the run is sorted
  float s1 = 0.0f, s2 = 0.0f;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    float x = 0.0f, sq = 0.0f;
    if (i < hi) {
      x = __int2float_rn(wrap_sub(value_of(key[i]), shift));
      sq = __fmul_rn(x, x);
    }
    const int m = min(32, hi - base);
    for (int j = 0; j < m; ++j) {  // in sorted order, term by term
      s1 = __fadd_rn(s1, __shfl_sync(kFull, x, j));
      s2 = __fadd_rn(s2, __shfl_sync(kFull, sq, j));
    }
  }
  const float c = __int2float_rn(k);
  const float mean = __fdiv_rn(s1, c);
  const float cm = __fmul_rn(c, mean);
  const float num = fused ? __fmaf_rn(-cm, mean, s2) : __fsub_rn(s2, __fmul_rn(cm, mean));
  float var = __fdiv_rn(num, __fsub_rn(c, 1.0f));
  var = var < 0.0f ? 0.0f : var;
  return __fsqrt_rn(var);
}

// A thread an element: the ends of each slot's run of the sorted masked
// ids (runs[c] = start, runs[n + c] = end; zero for an empty slot, set by
// the memset before), and the slots that an invalid element names.
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

// The statistics of the live slot c, its run [s, e) (e > s), by its warp;
// lane 0 writes the 16 values.
__device__ void slot_stats(const long long* __restrict__ key_len,
                           const long long* __restrict__ key_pos,
                           const long long* __restrict__ key_read,
                           const int64_t* __restrict__ order, const int32_t* __restrict__ mapq,
                           const int32_t* __restrict__ strand,
                           const int32_t* __restrict__ svtype, const float* __restrict__ nm,
                           const uint8_t* __restrict__ has_invalid, int32_t* __restrict__ out,
                           int n, bool fused, int c, int s, int e, int lane) {
  const int cnt = e - s;
  // the cluster in array order: strands, svtypes, the mapq and NM sums
  int fwd = 0, sv = has_invalid[c] ? -1 : INT_MIN;
  float mapq_sum = 0.0f, nm_sum = 0.0f;
  for (int base = s; base < e; base += 32) {
    const int i = base + lane;
    float q = 0.0f, x = 0.0f;
    int t = INT_MIN;
    bool f = false;
    if (i < e) {
      const int64_t o = order[i];
      q = __int2float_rn(mapq[o]);
      x = nm[o];
      f = strand[o] > 0;
      t = svtype[o];
    }
    fwd += __popc(__ballot_sync(kFull, f));
    sv = max(sv, warp_max(t));
    const int m = min(32, e - base);
    for (int j = 0; j < m; ++j) {  // in array order, term by term
      mapq_sum = __fadd_rn(mapq_sum, __shfl_sync(kFull, q, j));
      nm_sum = __fadd_rn(nm_sum, __shfl_sync(kFull, x, j));
    }
  }
  // support: the distinct reads of the (cluster, read) run
  int support = 0;
  for (int base = s; base < e; base += 32) {
    const int i = base + lane;
    const long long k = i < e ? key_read[i] : 0;
    long long prev = __shfl_up_sync(kFull, k, 1);
    if (lane == 0 && i < e && i > s) prev = key_read[i - 1];
    support += __popc(__ballot_sync(kFull, i < e && (i == s || prev != k)));
  }
  const int svlen_c = median_modes(key_len, s, e, lane);
  const int pos_c = median_modes(key_pos, s, e, lane);
  const float stdev_len = trimmed_stdev(key_len, s, cnt, lane, fused);
  const float stdev_pos = trimmed_stdev(key_pos, s, cnt, lane, fused);
  if (lane != 0) return;

  const float div = __int2float_rn(cnt);
  const int rev = cnt - fwd;
  const bool is_ins = sv == INS, is_del = sv == DEL;
  int v[kRows];
  v[kSvtype] = sv;
  v[kSvlen] = svlen_c;
  v[kPos] = is_del ? wrap_add(pos_c, svlen_c) : pos_c;
  v[kEnd] = (is_ins || is_del) ? pos_c : wrap_add(pos_c, wrap_abs(svlen_c));
  v[kRawPos] = pos_c;
  v[kPosMin] = value_of(key_pos[s]);
  v[kPosMax] = value_of(key_pos[e - 1]);
  v[kStdevPos] = __float_as_int(stdev_pos);
  v[kStdevLen] = __float_as_int(stdev_len);
  v[kSupport] = support;
  v[kLeadCount] = cnt;
  v[kQual] = to_i32(floorf(__fdiv_rn(mapq_sum, div)));
  v[kFwd] = fwd;
  v[kRev] = rev;
  v[kNm] = __float_as_int(__fdiv_rn(nm_sum, div));
  v[kNStrands] = (fwd > 0 && rev > 0) ? 2 : 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * n + c] = v[r];
}

// A resident grid over the n slots. First a thread a slot (grid-stride,
// coalesced): an empty slot gets the identities of the plain version's
// reductions (0, +0.0f, svtype -1 or INT32_MIN, pos_min INT32_MAX, pos_max
// INT32_MIN). Then a warp a live slot: warp w takes the slots w + W * k
// (W warps in the grid), 32 at a time, one load each by its lanes, and
// walks the live ones; the stride spreads the live slots, which are the
// low ids, evenly over the warps, and no warp is launched for an empty one.
__global__ void __launch_bounds__(kThreads)
call_stats_kernel(const long long* __restrict__ key_len, const long long* __restrict__ key_pos,
                  const long long* __restrict__ key_read, const int64_t* __restrict__ order,
                  const int32_t* __restrict__ mapq, const int32_t* __restrict__ strand,
                  const int32_t* __restrict__ svtype, const float* __restrict__ nm,
                  const int32_t* __restrict__ runs, const uint8_t* __restrict__ has_invalid,
                  int32_t* __restrict__ out, int n, bool fused) {
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int c = tid; c < n; c += threads) {
    if (runs[c] != runs[n + c]) continue;
    const int v[kRows] = {has_invalid[c] ? -1 : INT_MIN, 0, 0, 0, 0, INT_MAX, INT_MIN,
                          0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * n + c] = v[r];
  }
  const int warps = threads / 32, w = tid / 32, lane = tid % 32;
  for (long long base = w; base < n; base += 32LL * warps) {
    const long long mine = base + static_cast<long long>(warps) * lane;
    int s = 0, e = 0;
    if (mine < n) {
      s = runs[mine];
      e = runs[n + mine];
    }
    for (unsigned live = __ballot_sync(kFull, e > s); live; live &= live - 1) {
      const int j = __ffs(live) - 1;
      slot_stats(key_len, key_pos, key_read, order, mapq, strand, svtype, nm, has_invalid,
                 out, n, fused, static_cast<int>(base + static_cast<long long>(warps) * j),
                 __shfl_sync(kFull, s, j), __shfl_sync(kFull, e, j), lane);
    }
  }
}

}  // namespace

// The statistics of n slots: the sorted keys of the (cluster, svlen),
// (cluster, pos) and (cluster, read) sorts [n] (int64), the cid-only
// sort's masked ids [n] (int32) and permutation [n] (int64), the raw
// cluster_id, valid (bool bytes), mapq, strand, svtype (int32) and nm
// (float) [n]; scratch runs int32 [2, n] and has_invalid uint8 [n]; out
// int32 [16, n] in the rows of ops/call_stats.KEYS (float rows as bits).
// Two memsets and two launches on stream s; returns the first error.
extern "C" int call_stats(const long long* key_len, const long long* key_pos,
                          const long long* key_read, const int32_t* cid_sorted,
                          const int64_t* order, const int32_t* cluster_id, const uint8_t* valid,
                          const int32_t* mapq, const int32_t* strand, const int32_t* svtype,
                          const float* nm, int32_t* runs, uint8_t* has_invalid, int32_t* out,
                          int n, int fused, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(runs, 0, sizeof(int32_t) * 2 * static_cast<size_t>(n), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(has_invalid, 0, static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_runs<<<(n + kRunThreads - 1) / kRunThreads, kRunThreads, 0, s>>>(
      cid_sorted, cluster_id, valid, runs, has_invalid, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the resident grid: as many blocks as the card holds at once, no more
  // than the slots need
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, call_stats_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = std::max(1, std::min(sms * per_sm, (n + kThreads - 1) / kThreads));
  call_stats_kernel<<<blocks, kThreads, 0, s>>>(key_len, key_pos, key_read, order, mapq,
                                                strand, svtype, nm, runs, has_invalid, out, n,
                                                fused != 0);
  return static_cast<int>(cudaGetLastError());
}
