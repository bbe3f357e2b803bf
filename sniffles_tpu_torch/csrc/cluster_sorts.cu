// The clustering's segmented sorts on Hopper (sm_90a): each contiguous
// segment of a batch sorted stably by its own keys, on chip, and the
// columns of a stage gathered through the permutation in one launch.
//
// Replaces XLA work of the JAX package (no Pallas kernel): the lexsorts and
// the takes of every column through their permutations in _cluster_body's
// sort and seed (sniffles_tpu/ops/clustering.py:641, steps 1-2) and resplit
// (step 4, :764-798), merge_inner_fold (:806), resplit_child_ids (:880) and
// phase_tallies (:1173). Every one of those sorts but the first orders its
// elements only inside segments that are already contiguous in array order
// (a cluster, a merged segment, a parent cluster, a child), and the invalid
// elements form a suffix of segments of their own, whose masked keys are all
// INT32_MAX; so jnp.lexsort((k2, k1, masked segment id)) is the permutation
// of a stable sort of each segment by (k1, k2). The first sort is one stable
// sort by an int64 (svtype, bin) key (torch.sort, outside this source), then
// this sort inside each run of equal key by the tie. ops/cluster_sorts.py
// holds the plain versions (the ops/segments.lexsort chain) and the
// wrappers; the callers are in ops/clustering.py.
//
// seg_sort: the permutation `perm` with perm[x] = B(h + i_r) for the r-th
// position x = h + r of the segment [h, h + cnt), where i_r is the offset of
// the segment's r-th smallest element by (k1, k2, offset): ties keep array
// order, so any sort of these distinct keys gives the stable permutation.
// B(y) is base[y] where a base permutation is given (the element at
// position y is original element base[y], whose keys are k1[base[y]],
// k2[base[y]]), else y. A key is the int64 (k1, k2) with each half's sign
// bit flipped, so an unsigned compare orders signed int32 pairs; the keys
// INT32_MIN and INT32_MAX are keys like any other. An element marked alone
// (read through base) is a segment of its own, and the one after it starts
// a segment: the callers mark their invalid suffix so, which the lexsort
// leaves in place, and which one block would otherwise have to walk as one
// large segment.
//   * seg_runs, a thread an element, a warp 32 consecutive elements: the
//     segment heads (seg_start, element 0, the elements alone and the ones
//     after them) by a ballot; a head's end is
//     the next head in the warp's ballot or, for the warp's last head, the
//     first head of the windows of 32 after it that the warp loads, up to
//     kWarpMax past the head (a segment past it is known only as large).
//     A segment of at most kTinyMax elements is sorted by its head's thread
//     in registers (each element's rank by compares with the others); a
//     larger one's head (and count) is appended to the warp list, from the
//     list's front, or past kWarpMax to the block list, from its back (a
//     warp's appends by one atomic each).
//   * seg_tiers, tier 0: a resident grid, a warp a warp-list segment: up to
//     64 elements, two a lane, each ranked by shuffles and compares; more,
//     its keys and offsets in the warp's slice of dynamic shared memory;
//     tier 1: a block a block-list segment, which first finds its end (a
//     block-wide search for the next head, 2,048 elements a step), its keys
//     in dynamic shared memory up to kBlockMax elements and in a global
//     scratch buffer at the segment's own range past it. Both check first
//     whether the keys are in order already (the invalid suffix, whose keys
//     are all INT32_MAX, and presorted runs are): then the identity. Else a
//     bitonic network with every comparator ascending (the first step of
//     each merge compares mirrored elements), padded to a power of two by
//     virtual +inf elements (a comparator whose upper element lies past cnt
//     keeps the padding in place and is skipped).
// No host synchronisation and no cap on a segment's size: the tiers read
// their list counts on the card.
//
// seg_marks: a stage's per-element predicate in one pass over its sorted
// columns, in place of its chain of torch launches: the seeds of sort and
// seed (the bins and the seed boundaries), the resplit's splits, the inner
// fold's merge flags (each kind's plain version: ops/cluster_sorts.py).
//
// seg_gather: out_c[x] = col_c[order[x]] for up to kMaxCols columns of 1, 4
// or 8 bytes an element (bool, int32, float32 as bits, int64), a row of
// blocks a column (kGatherBlocks an SM), each thread kGatherUnroll
// elements an iteration, the column pointers in the kernel's parameters.
//
// Bound: bytes. seg_sort must read seg_start (1 byte), k1 (4), k2 (4 where
// given) and the base permutation (8 where given) and write the int64
// permutation (8) an element; the compares (a comparison sort's
// cnt * log2(cnt) a segment) are below the card's integer rate. seg_gather
// must read the permutation (8) and each column's element and write it (2
// times its size). The random reads through a permutation are the cost:
// each touches a 32-byte sector for 1 to 8 useful bytes, unless the
// permutation is near the identity, as it is inside small segments.
// seg_marks must read its columns once and write its outputs once (each
// element also reads its predecessor's, from the same cache lines).

#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#if !defined(SORT_TINY_MAX) || !defined(SORT_WARP_MAX) || !defined(SORT_BLOCK_MAX)
#error "build with the tier thresholds of ops/cluster_sorts.py (its nvcc_defines)"
#endif

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;       // seg_runs' and seg_gather's blocks
constexpr int kTierThreads = 512;   // seg_tiers' blocks (16 warps, or a block a segment)
constexpr int kTinyCap = 8;         // the most elements a thread sorts in registers
constexpr int kTinyMax = SORT_TINY_MAX;    // the thread tier's largest segment
constexpr int kWarpMax = SORT_WARP_MAX;    // the warp tier's largest segment
constexpr int kBlockMax = SORT_BLOCK_MAX;  // a block's largest segment in shared memory
static_assert(kTinyMax >= 1 && kTinyMax <= kTinyCap, "a thread sorts 1 to kTinyCap");
static_assert(kWarpMax >= kTinyMax && kBlockMax >= kWarpMax, "the tiers ascend");
constexpr int kMaxCols = 32;        // columns a seg_gather launch takes
constexpr int kSearchStep = 4;      // elements a thread tests a step of a block's end search
constexpr int kGatherUnroll = 4;    // elements a seg_gather thread takes an iteration
constexpr int kGatherBlocks = 4;    // seg_gather's blocks an SM, a column
constexpr unsigned kFull = 0xffffffffu;

// a sort's inputs and output (k2, base and alone may be null)
struct Sort {
  const uint8_t* seg_start;
  const int32_t* k1;
  const int32_t* k2;
  const int64_t* base;
  const uint8_t* alone;
  int64_t* perm;
  int n;
};

// the original element at position x
__device__ __forceinline__ int64_t src_of(const Sort& a, int x) {
  return a.base ? a.base[x] : static_cast<int64_t>(x);
}

// the (k1, k2) key of original element src, ordered as signed int32 pairs
__device__ __forceinline__ u64 key_of(const Sort& a, int64_t src) {
  const unsigned hi = static_cast<unsigned>(a.k1[src]) ^ 0x80000000u;
  const unsigned lo = a.k2 ? static_cast<unsigned>(a.k2[src]) ^ 0x80000000u : 0u;
  return (static_cast<u64>(hi) << 32) | lo;
}

// (ka, ia) sorts before (kb, ib): the key, then the offset
__device__ __forceinline__ bool before(u64 ka, int ia, u64 kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// an element left where it is, a segment of its own (alone, read through base)
__device__ __forceinline__ bool is_alone(const Sort& a, int x) {
  return a.alone && a.alone[src_of(a, x)] != 0;
}

// x starts a segment: element 0, a set seg_start, an element left alone
// and the one after it
__device__ __forceinline__ bool is_head(const Sort& a, int x) {
  return x == 0 || a.seg_start[x] != 0 || is_alone(a, x) || is_alone(a, x - 1);
}

// the segment [h, h + cnt), 2 <= cnt <= kTinyCap, by one thread: every
// element's rank among the others, in registers
__device__ void tiny_sort(const Sort& a, int h, int cnt) {
  int64_t src[kTinyCap];
  u64 key[kTinyCap];
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) src[j] = j < cnt ? src_of(a, h + j) : 0;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) key[j] = j < cnt ? key_of(a, src[j]) : 0;
#pragma unroll
  for (int j = 0; j < kTinyCap; ++j) {
    if (j < cnt) {
      int r = 0;
#pragma unroll
      for (int i = 0; i < kTinyCap; ++i) r += i < cnt && i != j && before(key[i], i, key[j], j);
      a.perm[h + r] = src[j];
    }
  }
}

// The bitonic sort of (K[x], I[x]), x < cnt, by `threads` threads (a warp,
// or a block when kBlock): every comparator ascending, the first step of a
// merge of width k pairing mirrored elements, the later ones elements j
// apart; virtual +inf padding past cnt.
template <bool kBlock>
__device__ void bitonic(u64* K, int* I, int cnt, int tid, int threads) {
  int p = 1;
  while (p < cnt) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < (p >> 1); t += threads) {
        const int q = t & (j - 1), head = 2 * (t - q), lo = head + q;
        const int hi = j == (k >> 1) ? head + 2 * j - 1 - q : lo + j;
        if (hi < cnt) {
          const u64 kl = K[lo], kh = K[hi];
          const int il = I[lo], ih = I[hi];
          if (before(kh, ih, kl, il)) {
            K[lo] = kh;
            K[hi] = kl;
            I[lo] = ih;
            I[hi] = il;
          }
        }
      }
      if (kBlock) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
}

// A run pass (see the file's note): the heads, each segment's count where
// it is at most kWarpMax past its head, the thread tier, and the two lists
// (an entry: head, count, or -1 for a block-list segment of unknown count).
__global__ void __launch_bounds__(kThreads)
seg_runs(Sort a, int2* __restrict__ lists, int32_t* __restrict__ counts) {
  const int n = a.n;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int i0 = i - lane;
  if (i0 >= n) return;  // the whole warp
  const bool head = i < n && is_head(a, i);
  const unsigned m = __ballot_sync(kFull, head);
  if (m == 0) return;  // the whole warp: no segment starts here
  // the warp's last segment: the next head after it, searched by the warp
  // window by window up to kWarpMax past its head (-1: not found so far)
  const int h_last = i0 + 31 - __clz(m);
  int next = -1;
  for (int b = i0 + 32;; b += 32) {
    if (b >= n) {
      next = n;
      break;
    }
    if (b > h_last + kWarpMax) break;
    const int x = b + lane;
    const unsigned hit = __ballot_sync(kFull, x < n && is_head(a, x));
    if (hit) {
      next = b + __ffs(hit) - 1;
      break;
    }
  }
  int cnt = 0;
  bool big = false;
  if (head) {
    const unsigned above = m & ~((2u << lane) - 1u);  // the heads after this lane's
    if (above) {
      cnt = __ffs(above) - 1 - lane;
    } else if (next >= 0) {
      cnt = next - i;
    } else {
      big = true;
    }
  }
  const bool to_warp = head && !big && cnt > kTinyMax && cnt <= kWarpMax;
  const bool to_block = head && (big || cnt > kWarpMax);
  const unsigned mw = __ballot_sync(kFull, to_warp), mb = __ballot_sync(kFull, to_block);
  const unsigned below = (1u << lane) - 1u;
  int at_w = 0, at_b = 0;
  if (lane == 0 && mw) at_w = atomicAdd(&counts[0], __popc(mw));
  if (lane == 0 && mb) at_b = atomicAdd(&counts[1], __popc(mb));
  at_w = __shfl_sync(kFull, at_w, 0);
  at_b = __shfl_sync(kFull, at_b, 0);
  if (to_warp) lists[at_w + __popc(mw & below)] = make_int2(i, cnt);
  if (to_block) lists[n - 1 - (at_b + __popc(mb & below))] = make_int2(i, big ? -1 : cnt);
  if (head && !big && cnt <= kTinyMax) {
    if (cnt == 1) {
      a.perm[i] = src_of(a, i);
    } else {
      tiny_sort(a, i, cnt);
    }
  }
}

// a warp's segment [h, h + cnt): up to 64 elements in two registers a lane
// (elements lane and lane + 32), each ranked against the others by
// shuffles; more, their keys and offsets in K and I (the warp's slice of
// shared memory), the identity if they are in order, else the bitonic
// network
__device__ void warp_segment(const Sort& a, int h, int cnt, u64* K, int* I, int lane) {
  if (cnt <= 64) {
    const int i1 = lane + 32;
    const int64_t s0 = lane < cnt ? src_of(a, h + lane) : 0;
    const int64_t s1 = i1 < cnt ? src_of(a, h + i1) : 0;
    const u64 k0 = lane < cnt ? key_of(a, s0) : 0;
    const u64 k1 = i1 < cnt ? key_of(a, s1) : 0;
    int r0 = 0, r1 = 0;
    for (int j = 0; j < min(cnt, 32); ++j) {
      const u64 kj = __shfl_sync(kFull, k0, j);
      r0 += before(kj, j, k0, lane);
      r1 += before(kj, j, k1, i1);
    }
    for (int j = 32; j < cnt; ++j) {
      const u64 kj = __shfl_sync(kFull, k1, j - 32);
      r0 += before(kj, j, k0, lane);
      r1 += before(kj, j, k1, i1);
    }
    if (lane < cnt) a.perm[h + r0] = s0;
    if (i1 < cnt) a.perm[h + r1] = s1;
    return;
  }
  for (int x = lane; x < cnt; x += 32) {
    K[x] = key_of(a, src_of(a, h + x));
    I[x] = x;
  }
  __syncwarp();
  bool down = false;
  for (int x = lane; x + 1 < cnt; x += 32) down |= K[x + 1] < K[x];
  if (__any_sync(kFull, down)) bitonic<false>(K, I, cnt, lane, 32);
  for (int x = lane; x < cnt; x += 32) a.perm[h + x] = src_of(a, h + I[x]);
  __syncwarp();  // the slice is read before the next segment writes it
}

// the count of the block-list segment at h, which has no head in
// (h, h + kWarpMax]: the next head (or n) less h, found by the block
__device__ int block_count(const Sort& a, int h, int* found) {
  if (threadIdx.x == 0) *found = a.n;
  __syncthreads();
  for (int b = h + kWarpMax + 1; b < a.n; b += kSearchStep * blockDim.x) {
    bool hit = false;
#pragma unroll
    for (int r = 0; r < kSearchStep; ++r) {
      const int x = b + r * blockDim.x + threadIdx.x;
      if (x < a.n && is_head(a, x)) {
        atomicMin(found, x);
        hit = true;
      }
    }
    if (__syncthreads_or(hit)) break;  // a barrier: every atomicMin is seen after it
  }
  const int cnt = *found - h;
  __syncthreads();  // read before the next segment sets it
  return cnt;
}

// a block's segment [h, h + cnt) with its keys and offsets at K and I
// (shared memory or the global scratch at the segment's range)
__device__ void block_segment(const Sort& a, int h, int cnt, u64* K, int* I) {
  for (int x = threadIdx.x; x < cnt; x += blockDim.x) {
    K[x] = key_of(a, src_of(a, h + x));
    I[x] = x;
  }
  __syncthreads();
  bool down = false;
  for (int x = threadIdx.x; x + 1 < cnt; x += blockDim.x) down |= K[x + 1] < K[x];
  if (__syncthreads_or(down)) bitonic<true>(K, I, cnt, threadIdx.x, blockDim.x);
  for (int x = threadIdx.x; x < cnt; x += blockDim.x) a.perm[h + x] = src_of(a, h + I[x]);
  __syncthreads();  // K and I are read before the next segment writes them
}

// tier 0: a resident grid, a warp a warp-list segment, each warp's slice of
// kWarpMax keys and offsets in the dynamic shared memory; tier 1: a block a
// block-list segment, in the dynamic shared memory (kBlockMax keys and
// offsets) or past it in the scratch buffers at its range
__global__ void __launch_bounds__(kTierThreads)
seg_tiers(Sort a, const int2* __restrict__ lists, const int32_t* __restrict__ counts,
          u64* scratch_k, int32_t* scratch_i, int tier) {
  extern __shared__ u64 smem[];
  if (tier == 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, per_block = blockDim.x >> 5;
    u64* K = smem + static_cast<size_t>(warp) * kWarpMax;
    int* I = reinterpret_cast<int*>(smem + static_cast<size_t>(per_block) * kWarpMax) +
             static_cast<size_t>(warp) * kWarpMax;
    const int total = counts[0];
    for (int w = blockIdx.x * per_block + warp; w < total; w += gridDim.x * per_block) {
      const int2 e = lists[w];
      warp_segment(a, e.x, e.y, K, I, lane);
    }
    return;
  }
  __shared__ int found;
  const int total = counts[1];
  for (int b = blockIdx.x; b < total; b += gridDim.x) {
    const int2 e = lists[a.n - 1 - b];
    const int h = e.x;
    const int cnt = e.y >= 0 ? e.y : block_count(a, h, &found);
    if (cnt <= kBlockMax) {
      block_segment(a, h, cnt, smem, reinterpret_cast<int*>(smem + kBlockMax));
    } else {
      block_segment(a, h, cnt, scratch_k + h, scratch_i + h);
    }
  }
}

// a launch's columns: pointers and element sizes (1, 4 or 8 bytes)
struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int size[kMaxCols];
  int count;
};

// out_c[x] = col_c[order[x]] for the column of blockIdx.y: a grid-stride
// loop of kGatherUnroll elements a thread an iteration, their loads issued
// before their stores. The blocks start in order of the column, so the
// random reads of one or two columns at a time share the L2 cache (on the
// H100, a thread that took every column of its element held them all at
// once: 0.29 ms for the engine's ten columns at 2^21, against 0.24 ms for
// ten takes); each block takes many elements (a block of 256 elements a
// column spent more time starting blocks than reading: 0.84 ms). The
// column's pointer is read from the parameters by an unrolled select.
template <typename T>
__device__ __forceinline__ void gather_column(const int64_t* __restrict__ order,
                                              const T* __restrict__ src, T* __restrict__ dst,
                                              int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int x0 = blockIdx.x * blockDim.x + threadIdx.x; x0 < n; x0 += kGatherUnroll * stride) {
    T v[kGatherUnroll];
#pragma unroll
    for (int r = 0; r < kGatherUnroll; ++r) {
      const int x = x0 + r * stride;
      if (x < n) v[r] = src[order[x]];
    }
#pragma unroll
    for (int r = 0; r < kGatherUnroll; ++r) {
      const int x = x0 + r * stride;
      if (x < n) dst[x] = v[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
seg_gather(const int64_t* __restrict__ order, Cols c, int n) {
  const void* src = nullptr;
  void* dst = nullptr;
  int size = 0;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j == static_cast<int>(blockIdx.y)) {
      src = c.src[j];
      dst = c.dst[j];
      size = c.size[j];
    }
  }
  if (size == 4) {
    gather_column(order, static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), n);
  } else if (size == 1) {
    gather_column(order, static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n);
  } else {
    gather_column(order, static_cast<const int64_t*>(src), static_cast<int64_t*>(dst), n);
  }
}

// ---- seg_marks: a stage's per-element predicate in one pass --------------

// what seg_marks computes (ops/cluster_sorts.py MARK_KINDS)
enum MarkKind { kSeeds = 0, kResplit = 1, kFold = 2 };
constexpr int kIns = 0, kDel = 1, kBnd = 4;  // svtype codes (ops/_call_consts.py)

// a seg_marks launch: int32 columns c, bool columns b, float32 scalars on
// the card f, the outputs, an int argument (binsize, cluster_merge_pos)
struct Marks {
  const int32_t* c[8];
  const uint8_t* b[2];
  const float* f[2];
  int32_t* out_i;
  uint8_t* out_b;
  int iarg, n, kind;
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// int32 abs as torch's: INT32_MIN stays INT32_MIN
__device__ __forceinline__ int wrap_abs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

// floor division, as torch.div(rounding_mode="floor") on int32
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// torch.maximum on float32: NaN where either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

// A thread an element of the stage's columns (each stage's plain version in
// ops/cluster_sorts.py says what it computes; element 0's predecessor is
// itself):
//   * kSeeds, sort and seed after its gather: bin = pos // binsize, and the
//     seed boundary (element 0, a svtype or bin change, the first invalid);
//   * kResplit, the resplit after its gather: the split (element 0, a new
//     merged segment, or a float32 gap |bin - prev| above max(minsvlen,
//     min(bin, prev) * cluster_merge_len) outside BND: one __fmul_rn, as
//     torch rounds it, no contraction);
//   * kFold, the inner fold's merge flag after its gather: same cluster and
//     read as the predecessor, both valid, INS or DEL, and the cluster in a
//     repeat or near (int32 differences that wrap, within
//     cluster_merge_pos) with the same strand; never element 0.
__global__ void __launch_bounds__(kThreads) seg_marks(Marks m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m.n) return;
  const int p = i > 0 ? i - 1 : 0;
  if (m.kind == kSeeds) {
    const int bin = floor_div(m.c[1][i], m.iarg), bin_p = floor_div(m.c[1][p], m.iarg);
    m.out_i[i] = bin;
    m.out_b[i] = i == 0 || m.c[0][i] != m.c[0][p] || bin != bin_p ||
                 (!m.b[0][i] && m.b[0][p]);
  } else if (m.kind == kResplit) {
    const int seg = m.c[0][i], seg_p = i > 0 ? m.c[0][p] : wrap_sub(seg, 1);
    const int bin = m.c[1][i], bin_p = m.c[1][p];
    const float gap = __int2float_rn(wrap_abs(wrap_sub(bin, bin_p)));
    const float thr = max_nan(*m.f[0], __fmul_rn(__int2float_rn(min(bin, bin_p)), *m.f[1]));
    m.out_b[i] = i == 0 || seg != seg_p || (gap > thr && m.c[2][i] != kBnd);
  } else {
    const int t = m.iarg;
    const int pos = m.c[2][i], qs = m.c[4][i], sv = m.c[7][i];
    const bool same_key = m.b[0][i] && m.b[0][p] && m.c[0][i] == m.c[0][p] &&
                          m.c[1][i] == m.c[1][p];
    const bool near = (wrap_abs(wrap_sub(pos, m.c[3][p])) < t ||
                       wrap_abs(wrap_sub(pos, m.c[2][p])) < t) &&
                      (wrap_abs(wrap_sub(qs, m.c[5][p])) < t ||
                       wrap_abs(wrap_sub(qs, m.c[4][p])) < t);
    m.out_b[i] = i > 0 && same_key && (sv == kIns || sv == kDel) &&
                 (m.b[1][i] || (near && m.c[6][i] == m.c[6][p]));
  }
}

// the dynamic shared memory of a seg_tiers block: tier 0, 16 warps' slices
// of kWarpMax keys and offsets; tier 1, kBlockMax of them
constexpr size_t kWarpSmem =
    (sizeof(u64) + sizeof(int)) * static_cast<size_t>(kWarpMax) * (kTierThreads / 32);
constexpr size_t kBlockSmem = (sizeof(u64) + sizeof(int)) * static_cast<size_t>(kBlockMax);
constexpr size_t kTierSmem = kWarpSmem > kBlockSmem ? kWarpSmem : kBlockSmem;

// What the launches on one device need: its SMs and the seg_tiers blocks one
// SM holds at once in each tier, after the shared memory attribute is set;
// cached by device (the queries cost host time on every call otherwise).
struct Config {
  int dev = -1, sms = 0, warp_blocks = 0, block_blocks = 0;
};

cudaError_t make_config(int dev, Config* c) {
  cudaError_t err = cudaFuncSetAttribute(seg_tiers, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTierSmem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->warp_blocks, seg_tiers, kTierThreads,
                                                        kWarpSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->block_blocks, seg_tiers,
                                                        kTierThreads, kBlockSmem);
  if (err != cudaSuccess) return err;
  if (c->warp_blocks < 1 || c->block_blocks < 1) return cudaErrorInvalidConfiguration;
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

// a resident grid: `per_sm` blocks on each SM, at least one, no more than `most`
int grid(int sms, int per_sm, long long most) {
  const long long g = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(most < 1 ? 1 : (g < most ? g : most));
}

// records event i on s where events are given (a timing tool's; null otherwise)
cudaError_t mark(cudaEvent_t const* events, int i, cudaStream_t s) {
  return events ? cudaEventRecord(events[i], s) : cudaSuccess;
}

int launch_sort(const Sort& a, int32_t* lists, int32_t* counts, u64* scratch_k,
                int32_t* scratch_i, cudaEvent_t const* events, cudaStream_t s) {
  Config cfg;
  cudaError_t err = config_for(&cfg);
  if (err == cudaSuccess) err = mark(events, 0, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int2* entries = reinterpret_cast<int2*>(lists);
  seg_runs<<<(a.n + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, entries, counts);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(events, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most n / (kTinyMax + 1) segments reach the warp list, n / (kWarpMax + 1) the block list
  const long long warp_segments = a.n / (kTinyMax + 1);
  seg_tiers<<<grid(cfg.sms, cfg.warp_blocks, (warp_segments + 15) / 16), kTierThreads,
              kWarpSmem, s>>>(a, entries, counts, scratch_k, scratch_i, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_tiers<<<grid(cfg.sms, cfg.block_blocks, a.n / (kWarpMax + 1)), kTierThreads, kBlockSmem,
              s>>>(a, entries, counts, scratch_k, scratch_i, 1);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(events, 2, s);
  return static_cast<int>(err);
}

}  // namespace

// The permutation of a stable sort of each contiguous segment of n elements
// by (k1, k2): seg_start uint8 [n] (nonzero at a segment's head; element 0
// is a head), k1 int32 [n], k2 int32 [n] or null, base int64 [n] or null
// (keys read through it, output composed with it: see the file's note),
// alone uint8 [n] or null (read through base: a nonzero element stays where
// it is, a segment of its own, and the element after it starts one);
// perm int64 [n]; scratch: lists int32 [2n] (8-byte aligned), counts int32
// [2], scratch_k uint64 [n] and scratch_i int32 [n] (a segment past
// kBlockMax); events: null, or three CUDA events recorded before the
// memset, after the run pass and after the tiers (a timing tool's). A memset
// and three launches on stream s; returns the first error (a shared memory
// size the card refuses included).
extern "C" int seg_sort(const uint8_t* seg_start, const int32_t* k1, const int32_t* k2,
                        const int64_t* base, const uint8_t* alone, int64_t* perm,
                        int32_t* lists, int32_t* counts, uint64_t* scratch_k,
                        int32_t* scratch_i, int n, cudaEvent_t const* events,
                        cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_sort(Sort{seg_start, k1, k2, base, alone, perm, n}, lists, counts,
                              reinterpret_cast<u64*>(scratch_k), scratch_i, events, s);
  // a refused attribute, memset or occupancy query leaves its error behind as
  // the last error; clear it, so that it is not read after a later launch
  if (err != 0) cudaGetLastError();
  return err;
}

// dst[c][x] = src[c][order[x]] for x < n and each of ncols columns of
// sizes[c] bytes an element (1, 4 or 8): one launch for every kMaxCols
// columns, on stream s; returns the first error.
extern "C" int gather_columns(const int64_t* order, const void* const* src, void* const* dst,
                              const int32_t* sizes, int ncols, int n, cudaStream_t s) {
  if (n <= 0 || ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Config cfg;
  const cudaError_t cfg_err = config_for(&cfg);
  if (cfg_err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(cfg_err);
  }
  const long long chunk = static_cast<long long>(kThreads) * kGatherUnroll;
  const int blocks = grid(cfg.sms, kGatherBlocks, (n + chunk - 1) / chunk);
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Cols c{};
    c.count = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int j = 0; j < c.count; ++j) {
      const int size = sizes[c0 + j];
      if (size != 1 && size != 4 && size != 8) return static_cast<int>(cudaErrorInvalidValue);
      c.src[j] = src[c0 + j];
      c.dst[j] = dst[c0 + j];
      c.size[j] = size;
    }
    seg_gather<<<dim3(blocks, c.count), kThreads, 0, s>>>(order, c, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// A stage's per-element predicate over n elements (seg_marks; kind and
// columns as its Marks): cols int32 [8] pointers, bools uint8 [2]
// pointers, f0 and f1 float32 scalars on the card, out_i int32 [n], out_b
// uint8 [n] (either may be null where the kind writes none), iarg. One
// launch on stream s; returns its error.
extern "C" int stage_marks(int kind, const int32_t* const* cols, const uint8_t* const* bools,
                           const float* f0, const float* f1, int32_t* out_i, uint8_t* out_b,
                           int iarg, int n, cudaStream_t s) {
  if (n <= 0 || kind < kSeeds || kind > kFold) return static_cast<int>(cudaErrorInvalidValue);
  Marks m{};
  for (int j = 0; j < 8; ++j) m.c[j] = cols[j];
  for (int j = 0; j < 2; ++j) m.b[j] = bools[j];
  m.f[0] = f0;
  m.f[1] = f1;
  m.out_i = out_i;
  m.out_b = out_b;
  m.iarg = iarg;
  m.n = n;
  m.kind = kind;
  seg_marks<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(m);
  return static_cast<int>(cudaGetLastError());
}
