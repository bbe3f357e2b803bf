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
//   * seg_runs, a block a tile of kTile consecutive elements, a thread 16
//     of them read as 16-byte vectors (seg_start, and alone where no base
//     is given; where alone is read through base, a warp reads its 512
//     elements' base entries coalesced and alone through them, all issued
//     before the first use, and ballots make the words): the block builds
//     the tile's head bitmask in shared memory (seg_start, element 0, the
//     elements alone and the ones after them), each element's head tested
//     once, alone[x - 1] taken from the neighbouring element, with a halo
//     of kWarpMax + 1 elements past the tile's end (tested there) and the
//     one element before it. A head's
//     count is the distance to the next set bit, exact where it lies at
//     most kWarpMax past the head (at most kWarpMax / 32 + 1 words of the
//     bitmask; the position n counts as a head), else unknown (-1). A
//     segment of at most kTinyMax elements is sorted by its head's thread in
//     registers (each element's rank by compares with the others); a larger
//     one's head and count is appended to the warp list, from the list's
//     front, or past kWarpMax to the block list, from its back: the block
//     prefix-sums its threads' appends and makes one atomic a list.
//   * seg_tiers, one resident launch. The warp tier: a warp takes up to 32
//     consecutive warp-list entries in one load (fewer where the list is
//     short, so that every resident warp has a group), compacts those of at
//     most 32 elements and those of 33-64, prefix-sums the small ones'
//     counts by shuffles, and deals them to its lanes: a pass takes as many
//     consecutive small segments as fit in 32 lanes, one element a lane,
//     each lane ranking its element by shuffles and compares against its
//     own segment's lanes (the loop runs to the pass's largest segment); a
//     segment of 33-64 is a pass of its own, two elements a lane. The next
//     pass's base entries and keys are loaded before this pass is ranked
//     and written (two in flight). A segment of 65 or more: its keys and
//     offsets in the warp's slice of dynamic shared memory. Then the block
//     tier, in the same blocks once their warps are done: a block a
//     block-list segment, taken by an atomic cursor, which first finds its
//     end (a block-wide search for the next head, 2,048 elements a step),
//     its keys in dynamic shared memory up to kBlockMax elements and in a
//     global scratch buffer at the segment's own range past it (an empty
//     block list costs no launch). The shared-memory paths check first
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
// seg_gather: out_c[x] = col_c[order[x]] for up to kMaxCols columns of 1,
// 4 or 8 bytes an element (bool, int32, float32 as bits, int64) a launch,
// the column pointers in the kernel's parameters (__grid_constant__), right
// for any permutation: a block reads a chunk's permutation entries once, into
// shared memory as int32, then copies every column for the chunk as 16-byte
// units, the chunk shrunk on a small batch so that the grid fills every SM.
//
// Bound: bytes. seg_sort must read seg_start (1 byte), alone (1 where
// given; through base, the base entry too: 8), k1 (4), k2 (4 where given)
// and the base permutation (8 where given) and write the int64
// permutation (8) an element; the compares (a comparison sort's
// cnt * log2(cnt) a segment) are below the card's integer rate. The gather
// must read the permutation (8) and each column's element and write it (2
// times its size). The random reads through a permutation are the cost:
// each touches a 32-byte sector for 1 to 8 useful bytes, unless the
// permutation is near the identity, as it is inside small segments (every
// stage's but sort and seed's).
// seg_marks must read its columns once and write its outputs once (each
// element also reads its predecessor's, from the same cache lines).

#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#if !defined(SORT_TINY_MAX) || !defined(SORT_WARP_MAX) || !defined(SORT_BLOCK_MAX) || \
    !defined(SORT_RUN_TILE)
#error "build with the tier thresholds and the tile of ops/cluster_sorts.py (its nvcc_defines)"
#endif

// A timing tool's variant of the run pass (tools/time_cluster_sorts.py
// --split): -DSORT_RUN_PARTS=k stops seg_runs after its k-th part (1: the
// heads, 2: each head's next head, 3: the lists' appends, 4: the thread
// tier, the whole pass and the default), so that the differences of their
// times split the pass. A variant's permutation is not complete: only a
// timing tool builds one.
#ifndef SORT_RUN_PARTS
#define SORT_RUN_PARTS 4
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
constexpr int kTile = SORT_RUN_TILE;       // seg_runs' elements a block
constexpr int kPer = kTile / kThreads;     // a seg_runs thread's: one 16-byte vector
static_assert(kPer == 16 && kPer * kThreads == kTile, "a run-pass thread takes 16 elements");
constexpr int kHalo = kWarpMax + 1;        // the elements past a tile whose heads it tests
constexpr int kTileWords = kTile / 32;     // the head bitmask's words: the tile's,
constexpr int kHeadWords = (kTile + kHalo + 31) / 32;  // and the halo's after them
constexpr int kMaxCols = 32;        // columns a gather launch takes
constexpr int kSearchStep = 4;      // elements a thread tests a step of a block's end search
constexpr int kChunk = 2048;        // the most output positions a seg_gather block takes at a time
constexpr int kChunkBlocks = 8;     // seg_gather's blocks an SM
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRunParts = SORT_RUN_PARTS;
static_assert(kRunParts >= 1 && kRunParts <= 4, "the run pass has four parts");

// v computed, in a variant that stops before its use (an empty asm that reads it)
__device__ __forceinline__ void keep(unsigned v) { asm volatile("" ::"r"(v)); }

// The warp tier's time by phase, in a build with -DSORT_PHASE_CLOCKS only
// (tools/time_cluster_sorts.py --split): each warp sums the clock64() cycles
// between its stamps by phase (kLoads: the list entries, the base entries
// and the keys, waited for; kRanks: the ranks, or the in-order check and the
// bitonic network; kWrites: the permutation entries) and adds them to
// g_phase_clocks when it ends. Without the flag the stamps are empty and
// the file compiles to the same code.
enum Phase { kLoads = 0, kRanks = 1, kWrites = 2, kPhases = 3 };
#ifdef SORT_PHASE_CLOCKS
__device__ u64 g_phase_clocks[kPhases + 1];  // + one word that keeps the waits alive
struct PhaseClock {
  long long t;
  u64 sum[kPhases];
  u64 sink;
  __device__ void start() {
    t = clock64();
    sum[0] = sum[1] = sum[2] = sink = 0;
  }
  __device__ void stamp(int p) {
    const long long now = clock64();
    sum[p] += static_cast<u64>(now - t);
    t = now;
  }
  // an instruction that reads v, so that a stamp after it waits for v's load
  __device__ void settle(u64 v) { asm volatile("xor.b64 %0, %0, %1;" : "+l"(sink) : "l"(v)); }
  __device__ void flush(int lane) {
    if (lane != 0) return;
    for (int p = 0; p < kPhases; ++p) atomicAdd(&g_phase_clocks[p], sum[p]);
    atomicXor(&g_phase_clocks[kPhases], sink);
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void stamp(int) {}
  __device__ void settle(u64) {}
  __device__ void flush(int) {}
};
#endif

// a sort's inputs and output (k2, base and alone may be null); vec:
// seg_start, base and alone are 16-byte aligned (seg_runs' vector loads)
struct Sort {
  const uint8_t* seg_start;
  const int32_t* k1;
  const int32_t* k2;
  const int64_t* base;
  const uint8_t* alone;
  int64_t* perm;
  int n;
  bool vec;
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
template <typename K>
__device__ __forceinline__ bool before(K ka, int ia, K kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The warp tier's key of original element src: the (k1, k2) pair as key_of
// gives it (u64), or, for a sort without k2, k1 alone as 32 bits (key_of's
// high half; its low half is 0), which halves each rank step's shuffles and
// compares.
template <typename Key>
__device__ __forceinline__ Key tier_key(const Sort& a, int64_t src);
template <>
__device__ __forceinline__ u64 tier_key<u64>(const Sort& a, int64_t src) {
  return key_of(a, src);
}
template <>
__device__ __forceinline__ unsigned tier_key<unsigned>(const Sort& a, int64_t src) {
  return static_cast<unsigned>(a.k1[src]) ^ 0x80000000u;
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

// bit k: byte k of the 16 bytes v is nonzero
__device__ __forceinline__ unsigned nonzero16(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // 0x80 in each nonzero byte (no carry crosses a byte), then its 4 bits
    const unsigned t = ((((w[q] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[q]) & 0x80808080u) >> 7;
    bits |= ((t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xfu) << (4 * q);
  }
  return bits;
}

// Lane l's seg_start and alone flags of element p + stride k + l for k < K
// (false at or past lim), as bit k of seg and al: every read issued before
// the first is used (the base entries read coalesced, then alone through
// them, one random read an element).
template <int K>
__device__ __forceinline__ void lane_bits(const Sort& a, long long p, int stride, long long lim,
                                          int lane, unsigned& seg, unsigned& al) {
  int64_t src[K];
  seg = al = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long x = p + static_cast<long long>(stride) * k + lane;
    const bool in = x < lim;
    seg |= static_cast<unsigned>(in && a.seg_start[x] != 0) << k;
    src[k] = !in ? -1 : (a.base ? a.base[x] : x);
  }
  if (a.alone) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      al |= static_cast<unsigned>(src[k] >= 0 && a.alone[src[k]] != 0) << k;
  }
}

// The seg_start and alone bits (bit k: element x0 + k) of a run-pass
// thread's kPer elements, 0 past n. Where the tile is whole: without base,
// one 16-byte vector of each (where the pointers allow); with alone read
// through base, the warp's 16 words of 32 elements (lane_bits), each made
// by a ballot, each lane keeping its half word. Else an element at a time.
__device__ __forceinline__ void load_bits(const Sort& a, int x0, bool whole, int lane,
                                          unsigned& seg, unsigned& al) {
  seg = al = 0;
  if (whole && a.alone && a.base) {
    unsigned ls, la;
    lane_bits<kPer>(a, x0 - kPer * lane, 32, a.n, lane, ls, la);  // the warp's 16 words
    const int shift = kPer * (lane & 1);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const unsigned ws = __ballot_sync(kFull, (ls >> k) & 1u);
      const unsigned wa = __ballot_sync(kFull, (la >> k) & 1u);
      if (k == lane >> 1) {
        seg = (ws >> shift) & 0xffffu;
        al = (wa >> shift) & 0xffffu;
      }
    }
    return;
  }
  if (whole && a.vec) {
    seg = nonzero16(*reinterpret_cast<const uint4*>(a.seg_start + x0));
    if (a.alone) al = nonzero16(*reinterpret_cast<const uint4*>(a.alone + x0));
    return;
  }
  for (int k = 0; k < kPer; ++k) {
    const int x = x0 + k;
    if (x < a.n) {
      seg |= static_cast<unsigned>(a.seg_start[x] != 0) << k;
      al |= static_cast<unsigned>(is_alone(a, x)) << k;
    }
  }
}

// the next set bit of the head bitmask after tile offset r, if it lies at
// most kWarpMax past r, else -1 (at most kWarpMax / 32 + 1 words read)
__device__ __forceinline__ int next_head(const unsigned* heads, int r) {
  const int lim = r + kWarpMax;
  int w = (r + 1) >> 5;
  unsigned bits = heads[w] & (~0u << ((r + 1) & 31));
  while (!bits && (w + 1) * 32 <= lim) bits = heads[++w];
  const int q = bits ? w * 32 + __ffs(bits) - 1 : INT_MAX;
  return q <= lim ? q : -1;
}

// The run pass (see the file's note), a block a tile of kTile elements
// from t0, a thread kPer of them from x0: (1) the head bitmask of the
// tile and its halo in shared memory; (2) each of the thread's heads' count
// (0: more than kWarpMax, unknown); (3) the appends, one atomic a list a
// block at offsets from a block-wide prefix sum of its threads' appends;
// (4) the thread tier. An entry: head, count, or -1 for a block-list
// segment of unknown count. A SORT_RUN_PARTS variant stops after part k.
__global__ void __launch_bounds__(kThreads)
seg_runs(Sort a, int2* __restrict__ lists, int32_t* __restrict__ counts) {
  constexpr int kHaloWords = kHeadWords - kTileWords;
  __shared__ unsigned heads[kHeadWords];
  __shared__ unsigned halo_seg[kHaloWords], halo_alone[kHaloWords];
  __shared__ unsigned last_alone[kThreads / 32];  // each warp's last thread's alone bits
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int base_w, base_b;
  __shared__ bool alone_before;                    // the element before the tile
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kTile, x0 = t0 + tid * kPer;
  const int left = n - x0;  // the thread's elements before n
  if (tid == 0) alone_before = t0 > 0 && is_alone(a, t0 - 1);
  unsigned seg, al;
  load_bits(a, x0, n - t0 >= kTile, lane, seg, al);
  unsigned before = __shfl_up_sync(kFull, al, 1) >> (kPer - 1);  // alone[x0 - 1]
  if (lane == 31) last_alone[warp] = al;
  // the halo's seg_start and alone words: warp w's words w, w + 8, ...
  // (their reads issued together; words past the halo read nothing)
  {
    constexpr int kWarps = kThreads / 32, kRounds = (kHaloWords + kWarps - 1) / kWarps;
    const long long h0 = static_cast<long long>(t0) + kTile;
    const long long lim = min(static_cast<long long>(n), h0 + 32 * kHaloWords);
    unsigned ls, la;
    lane_bits<kRounds>(a, h0 + 32 * warp, 32 * kWarps, lim, lane, ls, la);
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const unsigned ws = __ballot_sync(kFull, (ls >> k) & 1u);
      const unsigned wa = __ballot_sync(kFull, (la >> k) & 1u);
      const int hw = warp + kWarps * k;
      if (lane == 0 && hw < kHaloWords) {
        halo_seg[hw] = ws;
        halo_alone[hw] = wa;
      }
    }
  }
  __syncthreads();
  if (lane == 0) before = warp ? last_alone[warp - 1] >> (kPer - 1) : alone_before;
  if (tid < kHaloWords) {
    // the halo's heads: bit k of word hw is position p + k (the position n
    // a head; none past it)
    const long long p = static_cast<long long>(t0) + kTile + 32 * tid;
    const unsigned wa = halo_alone[tid];
    const unsigned carry = tid ? halo_alone[tid - 1] >> 31 : last_alone[kThreads / 32 - 1] >> (kPer - 1);
    unsigned word = halo_seg[tid] | wa | (wa << 1) | (carry & 1u);
    if (n - p < 32) word = n < p ? 0u : (word & ((1u << (n - p)) - 1u)) | (1u << (n - p));
    heads[kTileWords + tid] = word;
  }
  // bit k: x0 + k is a head (or is n)
  unsigned h = (seg | al | (al << 1) | (before & 1u)) & 0xffffu;
  if (x0 == 0) h |= 1u;
  if (left >= 0 && left < kPer) h = (h & ((1u << left) - 1u)) | (1u << left);
  const unsigned mine = left >= kPer ? h : (left > 0 ? h & ((1u << left) - 1u) : 0u);
  const unsigned hi = __shfl_down_sync(kFull, h, 1);
  if (!(lane & 1)) heads[tid >> 1] = h | (hi << 16);
  __syncthreads();
  if (kRunParts == 1) {
    keep(h);
    return;
  }
  // the count of the thread's last head, from the bitmask (0: unknown)
  int last = 0;
  if (mine) {
    const int r = tid * kPer + 31 - __clz(mine);
    const int q = next_head(heads, r);
    last = q >= 0 ? q - r : 0;
  }
  auto count_of = [&](int k) {
    const unsigned above = h & ~((2u << k) - 1u);
    return above ? __ffs(above) - 1 - k : last;
  };
  int nw = 0, nb = 0;
  for (unsigned m = mine; m; m &= m - 1) {
    const int cnt = count_of(__ffs(m) - 1);
    nw += cnt > kTinyMax && cnt <= kWarpMax;
    nb += cnt <= 0 || cnt > kWarpMax;
  }
  if (kRunParts == 2) {
    keep(nw | (nb << 16));
    return;
  }
  // the block's appends: a prefix sum of (warp entries, block entries), a
  // pair of 16-bit halves (a tile holds at most kTile heads)
  const int pair = nw | (nb << 16);
  int incl = pair;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int at = incl - pair, total = 0;
#pragma unroll
  for (int v = 0; v < kThreads / 32; ++v) {
    at += v < warp ? warp_sum[v] : 0;
    total += warp_sum[v];
  }
  if (tid == 0) {
    base_w = (total & 0xffff) ? atomicAdd(&counts[0], total & 0xffff) : 0;
    base_b = (total >> 16) ? atomicAdd(&counts[1], total >> 16) : 0;
  }
  __syncthreads();
  int at_w = base_w + (at & 0xffff), at_b = base_b + (at >> 16);
  for (unsigned m = mine; m; m &= m - 1) {
    const int k = __ffs(m) - 1, x = x0 + k, cnt = count_of(k);
    if (cnt <= 0 || cnt > kWarpMax) {
      lists[n - 1 - at_b++] = make_int2(x, cnt > 0 ? cnt : -1);
    } else if (cnt > kTinyMax) {
      lists[at_w++] = make_int2(x, cnt);
    } else if (kRunParts == 4) {
      if (cnt == 1) {
        a.perm[x] = src_of(a, x);
      } else {
        tiny_sort(a, x, cnt);
      }
    }
  }
}

// A warp's unit of work in the warp tier: a pass of small segments (up to
// 32 elements each) packed one element a lane, or one segment of 33 to 64
// elements, two a lane (elements r and r + 32). Each lane holds its
// element's segment head h and count cnt (0: the lane has no element), the
// lane s that holds the segment's element 0, its offset r in the segment,
// the original elements and their keys; top is the largest count of the
// unit's segments (warp-uniform; 0: no unit).
template <typename Key>
struct Unit {
  int h, cnt, s, r, top;
  int64_t src0, src1;
  Key k0, k1;
};

// A warp's group of up to 32 warp-list entries (one a lane, read in one
// load), with the segments of 65 or more taken out: the small ones (up to
// 32 elements) first, then those of 33 to 64, compacted in that order to
// lanes 0 to ns + nm - 1 (e), and the small ones' counts summed by shuffles
// (incl, inclusive; excl, exclusive).
struct Group {
  int2 e;
  int ns, nm, incl, excl;
};

// The next unit of group g from entry `cursor` on (advanced past it), its
// base entries and keys loaded: a pass takes as many consecutive small
// segments as fit in 32 lanes, each lane finding its segment by the bits of
// the segments' first lanes; a segment of 33-64 is a unit of its own.
template <typename Key>
__device__ __forceinline__ Unit<Key> next_unit(const Sort& a, const Group& g, int& cursor,
                                               int lane) {
  Unit<Key> u;
  if (cursor < g.ns) {
    const int base = __shfl_sync(kFull, g.excl, cursor);
    const bool fits = lane >= cursor && lane < g.ns && g.incl - base <= 32;
    const unsigned taken = __ballot_sync(kFull, fits);  // lanes cursor to last
    const int last = 31 - __clz(taken);
    const int used = __shfl_sync(kFull, g.incl, last) - base;
    const unsigned firsts = __reduce_or_sync(kFull, fits ? 1u << (g.excl - base) : 0u);
    const unsigned upto = firsts & ((2u << lane) - 1u);  // its segment's first lane and those before
    const bool on = lane < used;
    const int from = cursor + (on ? __popc(upto) - 1 : 0);
    u.h = __shfl_sync(kFull, g.e.x, from);
    const int cnt = __shfl_sync(kFull, g.e.y, from);
    u.s = on ? 31 - __clz(upto) : 0;
    u.r = lane - u.s;
    u.cnt = on ? cnt : 0;
    u.top = __reduce_max_sync(kFull, fits ? g.e.y : 0);
    cursor = last + 1;
  } else if (cursor < g.ns + g.nm) {
    u.h = __shfl_sync(kFull, g.e.x, cursor);
    u.cnt = __shfl_sync(kFull, g.e.y, cursor);
    u.s = 0;
    u.r = lane;
    u.top = u.cnt;
    ++cursor;
  } else {
    u.h = u.cnt = u.s = u.r = u.top = 0;
  }
  u.src0 = u.r < u.cnt ? src_of(a, u.h + u.r) : 0;
  u.src1 = u.r + 32 < u.cnt ? src_of(a, u.h + u.r + 32) : 0;
  u.k0 = u.r < u.cnt ? tier_key<Key>(a, u.src0) : 0;
  u.k1 = u.r + 32 < u.cnt ? tier_key<Key>(a, u.src1) : 0;
  return u;
}

// a unit's ranks by shuffles and compares (each lane against its own
// segment's elements; the loop runs to the unit's largest segment) and its
// permutation entries
template <typename Key>
__device__ __forceinline__ void rank_unit(const Sort& a, const Unit<Key>& u, PhaseClock& clk) {
  int r0 = 0, r1 = 0;
  if (u.top <= 32) {
    for (int j = 0; j < u.top; ++j) {
      const Key kj = __shfl_sync(kFull, u.k0, (u.s + j) & 31);
      r0 += j < u.cnt && before(kj, j, u.k0, u.r);
    }
  } else {
    for (int j = 0; j < 32; ++j) {
      const Key kj = __shfl_sync(kFull, u.k0, j);
      r0 += before(kj, j, u.k0, u.r);
      r1 += before(kj, j, u.k1, u.r + 32);
    }
    for (int j = 32; j < u.top; ++j) {
      const Key kj = __shfl_sync(kFull, u.k1, j - 32);
      r0 += before(kj, j, u.k0, u.r);
      r1 += before(kj, j, u.k1, u.r + 32);
    }
  }
  clk.stamp(kRanks);
  if (u.r < u.cnt) a.perm[u.h + r0] = u.src0;
  if (u.r + 32 < u.cnt) a.perm[u.h + r1] = u.src1;
  clk.stamp(kWrites);
}

// a warp's segment [h, h + cnt) of more than 64 elements: its keys and
// offsets in K and I (the warp's slice of shared memory), the identity if
// they are in order, else the bitonic network
__device__ void warp_large(const Sort& a, int h, int cnt, u64* K, int* I, int lane,
                           PhaseClock& clk) {
  for (int x = lane; x < cnt; x += 32) {
    K[x] = key_of(a, src_of(a, h + x));
    I[x] = x;
  }
  __syncwarp();
  clk.stamp(kLoads);
  bool down = false;
  for (int x = lane; x + 1 < cnt; x += 32) down |= K[x + 1] < K[x];
  if (__any_sync(kFull, down)) bitonic<false>(K, I, cnt, lane, 32);
  clk.stamp(kRanks);
  for (int x = lane; x < cnt; x += 32) a.perm[h + x] = src_of(a, h + I[x]);
  __syncwarp();  // the slice is read before the next segment writes it
  clk.stamp(kWrites);
}

// The warp tier: a warp takes `per` consecutive list entries at a time (up
// to 32, one a lane, in one load; the next group's read before this one is
// sorted), sorts the segments of 65 or more one at a time (warp_large),
// then the others unit by unit, the next unit's base entries and keys
// loaded before this one's ranks (two units in flight). G: the warp's 32
// slots of shared memory for the compaction. Key: tier_key's.
template <typename Key>
__device__ void warp_tier(const Sort& a, const int2* __restrict__ lists, int total, int per,
                          u64* K, int* I, int2* G, int lane, int first, int stride) {
  PhaseClock clk;
  clk.start();
  const unsigned below = (1u << lane) - 1u;
  int g0 = first;
  int2 e = lane < per && g0 + lane < total ? lists[g0 + lane] : make_int2(0, 0);
  while (g0 < total) {
    const int g1 = g0 + stride;
    const int2 e1 = lane < per && g1 + lane < total ? lists[g1 + lane] : make_int2(0, 0);
    const bool large = e.y > 64, mid = e.y > 32 && !large, small = e.y > 0 && e.y <= 32;
    for (unsigned m = __ballot_sync(kFull, large); m; m &= m - 1) {
      const int l = __ffs(m) - 1;
      warp_large(a, __shfl_sync(kFull, e.x, l), __shfl_sync(kFull, e.y, l), K, I, lane, clk);
    }
    const unsigned ms = __ballot_sync(kFull, small), mm = __ballot_sync(kFull, mid);
    Group g;
    g.ns = __popc(ms);
    g.nm = __popc(mm);
    if (small) G[__popc(ms & below)] = e;
    if (mid) G[g.ns + __popc(mm & below)] = e;
    __syncwarp();
    g.e = lane < g.ns + g.nm ? G[lane] : make_int2(0, 0);
    __syncwarp();  // every lane has read G before the next group writes it
    const int c = lane < g.ns ? g.e.y : 0;
    g.incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, g.incl, d);
      if (lane >= d) g.incl += v;
    }
    g.excl = g.incl - c;
    int cursor = 0;
    Unit<Key> cur = next_unit<Key>(a, g, cursor, lane);
    clk.settle(cur.k0 ^ cur.k1);
    clk.stamp(kLoads);
    while (cur.top) {
      const Unit<Key> nxt = next_unit<Key>(a, g, cursor, lane);
      clk.settle(nxt.k0 ^ nxt.k1);
      clk.stamp(kLoads);
      rank_unit(a, cur, clk);
      cur = nxt;
    }
    g0 = g1;
    e = e1;
  }
  clk.flush(lane);
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

// One resident launch for both tiers. The warp tier: each warp's slice of
// kWarpMax keys and offsets in the dynamic shared memory, `per` entries a
// group (every resident warp a group where the list is short, 32 where it
// is long). Then the block tier, in the same blocks once their warps are
// done: each block takes the next block-list entry by an atomic cursor
// (counts[2]), its keys in the dynamic shared memory (kBlockMax keys and
// offsets) or past it in the scratch buffers at its range. An empty block
// list costs one atomic a block, and no launch.
__global__ void __launch_bounds__(kTierThreads)
seg_tiers(Sort a, const int2* __restrict__ lists, int32_t* __restrict__ counts,
          u64* scratch_k, int32_t* scratch_i) {
  extern __shared__ u64 smem[];
  __shared__ int2 groups[kTierThreads / 32][32];
  __shared__ int found, next;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, per_block = blockDim.x >> 5;
  {
    u64* K = smem + static_cast<size_t>(warp) * kWarpMax;
    int* I = reinterpret_cast<int*>(smem + static_cast<size_t>(per_block) * kWarpMax) +
             static_cast<size_t>(warp) * kWarpMax;
    const int total = counts[0], warps = gridDim.x * per_block;
    const int per = min(32, max(1, (total + warps - 1) / warps));
    const int first = (blockIdx.x * per_block + warp) * per;
    if (a.k2) {
      warp_tier<u64>(a, lists, total, per, K, I, groups[warp], lane, first, warps * per);
    } else {
      warp_tier<unsigned>(a, lists, total, per, K, I, groups[warp], lane, first, warps * per);
    }
  }
  const int total = counts[1];
  for (;;) {
    __syncthreads();  // the slices (or the last segment's keys) are read; `next` is free
    if (threadIdx.x == 0) next = total > 0 ? atomicAdd(&counts[2], 1) : total;
    __syncthreads();
    const int b = next;
    if (b >= total) return;
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

// a launch's columns: pointers and element sizes (1, 4 or 8 bytes), and a
// full chunk's 16-byte units of each (chunk * size / 16): column j's are the
// units unit[j] to unit[j + 1] - 1
struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int size[kMaxCols];
  int unit[kMaxCols + 1];
  int count, chunk;
};

// 16 bytes of V = 16 / sizeof(T) elements, as one vector store takes them
template <typename T>
__device__ __forceinline__ uint4 pack16(const T* v) {
  if constexpr (sizeof(T) == 8) {
    return make_uint4(static_cast<unsigned>(v[0]), static_cast<unsigned>(v[0] >> 32),
                      static_cast<unsigned>(v[1]), static_cast<unsigned>(v[1] >> 32));
  } else if constexpr (sizeof(T) == 4) {
    return make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = v[4 * q] | (v[4 * q + 1] << 8) | (v[4 * q + 2] << 16) |
             (static_cast<unsigned>(v[4 * q + 3]) << 24);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One 16-byte unit of a column: dst[i + v] = src[idx[i + v]] for its V =
// 16 / sizeof(T) elements, their sources read from the shared index as
// vectors, the V loads issued together, one 16-byte store (dst + i is
// 16-byte aligned).
template <typename T>
__device__ __forceinline__ void copy_unit(const void* src_, void* dst_, const int* idx, int i) {
  constexpr int V = 16 / sizeof(T);
  const T* __restrict__ src = static_cast<const T*>(src_);
  T v[V];
  if constexpr (V == 2) {
    const int2 q = *reinterpret_cast<const int2*>(idx + i);
    v[0] = src[q.x];
    v[1] = src[q.y];
  } else {
#pragma unroll
    for (int u = 0; u < V; u += 4) {
      const int4 q = *reinterpret_cast<const int4*>(idx + i + u);
      v[u] = src[q.x];
      v[u + 1] = src[q.y];
      v[u + 2] = src[q.z];
      v[u + 3] = src[q.w];
    }
  }
  *reinterpret_cast<uint4*>(static_cast<T*>(dst_) + i) = pack16(v);
}

template <typename T>
__device__ __forceinline__ void copy_one(const void* src, void* dst, int to, int from) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

// seg_gather: a resident grid, a block c.chunk consecutive output positions
// at a time (kChunk, or fewer where the batch is too small to give every SM
// kChunkBlocks blocks of kChunk: the entry point's chunk). The block reads
// the chunk's permutation entries once, into shared memory as int32, then
// its threads take the 16-byte units of all the chunk's columns at once, in
// column order, each unit's loads issued together and written as one
// coalesced 16-byte store; a partial last chunk an element a thread. The
// permutation is read once an element, not once a column. The columns'
// pointers, sizes and units are copied from the parameters to shared
// memory, where a unit's column is found by a binary search.
__global__ void __launch_bounds__(kThreads)
seg_gather(const int64_t* __restrict__ order, const __grid_constant__ Cols c, int n) {
  __shared__ __align__(16) int idx[kChunk];
  __shared__ const void* src[kMaxCols];
  __shared__ void* dst[kMaxCols];
  __shared__ int size[kMaxCols], unit[kMaxCols + 1];
  for (int j = threadIdx.x; j <= c.count; j += blockDim.x) {
    unit[j] = c.unit[j];
    if (j < c.count) {
      src[j] = c.src[j];
      dst[j] = c.dst[j];
      size[j] = c.size[j];
    }
  }
  // the chunk loop's first __syncthreads orders these writes before any read
  for (int x0 = blockIdx.x * c.chunk; x0 < n; x0 += gridDim.x * c.chunk) {
    const int m = min(c.chunk, n - x0);
    for (int i = threadIdx.x; i < m; i += blockDim.x) idx[i] = static_cast<int>(order[x0 + i]);
    __syncthreads();
    if (m == c.chunk) {
      for (int u = threadIdx.x; u < unit[c.count]; u += blockDim.x) {
        int j = 0;  // the unit's column: the last j with unit[j] <= u
#pragma unroll
        for (int step = kMaxCols / 2; step > 0; step /= 2)
          if (j + step < c.count && unit[j + step] <= u) j += step;
        const int i = (u - unit[j]) * (16 / size[j]);
        if (size[j] == 4) {
          copy_unit<uint32_t>(src[j], static_cast<uint32_t*>(dst[j]) + x0, idx, i);
        } else if (size[j] == 1) {
          copy_unit<uint8_t>(src[j], static_cast<uint8_t*>(dst[j]) + x0, idx, i);
        } else {
          copy_unit<u64>(src[j], static_cast<u64*>(dst[j]) + x0, idx, i);
        }
      }
    } else {
      for (int e = threadIdx.x; e < m * c.count; e += blockDim.x) {
        const int j = e / m, i = e - j * m;
        if (size[j] == 4) {
          copy_one<uint32_t>(src[j], dst[j], x0 + i, idx[i]);
        } else if (size[j] == 1) {
          copy_one<uint8_t>(src[j], dst[j], x0 + i, idx[i]);
        } else {
          copy_one<u64>(src[j], dst[j], x0 + i, idx[i]);
        }
      }
    }
    __syncthreads();  // idx is read before the next chunk writes it
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

// the dynamic shared memory of a seg_tiers block: 16 warps' slices of
// kWarpMax keys and offsets, or a block segment's kBlockMax of them
constexpr size_t kWarpSmem =
    (sizeof(u64) + sizeof(int)) * static_cast<size_t>(kWarpMax) * (kTierThreads / 32);
constexpr size_t kBlockSmem = (sizeof(u64) + sizeof(int)) * static_cast<size_t>(kBlockMax);
constexpr size_t kTierSmem = kWarpSmem > kBlockSmem ? kWarpSmem : kBlockSmem;

// What the launches on one device need: its SMs and the seg_tiers blocks one
// SM holds at once, after the shared memory attribute is set; cached by
// device (the queries cost host time on every call otherwise).
struct Config {
  int dev = -1, sms = 0, tier_blocks = 0;
};

cudaError_t make_config(int dev, Config* c) {
  cudaError_t err = cudaFuncSetAttribute(seg_tiers, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTierSmem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->tier_blocks, seg_tiers, kTierThreads,
                                                        kTierSmem);
  if (err != cudaSuccess) return err;
  if (c->tier_blocks < 1) return cudaErrorInvalidConfiguration;
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
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, 3 * sizeof(int32_t), s);
  if (err == cudaSuccess) err = mark(events, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int2* entries = reinterpret_cast<int2*>(lists);
  seg_runs<<<(a.n + kTile - 1) / kTile, kThreads, 0, s>>>(a, entries, counts);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(events, 2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most n / (kTinyMax + 1) segments reach the warp list (16 a block at
  // the least, when each warp takes one), n / (kWarpMax + 1) the block list
  const long long warp_blocks = (a.n / (kTinyMax + 1) + 15) / 16;
  const long long block_blocks = a.n / (kWarpMax + 1);
  seg_tiers<<<grid(cfg.sms, cfg.tier_blocks, warp_blocks > block_blocks ? warp_blocks
                                                                       : block_blocks),
              kTierThreads, kTierSmem, s>>>(a, entries, counts, scratch_k, scratch_i);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(events, 3, s);
  return static_cast<int>(err);
}

}  // namespace

#ifdef SORT_PHASE_CLOCKS
// The warp tier's cycles by phase summed over its warps since the last
// call (kPhases words to out, on the host), then zeroed; a build with
// -DSORT_PHASE_CLOCKS only. Synchronous.
extern "C" int sort_phase_clocks(uint64_t* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, kPhases * sizeof(u64));
  static const u64 zero[kPhases + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

// The permutation of a stable sort of each contiguous segment of n elements
// by (k1, k2): seg_start uint8 [n] (nonzero at a segment's head; element 0
// is a head), k1 int32 [n], k2 int32 [n] or null, base int64 [n] or null
// (keys read through it, output composed with it: see the file's note),
// alone uint8 [n] or null (read through base: a nonzero element stays where
// it is, a segment of its own, and the element after it starts one);
// perm int64 [n]; scratch: lists int32 [2n] (8-byte aligned), counts int32
// [3], scratch_k uint64 [n] and scratch_i int32 [n] (a segment past
// kBlockMax); events: null, or four CUDA events recorded before the
// memset, after it, after the run pass and after the tiers (a timing
// tool's). A
// memset and two launches on stream s; returns the first error (a shared
// memory size the card refuses included).
extern "C" int seg_sort(const uint8_t* seg_start, const int32_t* k1, const int32_t* k2,
                        const int64_t* base, const uint8_t* alone, int64_t* perm,
                        int32_t* lists, int32_t* counts, uint64_t* scratch_k,
                        int32_t* scratch_i, int n, cudaEvent_t const* events,
                        cudaStream_t s) {
  if (n <= 0 || n > INT_MAX - 2 * kTile) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = aligned(seg_start) && aligned(base) && aligned(alone);
  const int err = launch_sort(Sort{seg_start, k1, k2, base, alone, perm, n, vec}, lists, counts,
                              reinterpret_cast<u64*>(scratch_k), scratch_i, events, s);
  // a refused attribute, memset or occupancy query leaves its error behind as
  // the last error; clear it, so that it is not read after a later launch
  if (err != 0) cudaGetLastError();
  return err;
}

// dst[c][x] = src[c][order[x]] for x < n and each of ncols columns of
// sizes[c] bytes an element (1, 4 or 8; each dst 16-byte aligned): one
// seg_gather launch every kMaxCols columns on stream s; returns the first
// error.
extern "C" int gather_columns(const int64_t* order, const void* const* src, void* const* dst,
                              const int32_t* sizes, int ncols, int n, cudaStream_t s) {
  if (n <= 0 || ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Config cfg;
  const cudaError_t cfg_err = config_for(&cfg);
  if (cfg_err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(cfg_err);
  }
  // the chunk: kChunk, or on a batch too small to give every SM
  // kChunkBlocks blocks of it, n over those blocks, a multiple of 16
  const long long blocks = static_cast<long long>(cfg.sms) * kChunkBlocks;
  const long long even = ((n + blocks - 1) / blocks + 15) / 16 * 16;
  const int chunk = static_cast<int>(even < kChunk ? even : kChunk);
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Cols c{};
    c.count = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    c.chunk = chunk;
    for (int j = 0; j < c.count; ++j) {
      const int size = sizes[c0 + j];
      if ((size != 1 && size != 4 && size != 8) ||
          (reinterpret_cast<uintptr_t>(dst[c0 + j]) & 15) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      c.src[j] = src[c0 + j];
      c.dst[j] = dst[c0 + j];
      c.size[j] = size;
      c.unit[j + 1] = c.unit[j] + chunk * size / 16;
    }
    seg_gather<<<grid(cfg.sms, kChunkBlocks, (n + chunk - 1) / chunk), kThreads, 0, s>>>(
        order, c, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
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
