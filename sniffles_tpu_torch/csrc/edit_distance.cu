// Batched exact Levenshtein distance on Hopper (sm_90a): Myers/Hyyrö
// bit-vectors, one warp per string pair, eight pairs (warps) per block.
//
// Replaces the TPU kernel sniffles_tpu/ops/edit_distance_jax.py::_ed_kernel
// (called through edit_distance_batch_pallas). That kernel advances a tile
// of 128 pairs through all 2L anti-diagonal steps in lockstep, with the DP
// row index on the vector lanes. Here the DP column is a bit-vector of the
// pattern (one bit per pattern position, 32-bit words), and each text
// character updates it with a dozen int32 operations per word: the global
// (NW) form of the recurrence of native/bamcore.cc::bamcore_edit_distance_k.
//
// Design:
//   * lane l of the warp holds C = ceil(kw / 32) consecutive words of the
//     pattern (kw = ceil(m / 32) words, C <= 4 for m <= 4096); the add
//     carry and the two shift carries (ph, mh) all move from low words to
//     high ones, so the lanes form a skewed pipeline: lane l processes text
//     column j at step j + l and gets its three carries, packed into one
//     int, from lane l - 1 with one __shfl_up_sync per step. A pair takes
//     n + (active lanes - 1) steps and no block barrier. Only the steps of
//     pipeline fill and drain check each lane's window (myers_step's
//     kGuard), and there lanes outside it keep shuffling with their state
//     unchanged; in the steady state every lane computes, since lanes above
//     the pattern feed only lanes above it;
//   * the match masks are bit planes: each distinct byte of the pattern
//     gets a code of k bits (k <= 8; one spare code for text bytes that
//     are not in the pattern, when there are any), plane t holds bit t of
//     the code of every pattern position, and eq(x) is the AND over the
//     planes of (plane XNOR bit t of x): k LOP3s a word, all in registers,
//     exact for any byte values; the text is staged in shared memory as
//     codes, so neighbouring lanes read neighbouring bytes, and for k <= 3
//     the per-bit selectors of a code come from one shared-memory load;
//   * bits above the pattern's top bit only ever move upwards (shifts
//     left, add carries), so the last word needs no mask while the scan
//     runs; no score is tracked per step either: once the last column is
//     done, D(m, n) = D(0, n) + sum of its vertical deltas = n +
//     popc(pv) - popc(mv) over the m pattern bits, one warp sum;
//   * the add carry runs through a lane's words on the hardware carry
//     flag (one IADD3 with carry a word, add_chain);
//   * the wrapper hands pairs in descending order of la * lb, so that the
//     long pairs start first and the short ones fill the tail.
//
// Bound: int32 operations. Per word-column the recurrence as written costs
// 10 operations (ep, the add with carry, ph (two LOP3s), mh, two funnel
// shifts, xv, mv, pv) plus k LOP3s for eq, so at least 12 (k >= 2); the
// per-step work of a lane (text and selector loads, the ends of the carry
// chain, carry pack and unpack, shuffle, loop) comes on top, once a step
// for the lane's C words. Bytes are negligible: la + lb input bytes and 4
// output bytes per pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // pairs per block
constexpr int kMaxC = 4;           // words per lane: m <= 4096
constexpr int kCodeTable = 256;    // per-warp byte -> code table, bytes
// entries of the per-block selector table; the spare code of a pattern
// with 8 distinct bytes is 8, which lanes above the pattern may read
constexpr int kMaskTable = 16;
constexpr unsigned kFull = 0xffffffffu;

// sum = x + y + cin over C words, low word first (cin is 0 or 1); returns
// the carry out. The carry flag lives only inside one asm statement, so
// the chain is one statement: one IADD3 with carry a word.
template <int C>
__device__ __forceinline__ uint32_t add_chain(const uint32_t (&x)[C], const uint32_t (&y)[C],
                                              uint32_t cin, uint32_t (&sum)[C]) {
  uint32_t cout;
  if constexpr (C == 1) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %2, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %3, %4;\n\t"
        "addc.u32 %1, 0, 0;\n\t}"
        : "=r"(sum[0]), "=r"(cout)
        : "r"(cin), "r"(x[0]), "r"(y[0]));
  } else if constexpr (C == 2) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %3, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %4, %5;\n\t"
        "addc.cc.u32 %1, %6, %7;\n\t"
        "addc.u32 %2, 0, 0;\n\t}"
        : "=r"(sum[0]), "=r"(sum[1]), "=r"(cout)
        : "r"(cin), "r"(x[0]), "r"(y[0]), "r"(x[1]), "r"(y[1]));
  } else if constexpr (C == 3) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %4, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %5, %6;\n\t"
        "addc.cc.u32 %1, %7, %8;\n\t"
        "addc.cc.u32 %2, %9, %10;\n\t"
        "addc.u32 %3, 0, 0;\n\t}"
        : "=r"(sum[0]), "=r"(sum[1]), "=r"(sum[2]), "=r"(cout)
        : "r"(cin), "r"(x[0]), "r"(y[0]), "r"(x[1]), "r"(y[1]), "r"(x[2]), "r"(y[2]));
  } else {
    static_assert(C == 4, "at most 4 words a lane");
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %5, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %6, %7;\n\t"
        "addc.cc.u32 %1, %8, %9;\n\t"
        "addc.cc.u32 %2, %10, %11;\n\t"
        "addc.cc.u32 %3, %12, %13;\n\t"
        "addc.u32 %4, 0, 0;\n\t}"
        : "=r"(sum[0]), "=r"(sum[1]), "=r"(sum[2]), "=r"(sum[3]), "=r"(cout)
        : "r"(cin), "r"(x[0]), "r"(y[0]), "r"(x[1]), "r"(y[1]), "r"(x[2]), "r"(y[2]),
          "r"(x[3]), "r"(y[3]));
  }
  return cout;
}

// The match-mask selectors of text code x: nm[t] is 0 where bit t of x is
// set and all ones where it is clear, so plane[t] ^ nm[t] marks the
// pattern positions that agree with x in bit t. For k <= 3 they come from
// a per-block table (one 64- or 128-bit shared load), else bit by bit.
template <int KB>
__device__ __forceinline__ void text_masks(uint32_t x, const uint4* nm_table,
                                           uint32_t (&nm)[KB]) {
  if constexpr (KB == 2) {
    const uint2 e = *reinterpret_cast<const uint2*>(nm_table + x);
    nm[0] = e.x;
    nm[1] = e.y;
  } else if constexpr (KB == 3) {
    const uint4 e = nm_table[x];
    nm[0] = e.x;
    nm[1] = e.y;
    nm[2] = e.z;
  } else {
#pragma unroll
    for (int t = 0; t < KB; ++t) nm[t] = ((x >> t) & 1u) - 1u;
  }
}

// One text column on one lane: its C words against the text code whose
// selectors are nm, with the packed carries cin of lane - 1 (bit 0 add,
// bit 31 ph, bit 30 mh); returns the packed carries out.
template <int C, int KB>
__device__ __forceinline__ uint32_t myers_column(const uint32_t (&plane)[KB][C],
                                                 const uint32_t (&nm)[KB],
                                                 uint32_t (&pv)[C], uint32_t (&mv)[C],
                                                 uint32_t cin) {
  uint32_t eq[C], ep[C], sum[C];
#pragma unroll
  for (int w = 0; w < C; ++w) {
    eq[w] = plane[0][w] ^ nm[0];
#pragma unroll
    for (int t = 1; t < KB; ++t) eq[w] &= plane[t][w] ^ nm[t];
    ep[w] = eq[w] & pv[w];
  }
  const uint32_t addc = add_chain<C>(ep, pv, cin & 1u, sum);
  uint32_t ph_lo = cin;       // bit 31: ph carry-in
  uint32_t mh_lo = cin << 1;  // bit 31: mh carry-in
#pragma unroll
  for (int w = 0; w < C; ++w) {
    const uint32_t p = pv[w], v = mv[w];
    const uint32_t ph = v | ~(sum[w] | p | eq[w]);   // v | ~(xh | pv)
    const uint32_t mh = p & ((sum[w] ^ p) | eq[w]);  // pv & xh
    const uint32_t ph_sh = __funnelshift_l(ph_lo, ph, 1);
    const uint32_t mh_sh = __funnelshift_l(mh_lo, mh, 1);
    ph_lo = ph;
    mh_lo = mh;
    const uint32_t xv = eq[w] | v;
    mv[w] = ph_sh & xv;
    pv[w] = mh_sh | ~(xv | ph_sh);
  }
  return (ph_lo & 0x80000000u) | ((mh_lo >> 1) & 0x40000000u) | addc;
}

// One step s of the lane pipeline: lane l takes text column j = s - l and
// hands its carries to lane l + 1. kGuard: some lane of the pattern lies
// outside its window 0 <= j < n (pipeline fill and drain), so each lane
// checks. Without it every lane computes: lanes above the pattern only
// feed lanes above it, and their text index s - l >= -31 stays inside the
// warp's code table, which lies just below the text.
template <int C, int KB, bool kGuard>
__device__ __forceinline__ void myers_step(int s, int lane, int n, bool in_pattern,
                                           const uint32_t (&plane)[KB][C],
                                           const uint8_t* text, const uint4* nm_table,
                                           uint32_t (&pv)[C], uint32_t (&mv)[C],
                                           uint32_t& cin) {
  const int j = s - lane;
  if (lane == 0) cin = 0x80000000u;  // ph shift-in 1: D(0, j) = j
  uint32_t cout = 0u;
  if (!kGuard || (in_pattern && j >= 0 && j < n)) {
    uint32_t nm[KB];
    text_masks<KB>(text[j], nm_table, nm);
    cout = myers_column<C, KB>(plane, nm, pv, mv, cin);
  }
  cin = __shfl_up_sync(kFull, cout, 1);
}

// D(pattern, text) for one pair, on one warp. code_of maps a byte to its
// code; text holds the text's codes. Every lane returns the distance.
template <int C, int KB>
__device__ __forceinline__ int myers_warp(const uint8_t* __restrict__ pat, int m,
                                          const uint8_t* code_of, const uint8_t* text,
                                          int n, const uint4* nm_table, int lane) {
  const int kw = (m + 31) >> 5;

  // bit planes of the pattern's codes, lane l owns words l*C .. l*C + C-1
  uint32_t plane[KB][C];
#pragma unroll
  for (int t = 0; t < KB; ++t)
#pragma unroll
    for (int w = 0; w < C; ++w) plane[t][w] = 0u;
  for (int g = 0; g < kw; ++g) {
    const int pos = (g << 5) + lane;
    const uint32_t code = pos < m ? code_of[pat[pos]] : 0u;
    const int w_own = g - lane * C;  // in [0, C) on the owning lane only
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      const uint32_t bits = __ballot_sync(kFull, (code >> t) & 1u);
#pragma unroll
      for (int w = 0; w < C; ++w)
        if (w_own == w) plane[t][w] = bits;
    }
  }

  uint32_t pv[C], mv[C];
#pragma unroll
  for (int w = 0; w < C; ++w) {
    pv[w] = ~0u;
    mv[w] = 0u;
  }
  const int lanes = (kw + C - 1) / C;
  const bool in_pattern = lane < lanes;
  uint32_t cin = 0u;
  // steps [lanes - 1, n) find every lane of the pattern inside its window
  const int steps = n + lanes - 1;
  const int fill_end = min(lanes - 1, steps);
  const int steady_end = max(fill_end, n);
  for (int s = 0; s < fill_end; ++s)
    myers_step<C, KB, true>(s, lane, n, in_pattern, plane, text, nm_table, pv, mv, cin);
  for (int s = fill_end; s < steady_end; ++s)
    myers_step<C, KB, false>(s, lane, n, in_pattern, plane, text, nm_table, pv, mv, cin);
  for (int s = steady_end; s < steps; ++s)
    myers_step<C, KB, true>(s, lane, n, in_pattern, plane, text, nm_table, pv, mv, cin);

  // D(m, n) = n + sum over pattern rows of the last column's vertical deltas
  int delta = 0;
#pragma unroll
  for (int w = 0; w < C; ++w) {
    const int first = (lane * C + w) << 5;  // pattern position of bit 0
    const int bits = min(max(m - first, 0), 32);
    const uint32_t keep = bits == 32 ? ~0u : (1u << bits) - 1u;
    delta += __popc(pv[w] & keep) - __popc(mv[w] & keep);
  }
  return n + static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(delta)));
}

template <int C>
__device__ __forceinline__ int myers_warp_k(int kb, const uint8_t* pat, int m,
                                            const uint8_t* code_of, const uint8_t* text,
                                            int n, const uint4* nm_table, int lane) {
  if (kb <= 2) return myers_warp<C, 2>(pat, m, code_of, text, n, nm_table, lane);
  if (kb == 3) return myers_warp<C, 3>(pat, m, code_of, text, n, nm_table, lane);
  return myers_warp<C, 8>(pat, m, code_of, text, n, nm_table, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
ed_myers_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
                const int32_t* __restrict__ order, int32_t* __restrict__ out,
                int B, int L, int stride) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // text_masks' table: entry x holds the selectors of code x, bits 0-2
  uint4* nm_table = smem;
  if (threadIdx.x < kMaskTable) {
    const uint32_t x = threadIdx.x;
    nm_table[x] = make_uint4((x & 1u) - 1u, ((x >> 1) & 1u) - 1u, ((x >> 2) & 1u) - 1u, 0u);
  }
  __syncthreads();
  const int idx = blockIdx.x * kWarps + warp;
  if (idx >= B) return;  // the whole warp: no other warp waits on it
  const int pair = order[idx];
  const int m = la[pair];
  const int n = lb[pair];
  if (m == 0 || n == 0) {
    if (lane == 0) out[pair] = m + n;
    return;
  }
  const uint8_t* pat = a + static_cast<size_t>(pair) * L;
  const uint8_t* txt = b + static_cast<size_t>(pair) * L;

  uint8_t* code_of = reinterpret_cast<uint8_t*>(smem + kMaskTable) +
                    static_cast<size_t>(warp) * stride;
  uint8_t* text = code_of + kCodeTable;

  // which bytes the pattern holds: a 256-bit set, OR-reduced over the warp
  uint32_t present[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) present[r] = 0u;
  for (int base = 0; base < m; base += 32) {
    const int pos = base + lane;
    if (pos < m) {
      const uint32_t ch = pat[pos];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        present[r] |= (ch >> 5) == static_cast<uint32_t>(r) ? (1u << (ch & 31)) : 0u;
    }
  }
  int distinct = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    present[r] = __reduce_or_sync(kFull, present[r]);
    distinct += __popc(present[r]);
  }
  // code of byte 32 r + lane: its rank among the pattern's bytes, or the
  // spare code `distinct` when the pattern lacks it
  const uint32_t below_lane = (1u << lane) - 1u;
  int rank_base = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const bool has = (present[r] >> lane) & 1u;
    const int code = has ? rank_base + __popc(present[r] & below_lane) : distinct;
    code_of[32 * r + lane] = static_cast<uint8_t>(code);
    rank_base += __popc(present[r]);
  }
  __syncwarp();
  bool missing = false;
  for (int base = 0; base < n; base += 32) {
    const int pos = base + lane;
    if (pos < n) {
      const uint8_t code = code_of[txt[pos]];
      text[pos] = code;
      missing |= code == distinct;  // never true when distinct == 256
    }
  }
  missing = __any_sync(kFull, missing);
  __syncwarp();
  const int values = distinct + (missing ? 1 : 0);
  const int kb = values <= 2 ? 1 : 32 - __clz(values - 1);

  const int c = (((m + 31) >> 5) + 31) >> 5;
  int d;
  switch (c) {
    case 1: d = myers_warp_k<1>(kb, pat, m, code_of, text, n, nm_table, lane); break;
    case 2: d = myers_warp_k<2>(kb, pat, m, code_of, text, n, nm_table, lane); break;
    case 3: d = myers_warp_k<3>(kb, pat, m, code_of, text, n, nm_table, lane); break;
    default: d = myers_warp_k<kMaxC>(kb, pat, m, code_of, text, n, nm_table, lane); break;
  }
  if (lane == 0) out[pair] = d;
}

}  // namespace

// a, b: [B, L] uint8 row-major (padded); la, lb: [B] int32 lengths with
// 0 <= la, lb <= min(L, 4096); order: [B] int32, a permutation of the
// pairs in the order the warps take them; out: [B] int32. Launches on
// stream s and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises.
extern "C" int ed_myers(const uint8_t* a, const uint8_t* b, const int32_t* la,
                        const int32_t* lb, const int32_t* order, int32_t* out,
                        int B, int L, cudaStream_t s) {
  if (B <= 0) return 0;
  const int stride = (kCodeTable + L + 15) & ~15;
  const size_t smem = kMaskTable * sizeof(uint4) + static_cast<size_t>(kWarps) * stride;
  cudaError_t err = cudaFuncSetAttribute(
      ed_myers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kWarps - 1) / kWarps;
  ed_myers_kernel<<<blocks, kWarps * 32, smem, s>>>(a, b, la, lb, order, out, B, L,
                                                    stride);
  return static_cast<int>(cudaGetLastError());
}
