// Combine's device greedy on Hopper (sm_90a): the host's sequential greedy
// assignment of candidates to groups (cluster.resolve_block_groups), one
// candidate a step, as two entry points of one device step:
//   - greedy_grid, the whole-task greedy: a warp a segment row of the
//     (S, L) grid, each warp running its row's trajectory to its own
//     counts[s], with no global loop bound and no host read;
//   - greedy_flush, the sequential greedy of one flush: one warp on one
//     row whose first n_groups0 slots hold the initial groups.
//
// Replaces two XLA programs of sniffles_tpu/ops/combine_greedy.py, each a
// lax.while_loop under jax.jit: _greedy_grid_loop (:180-323) and
// _greedy_loop (:60-162). The plain versions (ops/combine_greedy.py,
// greedy_grid_plain and greedy_flush_plain, torch ops on the CPU) hold the
// JAX package's arithmetic bit for bit; these kernels repeat it:
//   * a group is integer sums (psum, lsum, n) in local coordinates, so a
//     distance is the exact rational D / n with
//     D = |psum - pos n| + |lsum - len n|;
//   * the match-radius and identity gates in float32, every operation
//     through an intrinsic (__int2float_rn, __fdiv_rn, __fsub_rn,
//     __fmul_rn, __fsqrt_rn: the plain version's sqrt_f32 is the correctly
//     rounded root), so that nvcc contracts nothing into a fused
//     multiply-add (|dist - thr| against eps * max(thr, 1) would move);
//   * the int32 key floor(D / n) 2^20 + floor((D mod n) 2^20 / n), taken
//     only by eligible slots (the others hold INT32_MAX), and the minimum
//     key with the lowest slot on ties: argmin's first minimum, the host's
//     earliest-group-wins rule;
//   * the flags of a row: ambiguous (a probe within eps of a float32
//     threshold), ed_miss (a probe whose edit distance is not tabulated)
//     and n_overflow (a group past NMAX = 1024 members).
// The int32 sums stay in range under the packer's guards
// (parallel/combine_device_greedy.py: local coordinates and |svlen| below
// SPAN_MAX = 2^18, at most SEG_LMAX = 2,048 candidates a segment): pos n
// and psum stay below 2^29, so D is at most 2^30 and never negative, and C's
// truncating division is the plain version's floor division; an eligible
// slot has D <= n cmm with cmm <= 1,023, so its key stays below 2^30, and
// (D mod n) 2^20 < 2^31 for n < 2,048. The sums and products wrap as the
// plain version's int32 tensors do (the *_wrap helpers) wherever a caller
// passes more.
//
// A step (all 32 lanes, no block barrier): the lanes stride over the live
// slots [0, ngroups) in a loop whose trip count is the same for every lane,
// compute each slot's gates and key, and keep their first minimum; two
// __reduce_min_sync give the minimum key and its lowest slot, two
// __any_sync the flags; lane 0 updates the target slot (joined, or founded
// at slot ngroups), writes assign and ORs the row's flags; __syncwarp
// orders its writes before the next step's reads. The grid's identity gate
// reads the row's ED table at ed[s, hord, min(i, W - 1)]: lanes k < K hold
// column i of the table's K head rows and each slot takes its head row's
// value by a shuffle (K <= 32). A width-1 table (W = 1, all missing) is
// read at column 0 by every step, as the plain version reads it. The
// flush's gate reads ed[clamp(head, 0, H - 1), i].
//
// The row's state is five int32 arrays of its slots (psum, lsum, n, head,
// hord: 20 bytes a slot). A grid row's lives in the block's shared memory:
// the packer sends a segment of more than SEG_LMAX = 2,048 candidates to the
// host, so L <= 2,048 and a row takes at most 40 KB of a block's 48 KB (a
// warp a block there, up to four warps a block below); greedy_grid refuses
// a larger L. A grid row's state is written when a group is founded, so
// the shared memory is never cleared. The flush's one row of G slots lives
// in shared memory where 20 G bytes fit in 48 KB, else in a global scratch
// buffer of 5 x G int32 the wrapper passes; it copies its G initial slots
// in first.
//
// What bounds it: the trajectory is a chain of dependent steps, each a
// read of the candidate, a probe of every live group and a warp reduction,
// so a dispatch's time is its longest row's steps times the latency of a
// step; the bytes (the grids, the ED table, assign) and the operations
// (the live slots of every step, about 40 int32 and float32 operations
// each) are far below a millisecond. The next candidate's values and ED
// column are loaded while the current step runs.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kInt32Max = 0x7fffffff;
constexpr int kScale = 1 << 20;      // _greedy_consts.SCALE
constexpr int kNmax = 1024;          // _greedy_consts.NMAX
constexpr int kFlagAmbiguous = 1;    // SEGF_AMBIGUOUS
constexpr int kFlagEdMiss = 2;       // SEGF_ED_MISS
constexpr int kFlagNOverflow = 4;    // SEGF_N_OVERFLOW
constexpr int kStateWords = 5;       // psum, lsum, n, head, hord
constexpr int kSharedMax = 48 * 1024;
constexpr int kWarpsMax = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Gates {
  float cm, limit, eps, tiny, forced_at;
  int cmm;
  bool use_ed;     // limit > 0: the identity gate is on
  bool pass_same;  // limit < 1: a candidate whose alt is its group head's passes
};

// int32 arithmetic that wraps, as the plain version's int32 tensors do
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int abs_wrap(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

struct Row {
  int* psum;
  int* lsum;
  int* n;
  int* head;
  int* hord;
};

__device__ __forceinline__ Row row_state(int* base, int slots) {
  return Row{base, base + slots, base + 2 * slots, base + 3 * slots, base + 4 * slots};
}

struct Candidate {
  int pos, len, alt, hord, ed;  // ed: this lane's head row of the grid's column
};

// One step of the greedy for the warp's row: the candidate probes the live
// slots [0, ngroups) and joins the best one or founds slot ngroups. Returns
// the slot (the same in every lane) and, in lane 0, ORs the step's flags
// into `flags`; a target at or past the row's `slots` (a flush given no
// free slot) changes no state, as the plain version's one-hot update
// matches no slot there. kGrid: the grid's identity gate (the ED column by
// head row, in the lanes' `c.ed`) and its fresh founding (the slot's state
// written, not added to); else the flush's (the table `ed` of H rows of
// width cp, read at column i).
template <bool kGrid>
__device__ int step(const Row& st, int slots, int& ngroups, const Candidate& c, int i, int K,
                    const int* __restrict__ ed, int H, int cp, const Gates& g, int lane,
                    int& flags) {
  const float len_f = __int2float_rn(c.len);
  int best_key = kInt32Max, best_slot = kInt32Max;
  bool amb = false, miss = false;
  for (int base = 0; base < ngroups; base += 32) {
    const int j = base + lane;
    const bool live = j < ngroups;
    int n = 0, psum = 0, lsum = 0, head = 0, hord = -1;
    if (live) {
      n = st.n[j];
      psum = st.psum[j];
      lsum = st.lsum[j];
      head = st.head[j];
      if (kGrid) hord = st.hord[j];
    }
    int d_ed = -1;
    if (g.use_ed) {
      if (kGrid) {
        // every lane shuffles, live or not: the trip count is uniform
        const bool tab = hord >= 0 && hord < K;
        const int v = __shfl_sync(kFull, c.ed, tab ? hord : 0);
        d_ed = tab ? v : -1;
      } else if (live) {
        const int h = head < 0 ? 0 : (head > H - 1 ? H - 1 : head);
        d_ed = ed[static_cast<int64_t>(h) * cp + i];
      }
    }
    if (!live || n <= 0) continue;

    const int D = add_wrap(abs_wrap(sub_wrap(psum, mul_wrap(c.pos, n))),
                           abs_wrap(sub_wrap(lsum, mul_wrap(c.len, n))));
    const float nf = __int2float_rn(n);
    const bool cap_ok = D <= mul_wrap(n, g.cmm);
    const bool shorter_pos = lsum > 0 && c.len > 0;
    const float lmf = __fdiv_rn(__int2float_rn(lsum), nf);
    const float shorter_f = fminf(lmf, len_f);
    const float thr_f = __fmul_rn(g.cm, __fsqrt_rn(fmaxf(shorter_f, 0.0f)));
    const float dist_f = __fdiv_rn(__int2float_rn(D), nf);
    const bool forced = thr_f >= g.forced_at;
    const bool pass2 = dist_f <= thr_f || forced;
    const bool amb2 = fabsf(__fsub_rn(dist_f, thr_f)) <= __fmul_rn(g.eps, fmaxf(thr_f, 1.0f))
                      && !forced;
    const bool pre = cap_ok && shorter_pos;
    bool eligible;
    if (g.use_ed) {
      const bool same = head == c.alt;
      const bool have = d_ed >= 0;
      const float ratio = __fdiv_rn(__fsub_rn(lmf, __int2float_rn(d_ed)), fmaxf(lmf, g.tiny));
      const bool pass3 = same ? g.pass_same : (have && ratio > g.limit);
      const bool amb3 = !same && have && fabsf(__fsub_rn(ratio, g.limit)) <= g.eps;
      miss |= pre && pass2 && !same && !have;
      eligible = pre && pass2 && pass3;
      amb |= pre && (amb2 || amb3);
    } else {
      eligible = pre && pass2;
      amb |= pre && amb2;
    }
    if (eligible) {
      // D >= 0 and n >= 1: truncation is floor division
      const int q = D / n;
      const int r = D - q * n;
      const int key = add_wrap(mul_wrap(q, kScale), mul_wrap(r, kScale) / n);
      if (key < best_key) {  // strict: this lane's first minimum
        best_key = key;
        best_slot = j;
      }
    }
  }
  const int min_key = __reduce_min_sync(kFull, best_key);
  const int min_slot = __reduce_min_sync(kFull, best_key == min_key ? best_slot : kInt32Max);
  const bool amb_hit = __any_sync(kFull, amb);
  const bool miss_hit = __any_sync(kFull, miss);
  const bool found = min_key < kInt32Max;
  const int tgt = found ? min_slot : ngroups;
  if (lane == 0) {
    int over = 0;
    if (tgt < slots && kGrid && !found) {
      // a founded grid slot was never written: its state starts at zero
      st.psum[tgt] = c.pos;
      st.lsum[tgt] = c.len;
      st.n[tgt] = 1;
      st.head[tgt] = c.alt;
      st.hord[tgt] = c.hord;
    } else if (tgt < slots) {
      const int n_t = st.n[tgt];
      over = n_t + 1 > kNmax;
      st.psum[tgt] = add_wrap(st.psum[tgt], c.pos);
      st.lsum[tgt] = add_wrap(st.lsum[tgt], c.len);
      st.n[tgt] = n_t + 1;
      if (!found) st.head[tgt] = c.alt;
    }
    flags |= (amb_hit ? kFlagAmbiguous : 0) | (miss_hit ? kFlagEdMiss : 0)
             | (over ? kFlagNOverflow : 0);
  }
  ngroups += found ? 0 : 1;
  __syncwarp();
  return tgt;
}

// the block's dynamic shared memory
__device__ __forceinline__ int* shared_state() {
  extern __shared__ int smem[];
  return smem;
}

// The grid greedy: warp w of block b runs row s = b * warps + w.
__global__ void greedy_grid_kernel(const int* __restrict__ c_pos, const int* __restrict__ c_len,
                                   const int* __restrict__ c_alt, const int* __restrict__ c_hord,
                                   const int* __restrict__ counts, const int* __restrict__ ed,
                                   int* __restrict__ assign, int* __restrict__ segflags,
                                   int S, int L, int K, int W, Gates g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (s >= S) return;
  const Row st = row_state(shared_state() + warp * kStateWords * L, L);
  const int64_t row = s * L;
  int cnt = counts[s];
  cnt = cnt < 0 ? 0 : (cnt > L ? L : cnt);
  for (int i = cnt + lane; i < L; i += 32) assign[row + i] = -1;
  const int* ed_row = ed + (s * K + (lane < K ? lane : 0)) * static_cast<int64_t>(W);

  auto load = [&](int i) {
    Candidate c;
    c.pos = c_pos[row + i];
    c.len = c_len[row + i];
    c.alt = c_alt[row + i];
    c.hord = c_hord[row + i];
    c.ed = (g.use_ed && lane < K) ? ed_row[i < W - 1 ? i : W - 1] : -1;
    return c;
  };
  int ngroups = 0, flags = 0;
  Candidate cur = cnt > 0 ? load(0) : Candidate{};
  for (int i = 0; i < cnt; ++i) {
    const Candidate next = i + 1 < cnt ? load(i + 1) : cur;
    const int tgt = step<true>(st, L, ngroups, cur, i, K, nullptr, 0, 0, g, lane, flags);
    if (lane == 0) assign[row + i] = tgt;
    cur = next;
  }
  if (lane == 0) segflags[s] = flags;
}

// The flush greedy: one warp, candidates [0, c_count) of cp, G group slots
// whose first n_groups0 hold the initial groups.
__global__ void greedy_flush_kernel(const int* __restrict__ c_pos, const int* __restrict__ c_len,
                                    const int* __restrict__ c_alt, int c_count, int cp,
                                    const int* __restrict__ g_psum, const int* __restrict__ g_lsum,
                                    const int* __restrict__ g_n, const int* __restrict__ g_head,
                                    int G, const int* __restrict__ ed, int H, int n_groups0,
                                    int* __restrict__ assign, int* __restrict__ flags_out,
                                    int* scratch, Gates g) {
  const int lane = threadIdx.x & 31;
  const Row st = row_state(scratch != nullptr ? scratch : shared_state(), G);
  for (int j = lane; j < G; j += 32) {
    st.psum[j] = g_psum[j];
    st.lsum[j] = g_lsum[j];
    st.n[j] = g_n[j];
    st.head[j] = g_head[j];
  }
  const int cnt = c_count < 0 ? 0 : (c_count > cp ? cp : c_count);
  for (int i = cnt + lane; i < cp; i += 32) assign[i] = -1;
  __syncwarp();
  int ngroups = n_groups0, flags = 0;
  for (int i = 0; i < cnt; ++i) {
    const Candidate c{c_pos[i], c_len[i], c_alt[i], -1, -1};
    const int tgt = step<false>(st, G, ngroups, c, i, 0, ed, H, cp, g, lane, flags);
    if (lane == 0) assign[i] = tgt;
  }
  if (lane == 0) {
    flags_out[0] = (flags & kFlagAmbiguous) ? 1 : 0;
    flags_out[1] = (flags & kFlagEdMiss) ? 1 : 0;
    flags_out[2] = (flags & kFlagNOverflow) ? 1 : 0;
  }
}

Gates gates_of(int cmm, int cm_bits, int limit_bits, int eps_bits, int tiny_bits,
               int forced_bits, int use_ed, int pass_same) {
  auto as_float = [](int bits) {
    float f;
    static_assert(sizeof(f) == sizeof(bits), "float32 bits");
    std::memcpy(&f, &bits, sizeof(f));
    return f;
  };
  return Gates{as_float(cm_bits), as_float(limit_bits), as_float(eps_bits), as_float(tiny_bits),
               as_float(forced_bits), cmm, use_ed != 0, pass_same != 0};
}

}  // namespace

// The grid greedy on (S, L) int32 grids c_pos, c_len, c_alt, c_hord, counts
// (S,), ed (S, K, W); writes assign (S, L) and segflags (S,). The rows'
// state is in shared memory, L * 20 bytes a warp: an L past 48 KB of it
// (2,457) is refused. The float32 constants come as their bits. Returns the
// launch's CUDA error (0 when it was accepted).
extern "C" int greedy_grid(const int32_t* c_pos, const int32_t* c_len, const int32_t* c_alt,
                           const int32_t* c_hord, const int32_t* counts, const int32_t* ed,
                           int32_t* assign, int32_t* segflags, int S, int L, int K, int W,
                           int cmm, int cm_bits, int limit_bits, int eps_bits, int tiny_bits,
                           int forced_bits, int use_ed, int pass_same, cudaStream_t stream) {
  const int64_t row_bytes = static_cast<int64_t>(kStateWords) * L * sizeof(int);
  if (S <= 0 || L <= 0 || K <= 0 || K > 32 || W <= 0 || row_bytes > kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>(kSharedMax / row_bytes);
  warps = warps > kWarpsMax ? kWarpsMax : warps;
  const int blocks = (S + warps - 1) / warps;
  const size_t smem = static_cast<size_t>(warps) * row_bytes;
  greedy_grid_kernel<<<blocks, 32 * warps, smem, stream>>>(
      c_pos, c_len, c_alt, c_hord, counts, ed, assign, segflags, S, L, K, W,
      gates_of(cmm, cm_bits, limit_bits, eps_bits, tiny_bits, forced_bits, use_ed, pass_same));
  return static_cast<int>(cudaGetLastError());
}

// The flush greedy on candidates c_pos, c_len, c_alt (cp,), of which the
// first c_count are real, group slots g_psum, g_lsum, g_n, g_head (G,) and
// ed (H, cp); writes assign (cp,) and flags (3,): ambiguous, ed_miss,
// n_overflow. scratch: null for the row's state in shared memory (20 G
// bytes, at most 48 KB), else 5 * G int32 of global memory.
extern "C" int greedy_flush(const int32_t* c_pos, const int32_t* c_len, const int32_t* c_alt,
                            int c_count, int cp, const int32_t* g_psum, const int32_t* g_lsum,
                            const int32_t* g_n, const int32_t* g_head, int G, const int32_t* ed,
                            int H, int n_groups0, int32_t* assign, int32_t* flags,
                            int32_t* scratch, int cmm, int cm_bits, int limit_bits,
                            int eps_bits, int tiny_bits, int forced_bits, int use_ed,
                            int pass_same, cudaStream_t stream) {
  if (cp <= 0 || G <= 0 || H <= 0 || n_groups0 < 0 || n_groups0 > G)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch == nullptr
                          ? static_cast<size_t>(kStateWords) * G * sizeof(int) : 0;
  greedy_flush_kernel<<<1, 32, smem, stream>>>(
      c_pos, c_len, c_alt, c_count, cp, g_psum, g_lsum, g_n, g_head, G, ed, H, n_groups0,
      assign, flags, scratch,
      gates_of(cmm, cm_bits, limit_bits, eps_bits, tiny_bits, forced_bits, use_ed, pass_same));
  return static_cast<int>(cudaGetLastError());
}
