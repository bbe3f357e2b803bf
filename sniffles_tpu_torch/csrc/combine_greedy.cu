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
// __any_sync the flags; every lane computes the target slot's new record
// (joined, or founded at slot ngroups) and lane 0 writes it, writes assign
// and ORs the row's flags; __syncwarp orders its writes before the next
// step's reads. The grid's identity gate reads the row's ED table at
// ed[s, hord, min(i, W - 1)]: lanes k < K hold column i of the table's K
// head rows and each slot takes its head row's value by a shuffle (K <=
// 32). A width-1 table (W = 1, all missing) is read at column 0 by every
// step, as the plain version reads it. The flush's gate reads
// ed[clamp(head, 0, H - 1), i].
//
// Only one slot changes a step, so a slot keeps beside its sums what the
// probe would otherwise recompute every step from them: the length mean
// lmf = lsum / n (__fdiv_rn, as the probe computed it), its root sl =
// sqrt(max(lmf, 0)) (__fsqrt_rn) and the magic number m of an exact
// division by n (div_magic below; ops/combine_greedy.div_magic is its
// model, held to floor division on the CPU for every n up to SEG_LMAX).
// The radius cm sqrt(max(min(lmf, len), 0)) becomes cm min(sl, sqrt_len),
// sqrt_len = sqrt(max(len, 0)) once a step: a correctly rounded root is
// monotone, so the two are equal bit for bit (also held on the CPU); the
// key's two divisions by n become multiplies by m and shifts. A slot is a
// record of eight int32, read as two 16-byte words: psum, lsum, n, head;
// hord (the grid's; -1 in the flush), lmf and sl as bits, m.
//
// A grid row's records live in the block's dynamic shared memory, 32
// bytes a slot: the packer sends a segment of more than SEG_LMAX = 2,048
// candidates to the host, so L <= 2,048 and a row takes at most 64 KB (a
// warp a block there, up to four warps a block below); greedy_grid refuses
// a larger L. A grid row's state is written when a group is founded, so
// the shared memory is never cleared. The flush's one row of G slots lives
// in shared memory where 32 G bytes fit in 64 KB, else in a global scratch
// buffer of 8 x G int32 the wrapper passes; it copies its G initial slots
// in first, their caches computed as it copies them.
//
// What bounds it: the trajectory is a chain of dependent steps, each a
// read of the candidate, a probe of every live group and a warp reduction,
// so a dispatch's time is its longest row's steps times the latency of a
// step; the bytes (the grids, the ED table, assign) and the operations
// (the live slots of every step, about 40 int32 and float32 operations
// each) are far below a millisecond. The next candidate's values and ED
// column are loaded while the current step runs. The caches shorten the
// probe of each live slot and lengthen the update by a division and a
// root: they pay where a step probes many groups (sim's "group counts"
// rows: 14-17 % a step on an H100), not where it probes about one, as
// combine's cohorts do, whose steps go to fixed costs
// (tools/time_combine_greedy.py --split; PERF.md).
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
constexpr int kRecordWords = 8;      // a slot: psum, lsum, n, head; hord, lmf, sl, m
constexpr int kSharedMax = 64 * 1024;  // a block's records (an opt-in past 48 KB)
constexpr int kSharedDefault = 48 * 1024;
constexpr int kWarpsMax = 4;
constexpr int kMagicMax = 2048;      // _greedy_consts.SEG_LMAX: div_magic's table
constexpr unsigned kFull = 0xffffffffu;

// The exact division of 0 <= x < 2^31 by n >= 1 (Granlund and Montgomery,
// division by an invariant integer): with s = ceil(log2 n) and m =
// ceil(2^(31 + s) / n) < 2^32, x / n == (x m) >> (31 + s), since x (m n -
// 2^(31 + s)) / (n 2^(31 + s)) < 1 / n. The m of n <= kMagicMax from a
// table in constant memory that the compiler makes (a step's update reads
// one entry, the same in every lane); past it by a 64-bit division.
constexpr int div_shift(int n) {
  int s = 0;
  while (s < 31 && (1u << s) < static_cast<unsigned>(n)) ++s;
  return s;
}
struct MagicTable {
  unsigned m[kMagicMax + 1];
};
constexpr MagicTable make_magic_table() {
  MagicTable t{};
  for (int n = 1; n <= kMagicMax; ++n)
    t.m[n] = static_cast<unsigned>(((1ull << (31 + div_shift(n))) + n - 1) / n);
  return t;
}
__constant__ MagicTable kMagic = make_magic_table();

__device__ __forceinline__ unsigned div_magic(int n) {
  if (n <= kMagicMax) return kMagic.m[n];
  const unsigned long long d = static_cast<unsigned>(n);
  return static_cast<unsigned>(((1ull << (31 + (32 - __clz(n - 1)))) + d - 1) / d);
}

// x / n for 0 <= x < 2^31 and n >= 1 by n's magic number m
__device__ __forceinline__ int div_by(int x, unsigned m, int n) {
  const int s = 32 - __clz(n - 1);  // ceil(log2 n): 0 for n = 1
  return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(x)) * m) >>
                          (31 + s));
}

// A step's cycles by part, in a build with -DGREEDY_STEP_CLOCKS only
// (tools/time_combine_greedy.py --split): every lane sums the clock64()
// cycles between its stamps by part (kLoad: the candidate's values, loaded
// a step ahead, waited for; kProbe: the probe trips; kReduce: the warp
// reductions; kUpdate: the target slot's new record computed and written
// by lane 0, the assign write and the __syncwarp), and lane 0 adds its sums
// and its steps to g_step_clocks when its row ends. Without the flag the
// stamps are empty and the file compiles to the same code.
enum Part { kLoad = 0, kProbe = 1, kReduce = 2, kUpdate = 3, kParts = 4 };
#ifdef GREEDY_STEP_CLOCKS
// the parts' cycles, the steps, and one word that keeps the waits alive
__device__ unsigned long long g_step_clocks[kParts + 2];
struct StepClock {
  long long t;
  unsigned long long sum[kParts];
  unsigned long long steps, sink;
  __device__ void start() {
    t = clock64();
    for (int p = 0; p < kParts; ++p) sum[p] = 0;
    steps = sink = 0;
  }
  __device__ void stamp(int p) {
    const long long now = clock64();
    sum[p] += static_cast<unsigned long long>(now - t);
    t = now;
    steps += p == kUpdate;
  }
  // an instruction that reads v, so that a stamp after it waits for v
  __device__ void settle(unsigned v) {
    asm volatile("xor.b64 %0, %0, %1;" : "+l"(sink) : "l"(static_cast<unsigned long long>(v)));
  }
  __device__ void flush(int lane) {
    if (lane != 0) return;
    for (int p = 0; p < kParts; ++p) atomicAdd(&g_step_clocks[p], sum[p]);
    atomicAdd(&g_step_clocks[kParts], steps);
    atomicXor(&g_step_clocks[kParts + 1], sink);
  }
};
#else
struct StepClock {
  __device__ void start() {}
  __device__ void stamp(int) {}
  __device__ void settle(unsigned) {}
  __device__ void flush(int) {}
};
#endif

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

// A row's slot records: slot j at rec[2 j] (psum, lsum, n, head) and
// rec[2 j + 1] (hord, lmf and sl as bits, m).
struct Row {
  int4* rec;
};

// the cached half of a slot of n members whose lengths sum to lsum: hord,
// lmf and its root as bits, m (0 and no division where n < 1: the probe
// skips such a slot)
__device__ __forceinline__ int4 slot_caches(int hord, int lsum, int n) {
  const float lmf = n >= 1 ? __fdiv_rn(__int2float_rn(lsum), __int2float_rn(n)) : 0.0f;
  return make_int4(hord, __float_as_int(lmf), __float_as_int(__fsqrt_rn(fmaxf(lmf, 0.0f))),
                   n >= 1 ? static_cast<int>(div_magic(n)) : 0);
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
// head row, in the lanes' `c.ed`) and its fresh founding (the slot's record
// written, not added to); else the flush's (the table `ed` of H rows of
// width cp, read at column i).
template <bool kGrid>
__device__ int step(const Row& st, int slots, int& ngroups, const Candidate& c, int i, int K,
                    const int* __restrict__ ed, int H, int cp, const Gates& g, int lane,
                    int& flags, StepClock& clk) {
  clk.settle(c.pos ^ c.len ^ c.alt ^ c.hord ^ c.ed);
  clk.stamp(kLoad);
  const float len_f = __int2float_rn(c.len);
  const float sqrt_len = __fsqrt_rn(fmaxf(len_f, 0.0f));
  int best_key = kInt32Max, best_slot = kInt32Max;
  bool amb = false, miss = false;
  for (int base = 0; base < ngroups; base += 32) {
    const int j = base + lane;
    const bool live = j < ngroups;
    int4 ra = make_int4(0, 0, 0, 0), rb = make_int4(-1, 0, 0, 0);
    if (live) {
      ra = st.rec[2 * j];
      rb = st.rec[2 * j + 1];
    }
    const int psum = ra.x, lsum = ra.y, n = ra.z, head = ra.w;
    int d_ed = -1;
    if (g.use_ed) {
      if (kGrid) {
        // every lane shuffles, live or not: the trip count is uniform
        const bool tab = rb.x >= 0 && rb.x < K;
        const int v = __shfl_sync(kFull, c.ed, tab ? rb.x : 0);
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
    const float lmf = __int_as_float(rb.y);
    const float thr_f = __fmul_rn(g.cm, fminf(__int_as_float(rb.z), sqrt_len));
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
      // floor(D / n) 2^20 + floor((D mod n) 2^20 / n), each division by the
      // slot's magic number where the dividend is not negative (D >= 0 and
      // r 2^20 < 2^31 under the packer's guards; C's division, as before,
      // where a caller passes more)
      const unsigned m = static_cast<unsigned>(rb.w);
      const int q = D >= 0 ? div_by(D, m, n) : D / n;
      const int r = D - q * n;
      const int frac = mul_wrap(r, kScale);
      const int key = add_wrap(mul_wrap(q, kScale), frac >= 0 ? div_by(frac, m, n) : frac / n);
      if (key < best_key) {  // strict: this lane's first minimum
        best_key = key;
        best_slot = j;
      }
    }
  }
  clk.settle(best_key ^ best_slot ^ amb ^ (miss << 1));
  clk.stamp(kProbe);
  const int min_key = __reduce_min_sync(kFull, best_key);
  const int min_slot = __reduce_min_sync(kFull, best_key == min_key ? best_slot : kInt32Max);
  const bool amb_hit = __any_sync(kFull, amb);
  const bool miss_hit = __any_sync(kFull, miss);
  const bool found = min_key < kInt32Max;
  const int tgt = found ? min_slot : ngroups;
  clk.settle(tgt ^ amb_hit ^ (miss_hit << 1));
  clk.stamp(kReduce);
  // the target's new record, computed by every lane (each reads the same
  // words), written by lane 0
  int over = 0;
  if (tgt < slots) {
    int4 ra, rb;
    if (kGrid && !found) {
      // a founded grid slot was never written: its sums start at zero, its
      // mean is the length (a division by 1), its root sqrt_len
      ra = make_int4(c.pos, c.len, 1, c.alt);
      rb = make_int4(c.hord, __float_as_int(len_f), __float_as_int(sqrt_len),
                     static_cast<int>(div_magic(1)));
    } else {
      ra = st.rec[2 * tgt];
      over = ra.z + 1 > kNmax;
      ra.x = add_wrap(ra.x, c.pos);
      ra.y = add_wrap(ra.y, c.len);
      ra.z = ra.z + 1;
      if (!found) ra.w = c.alt;
      rb = slot_caches(st.rec[2 * tgt + 1].x, ra.y, ra.z);
    }
    if (lane == 0) {
      st.rec[2 * tgt] = ra;
      st.rec[2 * tgt + 1] = rb;
    }
  }
  if (lane == 0)
    flags |= (amb_hit ? kFlagAmbiguous : 0) | (miss_hit ? kFlagEdMiss : 0)
             | (over ? kFlagNOverflow : 0);
  ngroups += found ? 0 : 1;
  __syncwarp();
  return tgt;
}

// the block's dynamic shared memory
__device__ __forceinline__ int4* shared_state() {
  extern __shared__ int4 smem[];
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
  const Row st{shared_state() + static_cast<size_t>(warp) * 2 * L};
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
  StepClock clk;
  clk.start();
  Candidate cur = cnt > 0 ? load(0) : Candidate{};
  for (int i = 0; i < cnt; ++i) {
    const Candidate next = i + 1 < cnt ? load(i + 1) : cur;
    const int tgt = step<true>(st, L, ngroups, cur, i, K, nullptr, 0, 0, g, lane, flags, clk);
    if (lane == 0) assign[row + i] = tgt;
    clk.stamp(kUpdate);
    cur = next;
  }
  clk.flush(lane);
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
                                    int4* scratch, Gates g) {
  const int lane = threadIdx.x & 31;
  const Row st{scratch != nullptr ? scratch : shared_state()};
  for (int j = lane; j < G; j += 32) {
    st.rec[2 * j] = make_int4(g_psum[j], g_lsum[j], g_n[j], g_head[j]);
    st.rec[2 * j + 1] = slot_caches(-1, g_lsum[j], g_n[j]);
  }
  const int cnt = c_count < 0 ? 0 : (c_count > cp ? cp : c_count);
  for (int i = cnt + lane; i < cp; i += 32) assign[i] = -1;
  __syncwarp();
  int ngroups = n_groups0, flags = 0;
  StepClock clk;
  clk.start();
  for (int i = 0; i < cnt; ++i) {
    const Candidate c{c_pos[i], c_len[i], c_alt[i], -1, -1};
    const int tgt = step<false>(st, G, ngroups, c, i, 0, ed, H, cp, g, lane, flags, clk);
    if (lane == 0) assign[i] = tgt;
    clk.stamp(kUpdate);
  }
  clk.flush(lane);
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

#ifdef GREEDY_STEP_CLOCKS
// The steps' cycles by part summed over the rows since the last call, and
// the steps (kParts + 1 words to out, on the host), then zeroed; a build
// with -DGREEDY_STEP_CLOCKS only. Synchronous.
extern "C" int greedy_step_clocks(uint64_t* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_step_clocks, (kParts + 1) * sizeof(uint64_t));
  static const unsigned long long zero[kParts + 2] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_step_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

// dynamic shared memory of `bytes` for `kernel`: past the default 48 KB,
// the attribute that allows it first
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSharedDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The grid greedy on (S, L) int32 grids c_pos, c_len, c_alt, c_hord, counts
// (S,), ed (S, K, W); writes assign (S, L) and segflags (S,). The rows'
// records are in shared memory, L * 32 bytes a warp: an L past 64 KB of it
// (2,048) is refused. The float32 constants come as their bits. Returns the
// launch's CUDA error (0 when it was accepted).
extern "C" int greedy_grid(const int32_t* c_pos, const int32_t* c_len, const int32_t* c_alt,
                           const int32_t* c_hord, const int32_t* counts, const int32_t* ed,
                           int32_t* assign, int32_t* segflags, int S, int L, int K, int W,
                           int cmm, int cm_bits, int limit_bits, int eps_bits, int tiny_bits,
                           int forced_bits, int use_ed, int pass_same, cudaStream_t stream) {
  const int64_t row_bytes = static_cast<int64_t>(kRecordWords) * L * sizeof(int);
  if (S <= 0 || L <= 0 || K <= 0 || K > 32 || W <= 0 || row_bytes > kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>(kSharedMax / row_bytes);
  warps = warps > kWarpsMax ? kWarpsMax : warps;
  const int blocks = (S + warps - 1) / warps;
  const size_t smem = static_cast<size_t>(warps) * row_bytes;
  const cudaError_t err = allow_shared(greedy_grid_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_grid_kernel<<<blocks, 32 * warps, smem, stream>>>(
      c_pos, c_len, c_alt, c_hord, counts, ed, assign, segflags, S, L, K, W,
      gates_of(cmm, cm_bits, limit_bits, eps_bits, tiny_bits, forced_bits, use_ed, pass_same));
  return static_cast<int>(cudaGetLastError());
}

// The flush greedy on candidates c_pos, c_len, c_alt (cp,), of which the
// first c_count are real, group slots g_psum, g_lsum, g_n, g_head (G,) and
// ed (H, cp); writes assign (cp,) and flags (3,): ambiguous, ed_miss,
// n_overflow. scratch: null for the row's records in shared memory (32 G
// bytes, at most 64 KB), else 8 * G int32 of global memory (16-byte
// aligned).
extern "C" int greedy_flush(const int32_t* c_pos, const int32_t* c_len, const int32_t* c_alt,
                            int c_count, int cp, const int32_t* g_psum, const int32_t* g_lsum,
                            const int32_t* g_n, const int32_t* g_head, int G, const int32_t* ed,
                            int H, int n_groups0, int32_t* assign, int32_t* flags,
                            int32_t* scratch, int cmm, int cm_bits, int limit_bits,
                            int eps_bits, int tiny_bits, int forced_bits, int use_ed,
                            int pass_same, cudaStream_t stream) {
  const size_t smem = scratch == nullptr
                          ? static_cast<size_t>(kRecordWords) * G * sizeof(int) : 0;
  if (cp <= 0 || G <= 0 || H <= 0 || n_groups0 < 0 || n_groups0 > G || smem > kSharedMax ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(greedy_flush_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_flush_kernel<<<1, 32, smem, stream>>>(
      c_pos, c_len, c_alt, c_count, cp, g_psum, g_lsum, g_n, g_head, G, ed, H, n_groups0,
      assign, flags, reinterpret_cast<int4*>(scratch),
      gates_of(cmm, cm_bits, limit_bits, eps_bits, tiny_bits, forced_bits, use_ed, pass_same));
  return static_cast<int>(cudaGetLastError());
}
