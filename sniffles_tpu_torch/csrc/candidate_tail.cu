// The candidate tail of the fused calling engine on Hopper (sm_90a): a
// thread per candidate slot computes, from the slot's call statistics,
// everything the JAX step derives from them.
//
// Replaces the XLA programs of sniffles_tpu/parallel/engine.py:133-151 and
// what they call: the cluster's mean NM (call_statistics' seg_mean, in the
// step's own order), the length screen of cluster_valid (:133-135),
// annotate_coverage (ops/coverage.py:34), genotype_batch
// (ops/genotype_batch.py:42), qc_batch (ops/qc_batch.py:37) and the
// PRECISE flag (:151). The plain version is the composition of the port's
// torch functions (ops/candidate_tail.py::candidate_tail_plain), which hold
// the JAX package's CPU arithmetic bit for bit; this kernel repeats it
// operation for operation:
//   * float32 through __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, never
//     contracted; __fmaf_rn exactly where XLA's CPU code fuses and the plain
//     version calls fma_f32 (the likelihoods, the long-INS rescale, the
//     auto minimum support's blend);
//   * jnp.round is rintf (half to even), jnp.trunc truncf;
//   * the five log10 constants come from the host (XLA's CPU log, computed
//     by ops/genotype_batch.log10_constants), in the parameter struct;
//   * int32 index arithmetic wraps; `//` of the centre is floor division;
//   * the cluster's NM sum adds its contiguous run of elements in array
//     order in float32, as XLA's scatter-add does (cluster ids ascend
//     along the array; a first pass, tail_runs, writes the run's start,
//     the lower bound of each cluster id, so a slot reads its run's two
//     ends instead of searching for them);
//   * the stable descending sort of the three likelihoods puts NaN last,
//     as torch.argsort of -lq does; torch.minimum propagates NaN, and a
//     NaN or infinite float cast to int32 is INT32_MIN, as on the CPU.
// Parameters: the struct TailParams (by value; ops/candidate_tail.py builds
// it field for field) and, where they are tensors on the device (a mesh's
// reductions), coverage_global and qc_nm_threshold in dyn, so nothing waits
// for the host; where they are numbers they ride in the struct and dyn is
// null. Boolean columns in and out are the bytes of torch bool tensors.
//
// Bound: bytes. A slot reads about 60 bytes of statistics, its cluster's
// NM run (4 bytes an element) and five coverage samples, and writes 65
// bytes; a few hundred float operations a slot are far below the card's
// rate. A slot's loads are independent but for its coverage probes (they
// need its position) and its NM run, whose ends the run-start pass gives
// (scratch, n + 1 int32, not counted in the bound), so the run's loads go
// out ahead of the in-order sum; the wrapper launches no conversion.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

// A timing tool's variant of the run pass (tools/profile_engine.py
// --tail-split): -DTAIL_RUN_PARTS=1 launches its grid and returns at once
// (the empty launch), 2 issues its loads and stores nothing the data asks
// for (the loads alone; ops/candidate_tail.RUN_PARTS). 0, the default, is
// the pass. Only a timing tool builds a variant; its starts are not written.
#ifndef TAIL_RUN_PARTS
#define TAIL_RUN_PARTS 0
#endif

namespace {

constexpr int kThreads = 256;     // candidate_tail_kernel's blocks
constexpr int kRunThreads = 256;  // tail_runs' blocks,
constexpr int kRunVecs = 4;       // and a lane's int4 loads a round, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRunParts = TAIL_RUN_PARTS;
static_assert(kRunParts >= 0 && kRunParts <= 2, "the run pass's parts: the launch, the loads");
constexpr int INS = 0, DEL = 1, DUP = 2, INV = 3, BND = 4, SINGLE_LEFT = 5, SINGLE_RIGHT = 6;

// the order of INT_KEYS, FLOAT_KEYS and BOOL_KEYS in ops/candidate_tail.py
enum IntRow { kCovUp, kCovStart, kCovCenter, kCovEnd, kCovDown, kGtA, kGtB, kGq, kZscore,
              kDr, kDv, kFilter, kIntRows };
enum FloatRow { kAf, kCoverage, kNm, kFloatRows };
enum BoolRow { kGtFailed, kQc, kPrecise, kClusterValid, kBoolRows };

// FILTER_CODES of ops/qc_batch.py
enum Filter { PASS, STDEV_POS, STDEV_LEN, SINGLE_BREAK, SVLEN_MIN, STRAND_BND,
              COV_CHANGE_DEL, COV_CHANGE_DUP, COV_CHANGE_INS, SUPPORT_MIN, COV_MIN_GT,
              ALN_NM, MOSAIC_VAF, SVLEN_MAX_MOSAIC, STRAND, STRAND_MOSAIC,
              SVLEN_MIN_MOSAIC, COV_MIN, NOT_MOSAIC_VAF, GT, GT_FAILED };

}  // namespace

struct TailParams {
  float normalization_target, long_ins_length, rescale_base, rescale_mult, dev_min_dup_vaf,
      genotype_min_z_score, qc_stdev_abs_max, qc_coverage, long_del_length,
      long_del_coverage, long_dup_length, long_dup_coverage, long_inv_length,
      dev_longer_del, dev_longer_dup, qc_nm_mult, minsupport_const, minsupport_auto_base,
      minsupport_auto_mult, minsupport_auto_regional_coverage_weight, mosaic_af_min,
      mosaic_af_max, mosaic_min_reads, mosaic_use_strand_thresholds,
      mosaic_qc_invdup_min_length, max_svlen_mosaic;
  float log10_err, log10_1m_err, log10_het, log10_1m_het, log10_1m_1m_err;
  float coverage_global, qc_nm_threshold;  // unless dyn holds them on the device
  int minsvlen, minsvlen_screen, minsvlen_hard_cap, qc_stdev, qc_strand,
      qc_bnd_filter_strand, qc_nm, minsupport_is_auto, mosaic, mosaic_qc_strand,
      mosaic_include_germline, detect_large_ins;
};

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// int32 abs as XLA's: INT32_MIN stays INT32_MIN
__device__ __forceinline__ int wrap_abs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

// a float cast to int32 as the CPU's cvttss2si: NaN and out of range give
// INT32_MIN
__device__ __forceinline__ int to_i32(float x) {
  return (x != x || x >= 2147483648.0f || x < -2147483648.0f) ? INT_MIN
                                                               : static_cast<int>(x);
}

// torch.minimum: NaN when either is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_f(float a, float b) { return a > b ? a : b; }

__device__ __forceinline__ int sample(const int32_t* __restrict__ cov, int len, int idx) {
  return (idx >= 0 && idx < len) ? cov[idx] : 0;
}

// ops/genotype_batch._mean_nonzero of k coverage values: (round(mean), all zero)
__device__ __forceinline__ float mean_nonzero(const float* v, int k, bool* none) {
  float s = 0.0f, cnt = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float nz = v[j] != 0.0f ? 1.0f : 0.0f;
    s = j == 0 ? __fmul_rn(v[j], nz) : __fadd_rn(s, __fmul_rn(v[j], nz));
    cnt = __fadd_rn(cnt, nz);
  }
  *none = cnt == 0.0f;
  return rintf(cnt > 0.0f ? __fdiv_rn(s, max_f(cnt, 1.0f)) : 0.0f);
}

// rescale_support_batch
__device__ __forceinline__ float rescaled_support(int svtype, int svlen, int support,
                                                  const TailParams& p) {
  const float sv = static_cast<float>(svlen);
  const bool long_ins = svtype == INS && sv >= p.long_ins_length;
  const float scale = __fmaf_rn(p.rescale_mult, __fdiv_rn(sv, p.long_ins_length),
                                p.rescale_base);
  const float sup = static_cast<float>(support);
  return long_ins ? rintf(__fmul_rn(sup, scale)) : sup;
}

// -lq ascending, NaN last, stable: the genotype order of best first
__device__ __forceinline__ bool before(float a, float b) {
  const float na = -a, nb = -b;
  if (nb != nb) return na == na;
  return na < nb;
}

// The ids in (prev, cur], clamped to [0, n], start at element j: the run
// pass's write for element j (prev the id before it, -1 for j = 0); an id
// at or past n starts no slot after slot n.
__device__ __forceinline__ void write_starts(int32_t* __restrict__ run_start, int prev, int cur,
                                             int j, int n) {
  const int from = prev < 0 ? 0 : (prev >= n ? n + 1 : prev + 1);
  const int to = min(cur, n);
  for (int c = from; c <= to; ++c) run_start[c] = j;  // more than one only at a gap
}

// run_start[c] = the first element j with cluster_id[j] >= c, for every c
// up to clamp(cluster_id[n - 1] + 1, 0, n) (cluster ids ascend along the
// array): element j writes the ids in (cluster_id[j - 1], cluster_id[j]],
// and the end (j = n) the one past the last id.
//
// Bound: bytes (the ids read once, a start a cluster written). The ids
// from `head` (0-3: those before the first 16-byte boundary) are read as
// `vecs` int4 vectors, in chunks of 32 * V vectors, `per_warp` chunks to
// each of the grid's warps in order (the resident grid, no more blocks than
// chunks): a lane loads V vectors of a round, 32 lanes apart, every load
// issued before the first store, so that the card has the whole array in
// flight at once. V is kRunVecs where the chunks give each SM a block's
// warps, fewer on a small batch (more warps, less work a lane). An
// element's left neighbour is the previous lane's last id
// (__shfl_up_sync), lane 0's the last lane's of the round's previous
// vector or the id before the warp's first chunk (one load a warp): no id
// is loaded twice but those. The grid's last thread takes the head, the
// ids after the last vector (0-3) and the end, by scalar loads.
template <int V>
__global__ void __launch_bounds__(kRunThreads) tail_runs(const int32_t* __restrict__ cluster_id,
                                                         int32_t* __restrict__ run_start, int n,
                                                         int head, int vecs, int per_warp) {
  if (kRunParts == 1) return;
  constexpr int kChunk = 32 * V;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kRunThreads / 32);
  const int warp = blockIdx.x * (kRunThreads / 32) + (threadIdx.x >> 5);
  const int chunks = (vecs + kChunk - 1) / kChunk;
  const int c0 = min(warp * per_warp, chunks), c1 = min(c0 + per_warp, chunks);
  const int4* __restrict__ vec = reinterpret_cast<const int4*>(cluster_id + head);
  int carry = -1;  // the id before the warp's next vector
  if (c0 < c1 && (c0 > 0 || head > 0)) carry = cluster_id[head + 4 * c0 * kChunk - 1];
  for (int c = c0; c < c1; ++c) {
    int4 x[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {  // every load issued before the first store
      const int k = c * kChunk + u * 32 + lane;
      x[u] = k < vecs ? vec[k] : make_int4(0, 0, 0, 0);
    }
    if (kRunParts == 2) {  // a store no ascending ids ask for keeps the loads
      int folded = carry;
#pragma unroll
      for (int u = 0; u < V; ++u) folded ^= x[u].x ^ x[u].y ^ x[u].z ^ x[u].w;
      if (folded == INT_MIN + 1) run_start[0] = folded;
      continue;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int up = __shfl_up_sync(kFull, x[u].w, 1);
      const int prev = lane == 0 ? carry : up;
      carry = __shfl_sync(kFull, x[u].w, 31);
      const int k = c * kChunk + u * 32 + lane;
      if (k < vecs) {
        const int j = head + 4 * k;
        write_starts(run_start, prev, x[u].x, j, n);
        write_starts(run_start, x[u].x, x[u].y, j + 1, n);
        write_starts(run_start, x[u].y, x[u].z, j + 2, n);
        write_starts(run_start, x[u].z, x[u].w, j + 3, n);
      }
    }
  }
  if (kRunParts == 0 && warp == warps - 1 && lane == 31) {
    for (int j = 0; j < head; ++j)
      write_starts(run_start, j == 0 ? -1 : cluster_id[j - 1], cluster_id[j], j, n);
    for (int j = head + 4 * vecs; j < n; ++j)
      write_starts(run_start, j == 0 ? -1 : cluster_id[j - 1], cluster_id[j], j, n);
    const int last = cluster_id[n - 1];  // the end: the slot after it, where at most n
    write_starts(run_start, last, last < n ? max(last + 1, 0) : -1, n, n);
  }
}

// The current device's SMs and the blocks of tail_runs it holds at once,
// cached by device: the queries cost host time.
struct RunGrid {
  int sms = 0, resident = 0;
};

cudaError_t run_grid(RunGrid* out) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static RunGrid cache[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevices && cache[dev].resident > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  RunGrid g;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_runs<kRunVecs>,
                                                        kRunThreads, 0);
  if (err != cudaSuccess) return err;
  g.resident = std::max(1, g.sms * per_sm);
  if (dev < kDevices) cache[dev] = g;
  *out = g;
  return cudaSuccess;
}

// tail_runs<V> on the resident grid capped at its chunks, the chunks dealt
// evenly to its warps
template <int V>
void launch_runs_of(const int32_t* cluster_id, int32_t* run_start, int n, int head, int vecs,
                    int resident, cudaStream_t s) {
  constexpr int kWarps = kRunThreads / 32;
  const int chunks = (vecs + 32 * V - 1) / (32 * V);
  const int grid = std::max(1, std::min(resident, (chunks + kWarps - 1) / kWarps));
  const int per_warp = (chunks + grid * kWarps - 1) / (grid * kWarps);
  tail_runs<V><<<grid, kRunThreads, 0, s>>>(cluster_id, run_start, n, head, vecs, per_warp);
}

// the run pass on stream s (run_start: n + 1 int32; cluster_id 4-byte
// aligned, any 16-byte offset: a view's)
cudaError_t launch_runs(const int32_t* cluster_id, int32_t* run_start, int n, cudaStream_t s) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(cluster_id);
  if (at % 4 != 0) return cudaErrorMisalignedAddress;
  const int head = std::min(static_cast<int>((16 - at % 16) % 16 / 4), n);
  const int vecs = (n - head) / 4;
  RunGrid g;
  const cudaError_t err = run_grid(&g);
  if (err != cudaSuccess) return err;
  // the most vectors a lane (kRunVecs, 2, 1) whose chunks fill every SM
  // with a block's warps
  const int fill = g.sms * (kRunThreads / 32);
  static_assert(kRunVecs == 4, "the launch picks 4, 2 or 1 vectors a lane");
  if (vecs / (32 * 4) >= fill)
    launch_runs_of<4>(cluster_id, run_start, n, head, vecs, g.resident, s);
  else if (vecs / (32 * 2) >= fill)
    launch_runs_of<2>(cluster_id, run_start, n, head, vecs, g.resident, s);
  else
    launch_runs_of<1>(cluster_id, run_start, n, head, vecs, g.resident, s);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads) candidate_tail_kernel(
    const int32_t* __restrict__ svtype_, const int32_t* __restrict__ svlen_,
    const int32_t* __restrict__ pos_, const int32_t* __restrict__ support_,
    const int32_t* __restrict__ lead_count_, const int32_t* __restrict__ n_strands_,
    const float* __restrict__ stdev_pos_, const float* __restrict__ stdev_len_,
    const float* __restrict__ nm, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ cluster_id, const int32_t* __restrict__ run_start,
    const int32_t* __restrict__ n_clusters, const int32_t* __restrict__ support_sa_,
    const int32_t* __restrict__ cov, const float* __restrict__ dyn,
    int32_t* out_i, float* out_f, uint8_t* out_b, int n, int len, int region_offset,
    int binsize, TailParams p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int svtype = svtype_[c], svlen = svlen_[c], support = support_[c];
  const int lead_count = lead_count_[c], n_strands = n_strands_[c];
  const float stdev_pos = stdev_pos_[c], stdev_len = stdev_len_[c];
  const float coverage_global = dyn != nullptr ? dyn[0] : p.coverage_global;
  const float qc_nm_threshold = dyn != nullptr ? dyn[1] : p.qc_nm_threshold;
  const int abs_svlen = wrap_abs(svlen);

  // the cluster's mean NM: its run of elements [run_start[c],
  // run_start[c + 1]), summed in array order (a slot past the last cluster
  // id has none)
  float nm_sum = 0.0f;
  if (c <= cluster_id[n - 1]) {
    const int hi = run_start[c + 1];
#pragma unroll 4
    for (int j = run_start[c]; j < hi; ++j) {
      nm_sum = __fadd_rn(nm_sum, valid[j] ? nm[j] : 0.0f);
    }
  }
  const float nm_mean = __fdiv_rn(nm_sum, static_cast<float>(lead_count > 1 ? lead_count : 1));

  // cluster_valid with the length screen (engine.py:133-135)
  const bool is_sv = svtype >= 0 && svtype <= INV;
  const bool cluster_valid = c < n_clusters[0] && (!is_sv || abs_svlen >= p.minsvlen_screen) &&
                             lead_count > 0;

  // annotate_coverage (bnd_is_first is all False in the step)
  const int start = static_cast<int>(static_cast<unsigned>(pos_[c]) -
                                     static_cast<unsigned>(region_offset));
  const int end = svtype == INS ? wrap_add(start, 1)
                                : (svtype == BND ? start : wrap_add(start, abs_svlen));
  const bool ins_or_bnd = svtype == INS || svtype == BND;
  const int center = wrap_add(start, end) >> 1;  // floor division by 2
  const int cov_start = ins_or_bnd ? sample(cov, len, wrap_add(start, -binsize))
                                   : sample(cov, len, start);
  const int cov_center = ins_or_bnd ? sample(cov, len, start) : sample(cov, len, center);
  const int cov_end = ins_or_bnd ? sample(cov, len, wrap_add(end, binsize))
                                 : sample(cov, len, wrap_add(end, -binsize));
  const int cov_up = sample(cov, len, wrap_add(start, -5 * binsize));
  const int cov_down = sample(cov, len, wrap_add(end, 5 * binsize));

  // genotype_batch
  const float supp = rescaled_support(svtype, svlen, support, p);
  const int ssa = support_sa_[c];
  bool f_default, f_ins, f_dup, f_inv, f_del_sa;
  float v[3] = {static_cast<float>(cov_start), static_cast<float>(cov_center),
                static_cast<float>(cov_end)};
  const float cov_default = mean_nonzero(v, 3, &f_default);
  v[0] = static_cast<float>(cov_center);
  const float cov_ins = mean_nonzero(v, 1, &f_ins);
  v[0] = static_cast<float>(cov_start);
  v[1] = static_cast<float>(cov_end);
  const float cov_dup = __fadd_rn(mean_nonzero(v, 2, &f_dup), rintf(__fmul_rn(0.75f, supp)));
  v[0] = static_cast<float>(cov_up);
  v[1] = static_cast<float>(cov_down);
  const float cov_inv = __fadd_rn(mean_nonzero(v, 2, &f_inv), rintf(__fmul_rn(0.5f, supp)));
  v[0] = static_cast<float>(wrap_add(cov_start, ssa));
  v[1] = static_cast<float>(wrap_add(cov_center, ssa));
  v[2] = static_cast<float>(wrap_add(cov_end, ssa));
  const float cov_del_sa = mean_nonzero(v, 3, &f_del_sa);
  const float cov_del = ssa > 0 ? cov_del_sa : cov_default;
  const bool f_del = ssa > 0 ? f_del_sa : f_default;
  float coverage;
  bool gt_failed;
  switch (svtype) {
    case INS: coverage = cov_ins; gt_failed = f_ins; break;
    case DUP: coverage = cov_dup; gt_failed = f_dup; break;
    case INV: coverage = cov_inv; gt_failed = f_inv; break;
    case DEL: coverage = cov_del; gt_failed = f_del; break;
    default: coverage = cov_default; gt_failed = f_default;
  }
  coverage = max_f(coverage, supp);
  const float af = __fdiv_rn(supp, max_f(coverage, 1.0f));
  const float max_lead = max_f(supp, coverage);
  const float norm = max_lead > p.normalization_target
                         ? __fdiv_rn(p.normalization_target, max_f(max_lead, 1.0f))
                         : 1.0f;
  const float k = rintf(__fmul_rn(supp, norm));
  const float nk = __fsub_rn(rintf(__fmul_rn(coverage, norm)), k);
  const float lq[3] = {__fmaf_rn(nk, p.log10_1m_err, __fmul_rn(k, p.log10_err)),
                       __fmaf_rn(nk, p.log10_1m_het, __fmul_rn(k, p.log10_het)),
                       __fmaf_rn(nk, p.log10_1m_1m_err, __fmul_rn(k, p.log10_1m_err))};
  int order[3] = {0, 1, 2};
  for (int a = 1; a < 3; ++a) {  // stable insertion sort, best first
    const int x = order[a];
    int b = a;
    while (b > 0 && before(lq[x], lq[order[b - 1]])) {
      order[b] = order[b - 1];
      --b;
    }
    order[b] = x;
  }
  const float l1 = lq[order[0]], l2 = lq[order[1]], lz = lq[0];
  const float underflow = -323.3f;
  const float gq_f = l2 < underflow
                         ? 0.0f
                         : min_nan(60.0f, truncf(__fmul_rn(-10.0f, __fsub_rn(l2, l1))));
  const float z_f = lz < underflow
                        ? 0.0f
                        : min_nan(60.0f, truncf(__fmul_rn(-10.0f, __fsub_rn(lz, l1))));
  const int best = order[0];
  const int gt_a = best == 2 ? 1 : 0;
  int gt_b = best >= 1 ? 1 : 0;
  if (svtype == DUP && af >= p.dev_min_dup_vaf && best == 0) gt_b = 1;
  const int gq = to_i32(gq_f), zscore = to_i32(z_f);

  // qc_batch
  const float cu = static_cast<float>(cov_up), cs = static_cast<float>(cov_start);
  const float cc = static_cast<float>(cov_center), ce = static_cast<float>(cov_end);
  const float cd = static_cast<float>(cov_down);
  const float abs_len_f = static_cast<float>(abs_svlen), svlen_f = static_cast<float>(svlen);
  const float support_f = static_cast<float>(support);
  const bool is_bnd = svtype == BND;
  const bool is_single = svtype == SINGLE_LEFT || svtype == SINGLE_RIGHT;
  const float safe_len = max_f(abs_len_f, 1.0f);
  const bool qc_stdev = p.qc_stdev > 0;
  const bool f_stdev_pos = qc_stdev && (stdev_pos > p.qc_stdev_abs_max ||
                                        (!is_bnd && !is_single &&
                                         __fdiv_rn(stdev_pos, safe_len) > 2.0f));
  const bool f_stdev_len = qc_stdev && stdev_len != 0.0f &&
                           ((!is_bnd && __fdiv_rn(stdev_len, safe_len) > 1.0f) ||
                            stdev_len > p.qc_stdev_abs_max);
  const bool f_svlen_min = abs_svlen < p.minsvlen && !is_bnd &&
                           (support < 10 || p.minsvlen_hard_cap > 0);
  const bool f_strand_bnd = is_bnd && p.qc_bnd_filter_strand > 0 && n_strands < 2;

  const bool mosaic_off = p.mosaic == 0, mosaic_on = p.mosaic > 0;
  const float d_over_u = __fdiv_rn(cd, max_f(cu, 1e-6f));
  const float u_over_d = __fdiv_rn(cu, max_f(cd, 1e-6f));
  const float ud = __fadd_rn(cu, cd);
  const bool long_del = svtype == DEL && abs_len_f >= p.long_del_length && mosaic_off &&
                        abs_len_f <= p.dev_longer_del;
  const bool del_c1 = cc > __fmul_rn(ud, __fdiv_rn(p.long_del_coverage, 2.0f));
  const bool slope_dn = cu > cc && cc > cd, slope_up = cu < cc && cc < cd;
  const bool del_slope_fail = (slope_dn && d_over_u < 0.7f) || (slope_up && u_over_d < 0.7f);
  const bool del_ud_fail = cu > cd ? (0.5f > d_over_u || cc > cd)
                                   : (cu < cd && (0.5f > u_over_d || cu < cc));
  const bool f_cov_del = long_del && ((del_c1 && del_slope_fail) || del_ud_fail);
  const bool long_dup = svtype == DUP && abs_len_f >= p.long_dup_length && mosaic_off &&
                        abs_len_f <= p.dev_longer_dup;
  const bool dup_c1 = cc < __fmul_rn(ud, __fdiv_rn(p.long_dup_coverage, 2.0f));
  const bool dup_ud_fail = cu > cd ? (0.5f > d_over_u || cc < cd)
                                   : (cu < cd && (0.5f > u_over_d || cu > cc));
  const bool f_cov_dup = long_dup && dup_c1 && (del_slope_fail || dup_ud_fail);
  const bool f_cov_ins = svtype == INS && (cu < p.qc_coverage || cd < p.qc_coverage);

  const float nz_u = cu != 0.0f ? 1.0f : 0.0f, nz_d = cd != 0.0f ? 1.0f : 0.0f;
  const float n_ud = __fadd_rn(nz_u, nz_d);
  float cov_regional = n_ud > 0.0f
                           ? rintf(__fdiv_rn(__fadd_rn(__fmul_rn(cu, nz_u), __fmul_rn(cd, nz_d)),
                                             max_f(n_ud, 1.0f)))
                           : 0.0f;
  const float nz_s = cs != 0.0f ? 1.0f : 0.0f, nz_c = cc != 0.0f ? 1.0f : 0.0f;
  const float nz_e = ce != 0.0f ? 1.0f : 0.0f;
  const float n_sce = __fadd_rn(__fadd_rn(nz_s, nz_c), nz_e);
  const float sum_sce = __fadd_rn(__fadd_rn(__fmul_rn(cs, nz_s), __fmul_rn(cc, nz_c)),
                                  __fmul_rn(ce, nz_e));
  const float cov_sce = n_sce > 0.0f ? rintf(__fdiv_rn(sum_sce, max_f(n_sce, 1.0f))) : 0.0f;
  if (!(n_ud > 0.0f)) cov_regional = cov_sce;
  if (cov_regional == 0.0f) cov_regional = coverage_global;
  const float w = p.minsupport_auto_regional_coverage_weight;
  const float cov_blend = __fmaf_rn(cov_regional, w,
                                    __fmul_rn(coverage_global, __fsub_rn(1.0f, w)));
  const float min_support_auto = rintf(__fmaf_rn(p.minsupport_auto_mult, cov_blend,
                                                 p.minsupport_auto_base));
  const bool is_auto = p.minsupport_is_auto > 0;
  const float min_support = is_auto ? min_support_auto : p.minsupport_const;
  const float supp_rescaled = supp;  // the same rescale as genotype_batch's
  const bool f_support = mosaic_off && (is_auto ? supp_rescaled < min_support
                                                : support_f < min_support);

  const bool sv_is_mosaic = af <= p.mosaic_af_max;
  const bool mosaic_sv = mosaic_on && sv_is_mosaic;
  const bool f_cov_min_gt = cc < p.qc_coverage && gt_a + gt_b < 2 && svtype != DEL &&
                            abs_len_f > p.long_del_length;
  const bool f_nm = p.qc_nm > 0 && nm_mean > __fmul_rn(qc_nm_threshold, p.qc_nm_mult) &&
                    gt_b == 0;
  const bool skip_dup = svtype == DUP && af >= p.dev_min_dup_vaf;
  const bool f_mosaic_vaf_germ = mosaic_off && sv_is_mosaic && !skip_dup;
  const bool f_mosaic_support = mosaic_sv && support_f < p.mosaic_min_reads;
  const bool f_mosaic_len = mosaic_sv && !is_bnd && abs_len_f > p.max_svlen_mosaic;
  const bool is_long_ins = svtype == INS && svlen_f >= p.long_ins_length;
  const bool one_strand = n_strands < 2;
  const bool f_strand = p.qc_strand > 0 && !mosaic_sv && !is_bnd && !is_long_ins && one_strand;
  const bool f_strand_mosaic = mosaic_sv && p.mosaic_qc_strand > 0 && !is_bnd &&
                               !is_long_ins && one_strand &&
                               support_f >= p.mosaic_use_strand_thresholds;
  const bool f_mosaic_invdup = mosaic_sv && (svtype == INV || svtype == DUP) &&
                               svlen_f < p.mosaic_qc_invdup_min_length;
  const bool long_inv_exempt = svtype == INV && svlen_f > p.long_inv_length && !mosaic_sv;
  const bool f_cov_min = cc < p.qc_coverage && !(svtype == DEL || svtype == INS) &&
                         !long_inv_exempt;
  const bool f_mosaic_window = mosaic_sv && (af < p.mosaic_af_min || af > p.mosaic_af_max);
  const bool f_not_mosaic = mosaic_on && !sv_is_mosaic && p.mosaic_include_germline == 0;
  const bool f_gt = static_cast<float>(zscore) < p.genotype_min_z_score && mosaic_off &&
                    !(is_long_ins && p.detect_large_ins > 0) && !skip_dup;

  // the first failing check, in the cascade's order (qc_batch.py:174-197)
  int code = PASS;
  if (f_stdev_pos) code = STDEV_POS;
  else if (f_stdev_len) code = STDEV_LEN;
  else if (is_single) code = SINGLE_BREAK;
  else if (f_svlen_min) code = SVLEN_MIN;
  else if (f_strand_bnd) code = STRAND_BND;
  else if (f_cov_del) code = COV_CHANGE_DEL;
  else if (f_cov_dup) code = COV_CHANGE_DUP;
  else if (f_cov_ins) code = COV_CHANGE_INS;
  else if (f_support) code = SUPPORT_MIN;
  else if (gt_failed) code = GT_FAILED;
  else if (f_gt) code = GT;
  else if (f_cov_min_gt) code = COV_MIN_GT;
  else if (f_nm) code = ALN_NM;
  else if (f_mosaic_vaf_germ) code = MOSAIC_VAF;
  else if (f_mosaic_support) code = SUPPORT_MIN;
  else if (f_mosaic_len) code = SVLEN_MAX_MOSAIC;
  else if (f_strand) code = STRAND;
  else if (f_strand_mosaic) code = STRAND_MOSAIC;
  else if (f_mosaic_invdup) code = SVLEN_MIN_MOSAIC;
  else if (f_cov_min) code = COV_MIN;
  else if (f_mosaic_window) code = MOSAIC_VAF;
  else if (f_not_mosaic) code = NOT_MOSAIC_VAF;

  const int ints[kIntRows] = {cov_up, cov_start, cov_center, cov_end, cov_down, gt_a, gt_b,
                              gq, zscore, to_i32(__fsub_rn(coverage, supp)), to_i32(supp),
                              code};
  for (int r = 0; r < kIntRows; ++r) out_i[static_cast<size_t>(r) * n + c] = ints[r];
  out_f[static_cast<size_t>(kAf) * n + c] = af;
  out_f[static_cast<size_t>(kCoverage) * n + c] = coverage;
  out_f[static_cast<size_t>(kNm) * n + c] = nm_mean;
  out_b[static_cast<size_t>(kGtFailed) * n + c] = gt_failed;
  out_b[static_cast<size_t>(kQc) * n + c] = code == PASS;
  out_b[static_cast<size_t>(kPrecise) * n + c] = __fadd_rn(stdev_pos, stdev_len) < 25.0f;
  out_b[static_cast<size_t>(kClusterValid) * n + c] = cluster_valid;
}

}  // namespace

// The tail of one step over n candidate slots: statistics [n] (svtype,
// svlen, pos, support, lead_count, n_strands int32; stdev_pos, stdev_len
// float), the clustered elements' nm (float), valid (uint8) and cluster_id
// (int32) [n], n_clusters [1], support_sa [n], coverage [len], dyn [2]
// (coverage_global, qc_nm_threshold) or null; run_start int32 [n + 1]
// scratch; outputs out_i [12, n], out_f [3, n], out_b [4, n] (bool bytes)
// in the rows of ops/candidate_tail.py. Two launches: the run starts, then the tail.
// Returns the first launch error.
extern "C" int candidate_tail(const int32_t* svtype, const int32_t* svlen, const int32_t* pos,
                              const int32_t* support, const int32_t* lead_count,
                              const int32_t* n_strands, const float* stdev_pos,
                              const float* stdev_len, const float* nm, const uint8_t* valid,
                              const int32_t* cluster_id, const int32_t* n_clusters,
                              const int32_t* support_sa, const int32_t* cov, const float* dyn,
                              int32_t* run_start, int32_t* out_i, float* out_f, uint8_t* out_b,
                              int n, int len, int region_offset, int binsize, TailParams p,
                              cudaStream_t s) {
  if (n <= 0 || len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = launch_runs(cluster_id, run_start, n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  candidate_tail_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      svtype, svlen, pos, support, lead_count, n_strands, stdev_pos, stdev_len, nm, valid,
      cluster_id, run_start, n_clusters, support_sa, cov, dyn, out_i, out_f, out_b, n, len,
      region_offset, binsize, p);
  return static_cast<int>(cudaGetLastError());
}

// The run pass alone (the kernel tail_runs, the first launch of
// candidate_tail): cluster_id int32 [n] (ascending) to run_start int32
// [n + 1], of which the entries 0..clamp(cluster_id[n - 1] + 1, 0, n) are
// written; on stream s. For the tests and the timing tools. Returns the
// launch's error.
extern "C" int tail_run_starts(const int32_t* cluster_id, int32_t* run_start, int n,
                               cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_runs(cluster_id, run_start, n, s));
}
