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
// Design. Boundaries only turn off, so a round that changes nothing is a
// fixed point and every later round would change nothing: the entry point
// enqueues all 32 rounds on the stream at once, each two kernels, and a
// round whose predecessor changed nothing exits at its first instruction
// (the per-round flags `changed`, zeroed first). No host synchronisation
// anywhere; the caller derives the round count from the flags afterwards.
//   relax_metrics: a thread per element; the thread of a segment head
//     walks its segment [i, e) to the next boundary (no scan of segment
//     ids is needed: a segment is its head's contiguous run), writes the
//     segment's start and end bp, repeat flag and range_metrics at slot i,
//     and prev_head[e] = i for the head after it.
//   relax_merge: a thread per element; a head i > 0 that is valid and of
//     its predecessor's svtype evaluates m1 | m2 | m3 against the segment
//     at prev_head[i] and clears bound[i]. It reads only what relax_metrics
//     wrote and its own boundary, so the update is in place without races.
// A segment is all valid or all invalid: invalid slots sort last, the seed
// boundary before the first of them is never cleared (a merge needs a valid
// head), so the invalid tail only splits further. A valid segment's
// metrics are therefore range_metrics over its whole run (the sweep's
// float64 pick-order sums, range_metrics.cuh); an invalid head writes the
// empty segment's values and never merges.
//
// Float32 arithmetic through __f*_rn (never contracted into an FMA), as the
// plain version (ops/merge_relax.py::merge_step_plain) rounds it; int32
// differences wrap, as XLA's do.
//
// Bound: latency. A round is two launches over n slots; each head's walk
// is its segment's length, and a round moves about 20 bytes a slot; the
// rounds that run are the data's (2 on well-separated sites, up to 32).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "range_metrics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 32;  // MERGE_ITERS_MAX
constexpr int kSvtypeBnd = 4;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ bool skipped(const int32_t* changed, int r) {
  return r > 0 && changed[r - 1] == 0;
}

__global__ void __launch_bounds__(kThreads) relax_metrics(
    const float* __restrict__ posf, const float* __restrict__ svlenf,
    const int32_t* __restrict__ bin, const uint8_t* __restrict__ repeat,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ bound,
    int32_t* start_bp, int32_t* end_bp, int32_t* prev_head, float* msv, float* sd,
    uint8_t* rep, const int32_t* changed, int n, int binsize, int r) {
  if (skipped(changed, r)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !bound[i]) return;
  if (!valid[i]) {
    // the invalid tail: the empty segment's values; nothing after it merges
    start_bp[i] = INT_MAX;
    end_bp[i] = -1;
    msv[i] = 0.0f;
    sd[i] = 0.0f;
    rep[i] = 0;
    return;
  }
  int lo_bp = INT_MAX, hi_bp = INT_MIN;
  uint8_t any_rep = 0;
  int e = i;
  do {
    const int b = wrap_mul(bin[e], binsize);
    lo_bp = min(lo_bp, b);
    hi_bp = max(hi_bp, static_cast<int>(static_cast<unsigned>(b) +
                                        static_cast<unsigned>(binsize)));
    any_rep |= repeat[e];
    ++e;
  } while (e < n && !bound[e]);
  if (e < n) prev_head[e] = i;
  start_bp[i] = lo_bp;
  end_bp[i] = hi_bp;
  rep[i] = any_rep ? 1 : 0;
  float m, s;
  sniffles::range_metrics(posf, svlenf, n, i, e, &m, &s);
  msv[i] = m;
  sd[i] = s;
}

__global__ void __launch_bounds__(kThreads) relax_merge(
    const int32_t* __restrict__ svtype, const uint8_t* __restrict__ valid, uint8_t* bound,
    const int32_t* __restrict__ start_bp, const int32_t* __restrict__ end_bp,
    const int32_t* __restrict__ prev_head, const float* __restrict__ msv,
    const float* __restrict__ sd, const uint8_t* __restrict__ rep, int32_t* changed, int n,
    float cluster_r, float repeat_h, float repeat_h_max, int merge_bnd, int global_repeat,
    int r) {
  if (skipped(changed, r)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= 0 || i >= n || !bound[i] || !valid[i] || svtype[i] != svtype[i - 1]) return;
  const int p = prev_head[i];
  const int inner = wrap_sub(start_bp[i], end_bp[p]);
  const int outer = wrap_sub(end_bp[i], start_bp[p]);
  const float sd_pair = fminf(sd[i], sd[p]);
  const bool m1 = static_cast<float>(inner) <= __fmul_rn(sd_pair, cluster_r);
  const bool rep_pair = rep[i] || rep[p] || global_repeat;
  const float h_lim = fminf(repeat_h_max,
                            __fmul_rn(__fadd_rn(fabsf(msv[i]), fabsf(msv[p])), repeat_h));
  const bool m2 = rep_pair && static_cast<float>(outer) <= h_lim;
  const bool m3 = svtype[i] == kSvtypeBnd && inner <= merge_bnd;
  if (m1 || m2 || m3) {
    bound[i] = 0;
    changed[r] = 1;
  }
}

}  // namespace

// One relaxation over n sorted slots: bound (uint8 [n]) holds the seed
// boundaries on entry and the final ones on return; start_bp, end_bp,
// prev_head, msv, sd, rep are [n] scratch; changed is int32 [32] (round r
// changed a boundary). Returns the first launch error, or 0.
extern "C" int merge_relax(const float* posf, const float* svlenf, const int32_t* svtype,
                           const int32_t* bin, const uint8_t* repeat, const uint8_t* valid,
                           uint8_t* bound, int32_t* start_bp, int32_t* end_bp,
                           int32_t* prev_head, float* msv, float* sd, uint8_t* rep,
                           int32_t* changed, int n, int binsize, float cluster_r,
                           float repeat_h, float repeat_h_max, int merge_bnd,
                           int global_repeat, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(changed, 0, kRounds * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  for (int r = 0; r < kRounds; ++r) {
    relax_metrics<<<blocks, kThreads, 0, s>>>(posf, svlenf, bin, repeat, valid, bound,
                                              start_bp, end_bp, prev_head, msv, sd, rep,
                                              changed, n, binsize, r);
    relax_merge<<<blocks, kThreads, 0, s>>>(svtype, valid, bound, start_bp, end_bp,
                                            prev_head, msv, sd, rep, changed, n, cluster_r,
                                            repeat_h, repeat_h_max, merge_bnd,
                                            global_repeat, r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
