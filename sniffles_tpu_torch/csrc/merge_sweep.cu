// The exact cluster merge sweep of one call task on Hopper (sm_90a): one
// thread walks the host's sequential backtracking sweep (reference:
// cluster.py:277-308) over the task's seed clusters, on the device.
//
// Replaces the XLA program sniffles_tpu/ops/clustering.py::_exact_merge_sweep,
// a lax.while_loop (the loop body :194-252, range_metrics :153-173). A loop
// driven from the host would launch dozens of small kernels and wait for the
// loop condition at every step; this kernel keeps the whole loop on the card.
//
// State, in the JAX package's layout (one slot per seed cluster, n slots,
// the first nseeds live; the wrapper in ops/clustering.py builds it with
// torch ops and the thread updates it in place in global memory):
//   nxt, prv      the doubly linked list of surviving clusters (n = none)
//   hi, end_bp    the cluster's element range end and its last bin's end
//   rep           the cluster's tandem-repeat flag
//   msv, sd       compute_metrics of the cluster: subsampled mean svlen,
//                 sample stdev of the subsampled start positions
//   alive         0 once the cluster was merged into its left neighbour
// and the pointer pair (c, i): the current cluster and the host's list
// index, whose i = max(0, i - 2) + 1 after a merge is reproduced exactly
// (the head quirk at i = 0 and 1, the backtrack for i >= 2). Each svtype's
// chain starts at i = 0: every svtype's first cluster is the task's (the
// JAX package's head_freeze is all true outside its mesh shards). The
// iteration cap 4n + 8 is the JAX package's.
//
// Arithmetic: the criteria and the metrics are float32 as in the JAX
// package, written with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never
// contracts into an FMA, so that every rounding is the plain version's, and
// with IEEE division and square root (no fast math). The sums of the stride picks of
// positions and lengths (integer-valued terms) and of the squared
// deviations accumulate in double in index order and round once to float,
// as the plain version does (merge_sweep_plain): the integer-valued sums
// are exact in double, so their order cannot matter.
//
// Bound: latency. The sweep is a chain of dependent steps (about one step
// a seed plus two a merge, each a handful of dependent loads), so the card
// cannot do better than one step after the other; bytes (each slot read
// and written once) and operations are far below a microsecond. A thread
// per svtype (the chains of different svtypes never interact) and a thread
// per sound-cut segment (the JAX package's grid sweep) are the redesigns
// that shorten the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSvtypeBnd = 4;
constexpr int kPickCap = 256;   // stride picks top out at 199

__device__ __forceinline__ int clamp_slot(int x, int n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

// compute_metrics over the contiguous element range [lo, hi): the
// reference's stride subsample of at most ~max_n = 100 leads, the mean
// svlen divided by max_n, the sample stdev over the actual picks.
// All divisions here are of non-negative values, so C++'s truncating
// division is the JAX package's floor division.
__device__ void range_metrics(const float* __restrict__ posf,
                              const float* __restrict__ svlenf, int n, int lo, int hi,
                              float* mean_sv, float* sd) {
  const int L = hi - lo > 0 ? hi - lo : 0;
  const int nn = L < 100 ? L : 100;
  const int q = L / (nn > 1 ? nn : 1);
  const int stride = q > 1 ? q : 1;
  double sum_sv = 0.0, sum_ps = 0.0;
  int npicks = 0;
  for (int k = 0; k < kPickCap && k * stride < L; ++k) {
    const int idx = clamp_slot(lo + k * stride, n);
    sum_sv += static_cast<double>(svlenf[idx]);
    sum_ps += static_cast<double>(posf[idx]);
    ++npicks;
  }
  *mean_sv = __fdiv_rn(static_cast<float>(sum_sv), static_cast<float>(nn > 1 ? nn : 1));
  const float mean_ps = __fdiv_rn(static_cast<float>(sum_ps),
                                  static_cast<float>(npicks > 1 ? npicks : 1));
  double ss = 0.0;
  for (int k = 0; k < npicks; ++k) {
    const float dev = __fsub_rn(posf[clamp_slot(lo + k * stride, n)], mean_ps);
    ss += static_cast<double>(__fmul_rn(dev, dev));
  }
  *sd = npicks >= 2
            ? __fsqrt_rn(__fdiv_rn(static_cast<float>(ss),
                                   static_cast<float>(npicks - 1 > 1 ? npicks - 1 : 1)))
            : 0.0f;
}

__global__ void merge_sweep_kernel(
    const int32_t* __restrict__ seed_type, const int32_t* __restrict__ start_bp,
    const int32_t* __restrict__ lo, const float* __restrict__ posf,
    const float* __restrict__ svlenf, const int32_t* __restrict__ nseeds_ptr,
    int32_t* nxt, int32_t* prv, int32_t* hi, int32_t* end_bp, int32_t* rep,
    float* msv, float* sd, int32_t* alive, int32_t* iters, int n, float cluster_r,
    float repeat_h, float repeat_h_max, float merge_bnd, int global_repeat) {
  const int sent = n;
  const int nseeds = *nseeds_ptr;
  if (nseeds <= 0) {
    *iters = 0;
    return;
  }
  const int64_t max_iters = 4LL * n + 8;
  int c = 0, i = 0, cur_t = seed_type[0];
  int64_t it = 0;
  while (c < sent && it < max_iters) {
    const int ct = seed_type[c];
    if (ct != cur_t) i = 0;
    const int r = nxt[c];
    const int rc = clamp_slot(r, n);
    bool merge = false;
    if (r < sent && seed_type[rc] == ct) {
      // criteria, as the host evaluates them (cluster.py:266-275)
      const float inner = static_cast<float>(start_bp[rc] - end_bp[c]);
      const float outer = static_cast<float>(end_bp[rc] - start_bp[c]);
      const bool m1 = inner <= __fmul_rn(fminf(sd[c], sd[rc]), cluster_r);
      const bool rep_pair = rep[c] > 0 || rep[rc] > 0 || global_repeat != 0;
      const float h_lim = fminf(repeat_h_max,
                                __fmul_rn(__fadd_rn(fabsf(msv[c]), fabsf(msv[rc])), repeat_h));
      const bool m2 = rep_pair && outer <= h_lim;
      const bool m3 = ct == kSvtypeBnd && inner <= merge_bnd;
      merge = m1 || m2 || m3;
    }
    int c2, i2;
    if (merge) {
      const int new_hi = hi[rc];
      float mean_new, sd_new;
      range_metrics(posf, svlenf, n, lo[c], new_hi, &mean_new, &sd_new);
      const int rn = nxt[rc];
      hi[c] = new_hi;
      end_bp[c] = end_bp[rc];
      rep[c] = rep[c] | rep[rc];
      msv[c] = mean_new;
      sd[c] = sd_new;
      nxt[c] = rn;
      if (rn < sent) prv[rn] = c;
      alive[rc] = 0;
      // pointer transition (host: i = max(0, i-2) + 1 after a merge):
      // i == 0 -> the node after the merged head; i == 1 -> the merged
      // node itself; i >= 2 -> the node before it (backtrack)
      const int p = prv[c];
      const bool p_ok = p < sent && seed_type[clamp_slot(p, n)] == ct;
      if (i == 0) {
        c2 = rn;
        i2 = 1;
      } else if (i == 1) {
        c2 = c;
        i2 = 1;
      } else {
        c2 = p_ok ? p : c;
        i2 = p_ok ? i - 1 : i;
      }
    } else {
      c2 = r;
      i2 = i + 1;
    }
    c = c2;
    i = i2;
    cur_t = ct;
    ++it;
  }
  *iters = static_cast<int32_t>(it);
}

}  // namespace

extern "C" int merge_sweep(const int32_t* seed_type, const int32_t* start_bp,
                           const int32_t* lo, const float* posf, const float* svlenf,
                           const int32_t* nseeds, int32_t* nxt, int32_t* prv, int32_t* hi,
                           int32_t* end_bp, int32_t* rep, float* msv, float* sd,
                           int32_t* alive, int32_t* iters, int n, float cluster_r,
                           float repeat_h, float repeat_h_max, float merge_bnd,
                           int global_repeat, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  merge_sweep_kernel<<<1, 1, 0, s>>>(seed_type, start_bp, lo, posf, svlenf, nseeds, nxt,
                                     prv, hi, end_bp, rep, msv, sd, alive, iters, n,
                                     cluster_r, repeat_h, repeat_h_max, merge_bnd,
                                     global_repeat);
  return static_cast<int>(cudaGetLastError());
}
