// Shared by the kernels that compute the reference's compute_metrics over
// a cluster (cluster.py:48-61) as one contiguous range of sorted elements:
// merge_sweep.cu (the exact sweep) and merge_relax.cu (the engine's
// relaxation). Float32 arithmetic through the __f*_rn intrinsics, which
// nvcc never contracts into a fused multiply-add; the pick sums in double,
// in pick order, rounded once (the plain versions' seg_sum_f32).
#pragma once

#include <cstdint>

namespace sniffles {

constexpr int kPickCap = 256;  // stride picks top out at 199

__device__ __forceinline__ int clamp_slot(int x, int n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

// compute_metrics over the contiguous element range [lo, hi): the
// reference's stride subsample of at most ~max_n = 100 leads, the mean
// svlen divided by max_n, the sample stdev over the actual picks.
// All divisions here are of non-negative values, so C++'s truncating
// division is the JAX package's floor division. The positions and
// lengths are float32, or int32 taken as float32 (round to nearest, as
// torch's .to(float32)): T is float or int32_t.
template <typename T>
__device__ inline void range_metrics(const T* __restrict__ posf, const T* __restrict__ svlenf,
                                     int n, int lo, int hi, float* mean_sv, float* sd) {
  const int L = hi - lo > 0 ? hi - lo : 0;
  const int nn = L < 100 ? L : 100;
  const int q = L / (nn > 1 ? nn : 1);
  const int stride = q > 1 ? q : 1;
  double sum_sv = 0.0, sum_ps = 0.0;
  int npicks = 0;
  for (int k = 0; k < kPickCap && k * stride < L; ++k) {
    const int idx = clamp_slot(lo + k * stride, n);
    sum_sv += static_cast<double>(static_cast<float>(svlenf[idx]));
    sum_ps += static_cast<double>(static_cast<float>(posf[idx]));
    ++npicks;
  }
  *mean_sv = __fdiv_rn(static_cast<float>(sum_sv), static_cast<float>(nn > 1 ? nn : 1));
  const float mean_ps = __fdiv_rn(static_cast<float>(sum_ps),
                                  static_cast<float>(npicks > 1 ? npicks : 1));
  double ss = 0.0;
  for (int k = 0; k < npicks; ++k) {
    const float dev = __fsub_rn(static_cast<float>(posf[clamp_slot(lo + k * stride, n)]),
                                mean_ps);
    ss += static_cast<double>(__fmul_rn(dev, dev));
  }
  *sd = npicks >= 2
            ? __fsqrt_rn(__fdiv_rn(static_cast<float>(ss),
                                   static_cast<float>(npicks - 1 > 1 ? npicks - 1 : 1)))
            : 0.0f;
}

}  // namespace sniffles
