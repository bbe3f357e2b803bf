// Batched exact Levenshtein distance on Hopper (sm_90a): one thread block
// per string pair, an anti-diagonal wavefront over the DP matrix.
//
// Replaces the TPU kernel sniffles_tpu/ops/edit_distance_jax.py::_ed_kernel
// (called through edit_distance_batch_pallas). That kernel advances a tile
// of 128 pairs through all 2L wavefront steps in lockstep, with the DP row
// index on the vector lanes, and harvests each answer at t == la + lb. Here
// pairs are independent blocks, so each block stops at its own t = la + lb.
//
// Design:
//   * diagonal t holds D(i, t - i) at index i, for the rows
//     i in [max(0, t - lb), min(t, la)]; threads stride over those rows;
//   * D(i, j) = min(D(i-1, j) + 1, D(i, j-1) + 1, D(i-1, j-1) + (a[i-1] != b[j-1]))
//     reads diagonals t-1 (indices i-1 and i) and t-2 (index i-1), so three
//     rotating diagonals live in shared memory, with __syncthreads() between
//     steps; the boundary D(0, t) = D(t, 0) = t needs no sentinel;
//   * both sequences are staged in shared memory once per pair.
// Shared memory per block: 3 (L + 1) int32 + 2 L bytes (57,356 B at
// L = 4096, above the 48 KB static limit, hence dynamic shared memory).
//
// Bound: about 6 integer operations per DP cell (one compare, three adds,
// two mins) over sum (la + 1)(lb + 1) cells; bytes moved are negligible
// (la + lb input bytes and 4 output bytes per pair), so the card's integer
// rate bounds it. Shorter diagonals leave threads idle at each step, and
// every step pays a block barrier: a Myers bit-vector kernel with a warp
// per pair would do fewer operations per cell.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ed_wavefront_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                    const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
                    int32_t* __restrict__ out, int L) {
  extern __shared__ int32_t smem[];
  const int pair = blockIdx.x;
  const int m = la[pair];
  const int n = lb[pair];

  int32_t* prev2 = smem;                // diagonal t - 2
  int32_t* prev1 = smem + (L + 1);      // diagonal t - 1
  int32_t* cur = smem + 2 * (L + 1);    // diagonal t
  uint8_t* sa = reinterpret_cast<uint8_t*>(smem + 3 * (L + 1));
  uint8_t* sb = sa + L;

  const uint8_t* ga = a + static_cast<size_t>(pair) * L;
  const uint8_t* gb = b + static_cast<size_t>(pair) * L;
  for (int k = threadIdx.x; k < m; k += blockDim.x) sa[k] = ga[k];
  for (int k = threadIdx.x; k < n; k += blockDim.x) sb[k] = gb[k];
  __syncthreads();

  for (int t = 0; t <= m + n; ++t) {
    const int lo = max(0, t - n);
    const int hi = min(t, m);
    for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
      int32_t d;
      if (i == 0 || i == t) {
        d = t;  // D(0, t) or D(t, 0)
      } else {
        const int32_t cost = sa[i - 1] != sb[t - i - 1];
        d = min(min(prev1[i - 1], prev1[i]) + 1, prev2[i - 1] + cost);
      }
      cur[i] = d;
    }
    __syncthreads();
    int32_t* spent = prev2;
    prev2 = prev1;
    prev1 = cur;
    cur = spent;
  }
  if (threadIdx.x == 0) out[pair] = prev1[m];
}

}  // namespace

// a, b: [B, L] uint8 row-major (padded); la, lb: [B] int32 lengths with
// 0 <= la, lb <= L; out: [B] int32. Launches on stream s and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int ed_wavefront(const uint8_t* a, const uint8_t* b, const int32_t* la,
                            const int32_t* lb, int32_t* out, int B, int L,
                            cudaStream_t s) {
  if (B <= 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(L + 1) * sizeof(int32_t) +
                      2 * static_cast<size_t>(L);
  cudaError_t err = cudaFuncSetAttribute(
      ed_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ed_wavefront_kernel<<<B, kThreads, smem, s>>>(a, b, la, lb, out, L);
  return static_cast<int>(cudaGetLastError());
}
