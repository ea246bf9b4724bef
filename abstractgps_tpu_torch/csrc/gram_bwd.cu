// gram_bwd: the VJP of the fused isotropic gram K = g(d^2(x, z)) against a cotangent C: the row
// operand's cotangent xbar and the map hyperparameter's bar sum C * dg/dp.
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:185 (_bwd_pass, pallas_call at :289), driven by
// _fused_vjp_bwd (:325). Modes, as there:
//   0  C is (n, m): xbar of x; z's cotangent is the same sweep with the roles swapped and
//   1  C read transposed (C is (m, n), the row operand is the original column operand);
//   2  z is x (symmetric gram, n = m): one sweep over C + C^T gives the total xbar, and the
//      hyperparameter bar is doubled (the wrapper halves it).
// Bound on the H100: bytes. It reads C once per pass (n*m*4 bytes; C + C^T reads the n^2
// cotangent twice, once transposed) and does ~25 + 3*D flops per entry at D = 8, well under the
// FP32 rate for the bytes moved. Design: the row-block sweep of gram_sweep.cuh (one CTA per 64
// rows, a loop over the 64-wide column tiles, d^2 rebuilt with FP32 FMA, the VJP in the
// epilogue, w*(x_i - z_j) summed in shared memory, no atomics, FP64 scalar sums), then one
// small launch adds the per-CTA partials in order. Transposed reads stage the tile through
// shared memory so the global loads stay coalesced.
#include "gram_sweep.cuh"

namespace {

using agp::kSweepBlock;
using agp::kSweepTile;

struct LoadC {
  const float* C;
  long ldc;
  int n, m, mode;

  __device__ void operator()(int row0, int col0, int tid, float (*cs)[kSweepTile + 1]) const {
    for (int e = tid; e < kSweepTile * kSweepTile; e += kSweepBlock) {
      const int a = e / kSweepTile, b = e % kSweepTile;
      if (mode == 1) {  // tile entry (b, a) is C[col0 + a][row0 + b]
        const bool in = row0 + b < n && col0 + a < m;
        cs[b][a] = in ? C[(long)(col0 + a) * ldc + row0 + b] : 0.f;
      } else {
        const bool in = row0 + a < n && col0 + b < m;
        cs[a][b] = in ? C[(long)(row0 + a) * ldc + col0 + b] : 0.f;
      }
    }
    __syncthreads();
    if (mode == 2) {  // + C^T
      for (int e = tid; e < kSweepTile * kSweepTile; e += kSweepBlock) {
        const int a = e / kSweepTile, b = e % kSweepTile;
        if (row0 + b < n && col0 + a < m) cs[b][a] += C[(long)(col0 + a) * ldc + row0 + b];
      }
      __syncthreads();
    }
  }
};

__global__ void __launch_bounds__(kSweepBlock)
    gram_bwd_kernel(const float* __restrict__ x, const float* __restrict__ z,
                    const float* __restrict__ C, long ldc, const float* __restrict__ params,
                    float* __restrict__ xbar, double* __restrict__ partial, int n, int m, int d,
                    int family, int symmetric, int mode) {
  __shared__ agp::SweepSmem sm;
  const float p0 = (family == 4 || family == 5) ? params[0] : 0.f;
  const LoadC load{C, ldc, n, m, mode};
  agp::row_block_sweep(x, z, n, m, d, family, p0, 1.f, symmetric, 2.f, load, xbar, partial, sm);
}

}  // namespace

// x (n, d), z (m, d), C as the mode says with row stride ldc, params: the map's hyperparameter
// buffer. xbar (n, d) is written whole; partial holds 2 doubles per 64-row block; sums (2) gets
// [sum C dg/dp, sum C g].
extern "C" int agp_gram_bwd(const float* x, const float* z, const float* C, long ldc,
                            const float* params, float* xbar, double* partial, double* sums, int n,
                            int m, int d, int family, int symmetric, int mode,
                            cudaStream_t stream) {
  if (family < 0 || family > 6 || n <= 0 || m <= 0 || d <= 0 || mode < 0 || mode > 2 ||
      (mode == 2 && n != m))
    return (int)cudaErrorInvalidValue;
  const int nblocks = (n + kSweepTile - 1) / kSweepTile;
  const dim3 block(agp::kSweepThreads, agp::kSweepThreads);
  gram_bwd_kernel<<<nblocks, block, 0, stream>>>(x, z, C, ldc, params, xbar, partial, n, m, d,
                                                 family, symmetric, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  agp::reduce_partials_kernel<<<1, 32, 0, stream>>>(partial, nblocks, sums);
  return (int)cudaGetLastError();
}
