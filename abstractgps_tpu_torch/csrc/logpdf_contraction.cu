// logpdf_contraction: the cotangents of F = <C, s2 * g(d^2(x', x'))> for the logpdf cotangent
//   C = 1/2 (alpha_g alpha^T - gsum * Tsym),   Tsym = T + T^T - diag T,   T = tril(K^-1),
// built tile by tile in shared memory and never stored: returns s2bar = sum C*g, the map
// hyperparameter's bar sum s2*C*dg/dp, and x'bar = 4 * row part (C is symmetric, so the total is
// twice the row-operand cotangent of the symmetric sweep).
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:359 (logpdf_contraction, pallas_call at :458).
// Bound on the H100: bytes. Every tile reads one 64 x 64 tile of T: the lower tiles directly,
// the upper ones as the mirrored lower tile, so each lower tile of T is read twice and the whole
// sweep moves n^2 * 4 bytes of T (268 MB at n = 8192; the strict upper triangle of T is never
// read). alpha_g alpha^T is a rank-q (q = 1 on the main path) outer product formed per entry from
// the two (n, q) operands, with no library product. Design: the row-block sweep of
// gram_sweep.cuh with this loader; the two scalar sums, whose sigma^2 part nearly cancels
// (1/2 sum alpha g alpha^T K against 1/2 gsum tr(K^-1 K)), accumulate in FP64 per thread, per CTA
// in a fixed tree and across CTAs in block order (the TPU kernel's Neumaier-compensated f32
// sums, made exact to f32 products), with no atomics: the same inputs give the same bits.
#include "gram_sweep.cuh"

namespace {

using agp::kSweepBlock;
using agp::kSweepTile;

struct LoadLogpdfCot {
  const float* ag;
  const float* a;
  const float* T;
  long ldt;
  int n, q;
  float gsum;

  __device__ void operator()(int row0, int col0, int tid, float (*cs)[kSweepTile + 1]) const {
    const bool lower = row0 >= col0, diag = row0 == col0;
    for (int e = tid; e < kSweepTile * kSweepTile; e += kSweepBlock) {
      const int u = e / kSweepTile, v = e % kSweepTile;
      if (lower) {  // T[row0 + u][col0 + v]
        const bool in = row0 + u < n && col0 + v < n;
        cs[u][v] = in ? T[(long)(row0 + u) * ldt + col0 + v] : 0.f;
      } else {  // Tsym[row0 + v][col0 + u] = T[col0 + u][row0 + v]
        const bool in = row0 + v < n && col0 + u < n;
        cs[v][u] = in ? T[(long)(col0 + u) * ldt + row0 + v] : 0.f;
      }
    }
    __syncthreads();
    if (diag) {  // mirror the lower triangle of the diagonal tile into its upper one
      for (int e = tid; e < kSweepTile * kSweepTile; e += kSweepBlock) {
        const int u = e / kSweepTile, v = e % kSweepTile;
        if (v > u) cs[u][v] = cs[v][u];
      }
      __syncthreads();
    }
    for (int e = tid; e < kSweepTile * kSweepTile; e += kSweepBlock) {
      const int u = e / kSweepTile, v = e % kSweepTile;
      const int r = row0 + u, c = col0 + v;
      float aa = 0.f;
      if (r < n && c < n)
        for (int k = 0; k < q; ++k) aa = fmaf(ag[(long)r * q + k], a[(long)c * q + k], aa);
      cs[u][v] = 0.5f * (aa - gsum * cs[u][v]);
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kSweepBlock)
    logpdf_contraction_kernel(const float* __restrict__ x, const float* __restrict__ ag,
                              const float* __restrict__ a, const float* __restrict__ T, long ldt,
                              const float* __restrict__ scal, float* __restrict__ xbar,
                              double* __restrict__ partial, int n, int d, int q, int family) {
  __shared__ agp::SweepSmem sm;
  const float p0 = (family == 4 || family == 5) ? scal[0] : 0.f;
  const float s2 = scal[1], gsum = scal[2];
  const LoadLogpdfCot load{ag, a, T, ldt, n, q, gsum};
  agp::row_block_sweep(x, x, n, n, d, family, p0, s2, 1, 4.f, load, xbar, partial, sm);
}

}  // namespace

// x' (n, d), alpha_g and alpha (n, q), T (n, n) with row stride ldt (lower triangle read),
// scal = [map hyperparameter, s2, gsum]. xbar (n, d) is written whole; partial holds 2 doubles
// per 64-row block; sums (2) gets [hyperparameter bar, s2bar].
extern "C" int agp_logpdf_contraction(const float* x, const float* ag, const float* a,
                                      const float* T, long ldt, const float* scal, float* xbar,
                                      double* partial, double* sums, int n, int d, int q,
                                      int family, cudaStream_t stream) {
  if (family < 0 || family > 6 || n <= 0 || d <= 0 || q <= 0 || ldt < n)
    return (int)cudaErrorInvalidValue;
  const int nblocks = (n + kSweepTile - 1) / kSweepTile;
  const dim3 block(agp::kSweepThreads, agp::kSweepThreads);
  logpdf_contraction_kernel<<<nblocks, block, 0, stream>>>(x, ag, a, T, ldt, scal, xbar, partial,
                                                           n, d, q, family);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  agp::reduce_partials_kernel<<<1, 32, 0, stream>>>(partial, nblocks, sums);
  return (int)cudaGetLastError();
}
