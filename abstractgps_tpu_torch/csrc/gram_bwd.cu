// gram_bwd: the VJP of the fused isotropic gram K = g(d^2(x, z)) against a cotangent C: the row
// operand's cotangent xbar_r = 2 sum_c w_rc (x_r - z_c), w = C * dg/dd^2, and the map
// hyperparameter's bar sum C * dg/dp.
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:185 (_bwd_pass, pallas_call at :289), driven by
// _fused_vjp_bwd (:325). Modes, as there:
//   0  C is (n, m): xbar of x; z's cotangent is the same sweep with the roles swapped and
//   1  C read transposed (C is (m, n), the row operand is the original column operand);
//   2  z is x (symmetric gram, n = m): one sweep over C + C^T gives the total xbar, and the
//      hyperparameter bar is doubled (the wrapper halves it).
// Bound on the H100: bytes. It reads C once per pass (n*m*4 bytes; C + C^T reads the n^2
// cotangent twice) and does ~6D + 15 operations per entry at D = 8, under the FP32 rate for
// the bytes moved.
//
// Design: the column-split sweep of gram_sweep.cuh (grid of 64-row blocks x S column splits,
// S = fused_gram.column_split_count(n, m); cp.async double buffer; one row and 16 columns a
// thread with x-bar in registers; batches of 8 entries; per-split partials summed in a fixed
// order), with this file's cotangent policy: per 64 x 64 tile the cotangent (mode 2: C[I, J]
// and C[J, I]) lands row-major as C's rows lie, so the copies stay coalesced, and a
// transposed tile is read transposed from shared memory. Row strides of 68 floats ([row][col],
// = 4 mod 32 banks) and 72 ([col][row], = 8 mod 32) keep each warp's reads on distinct banks;
// mode 2's mirrored tile also takes 68, at a 2-way conflict on its reads, so that three CTAs
// fit an SM. Shared memory per CTA at D <= 8: 38.9 KB (mode 0), 41.0 KB (mode 1), 73.7 KB
// (mode 2).
#include "gram_sweep.cuh"

namespace {

using agp::kColStride;
using agp::kRowStride;
using agp::kSweepTile;

template <int kMode>
struct GramBwdCot {
  static constexpr int kPrim = kSweepTile * (kMode == 1 ? kColStride : kRowStride);
  static constexpr int kFloats = kPrim + (kMode == 2 ? kSweepTile * kRowStride : 0);
  static constexpr bool kWithG = false;
  static constexpr float kXScale = 2.f;

  const float* C;
  long ldc;
  int n, m, vec;

  struct State {};
  __device__ State begin(int) const { return {}; }

  __device__ void fetch(float* s, int row0, int col0, int tid) const {
    if (kMode == 1)  // tile entry (r, c) = C[col0 + c][row0 + r], landed as [c][r]
      agp::fetch_tile(s, kColStride, C, ldc, col0, row0, m, n, vec, tid);
    else
      agp::fetch_tile(s, kRowStride, C, ldc, row0, col0, n, m, vec, tid);
    if (kMode == 2)  // C[J, I], landed as [c][r]
      agp::fetch_tile(s + kPrim, kRowStride, C, ldc, col0, row0, n, n, vec, tid);
  }

  __device__ float entry(const State&, const float* s, int rl, int cl, int, int) const {
    float ct = (kMode == 1) ? s[cl * kColStride + rl] : s[rl * kRowStride + cl];
    if (kMode == 2) ct += s[kPrim + cl * kRowStride + rl];
    return ct;
  }

  __device__ float scaled(const State&, float ct) const { return ct; }
};

template <int kMode>
int launch_mode(const float* x, const float* z, const float* C, long ldc, const float* params,
                float* xbar, float* part_x, double* part_p, double* pbar, int n,
                int m, int d, int family, int symmetric, int splits, cudaStream_t stream) {
  const int vec = ldc % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const GramBwdCot<kMode> cot{C, ldc, n, m, vec};
  return agp::launch_split_sweep(cot, x, z, params, xbar, part_x, part_p, pbar, n, m, d,
                                 family, symmetric, splits, stream);
}

}  // namespace

// x (n, d), z (m, d), C as the mode says with row stride ldc, params: the map's
// hyperparameter buffer; splits: the column splits S (1 <= S <= column tiles). Scratch:
// part_x (S, n, d) f32, part_p (row blocks * S) f64. Writes xbar (n, d) whole
// and pbar[0] = sum C dg/dp.
extern "C" int agp_gram_bwd(const float* x, const float* z, const float* C, long ldc,
                            const float* params, float* xbar, float* part_x,
                            double* part_p, double* pbar, int n, int m, int d, int family,
                            int symmetric, int mode, int splits, cudaStream_t stream) {
  const int tiles = (m + kSweepTile - 1) / kSweepTile;
  if (family < 0 || family > 6 || n <= 0 || m <= 0 || d <= 0 || mode < 0 || mode > 2 ||
      (mode == 2 && n != m) || splits < 1 || splits > tiles)
    return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return launch_mode<0>(x, z, C, ldc, params, xbar, part_x, part_p, pbar, n, m, d,
                          family, symmetric, splits, stream);
  if (mode == 1)
    return launch_mode<1>(x, z, C, ldc, params, xbar, part_x, part_p, pbar, n, m, d,
                          family, symmetric, splits, stream);
  return launch_mode<2>(x, z, C, ldc, params, xbar, part_x, part_p, pbar, n, m, d,
                        family, symmetric, splits, stream);
}
