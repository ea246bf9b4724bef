// logpdf_contraction: the cotangents of F = <C, s2 * g(d^2(x', x'))> for the logpdf cotangent
//   C = 1/2 (alpha_g alpha^T - gsum * Tsym),   Tsym = T + T^T - diag T,   T = tril(K^-1),
// built entry by entry and never stored: returns s2bar = sum C*g, the map hyperparameter's bar
// sum s2*C*dg/dp, and x'bar_r = 4 sum_c w_rc (x'_r - x'_c), w = s2*C*dg/dd^2 (C is symmetric,
// so the total is twice the row-operand cotangent of the symmetric sweep).
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:359 (logpdf_contraction, pallas_call at :458).
// Bound on the H100: bytes. It needs T's lower triangle once (n(n+1)/2 * 4 bytes, 134 MB at
// n = 8192: 0.040 ms at 3.35 TB/s); x', alpha and alpha_g are small, and the ~6D + 25
// operations an entry at D = 8, q = 1 stay under the FP32 rate for the bytes moved.
//
// Design: the column-split sweep of gram_sweep.cuh over the full n x n grid of ordered entries
// (64-row blocks x S column splits, S = fused_gram.column_split_count(n, n); cp.async double
// buffer; one row and 16 columns a thread, x'bar in registers; batches of 8 entries, the
// family switch once a batch), with this file's cotangent policy. Per 64 x 64 tile (I, J) it
// fetches one tile of T, landed [row][col] at stride 68: T[I, J] when J <= I, read as it lies;
// T[J, I] when J > I, read transposed (the mirror tile of gram_bwd's mode 2, at a 2-way bank
// conflict). The diagonal tile is fetched once and entry (r, c) with c > r reads tile[c][r],
// so T's strict upper triangle is never read and may hold anything (T is a view of a padded
// buffer). A split that crosses the diagonal changes read per tile; the choice is uniform over
// the CTA except in the diagonal tile. So each lower tile of T is read twice, n^2 * 4 bytes in
// all. alpha's rows of the column tile are staged beside x''s (q = 1 as one float a column,
// q <= 4 as [c][4]) and the thread holds its row of alpha_g; past q = 4 both are read per
// entry through L1 (untuned; the main path has q = 1). Both scalar sums, whose sigma^2 part
// nearly cancels (1/2 sum alpha_g alpha^T K against 1/2 gsum tr(K^-1 K)), are FP64 sums of
// the f32 entries (the TPU kernel's Neumaier-compensated f32 sums, made exact to the f32
// products), per CTA in a fixed order into (row block, split) partials that a last small launch
// adds in order, with the x'bar partials: no atomics, the same inputs give the same bits.
#include "gram_sweep.cuh"

namespace {

using agp::kRowStride;
using agp::kSweepThreads;
using agp::kSweepTile;

// columns of alpha staged per row of the column tile: 1 (the main path's q = 1) or 4 (q <= 4,
// zero past q); 0: q > 4, alpha's and alpha_g's rows read per entry
template <int kQ>
struct LogpdfCot {
  static constexpr int kTFloats = kSweepTile * kRowStride;
  static constexpr int kFloats = kTFloats + kSweepTile * kQ;
  static constexpr bool kWithG = true;
  static constexpr float kXScale = 4.f;

  const float* ag;    // alpha_g (n, q)
  const float* a;     // alpha (n, q)
  const float* T;     // (n, n), row stride ldt, lower triangle read
  const float* scal;  // [map hyperparameter, s2, gsum]
  long ldt;
  int n, q, vec;

  struct State {
    float s2, hgsum, agr[kQ == 0 ? 1 : kQ];  // s2, gsum / 2, alpha_g's row / 2 (zero past q)
  };

  __device__ State begin(int row) const {
    State st;
    st.s2 = scal[1];
    st.hgsum = 0.5f * scal[2];
#pragma unroll
    for (int k = 0; k < (kQ == 0 ? 1 : kQ); ++k)
      st.agr[k] = (kQ > 0 && k < q) ? 0.5f * ag[(long)row * q + k] : 0.f;
    return st;
  }

  __device__ void fetch(float* s, int row0, int col0, int tid) const {
    if (col0 <= row0)  // T[I, J]: entry (r, c) at [r][c]
      agp::fetch_tile(s, kRowStride, T, ldt, row0, col0, n, n, vec, tid);
    else  // T[J, I]: Tsym entry (r, c) = T[c][r], landed at [c][r]
      agp::fetch_tile(s, kRowStride, T, ldt, col0, row0, n, n, vec, tid);
    if constexpr (kQ > 0) {  // alpha's rows of the column tile, [c][k], zero past q and n
      float* as = s + kTFloats;
      for (int e = tid; e < kSweepTile * kQ; e += kSweepThreads) {
        const int c = e / kQ, k = e % kQ;
        const bool in = col0 + c < n && k < q;
        agp::cp_async4(as + e, in ? a + (long)(col0 + c) * q + k : a, in ? 4 : 0);
      }
    }
  }

  // C = 1/2 (alpha_g[row] . alpha[col] - gsum Tsym[row][col]), the halves folded into the
  // thread's alpha_g row and gsum (exact scalings by 2^-1)
  __device__ float entry(const State& st, const float* s, int rl, int cl, int row,
                         int col) const {
    const float t = col <= row ? s[rl * kRowStride + cl] : s[cl * kRowStride + rl];
    float aa = 0.f;
    if constexpr (kQ == 0) {
      if (col < n)
        for (int k = 0; k < q; ++k)
          aa = fmaf(0.5f * ag[(long)row * q + k], a[(long)col * q + k], aa);
    } else if constexpr (kQ == 1) {
      aa = st.agr[0] * s[kTFloats + cl];
    } else {
      const float4 ac = *reinterpret_cast<const float4*>(s + kTFloats + cl * 4);
      aa = fmaf(st.agr[0], ac.x, aa);
      aa = fmaf(st.agr[1], ac.y, aa);
      aa = fmaf(st.agr[2], ac.z, aa);
      aa = fmaf(st.agr[3], ac.w, aa);
    }
    return fmaf(-st.hgsum, t, aa);
  }

  __device__ float scaled(const State& st, float ct) const { return ct * st.s2; }
};

template <int kQ>
int launch_q(const float* x, const float* ag, const float* a, const float* T, long ldt,
             const float* scal, float* xbar, float* part_x, double* part_s,
             double* sums, int n, int d, int q, int family, int splits, cudaStream_t stream) {
  const int vec = ldt % 4 == 0 && reinterpret_cast<uintptr_t>(T) % 16 == 0;
  const LogpdfCot<kQ> cot{ag, a, T, scal, ldt, n, q, vec};
  return agp::launch_split_sweep(cot, x, x, scal, xbar, part_x, part_s, sums, n, n, d,
                                 family, 1, splits, stream);
}

}  // namespace

// x' (n, d), alpha_g and alpha (n, q), T (n, n) with row stride ldt (lower triangle read),
// scal = [map hyperparameter, s2, gsum] on the device; splits: the column splits S (1 <= S <=
// column tiles). Scratch: part_x (S, n, d) f32, part_s (2 * row blocks * S) f64. Writes xbar
// (n, d) whole and sums (2) = [hyperparameter bar, s2bar].
extern "C" int agp_logpdf_contraction(const float* x, const float* ag, const float* a,
                                      const float* T, long ldt, const float* scal, float* xbar,
                                      float* part_x, double* part_s, double* sums,
                                      int n, int d, int q, int family, int splits,
                                      cudaStream_t stream) {
  const int tiles = (n + kSweepTile - 1) / kSweepTile;
  if (family < 0 || family > 6 || n <= 0 || d <= 0 || q <= 0 || ldt < n || splits < 1 ||
      splits > tiles)
    return (int)cudaErrorInvalidValue;
  if (q == 1)
    return launch_q<1>(x, ag, a, T, ldt, scal, xbar, part_x, part_s, sums, n, d, q,
                       family, splits, stream);
  if (q <= 4)
    return launch_q<4>(x, ag, a, T, ldt, scal, xbar, part_x, part_s, sums, n, d, q,
                       family, splits, stream);
  return launch_q<0>(x, ag, a, T, ldt, scal, xbar, part_x, part_s, sums, n, d, q,
                     family, splits, stream);
}
