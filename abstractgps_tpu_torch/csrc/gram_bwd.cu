// gram_bwd: the VJP of the fused isotropic gram K = g(d^2(x, z)) against a cotangent C: the row
// operand's cotangent xbar = 2 (rowsum(w) o x - w z), w = C * dg/dd^2, and the map
// hyperparameter's bar sum C * dg/dp.
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:185 (_bwd_pass, pallas_call at :289), driven by
// _fused_vjp_bwd (:325). Modes, as there:
//   0  C is (n, m): xbar of x; z's cotangent is the same sweep with the roles swapped and
//   1  C read transposed (C is (m, n), the row operand is the original column operand);
//   2  z is x (symmetric gram, n = m): one sweep over C + C^T gives the total xbar, and the
//      hyperparameter bar is doubled (the wrapper halves it).
// Bound on the H100: bytes. It reads C once per pass (n*m*4 bytes; C + C^T reads the n^2
// cotangent twice) and does ~4D + 15 operations per entry at D = 8, under the FP32 rate for
// the bytes moved.
//
// Design, a column-split sweep:
//   * Grid (row blocks of 64, S column splits), S fixed by (n, m) in the wrapper
//     (fused_gram.column_split_count): at least ~8 CTAs per SM of 132, at most one split per
//     column tile. Split s walks the contiguous column tiles [s*T/S, (s+1)*T/S) of T.
//   * Per 64 x 64 tile the cotangent (mode 2: C[I, J] and C[J, I]) and z's rows are fetched
//     with cp.async (16-byte copies where C's rows are 16-byte aligned, else 4-byte ones,
//     zero-filled past the edge) into a double buffer, so tile j + 1 loads while tile j is
//     computed. Tiles of C land row-major as C's rows lie, so the copies stay coalesced; a
//     transposed tile is read transposed from shared memory. Row strides of 68 floats
//     ([row][col], = 4 mod 32 banks) and 72 ([col][row], = 8 mod 32) keep each warp's reads
//     on distinct banks; mode 2's mirrored tile also takes 68, at a 2-way conflict on its
//     reads, so that three CTAs fit an SM.
//   * A thread owns one row (its features, |x|^2 and its xbar accumulators in registers)
//     and 16 of the tile's columns (4 threads a row): per entry it rebuilds d^2 from z's
//     staged row and norm by FP32 FMA (no TF32: ops/precision.py), applies the closed-form
//     map VJP, and adds w to its row sum and w * z_j to its accumulators. The hyperparameter
//     bar is an FP64 sum per thread (only for the families that have one). Issue, not bytes,
//     limits this loop, so: the entries go in batches of 8 whose passes are unrolled (the
//     map's family switch once a batch, the MUFU latencies of 8 entries side by side); z's
//     row norms come from a small first launch, once, not once per row block; the mode is a
//     template parameter, so the cotangent read has no branch.
//   * Shared memory per CTA at D <= 8: 39.4 KB (mode 0), 41.5 KB (mode 1), 74.2 KB (mode 2);
//     <= 85 registers a thread: 3 CTAs of 256 threads an SM in every mode (at <= 64, four
//     CTAs in modes 0 and 1, the batches spill and ran slower on the H100).
//   * Any D: a thread holds KD = 8, 16 or 32 features of its row (zero past d). Past 32
//     features the grid gets a third dimension of 32-feature chunks: each CTA rebuilds d^2
//     from all d features (its row and z's rows read from global memory, through L1) and
//     accumulates xbar for its own chunk only, so the cotangent is read once per chunk. This
//     wide path is not tuned; the main path has D = 8.
//   * No atomics: each CTA writes its row block's xbar partial for its split into an
//     (S, n, D) buffer and its FP64 bar into (row block, split) order; one small last
//     launch adds the xbar partials in split order and the bars in a fixed order. The same
//     inputs and (n, m) give the same bits.
#include <stdint.h>

#include "gram_sweep.cuh"

namespace {

constexpr int kTile = agp::kSweepTile;  // rows of a row block = columns of a column tile
constexpr int kThreads = 256;           // 8 warps x 8 rows, 4 threads a row
constexpr int kColsPerThread = kTile / 4;
constexpr int kBatch = 8;  // entries of a thread computed side by side
constexpr int kRowStride = 68;  // [row][col] tiles
constexpr int kColStride = 72;  // mode 1's [col][row] tile
static_assert(kThreads == 4 * kTile && kRowStride % 32 == 4 && kColStride % 32 == 8,
              "one row and 16 columns a thread, bank-distinct strides");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the tile being fetched ahead) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows r0..r0+63, columns c0..c0+63 of the row-major (nr x nc) matrix M (row stride ld) into
// dst ([row][col], row stride `stride`), zero outside the matrix.
__device__ __forceinline__ void fetch_tile(float* dst, int stride, const float* M, long ld,
                                           int r0, int c0, int nr, int nc, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTile * kTile / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e >> 4, q = (e & 15) * 4;
      const int valid = (r0 + r < nr) ? min(max(nc - c0 - q, 0), 4) : 0;
      cp_async16(dst + r * stride + q, valid ? M + (long)(r0 + r) * ld + c0 + q : M, 4 * valid);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kTile * kTile / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e >> 6, c = e & (kTile - 1);
      const bool in = r0 + r < nr && c0 + c < nc;
      cp_async4(dst + r * stride + c, in ? M + (long)(r0 + r) * ld + c0 + c : M, in ? 4 : 0);
    }
  }
}

template <int KD>
__device__ __forceinline__ void load_row(const float* src, float (&v)[KD]) {
#pragma unroll
  for (int q = 0; q < KD / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(src)[q];
    v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
  }
}

// the map's VJP at family F for N entries: e holds d^2 and gets dg/dd^2, dp gets dg/dp
template <int F, int N>
__device__ __forceinline__ void map_vjp_n(float (&e)[N], float p0, float (&dp)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const agp::MapVjp v = agp::map_vjp(F, e[j], p0);
    e[j] = v.dg;
    dp[j] = v.dp;
  }
}

// floats of one buffer stage: the cotangent tile(s), z's rows [c][k], their norms
__host__ __device__ constexpr int stage_floats(int mode, int kd) {
  return kTile * (mode == 1 ? kColStride : kRowStride) + (mode == 2 ? kTile * kRowStride : 0) +
         kTile * kd + kTile;
}

// |z_j|^2 of the column operand's rows, once, for every CTA's tiles
__global__ void column_norms_kernel(const float* __restrict__ z, int m, int d,
                                    float* __restrict__ znorm) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.f;
  for (int k = 0; k < d; ++k) s = fmaf(z[(long)j * d + k], z[(long)j * d + k], s);
  znorm[j] = s;
}

// KD: features held per row, chunk blockIdx.z of them, [k0, k0 + KD) (zero past d); kWide:
// d > KD, so d^2 takes every feature from global memory; kMode as agp_gram_bwd's mode.
template <int KD, int kMode, bool kWide>
__global__ void __launch_bounds__(kThreads, KD <= 8 ? 3 : (KD <= 16 ? 2 : 1))
    gram_bwd_split_kernel(const float* __restrict__ x, const float* __restrict__ z,
                          const float* __restrict__ znorm, const float* __restrict__ C, long ldc,
                          const float* __restrict__ params, float* __restrict__ part_x,
                          double* __restrict__ part_p, int n, int m, int d, int family,
                          int symmetric, int splits, int vec) {
  constexpr int mode = kMode;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = warp * 8 + (lane & 7), cg = lane >> 3;  // row in the block, column group
  const int row0 = blockIdx.x * kTile, row = row0 + rl, split = blockIdx.y;
  const int k0 = blockIdx.z * KD;  // the feature chunk whose xbar this CTA accumulates
  const int tiles = (m + kTile - 1) / kTile;
  const int t0 = (int)((long long)split * tiles / splits);
  const int t1 = (int)((long long)(split + 1) * tiles / splits);
  constexpr int prim = kTile * (mode == 1 ? kColStride : kRowStride);
  constexpr int mirror = mode == 2 ? kTile * kRowStride : 0;
  constexpr int stage = stage_floats(mode, KD);
  const bool has_p = family == 4 || family == 5;
  const float p0 = has_p ? params[0] : 0.f;

  // this thread's row: its chunk's features, |x|^2; its row sum of w and sum of w z_j
  const float* xrow = x + (long)(row < n ? row : 0) * d;
  float xr[KD], acc[KD];
  float nx = 0.f, rs = 0.f;
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    xr[k] = (row < n && k0 + k < d) ? xrow[k0 + k] : 0.f;
    if (!kWide) nx = fmaf(xr[k], xr[k], nx);
    acc[k] = 0.f;
  }
  if (kWide)
    for (int k = 0; k < d; ++k) nx = fmaf(xrow[k], xrow[k], nx);
  double acc_p = 0.0;

  auto fetch = [&](int t, int b) {
    float* s = smem + b * stage;
    const int col0 = t * kTile;
    if (mode == 1)  // tile entry (r, c) = C[col0 + c][row0 + r], landed as [c][r]
      fetch_tile(s, kColStride, C, ldc, col0, row0, m, n, vec, tid);
    else
      fetch_tile(s, kRowStride, C, ldc, row0, col0, n, m, vec, tid);
    if (mode == 2)  // C[J, I], landed as [c][r]
      fetch_tile(s + prim, kRowStride, C, ldc, col0, row0, n, n, vec, tid);
    float* zs = s + prim + mirror;  // z's rows of the tile at the chunk, [c][k], zero past d, m
#pragma unroll
    for (int i = 0; i < KD * kTile / kThreads; ++i) {
      const int e = tid + i * kThreads, c = e / KD, k = e % KD;
      const bool in = col0 + c < m && k0 + k < d;
      cp_async4(zs + e, in ? z + (long)(col0 + c) * d + k0 + k : z, in ? 4 : 0);
    }
    if (tid < kTile) {
      const bool in = col0 + tid < m;
      cp_async4(zs + kTile * KD + tid, in ? znorm + col0 + tid : znorm, in ? 4 : 0);
    }
  };

  fetch(t0, 0);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) & 1;
    if (t + 1 < t1) fetch(t + 1, b ^ 1);  // the buffer tile t - 1 left (barrier below)
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* cs = smem + b * stage;
    const float* zs = cs + prim + mirror;
    const float* zn = zs + kTile * KD;
    const int col0 = t * kTile;
    // the thread's 16 entries in two batches of 8, three passes over a batch, each unrolled
    // so that the batch's entries interleave: d^2; the map's VJP (its family switch once a
    // batch); w and the sums. Entries past m hold zero-filled z rows and cotangents and are
    // masked out of the sums.
    const int live = m - col0;  // columns cl < live are in the matrix
#pragma unroll 1
    for (int j0 = 0; row < n && j0 < kColsPerThread; j0 += kBatch) {
      float e[kBatch];  // d^2, then dg/dd^2
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int cl = cg + 4 * (j0 + j);
        float dot = 0.f;
        if (kWide) {  // all d features; entries past m take z's last row and are masked below
          const float* zrow = z + (long)min(col0 + cl, m - 1) * d;
          for (int k = 0; k < d; ++k) dot = fmaf(xrow[k], zrow[k], dot);
        } else {
          float zc[KD];
          load_row(zs + cl * KD, zc);
#pragma unroll
          for (int k = 0; k < KD; ++k) dot = fmaf(xr[k], zc[k], dot);
        }
        const bool diag = symmetric && row == col0 + cl;
        e[j] = diag ? 0.f : fmaxf(nx + zn[cl] - 2.f * dot, 0.f);
      }
      auto accumulate = [&](const float(&dp)[kBatch], bool with_p) {
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int cl = cg + 4 * (j0 + j);
          float ct = (mode == 1) ? cs[cl * kColStride + rl] : cs[rl * kRowStride + cl];
          if (mode == 2) ct += cs[prim + cl * kRowStride + rl];
          const bool in = cl < live;
          if (with_p && in) acc_p += (double)(ct * dp[j]);
          const float w = (in && !(symmetric && row == col0 + cl)) ? ct * e[j] : 0.f;
          rs += w;
          float zc[KD];
          load_row(zs + cl * KD, zc);
#pragma unroll
          for (int k = 0; k < KD; ++k) acc[k] = fmaf(w, zc[k], acc[k]);
        }
      };
      float dp[kBatch];  // dg/dp: read only for the families that have one
      if (has_p) {
        if (family == 4)
          map_vjp_n<4>(e, p0, dp);
        else
          map_vjp_n<5>(e, p0, dp);
        accumulate(dp, true);
      } else {
        switch (family) {
          case 0: map_vjp_n<0>(e, p0, dp); break;
          case 1: map_vjp_n<1>(e, p0, dp); break;
          case 2: map_vjp_n<2>(e, p0, dp); break;
          case 3: map_vjp_n<3>(e, p0, dp); break;
          default: map_vjp_n<6>(e, p0, dp); break;
        }
        accumulate(dp, false);
      }
    }
    __syncthreads();  // tile t read: its buffer may be refilled
  }

  // the row's sums over its 4 threads (lanes rl, +8, +16, +24) in a fixed order
  rs += __shfl_xor_sync(0xffffffffu, rs, 8);
  rs += __shfl_xor_sync(0xffffffffu, rs, 16);
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 8);
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 16);
  }
  if (cg == 0 && row < n) {
    float* dst = part_x + ((long)split * n + row) * d + k0;
#pragma unroll
    for (int k = 0; k < KD; ++k)
      if (k0 + k < d) dst[k] = 2.f * (rs * xr[k] - acc[k]);
  }
  // the bar over the CTA: a butterfly per warp, then the 8 warps in order, through the
  // first cotangent buffer (no copy is in flight after the last barrier); every chunk's CTA
  // sums the same bar, the first chunk's writes it
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc_p += __shfl_xor_sync(0xffffffffu, acc_p, o);
  double* red = reinterpret_cast<double*>(smem);
  if (lane == 0) red[warp] = acc_p;
  __syncthreads();
  if (tid == 0 && blockIdx.z == 0) {
    double s = red[0];
    for (int w = 1; w < kThreads / 32; ++w) s += red[w];
    part_p[(long)blockIdx.x * splits + split] = s;
  }
}

// xbar = sum of the S partials in split order, one thread an entry; block 0's first warp
// sums the np bar partials (lane l takes l, l + 32, ... in order, then a butterfly).
__global__ void gram_bwd_reduce_kernel(const float* __restrict__ part_x,
                                       const double* __restrict__ part_p, long nd, int splits,
                                       int np, float* __restrict__ xbar,
                                       double* __restrict__ pbar) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nd) {
    float s = part_x[i];
    for (int sp = 1; sp < splits; ++sp) s += part_x[sp * nd + i];
    xbar[i] = s;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    double s = 0.0;
    for (int e = threadIdx.x; e < np; e += 32) s += part_p[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) *pbar = s;
  }
}

template <int KD, int kMode, bool kWide>
int launch(const float* x, const float* z, float* znorm, const float* C, long ldc,
           const float* params, float* xbar, float* part_x, double* part_p, double* pbar, int n,
           int m, int d, int family, int symmetric, int splits, cudaStream_t stream) {
  constexpr int smem = 2 * stage_floats(kMode, KD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gram_bwd_split_kernel<KD, kMode, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  column_norms_kernel<<<(m + 255) / 256, 256, 0, stream>>>(z, m, d, znorm);
  const int vec = ldc % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const int rblocks = (n + kTile - 1) / kTile, chunks = (d + KD - 1) / KD;
  gram_bwd_split_kernel<KD, kMode, kWide>
      <<<dim3(rblocks, splits, chunks), kThreads, smem, stream>>>(
      x, z, znorm, C, ldc, params, part_x, part_p, n, m, d, family, symmetric, splits, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long nd = (long)n * d;
  gram_bwd_reduce_kernel<<<(unsigned)((nd + 255) / 256), 256, 0, stream>>>(
      part_x, part_p, nd, splits, rblocks * splits, xbar, pbar);
  return (int)cudaGetLastError();
}

template <int KD, bool kWide = false>
int launch_kd(int mode, const float* x, const float* z, float* znorm, const float* C, long ldc,
              const float* params, float* xbar, float* part_x, double* part_p, double* pbar,
              int n, int m, int d, int family, int symmetric, int splits, cudaStream_t stream) {
  if (mode == 0)
    return launch<KD, 0, kWide>(x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n, m,
                                d, family, symmetric, splits, stream);
  if (mode == 1)
    return launch<KD, 1, kWide>(x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n, m,
                                d, family, symmetric, splits, stream);
  return launch<KD, 2, kWide>(x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n, m, d,
                              family, symmetric, splits, stream);
}

}  // namespace

// x (n, d), z (m, d), C as the mode says with row stride ldc, params: the map's
// hyperparameter buffer; splits: the column splits S (1 <= S <= column tiles). Scratch:
// znorm (m) f32, part_x (S, n, d) f32, part_p (row blocks * S) f64. Writes xbar (n, d) whole
// and pbar[0] = sum C dg/dp.
extern "C" int agp_gram_bwd(const float* x, const float* z, const float* C, long ldc,
                            const float* params, float* xbar, float* znorm, float* part_x,
                            double* part_p, double* pbar, int n, int m, int d, int family,
                            int symmetric, int mode, int splits, cudaStream_t stream) {
  const int tiles = (m + kTile - 1) / kTile;
  if (family < 0 || family > 6 || n <= 0 || m <= 0 || d <= 0 || mode < 0 || mode > 2 ||
      (mode == 2 && n != m) || splits < 1 || splits > tiles)
    return (int)cudaErrorInvalidValue;
  if (d <= 8)
    return launch_kd<8>(mode, x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n, m,
                        d, family, symmetric, splits, stream);
  if (d <= 16)
    return launch_kd<16>(mode, x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n, m,
                         d, family, symmetric, splits, stream);
  if (d <= 32)
    return launch_kd<32>(mode, x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n, m,
                         d, family, symmetric, splits, stream);
  return launch_kd<32, true>(mode, x, z, znorm, C, ldc, params, xbar, part_x, part_p, pbar, n,
                             m, d, family, symmetric, splits, stream);
}
