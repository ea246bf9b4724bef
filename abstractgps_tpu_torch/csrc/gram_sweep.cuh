// Isotropic gram maps and their VJPs (agp::apply_map is gram_tile.cu's epilogue), the cp.async
// helpers of the gram kernels, and the column-split backward sweep that gram_bwd.cu and
// logpdf_contraction.cu each run with their own cotangent policy.
//
// The column-split sweep: the grid is (row blocks of 64, S column splits, feature chunks); split
// s walks the contiguous column tiles [s*T/S, (s+1)*T/S) of the T = ceil(m/64) tiles of z. Per
// 64 x 64 tile the policy's cotangent tile(s) and z's rows are fetched with cp.async into a
// double buffer, so tile j + 1 loads while tile j is computed. A thread owns one row (its
// features and its x-bar accumulators in registers) and 16 of the tile's columns (4 threads a
// row): per entry it rebuilds d^2 = sum_k (x_rk - z_ck)^2 from the differences by FP32 FMA (no
// TF32: ops/precision.py; not as |x_r|^2 + |z_c|^2 - 2 x_r.z_c, which cancels to eps |x|^2 where
// the inputs lie far from the origin, as 1-D time axes do), applies the closed-form map VJP, and
// accumulates
//   w = scaled(C_rc) * dg/dd^2              (0 on the diagonal of a symmetric sweep)
//   sum_c w (x_r - z_c)                     -> x-bar partial = kXScale sum_c w (x_r - z_c)
//   sum scaled(C) * dg/dp                   (FP64; RQ alpha, gamma)
//   sum C * g                               (FP64; only for a policy with kWithG)
// The instruction rate, not bytes, limits the entry loop, so the entries go in batches of 8 whose
// passes are unrolled (the family switch once a batch), and the policy is a template parameter (its cotangent read has no branch on a mode). A row
// keeps KD = 8, 16 or 32 features in registers (zero past d); past 32 the grid's third dimension
// takes 32-feature chunks, each CTA rebuilding d^2 from all d features through L1 and
// accumulating the x-bar of its own chunk (untuned). No atomics: each CTA writes its x-bar
// partial into an (S, n, d) buffer and its FP64 sums in (row block, split) order, and one small
// last launch adds them in a fixed order. The same inputs and (n, m) give the same bits.
//
// A cotangent policy is passed by value and stays constant (its pointers are read from the
// kernel's parameters, not copied into registers); it supplies
//   kFloats            shared floats of its part of one buffer stage (a multiple of 4);
//   kWithG, kXScale    whether sum C * g is accumulated; the x-bar factor;
//   State, begin(row)  the thread's own set-up (device scalars, its row of an operand);
//   fetch(s, r0, c0)   cp.async of its tile(s) for rows r0.., columns c0.. into s;
//   entry(st, s, rl, cl, row, col)   the unscaled cotangent of entry (row, col) from the stage;
//   scaled(st, ct)     the factor of C in w and in the dp sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace agp {

constexpr int kSweepTile = 64;      // rows of a row block = columns of a column tile
constexpr int kSweepThreads = 256;  // 8 warps x 8 rows, 4 threads a row
constexpr int kSweepBatch = 8;      // entries of a thread computed side by side
constexpr int kRowStride = 68;      // [row][col] tiles, = 4 mod 32 banks
constexpr int kColStride = 72;      // [col][row] tiles, = 8 mod 32 banks
static_assert(kSweepThreads == 4 * kSweepTile && kRowStride % 32 == 4 && kColStride % 32 == 8,
              "one row and 16 columns a thread, bank-distinct strides");

__device__ __forceinline__ float safe_sqrt(float d2) { return d2 > 0.f ? sqrtf(d2) : 0.f; }

// Epilogue per isotropic family; ids match abstractgps_tpu_torch/ops/fused_gram.py FAMILIES.
__device__ __forceinline__ float apply_map(int family, float d2, float p0) {
  switch (family) {
    case 0:  // squared exponential
      return expf(-0.5f * d2);
    case 1:  // exponential / Matern-1/2
      return expf(-safe_sqrt(d2));
    case 2: {  // Matern-3/2
      const float t = 1.7320508075688772f * safe_sqrt(d2);
      return (1.f + t) * expf(-t);
    }
    case 3: {  // Matern-5/2
      const float t = 2.23606797749979f * safe_sqrt(d2);
      return (1.f + t + t * t / 3.f) * expf(-t);
    }
    case 4:  // rational quadratic, p0 = alpha
      return powf(1.f + d2 / (2.f * p0), -p0);
    case 5:  // gamma-exponential, p0 = gamma
      return expf(-(d2 > 0.f ? powf(d2, 0.5f * p0) : 0.f));
    case 6:  // cosine
      return cosf(3.14159265358979323846f * safe_sqrt(d2));
  }
  return __int_as_float(0x7fc00000);
}

struct MapVjp {
  float g, dg, dp;  // g(d^2), dg/dd^2, dg/dp
};

// Closed-form derivatives of the maps, as autodiff of the JAX package's _apply_sqdist gives
// them: safe_sqrt has derivative 0 at d^2 = 0, so every sqrt-based family has dg/dd^2 = 0 there.
// Same formulas as fused_gram._map_vjp.
__device__ __forceinline__ MapVjp map_vjp(int family, float d2, float p0) {
  const bool pos = d2 > 0.f;
  const float s = safe_sqrt(d2);
  switch (family) {
    case 0: {
      const float g = expf(-0.5f * d2);
      return {g, -0.5f * g, 0.f};
    }
    case 1: {
      const float g = expf(-s);
      return {g, pos ? -0.5f * g / s : 0.f, 0.f};
    }
    case 2: {
      const float t = 1.7320508075688772f * s, e = expf(-t);
      return {(1.f + t) * e, pos ? -1.5f * e : 0.f, 0.f};
    }
    case 3: {
      const float t = 2.23606797749979f * s, e = expf(-t);
      return {(1.f + t + t * t / 3.f) * e, pos ? -(5.f / 6.f) * (1.f + t) * e : 0.f, 0.f};
    }
    case 4: {
      const float u = d2 / (2.f * p0), b = 1.f + u, g = powf(b, -p0);
      return {g, -0.5f * g / b, g * (u / b - log1pf(u))};
    }
    case 5: {
      if (!pos) return {1.f, 0.f, 0.f};
      const float pw = powf(d2, 0.5f * p0), g = expf(-pw);
      return {g, -0.5f * p0 * g * pw / d2, -0.5f * g * pw * logf(d2)};
    }
    case 6: {
      const float a = 3.14159265358979323846f * s;
      return {cosf(a), pos ? -0.5f * 3.14159265358979323846f * sinf(a) / s : 0.f, 0.f};
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  return {nan, nan, nan};
}

// ---- cp.async --------------------------------------------------------------------------------

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

// wait until at most N groups (the tiles being fetched ahead) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0..r0+63, columns c0..c0+63 of the row-major (nr x nc) matrix M (row stride ld) into
// dst ([row][col], row stride `stride`), zero outside the matrix: 16-byte copies when M's rows
// are 16-byte aligned (vec), else 4-byte ones.
__device__ __forceinline__ void fetch_tile(float* dst, int stride, const float* M, long ld,
                                           int r0, int c0, int nr, int nc, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kSweepTile * kSweepTile / 4 / kSweepThreads; ++i) {
      const int e = tid + i * kSweepThreads, r = e >> 4, q = (e & 15) * 4;
      const int valid = (r0 + r < nr) ? min(max(nc - c0 - q, 0), 4) : 0;
      cp_async16(dst + r * stride + q, valid ? M + (long)(r0 + r) * ld + c0 + q : M, 4 * valid);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kSweepTile * kSweepTile / kSweepThreads; ++i) {
      const int e = tid + i * kSweepThreads, r = e >> 6, c = e & (kSweepTile - 1);
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

// ---- the column-split sweep ------------------------------------------------------------------

// the map's VJP at family F for N entries: e holds d^2 and gets dg/dd^2; g, dp get g, dg/dp
template <int F, int N>
__device__ __forceinline__ void map_vjp_n(float (&e)[N], float p0, float (&g)[N],
                                          float (&dp)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const MapVjp v = map_vjp(F, e[j], p0);
    e[j] = v.dg;
    g[j] = v.g;
    dp[j] = v.dp;
  }
}

// floats of one buffer stage: the policy's tile(s), z's rows [c][k]
template <class Cot, int KD>
__host__ __device__ constexpr int sweep_stage_floats() {
  return Cot::kFloats + kSweepTile * KD;
}

// KD: features held per row, chunk blockIdx.z of them, [k0, k0 + KD) (zero past d); kWide:
// d > KD, so d^2 takes every feature from global memory; kP: the family has a map
// hyperparameter (RQ, gamma-exponential), whose sum is kept only then.
template <class Cot, int KD, bool kWide, bool kP>
__global__ void __launch_bounds__(kSweepThreads, KD <= 8 ? 3 : (KD <= 16 ? 2 : 1))
    split_sweep_kernel(const Cot cot, const float* __restrict__ x, const float* __restrict__ z,
                       const float* __restrict__ params,
                       float* __restrict__ part_x, double* __restrict__ part_s, int n, int m,
                       int d, int family, int symmetric, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = warp * 8 + (lane & 7), cg = lane >> 3;  // row in the block, column group
  const int row0 = blockIdx.x * kSweepTile, row = row0 + rl, split = blockIdx.y;
  const int k0 = blockIdx.z * KD;  // the feature chunk whose x-bar this CTA accumulates
  const int tiles = (m + kSweepTile - 1) / kSweepTile;
  const int t0 = (int)((long long)split * tiles / splits);
  const int t1 = (int)((long long)(split + 1) * tiles / splits);
  constexpr int stage = sweep_stage_floats<Cot, KD>();
  const float p0 = kP ? params[0] : 0.f;
  const typename Cot::State st = cot.begin(row < n ? row : 0);

  // this thread's row: its chunk's features; its sum of w (x_r - z_c)
  const float* xrow = x + (long)(row < n ? row : 0) * d;
  float xr[KD], acc[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    xr[k] = (row < n && k0 + k < d) ? xrow[k0 + k] : 0.f;
    acc[k] = 0.f;
  }
  double acc_p = 0.0, acc_g = 0.0;

  auto fetch = [&](int t, int b) {
    float* s = smem + b * stage;
    const int col0 = t * kSweepTile;
    cot.fetch(s, row0, col0, tid);
    float* zs = s + Cot::kFloats;  // z's rows of the tile at the chunk, [c][k], zero past d, m
#pragma unroll
    for (int i = 0; i < KD * kSweepTile / kSweepThreads; ++i) {
      const int e = tid + i * kSweepThreads, c = e / KD, k = e % KD;
      const bool in = col0 + c < m && k0 + k < d;
      cp_async4(zs + e, in ? z + (long)(col0 + c) * d + k0 + k : z, in ? 4 : 0);
    }
  };

  fetch(t0, 0);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) & 1;
    if (t + 1 < t1) fetch(t + 1, b ^ 1);  // the buffer tile t - 1 left (barrier below)
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cs = smem + b * stage;
    const float* zs = cs + Cot::kFloats;
    const int col0 = t * kSweepTile;
    // the thread's 16 entries in two batches of 8, three passes over a batch, each unrolled
    // so that the batch's entries interleave: d^2; the map's VJP (its family switch once a
    // batch); w and the sums. Entries past m hold zero-filled z rows and cotangents and are
    // masked out of the sums.
    const int live = m - col0;  // columns cl < live are in the matrix
#pragma unroll 1
    for (int j0 = 0; row < n && j0 < kSweepTile / 4; j0 += kSweepBatch) {
      float e[kSweepBatch];  // d^2, then dg/dd^2
#pragma unroll
      for (int j = 0; j < kSweepBatch; ++j) {
        const int cl = cg + 4 * (j0 + j);
        float s2 = 0.f;
        if (kWide) {  // all d features; entries past m take z's last row and are masked below
          const float* zrow = z + (long)min(col0 + cl, m - 1) * d;
          for (int k = 0; k < d; ++k) {
            const float df = xrow[k] - zrow[k];
            s2 = fmaf(df, df, s2);
          }
        } else {
          float zc[KD];
          load_row(zs + cl * KD, zc);
#pragma unroll
          for (int k = 0; k < KD; ++k) {
            const float df = xr[k] - zc[k];
            s2 = fmaf(df, df, s2);
          }
        }
        const bool diag = symmetric && row == col0 + cl;
        e[j] = diag ? 0.f : s2;
      }
      auto accumulate = [&](const float(&g)[kSweepBatch], const float(&dp)[kSweepBatch],
                            bool with_p) {
#pragma unroll
        for (int j = 0; j < kSweepBatch; ++j) {
          const int cl = cg + 4 * (j0 + j);
          const float ct = cot.entry(st, cs, rl, cl, row, col0 + cl);
          const float sc = cot.scaled(st, ct);
          const bool in = cl < live;
          if (with_p && in) acc_p += (double)(sc * dp[j]);
          if (Cot::kWithG && in) acc_g += (double)(ct * g[j]);
          const float w = (in && !(symmetric && row == col0 + cl)) ? sc * e[j] : 0.f;
          float zc[KD];
          load_row(zs + cl * KD, zc);
#pragma unroll
          for (int k = 0; k < KD; ++k) acc[k] = fmaf(w, xr[k] - zc[k], acc[k]);
        }
      };
      float g[kSweepBatch], dp[kSweepBatch];  // g, dg/dp: read only where needed
      if (kP) {
        if (family == 4)
          map_vjp_n<4>(e, p0, g, dp);
        else
          map_vjp_n<5>(e, p0, g, dp);
        accumulate(g, dp, true);
      } else {
        switch (family) {
          case 0: map_vjp_n<0>(e, p0, g, dp); break;
          case 1: map_vjp_n<1>(e, p0, g, dp); break;
          case 2: map_vjp_n<2>(e, p0, g, dp); break;
          case 3: map_vjp_n<3>(e, p0, g, dp); break;
          default: map_vjp_n<6>(e, p0, g, dp); break;
        }
        accumulate(g, dp, false);
      }
    }
    __syncthreads();  // tile t read: its buffer may be refilled
  }

  // the row's sums over its 4 threads (lanes rl, +8, +16, +24) in a fixed order
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 8);
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 16);
  }
  if (cg == 0 && row < n) {
    float* dst = part_x + ((long)split * n + row) * d + k0;
#pragma unroll
    for (int k = 0; k < KD; ++k)
      if (k0 + k < d) dst[k] = Cot::kXScale * acc[k];
  }
  // the sums over the CTA: a butterfly per warp, then the 8 warps in order, through the first
  // buffer (no copy is in flight after the last barrier); every chunk's CTA forms the same
  // sums, the first chunk's writes them. Sum t of CTA (i, s) goes to t * (row blocks * S) +
  // i * S + s.
  constexpr int nsums = Cot::kWithG ? 2 : 1;
  double sums[2] = {acc_p, acc_g};
  double* red = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int t = 0; t < nsums; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sums[t] += __shfl_xor_sync(0xffffffffu, sums[t], o);
    if (lane == 0) red[t * 8 + warp] = sums[t];
  }
  __syncthreads();
  if (tid == 0 && blockIdx.z == 0) {
    const long np = (long)gridDim.x * splits;
    for (int t = 0; t < nsums; ++t) {
      double s = red[t * 8];
      for (int w = 1; w < kSweepThreads / 32; ++w) s += red[t * 8 + w];
      part_s[t * np + (long)blockIdx.x * splits + split] = s;
    }
  }
}

// xbar = sum of the S partials in split order, one thread an entry; in block 0, warp t < nsums
// adds the np partials of sum t (lane l takes l, l + 32, ... in order, then a butterfly).
static __global__ void split_sweep_reduce_kernel(const float* __restrict__ part_x,
                                                 const double* __restrict__ part_s, long nd,
                                                 int splits, int np, int nsums,
                                                 float* __restrict__ xbar,
                                                 double* __restrict__ sums) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nd) {
    float s = part_x[i];
    for (int sp = 1; sp < splits; ++sp) s += part_x[sp * nd + i];
    xbar[i] = s;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && warp < nsums) {
    double s = 0.0;
    for (int e = lane; e < np; e += 32) s += part_s[(long)warp * np + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sums[warp] = s;
  }
}

template <class Cot, int KD, bool kWide, bool kP>
int launch_split_sweep_kp(const Cot& cot, const float* x, const float* z,
                          const float* params, float* xbar, float* part_x, double* part_s,
                          double* sums, int n, int m, int d, int family, int symmetric,
                          int splits, cudaStream_t stream) {
  constexpr int smem = 2 * sweep_stage_floats<Cot, KD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(split_sweep_kernel<Cot, KD, kWide, kP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rblocks = (n + kSweepTile - 1) / kSweepTile, chunks = (d + KD - 1) / KD;
  split_sweep_kernel<Cot, KD, kWide, kP><<<dim3(rblocks, splits, chunks), kSweepThreads, smem,
                                           stream>>>(cot, x, z, params, part_x, part_s,
                                                     n, m, d, family, symmetric, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long nd = (long)n * d;
  split_sweep_reduce_kernel<<<(unsigned)((nd + 255) / 256), 256, 0, stream>>>(
      part_x, part_s, nd, splits, rblocks * splits, Cot::kWithG ? 2 : 1, xbar, sums);
  return (int)cudaGetLastError();
}

template <class Cot, int KD, bool kWide>
int launch_split_sweep_kd(const Cot& cot, const float* x, const float* z,
                          const float* params, float* xbar, float* part_x, double* part_s,
                          double* sums, int n, int m, int d, int family, int symmetric,
                          int splits, cudaStream_t stream) {
  if (family == 4 || family == 5)
    return launch_split_sweep_kp<Cot, KD, kWide, true>(cot, x, z, params, xbar, part_x,
                                                       part_s, sums, n, m, d, family,
                                                       symmetric, splits, stream);
  return launch_split_sweep_kp<Cot, KD, kWide, false>(cot, x, z, params, xbar, part_x,
                                                      part_s, sums, n, m, d, family, symmetric,
                                                      splits, stream);
}

// One sweep: the split sweep, then the in-order sums. x (n, d), z (m, d), params: the map's
// hyperparameter at [0]; splits: 1 <= S <= column tiles. Scratch: part_x (S, n, d) f32,
// part_s (nsums * row blocks * S) f64. Writes xbar (n, d) whole and
// sums[0] = sum scaled(C) dg/dp (and sums[1] = sum C g for a policy with kWithG).
template <class Cot>
int launch_split_sweep(const Cot& cot, const float* x, const float* z,
                       const float* params, float* xbar, float* part_x, double* part_s,
                       double* sums, int n, int m, int d, int family, int symmetric,
                       int splits, cudaStream_t stream) {
  if (d <= 8)
    return launch_split_sweep_kd<Cot, 8, false>(cot, x, z, params, xbar, part_x, part_s,
                                                sums, n, m, d, family, symmetric, splits, stream);
  if (d <= 16)
    return launch_split_sweep_kd<Cot, 16, false>(cot, x, z, params, xbar, part_x,
                                                 part_s, sums, n, m, d, family, symmetric,
                                                 splits, stream);
  if (d <= 32)
    return launch_split_sweep_kd<Cot, 32, false>(cot, x, z, params, xbar, part_x,
                                                 part_s, sums, n, m, d, family, symmetric,
                                                 splits, stream);
  return launch_split_sweep_kd<Cot, 32, true>(cot, x, z, params, xbar, part_x, part_s,
                                              sums, n, m, d, family, symmetric, splits, stream);
}

}  // namespace agp
