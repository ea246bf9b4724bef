// Isotropic gram maps, their VJPs (also used by gram_bwd.cu's column-split sweep), and the
// row-block backward sweep of logpdf_contraction.cu (the map alone is also gram_tile.cu's
// epilogue).
//
// The row-block sweep: one CTA owns a block of kSweepTile rows of the row operand x and walks over every
// column tile of z in order. Per tile it rebuilds d^2 = max(|x_i|^2 + |z_j|^2 - 2 x_i.z_j, 0)
// with FP32 FMA (as gram_tile does), has a loader put the cotangent tile C in shared memory,
// applies the map's VJP in the epilogue, and accumulates
//   xbar[i]   += xscale * sum_j w_ij (x_i - z_j),   w = (cscale C) * dg/dd^2   (diagonal 0 if symmetric)
//   pbar      += sum (cscale C) * dg/dp              (RQ alpha, gamma)
//   gsum_part += sum C * g                           (the sigma^2 bar of logpdf_contraction)
// The CTA owns its xbar rows, so they are read-modify-written without atomics; the two scalar sums
// are per-thread FP64 accumulators reduced over the CTA in a fixed tree into per-CTA partials,
// which reduce_partials adds in block order. Same inputs, same bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace agp {

constexpr int kSweepTile = 64;
constexpr int kSweepThreads = 16;  // 16 x 16 threads, 4 x 4 tile entries each
constexpr int kSweepChunk = 32;    // features staged per pass
constexpr int kSweepBlock = kSweepThreads * kSweepThreads;

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

struct SweepSmem {
  float xs[kSweepChunk][kSweepTile + 1];  // row-operand features of one chunk
  float zs[kSweepChunk][kSweepTile + 1];  // column-operand features of one chunk
  float cs[kSweepTile][kSweepTile + 1];   // the cotangent tile, then w
  double red[kSweepBlock][2];
};

// Stage features k0..k0+kc of rows base..base+63 of a (rows x d) row-major matrix as [k][r],
// zero outside.
__device__ __forceinline__ void stage_rows(const float* __restrict__ a, int base, int rows, int d,
                                           int k0, float (*dst)[kSweepTile + 1], int tid) {
  const int kc = min(kSweepChunk, d - k0);
  for (int e = tid; e < kSweepTile * kSweepChunk; e += kSweepBlock) {
    const int r = e / kSweepChunk, k = e % kSweepChunk;
    dst[k][r] = (k < kc && base + r < rows) ? a[(long)(base + r) * d + k0 + k] : 0.f;
  }
}

// The sweep of one CTA over its row block (blockIdx.x). load_cot(row0, col0, tid, cs) fills the
// unscaled cotangent tile (zero outside the n x m range) and ends with __syncthreads().
template <class LoadCot>
__device__ void row_block_sweep(const float* __restrict__ x, const float* __restrict__ z, int n,
                                int m, int d, int family, float p0, float cscale, int symmetric,
                                float xscale, const LoadCot& load_cot, float* __restrict__ xbar,
                                double* __restrict__ partial, SweepSmem& sm) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSweepThreads + tx;
  const int row0 = blockIdx.x * kSweepTile;
  // this CTA's xbar rows start at 0; each entry is owned by one thread for the whole sweep
  for (int k0 = 0; k0 < d; k0 += kSweepChunk) {
    const int kc = min(kSweepChunk, d - k0);
    for (int e = tid; e < kSweepTile * kc; e += kSweepBlock) {
      const int r = row0 + e % kSweepTile;
      if (r < n) xbar[(long)r * d + k0 + e / kSweepTile] = 0.f;
    }
  }
  double acc_p = 0.0, acc_g = 0.0;
  for (int col0 = 0; col0 < m; col0 += kSweepTile) {
    float dot[4][4] = {};
    float nx[4] = {}, nz[4] = {};
    for (int k0 = 0; k0 < d; k0 += kSweepChunk) {
      stage_rows(x, row0, n, d, k0, sm.xs, tid);
      stage_rows(z, col0, m, d, k0, sm.zs, tid);
      __syncthreads();
      const int kc = min(kSweepChunk, d - k0);
      for (int k = 0; k < kc; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sm.xs[k][ty + kSweepThreads * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sm.zs[k][tx + kSweepThreads * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          nx[i] = fmaf(a[i], a[i], nx[i]);
          nz[i] = fmaf(b[i], b[i], nz[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(a[i], b[j], dot[i][j]);
        }
      }
      __syncthreads();
    }

    load_cot(row0, col0, tid, sm.cs);

    // epilogue: each thread turns its own 16 cotangent entries into w in place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + kSweepThreads * i, r = row0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + kSweepThreads * j, c = col0 + cl;
        float w = 0.f;
        if (r < n && c < m) {
          const bool diag = symmetric && r == c;
          const float d2 = diag ? 0.f : fmaxf(nx[i] + nz[j] - 2.f * dot[i][j], 0.f);
          const MapVjp v = map_vjp(family, d2, p0);
          const float ct = sm.cs[rl][cl], cot = ct * cscale;
          acc_p += (double)(cot * v.dp);
          acc_g += (double)(ct * v.g);
          if (!diag) w = cot * v.dg;
        }
        sm.cs[rl][cl] = w;
      }
    }
    __syncthreads();

    // xbar rows += xscale * sum_c w[r][c] (x_r - z_c), by feature chunk (the staged chunk of
    // the distance pass is still in place when d fits one chunk)
    for (int k0 = 0; k0 < d; k0 += kSweepChunk) {
      const int kc = min(kSweepChunk, d - k0);
      if (d > kSweepChunk) {
        stage_rows(x, row0, n, d, k0, sm.xs, tid);
        stage_rows(z, col0, m, d, k0, sm.zs, tid);
        __syncthreads();
      }
      for (int e = tid; e < kSweepTile * kc; e += kSweepBlock) {
        const int rl = e % kSweepTile, k = e / kSweepTile, r = row0 + rl;
        if (r >= n) continue;
        const float xr = sm.xs[k][rl];
        float s = 0.f;
#pragma unroll 8
        for (int cl = 0; cl < kSweepTile; ++cl) s = fmaf(sm.cs[rl][cl], xr - sm.zs[k][cl], s);
        xbar[(long)r * d + k0 + k] += xscale * s;
      }
      __syncthreads();
    }
  }

  sm.red[tid][0] = acc_p;
  sm.red[tid][1] = acc_g;
  __syncthreads();
  for (int s = kSweepBlock / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sm.red[tid][0] += sm.red[tid + s][0];
      sm.red[tid][1] += sm.red[tid + s][1];
    }
    __syncthreads();
  }
  if (tid == 0) {
    partial[2 * blockIdx.x] = sm.red[0][0];
    partial[2 * blockIdx.x + 1] = sm.red[0][1];
  }
}

// sums[t] = partial[0][t] + partial[1][t] + ... in block order (one thread per slot).
static __global__ void reduce_partials_kernel(const double* __restrict__ partial, int nblocks,
                                              double* __restrict__ sums) {
  const int t = threadIdx.x;
  if (t >= 2) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += partial[2 * b + t];
  sums[t] = s;
}

}  // namespace agp
