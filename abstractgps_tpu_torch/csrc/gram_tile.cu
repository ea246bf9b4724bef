// gram_tile: fused isotropic gram, K[i][j] = g(sum_k (x_ik - z_jk)^2).
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:128 (_fused_fwd_impl, pallas_call at :160).
// Bound on the H100: the n*m*4 output bytes (0.040 ms for 8192 x 4096 at 3.35 TB/s); the 3D
// operations of d^2 and the map's ~10 an entry stay under the FP32 rate for those bytes at
// D = 8, but not by much, so the design keeps the entry loop lean as well as the stores wide.
//
// Design: one CTA of 256 threads per 128 x 128 output tile (2048 CTAs at 8192 x 4096, three
// an SM at D <= 8). The family and KD (8, 16, 32 features held per column; a wide path past
// 32) are template parameters, so the map's switch folds away. The tile's rows of x land in
// shared memory as they lie (128 x d floats, 16-byte cp.async where x is 16-byte aligned) and
// z's 128 rows land transposed ([k][c], 4-byte cp.async, true width d). Each thread owns 4
// contiguous columns (their features in registers, read as one float4 per feature) and walks
// 16 rows, warp w taking rows w, w + 8, ...: per row it forms the 4 squared distances from the
// differences, d^2 = sum_k (x_ik - z_jk)^2 by FP32 FMA (no TF32, no tensor cores:
// ops/precision.py), so a symmetric gram is symmetric to the bit and d^2 rounds relative to
// itself (|x|^2 + |z|^2 - 2 x.z would round to eps |x|^2: 1e-2 at a 1-D time axis of [0, 100]),
// applies g, and stores the 4 entries
// as one float4 streaming store when m % 4 == 0 and out is 16-byte aligned (else as 4 scalar
// ones), so a warp writes 512 contiguous bytes per row. Past 32 features the differences read
// x and z through L1 (untuned; the main path has D = 8). The `symmetric` rule: d^2 = 0 where
// i == j.
#include "gram_sweep.cuh"

namespace {

constexpr int kRows = 128;     // output rows of a CTA
constexpr int kCols = 128;     // output columns of a CTA: 4 a lane
constexpr int kThreads = 256;  // 8 warps
constexpr int kZStride = 132;  // floats per feature row of the transposed z tile

// dynamic shared floats: x's rows, z's rows transposed
__host__ __device__ constexpr int tile_floats(int d, bool wide) {
  return wide ? 0 : kRows * d + d * kZStride;
}

template <int F, int KD, bool kWide>
__global__ void __launch_bounds__(kThreads, KD <= 8 ? 3 : (KD <= 16 ? 2 : 1))
    gram_tile_kernel(const float* __restrict__ x, const float* __restrict__ z,
                     float* __restrict__ out, const float* __restrict__ params, int n, int m,
                     int d, int symmetric, int vec_in, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;
  const int nrows = min(kRows, n - row0);
  float* xs = smem;                                    // [r][k], true width d
  float* zs = smem + kRows * d;                        // [k][c], row stride kZStride

  if (!kWide) {
    const float* xsrc = x + (long)row0 * d;  // the tile's rows are one contiguous run
    const int xcount = nrows * d;
    if (vec_in) {
      for (int e = 4 * tid; e < kRows * d; e += 4 * kThreads) {
        const int valid = min(max(xcount - e, 0), 4);
        agp::cp_async16(xs + e, valid ? xsrc + e : x, 4 * valid);
      }
    } else {
      for (int e = tid; e < kRows * d; e += kThreads)
        agp::cp_async4(xs + e, e < xcount ? xsrc + e : x, e < xcount ? 4 : 0);
    }
    const float* zsrc = z + (long)col0 * d;
    const int zcount = min(kCols, m - col0) * d;
    for (int e = tid; e < kCols * d; e += kThreads) {
      const int c = e / d, k = e - c * d;
      agp::cp_async4(zs + k * kZStride + c, e < zcount ? zsrc + e : z, e < zcount ? 4 : 0);
    }
    agp::cp_async_commit();
    agp::cp_async_wait<0>();
    __syncthreads();
  }

  // this thread's 4 columns' features (zero past d)
  const int c0 = col0 + 4 * lane;
  float zc[4][KD];
  if (!kWide) {
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < d) v = *reinterpret_cast<const float4*>(zs + k * kZStride + 4 * lane);
      zc[0][k] = v.x; zc[1][k] = v.y; zc[2][k] = v.z; zc[3][k] = v.w;
    }
  }
  const float p0 = (F == 4 || F == 5) ? params[0] : 0.f;

#pragma unroll 1
  for (int rl = warp; rl < nrows; rl += kThreads / 32) {
    const int r = row0 + rl;
    float s2[4] = {0.f, 0.f, 0.f, 0.f};
    if (kWide) {
      const float* xrow = x + (long)r * d;
      const float* zrow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) zrow[j] = z + (long)min(c0 + j, m - 1) * d;
      for (int k = 0; k < d; ++k) {
        const float xv = xrow[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float df = xv - zrow[j][k];
          s2[j] = fmaf(df, df, s2[j]);
        }
      }
    } else {
      const float* xrow = xs + rl * d;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const float xv = k < d ? xrow[k] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float df = xv - zc[j][k];
          s2[j] = fmaf(df, df, s2[j]);
        }
      }
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d2 = s2[j];
      if (symmetric && r == c0 + j) d2 = 0.f;
      v[j] = agp::apply_map(F, d2, p0);
    }
    float* dst = out + (long)r * m + c0;
    if (vec_out) {
      if (c0 < m) __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < m) __stcs(dst + j, v[j]);
    }
  }
}

template <int F, int KD, bool kWide>
int launch(const float* x, const float* z, float* out, const float* params, int n, int m, int d,
           int symmetric, int vec_in, int vec_out, cudaStream_t stream) {
  const int smem = tile_floats(d, kWide) * (int)sizeof(float);  // <= 33.3 KB at d <= 32
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  gram_tile_kernel<F, KD, kWide><<<grid, kThreads, smem, stream>>>(
      x, z, out, params, n, m, d, symmetric, vec_in, vec_out);
  return (int)cudaGetLastError();
}

template <int F>
int launch_family(const float* x, const float* z, float* out, const float* params, int n, int m,
                  int d, int symmetric, int vec_in, int vec_out, cudaStream_t stream) {
  if (d <= 8)
    return launch<F, 8, false>(x, z, out, params, n, m, d, symmetric, vec_in, vec_out, stream);
  if (d <= 16)
    return launch<F, 16, false>(x, z, out, params, n, m, d, symmetric, vec_in, vec_out, stream);
  if (d <= 32)
    return launch<F, 32, false>(x, z, out, params, n, m, d, symmetric, vec_in, vec_out, stream);
  return launch<F, 32, true>(x, z, out, params, n, m, d, symmetric, vec_in, vec_out, stream);
}

}  // namespace

// x (n, d), z (m, d) row-major; out (n, m); params: the map's hyperparameter buffer. One launch.
extern "C" int agp_gram_tile(const float* x, const float* z, float* out, const float* params,
                             int n, int m, int d, int family, int symmetric,
                             cudaStream_t stream) {
  if (family < 0 || family > 6 || n <= 0 || m <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using Launch = int (*)(const float*, const float*, float*, const float*, int, int, int, int,
                         int, int, cudaStream_t);
  constexpr Launch by_family[7] = {launch_family<0>, launch_family<1>, launch_family<2>,
                                   launch_family<3>, launch_family<4>, launch_family<5>,
                                   launch_family<6>};
  return by_family[family](x, z, out, params, n, m, d, symmetric, vec_in, vec_out, stream);
}
