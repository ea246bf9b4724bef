// gram_tile: fused isotropic gram tile, K[i][j] = g(max(|x_i|^2 + |z_j|^2 - 2 x_i.z_j, 0)).
//
// Replaces abstractgps_tpu/ops/pallas_gram.py:128 (_fused_fwd_impl, pallas_call at :160).
// Bound on the H100: the n*m*4 output bytes (D is small, 2*D flops per entry), so the
// kernel is memory-bound. Design: one 64x64 output tile per CTA, 16x16 threads with 4x4
// outputs each; the x and z row tiles are staged in shared memory in feature chunks of 32,
// the row norms are accumulated from the same staged values, and the map g is applied in
// the epilogue so d^2 never reaches device memory. Plain FP32 FMA, no tensor cores: the
// distance expansion is cancellation-prone and must run at full f32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 16;
constexpr int kChunk = 32;

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

__global__ void gram_tile_kernel(const float* __restrict__ x, const float* __restrict__ z,
                                 float* __restrict__ out, const float* __restrict__ params,
                                 int n, int m, int d, int family, int symmetric) {
  __shared__ float xs[kChunk][kTile + 1];
  __shared__ float zs[kChunk][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;

  float dot[4][4] = {};
  float nx[4] = {}, nz[4] = {};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    for (int e = tid; e < kTile * kChunk; e += kThreads * kThreads) {
      const int r = e / kChunk, k = e % kChunk;
      float xv = 0.f, zv = 0.f;
      if (k < kc) {
        if (row0 + r < n) xv = x[(long)(row0 + r) * d + k0 + k];
        if (col0 + r < m) zv = z[(long)(col0 + r) * d + k0 + k];
      }
      xs[k][r] = xv;
      zs[k][r] = zv;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + kThreads * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = zs[k][tx + kThreads * j];
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

  const float p0 = (family == 4 || family == 5) ? params[0] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + kThreads * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + kThreads * j;
      if (c >= m) continue;
      float d2 = fmaxf(nx[i] + nz[j] - 2.f * dot[i][j], 0.f);
      if (symmetric && r == c) d2 = 0.f;
      out[(long)r * m + c] = apply_map(family, d2, p0);
    }
  }
}

}  // namespace

extern "C" int agp_gram_tile(const float* x, const float* z, float* out, const float* params,
                             int n, int m, int d, int family, int symmetric,
                             cudaStream_t stream) {
  if (family < 0 || family > 6 || n <= 0 || m <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const dim3 block(kThreads, kThreads);
  gram_tile_kernel<<<grid, block, 0, stream>>>(x, z, out, params, n, m, d, family, symmetric);
  return (int)cudaGetLastError();
}
