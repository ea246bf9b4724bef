// slab_factor: factor + invert one W x W SPD slab-diagonal block (W a multiple of B),
// lower triangle read. Outputs the plain-lower slab factor L (W x W, upper triangle zeroed)
// and the W/B inverses of its B x B diagonal blocks.
//
// Replaces abstractgps_tpu/ops/pallas_chol.py:339 (_slab_factor, pallas_call at :347,
// body _slab_body :298, _factor_invert_values :233, _sdot :210). A 1024^2 f32 slab is 4 MB:
// it sat in one TPU core's VMEM, but cannot sit in one SM's 227 KB of shared memory, so the
// design differs. The slab stays in device memory, L2-resident (50 MB L2). For each
// diagonal block k, a fixed sequence of three launches on the caller's stream:
//   1. factor_invert_block_kernel (one CTA, shared memory): L_kk and W_k = L_kk^-1,
//   2. gemm_nt: the slab-local panel L21 = P W_k^T (the TPU kernel's L21^T = W_k P^T),
//   3. gemm_nt: the trailing update S22 -= L21 L21^T, lower tiles only.
// Bound on the H100: W^3/3 flops (0.36 GFLOP at W = 1024) against 12 MB moved, so
// operations at the FP32 rate -- but the eight serial diagonal factorizations dominate a
// simple implementation. The panel and trailing products are hand-written tiled FP32 FMA
// (64x64 output tiles, 16x16 threads, 4x4 outputs each), never TF32.
#include "block_routines.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 16;

// C[M x N] = alpha * A[M x K] B[N x K]^T (+ C when accumulate). lower_only: skip the
// tiles and entries above the diagonal of C.
__global__ void gemm_nt_kernel(int M, int N, int K, const float* __restrict__ A, long lda,
                               const float* __restrict__ Bm, long ldb, float* __restrict__ C,
                               long ldc, float alpha, int accumulate, int lower_only) {
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  if (lower_only && col0 > row0 + kTile - 1) return;
  __shared__ float As[kDepth][kTile + 1];
  __shared__ float Bs[kDepth][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kThreads * kThreads) {
      const int r = e / kDepth, k = e % kDepth;
      const bool kin = k0 + k < K;
      As[k][r] = (kin && row0 + r < M) ? A[(long)(row0 + r) * lda + k0 + k] : 0.f;
      Bs[k][r] = (kin && col0 + r < N) ? Bm[(long)(col0 + r) * ldb + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + kThreads * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + kThreads * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + kThreads * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + kThreads * j;
      if (c >= N || (lower_only && c > r)) continue;
      float* dst = C + (long)r * ldc + c;
      *dst = accumulate ? fmaf(alpha, acc[i][j], *dst) : alpha * acc[i][j];
    }
  }
}

cudaError_t gemm_nt(int M, int N, int K, const float* A, long lda, const float* Bm, long ldb,
                    float* C, long ldc, float alpha, int accumulate, int lower_only,
                    cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const dim3 block(kThreads, kThreads);
  gemm_nt_kernel<<<grid, block, 0, stream>>>(M, N, K, A, lda, Bm, ldb, C, ldc, alpha,
                                             accumulate, lower_only);
  return cudaGetLastError();
}

}  // namespace

// S: the W x W slab (read only). work: W x W scratch that the trailing updates overwrite.
extern "C" int agp_slab_factor(const float* S, float* L, float* Winv, float* work, int W,
                               int B, cudaStream_t stream) {
  if (B <= 0 || B > agp::kMaxBlock || W <= 0 || W % B) return (int)cudaErrorInvalidValue;
  const int smem = agp::block_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(agp::factor_invert_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(work, S, (size_t)W * W * sizeof(float), cudaMemcpyDeviceToDevice,
                        stream);
  if (err != cudaSuccess) return (int)err;
  const long ld = W;
  for (int k = 0; k < W / B; ++k) {
    const long r0 = (long)k * B;
    const int rest = W - (int)r0 - B;
    float* Wk = Winv + r0 * B;
    agp::factor_invert_block_kernel<<<1, agp::kBlockThreads, smem, stream>>>(
        work + r0 * ld + r0, ld, L + r0 * ld + r0, ld, Wk, B, rest);
    err = cudaGetLastError();
    if (err != cudaSuccess || rest == 0) return (int)err;
    float* L21 = L + (r0 + B) * ld + r0;
    // panel: L21 = P W_k^T with P = work[r0+B:, r0:r0+B]
    err = gemm_nt(rest, B, B, work + (r0 + B) * ld + r0, ld, Wk, B, L21, ld, 1.f, 0, 0, stream);
    if (err != cudaSuccess) return (int)err;
    // trailing: work[r0+B:, r0+B:] -= L21 L21^T (lower triangle)
    err = gemm_nt(rest, rest, B, L21, ld, L21, ld, work + (r0 + B) * ld + r0 + B, ld, -1.f, 1,
                  1, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
