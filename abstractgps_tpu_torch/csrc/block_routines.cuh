// Shared-memory routines for one diagonal block, used by chol_inv_block, slab_factor and
// tri_inv_block. A block of edge B <= 128 is held row-major in dynamic shared memory
// (B*B floats per matrix, 64 KB at B = 128); one CTA works on it with all its threads.
#pragma once

#include <cuda_runtime.h>

namespace agp {

constexpr int kMaxBlock = 128;
constexpr int kBlockThreads = 512;

__host__ __device__ constexpr int block_smem_bytes(int B) { return 2 * B * B * (int)sizeof(float); }

// In-place right-looking Cholesky of the symmetric matrix M (lower triangle read and
// written, upper never touched). Column j: d = sqrt(pivot), scale the column, then the
// rank-1 update of the trailing lower triangle. A negative pivot gives sqrt -> NaN, which
// the trailing updates carry into every later column (the failure-detection contract).
__device__ inline void factor_lower_smem(float* M, int B) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < B; ++j) {
    __syncthreads();
    const float dj = sqrtf(M[j * B + j]);
    __syncthreads();
    for (int i = j + tid; i < B; i += nt) M[i * B + j] = (i == j) ? dj : M[i * B + j] / dj;
    __syncthreads();
    const int r = B - j - 1;
    for (int e = tid; e < r * r; e += nt) {
      const int i = j + 1 + e / r, k = j + 1 + e % r;
      if (k <= i) M[i * B + k] = fmaf(-M[i * B + j], M[k * B + j], M[i * B + k]);
    }
  }
  __syncthreads();
}

// W = L^-1 for the lower-triangular L (lower triangle read), by right-looking forward
// substitution on the rows of W: row j is divided by L[j][j], then L[i][j] * row j is
// subtracted from every later row i. W's strict upper triangle is exactly zero.
__device__ inline void invert_lower_smem(const float* L, float* W, int B) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < B * B; e += nt) W[e] = (e / B == e % B) ? 1.f : 0.f;
  for (int j = 0; j < B; ++j) {
    __syncthreads();
    const float d = L[j * B + j];
    for (int c = tid; c <= j; c += nt) W[j * B + c] /= d;
    __syncthreads();
    const int r = B - j - 1, w = j + 1;
    for (int e = tid; e < r * w; e += nt) {
      const int i = j + 1 + e / w, c = e % w;
      W[i * B + c] = fmaf(-L[i * B + j], W[j * B + c], W[i * B + c]);
    }
  }
  __syncthreads();
}

// Factor + invert one SPD block read from A (row stride lda, lower triangle only).
// Writes the plain-lower factor to L (row stride ldl, upper triangle zeroed), zeroes the
// zero_cols columns of L to the right of the block (the slab's upper triangle), and
// writes L^-1 to Winv (B x B, contiguous).
// (static: each translation unit that launches it keeps its own copy.)
static __global__ void factor_invert_block_kernel(const float* __restrict__ A, long lda,
                                                  float* __restrict__ L, long ldl,
                                                  float* __restrict__ Winv, int B,
                                                  int zero_cols) {
  extern __shared__ float smem[];
  float* M = smem;
  float* W = smem + B * B;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < B * B; e += nt) {
    const int r = e / B, c = e % B;
    M[e] = (c <= r) ? A[r * lda + c] : 0.f;
  }
  factor_lower_smem(M, B);
  invert_lower_smem(M, W, B);
  for (int e = tid; e < B * B; e += nt) {
    const int r = e / B, c = e % B;
    L[r * ldl + c] = (c <= r) ? M[e] : 0.f;
    Winv[e] = W[e];
  }
  for (long e = tid; e < (long)B * zero_cols; e += nt) {
    const long r = e / zero_cols, c = e % zero_cols;
    L[r * ldl + B + c] = 0.f;
  }
}

}  // namespace agp
