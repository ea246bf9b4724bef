// tri_inv_block: batched L^-1 of nb lower-triangular blocks of edge B <= 128.
//
// Replaces abstractgps_tpu/ops/pallas_chol.py:405 (_tri_inv_block, pallas_call at :411,
// body :368-401), which ran once per block (_pallas_diag_inv) or vmapped over the nb
// diagonal blocks (_batched_diag_inv). Bound on the H100: per block ~B^3/3 flops against
// 128 KB moved, latency-bound like chol_inv_block; the batch fills the card with one CTA
// per block (grid = nb). Design: the block is read straight out of the caller's matrix
// through a row stride and a block stride (the diagonal blocks of an n x n factor need no
// gather copy), held in shared memory with its inverse, and inverted by exact forward
// substitution (the TPU kernel used Newton doubling; both give L^-1).
#include "block_routines.cuh"

namespace {

__global__ void tri_inv_kernel(const float* __restrict__ L, long ld, long block_stride,
                               float* __restrict__ out, int B) {
  extern __shared__ float smem[];
  float* Ls = smem;
  float* W = smem + B * B;
  const float* Lb = L + blockIdx.x * block_stride;
  float* ob = out + (long)blockIdx.x * B * B;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < B * B; e += nt) {
    const int r = e / B, c = e % B;
    Ls[e] = (c <= r) ? Lb[r * ld + c] : 0.f;
  }
  agp::invert_lower_smem(Ls, W, B);
  for (int e = tid; e < B * B; e += nt) ob[e] = W[e];
}

}  // namespace

extern "C" int agp_tri_inv_block(const float* L, long ld, long block_stride, int nb, int B,
                                 float* out, cudaStream_t stream) {
  if (B <= 0 || B > agp::kMaxBlock || nb <= 0) return (int)cudaErrorInvalidValue;
  const int smem = agp::block_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(tri_inv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tri_inv_kernel<<<nb, agp::kBlockThreads, smem, stream>>>(L, ld, block_stride, out, B);
  return (int)cudaGetLastError();
}
