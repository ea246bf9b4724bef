// chol_inv_block: (L, L^-1) of one SPD block of edge B <= 128, lower triangle read.
//
// Replaces abstractgps_tpu/ops/pallas_chol.py:179 (_chol_inv_block, pallas_call at :188,
// body :77-175). Bound on the H100: neither bytes (128 KB in and out) nor flops (~B^3
// = 2 MFLOP) -- the serial column chain of one factorization is latency-bound. Design: one
// CTA holds M and W (64 KB each) in dynamic shared memory, so every one of the B column
// steps is a few shared-memory passes and a barrier; 512 threads split each trailing
// update. The factor is plain lower (the TPU kernel's L^T layout was a store-layout
// choice). The inverse is exact forward substitution, so no Newton polish is needed.
#include "block_routines.cuh"

extern "C" int agp_chol_inv_block(const float* A, long lda, float* L, float* W, int B,
                                  cudaStream_t stream) {
  if (B <= 0 || B > agp::kMaxBlock) return (int)cudaErrorInvalidValue;
  const int smem = agp::block_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(agp::factor_invert_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  agp::factor_invert_block_kernel<<<1, agp::kBlockThreads, smem, stream>>>(A, lda, L, B, W, B,
                                                                          0);
  return (int)cudaGetLastError();
}
