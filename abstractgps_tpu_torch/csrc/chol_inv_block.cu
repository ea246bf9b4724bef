// chol_inv_block: (L, L^-1) of one SPD block of edge B <= 128 (a multiple of 8), lower
// triangle read.
//
// Replaces abstractgps_tpu/ops/pallas_chol.py:179 (_chol_inv_block, pallas_call at :188,
// body :77-175). Bound on the H100: neither bytes (128 KB in and out) nor flops (~B^3
// = 2 MFLOP) -- the serial chain of one factorization is latency-bound. Design: one CTA
// runs the block routine of block_routines.cuh, which factors and inverts in one pass of
// B/8 group steps on register tiles (two barriers a group). The factor is plain lower (the
// TPU kernel's L^T layout was a store-layout choice). The inverse is exact blocked forward
// substitution, so no Newton polish is needed.
#include "block_routines.cuh"

extern "C" int agp_chol_inv_block(const float* A, long lda, float* L, float* W, int B,
                                  cudaStream_t stream) {
  if (B <= 0 || B > agp::kMaxBlock || B % agp::kGroup) return (int)cudaErrorInvalidValue;
  agp::factor_block_kernel<true><<<1, agp::kGroupThreads, 0, stream>>>(A, lda, L, B, W, B, 0, 0);
  return (int)cudaGetLastError();
}
