// chol_block: the plain-lower Cholesky factor of one SPD block of edge B <= 128 (a
// multiple of 8), lower triangle read, upper triangle of L zeroed.
//
// Replaces abstractgps_tpu/ops/pallas_chol.py:455 (_chol_block, pallas_call at :460, body
// _chol_block_body :425-451: B masked rank-1 steps). Nothing in the JAX package calls it.
// Bound on the H100: neither bytes (2 B^2 floats) nor operations (B^3/3) -- the serial
// column chain is latency-bound, as in the factor half of chol_inv_block and of each
// diagonal block of slab_factor. So one design serves kernels 2, 3 and 7: this launches
// the block routine of block_routines.cuh without its inverse (8-column group steps on
// register tiles, one CTA).
#include "block_routines.cuh"

extern "C" int agp_chol_block(const float* A, long lda, float* L, int B, cudaStream_t stream) {
  if (B <= 0 || B > agp::kMaxBlock || B % agp::kGroup) return (int)cudaErrorInvalidValue;
  agp::factor_block_kernel<false><<<1, agp::kGroupThreads, 0, stream>>>(A, lda, L, B, nullptr,
                                                                        B, 0, 0);
  return (int)cudaGetLastError();
}
