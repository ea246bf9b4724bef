// tri_inv_block: batched L^-1 of nb lower-triangular blocks of edge B <= 128 (a multiple
// of 8).
//
// Replaces abstractgps_tpu/ops/pallas_chol.py:405 (_tri_inv_block, pallas_call at :411,
// body :368-401), which ran once per block (_pallas_diag_inv) or vmapped over the nb
// diagonal blocks (_batched_diag_inv). Bound on the H100: per block ~B^3/3 flops against
// ~100 KB moved, latency-bound like chol_inv_block: the chain of a block's forward
// substitution, not bytes or operations. Design: the kGiven mode of the block routine of
// block_routines.cuh (the one routine of kernels 2, 3 and 7): 8-column group steps on
// register tiles, two barriers a group, L_gg's pivot reciprocals in IEEE FP32 (the TPU
// kernel used Newton doubling from the exact inverse diagonal; both give L^-1). One CTA
// per block (grid = nb, static shared memory): the block is read straight out of the
// caller's matrix through a row stride and a block stride (the diagonal blocks of an
// n x n factor need no gather copy), lower triangle only.
#include "block_routines.cuh"

extern "C" int agp_tri_inv_block(const float* L, long ld, long block_stride, int nb, int B,
                                 float* out, cudaStream_t stream) {
  if (B <= 0 || B > agp::kMaxBlock || B % agp::kGroup || nb <= 0)
    return (int)cudaErrorInvalidValue;
  agp::factor_block_kernel<true, true><<<nb, agp::kGroupThreads, 0, stream>>>(
      L, ld, nullptr, 0, out, B, 0, block_stride);
  return (int)cudaGetLastError();
}
