// The routine for one diagonal block of edge B <= 128 (a multiple of 8), one CTA a block,
// behind chol_inv_block, slab_factor, chol_block and tri_inv_block.
//
// factor_block_kernel<kInverse, kGiven> is designed for one SM of the H100. The serial chain
// of a 128-block (~1.4 MFLOP for the factor and its inverse) bounds it, not bytes or
// operations, so the design shortens that chain:
//   * Register tiles. The block is cut into 8 x 8 tiles; each tile of the lower triangle
//     (136 at B = 128) belongs to two threads (4 rows each) and stays in their registers
//     for the whole run: first as a tile of the trailing matrix M, then, once its column
//     group is factored, as a tile of the right-hand side X of the inverse's forward
//     substitution L W = I (X starts as I; the two uses never overlap in time).
//   * Group steps of 8 columns, as the TPU kernel's (pallas_chol.py:121-163). In step g
//     every thread factors the 8 x 8 diagonal block itself, in registers, from broadcast
//     shared-memory reads (rsqrt of each pivot, as the TPU kernel took it); thread k then
//     solves row k of the panel, L[k, g] = M[k, g] L_gg^-T, and column k of W's row group,
//     W[g, k] = L_gg^-1 X[g, k] (exact substitution, so no Newton polish is needed), while
//     threads 128-255 write the previous group's L columns out. One rank-8 update of every
//     live tile follows: M -= L[., g] L[., g]^T below the group, X -= L[., g] W[g, .].
//     Two barriers a group (32 at B = 128, where the column loop had ~640), no division
//     or modulo in any loop.
//   * kGiven (tri_inv_block): L is given and only inverted. Every tile starts as X, step g
//     reads L_gg from the staged column group and takes its 8 pivot reciprocals (IEEE, as
//     the TPU kernel started from the exact inverse diagonal) instead of factoring, and the
//     column group L[:, g] is read from global memory instead of solved: threads 128-255
//     load group g + 1 into registers during step g and stage it after the update, so the
//     load overlaps the step. No M tiles, no factor, no write-out; a batch of blocks runs
//     one CTA per block (blockIdx.x, block stride a_stride).
//   * Shared memory holds only the group's panel, its L columns, and X's and W's rows
//     (29 KB, padded so the tile reads and stores fall on distinct banks; 25 KB with
//     kGiven, which has no panel).
//   * IEEE FP32 FMAs throughout. Tensor cores buy nothing on a latency-bound 128-block,
//     and TF32 would corrupt the pivots (ops/precision.py).
// Contract: the lower triangle of A is read, nothing above it; L is plain lower with its
// upper triangle zeroed; W = L^-1 with its strict upper triangle exactly zero; a negative
// pivot gives NaN, which the later groups carry; B is a multiple of 8.
#pragma once

#include <cuda_runtime.h>

namespace agp {

constexpr int kMaxBlock = 128;
constexpr int kGroup = 8;      // columns of one group step = edge of a tile
constexpr int kTileRows = 4;   // rows of a tile held by one thread: two threads a tile
constexpr int kSplit = kGroup / kTileRows;
constexpr int kMaxTiles = (kMaxBlock / kGroup) * (kMaxBlock / kGroup + 1) / 2;  // 136
// threads 0-127: panel rows; 128-255: L write-out; 0-271: tile rows
constexpr int kGroupThreads = 288;
static_assert(kGroupThreads >= 2 * kMaxBlock && kGroupThreads >= kMaxTiles * kSplit &&
                  kGroupThreads % 32 == 0,
              "a panel row, a write-out thread and a tile half per thread");
// The [t][row] shared arrays (L's columns, X's and W's rows of a group) pad each 8-row
// block by 4 floats (tr below), so the float4 reads of tiles side by side fall on
// distinct banks; a row stride of 196 = 4 (mod 32) does the same for the 8 rows t.
constexpr int kRowStride = 196;
static_assert(kRowStride >= kMaxBlock + kMaxBlock / 2 && kRowStride % 32 == 4, "padding");
// the panel M[:, g] is stored by 8-row tiles, each padded by 4 floats, so the tile stores
// of different threads fall on distinct banks
constexpr int kPanelTile = kGroup * kGroup + 4;
static_assert(kGroup == 8, "the L write-out puts 8 threads on a row");
static_assert(kTileRows % 4 == 0, "a tile's rows are read as float4s");

using Tile = float[kTileRows][kGroup];

__device__ __forceinline__ int panel_row(int r) { return (r >> 3) * kPanelTile + (r & 7) * kGroup; }
__device__ __forceinline__ int tr(int r) { return r + (r >> 3) * 4; }

__device__ __forceinline__ void store_tile_rows(float* dst, int ld, const Tile& t) {
#pragma unroll
  for (int a = 0; a < kTileRows; ++a) {
    float4* d = reinterpret_cast<float4*>(dst + a * ld);
    d[0] = make_float4(t[a][0], t[a][1], t[a][2], t[a][3]);
    d[1] = make_float4(t[a][4], t[a][5], t[a][6], t[a][7]);
  }
}

// the tile's rows row0.. of I (diagonal tile) or of 0
__device__ __forceinline__ void set_identity_or_zero(Tile& t, bool identity, int row0) {
#pragma unroll
  for (int a = 0; a < kTileRows; ++a)
#pragma unroll
    for (int b = 0; b < kGroup; ++b) t[a][b] = (identity && row0 + a == b) ? 1.f : 0.f;
}

template <int N>
__device__ __forceinline__ void load_n(const float* src, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(src)[q];
    v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
  }
}

// L's column group j0 out of lc ([t][row]) by the write-out threads w = 0..127, 8 threads
// to a row (one 32-byte sector), zero above the diagonal block.
__device__ __forceinline__ void write_l_group(float* L, long ldl, const float* lc, int j0,
                                              int B, int w) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int e = w + i * kMaxBlock, r = e >> 3, t = e & (kGroup - 1);
    if (r < B) L[(long)r * ldl + j0 + t] = (r >= j0) ? lc[t * kRowStride + tr(r)] : 0.f;
  }
}

// The given L's column group j0, rows j0.. (lower triangle only, 0 above it), into v by the
// threads w = 0..127 in the layout of write_l_group, and from v into lc ([t][row]).
__device__ __forceinline__ void load_l_group(const float* A, long lda, int j0, int B, int w,
                                             float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int e = w + i * kMaxBlock, r = e >> 3, t = e & (kGroup - 1);
    v[i] = (r >= j0 + t && r < B) ? A[(long)r * lda + j0 + t] : 0.f;
  }
}

__device__ __forceinline__ void stage_l_group(float* lc, int j0, int B, int w,
                                              const float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int e = w + i * kMaxBlock, r = e >> 3, t = e & (kGroup - 1);
    if (r >= j0 && r < B) lc[t * kRowStride + tr(r)] = v[i];
  }
}

// The factor (kInverse: and the inverse) of one SPD block read from A (row stride lda,
// lower triangle only). Writes the plain-lower factor to L (row stride ldl, upper triangle
// zeroed), zeroes the zero_cols columns of L to the right of the block (the slab's upper
// triangle; L 16-byte aligned, ldl and zero_cols multiples of 4, when zero_cols > 0), and
// with kInverse writes L^-1 to Winv (B x B, contiguous).
// kGiven: A holds lower-triangular blocks, block blockIdx.x at A + blockIdx.x * a_stride;
// writes the inverse of each to Winv + blockIdx.x * B * B (L, ldl, zero_cols unused).
// One CTA of kGroupThreads threads a block, static shared memory only.
// (static: each translation unit that launches it keeps its own copy.)
template <bool kInverse, bool kGiven = false>
static __global__ void __launch_bounds__(kGroupThreads)
    factor_block_kernel(const float* __restrict__ A, long lda, float* __restrict__ L, long ldl,
                        float* __restrict__ Winv, int B, int zero_cols, long a_stride) {
  static_assert(kInverse || !kGiven, "a given factor is only inverted");
  // M[:, g]
  __shared__ __align__(16) float panel[kGiven ? 4 : kMaxBlock / kGroup * kPanelTile];
  __shared__ __align__(16) float lcol[2][kGroup * kRowStride];  // L[:, g], [t][row], by g & 1
  __shared__ __align__(16) float xrow[kInverse ? kGroup * kRowStride : 4];  // X[g, :], [t][col]
  __shared__ __align__(16) float wrow[kInverse ? kGroup * kRowStride : 4];  // W[g, :], [t][col]
  const int tid = threadIdx.x;
  const int groups = B / kGroup;
  const bool loader = tid >= kMaxBlock && tid < 2 * kMaxBlock;  // the L write-out (or load)
  if (kGiven) {
    A += blockIdx.x * a_stride;
    Winv += (long)blockIdx.x * B * B;
  }

  // this thread's rows row0.. of tile (ti, tj) of the lower triangle, the tiles in
  // reversed row-major order (the top rows, idle first, go to the last warps)
  const int tiles = groups * (groups + 1) / 2;
  const int row0 = (tid % kSplit) * kTileRows;
  int ti = 0, tj = tiles - 1 - tid / kSplit;
  while (tj > ti) {
    tj -= ti + 1;
    ++ti;
  }
  const bool has_tile = tid < tiles * kSplit;
  Tile tile;
  float next[kGroup];  // kGiven: the next column group of L, loaded a step ahead
  if (kGiven) {
    if (has_tile) set_identity_or_zero(tile, ti == tj, row0);
    if (loader) {
      load_l_group(A, lda, 0, B, tid - kMaxBlock, next);
      stage_l_group(lcol[0], 0, B, tid - kMaxBlock, next);
    }
  } else if (has_tile) {
    const float* src = A + (long)(ti * kGroup + row0) * lda + tj * kGroup;
#pragma unroll
    for (int a = 0; a < kTileRows; ++a)
#pragma unroll
      for (int b = 0; b < kGroup; ++b)
        tile[a][b] = (ti > tj || b <= row0 + a) ? src[a * lda + b] : 0.f;
    if (tj == 0) {
      store_tile_rows(panel + ti * kPanelTile + row0 * kGroup, kGroup, tile);
      if (kInverse) set_identity_or_zero(tile, ti == 0, row0);
    }
  }
  __syncthreads();

  for (int g = 0; g < groups; ++g) {
    const int j0 = g * kGroup;
    float* lc = lcol[g & 1];
    const int k = tid;
    if (k < B) {
      // the diagonal block's factor (kGiven: the given block), by every thread (broadcast
      // reads), and the reciprocals of its pivots
      float d[kGroup][kGroup], rinv[kGroup];
      if (kGiven) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) d[i][j] = lc[j * kRowStride + tr(j0 + i)];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) rinv[t] = __frcp_rn(d[t][t]);
      } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) d[i][j] = panel[g * kPanelTile + i * kGroup + j];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          // rsqrt of the pivot, as the TPU kernel took it (one MUFU op on the serial chain,
          // where an IEEE sqrt and division cost ~100 cycles a column)
          rinv[t] = rsqrtf(d[t][t]);
          d[t][t] *= rinv[t];
#pragma unroll
          for (int i = t + 1; i < kGroup; ++i) d[i][t] *= rinv[t];
#pragma unroll
          for (int i = t + 1; i < kGroup; ++i)
#pragma unroll
            for (int j = t + 1; j <= i; ++j) d[i][j] = fmaf(-d[i][t], d[j][t], d[i][j]);
        }
      }
      // row k of L's column group: L[k, g] = M[k, g] L_gg^-T, zero above the diagonal
      // (staged in lc, written to L in the next group step)
      if (!kGiven && k >= j0) {
        float p[kGroup], l[kGroup];
        load_n(panel + panel_row(k), p);
        const int kk = k - j0;  // < kGroup inside the diagonal block
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          float acc = p[t];
#pragma unroll
          for (int s = 0; s < t; ++s) acc = fmaf(-l[s], d[t][s], acc);
          l[t] = (kk > t) ? acc * rinv[t] : ((kk == t) ? d[t][t] : 0.f);
          lc[t * kRowStride + tr(k)] = l[t];
        }
      }
      if (kInverse) {
        // column k of W's row group: W[g, k] = L_gg^-1 X[g, k], with X[g, j0:j0+8] = I and
        // X[g, k] = 0 beyond; entries above W's diagonal are set to exactly 0
        float x[kGroup], w[kGroup];
#pragma unroll
        for (int t = 0; t < kGroup; ++t)
          x[t] = (k < j0) ? xrow[t * kRowStride + tr(k)] : ((k == j0 + t) ? 1.f : 0.f);
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          float acc = x[t];
#pragma unroll
          for (int s = 0; s < t; ++s) acc = fmaf(-d[t][s], w[s], acc);
          w[t] = (j0 + t < k) ? 0.f : acc * rinv[t];
          wrow[t * kRowStride + tr(k)] = w[t];
          Winv[(long)(j0 + t) * B + k] = w[t];
        }
      }
    } else if (loader) {
      // meanwhile the other half of the CTA writes out the previous group's L columns
      // (kGiven: loads the next group's)
      if (kGiven && g + 1 < groups)
        load_l_group(A, lda, j0 + kGroup, B, tid - kMaxBlock, next);
      if (!kGiven && g > 0)
        write_l_group(L, ldl, lcol[(g - 1) & 1], j0 - kGroup, B, tid - kMaxBlock);
    }
    __syncthreads();

    // the rank-8 update of every live tile: M tiles right of the group (tj > g), X tiles
    // left of it (tj <= g), all below it (ti > g)
    if (has_tile && ti > g && (kGiven ? tj <= g : (kInverse || tj > g))) {
      const float* as = lc + tr(ti * kGroup) + row0;
      const float* bs = ((!kInverse || tj > g) ? lc : wrow) + tr(tj * kGroup);
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        float av[kTileRows], bv[kGroup];
        load_n(as + t * kRowStride, av);
        load_n(bs + t * kRowStride, bv);
#pragma unroll
        for (int a = 0; a < kTileRows; ++a)
#pragma unroll
          for (int b = 0; b < kGroup; ++b) tile[a][b] = fmaf(-av[a], bv[b], tile[a][b]);
      }
      if (!kGiven && tj == g + 1) {
        // M's next column group is final: hand it to the panel, start this tile's X
        store_tile_rows(panel + ti * kPanelTile + row0 * kGroup, kGroup, tile);
        if (kInverse) set_identity_or_zero(tile, ti == tj, row0);
      } else if (kInverse && ti == g + 1) {
        // X's next row group is final (tj <= g)
        store_tile_rows(xrow + row0 * kRowStride + tr(tj * kGroup), kRowStride, tile);
      }
    }
    // kGiven: the next column group into the other lc buffer (last read in step g - 1)
    if (kGiven && loader && g + 1 < groups)
      stage_l_group(lcol[(g + 1) & 1], j0 + kGroup, B, tid - kMaxBlock, next);
    __syncthreads();
  }
  if (kGiven) return;
  if (loader) write_l_group(L, ldl, lcol[(groups - 1) & 1], B - kGroup, B, tid - kMaxBlock);
  // the slab's zeros last (global stores issued before a barrier delay it), 16 bytes a store
  const int w4 = zero_cols >> 2;
  for (int e = tid; e < B * w4; e += kGroupThreads) {
    const int r = e / w4, c = e - r * w4;  // once per 16 bytes stored, outside the groups
    reinterpret_cast<float4*>(L + r * ldl + B)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace agp
