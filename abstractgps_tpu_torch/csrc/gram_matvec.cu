// gram_matvec: the CG solver's matvec out = s2 * K0(x, x) V + noise (.) V with the gram K0 of an
// isotropic kernel formed on chip, K0[i][j] = g(sum_k (x_ik - x_jk)^2), and never stored.
//
// Replaces no TPU kernel: the JAX package's ops/matvec.py is a lax.fori_loop over row panels
// (gram_matvec), each panel a gram tile written to memory and a matrix product reading it back.
// The port ran that loop too, with csrc/gram_tile.cu writing each 1024 x N panel (128 MiB at
// N = 32 768), a scaling by s2 reading and writing it again, and an SGEMM reading it a third
// time: ~10.6 ms a matvec against the 1.63 ms its operations need, and ~377 launches.
//
// Bound on the H100: FP32 operations. Per entry d^2 from the differences (3D), the map (~12)
// and the product with the q columns of V (2q); the bytes are x and V read and out written once
// (4 (N D + 2 N q)), ~9 MB at N = 32 768, D = 8, q = 33, against 1.1e11 operations.
//
// Design: the column-split sweep of gram_sweep.cuh with V in the cotangent's place. The grid is
// (row blocks of kRows, S column splits); split s walks the contiguous column tiles
// [s T / S, (s + 1) T / S) of the T = ceil(N / kCols) tiles, so that N = 32 768 fills the 132
// SMs (S from ops/matvec.py, a function of the shapes). Each tile's rows of x (true width d,
// zero past d and N) and of V (zero past q and N, row stride rounded up to 4 floats) land in
// shared memory through a cp.async double buffer, tile t + 1 loading while tile t is computed.
// A thread owns kRowsPerThread rows: their features and their q accumulators stay in registers.
// Per column it reads that column's features and its row of V from shared memory (the same
// address across the warp, one broadcast), forms d^2 by FP32 FMA from the differences (no TF32,
// no tensor cores: ops/precision.py; zero on the diagonal to the bit), applies g
// (entry_map: agp::apply_map's formulas, gram_tile.cu's epilogue, with the sqrt of the
// sqrt-based families taken by sqrt.approx.f32, within 1 ulp of the rounded root: IEEE sqrtf
// branches to a special-case path on every call: 3.80-4.03 ms a sweep against 3.28-3.32 at
// N = 32 768, q = 33), and adds g * V[j, :] to its accumulators: the K entry lives in one
// register between the map and the product. Columns go in batches of kBatch so that the map's
// dependent chains interleave. Shared memory, not the FP32 rate, sets the floor at two rows a
// thread: each column's features and V row reach every thread (41 words for 2 x 33 FMAs),
// ~2.6 ms at N = 32 768 by the 128 B/clock of an SM; three rows a thread or more spill or lose
// occupancy and were no faster. Padded columns hold zero rows of V and add
// nothing. No atomics: each CTA writes its rows' partial sums into an (S, N, q) buffer, and one
// small last launch adds the S partials in split order and applies the epilogue
// out = s2 * sum + noise (.) V, with s2 and the map's hyperparameter read from device buffers.
// The same inputs and shapes give the same bits. V wider than kMaxQ columns goes in chunks of
// kMaxQ, each a sweep and its sum; the column count of a chunk is a template parameter (1, 8 or
// kMaxQ accumulators), as the family and the feature width (8, 16; wider inputs read their
// features through L1) are.
#include "gram_sweep.cuh"

namespace {

constexpr int kThreads = 128;                      // 4 warps
constexpr int kRowsPerThread = 2;                  // rows tid and tid + kThreads of the block
constexpr int kRows = kThreads * kRowsPerThread;   // rows of a CTA
constexpr int kCols = 64;                          // columns of a staged tile
constexpr int kBatch = 4;                          // columns whose entries are formed together
constexpr int kMaxQ = 33;                          // columns of V a sweep takes: [y, 32 probes]

__host__ __device__ constexpr int v_stride(int q) { return (q + 3) / 4 * 4; }

// floats of one buffer stage: the tile's rows of x ([c][KD]; none when wide), of V ([c][q4])
template <int KD, int Q, bool kWide>
__host__ __device__ constexpr int stage_floats() {
  return kCols * ((kWide ? 0 : KD) + v_stride(Q));
}

// sqrt of d^2 for the maps: one MUFU op, within 1 ulp of the rounded root (0.94 ulp at most over
// 2^26 values in [4e-18, 1.6e5] on the H100) and 0 at d^2 = 0, as agp::safe_sqrt
__device__ __forceinline__ float entry_sqrt(float d2) {
  float s;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(s) : "f"(d2));
  return s;
}

// g(d^2) of family F: agp::apply_map's formulas, the sqrt-based families through entry_sqrt
template <int F>
__device__ __forceinline__ float entry_map(float d2, float p0) {
  if (F == 1) return expf(-entry_sqrt(d2));
  if (F == 2) {
    const float t = 1.7320508075688772f * entry_sqrt(d2);
    return (1.f + t) * expf(-t);
  }
  if (F == 3) {
    const float t = 2.23606797749979f * entry_sqrt(d2);
    return (1.f + t + t * t / 3.f) * expf(-t);
  }
  if (F == 6) return cosf(3.14159265358979323846f * entry_sqrt(d2));
  return agp::apply_map(F, d2, p0);
}

// KD <= 8: 128 registers, four CTAs an SM (16 warps; three at 143 registers were 15 % slower)
template <int F, int KD, int Q, bool kWide>
__global__ void __launch_bounds__(kThreads, KD <= 8 ? 4 : 3)
    gram_matvec_sweep_kernel(const float* __restrict__ x, const float* __restrict__ V, int ldv,
                             const float* __restrict__ params, float* __restrict__ part, int n,
                             int d, int q, int splits) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QS = v_stride(Q), XS = kWide ? 0 : KD;
  constexpr int stage = stage_floats<KD, Q, kWide>();
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const int tiles = (n + kCols - 1) / kCols;
  const int t0 = (int)((long long)split * tiles / splits);
  const int t1 = (int)((long long)(split + 1) * tiles / splits);
  const float p0 = (F == 4 || F == 5) ? params[0] : 0.f;

  // this thread's rows (rows past n take row n - 1's features and are not stored), their
  // features (zero past d) and accumulators
  const float* xrow[kRowsPerThread];
  float xr[kRowsPerThread][KD], acc[kRowsPerThread][Q];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    xrow[r] = x + (long)min(row0 + tid + r * kThreads, n - 1) * d;
#pragma unroll
    for (int k = 0; k < KD; ++k) xr[r][k] = (!kWide && k < d) ? xrow[r][k] : 0.f;
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[r][j] = 0.f;
  }

  auto fetch = [&](int t, int b) {
    float* s = smem + b * stage;
    const int c0 = t * kCols;
    if (!kWide) {
      for (int e = tid; e < kCols * KD; e += kThreads) {
        const int c = e / KD, k = e % KD;
        const bool in = c0 + c < n && k < d;
        agp::cp_async4(s + e, in ? x + (long)(c0 + c) * d + k : x, in ? 4 : 0);
      }
    }
    float* vs = s + kCols * XS;
    for (int e = tid; e < kCols * QS; e += kThreads) {
      const int c = e / QS, j = e % QS;
      const bool in = c0 + c < n && j < q;
      agp::cp_async4(vs + e, in ? V + (long)(c0 + c) * ldv + j : V, in ? 4 : 0);
    }
  };

  fetch(t0, 0);
  agp::cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) & 1;
    if (t + 1 < t1) fetch(t + 1, b ^ 1);  // the buffer tile t - 1 left (barrier below)
    agp::cp_async_commit();
    agp::cp_async_wait<1>();
    __syncthreads();
    const float* xs = smem + b * stage;
    const float* vs = xs + kCols * XS;
    const int c0 = t * kCols;
#pragma unroll 1
    for (int cb = 0; cb < kCols; cb += kBatch) {
      float kv[kRowsPerThread][kBatch];  // the entries K0[row][c0 + cb + j]
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        float zc[KD];
        if (!kWide) agp::load_row(xs + (cb + j) * KD, zc);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          float s2 = 0.f;
          if (kWide) {  // every feature through L1; a padded column takes row n - 1
            const float* zrow = x + (long)min(c0 + cb + j, n - 1) * d;
            for (int k = 0; k < d; ++k) {
              const float df = xrow[r][k] - zrow[k];
              s2 = fmaf(df, df, s2);
            }
          } else {
#pragma unroll
            for (int k = 0; k < KD; ++k) {
              const float df = xr[r][k] - zc[k];
              s2 = fmaf(df, df, s2);
            }
          }
          kv[r][j] = entry_map<F>(s2, p0);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float* vrow = vs + (cb + j) * QS;
#pragma unroll
        for (int j4 = 0; j4 < Q / 4; ++j4) {
          const float4 v = reinterpret_cast<const float4*>(vrow)[j4];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            acc[r][4 * j4] = fmaf(kv[r][j], v.x, acc[r][4 * j4]);
            acc[r][4 * j4 + 1] = fmaf(kv[r][j], v.y, acc[r][4 * j4 + 1]);
            acc[r][4 * j4 + 2] = fmaf(kv[r][j], v.z, acc[r][4 * j4 + 2]);
            acc[r][4 * j4 + 3] = fmaf(kv[r][j], v.w, acc[r][4 * j4 + 3]);
          }
        }
#pragma unroll
        for (int jq = Q / 4 * 4; jq < Q; ++jq) {
          const float v = vrow[jq];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) acc[r][jq] = fmaf(kv[r][j], v, acc[r][jq]);
        }
      }
    }
    __syncthreads();  // tile t read: its buffer may be refilled
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + tid + r * kThreads;
    if (row < n) {
      float* dst = part + ((long)split * n + row) * q;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        if (j < q) dst[j] = acc[r][j];
    }
  }
}

// out[i][j] = s2 * (the S partials of entry (i, j) added in split order) + noise[i] * V[i][j],
// one thread an entry; part is (S, n, q), V and out have row stride ld
__global__ void gram_matvec_reduce_kernel(const float* __restrict__ part,
                                          const float* __restrict__ V,
                                          const float* __restrict__ noise,
                                          const float* __restrict__ s2, float* __restrict__ out,
                                          int ld, int n, int q, int splits) {
  const long nq = (long)n * q;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nq) return;
  const int i = (int)(e / q), j = (int)(e - (long)i * q);
  float s = part[e];
  for (int sp = 1; sp < splits; ++sp) s += part[sp * nq + e];
  out[(long)i * ld + j] = s2[0] * s + noise[i] * V[(long)i * ld + j];
}

template <int F, int KD, int Q, bool kWide>
int launch_sweep(const float* x, const float* V, int ldv, const float* params, float* part,
                 int n, int d, int q, int splits, cudaStream_t stream) {
  const int smem = 2 * stage_floats<KD, Q, kWide>() * (int)sizeof(float);  // <= 26.6 KB
  const dim3 grid((n + kRows - 1) / kRows, splits);
  gram_matvec_sweep_kernel<F, KD, Q, kWide><<<grid, kThreads, smem, stream>>>(
      x, V, ldv, params, part, n, d, q, splits);
  return (int)cudaGetLastError();
}

template <int F, int KD, bool kWide>
int launch_q(const float* x, const float* V, int ldv, const float* params, float* part, int n,
             int d, int q, int splits, cudaStream_t stream) {
  if (q == 1)
    return launch_sweep<F, KD, 1, kWide>(x, V, ldv, params, part, n, d, q, splits, stream);
  if (q <= 8)
    return launch_sweep<F, KD, 8, kWide>(x, V, ldv, params, part, n, d, q, splits, stream);
  return launch_sweep<F, KD, kMaxQ, kWide>(x, V, ldv, params, part, n, d, q, splits, stream);
}

template <int F>
int launch_family(const float* x, const float* V, int ldv, const float* params, float* part,
                  int n, int d, int q, int splits, cudaStream_t stream) {
  if (d <= 8) return launch_q<F, 8, false>(x, V, ldv, params, part, n, d, q, splits, stream);
  if (d <= 16) return launch_q<F, 16, false>(x, V, ldv, params, part, n, d, q, splits, stream);
  return launch_q<F, 8, true>(x, V, ldv, params, part, n, d, q, splits, stream);
}

}  // namespace

// x (n, d) and V (n, q) row-major f32; params: the map's hyperparameter buffer; s2: one float;
// noise (n,); out (n, q); part: scratch of splits * n * min(q, 33) floats; 1 <= splits <=
// ceil(n / 64). Per chunk of at most 33 columns of V: the sweep, then the sum of its partials.
extern "C" int agp_gram_matvec(const float* x, const float* V, const float* params,
                               const float* s2, const float* noise, float* out, float* part,
                               int n, int d, int q, int family, int splits,
                               cudaStream_t stream) {
  if (family < 0 || family > 6 || n <= 0 || d <= 0 || q <= 0 || splits < 1
      || splits > (n + kCols - 1) / kCols)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, int, const float*, float*, int, int, int,
                         int, cudaStream_t);
  constexpr Launch by_family[7] = {launch_family<0>, launch_family<1>, launch_family<2>,
                                   launch_family<3>, launch_family<4>, launch_family<5>,
                                   launch_family<6>};
  for (int c0 = 0; c0 < q; c0 += kMaxQ) {
    const int qc = q - c0 < kMaxQ ? q - c0 : kMaxQ;
    int err = by_family[family](x, V + c0, q, params, part, n, d, qc, splits, stream);
    if (err) return err;
    const long nq = (long)n * qc;
    gram_matvec_reduce_kernel<<<(unsigned)((nq + 255) / 256), 256, 0, stream>>>(
        part, V + c0, noise, s2, out + c0, q, n, qc, splits);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
