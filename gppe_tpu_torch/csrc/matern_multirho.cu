// Fused multi-rho Matern trace(K^2) for Hopper (sm_90a):
//
//     partials[b, blk] = sum over block blk's tile pairs of
//                        weight * sum K(rho_b)[i, j]^2,
//     K(rho)[i, j] = k_nu(|x_i - x_j| / rho),
//
// for a batch of B isotropic correlation scales over one set of raw
// (unscaled) points x (n, d), float32, with partials (B, blocks) float64:
// the caller's sum over blk is trace(K(rho_b)^2) for the whole batch in one
// launch. No K(rho_b) is ever stored.
//
// Replaces the per-rho sums of K^2 (fro_ref) of
// gppe_tpu/ops/pallas_kernels.py::_multirho_kernel, the engine of the
// grid-batched Krylov factorization (models/grid_krylov.py). It serves every
// dot mode: the tile-dot modes round the products' operands only, and the
// traces always sum the unrounded k^2. The products K(rho_b) @ V_b, in all
// three modes, are matern_multirho_mma.cu. The arithmetic order is that of
// its 'highest' k and of the reference: d^2 by differences on the raw
// points, one correctly rounded sqrt (sqrt_rn_nonneg, matern_mma.cuh),
// then per rho one multiply by 1/rho_b (rounded to float32 by the caller)
// and the closed form from the distance (matern_from_r). That differs in
// the last bits from matern_matmat.cu, which scales the points first.
//
// What bounds it on this card. Per pair: d subtract/FMAs and one sqrt
// (MUFU.RSQ and four FP32 operations), shared by the 8 rhos a thread holds;
// per rho one multiply, one IEEE expf (MUFU.EX2 and seven FP32 operations)
// and one FMA for k^2. That is 9 MUFU operations against about 90 issued
// instructions per pair: the SFU (16 MUFU operations per clock and SM)
// allows 1.8 pairs per clock and SM, issue (128 thread instructions per
// clock) about 1.4, so issue binds with the SFU close behind. Device-memory
// traffic is O(B n) words, never the bound.
//
// What the design does about it:
//   * K(rho_b) is symmetric bit for bit, so the walk takes only the tile
//     pairs tj >= ti and counts each off the diagonal twice: half the pairs,
//     the one large lever (matern_trace.cuh);
//   * one tile pair of 128 x 128 points per block, balanced over the
//     triangle by the fold of row ti with row T - 1 - ti; each block writes
//     one float64 partial per rho, no atomics, the same bits run to run;
//   * a thread holds kBT = 8 rhos, so a pair's distance and sqrt are shared
//     eight ways (a larger batch is split over grid.y), and kR = 2 rows, so
//     16 independent exps interleave per column point (2 rows ran 6% faster
//     than 1 or 4 at n = 100,000; chip_profile.py variants);
//   * the sqrt without the branch nvcc puts around sqrtf;
//   * nu (four closed forms) and d = 2 are template parameters, other
//     d <= 8 run over zero-padded coordinates; ragged edges are masked.
// Precision: built WITHOUT --use_fast_math. Each thread sums the k^2 of a
// row and rho over its 64 columns of the tile in float32, then in float64.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"
#include "matern_trace.cuh"

using namespace gppe;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 8;  // rhos per thread
constexpr int kR = 2;   // rows per thread: lane + 32 r of its row set
constexpr int kRowSets = kTraceTile / (32 * kR);
constexpr int kColGroups = kWarps / kRowSets;
constexpr int kColsPerThread = kTraceTile / kColGroups;
static_assert(kRowSets * 32 * kR == kTraceTile && kColGroups >= 1 &&
                  kColGroups * kRowSets == kWarps,
              "the threads must tile the 128 x 128 pair exactly");

// k(rho_t)^2 of one column point y with the thread's kR rows, added into
// their float32 sums
template <int NU, int KD>
__device__ __forceinline__ void trace_column(const float (&x)[kR][KD],
                                             const float* y_smem,
                                             const float (&inv)[kBT],
                                             float (&part)[kR][kBT]) {
  float y[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) y[k] = y_smem[k];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const float diff = x[r][k] - y[k];
      d2 = fmaf(diff, diff, d2);
    }
    const float r0 = sqrt_rn_nonneg(d2);
#pragma unroll
    for (int t = 0; t < kBT; ++t) {
      const float kv = matern_from_r<NU>(r0 * inv[t]);
      part[r][t] = fmaf(kv, kv, part[r][t]);
    }
  }
}

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded
// coordinates). grid.x: the blocks of the walk; grid.y: rho groups.
template <int NU, int D>
__global__ void __launch_bounds__(kThreads)
    multirho_trace_kernel(const float* __restrict__ pts,
                          const float* __restrict__ inv_rho,
                          double* __restrict__ partials, int n, int d, int B,
                          int tiles, int64_t pairs, int per_block) {
  constexpr int kD = D > 0 ? D : kMaxD;
  __shared__ __align__(16) float s_pts[kTraceTile][kD];
  __shared__ double s_warp[kWarps];

  const int dim = D > 0 ? D : d;
  const int b0 = blockIdx.y * kBT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp % kRowSets) * 32 * kR + lane;
  const int col0 = (warp / kRowSets) * kColsPerThread;

  // a rho past the end of the batch runs with 1/rho = 0 (k = 1) and writes
  // nothing
  float inv[kBT];
#pragma unroll
  for (int t = 0; t < kBT; ++t) inv[t] = b0 + t < B ? inv_rho[b0 + t] : 0.0f;

  double acc[kBT];
#pragma unroll
  for (int t = 0; t < kBT; ++t) acc[t] = 0.0;

  const int64_t p_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t p_end =
      p_begin + per_block < pairs ? p_begin + per_block : pairs;
  for (int64_t p = p_begin; p < p_end; ++p) {
    const TilePair tp = trace_tile_pair(p, tiles, tiles, true);
    const int j0 = tp.tj * kTraceTile;
    const int tc = min(kTraceTile, n - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTraceTile * kD; e += kThreads) {
      const int j = e / kD;
      const int k = e % kD;
      s_pts[j][k] = (j < tc && k < dim)
                        ? pts[static_cast<int64_t>(j0 + j) * dim + k]
                        : 0.0f;
    }
    float x[kR][kD];
    bool live[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = tp.ti * kTraceTile + row0 + 32 * r;
      live[r] = row < n;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        x[r][k] = (live[r] && k < dim)
                      ? pts[static_cast<int64_t>(row) * dim + k]
                      : 0.0f;
      }
    }
    __syncthreads();

    float part[kR][kBT];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int t = 0; t < kBT; ++t) part[r][t] = 0.0f;
    }
    const int jn = min(kColsPerThread, tc - col0);
    if (jn == kColsPerThread) {
#pragma unroll 4
      for (int j = col0; j < col0 + kColsPerThread; ++j) {
        trace_column<NU, kD>(x, s_pts[j], inv, part);
      }
    } else {
      for (int j = col0; j < col0 + jn; ++j) {
        trace_column<NU, kD>(x, s_pts[j], inv, part);
      }
    }
#pragma unroll
    for (int t = 0; t < kBT; ++t) {
      double tile = 0.0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (live[r]) tile += static_cast<double>(part[r][t]);
      }
      acc[t] += tp.weight * tile;
    }
  }

  const int64_t blocks = gridDim.x;
#pragma unroll
  for (int t = 0; t < kBT; ++t) {
    const double total = block_sum<kWarps>(acc[t], s_warp);
    if (threadIdx.x == 0 && b0 + t < B) {
      partials[(b0 + t) * blocks + blockIdx.x] = total;
    }
  }
}

struct Args {
  const float* pts;
  const float* inv_rho;
  double* partials;
  int n, d, B, tiles;
  int64_t pairs;
  int per_block, blocks;
  cudaStream_t stream;
};

template <int NU, int D>
cudaError_t launch(const Args& a) {
  const int groups = (a.B + kBT - 1) / kBT;
  if (groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.blocks, groups);
  multirho_trace_kernel<NU, D><<<grid, kThreads, 0, a.stream>>>(
      a.pts, a.inv_rho, a.partials, a.n, a.d, a.B, a.tiles, a.pairs,
      a.per_block);
  return cudaGetLastError();
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  return a.d == 2 ? launch<NU, 2>(a) : launch<NU, 0>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `inv_rho` holds B float32 values
// 1/rho_b; `partials` B * blocks float64, row-major (B, blocks), receives
// one weighted k^2 sum per rho and block of `per_block` tile pairs of the
// symmetric walk; the blocks must cover its pairs exactly
// (cuda_kernels.trace_schedule).
extern "C" int gppe_matern_multirho(const void* pts, const void* inv_rho,
                                    void* partials, int n, int d, int B,
                                    int nu_code, int per_block, int blocks,
                                    void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || B <= 0 || partials == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kTraceTile - 1) / kTraceTile;
  const int64_t pairs = trace_pairs(tiles, tiles, true);
  if (!trace_grid_ok(pairs, per_block, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(inv_rho),
               static_cast<double*>(partials),
               n,
               d,
               B,
               tiles,
               pairs,
               per_block,
               blocks,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (nu_code) {
    case kNuHalf: err = launch_d<kNuHalf>(a); break;
    case kNuThreeHalf: err = launch_d<kNuThreeHalf>(a); break;
    case kNuFiveHalf: err = launch_d<kNuFiveHalf>(a); break;
    case kNuGauss: err = launch_d<kNuGauss>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
