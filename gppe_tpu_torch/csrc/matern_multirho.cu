// Fused multi-rho Matern trace(K^2) for Hopper (sm_90a):
//
//     fro_rows[b, i] = sum_j K(rho_b)[i, j]^2,
//     K(rho)[i, j] = k_nu(|x_i - x_j| / rho),
//
// for a batch of B isotropic correlation scales over one set of raw
// (unscaled) points x (n, d), float32, with fro_rows (B, n) float64: the
// sum over i is trace(K(rho_b)^2) for the whole batch in one launch. No
// K(rho_b) is ever stored.
//
// Replaces the per-rho sums of K^2 of
// gppe_tpu/ops/pallas_kernels.py::_multirho_kernel, the engine of the
// grid-batched Krylov factorization (models/grid_krylov.py). It serves every
// dot mode: the tile-dot modes round the products' operands only, and the
// traces always sum the unrounded k^2. The products K(rho_b) @ V_b, in all
// three modes, are matern_multirho_mma.cu. The arithmetic order is that
// kernel's and the reference's: d^2 by differences on the raw points, one
// sqrtf, then per rho one multiply by 1/rho_b (rounded to float32 by the
// caller) and the closed form from the distance (matern_from_r). That
// differs in the last bits from matern_matmat.cu, which scales the points
// first.
//
// What bounds it on this card. Per pair: d subtract/FMAs and one sqrtf,
// shared by the rhos a thread holds; per rho one multiply, one expf and one
// FMA for k^2. Device-memory traffic is O(B n) words against O(B n^2 ~12)
// instructions, so it is bound by instruction issue (FP32 FMA and the SFU's
// fix-up code), never by HBM.
//
// What the design does about it:
//   * one thread per output row, kRows = 128 rows per block, the columns
//     walked in shared-memory tiles of kCols = 128 points, ragged edges
//     masked (nothing to subtract from the traces);
//   * a thread holds BT = 8 rhos, so a pair's distance and sqrt are shared
//     eight ways; a larger batch is split over grid.y;
//   * a column tile's k^2 are summed in float32 and the tile sums added in
//     float64;
//   * __launch_bounds__(128, 4): 4 blocks per SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;  // output rows per block, one per thread
constexpr int kCols = 128;  // column points per shared-memory tile
constexpr int kBT = 8;      // rhos per thread

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded
// coordinates). grid.x: row blocks; grid.y: rho groups.
template <int NU, int D>
__global__ void __launch_bounds__(kRows, 4)
    multirho_trace_kernel(const float* __restrict__ pts,
                          const float* __restrict__ inv_rho,
                          double* __restrict__ fro_rows, int n, int d,
                          int B) {
  constexpr int kD = D > 0 ? D : kMaxD;
  __shared__ float s_pts[kD][kCols];

  const int dim = D > 0 ? D : d;
  const int b0 = blockIdx.y * kBT;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;

  float x[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    x[k] = (live && k < dim) ? pts[static_cast<int64_t>(row) * dim + k] : 0.0f;
  }
  // a rho past the end of the batch runs with 1/rho = 0 (k = 1) and writes
  // nothing
  float inv[kBT];
#pragma unroll
  for (int t = 0; t < kBT; ++t) inv[t] = b0 + t < B ? inv_rho[b0 + t] : 0.0f;

  double fro[kBT];
#pragma unroll
  for (int t = 0; t < kBT; ++t) fro[t] = 0.0;

  for (int j0 = 0; j0 < n; j0 += kCols) {
    const int tc = min(kCols, n - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kD * kCols; e += kRows) {
      const int k = e / kCols;
      const int j = e % kCols;
      s_pts[k][j] = (j < tc && k < dim)
                        ? pts[static_cast<int64_t>(j0 + j) * dim + k]
                        : 0.0f;
    }
    __syncthreads();

    // two-level sum: this tile's k^2 in float32, then into float64
    float fro_tile[kBT];
#pragma unroll
    for (int t = 0; t < kBT; ++t) fro_tile[t] = 0.0f;
    for (int j = 0; j < tc; ++j) {
      float d2 = 0.0f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float diff = x[k] - s_pts[k][j];
        d2 = fmaf(diff, diff, d2);
      }
      const float r0 = sqrtf(d2);
#pragma unroll
      for (int t = 0; t < kBT; ++t) {
        const float kv = matern_from_r<NU>(r0 * inv[t]);
        fro_tile[t] = fmaf(kv, kv, fro_tile[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kBT; ++t) fro[t] += static_cast<double>(fro_tile[t]);
  }

  if (!live) return;
#pragma unroll
  for (int t = 0; t < kBT; ++t) {
    const int b = b0 + t;
    if (b < B) fro_rows[static_cast<int64_t>(b) * n + row] = fro[t];
  }
}

struct Args {
  const float* pts;
  const float* inv_rho;
  double* fro_rows;
  int n, d, B;
  cudaStream_t stream;
};

template <int NU, int D>
cudaError_t launch(const Args& a) {
  const int groups = (a.B + kBT - 1) / kBT;
  if (groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.n + kRows - 1) / kRows, groups);
  multirho_trace_kernel<NU, D><<<grid, kRows, 0, a.stream>>>(
      a.pts, a.inv_rho, a.fro_rows, a.n, a.d, a.B);
  return cudaGetLastError();
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  return a.d == 2 ? launch<NU, 2>(a) : launch<NU, 0>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `inv_rho` holds B float32 values
// 1/rho_b; `fro_rows` B * n float64, row-major (B, n).
extern "C" int gppe_matern_multirho(const void* pts, const void* inv_rho,
                                    void* fro_rows, int n, int d, int B,
                                    int nu_code, void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || B <= 0 || fro_rows == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(inv_rho),
               static_cast<double*>(fro_rows),
               n,
               d,
               B,
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
