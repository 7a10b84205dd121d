// Fused Matern trace(K^2) for Hopper (sm_90a):
//
//     fro_rows[i] = sum_j K[i, j]^2,   K[i, j] = k_nu(|x_i - y_j|),
//
// with x (nr, d) and y (nc, d) the row and column points already divided by
// the correlation scale (the Python wrapper does that, so anisotropic scales
// work), fro_rows (nr) float64; sum fro_rows = trace(K^2) = ||K||_F^2 for
// square K. K is never stored.
//
// Replaces the XLA trace(K^2) pass
// gppe_tpu/ops/operators.py::_matern_frobenius2_blocked. It serves every
// dot mode: the tile-dot modes round the products' operands only, and the
// reference's trace_pow(2) is the exact pass in every mode. The products
// K @ V, the port of gppe_tpu/ops/pallas_kernels.py::_matmat_kernel in all
// three modes, are matern_matmat_mma.cu. With the GRAM flag the squared
// distance is |x|^2 + |y|^2 - 2 x.y, clamped at 0, on points the caller has
// centred on the column mean and with the norms the caller computed, as in
// ::_matmat_kernel_gram.
//
// What bounds it on this card. Each pair (i, j) costs d subtract/FMAs for the
// squared distance, one sqrtf and one expf (the SFU's MUFU.RSQ / MUFU.EX2 plus
// the IEEE fix-up instructions around them) and one FMA for k^2. Device-memory
// traffic is O(n d) words against O(n^2 (3 d + ~20)) instructions, so the
// kernel is bound by the SFU rate and instruction issue, never by HBM.
//
// What the design does about it:
//   * one thread per output row, kRows = 128 rows per block; the block walks
//     the columns in tiles of kCols = 128 points, staging each tile's points
//     in shared memory once; every thread then reads them as warp-wide
//     broadcasts (no bank conflicts);
//   * each thread evaluates k(x_i, y_j) exactly once per pair - one sqrt and
//     one exp, the minimum;
//   * nu (four closed forms) and d = 2 are template parameters, other d <= 8
//     run an unrolled loop over zero-padded coordinates (exact: a zero pad
//     adds 0 to the squared distance); the Gram form has the any-d
//     instances only;
//   * ragged row and column edges are masked, not padded with far points.
// Precision: built WITHOUT --use_fast_math, so sqrtf is correctly rounded and
// expf is the full-accuracy routine (matern_from_d2, as the 'highest'
// products take it). The k^2 row sums take float32 partials per column tile
// and add them in float64.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;  // output rows per block, one per thread
constexpr int kCols = 128;  // column points per shared-memory tile

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded coordinates).
// GRAM: the Gram-form distance from centred points and their norms.
template <int NU, int D, bool GRAM>
__global__ void __launch_bounds__(kRows)
    matern_frobenius_kernel(const float* __restrict__ rows,
                            const float* __restrict__ cols,
                            const float* __restrict__ rows_norm,
                            const float* __restrict__ cols_norm,
                            double* __restrict__ fro_rows, int nr, int nc,
                            int d) {
  constexpr int kD = D > 0 ? D : kMaxD;
  __shared__ float s_pts[kD][kCols];
  __shared__ float s_norm[GRAM ? kCols : 1];

  const int dim = D > 0 ? D : d;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < nr;

  float x[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    x[k] = (live && k < dim) ? rows[static_cast<int64_t>(row) * dim + k] : 0.0f;
  }
  float x_norm = 0.0f;
  if constexpr (GRAM) x_norm = live ? rows_norm[row] : 0.0f;
  double fro = 0.0;

  for (int j0 = 0; j0 < nc; j0 += kCols) {
    const int tc = min(kCols, nc - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kD * kCols; e += kRows) {
      const int k = e / kCols;
      const int j = e % kCols;
      s_pts[k][j] = (j < tc && k < dim)
                        ? cols[static_cast<int64_t>(j0 + j) * dim + k]
                        : 0.0f;
    }
    if constexpr (GRAM) {  // kRows == kCols: one norm per thread
      s_norm[threadIdx.x] =
          threadIdx.x < tc ? cols_norm[j0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();

    // this tile's k^2 in float32, then into the float64 row sum
    float fro_tile = 0.0f;
    for (int j = 0; j < tc; ++j) {
      float d2 = 0.0f;
      if constexpr (GRAM) {
        float dot = 0.0f;
#pragma unroll
        for (int k = 0; k < kD; ++k) dot = fmaf(x[k], s_pts[k][j], dot);
        d2 = fmaxf(fmaf(-2.0f, dot, x_norm + s_norm[j]), 0.0f);
      } else {
#pragma unroll
        for (int k = 0; k < kD; ++k) {
          const float diff = x[k] - s_pts[k][j];
          d2 = fmaf(diff, diff, d2);
        }
      }
      const float kv = matern_from_d2<NU>(d2);
      fro_tile = fmaf(kv, kv, fro_tile);
    }
    fro += static_cast<double>(fro_tile);
  }
  if (live) fro_rows[row] = fro;
}

struct Args {
  const float* rows;
  const float* cols;
  const float* rows_norm;  // both norms null: the difference form
  const float* cols_norm;
  double* fro_rows;
  int nr, nc, d;
  cudaStream_t stream;
};

static_assert(kRows == kCols, "the column norms are staged one per thread");

template <int NU, int D, bool GRAM>
cudaError_t launch(const Args& a) {
  matern_frobenius_kernel<NU, D, GRAM>
      <<<(a.nr + kRows - 1) / kRows, kRows, 0, a.stream>>>(
          a.rows, a.cols, a.rows_norm, a.cols_norm, a.fro_rows, a.nr, a.nc,
          a.d);
  return cudaGetLastError();
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  // the Gram form has the any-d instances only: it loses to the difference
  // form at every d on this card, so it is not worth a specialisation
  if (a.rows_norm != nullptr) return launch<NU, 0, true>(a);
  return a.d == 2 ? launch<NU, 2, false>(a) : launch<NU, 0, false>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `rows_norm` (nr) and `cols_norm`
// (nc) are both null for the difference form, or hold the squared norms of
// the (centred) rows and cols for the Gram form. `fro_rows` (nr float64)
// receives the k^2 row sums.
extern "C" int gppe_matern_matmat(const void* rows, const void* cols,
                                  const void* rows_norm,
                                  const void* cols_norm, void* fro_rows,
                                  int nr, int nc, int d, int nu_code,
                                  void* stream) {
  if (nr <= 0 || nc < 0 || d < 1 || d > kMaxD || fro_rows == nullptr ||
      (rows_norm == nullptr) != (cols_norm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(rows),
               static_cast<const float*>(cols),
               static_cast<const float*>(rows_norm),
               static_cast<const float*>(cols_norm),
               static_cast<double*>(fro_rows),
               nr,
               nc,
               d,
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

extern "C" const char* gppe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
