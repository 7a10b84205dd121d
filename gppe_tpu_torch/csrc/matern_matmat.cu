// Fused Matern correlation matmat for Hopper (sm_90a):
//
//     out = K @ V,   K[i, j] = k_nu(|x_i - y_j|),
//
// with x (nr, d) and y (nc, d) the row and column points already divided by
// the correlation scale (the Python wrapper does that, so anisotropic scales
// work), V (nc, r) row-major, out (nr, r) row-major, everything float32.
// K is never stored. Optionally each row also writes sum_j K[i, j]^2 in
// float64, so one launch with r = 0 gives trace(K^2) = ||K||_F^2.
//
// Replaces gppe_tpu/ops/pallas_kernels.py::_matmat_kernel (the TPU's fused
// distance -> Matern -> tile-dot -> accumulate kernel) at its exact tile-dot
// mode 'highest', and folds in the XLA trace(K^2) pass
// gppe_tpu/ops/operators.py::_matern_frobenius2_blocked. With the GRAM flag
// it replaces ::_matmat_kernel_gram at the same mode: the squared distance is
// |x|^2 + |y|^2 - 2 x.y, clamped at 0, on points the caller has centred on
// the column mean and with the norms the caller computed (as the TPU
// wrapper did). On the TPU the d <= 8 contraction x.y went to the matrix
// unit; here it is d float32 FMAs per pair on the CUDA cores, beside the d
// subtract + d FMA of the difference form, so at d = 2 the Gram form saves
// nothing on this card and keeps its cancellation error (~1e-3 on
// near-coincident pairs). It is ported for parity, not for speed. The bf16
// tile-dot modes are matern_matmat_mma.cu.
//
// What bounds it on this card. Each pair (i, j) costs d subtract/FMAs for the
// squared distance, one sqrtf and one expf (the SFU's MUFU.RSQ / MUFU.EX2 plus
// the IEEE fix-up instructions around them) and r FP32 FMAs. Device-memory
// traffic is O(n (d + r)) words per call against O(n^2 (r + d + ~10))
// instructions, so the kernel is bound by the SFU rate and FP32 FMA issue,
// never by HBM.
//
// What the design does about it:
//   * one thread per output row, kRows = 128 rows per block; the block walks
//     the columns in tiles of kCols = 128 points, staging each tile's points
//     and V rows in shared memory once; every thread then reads them as
//     warp-wide broadcasts (no bank conflicts);
//   * each thread evaluates k(x_i, y_j) exactly once per column - one sqrt and
//     one exp per pair, the minimum - and FMAs it into RC register
//     accumulators. RC is a template parameter (8, 16, 24 or 32: the next
//     multiple of 8 above r, so the engine's r = 24 block wastes no FMA);
//     wider V is split into 32-column chunks over grid.y;
//   * nu (four closed forms) and d = 2 are template parameters, other d <= 8
//     run an unrolled loop over zero-padded coordinates (exact: a zero pad
//     adds 0 to the squared distance);
//   * ragged row and column edges are masked, not padded with far points, so
//     there is no n_pad - n correction to forget.
// Precision: built WITHOUT --use_fast_math, so sqrtf is correctly rounded and
// expf is the full-accuracy routine; products are summed by IEEE float32
// fmaf - the reference's 'highest' dot mode - first within a column tile,
// then tile by tile (at n = 10^5 one running float32 sum would carry
// ~sqrt(n) ulps of error). The k^2 row sums take float32 partials per
// column tile and add them in float64. K is exactly symmetric: k(x_i, x_j)
// and k(x_j, x_i) round identically.
// Not yet used: wgmma/TMA and a faster schedule; those are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;  // output rows per block, one per thread
constexpr int kCols = 128;  // column points per shared-memory tile
constexpr int kMaxRC = 32;  // V columns per block; wider V uses grid.y

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded coordinates).
// RC: V columns per block; 0 for a Frobenius-only launch (V and out unused).
// FRO: also write the per-row float64 sum of k^2 (grid.y == 0 blocks only).
// GRAM: the Gram-form distance from centred points and their norms.
template <int NU, int D, int RC, bool FRO, bool GRAM>
__global__ void __launch_bounds__(kRows)
    matern_matmat_kernel(const float* __restrict__ rows,
                         const float* __restrict__ cols,
                         const float* __restrict__ rows_norm,
                         const float* __restrict__ cols_norm,
                         const float* __restrict__ V, float* __restrict__ out,
                         double* __restrict__ fro_rows, int nr, int nc, int d,
                         int r) {
  constexpr int kD = D > 0 ? D : kMaxD;
  constexpr int kRC = RC > 0 ? RC : 1;
  __shared__ float s_pts[kD][kCols];
  __shared__ __align__(16) float s_v[kCols][kRC];
  __shared__ float s_norm[GRAM ? kCols : 1];

  const int dim = D > 0 ? D : d;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const int c0 = blockIdx.y * RC;
  const bool live = row < nr;

  float x[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    x[k] = (live && k < dim) ? rows[static_cast<int64_t>(row) * dim + k] : 0.0f;
  }
  float x_norm = 0.0f;
  if constexpr (GRAM) x_norm = live ? rows_norm[row] : 0.0f;
  float acc[kRC];
#pragma unroll
  for (int c = 0; c < kRC; ++c) acc[c] = 0.0f;
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
    if constexpr (RC > 0) {
      for (int e = threadIdx.x; e < kCols * RC; e += kRows) {
        const int j = e / RC;
        const int c = e % RC;
        s_v[j][c] = (j < tc && c0 + c < r)
                        ? V[static_cast<int64_t>(j0 + j) * r + c0 + c]
                        : 0.0f;
      }
    }
    __syncthreads();

    // two-level sum: this tile's terms into `part`, then `part` into the
    // running `acc` - the rounding error grows like sqrt(kCols) +
    // sqrt(nc / kCols) ulps instead of sqrt(nc)
    float part[kRC];
#pragma unroll
    for (int c = 0; c < kRC; ++c) part[c] = 0.0f;
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
      if constexpr (FRO) fro_tile = fmaf(kv, kv, fro_tile);
#pragma unroll
      for (int c = 0; c < RC; ++c) part[c] = fmaf(kv, s_v[j][c], part[c]);
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[c] += part[c];
    if constexpr (FRO) fro += static_cast<double>(fro_tile);
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (c0 + c < r) out[static_cast<int64_t>(row) * r + c0 + c] = acc[c];
  }
  if constexpr (FRO) {
    if (blockIdx.y == 0) fro_rows[row] = fro;
  }
}

struct Args {
  const float* rows;
  const float* cols;
  const float* rows_norm;  // both norms null: the difference form
  const float* cols_norm;
  const float* V;
  float* out;
  double* fro_rows;
  int nr, nc, d, r;
  cudaStream_t stream;
};

static_assert(kRows == kCols, "the column norms are staged one per thread");

template <int NU, int D, int RC, bool FRO, bool GRAM>
cudaError_t launch(const Args& a) {
  int chunks = 1;
  if constexpr (RC > 0) chunks = (a.r + RC - 1) / RC;
  const dim3 grid((a.nr + kRows - 1) / kRows, chunks);
  matern_matmat_kernel<NU, D, RC, FRO, GRAM><<<grid, kRows, 0, a.stream>>>(
      a.rows, a.cols, a.rows_norm, a.cols_norm, a.V, a.out, a.fro_rows, a.nr,
      a.nc, a.d, a.r);
  return cudaGetLastError();
}

template <int NU, int D, int RC, bool GRAM>
cudaError_t launch_fro(const Args& a) {
  return a.fro_rows != nullptr ? launch<NU, D, RC, true, GRAM>(a)
                               : launch<NU, D, RC, false, GRAM>(a);
}

template <int NU, int D, bool GRAM>
cudaError_t launch_rc(const Args& a) {
  if (a.r == 0) {
    return a.fro_rows != nullptr ? launch<NU, D, 0, true, GRAM>(a)
                                 : cudaErrorInvalidValue;
  }
  if (a.r <= 8) return launch_fro<NU, D, 8, GRAM>(a);
  if (a.r <= 16) return launch_fro<NU, D, 16, GRAM>(a);
  if (a.r <= 24) return launch_fro<NU, D, 24, GRAM>(a);
  return launch_fro<NU, D, kMaxRC, GRAM>(a);
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  // the Gram form has the any-d instances only: it loses to the difference
  // form at every d on this card, so it is not worth a specialisation
  if (a.rows_norm != nullptr) return launch_rc<NU, 0, true>(a);
  return a.d == 2 ? launch_rc<NU, 2, false>(a) : launch_rc<NU, 0, false>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `rows_norm` (nr) and `cols_norm`
// (nc) are both null for the difference form, or hold the squared norms of
// the (centred) rows and cols for the Gram form. `V` and `out` may be null
// when r == 0; `fro_rows` (nr float64) is null unless the k^2 row sums are
// wanted.
extern "C" int gppe_matern_matmat(const void* rows, const void* cols,
                                  const void* rows_norm,
                                  const void* cols_norm, const void* V,
                                  void* out, void* fro_rows, int nr, int nc,
                                  int d, int r, int nu_code, void* stream) {
  if (nr <= 0 || nc < 0 || d < 1 || d > kMaxD || r < 0 ||
      (rows_norm == nullptr) != (cols_norm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(rows),
               static_cast<const float*>(cols),
               static_cast<const float*>(rows_norm),
               static_cast<const float*>(cols_norm),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               static_cast<double*>(fro_rows),
               nr,
               nc,
               d,
               r,
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
