// Fused Matern trace(K^2) for Hopper (sm_90a):
//
//     partials[b] = sum over block b's tile pairs of weight * sum K[i, j]^2,
//     K[i, j] = k_nu(|x_i - y_j|),
//
// with x (nr, d) and y (nc, d) the row and column points already divided by
// the correlation scale (the Python wrapper does that, so anisotropic scales
// work), partials float64; the caller sums them, and that sum is
// sum K^2 = trace(K^2) = ||K||_F^2 for square K. K is never stored.
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
// squared distance, one correctly rounded sqrt (MUFU.RSQ and four FP32
// operations), one IEEE expf (MUFU.EX2 and seven FP32 operations) and one
// FMA for k^2: two MUFU operations against about twenty issued
// instructions. Device-memory traffic is O(n d) words against O(n^2)
// instructions, so the kernel is bound by instruction issue, with the SFU
// (16 MUFU operations per clock and SM) close behind, never by HBM.
//
// What the design does about it:
//   * a square K in the difference form is symmetric bit for bit, so the
//     walk takes only the tile pairs tj >= ti and counts each off the
//     diagonal twice: half the pairs (matern_trace.cuh). The Gram form and
//     a rectangular K walk every pair;
//   * one tile pair of 128 x 128 points per block, balanced over the
//     triangle by the fold of row ti with row T - 1 - ti; each block writes
//     one float64 partial, no atomics, the same bits run to run;
//   * k from matern_exact_d2 (matern_mma.cuh): the same bits as sqrtf and
//     expf, without the branch nvcc puts around sqrtf, which cost a third
//     of the 'highest' product kernel;
//   * each thread owns kR = 4 rows and a quarter of the tile's columns, so
//     every column point read from shared memory (a warp-wide broadcast)
//     serves four pairs, and four independent sqrt/exp chains interleave;
//   * nu (four closed forms) and d = 2 are template parameters, other
//     d <= 8 run over zero-padded coordinates (exact: a zero pad adds 0 to
//     the squared distance); the Gram form has the any-d instances only;
//   * ragged row and column edges are masked, not padded with far points.
// Precision: built WITHOUT --use_fast_math. Each thread sums the k^2 of a
// row over its 32 columns of the tile in float32, then in float64.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"
#include "matern_trace.cuh"

using namespace gppe;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;  // rows per thread: lane + 32 r of its row set
constexpr int kRowSets = kTraceTile / (32 * kR);
constexpr int kColGroups = kWarps / kRowSets;
constexpr int kColsPerThread = kTraceTile / kColGroups;
static_assert(kRowSets * 32 * kR == kTraceTile && kColGroups >= 1 &&
                  kColGroups * kRowSets == kWarps,
              "the threads must tile the 128 x 128 pair exactly");

// k^2 of one column point y (coordinates, and its norm for the Gram form)
// with the thread's kR rows, added into their float32 sums
template <int NU, int KD, bool GRAM>
__device__ __forceinline__ void trace_column(const float (&x)[kR][KD],
                                             const float (&xn)[kR],
                                             const float* y_smem, float yn,
                                             float (&part)[kR]) {
  float y[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) y[k] = y_smem[k];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float d2 = 0.0f;
    if constexpr (GRAM) {
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < KD; ++k) dot = fmaf(x[r][k], y[k], dot);
      d2 = fmaxf(fmaf(-2.0f, dot, xn[r] + yn), 0.0f);
    } else {
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const float diff = x[r][k] - y[k];
        d2 = fmaf(diff, diff, d2);
      }
    }
    const float kv = matern_exact_d2<NU>(d2);
    part[r] = fmaf(kv, kv, part[r]);
  }
}

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded coordinates).
// GRAM: the Gram-form distance from centred points and their norms.
template <int NU, int D, bool GRAM>
__global__ void __launch_bounds__(kThreads)
    matern_frobenius_kernel(const float* __restrict__ rows,
                            const float* __restrict__ cols,
                            const float* __restrict__ rows_norm,
                            const float* __restrict__ cols_norm,
                            double* __restrict__ partials, int nr, int nc,
                            int d, int tiles_r, int tiles_c, int64_t pairs,
                            int per_block, bool symmetric) {
  constexpr int kD = D > 0 ? D : kMaxD;
  __shared__ __align__(16) float s_pts[kTraceTile][kD];
  __shared__ float s_norm[GRAM ? kTraceTile : 1];
  __shared__ double s_warp[kWarps];

  const int dim = D > 0 ? D : d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp % kRowSets) * 32 * kR + lane;
  const int col0 = (warp / kRowSets) * kColsPerThread;

  double acc = 0.0;
  const int64_t p_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t p_end =
      p_begin + per_block < pairs ? p_begin + per_block : pairs;
  for (int64_t p = p_begin; p < p_end; ++p) {
    const TilePair tp = trace_tile_pair(p, tiles_r, tiles_c, symmetric);
    const int j0 = tp.tj * kTraceTile;
    const int tc = min(kTraceTile, nc - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTraceTile * kD; e += kThreads) {
      const int j = e / kD;
      const int k = e % kD;
      s_pts[j][k] = (j < tc && k < dim)
                        ? cols[static_cast<int64_t>(j0 + j) * dim + k]
                        : 0.0f;
    }
    if constexpr (GRAM) {
      for (int j = threadIdx.x; j < kTraceTile; j += kThreads) {
        s_norm[j] = j < tc ? cols_norm[j0 + j] : 0.0f;
      }
    }
    float x[kR][kD];
    float xn[kR];
    bool live[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = tp.ti * kTraceTile + row0 + 32 * r;
      live[r] = row < nr;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        x[r][k] = (live[r] && k < dim)
                      ? rows[static_cast<int64_t>(row) * dim + k]
                      : 0.0f;
      }
      xn[r] = (GRAM && live[r]) ? rows_norm[row] : 0.0f;
    }
    __syncthreads();

    float part[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) part[r] = 0.0f;
    const int jn = min(kColsPerThread, tc - col0);
    if (jn == kColsPerThread) {
#pragma unroll 8
      for (int j = col0; j < col0 + kColsPerThread; ++j) {
        trace_column<NU, kD, GRAM>(x, xn, s_pts[j], GRAM ? s_norm[j] : 0.0f,
                                   part);
      }
    } else {
      for (int j = col0; j < col0 + jn; ++j) {
        trace_column<NU, kD, GRAM>(x, xn, s_pts[j], GRAM ? s_norm[j] : 0.0f,
                                   part);
      }
    }
    double tile = 0.0;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (live[r]) tile += static_cast<double>(part[r]);
    }
    acc += tp.weight * tile;
  }
  const double total = block_sum<kWarps>(acc, s_warp);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

struct Args {
  const float* rows;
  const float* cols;
  const float* rows_norm;  // both norms null: the difference form
  const float* cols_norm;
  double* partials;
  int nr, nc, d, tiles_r, tiles_c;
  int64_t pairs;
  int per_block, blocks;
  bool symmetric;
  cudaStream_t stream;
};

template <int NU, int D, bool GRAM>
cudaError_t launch(const Args& a) {
  matern_frobenius_kernel<NU, D, GRAM><<<a.blocks, kThreads, 0, a.stream>>>(
      a.rows, a.cols, a.rows_norm, a.cols_norm, a.partials, a.nr, a.nc, a.d,
      a.tiles_r, a.tiles_c, a.pairs, a.per_block, a.symmetric);
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
// the (centred) rows and cols for the Gram form. `symmetric` (the rows are
// the columns, nr == nc) walks the tile pairs tj >= ti only. `partials`
// (`blocks` float64) receives one weighted k^2 sum per block of `per_block`
// tile pairs; the blocks must cover the walk's pairs exactly
// (cuda_kernels.trace_schedule).
extern "C" int gppe_matern_matmat(const void* rows, const void* cols,
                                  const void* rows_norm,
                                  const void* cols_norm, void* partials,
                                  int nr, int nc, int d, int nu_code,
                                  int symmetric, int per_block, int blocks,
                                  void* stream) {
  if (nr <= 0 || nc <= 0 || d < 1 || d > kMaxD || partials == nullptr ||
      (rows_norm == nullptr) != (cols_norm == nullptr) ||
      (symmetric && nr != nc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_r = (nr + kTraceTile - 1) / kTraceTile;
  const int tiles_c = (nc + kTraceTile - 1) / kTraceTile;
  const int64_t pairs = trace_pairs(tiles_r, tiles_c, symmetric != 0);
  if (!trace_grid_ok(pairs, per_block, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(rows),
               static_cast<const float*>(cols),
               static_cast<const float*>(rows_norm),
               static_cast<const float*>(cols_norm),
               static_cast<double*>(partials),
               nr,
               nc,
               d,
               tiles_r,
               tiles_c,
               pairs,
               per_block,
               blocks,
               symmetric != 0,
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
