// Fused tapered (block-sparse) Matern trace(K^2) for Hopper (sm_90a):
//
//     fro_rows[i] = sum_j K_tau[i, j]^2,
//     K_tau[i, j] = k >= tau ? k : 0,  k = k_nu(|x_i - x_j|),
//
// over a list of active tile pairs only. x (n_pad, d) are spatially sorted
// points already divided by the correlation scale and padded to a multiple
// of `tile`, float32; fro_rows (n_pad) float64. Row tile ti sums over the
// column tiles col_tiles[row_ptr[ti] .. row_ptr[ti + 1]). Only the first n
// rows and columns are real: pad rows are left untouched and pad columns
// are skipped, so nothing of the padding reaches a sum; the sum over i is
// trace(K_tau^2).
//
// Replaces the XLA scan of gppe_tpu/ops/taper.py::TaperedMaternOperator
// .trace_pow. It serves every dot mode: the tile-dot modes round the
// products' operands only, and the trace always sums the unrounded k^2.
// The products K_tau @ V, the port of
// gppe_tpu/ops/pallas_kernels.py::_blocksparse_kernel in all three modes,
// are matern_blocksparse_mma.cu, whose 'highest' k is this kernel's, bit
// for bit.
//
// The TPU kernel's grid is sequential: the first pair of a row tile
// initialises the output tile and later pairs add to it. Blocks here run in
// no order, so a block owns kRows = 128 rows of ONE row tile and loops over
// that tile's column tiles itself (the caller turns the sorted pair list
// into the row_ptr array once). No atomics, no cross-block sums: the result
// is deterministic, run to run.
//
// What bounds it on this card: per pair d subtract/FMAs, one sqrtf, one
// expf, one compare-select and one FMA for k^2, against O(pairs / tile * d)
// words of traffic that mostly hit the L2 cache - instruction issue, as in
// matern_matmat.cu, whose inner loop this is (one thread per row, column
// sub-tiles of kCols = 128 points staged in shared memory, float32 k^2 sums
// per sub-tile added in float64). Every pair of an active tile pair is
// evaluated, also those beyond the taper radius.
//
// The hard taper compares float32 k with float32 tau. A pair whose k lies
// within rounding of tau can fall on the other side than in float64; the
// comparisons against the plain float64 version therefore use thresholds
// that no pair comes close to (see ops/cuda_kernels.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;  // output rows per block, one per thread
constexpr int kCols = 128;  // column points per shared-memory tile

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded
// coordinates). grid.x: row tile * blocks per tile + block within the tile.
template <int NU, int D>
__global__ void __launch_bounds__(kRows)
    blocksparse_trace_kernel(const float* __restrict__ pts,
                             double* __restrict__ fro_rows,
                             const int* __restrict__ row_ptr,
                             const int* __restrict__ col_tiles, int n, int d,
                             int tile, int blocks_per_tile, float tau) {
  constexpr int kD = D > 0 ? D : kMaxD;
  __shared__ float s_pts[kD][kCols];

  const int dim = D > 0 ? D : d;
  const int ti = blockIdx.x / blocks_per_tile;
  const int local = (blockIdx.x % blocks_per_tile) * kRows + threadIdx.x;
  const int row = ti * tile + local;  // < n_pad whenever local < tile
  const bool live = local < tile && row < n;

  float x[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    x[k] = (live && k < dim) ? pts[static_cast<int64_t>(row) * dim + k] : 0.0f;
  }
  double fro = 0.0;

  const int p_end = row_ptr[ti + 1];
  for (int p = row_ptr[ti]; p < p_end; ++p) {
    const int col_begin = col_tiles[p] * tile;
    const int col_end = min(col_begin + tile, n);  // pad columns skipped
    for (int j0 = col_begin; j0 < col_end; j0 += kCols) {
      const int tc = min(kCols, col_end - j0);
      __syncthreads();  // every thread is done with the previous tile
      for (int e = threadIdx.x; e < kD * kCols; e += kRows) {
        const int k = e / kCols;
        const int j = e % kCols;
        s_pts[k][j] = (j < tc && k < dim)
                          ? pts[static_cast<int64_t>(j0 + j) * dim + k]
                          : 0.0f;
      }
      __syncthreads();

      float fro_tile = 0.0f;
      for (int j = 0; j < tc; ++j) {
        float d2 = 0.0f;
#pragma unroll
        for (int k = 0; k < kD; ++k) {
          const float diff = x[k] - s_pts[k][j];
          d2 = fmaf(diff, diff, d2);
        }
        float kv = matern_from_d2<NU>(d2);
        kv = kv >= tau ? kv : 0.0f;  // the hard taper
        fro_tile = fmaf(kv, kv, fro_tile);
      }
      fro += static_cast<double>(fro_tile);
    }
  }

  if (live) fro_rows[row] = fro;
}

struct Args {
  const float* pts;
  double* fro_rows;
  const int* row_ptr;
  const int* col_tiles;
  int n, d, tile, num_tiles;
  float tau;
  cudaStream_t stream;
};

template <int NU, int D>
cudaError_t launch(const Args& a) {
  const int blocks_per_tile = (a.tile + kRows - 1) / kRows;
  const int64_t grid_x = static_cast<int64_t>(a.num_tiles) * blocks_per_tile;
  if (grid_x > 2147483647LL) return cudaErrorInvalidValue;
  blocksparse_trace_kernel<NU, D>
      <<<static_cast<unsigned>(grid_x), kRows, 0, a.stream>>>(
          a.pts, a.fro_rows, a.row_ptr, a.col_tiles, a.n, a.d, a.tile,
          blocks_per_tile, a.tau);
  return cudaGetLastError();
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  return a.d == 2 ? launch<NU, 2>(a) : launch<NU, 0>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `pts` holds num_tiles * tile
// points, of which the first n are real; `row_ptr` has num_tiles + 1 int32
// entries and `col_tiles` row_ptr[num_tiles] int32 tile indices;
// `fro_rows` num_tiles * tile float64, pad rows left untouched.
extern "C" int gppe_matern_blocksparse(const void* pts, void* fro_rows,
                                       const void* row_ptr,
                                       const void* col_tiles, int n, int d,
                                       int tile, int num_tiles, float tau,
                                       int nu_code, void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || tile <= 0 || num_tiles <= 0 ||
      fro_rows == nullptr ||
      static_cast<int64_t>(num_tiles) * tile > 2147483647LL ||
      static_cast<int64_t>(num_tiles) * tile < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<double*>(fro_rows),
               static_cast<const int*>(row_ptr),
               static_cast<const int*>(col_tiles),
               n,
               d,
               tile,
               num_tiles,
               tau,
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
