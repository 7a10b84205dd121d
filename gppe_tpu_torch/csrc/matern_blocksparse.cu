// Fused tapered (block-sparse) Matern correlation matmat for Hopper (sm_90a):
//
//     out = K_tau @ V,   K_tau[i, j] = k >= tau ? k : 0,  k = k_nu(|x_i - x_j|),
//
// over a list of active tile pairs only. x (n_pad, d) are spatially sorted
// points already divided by the correlation scale and padded to a multiple
// of `tile`; V and out are (n_pad, r) row-major in the same order; all
// float32. Row tile ti multiplies the column tiles
// col_tiles[row_ptr[ti] .. row_ptr[ti + 1]). Only the first n rows and
// columns are real: pad rows of out are written as zero and pad columns are
// skipped, so nothing of the padding reaches a sum. Optionally each row also
// writes its sum of squared tapered entries in float64, so one launch with
// r = 0 gives trace(K_tau^2).
//
// Replaces gppe_tpu/ops/pallas_kernels.py::_blocksparse_kernel (the TPU's
// kernel over a scalar-prefetched pair list) and folds in the XLA scan of
// gppe_tpu/ops/taper.py::TaperedMaternOperator.trace_pow.
//
// The TPU kernel's grid is sequential: the first pair of a row tile
// initialises the output tile and later pairs add to it. Blocks here run in
// no order, so a block owns kRows = 128 rows of ONE row tile and loops over
// that tile's column tiles itself (the caller turns the sorted pair list
// into the row_ptr array once). No atomics, no cross-block sums: the result
// is deterministic, run to run.
//
// What bounds it on this card: per pair d subtract/FMAs, one sqrtf, one
// expf, one compare-select and r FMAs, against O(pairs / tile * (d + r))
// words of traffic that mostly hit the L2 cache - instruction issue, as in
// matern_matmat.cu, whose inner loop this is (one thread per row, column
// sub-tiles of kCols = 128 points staged in shared memory, RC register sums
// per thread, two-level float32 sums, float64 k^2 sums). Every pair of an
// active tile pair is evaluated, also those beyond the taper radius.
//
// The tile-dot modes of ::_tile_dot (MODE; 'bf16x3' and 'bf16') round the
// tapered k per pair and V as its tile is staged, and sum the one or three
// products by the same float32 FMAs (round_k, stage_v, tile_fma in
// matern_common.cuh): bf16 operands and float32 sums, as on the TPU, in this
// kernel's ownership and summation design. The taper is taken on the
// unrounded k. These modes add instructions and save none, so they are
// slower than 'highest' here (tensor cores are a redesign of this kernel);
// they exist for any d only and carry no trace output.
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
constexpr int kMaxRC = 32;  // V columns per block; wider V uses grid.y

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded coordinates).
// RC: V columns per block; 0 for a trace-only launch (V and out unused).
// FRO: also write the per-row float64 sum of k^2 (grid.y == 0 blocks only).
// MODE: the tile-dot mode (kDotHighest, kDotBf16x3, kDotBf16).
// grid.x: row tile * blocks per tile + block within the tile.
template <int NU, int D, int RC, bool FRO, int MODE>
__global__ void __launch_bounds__(kRows)
    blocksparse_kernel(const float* __restrict__ pts,
                       const float* __restrict__ V, float* __restrict__ out,
                       double* __restrict__ fro_rows,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ col_tiles, int n, int d, int r,
                       int tile, int blocks_per_tile, float tau) {
  constexpr int kD = D > 0 ? D : kMaxD;
  constexpr int kRC = RC > 0 ? RC : 1;
  __shared__ float s_pts[kD][kCols];
  __shared__ __align__(16) float s_v[kCols][kRC];

  const int dim = D > 0 ? D : d;
  const int ti = blockIdx.x / blocks_per_tile;
  const int local = (blockIdx.x % blocks_per_tile) * kRows + threadIdx.x;
  const int row = ti * tile + local;  // < n_pad whenever local < tile
  const int c0 = blockIdx.y * RC;
  const bool in_tile = local < tile;
  const bool live = in_tile && row < n;

  float x[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    x[k] = (live && k < dim) ? pts[static_cast<int64_t>(row) * dim + k] : 0.0f;
  }
  float acc[kRC];
#pragma unroll
  for (int c = 0; c < kRC; ++c) acc[c] = 0.0f;
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
      if constexpr (RC > 0) {
        for (int e = threadIdx.x; e < kCols * RC; e += kRows) {
          const int j = e / RC;
          const int c = e % RC;
          s_v[j][c] =
              (j < tc && c0 + c < r)
                  ? stage_v<MODE>(V[static_cast<int64_t>(j0 + j) * r + c0 + c])
                  : 0.0f;
        }
      }
      __syncthreads();

      float part[kRC];
#pragma unroll
      for (int c = 0; c < kRC; ++c) part[c] = 0.0f;
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
        if constexpr (FRO) fro_tile = fmaf(kv, kv, fro_tile);
        float k_hi, k_lo;
        round_k<MODE>(kv, k_hi, k_lo);
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          part[c] = tile_fma<MODE>(k_hi, k_lo, s_v[j][c], part[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[c] += part[c];
      if constexpr (FRO) fro += static_cast<double>(fro_tile);
    }
  }

  if (!in_tile) return;
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (c0 + c < r) {
      out[static_cast<int64_t>(row) * r + c0 + c] = live ? acc[c] : 0.0f;
    }
  }
  if constexpr (FRO) {
    if (blockIdx.y == 0 && live) fro_rows[row] = fro;
  }
}

struct Args {
  const float* pts;
  const float* V;
  float* out;
  double* fro_rows;
  const int* row_ptr;
  const int* col_tiles;
  int n, d, r, tile, num_tiles, dot_code;
  float tau;
  cudaStream_t stream;
};

template <int NU, int D, int RC, bool FRO, int MODE>
cudaError_t launch(const Args& a) {
  int chunks = 1;
  if constexpr (RC > 0) chunks = (a.r + RC - 1) / RC;
  const int blocks_per_tile = (a.tile + kRows - 1) / kRows;
  const int64_t grid_x = static_cast<int64_t>(a.num_tiles) * blocks_per_tile;
  if (grid_x > 2147483647LL || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x), chunks);
  blocksparse_kernel<NU, D, RC, FRO, MODE><<<grid, kRows, 0, a.stream>>>(
      a.pts, a.V, a.out, a.fro_rows, a.row_ptr, a.col_tiles, a.n, a.d, a.r,
      a.tile, blocks_per_tile, a.tau);
  return cudaGetLastError();
}

template <int NU, int D, int RC>
cudaError_t launch_fro(const Args& a) {
  return a.fro_rows != nullptr ? launch<NU, D, RC, true, kDotHighest>(a)
                               : launch<NU, D, RC, false, kDotHighest>(a);
}

template <int NU, int D>
cudaError_t launch_rc(const Args& a) {
  if (a.r == 0) {
    return a.fro_rows != nullptr ? launch<NU, D, 0, true, kDotHighest>(a)
                                 : cudaErrorInvalidValue;
  }
  if (a.r <= 8) return launch_fro<NU, D, 8>(a);
  if (a.r <= 16) return launch_fro<NU, D, 16>(a);
  if (a.r <= 24) return launch_fro<NU, D, 24>(a);
  return launch_fro<NU, D, kMaxRC>(a);
}

// The bf16 modes: any-d instances, a product and no trace output.
template <int NU, int MODE>
cudaError_t launch_mode(const Args& a) {
  if (a.r == 0 || a.fro_rows != nullptr) return cudaErrorInvalidValue;
  if (a.r <= 8) return launch<NU, 0, 8, false, MODE>(a);
  if (a.r <= 16) return launch<NU, 0, 16, false, MODE>(a);
  if (a.r <= 24) return launch<NU, 0, 24, false, MODE>(a);
  return launch<NU, 0, kMaxRC, false, MODE>(a);
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  if (a.dot_code == kDotBf16x3) return launch_mode<NU, kDotBf16x3>(a);
  if (a.dot_code == kDotBf16) return launch_mode<NU, kDotBf16>(a);
  return a.d == 2 ? launch_rc<NU, 2>(a) : launch_rc<NU, 0>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `pts` holds num_tiles * tile
// points, of which the first n are real; `row_ptr` has num_tiles + 1 int32
// entries and `col_tiles` row_ptr[num_tiles] int32 tile indices. `V` and
// `out` may be null when r == 0; `fro_rows` (num_tiles * tile float64, pad
// rows left untouched) is null unless the k^2 row sums are wanted, and must
// be null (and r > 0) when `dot_code` is not kDotHighest.
extern "C" int gppe_matern_blocksparse(const void* pts, const void* V,
                                       void* out, void* fro_rows,
                                       const void* row_ptr,
                                       const void* col_tiles, int n, int d,
                                       int r, int tile, int num_tiles,
                                       float tau, int nu_code, int dot_code,
                                       void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || r < 0 || tile <= 0 || num_tiles <= 0 ||
      dot_code < 0 || dot_code > kDotBf16 ||
      static_cast<int64_t>(num_tiles) * tile > 2147483647LL ||
      static_cast<int64_t>(num_tiles) * tile < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               static_cast<double*>(fro_rows),
               static_cast<const int*>(row_ptr),
               static_cast<const int*>(col_tiles),
               n,
               d,
               r,
               tile,
               num_tiles,
               dot_code,
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
