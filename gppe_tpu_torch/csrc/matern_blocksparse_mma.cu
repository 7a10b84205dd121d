// Fused tapered (block-sparse) Matern correlation matmat on the tensor
// cores, for Hopper (sm_90a):
//
//     out = K_tau @ V,   K_tau[i, j] = k >= tau ? k : 0,  k = k_nu(|x_i - x_j|),
//
// over a list of active tile pairs only, at the two reduced tile-dot
// precisions: 'bf16' (K_tau and V rounded to bfloat16, float32 sums) and
// 'bf16x3' (both split into a bfloat16 high part and the bfloat16 rounding
// of the residual, k_hi v_hi + k_lo v_hi + k_hi v_lo, float32 sums). The
// taper is taken on the unrounded float32 k. Operands as in
// matern_blocksparse.cu: x (n_pad, d) spatially sorted points already
// divided by the correlation scale and padded to a multiple of `tile`; V
// and out (n_pad, r) row-major in the same order; row tile ti multiplies
// the column tiles col_tiles[row_ptr[ti] .. row_ptr[ti + 1]). Only the first
// n rows and columns are real: pad rows of out are written as zero and pad
// columns are skipped.
//
// Replaces the 'bf16x3' and 'bf16' modes of
// gppe_tpu/ops/pallas_kernels.py::_tile_dot inside ::_blocksparse_kernel.
// The exact mode 'highest' and trace(K_tau^2) stay in matern_blocksparse.cu.
//
// Approximate: k is formed from sqrt.approx and ex2.approx, the bare SFU
// results (matern_approx in matern_mma.cuh; each within 2^-22 relative),
// not from the IEEE sqrtf and expf. k is rounded to bf16 parts right away
// and the error is 20 times under what the 'bf16x3' split costs; every
// accuracy bound of the mode is held with these. With the IEEE routines the
// kernel took 10.0 ms where it takes 5.9 (n = 2^20, r = 24, 'bf16x3';
// NVIDIA H100 80GB HBM3, 700 W, same run).
//
// What bounds it on this card: per pair of an active tile pair the
// distance, one sqrt, one exp2, one compare-select and the rounding of k
// to one or two bf16 values, on the CUDA cores and the SFU; the r
// multiply-adds per pair go to the tensor cores and the traffic mostly hits
// the L2 cache. So it is bound by the instructions that produce K, as
// matern_matmat_mma.cu is, whose inner loop this is.
//
// What the design does about it:
//   * ownership as in matern_blocksparse.cu: a block owns 128 rows of ONE
//     row tile (4 warps, two m16 tiles each) and walks that tile's column
//     tiles itself, in sub-tiles of 128 points. No atomics and no
//     cross-block sums: the same bits run to run;
//   * inside a sub-tile a thread computes the K entries of its own
//     mma.sync.m16n8k16 A fragments (matern_mma.cuh), tapers, rounds and
//     packs them in registers; V is staged transposed and pre-split into
//     bf16 high and residual arrays;
//   * V is taken 8, 16, 24 or 32 columns at a time (r = 24 is 3 n8 tiles);
//     wider V is split into 32-column chunks over grid.y;
//   * a sub-tile's products are summed in fresh accumulator fragments,
//     which are then added to running float32 sums (tensor-core
//     accumulators do not round to nearest);
//   * pad columns and columns past a ragged sub-tile are staged with zero
//     coordinates and v = 0 and add nothing; rows past the row tile are not
//     written and pad rows are written as zero.
// bf16 rounds V, so u.Kv and v.Ku differ at the 1e-6 level in 'bf16x3'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"

using namespace gppe;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 32;              // two m16 tiles per warp
constexpr int kRows = kWarps * kWarpRows;  // output rows per block
constexpr int kCols = kMmaCols;            // column points per staged tile
constexpr int kStep = kMmaStep;            // depth of one mma
constexpr int kMaxNT = 4;                  // n8 tiles per block: 32 V columns

// NT: n8 tiles of V columns per block. X3: 'bf16x3' (else 'bf16').
// grid.x: row tile * blocks per tile + block within the tile; grid.y:
// chunks of NT * 8 V columns.
template <int NU, int NT, bool X3>
__global__ void __launch_bounds__(kThreads)
    blocksparse_mma_kernel(const float* __restrict__ pts,
                           const float* __restrict__ V,
                           float* __restrict__ out,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ col_tiles, int n, int d,
                           int r, int tile, int blocks_per_tile, float tau) {
  constexpr int kRC = NT * 8;
  __shared__ float s_rows[kMaxD][kRows];
  __shared__ __align__(8) float s_cols[kMaxD][kCols];
  __shared__ __align__(16) uint16_t s_vhi[kRC][kLdV];
  __shared__ __align__(16) uint16_t s_vlo[X3 ? kRC : 1][X3 ? kLdV : 2];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in group: the fragment's column pair
  const int wrow = (threadIdx.x >> 5) * kWarpRows;  // warp's first row
  const int ti = blockIdx.x / blocks_per_tile;
  const int local0 = (blockIdx.x % blocks_per_tile) * kRows;
  const int row0 = ti * tile + local0;  // the block's first row
  const int c0 = blockIdx.y * kRC;

  // the block's row points, dimension-major; rows past the tile or past n
  // are zeros
  for (int e = threadIdx.x; e < d * kRows; e += kThreads) {
    const int k = e / kRows;
    const int i = e % kRows;
    s_rows[k][i] = (local0 + i < tile && row0 + i < n)
                       ? pts[static_cast<int64_t>(row0 + i) * d + k]
                       : 0.0f;
  }

  // acc[m16 tile][n8 tile][fragment element]: the running sums
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }

  const int p_end = row_ptr[ti + 1];
  for (int p = row_ptr[ti]; p < p_end; ++p) {
    const int col_begin = col_tiles[p] * tile;
    const int col_end = min(col_begin + tile, n);  // pad columns skipped
    for (int j0 = col_begin; j0 < col_end; j0 += kCols) {
      const int tc = min(kCols, col_end - j0);
      __syncthreads();  // every warp is done with the previous sub-tile
      for (int e = threadIdx.x; e < d * kCols; e += kThreads) {
        const int k = e / kCols;
        const int j = e % kCols;
        s_cols[k][j] =
            j < tc ? pts[static_cast<int64_t>(j0 + j) * d + k] : 0.0f;
      }
      for (int e = threadIdx.x; e < kCols * kRC; e += kThreads) {
        const int j = e / kRC;
        const int c = e % kRC;
        const float v = (j < tc && c0 + c < r)
                            ? V[static_cast<int64_t>(j0 + j) * r + c0 + c]
                            : 0.0f;
        stage_split<X3>(v, s_vhi[c][j], s_vlo[X3 ? c : 0][X3 ? j : 0]);
      }
      __syncthreads();

      // this sub-tile's products, in fresh accumulators
      float part[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
        }
      }

      for (int kk = 0; kk < tc; kk += kStep) {
        // the thread's 4 rows (m16 tile mt, half h: row wrow + 16 mt + 8 h
        // + g) x 4 columns (kk + 2 tig, + 1, + 8, + 9): squared distances
        float d2[2][2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int c = 0; c < 4; ++c) d2[mt][h][c] = 0.0f;
          }
        }
        for (int k = 0; k < d; ++k) {
          const float2 ya =
              *reinterpret_cast<const float2*>(&s_cols[k][kk + 2 * tig]);
          const float2 yb =
              *reinterpret_cast<const float2*>(&s_cols[k][kk + 8 + 2 * tig]);
          const float y[4] = {ya.x, ya.y, yb.x, yb.y};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float x = s_rows[k][wrow + 16 * mt + 8 * h + g];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float diff = x - y[c];
                d2[mt][h][c] = fmaf(diff, diff, d2[mt][h][c]);
              }
            }
          }
        }

        // the tapered k, rounded, into the A fragments
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float kv[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float k = matern_approx<NU>(sqrt_approx(d2[mt][h][c]),
                                                rho_weight<NU>(1.0f));
              kv[c] = k >= tau ? k : 0.0f;  // the hard taper
            }
            pack_pair<X3>(kv[0], kv[1], a_hi[mt][h], a_lo[mt][h]);
            pack_pair<X3>(kv[2], kv[3], a_hi[mt][2 + h], a_lo[mt][2 + h]);
          }
        }

#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const BFragment b = load_b<X3>(
              s_vhi[nt * 8 + g], s_vlo[X3 ? nt * 8 + g : 0], kk, tig);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tile_dot<X3>(part[mt][nt], a_hi[mt], a_lo[mt], b);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
        }
      }
    }
  }

  // fragment element i: row g (+ 8 for i >= 2), column 2 tig + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int local = local0 + wrow + 16 * mt + 8 * (i >> 1) + g;
        const int row = ti * tile + local;  // < n_pad whenever local < tile
        const int col = c0 + nt * 8 + 2 * tig + (i & 1);
        if (local < tile && col < r) {
          out[static_cast<int64_t>(row) * r + col] =
              row < n ? acc[mt][nt][i] : 0.0f;
        }
      }
    }
  }
}

struct Args {
  const float* pts;
  const float* V;
  float* out;
  const int* row_ptr;
  const int* col_tiles;
  int n, d, r, tile, num_tiles;
  float tau;
  cudaStream_t stream;
};

template <int NU, int NT, bool X3>
cudaError_t launch(const Args& a) {
  const int chunks = (a.r + NT * 8 - 1) / (NT * 8);
  const int blocks_per_tile = (a.tile + kRows - 1) / kRows;
  const int64_t grid_x = static_cast<int64_t>(a.num_tiles) * blocks_per_tile;
  if (grid_x > 2147483647LL || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x), chunks);
  blocksparse_mma_kernel<NU, NT, X3><<<grid, kThreads, 0, a.stream>>>(
      a.pts, a.V, a.out, a.row_ptr, a.col_tiles, a.n, a.d, a.r, a.tile,
      blocks_per_tile, a.tau);
  return cudaGetLastError();
}

template <int NU, bool X3>
cudaError_t launch_nt(const Args& a) {
  if (a.r <= 8) return launch<NU, 1, X3>(a);
  if (a.r <= 16) return launch<NU, 2, X3>(a);
  if (a.r <= 24) return launch<NU, 3, X3>(a);
  return launch<NU, kMaxNT, X3>(a);
}

template <int NU>
cudaError_t launch_mode(const Args& a, int dot_code) {
  return dot_code == kDotBf16x3 ? launch_nt<NU, true>(a)
                                : launch_nt<NU, false>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `pts` holds num_tiles * tile
// points, of which the first n are real; `row_ptr` has num_tiles + 1 int32
// entries and `col_tiles` row_ptr[num_tiles] int32 tile indices. `dot_code`
// is kDotBf16x3 or kDotBf16; r >= 1.
extern "C" int gppe_matern_blocksparse_mma(const void* pts, const void* V,
                                           void* out, const void* row_ptr,
                                           const void* col_tiles, int n,
                                           int d, int r, int tile,
                                           int num_tiles, float tau,
                                           int nu_code, int dot_code,
                                           void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || r < 1 || tile <= 0 || num_tiles <= 0 ||
      (dot_code != kDotBf16x3 && dot_code != kDotBf16) ||
      static_cast<int64_t>(num_tiles) * tile > 2147483647LL ||
      static_cast<int64_t>(num_tiles) * tile < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               static_cast<const int*>(row_ptr),
               static_cast<const int*>(col_tiles),
               n,
               d,
               r,
               tile,
               num_tiles,
               tau,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (nu_code) {
    case kNuHalf: err = launch_mode<kNuHalf>(a, dot_code); break;
    case kNuThreeHalf: err = launch_mode<kNuThreeHalf>(a, dot_code); break;
    case kNuFiveHalf: err = launch_mode<kNuFiveHalf>(a, dot_code); break;
    case kNuGauss: err = launch_mode<kNuGauss>(a, dot_code); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
