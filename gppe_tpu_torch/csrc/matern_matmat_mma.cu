// Fused Matern correlation matmat on the tensor cores, for Hopper (sm_90a):
//
//     out = K @ V,   K[i, j] = k_nu(|x_i - y_j|),
//
// at the two reduced tile-dot precisions: 'bf16' (K and V rounded to
// bfloat16, float32 sums) and 'bf16x3' (both operands split into a bfloat16
// high part and the bfloat16 rounding of the residual, k_hi v_hi + k_lo v_hi
// + k_hi v_lo, float32 sums; only lo*lo is dropped, about 5e-6 of relative
// error). x (nr, d), y (nc, d): row and column points already divided by the
// correlation scale; V (nc, r), out (nr, r) row-major; all float32 in device
// memory. K is never stored, in any precision.
//
// Replaces the 'bf16x3' and 'bf16' modes of
// gppe_tpu/ops/pallas_kernels.py::_tile_dot inside ::_matmat_kernel and,
// with the GRAM flag, inside ::_matmat_kernel_gram (squared distance
// |x|^2 + |y|^2 - 2 x.y clamped at 0, on points the caller centred and with
// the norms the caller computed; the d <= 8 contraction is d float32 FMAs on
// the CUDA cores, not a tensor-core product). The exact mode 'highest' and
// every trace(K^2) pass stay in matern_matmat.cu.
//
// What bounds it on this card. Per pair (i, j): the distance, one sqrtf, one
// expf, and the rounding of k to one or two bf16 values, all on the CUDA
// cores and the SFU; the r multiply-adds per pair go to the tensor cores,
// 2 n^2 r (x3) bf16 operations that the card could issue in a small
// fraction of the time the k tile takes to compute. Device-memory traffic
// is O(n (d + r)) words. So the kernel is bound by the instructions that
// produce K, not by the product and not by HBM.
//
// What the design does about it:
//   * the product is mma.sync.m16n8k16 (bf16 operands, float32 accumulate).
//     A thread computes exactly the K entries its own A fragment holds (two
//     rows x four columns of each 16 x 16 tile), rounds them and packs them
//     into the fragment registers: the K tile never passes through shared
//     memory and a warp needs no barrier between computing K and multiplying
//     it;
//   * a block of 4 warps owns 128 rows, 32 per warp (two m16 tiles), and
//     walks the columns in tiles of 128 points. Per tile it stages the column
//     points (and norms) as float32 and the V tile transposed, already
//     rounded and split into bf16 high and residual arrays; every thread
//     reads its B fragments from there as 32-bit words (a row stride of
//     128 + 8 bf16 makes those loads conflict-free);
//   * V is taken 8, 16, 24 or 32 columns at a time (NT n8 tiles: the
//     engine's r = 24 is 3 x 8, no padded column); wider V is split into
//     32-column chunks over grid.y, and each chunk recomputes K, as
//     matern_matmat.cu does;
//   * d is a run-time loop over staged coordinates (the build has 64
//     instances of this kernel as it is; a d = 2 specialisation would double
//     them);
//   * accumulation: tensor-core accumulators do not round to nearest, so one
//     column tile's products (8 k-steps) are summed in a fresh accumulator
//     fragment, which is then added to a running float32 sum held in
//     ordinary registers - the two-level sum of matern_matmat.cu;
//   * ragged edges are masked, not padded with far points: a column past nc
//     is staged with zero coordinates, so its k is finite, and with v = 0,
//     so it adds nothing; rows past nr are computed and not written.
// bf16 rounds V, so the map V -> K V is not exactly linear: u.Kv and v.Ku
// differ at the 1e-6 level in 'bf16x3' (the exact kernel keeps 1e-7).
// Not yet used: wgmma, TMA, a pipelined schedule; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"

using namespace gppe;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 32;            // two m16 tiles per warp
constexpr int kRows = kWarps * kWarpRows;  // output rows per block
constexpr int kCols = kMmaCols;          // column points per staged tile
constexpr int kStep = kMmaStep;          // depth of one mma
constexpr int kMaxNT = 4;                // n8 tiles per block: 32 V columns

// NT: n8 tiles of V columns per block. X3: 'bf16x3' (else 'bf16').
// GRAM: the Gram-form distance from centred points and their norms.
// grid.x: row blocks; grid.y: chunks of NT * 8 V columns.
template <int NU, int NT, bool X3, bool GRAM>
__global__ void __launch_bounds__(kThreads)
    matern_matmat_mma_kernel(const float* __restrict__ rows,
                             const float* __restrict__ cols,
                             const float* __restrict__ rows_norm,
                             const float* __restrict__ cols_norm,
                             const float* __restrict__ V,
                             float* __restrict__ out, int nr, int nc, int d,
                             int r) {
  constexpr int kRC = NT * 8;
  __shared__ float s_rows[kMaxD][kRows];
  __shared__ __align__(8) float s_cols[kMaxD][kCols];
  __shared__ float s_rnorm[GRAM ? kRows : 1];
  __shared__ float s_cnorm[GRAM ? kCols : 1];
  __shared__ __align__(16) uint16_t s_vhi[kRC][kLdV];
  __shared__ __align__(16) uint16_t s_vlo[X3 ? kRC : 1][X3 ? kLdV : 2];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in group: the fragment's column pair
  const int wrow = (threadIdx.x >> 5) * kWarpRows;  // warp's first row
  const int row0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kRC;

  // the block's row points, dimension-major; rows past nr are zeros
  for (int e = threadIdx.x; e < d * kRows; e += kThreads) {
    const int k = e / kRows;
    const int i = e % kRows;
    s_rows[k][i] = row0 + i < nr
                       ? rows[static_cast<int64_t>(row0 + i) * d + k]
                       : 0.0f;
  }
  if constexpr (GRAM) {
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      s_rnorm[i] = row0 + i < nr ? rows_norm[row0 + i] : 0.0f;
    }
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

  for (int j0 = 0; j0 < nc; j0 += kCols) {
    const int tc = min(kCols, nc - j0);
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < d * kCols; e += kThreads) {
      const int k = e / kCols;
      const int j = e % kCols;
      s_cols[k][j] =
          j < tc ? cols[static_cast<int64_t>(j0 + j) * d + k] : 0.0f;
    }
    if constexpr (GRAM) {
      for (int j = threadIdx.x; j < kCols; j += kThreads) {
        s_cnorm[j] = j < tc ? cols_norm[j0 + j] : 0.0f;
      }
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

    // this tile's products, in fresh accumulators
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
      // the thread's 4 rows (m16 tile mt, half h: row wrow + 16 mt + 8 h + g)
      // x 4 columns (kk + 2 tig, + 1, + 8, + 9): squared distances, or for
      // the Gram form the dot products first
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
              if constexpr (GRAM) {
                d2[mt][h][c] = fmaf(x, y[c], d2[mt][h][c]);
              } else {
                const float diff = x - y[c];
                d2[mt][h][c] = fmaf(diff, diff, d2[mt][h][c]);
              }
            }
          }
        }
      }
      if constexpr (GRAM) {
        const float2 na =
            *reinterpret_cast<const float2*>(&s_cnorm[kk + 2 * tig]);
        const float2 nb =
            *reinterpret_cast<const float2*>(&s_cnorm[kk + 8 + 2 * tig]);
        const float yn[4] = {na.x, na.y, nb.x, nb.y};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float xn = s_rnorm[wrow + 16 * mt + 8 * h + g];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              d2[mt][h][c] =
                  fmaxf(fmaf(-2.0f, d2[mt][h][c], xn + yn[c]), 0.0f);
            }
          }
        }
      }

      // k, rounded, into the A fragments: a[0] row g, columns 2 tig, + 1;
      // a[1] row g + 8, same columns; a[2], a[3] the same rows, columns + 8
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float kv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            kv[c] = matern_from_d2<NU>(d2[mt][h][c]);
          }
          pack_pair<X3>(kv[0], kv[1], a_hi[mt][h], a_lo[mt][h]);
          pack_pair<X3>(kv[2], kv[3], a_hi[mt][2 + h], a_lo[mt][2 + h]);
        }
      }

      // B fragments: b0 rows kk + 2 tig, + 1 of V column g of the n8 tile;
      // b1 the same column, rows + 8
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const BFragment b = load_b<X3>(s_vhi[nt * 8 + g],
                                       s_vlo[X3 ? nt * 8 + g : 0], kk, tig);
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

  // fragment element i: row g (+ 8 for i >= 2), column 2 tig + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + wrow + 16 * mt + 8 * (i >> 1) + g;
        const int col = c0 + nt * 8 + 2 * tig + (i & 1);
        if (row < nr && col < r) {
          out[static_cast<int64_t>(row) * r + col] = acc[mt][nt][i];
        }
      }
    }
  }
}

struct Args {
  const float* rows;
  const float* cols;
  const float* rows_norm;  // both norms null: the difference form
  const float* cols_norm;
  const float* V;
  float* out;
  int nr, nc, d, r;
  cudaStream_t stream;
};

template <int NU, int NT, bool X3, bool GRAM>
cudaError_t launch(const Args& a) {
  const int chunks = (a.r + NT * 8 - 1) / (NT * 8);
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.nr + kRows - 1) / kRows, chunks);
  matern_matmat_mma_kernel<NU, NT, X3, GRAM><<<grid, kThreads, 0, a.stream>>>(
      a.rows, a.cols, a.rows_norm, a.cols_norm, a.V, a.out, a.nr, a.nc, a.d,
      a.r);
  return cudaGetLastError();
}

template <int NU, int NT, bool X3>
cudaError_t launch_dist(const Args& a) {
  return a.rows_norm != nullptr ? launch<NU, NT, X3, true>(a)
                                : launch<NU, NT, X3, false>(a);
}

template <int NU, bool X3>
cudaError_t launch_nt(const Args& a) {
  if (a.r <= 8) return launch_dist<NU, 1, X3>(a);
  if (a.r <= 16) return launch_dist<NU, 2, X3>(a);
  if (a.r <= 24) return launch_dist<NU, 3, X3>(a);
  return launch_dist<NU, kMaxNT, X3>(a);
}

template <int NU>
cudaError_t launch_mode(const Args& a, int dot_code) {
  return dot_code == kDotBf16x3 ? launch_nt<NU, true>(a)
                                : launch_nt<NU, false>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `dot_code` is kDotBf16x3 or
// kDotBf16. `rows_norm` (nr) and `cols_norm` (nc) are both null for the
// difference form, or hold the squared norms of the (centred) rows and cols
// for the Gram form. r >= 1.
extern "C" int gppe_matern_matmat_mma(const void* rows, const void* cols,
                                      const void* rows_norm,
                                      const void* cols_norm, const void* V,
                                      void* out, int nr, int nc, int d, int r,
                                      int nu_code, int dot_code,
                                      void* stream) {
  if (nr <= 0 || nc < 0 || d < 1 || d > kMaxD || r < 1 ||
      (dot_code != kDotBf16x3 && dot_code != kDotBf16) ||
      (rows_norm == nullptr) != (cols_norm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(rows),
               static_cast<const float*>(cols),
               static_cast<const float*>(rows_norm),
               static_cast<const float*>(cols_norm),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               nr,
               nc,
               d,
               r,
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
