// Fused multi-rho Matern correlation matmat on the tensor cores, for Hopper
// (sm_90a):
//
//     out[b] = K(rho_b) @ V[b],   K(rho)[i, j] = k_nu(|x_i - x_j| / rho),
//
// at the two reduced tile-dot precisions: 'bf16' (K and V rounded to
// bfloat16, float32 sums) and 'bf16x3' (both operands split into a bfloat16
// high part and the bfloat16 rounding of the residual, k_hi v_hi + k_lo v_hi
// + k_hi v_lo, float32 sums). x (n, d) are the raw (unscaled) points,
// inv_rho (B,) the float32 1 / rho_b, V and out (B, n, r) row-major, all
// float32 in device memory. No K(rho_b) is ever stored, in any precision.
//
// Replaces the 'bf16x3' and 'bf16' modes of
// gppe_tpu/ops/pallas_kernels.py::_tile_dot inside ::_multirho_kernel. The
// exact mode 'highest' and every trace(K_b^2) stay in matern_multirho.cu.
// It keeps that kernel's order of work: d^2 by differences on the raw
// points, one sqrt, then per rho one multiply by a factor of 1 / rho_b and
// the closed form from the distance.
//
// Approximate: the sqrt is sqrt.approx and the exponential ex2.approx, the
// bare SFU results (matern_approx in matern_mma.cuh; each within 2^-22
// relative; for nu = 1/2 log2(e) / rho_b is folded into the one multiply),
// not the IEEE sqrtf and expf. k is rounded to bf16 parts right away and
// the error is 20 times under what the 'bf16x3' split costs; every accuracy
// bound of the modes is held with these. With the IEEE routines, 4 rhos
// per block and unpaired conversions this kernel took 122.1 ms where that
// design took 104.3 with the approximations, and it takes 67.5 as it is
// now (n = 10^5, B = 8, r = 16, 'bf16x3'; NVIDIA H100 80GB HBM3, 700 W,
// all in one run).
//
// What bounds it on this card. Per pair one distance and one sqrt, and per
// pair and rho one multiply, one exp2 and the rounding of k to one or two
// bf16 values, on the CUDA cores and the SFU. The r multiply-adds per pair
// and rho go to the tensor cores: 2 n^2 B r (x3) bf16 operations, a small
// fraction of the time it takes to produce the K entries. Traffic is
// O(B n r) words. With sqrt and exp2 one instruction each, the SFU is the
// busiest unit: it retires 16 results per clock and SM, so a warp's 16
// sqrt and 32 exp2 per 16-column step hold it for 384 clocks, against
// about 290 scheduler slots for all the warp's instructions; that alone
// is 32 ms at the grid path's shape.
//
// What the design does about it:
//   * the product is mma.sync.m16n8k16, and a thread computes exactly the K
//     entries its own A fragment holds (matern_mma.cuh), as in
//     matern_matmat_mma.cu: K never passes through shared memory;
//   * per 16-column step a thread computes the distance and the sqrt of
//     its rows x 4 columns ONCE and then walks the block's BT rhos: scale,
//     closed form, round and pack, and the n8 products (three each for
//     'bf16x3') into that rho's tile accumulators;
//   * a block owns 128 rows and BT rhos; a warp owns MT m16 tiles (16 MT
//     rows), so a B fragment read from shared memory serves MT products.
//     At r <= 16 (NT = 2 n8 tiles; the grid engine's block) BT = 2 and
//     MT = 2: 32 tile sums and 32 running sums per thread, the footprint of
//     matern_matmat_mma.cu, 122-127 registers, 4 blocks of 4 warps per SM.
//     Timed in one run at the grid path's shape, 'bf16x3' / 'bf16': BT = 4,
//     MT = 1 (a distance shared by 4 rhos, 8 warps, 2 blocks per SM) 96.3 /
//     53.5 ms; BT = 2, MT = 1 80.3 / 64.3 ms, and 71.3 / 55.6 ms held to 80
//     registers for 3 blocks per SM; BT = 2, MT = 2 67.5 / 54.0 ms. Sharing
//     a B fragment and keeping the occupancy buy more than sharing a
//     distance further: the distance and sqrt are computed B / 2 times per
//     pair, as in matern_multirho.cu. r <= 8 takes BT = 4, MT = 2 and r in
//     (16, 24] BT = 2, MT = 1 with NT = 3, each the same count of sums;
//   * V is staged per rho, transposed and pre-split into bf16 high and
//     residual arrays (row stride kLdV, conflict-free B loads); with the
//     points 26 KB of static shared memory at NT = 2;
//   * V columns are taken 8, 16 or 24 at a time (r = 24 costs 3 n8 tiles);
//     wider V is split into 16-column chunks over grid.y, each recomputing
//     K;
//   * accumulation: a column tile's products (8 steps) are summed in fresh
//     accumulator fragments, which are then added to running float32 sums
//     in ordinary registers (tensor-core accumulators do not round to
//     nearest), the two-level sum of matern_matmat_mma.cu;
//   * ragged edges are masked: a column past n is staged with zero
//     coordinates and v = 0 and adds nothing, rows past n are computed and
//     not written, and a rho past B is skipped.
// Not yet used: wgmma, TMA, a pipelined schedule, V converted once per
// launch instead of once per block, part of the exp2 as a polynomial on
// the FMA pipe; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;                 // output rows per block
constexpr int kCols = kMmaCols;            // column points per staged tile
constexpr int kStep = kMmaStep;            // depth of one mma
constexpr int kChunkNT = 2;                // n8 tiles per chunk of a wide V

// NT: n8 tiles of V columns per block. BT: rhos per block. MT: m16 tiles
// (16 rows) per warp; a block has 8 / MT warps. X3: 'bf16x3' (else 'bf16').
// grid.x: row blocks; grid.y: rho group * column chunks + column chunk.
template <int NU, int NT, int BT, int MT, bool X3>
__global__ void __launch_bounds__(kRows / (16 * MT) * 32, 2 * MT)
    multirho_mma_kernel(const float* __restrict__ pts,
                        const float* __restrict__ inv_rho,
                        const float* __restrict__ V, float* __restrict__ out,
                        int n, int d, int B, int r) {
  constexpr int kRC = NT * 8;
  constexpr int kWarpRows = 16 * MT;
  constexpr int kThreads = kRows / kWarpRows * 32;
  __shared__ float s_rows[kMaxD][kRows];
  __shared__ __align__(8) float s_cols[kMaxD][kCols];
  __shared__ __align__(16) uint16_t s_vhi[BT][kRC][kLdV];
  __shared__ __align__(16)
      uint16_t s_vlo[X3 ? BT : 1][X3 ? kRC : 1][X3 ? kLdV : 2];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in group: the fragment's column pair
  const int wrow = (threadIdx.x >> 5) * kWarpRows;  // warp's first row
  const int row0 = blockIdx.x * kRows;
  const int chunks = (r + kRC - 1) / kRC;
  const int b0 = (blockIdx.y / chunks) * BT;
  const int c0 = (blockIdx.y % chunks) * kRC;

  // the block's row points, dimension-major; rows past n are zeros
  for (int e = threadIdx.x; e < d * kRows; e += kThreads) {
    const int k = e / kRows;
    const int i = e % kRows;
    s_rows[k][i] =
        row0 + i < n ? pts[static_cast<int64_t>(row0 + i) * d + k] : 0.0f;
  }
  float w[BT];  // what rho_t contributes to the closed form
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    w[t] = rho_weight<NU>(b0 + t < B ? inv_rho[b0 + t] : 0.0f);
  }

  // acc[rho][m16 tile * NT + n8 tile][fragment element]: the running sums
  float acc[BT][MT * NT][4];
#pragma unroll
  for (int t = 0; t < BT; ++t) {
#pragma unroll
    for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][q][i] = 0.0f;
    }
  }

  for (int j0 = 0; j0 < n; j0 += kCols) {
    const int tc = min(kCols, n - j0);
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < d * kCols; e += kThreads) {
      const int k = e / kCols;
      const int j = e % kCols;
      s_cols[k][j] =
          j < tc ? pts[static_cast<int64_t>(j0 + j) * d + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < BT * kCols * kRC; e += kThreads) {
      const int c = e % kRC;
      const int j = (e / kRC) % kCols;
      const int t = e / (kRC * kCols);
      const float v =
          (j < tc && c0 + c < r && b0 + t < B)
              ? V[(static_cast<int64_t>(b0 + t) * n + j0 + j) * r + c0 + c]
              : 0.0f;
      stage_split<X3>(v, s_vhi[t][c][j],
                      s_vlo[X3 ? t : 0][X3 ? c : 0][X3 ? j : 0]);
    }
    __syncthreads();

    // this tile's products, in fresh accumulators
    float part[BT][MT * NT][4];
#pragma unroll
    for (int t = 0; t < BT; ++t) {
#pragma unroll
      for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[t][q][i] = 0.0f;
      }
    }

    for (int kk = 0; kk < tc; kk += kStep) {
      // the thread's 2 MT rows (m16 tile mt, half h: row wrow + 16 mt + 8 h
      // + g) x 4 columns (kk + 2 tig, + 1, + 8, + 9): the unscaled
      // distances, once for every rho of the block
      float r0[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 4; ++c) r0[mt][h][c] = 0.0f;
        }
      }
      for (int k = 0; k < d; ++k) {
        const float2 ya =
            *reinterpret_cast<const float2*>(&s_cols[k][kk + 2 * tig]);
        const float2 yb =
            *reinterpret_cast<const float2*>(&s_cols[k][kk + 8 + 2 * tig]);
        const float y[4] = {ya.x, ya.y, yb.x, yb.y};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = s_rows[k][wrow + 16 * mt + 8 * h + g];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float diff = x - y[c];
              r0[mt][h][c] = fmaf(diff, diff, r0[mt][h][c]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            r0[mt][h][c] = sqrt_approx(r0[mt][h][c]);
          }
        }
      }

#pragma unroll
      for (int t = 0; t < BT; ++t) {
        if (b0 + t < B) {  // the same for every thread of the block
          // k(rho_t), rounded, into the A fragments
          uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float kv[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                kv[c] = matern_approx<NU>(r0[mt][h][c], w[t]);
              }
              pack_pair<X3>(kv[0], kv[1], a_hi[mt][h], a_lo[mt][h]);
              pack_pair<X3>(kv[2], kv[3], a_hi[mt][2 + h], a_lo[mt][2 + h]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const BFragment b =
                load_b<X3>(s_vhi[t][nt * 8 + g],
                           s_vlo[X3 ? t : 0][X3 ? nt * 8 + g : 0], kk, tig);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_tile_dot<X3>(part[t][mt * NT + nt], a_hi[mt], a_lo[mt], b);
            }
          }
        }
      }
    }

#pragma unroll
    for (int t = 0; t < BT; ++t) {
#pragma unroll
      for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][q][i] += part[t][q][i];
      }
    }
  }

  // fragment element i: row g (+ 8 for i >= 2), column 2 tig + (i & 1)
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    if (b0 + t >= B) continue;
#pragma unroll
    for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + wrow + 16 * (q / NT) + 8 * (i >> 1) + g;
        const int col = c0 + (q % NT) * 8 + 2 * tig + (i & 1);
        if (row < n && col < r) {
          out[(static_cast<int64_t>(b0 + t) * n + row) * r + col] =
              acc[t][q][i];
        }
      }
    }
  }
}

struct Args {
  const float* pts;
  const float* inv_rho;
  const float* V;
  float* out;
  int n, d, B, r;
  cudaStream_t stream;
};

template <int NU, int NT, int BT, int MT, bool X3>
cudaError_t launch(const Args& a) {
  constexpr int kThreads = kRows / (16 * MT) * 32;
  const int chunks = (a.r + NT * 8 - 1) / (NT * 8);
  const int64_t grid_y = static_cast<int64_t>((a.B + BT - 1) / BT) * chunks;
  if (grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.n + kRows - 1) / kRows, static_cast<unsigned>(grid_y));
  multirho_mma_kernel<NU, NT, BT, MT, X3><<<grid, kThreads, 0, a.stream>>>(
      a.pts, a.inv_rho, a.V, a.out, a.n, a.d, a.B, a.r);
  return cudaGetLastError();
}

template <int NU, bool X3>
cudaError_t launch_nt(const Args& a) {
  // <NT, BT, MT>: BT * MT * NT = 8 or 6 sets of sums (see the header)
  if (a.r <= 8) return launch<NU, 1, 4, 2, X3>(a);
  if (a.r > 16 && a.r <= 24) return launch<NU, 3, 2, 1, X3>(a);
  return launch<NU, kChunkNT, 2, 2, X3>(a);
}

template <int NU>
cudaError_t launch_mode(const Args& a, int dot_code) {
  return dot_code == kDotBf16x3 ? launch_nt<NU, true>(a)
                                : launch_nt<NU, false>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `inv_rho` holds B float32 values
// 1/rho_b; `dot_code` is kDotBf16x3 or kDotBf16; r >= 1.
extern "C" int gppe_matern_multirho_mma(const void* pts, const void* inv_rho,
                                        const void* V, void* out, int n,
                                        int d, int B, int r, int nu_code,
                                        int dot_code, void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || B <= 0 || r < 1 ||
      (dot_code != kDotBf16x3 && dot_code != kDotBf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(inv_rho),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               n,
               d,
               B,
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
