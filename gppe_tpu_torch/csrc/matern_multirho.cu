// Fused multi-rho Matern correlation matmat for Hopper (sm_90a):
//
//     out[b] = K(rho_b) @ V[b],   K(rho)[i, j] = k_nu(|x_i - x_j| / rho),
//
// for a batch of B isotropic correlation scales over one set of raw
// (unscaled) points x (n, d), everything float32; no K(rho_b) is ever
// stored. Optionally each (b, row) also writes sum_j K(rho_b)[i, j]^2 in
// float64, so one launch with r = 0 gives trace(K(rho_b)^2) for the batch.
//
// Replaces gppe_tpu/ops/pallas_kernels.py::_multirho_kernel, the engine of
// the grid-batched Krylov factorization (models/grid_krylov.py). It keeps
// that kernel's arithmetic order: d^2 by differences on the raw points, one
// sqrtf, then per rho one multiply by 1/rho_b (rounded to float32 by the
// caller) and the closed form from the distance (matern_from_r). That
// differs in the last bits from matern_matmat.cu, which scales the points
// first.
//
// V and out are (B, n, r) row-major. The batched Lanczos of the grid path
// keeps its block as (B, r, n), so that path transposes 51 MB each way per
// step at n = 10^5, B * r = 128. A variant of this kernel that read and
// wrote the (B, r, n) layout itself, through a transposing shared-memory
// store, took 204 ms per launch against 162 ms for this one (NVIDIA H100
// 80GB HBM3, 700 W); the two copies cost well under a millisecond, so the
// copies stay and the variant went.
//
// What bounds it on this card. Per pair: d subtract/FMAs and one sqrtf,
// shared by the rhos a thread holds; per rho one multiply, one expf and r
// FMAs. Device-memory traffic is O(B n r) words against O(B n^2 (r + ~10))
// instructions, so it is bound by instruction issue (FP32 FMA and the SFU's
// fix-up code), never by HBM.
//
// What the design does about it:
//   * as in matern_matmat.cu, one thread per output row, kRows = 128 rows
//     per block, the columns walked in shared-memory tiles of kCols = 128
//     points, ragged edges masked (nothing to subtract from the traces);
//   * the rho batch is split over the grid: a block owns BT = 2 rhos, so a
//     thread holds 2 x RC <= 32 running sums (all B * r = 128 of the grid
//     path would not fit the register file). The price is that a pair's
//     distance and sqrt are computed once per rho group, B / 2 times per
//     launch instead of once; they are ~14 of the ~70 instructions a thread
//     issues per pair at r = 16, so the whole launch issues about 1.18
//     times what a once-per-pair design would;
//   * a trace-only launch (r = 0) holds no sums, so there a thread takes 8
//     rhos and the distance is shared eight ways;
//   * V columns are taken RC = 8 or 16 at a time; wider V is split into
//     16-column chunks over grid.y (r = 24 pays for 32);
//   * a column tile's products are summed in float32, as in
//     matern_matmat.cu, and the tile sums are added with Kahan
//     compensation: at the grid path's largest rho K is nearly dense, the
//     sums reach a few hundred, and a plain float32 sum of n / 128 = 782
//     tile sums carried 5.0e-4 of absolute error at n = 10^5, at the 5e-4
//     bound. The compensation terms live in shared memory, one slot per
//     thread and sum, touched once per 128 columns: held in registers (or
//     as float64 sums) they cost 40% of the kernel's speed;
//   * the tile-dot modes of ::_tile_dot (MODE; 'bf16x3' and 'bf16') round k
//     per pair and V as its tile is staged, and sum the one or three
//     products by the same float32 FMAs into the same sums (round_k,
//     stage_v, tile_fma in matern_common.cuh): what the TPU kernel computes
//     with bf16 operands and float32 sums, in this kernel's ownership and
//     summation design. That adds instructions and saves none, so these
//     modes are slower than 'highest' here; moving the products onto the
//     tensor cores is a redesign of this kernel. They exist for any d only
//     and carry no trace output (the traces always sum the unrounded k^2;
//     the wrapper takes them from a trace-only launch);
//   * __launch_bounds__(128, 4) holds the main instance to 128 registers
//     (4 blocks per SM; left alone the compiler took 167 and fit 3), which
//     took a launch at the grid path's shape from 162 ms to 148 ms.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;  // output rows per block, one per thread
constexpr int kCols = 128;  // column points per shared-memory tile
constexpr int kBT = 2;      // rhos per thread in a launch with V
constexpr int kBTFro = 8;   // rhos per thread in a trace-only launch
constexpr int kMaxRC = 16;  // V columns per block; wider V uses grid.y

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded coordinates).
// BT: rhos per thread. RC: V columns per block; 0 for a trace-only launch.
// FRO: also write the float64 k^2 row sums (column chunk 0 only).
// MODE: the tile-dot mode (kDotHighest, kDotBf16x3, kDotBf16).
// grid.x: row blocks; grid.y: rho group * column chunks + column chunk.
template <int NU, int D, int BT, int RC, bool FRO, int MODE>
__global__ void __launch_bounds__(kRows, 4)
    multirho_kernel(const float* __restrict__ pts,
                    const float* __restrict__ inv_rho,
                    const float* __restrict__ V, float* __restrict__ out,
                    double* __restrict__ fro_rows, int n, int d, int B,
                    int r) {
  constexpr int kD = D > 0 ? D : kMaxD;
  constexpr int kRC = RC > 0 ? RC : 1;
  constexpr int kVT = RC > 0 ? BT : 1;        // s_v is unused when RC == 0
  constexpr int kVCols = RC > 0 ? kCols : 1;
  __shared__ float s_pts[kD][kCols];
  __shared__ __align__(16) float s_v[kVT][kVCols][kRC];
  __shared__ float s_comp[kVT * kRC][kRows];  // Kahan terms of acc

  const int dim = D > 0 ? D : d;
  const int chunks = RC > 0 ? (r + RC - 1) / RC : 1;
  const int b0 = (blockIdx.y / chunks) * BT;
  const int c0 = (blockIdx.y % chunks) * RC;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;

  float x[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    x[k] = (live && k < dim) ? pts[static_cast<int64_t>(row) * dim + k] : 0.0f;
  }
  // a rho past the end of the batch runs with 1/rho = 0 (k = 1) against
  // zero V rows and writes nothing
  float inv[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) inv[t] = b0 + t < B ? inv_rho[b0 + t] : 0.0f;

  float acc[BT][kRC];
  double fro[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    fro[t] = 0.0;
#pragma unroll
    for (int c = 0; c < kRC; ++c) acc[t][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      s_comp[t * kRC + c][threadIdx.x] = 0.0f;  // this thread's slots only
    }
  }

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
    if constexpr (RC > 0) {
      for (int e = threadIdx.x; e < BT * kCols * RC; e += kRows) {
        const int c = e % RC;
        const int j = (e / RC) % kCols;
        const int t = e / (RC * kCols);
        s_v[t][j][c] =
            (j < tc && c0 + c < r && b0 + t < B)
                ? stage_v<MODE>(V[(static_cast<int64_t>(b0 + t) * n + j0 + j) *
                                      r +
                                  c0 + c])
                : 0.0f;
      }
    }
    __syncthreads();

    // two-level sum: this tile's terms into `part`, then `part` into the
    // running `acc` with Kahan compensation (see the header)
    float part[BT][kRC];
    float fro_tile[BT];
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      fro_tile[t] = 0.0f;
#pragma unroll
      for (int c = 0; c < kRC; ++c) part[t][c] = 0.0f;
    }
    for (int j = 0; j < tc; ++j) {
      float d2 = 0.0f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float diff = x[k] - s_pts[k][j];
        d2 = fmaf(diff, diff, d2);
      }
      const float r0 = sqrtf(d2);
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        const float kv = matern_from_r<NU>(r0 * inv[t]);
        if constexpr (FRO) fro_tile[t] = fmaf(kv, kv, fro_tile[t]);
        float k_hi, k_lo;
        round_k<MODE>(kv, k_hi, k_lo);
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          part[t][c] = tile_fma<MODE>(k_hi, k_lo, s_v[t][j][c], part[t][c]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < BT; ++t) {
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float y = part[t][c] - s_comp[t * kRC + c][threadIdx.x];
        const float sum = acc[t][c] + y;
        s_comp[t * kRC + c][threadIdx.x] = (sum - acc[t][c]) - y;
        acc[t][c] = sum;
      }
      if constexpr (FRO) fro[t] += static_cast<double>(fro_tile[t]);
    }
  }

  if (!live) return;
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    const int b = b0 + t;
    if (b >= B) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c0 + c < r) {
        out[(static_cast<int64_t>(b) * n + row) * r + c0 + c] = acc[t][c];
      }
    }
    if constexpr (FRO) {
      if (c0 == 0) fro_rows[static_cast<int64_t>(b) * n + row] = fro[t];
    }
  }
}

struct Args {
  const float* pts;
  const float* inv_rho;
  const float* V;
  float* out;
  double* fro_rows;
  int n, d, B, r, dot_code;
  cudaStream_t stream;
};

template <int NU, int D, int BT, int RC, bool FRO, int MODE>
cudaError_t launch(const Args& a) {
  int chunks = 1;
  if constexpr (RC > 0) chunks = (a.r + RC - 1) / RC;
  const int64_t grid_y = static_cast<int64_t>((a.B + BT - 1) / BT) * chunks;
  if (grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.n + kRows - 1) / kRows, static_cast<unsigned>(grid_y));
  multirho_kernel<NU, D, BT, RC, FRO, MODE><<<grid, kRows, 0, a.stream>>>(
      a.pts, a.inv_rho, a.V, a.out, a.fro_rows, a.n, a.d, a.B, a.r);
  return cudaGetLastError();
}

template <int NU, int D, int RC>
cudaError_t launch_fro(const Args& a) {
  return a.fro_rows != nullptr ? launch<NU, D, kBT, RC, true, kDotHighest>(a)
                               : launch<NU, D, kBT, RC, false, kDotHighest>(a);
}

template <int NU, int D>
cudaError_t launch_rc(const Args& a) {
  if (a.r == 0) {
    return a.fro_rows != nullptr
               ? launch<NU, D, kBTFro, 0, true, kDotHighest>(a)
               : cudaErrorInvalidValue;
  }
  if (a.r <= 8) return launch_fro<NU, D, 8>(a);
  return launch_fro<NU, D, kMaxRC>(a);
}

// The bf16 modes: any-d instances, a product and no trace output.
template <int NU, int MODE>
cudaError_t launch_mode(const Args& a) {
  if (a.r == 0 || a.fro_rows != nullptr) return cudaErrorInvalidValue;
  if (a.r <= 8) return launch<NU, 0, kBT, 8, false, MODE>(a);
  return launch<NU, 0, kBT, kMaxRC, false, MODE>(a);
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  if (a.dot_code == kDotBf16x3) return launch_mode<NU, kDotBf16x3>(a);
  if (a.dot_code == kDotBf16) return launch_mode<NU, kDotBf16>(a);
  return a.d == 2 ? launch_rc<NU, 2>(a) : launch_rc<NU, 0>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `inv_rho` holds B float32 values
// 1/rho_b. `V` and `out` may be null when r == 0; `fro_rows` (B * n float64,
// row-major (B, n)) is null unless the k^2 row sums are wanted, and must be
// null (and r > 0) when `dot_code` is not kDotHighest.
extern "C" int gppe_matern_multirho(const void* pts, const void* inv_rho,
                                    const void* V, void* out, void* fro_rows,
                                    int n, int d, int B, int r, int nu_code,
                                    int dot_code, void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || B <= 0 || r < 0 || dot_code < 0 ||
      dot_code > kDotBf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(inv_rho),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               static_cast<double*>(fro_rows),
               n,
               d,
               B,
               r,
               dot_code,
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
