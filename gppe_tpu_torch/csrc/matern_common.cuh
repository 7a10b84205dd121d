// Shared by the package's CUDA kernels: the nu codes, the closed-form
// Matern correlation in IEEE float32 (no --use_fast_math: sqrtf is correctly
// rounded and expf is the full-accuracy routine), and the tile-dot mode
// codes.
// matern_mma.cuh's matern_exact_d2 is matern_from_d2 without the branch
// around sqrtf, and its sqrt_rn_nonneg the same bits as sqrtf: the
// 'highest' products and the trace(K^2) passes see the same k.
#pragma once

namespace gppe {

constexpr int kMaxD = 8;  // largest point dimension

// nu codes, shared with gppe_tpu_torch/ops/cuda_kernels.py::_NU_CODES
constexpr int kNuHalf = 0;       // nu = 1/2
constexpr int kNuThreeHalf = 1;  // nu = 3/2
constexpr int kNuFiveHalf = 2;   // nu = 5/2
constexpr int kNuGauss = 3;      // nu >= 100, the Gaussian limit

// tile-dot mode codes, shared with ops/cuda_kernels.py::_DOT_CODES: the
// precision of the K-tile times V product, after
// gppe_tpu/ops/pallas_kernels.py::_tile_dot. The three product kernels
// (matern_matmat_mma.cu, matern_multirho_mma.cu, matern_blocksparse_mma.cu)
// run all three modes on the tensor cores (matern_mma.cuh), 'highest' as
// 3xTF32
constexpr int kDotHighest = 0;  // tf32 high + residual parts, lo*lo dropped
constexpr int kDotBf16x3 = 1;   // bf16 high + residual parts, lo*lo dropped
constexpr int kDotBf16 = 2;     // both operands rounded to bf16

// k_nu from the squared scaled distance (the points were divided by the
// correlation scale beforehand).
template <int NU>
__device__ __forceinline__ float matern_from_d2(float d2) {
  if constexpr (NU == kNuHalf) {
    return expf(-sqrtf(d2));
  } else if constexpr (NU == kNuThreeHalf) {
    const float s = sqrtf(3.0f * d2);
    return (1.0f + s) * expf(-s);
  } else if constexpr (NU == kNuFiveHalf) {
    const float s = sqrtf(5.0f * d2);
    return (1.0f + s + d2 * (5.0f / 3.0f)) * expf(-s);
  } else {
    return expf(-0.5f * d2);
  }
}

// k_nu from the scaled distance x = |x_i - x_j| / rho itself: the form of
// the multi-rho kernel, where one sqrt serves every rho of the batch.
template <int NU>
__device__ __forceinline__ float matern_from_r(float x) {
  if constexpr (NU == kNuHalf) {
    return expf(-x);
  } else if constexpr (NU == kNuThreeHalf) {
    const float s = 1.7320508075688772f * x;
    return (1.0f + s) * expf(-s);
  } else if constexpr (NU == kNuFiveHalf) {
    const float s = 2.23606797749979f * x;
    return (1.0f + s + s * s * (1.0f / 3.0f)) * expf(-s);
  } else {
    return expf(-0.5f * x * x);
  }
}

}  // namespace gppe
