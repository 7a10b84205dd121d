// Shared by the package's CUDA kernels: the nu codes, the closed-form
// Matern correlation in IEEE float32 (no --use_fast_math: sqrtf is correctly
// rounded and expf is the full-accuracy routine), and the tile-dot modes'
// operand rounding.
#pragma once

#include <cuda_bf16.h>

namespace gppe {

constexpr int kMaxD = 8;  // largest point dimension

// nu codes, shared with gppe_tpu_torch/ops/cuda_kernels.py::_NU_CODES
constexpr int kNuHalf = 0;       // nu = 1/2
constexpr int kNuThreeHalf = 1;  // nu = 3/2
constexpr int kNuFiveHalf = 2;   // nu = 5/2
constexpr int kNuGauss = 3;      // nu >= 100, the Gaussian limit

// tile-dot mode codes, shared with ops/cuda_kernels.py::_DOT_CODES: the
// precision of the K-tile times V product, after
// gppe_tpu/ops/pallas_kernels.py::_tile_dot
constexpr int kDotHighest = 0;  // exact float32
constexpr int kDotBf16x3 = 1;   // bf16 high + residual parts, lo*lo dropped
constexpr int kDotBf16 = 2;     // both operands rounded to bf16

// x rounded to bfloat16 (round to nearest even), as a float.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bf16 high part of x and the bf16 rounding of the residual, computed
// in float32, both as floats.
__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
  hi = bf16_round(x);
  lo = bf16_round(x - hi);
}

// The FP32-FMA form of the tile dot, for kernels that keep their products
// on the CUDA cores: round_k and stage_v round the operands once (k per
// pair, v when its tile is staged in shared memory) and tile_fma sums the
// one or three products by float32 FMAs; a product of two bf16 values is
// exact in float32, so only the sums round. kDotHighest passes everything
// through unrounded: tile_fma is then the plain fmaf(k, v, acc).
template <int MODE>
__device__ __forceinline__ void round_k(float k, float& k_hi, float& k_lo) {
  k_hi = k;
  k_lo = 0.0f;
  if constexpr (MODE == kDotBf16) k_hi = bf16_round(k);
  if constexpr (MODE == kDotBf16x3) bf16_split(k, k_hi, k_lo);
}

// v as the staged word: itself, its bf16 rounding, or for kDotBf16x3 its
// high and residual parts packed into one 32-bit word (high part in the
// upper half), so the staged tile takes no more shared memory.
template <int MODE>
__device__ __forceinline__ float stage_v(float v) {
  if constexpr (MODE == kDotBf16) return bf16_round(v);
  if constexpr (MODE == kDotBf16x3) {
    float hi, lo;
    bf16_split(v, hi, lo);
    return __uint_as_float((__float_as_uint(hi) & 0xffff0000u) |
                           (__float_as_uint(lo) >> 16));
  }
  return v;
}

// acc + k * v: hi*hi, and for kDotBf16x3 + lo*hi + hi*lo (lo*lo dropped).
template <int MODE>
__device__ __forceinline__ float tile_fma(float k_hi, float k_lo,
                                          float v_staged, float acc) {
  if constexpr (MODE == kDotBf16x3) {
    const unsigned w = __float_as_uint(v_staged);
    const float v_hi = __uint_as_float(w & 0xffff0000u);
    const float v_lo = __uint_as_float(w << 16);
    acc = fmaf(k_hi, v_hi, acc);
    acc = fmaf(k_lo, v_hi, acc);
    return fmaf(k_hi, v_lo, acc);
  } else {
    return fmaf(k_hi, v_staged, acc);
  }
}

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
