// The general-nu Matern correlation of one scaled distance, in registers:
//
//     k(x; nu) = 2^{1-nu} / Gamma(nu) (sqrt(2 nu) x)^nu K_nu(sqrt(2 nu) x),
//
// for the kernels of matern_general.cu. The algorithm is the reference's
// Bessel K_nu (gppe_tpu/ops/special.py, the counterpart of NR's bessik):
// the order reduced to mu = nu - round(nu) in [-1/2, 1/2]; below z = 2
// Temme's series for K_mu and K_{mu+1} (at most 30 terms), from 2 up
// Steed's continued fraction CF2, e^z-scaled (at most 59 steps); then
// round(nu) upward steps. Each lane leaves its loop when both of its series
// have converged (the reference's freeze test), so a pair pays only for the
// branch and the terms its argument needs.
//
// In float32, as the reference computes on its accelerator, but the
// recurrence does not run on K: it runs on the normalized values
//
//     f_v = 2^{1-v} / Gamma(v) z^v K_v(z),   v = mu + j,
//
// which the recurrence K_{v+1} = 2v/z K_v + K_{v-1} turns into
//
//     f_{v+1} = f_v + z^2 / (4 v (v - 1)) f_{v-1},
//
// and f_nu is k itself. Every f_v is a Matern correlation, so it lies in
// (0, 1] (below z = 2) or, e^z-scaled, grows at most like z^{v-1/2}: no
// log-scale bookkeeping is needed. The reference's log form sums two logs
// of ~nu |log z| that cancel to log k, an error of ~1e-5 at nu ~ 25 in
// float32 (gppe_tpu/ops/kernels.py:23-37); here nothing cancels. The first
// step, from K_mu, is f_{mu+2} = f_{mu+1} + 2^{-mu} z^{mu+2} K_mu /
// (2 Gamma(mu + 2)), which holds at mu = 0 as well.
//
// Everything that depends on nu alone is a per-launch constant, computed on
// the host in float64 (ops/cuda_kernels.py::_general_consts): mu, round(nu),
// sqrt(2 nu), Temme's gam1, gam2 and Gamma(1 +- mu), the normalisations,
// the reciprocals of Temme's and CF2's divisors (which depend on the term
// index and mu only) and the recurrence's weights. Per pair that leaves
// one logf and one expf for z^mu, Temme's expf pair and sinhf or CF2's one
// real division per step and one sqrtf, and the FMAs.
//
// Built WITHOUT --use_fast_math: sqrtf, expf, logf and the divisions are
// the IEEE versions.
#pragma once

#include "matern_common.cuh"

namespace gppe {

constexpr int kNuGeneral = 4;      // the mode of a general nu
constexpr int kTemmeTerms = 30;    // Temme's series: terms 1..30
constexpr int kCf2Steps = 59;      // CF2: steps i = 2..60
constexpr int kMaxOrder = 128;     // round(nu) <= kMaxOrder
constexpr float kFloatEps = 1.1920929e-07f;  // FLT_EPSILON, the freeze test
constexpr float kPi = 3.14159265358979f;
constexpr float kLn2 = 0.693147180559945f;
constexpr float kLog2e = 1.44269504088896f;

// Per-launch constants; the layout is ops/cuda_kernels.py::_general_consts
// (two int32, then float32), checked by gppe_matern_general_consts_bytes.
struct MaternGeneralConsts {
  int mode;  // kNuHalf, kNuThreeHalf, kNuFiveHalf, kNuGauss or kNuGeneral
  int nl;    // round(nu): the upward steps
  float sqrt2nu, mu, a1;          // a1 = 1/4 - mu^2, CF2's first numerator
  float fact, gam1, gam2;         // pi mu / sin(pi mu), Temme's gam1, gam2
  float p0, q0;                   // Gamma(1 + mu) / 2, Gamma(1 - mu) / 2
  float c_nl0;                    // 2^{1-mu} / Gamma(mu), for nl = 0
  float c1;                       // 2^{-mu} / Gamma(mu + 1)
  float c0;                       // 2^{-mu} / (2 Gamma(mu + 2))
  float t_inv[kTemmeTerms];       // 1 / (i^2 - mu^2)
  float t_imu[kTemmeTerms];       // 1 / (i - mu)
  float t_ipmu[kTemmeTerms];      // 1 / (i + mu)
  float t_i[kTemmeTerms];         // 1 / i
  float cf_a[kCf2Steps];          // a_i = -a1 - i (i - 1)
  float cf_inva[kCf2Steps];       // 1 / a_i
  float cf_cfac[kCf2Steps];       // -a_i / i
  float rec_w[kMaxOrder];         // 1 / (4 v (v - 1)), v = mu + j, j >= 2
};

// The pieces below are what one k runs: the entry (z, log z, z^mu), one
// branch's setup, steps and finish, the recurrence's start and steps, the
// end. chip_profile.py sass-mix compiles each alone and counts its FP32 and
// MUFU operations, the per-pair work that chip_smoke.py's bound adds up
// over the trips each pair takes.

// Temme's series for 0 < z < 2: state before term i = 1
struct TemmeState {
  float ff, p, q, cc, s, s1, dd;
};

__device__ __forceinline__ TemmeState bessel_temme_setup(
    float z, float lz, const MaternGeneralConsts& c) {
  const float x2 = 0.5f * z;
  const float d = kLn2 - lz;  // -log(z / 2)
  const float e = c.mu * d;
  const float fact2 = e == 0.0f ? 1.0f : sinhf(e) / e;
  const float ee = expf(e);
  const float eei = expf(-e);
  const float ff =
      c.fact * (c.gam1 * (0.5f * (ee + eei)) + c.gam2 * fact2 * d);
  const float p = c.p0 * ee;
  return {ff, p, c.q0 * eei, 1.0f, ff, p, x2 * x2};
}

// term i + 1 (i = 0 .. kTemmeTerms - 1); true once both series converged
__device__ __forceinline__ bool bessel_temme_step(
    int i, TemmeState& t, const MaternGeneralConsts& c) {
  const float fi = static_cast<float>(i + 1);
  t.ff = (fi * t.ff + t.p + t.q) * c.t_inv[i];
  t.cc = t.cc * t.dd * c.t_i[i];
  t.p *= c.t_imu[i];
  t.q *= c.t_ipmu[i];
  const float dl = t.cc * t.ff;
  t.s += dl;
  const float dl1 = t.cc * (t.p - fi * t.ff);
  t.s1 += dl1;
  return fabsf(dl) < fabsf(t.s) * kFloatEps &&
         fabsf(dl1) < fabsf(t.s1) * kFloatEps;
}

// Steed's CF2 for z >= 2: state before step i = 2
struct Cf2State {
  float b, d, h, delh, q1, q2, q, cc, s;
};

__device__ __forceinline__ Cf2State bessel_cf2_setup(
    float z, const MaternGeneralConsts& c) {
  const float b = 2.0f * (1.0f + z);
  const float d = 1.0f / b;
  return {b, d, d, d, 0.0f, 1.0f, c.a1, c.a1, 1.0f + c.a1 * d};
}

// step i + 2 (i = 0 .. kCf2Steps - 1); true once the s and the h series
// converged (at mu = +-1/2 every dels is 0 while h still converges)
__device__ __forceinline__ bool bessel_cf2_step(
    int i, Cf2State& t, const MaternGeneralConsts& c) {
  t.cc *= c.cf_cfac[i];
  const float qnew = (t.q1 - t.b * t.q2) * c.cf_inva[i];
  t.q1 = t.q2;
  t.q2 = qnew;
  t.q += t.cc * qnew;
  t.b += 2.0f;
  t.d = 1.0f / (t.b + c.cf_a[i] * t.d);
  t.delh = (t.b * t.d - 1.0f) * t.delh;
  t.h += t.delh;
  const float dels = t.q * t.delh;
  t.s += dels;
  return fabsf(dels) < fabsf(t.s) * kFloatEps &&
         fabsf(t.delh) < fabsf(t.h) * kFloatEps;
}

// K_mu(z), K_{mu+1}(z) (e^z-scaled from CF2)
__device__ __forceinline__ void bessel_temme_finish(const TemmeState& t,
                                                    float z, float& kmu,
                                                    float& kmu1) {
  kmu = t.s;
  kmu1 = 2.0f * t.s1 / z;
}

__device__ __forceinline__ void bessel_cf2_finish(
    const Cf2State& t, float z, const MaternGeneralConsts& c, float& kmu,
    float& kmu1) {
  kmu = sqrtf(kPi / (2.0f * z)) / t.s;
  kmu1 = kmu * (c.mu + z + 0.5f - c.a1 * t.h) / z;
}

// the normalized recurrence's first values: f = f_{mu+1} and fp, the
// first step's addend (f_{mu+2} = f + fp); for nl = 0, f = k e^{..}
__device__ __forceinline__ void bessel_rec_start(
    float z, float zm, float kmu, float kmu1, const MaternGeneralConsts& c,
    float& f, float& fp) {
  if (c.nl == 0) {
    f = c.c_nl0 * zm * kmu;
    fp = 0.0f;
  } else {
    fp = c.c0 * (z * z) * zm * kmu;
    f = c.c1 * z * zm * kmu1;
  }
}

// f_{v+1} = f_v + z^2 / (4 v (v - 1)) f_{v-1}, v = mu + j, j >= 2,
// rescaled by 2^-64 (e2 += 64) where e^z-scaled values grow past float32
__device__ __forceinline__ void bessel_rec_step(int j, float z2,
                                                const MaternGeneralConsts& c,
                                                float& f, float& fp,
                                                int& e2) {
  const float fj = fmaf(z2 * c.rec_w[j - 2], fp, f);
  fp = f;
  f = fj;
  if (f > 0x1p64f) {
    f *= 0x1p-64f;
    fp *= 0x1p-64f;
    e2 += 64;
  }
}

// k from f_nu: as it is below z = 2; times e^{-z} (and 2^e2) above
__device__ __forceinline__ float bessel_end(float f, float z, int e2,
                                            bool small) {
  float k;
  if (small) {
    k = f;
  } else if (e2 == 0 && z < 80.0f) {
    k = f * expf(-z);
  } else {
    k = exp2f(log2f(f) + static_cast<float>(e2) - z * kLog2e);
  }
  return fminf(k, 1.0f);
}

// k(x; nu) of one scaled distance x >= 0, in [0, 1]
__device__ __forceinline__ float matern_general(float x,
                                                const MaternGeneralConsts& c) {
  if (x == 0.0f) return 1.0f;
  switch (c.mode) {  // uniform over the launch
    case kNuHalf: return matern_from_r<kNuHalf>(x);
    case kNuThreeHalf: return matern_from_r<kNuThreeHalf>(x);
    case kNuFiveHalf: return matern_from_r<kNuFiveHalf>(x);
    case kNuGauss: return matern_from_r<kNuGauss>(x);
    default: break;
  }
  const float z = fmaxf(c.sqrt2nu * x, 1e-30f);
  const float lz = logf(z);
  const float zm = expf(c.mu * lz);  // z^mu
  const bool small = z < 2.0f;
  float kmu, kmu1;
  if (small) {
    TemmeState t = bessel_temme_setup(z, lz, c);
    for (int i = 0; i < kTemmeTerms; ++i) {
      if (bessel_temme_step(i, t, c)) break;
    }
    bessel_temme_finish(t, z, kmu, kmu1);
  } else {
    Cf2State t = bessel_cf2_setup(z, c);
    for (int i = 0; i < kCf2Steps; ++i) {
      if (bessel_cf2_step(i, t, c)) break;
    }
    bessel_cf2_finish(t, z, c, kmu, kmu1);
  }
  float f, fp;
  bessel_rec_start(z, zm, kmu, kmu1, c, f, fp);
  int e2 = 0;  // f carries a factor 2^{e2} (only where z is large)
  if (c.nl >= 2) {
    const float fn = f + fp;
    fp = f;
    f = fn;
    const float z2 = z * z;
    for (int j = 2; j < c.nl; ++j) bessel_rec_step(j, z2, c, f, fp, e2);
  }
  return bessel_end(f, z, e2, small);
}

}  // namespace gppe
