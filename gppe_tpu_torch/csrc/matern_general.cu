// The general-nu Matern correlation on Hopper (sm_90a): three entries over
// one device function, matern_general (matern_bessel.cuh):
//
//   (a) elementwise: out[i] = k(x[i]; nu) over a buffer of scaled
//       distances, the assembly of a dense K;
//   (b) product: out = K @ V, K[i, j] = k(|x_i - y_j|; nu) of the row and
//       column points already divided by the correlation scale (the Python
//       wrapper does that), K never stored, exact float32 FMA sums;
//   (c) trace: partials[b] = weight * sum K[i, j]^2 over block b's tile
//       pairs of the symmetric walk of matern_trace.cuh, float64 partials
//       that the caller sums to trace(K^2).
//
// Replaces no Pallas kernel: the TPU has none for general nu. It ran
// XLA-fused there, at the call sites gppe_tpu/ops/assembly.py:22 (dense
// assembly), gppe_tpu/ops/operators.py:22 and :42 (the row-blocked K @ V and
// trace(K^2) of MaternOperator for nu outside the closed forms) and
// gppe_tpu/models/grid_krylov.py:128-141 (the general branch of the
// matrix-free grid chunk). XLA fuses the whole Bessel loop of
// gppe_tpu/ops/special.py into one program, which keeps the per-pair work in
// registers; eager PyTorch would run each of its ~2,000 elementwise steps as
// one pass over a (block x n) tensor. This source is that fused loop.
//
// What bounds it on this card. One k costs the branch its argument takes:
// below z = 2 Temme's series (a logf, an expf pair or a sinhf, then ~12 FP32
// operations per term), from 2 up CF2 (one real division and ~14 FP32
// operations per step), then ~2 operations per upward step: hundreds of
// FP32 operations and a few MUFU operations per pair, against d + 2r for
// the distance and the product and 2 for k^2. Device memory moves O(n (d +
// r)) words against O(n^2) such k: the kernels are bound by FP32 issue,
// never by HBM, and the tensor cores would bring nothing.
//
// What the design does about it:
//   * each pair's k is computed once and serves all r columns of V from
//     registers (the product) or its square (the trace);
//   * nu is a per-launch constant: everything that depends on nu alone is
//     computed once on the host in float64 and passed by value, so a pair
//     only runs its branch's loop and the recurrence, and leaves the loop
//     when its own series has converged;
//   * the product: a block holds 32 rows (one per lane) and 8 warps that
//     take every 8th column, each thread one row's r sums; the warps' sums
//     are added in a fixed order through shared memory, and where the rows
//     alone do not fill the card, grid.y splits the columns into slices
//     whose float32 partial products the wrapper sums: the same bits run to
//     run. Widths above 32 run as launches of 32 columns;
//   * the trace: the symmetric walk of matern_trace.cuh (tile pairs tj >= ti
//     of 128 x 128 points, weight 2 off the diagonal; K is symmetric bit for
//     bit in the difference form), each of 256 threads one row and half the
//     tile's columns, float64 block partials, no atomics.
// The pairs of a warp can take different branches and different trip
// counts: the warp runs the longest. Sorting pairs by argument is a later
// lever, not taken here.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_bessel.cuh"
#include "matern_common.cuh"
#include "matern_trace.cuh"

using namespace gppe;

namespace {

constexpr int kElemThreads = 256;
constexpr int kProductWarps = 8;
constexpr int kProductThreads = 32 * kProductWarps;
constexpr int kProductMaxCols = 32;  // widest instance; wider V in slices
constexpr int kTraceThreads = 256;
constexpr int kTraceWarps = kTraceThreads / 32;
constexpr int kTraceHalves = kTraceThreads / kTraceTile;  // column halves

__global__ void __launch_bounds__(kElemThreads)
    matern_general_elementwise_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, int64_t n,
                                      const MaternGeneralConsts c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kElemThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kElemThreads +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = matern_general(x[i], c);
  }
}

__device__ __forceinline__ float squared_distance(const float (&x)[kMaxD],
                                                  const float* y, int d) {
  float d2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    if (k < d) {
      const float diff = x[k] - __ldg(y + k);
      d2 = fmaf(diff, diff, d2);
    }
  }
  return d2;
}

// RC: accumulators per thread, the instance's widest r. Block (bx, by)
// takes rows 32 bx .. 32 bx + 31 and the by-th of gridDim.y slices of the
// columns, and writes its partial product to out + by * slice_stride.
template <int RC>
__global__ void __launch_bounds__(kProductThreads)
    matern_general_product_kernel(const float* __restrict__ rows,
                                  const float* __restrict__ cols,
                                  const float* __restrict__ V,
                                  float* __restrict__ out, int nr, int nc,
                                  int d, int r, int ldv, int ldo,
                                  int64_t slice_stride,
                                  const MaternGeneralConsts c) {
  __shared__ float s_acc[kProductWarps][RC][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * 32 + lane;
  const bool live = row < nr;
  float x[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    x[k] = (live && k < d) ? rows[static_cast<int64_t>(row) * d + k] : 0.0f;
  }
  float acc[RC];
#pragma unroll
  for (int q = 0; q < RC; ++q) acc[q] = 0.0f;

  const int per_slice = (nc + gridDim.y - 1) / gridDim.y;
  const int j0 = blockIdx.y * per_slice;
  const int j1 = min(nc, j0 + per_slice);
  for (int j = j0 + warp; j < j1; j += kProductWarps) {
    const float d2 =
        squared_distance(x, cols + static_cast<int64_t>(j) * d, d);
    const float kv = matern_general(sqrtf(d2), c);
    const float* v = V + static_cast<int64_t>(j) * ldv;
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      if (q < r) acc[q] = fmaf(kv, __ldg(v + q), acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < RC; ++q) s_acc[warp][q][lane] = acc[q];
  __syncthreads();
  float* dst = out + blockIdx.y * slice_stride;
  for (int e = threadIdx.x; e < RC * 32; e += kProductThreads) {
    const int q = e >> 5;
    const int l = e & 31;
    const int orow = blockIdx.x * 32 + l;
    if (q < r && orow < nr) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kProductWarps; ++w) sum += s_acc[w][q][l];
      dst[static_cast<int64_t>(orow) * ldo + q] = sum;
    }
  }
}

__global__ void __launch_bounds__(kTraceThreads)
    matern_general_trace_kernel(const float* __restrict__ rows,
                                const float* __restrict__ cols,
                                double* __restrict__ partials, int nr,
                                int nc, int d, int tiles_r, int tiles_c,
                                int64_t pairs, int per_block, bool symmetric,
                                const MaternGeneralConsts c) {
  __shared__ float s_pts[kTraceTile][kMaxD];
  __shared__ double s_warp[kTraceWarps];
  const int lrow = threadIdx.x % kTraceTile;
  const int half = threadIdx.x / kTraceTile;
  constexpr int kCols = kTraceTile / kTraceHalves;

  double acc = 0.0;
  const int64_t p_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t p_end =
      p_begin + per_block < pairs ? p_begin + per_block : pairs;
  for (int64_t p = p_begin; p < p_end; ++p) {
    const TilePair tp = trace_tile_pair(p, tiles_r, tiles_c, symmetric);
    const int j0 = tp.tj * kTraceTile;
    const int tc = min(kTraceTile, nc - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTraceTile * kMaxD; e += kTraceThreads) {
      const int j = e / kMaxD;
      const int k = e % kMaxD;
      s_pts[j][k] = (j < tc && k < d)
                        ? cols[static_cast<int64_t>(j0 + j) * d + k]
                        : 0.0f;
    }
    const int row = tp.ti * kTraceTile + lrow;
    const bool live = row < nr;
    float x[kMaxD];
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      x[k] = (live && k < d) ? rows[static_cast<int64_t>(row) * d + k]
                             : 0.0f;
    }
    __syncthreads();
    float part = 0.0f;
    const int jb = half * kCols;
    const int je = min(tc, jb + kCols);
    for (int j = jb; j < je; ++j) {
      float d2 = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) {
        if (k < d) {
          const float diff = x[k] - s_pts[j][k];
          d2 = fmaf(diff, diff, d2);
        }
      }
      const float kv = matern_general(sqrtf(d2), c);
      part = fmaf(kv, kv, part);
    }
    if (live) acc += tp.weight * static_cast<double>(part);
  }
  const double total = block_sum<kTraceWarps>(acc, s_warp);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <int RC>
cudaError_t launch_product(const float* rows, const float* cols,
                           const float* V, float* out, int nr, int nc, int d,
                           int r, int ldv, int ldo, int slices,
                           int64_t slice_stride,
                           const MaternGeneralConsts& c,
                           cudaStream_t stream) {
  const dim3 grid((nr + 31) / 32, slices);
  matern_general_product_kernel<RC><<<grid, kProductThreads, 0, stream>>>(
      rows, cols, V, out, nr, nc, d, r, ldv, ldo, slice_stride, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gppe_matern_general_consts_bytes() {
  return static_cast<int>(sizeof(MaternGeneralConsts));
}

// (a) out[i] = k(x[i]; nu) for i < n. `consts` is a host pointer to the
// per-launch constants (gppe_matern_general_consts_bytes bytes). Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise and allocates nothing.
extern "C" int gppe_matern_general_elementwise(const void* x, void* out,
                                               int64_t n, const void* consts,
                                               void* stream) {
  const MaternGeneralConsts c = *static_cast<const MaternGeneralConsts*>(
      consts);
  if (n <= 0 || x == nullptr || out == nullptr || !consts_ok(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks64 = (n + kElemThreads - 1) / kElemThreads;
  const int blocks = static_cast<int>(blocks64 < 132 * 32 ? blocks64
                                                          : 132 * 32);
  matern_general_elementwise_kernel<<<blocks, kElemThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, c);
  return static_cast<int>(cudaGetLastError());
}

// (b) out[s] = the s-th column slice's share of K @ V[:, :r] for
// s < slices, each an (nr, ldo) float32 block at out + s * nr * ldo (with
// slices = 1, out itself); the caller sums the slices. rows (nr, d), cols
// (nc, d) scaled points; V rows of stride ldv, r <= 32 columns.
extern "C" int gppe_matern_general_product(const void* rows,
                                           const void* cols, const void* V,
                                           void* out, int nr, int nc, int d,
                                           int r, int ldv, int ldo,
                                           int slices, const void* consts,
                                           void* stream) {
  const MaternGeneralConsts c = *static_cast<const MaternGeneralConsts*>(
      consts);
  if (nr <= 0 || nc <= 0 || d < 1 || d > kMaxD || r < 1 ||
      r > kProductMaxCols || ldv < r || ldo < r || slices < 1 ||
      slices > 65535 || !consts_ok(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p_rows = static_cast<const float*>(rows);
  const float* p_cols = static_cast<const float*>(cols);
  const float* p_v = static_cast<const float*>(V);
  float* p_out = static_cast<float*>(out);
  const int64_t stride = static_cast<int64_t>(nr) * ldo;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r <= 8) {
    err = launch_product<8>(p_rows, p_cols, p_v, p_out, nr, nc, d, r, ldv,
                            ldo, slices, stride, c, s);
  } else if (r <= 16) {
    err = launch_product<16>(p_rows, p_cols, p_v, p_out, nr, nc, d, r, ldv,
                             ldo, slices, stride, c, s);
  } else {
    err = launch_product<32>(p_rows, p_cols, p_v, p_out, nr, nc, d, r, ldv,
                             ldo, slices, stride, c, s);
  }
  return static_cast<int>(err);
}

// (c) partials[b] = block b's weighted sum of k^2 over `per_block` tile
// pairs of the walk (matern_trace.cuh); `symmetric` (rows are cols, nr ==
// nc) walks tj >= ti. The blocks must cover the walk's pairs exactly
// (cuda_kernels.trace_schedule).
extern "C" int gppe_matern_general_trace(const void* rows, const void* cols,
                                         void* partials, int nr, int nc,
                                         int d, int symmetric, int per_block,
                                         int blocks, const void* consts,
                                         void* stream) {
  const MaternGeneralConsts c = *static_cast<const MaternGeneralConsts*>(
      consts);
  if (nr <= 0 || nc <= 0 || d < 1 || d > kMaxD || partials == nullptr ||
      (symmetric && nr != nc) || !consts_ok(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_r = (nr + kTraceTile - 1) / kTraceTile;
  const int tiles_c = (nc + kTraceTile - 1) / kTraceTile;
  const int64_t pairs = trace_pairs(tiles_r, tiles_c, symmetric != 0);
  if (!trace_grid_ok(pairs, per_block, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  matern_general_trace_kernel<<<blocks, kTraceThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cols),
      static_cast<double*>(partials), nr, nc, d, tiles_r, tiles_c, pairs,
      per_block, symmetric != 0, c);
  return static_cast<int>(cudaGetLastError());
}
