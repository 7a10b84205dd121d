// Fused tapered (block-sparse) Matern trace(K^2) for Hopper (sm_90a):
//
//     partials[b] = sum over block b's units of weight * sum K_tau[i, j]^2,
//     K_tau[i, j] = k >= tau ? k : 0,  k = k_nu(|x_i - x_j|),
//
// over the sub-tile pairs of a list of active tile pairs only; the caller
// sums the float64 partials, and that sum is trace(K_tau^2). x (n_pad, d)
// are spatially sorted points already divided by the correlation scale and
// padded to a multiple of `tile`, float32. Only the first n rows and
// columns are real: sub-tiles end at min(their tile's end, n), so nothing
// of the padding reaches a sum.
//
// Replaces the XLA scan of gppe_tpu/ops/taper.py::TaperedMaternOperator
// .trace_pow. It serves every dot mode: the tile-dot modes round the
// products' operands only, and the trace always sums the unrounded k^2.
// The products K_tau @ V, the port of
// gppe_tpu/ops/pallas_kernels.py::_blocksparse_kernel in all three modes,
// are matern_blocksparse_mma.cu, whose 'highest' k (and taper) is this
// kernel's, bit for bit.
//
// The walk. A unit is one pair of sub-tiles of at most kTraceTile = 128
// points (matern_trace.cuh), named by the first row and the first column it
// covers; a tile of `tile` points holds ceil(tile / 128) sub-tiles, the
// last perhaps short. The units are a flat list the caller builds once per
// pair list on the host (ops/cuda_kernels.py::blocksparse_trace_schedule,
// the Python mirror, which also sizes the partials). The operator's list
// holds (j, i) with every (i, j), and K_tau is then symmetric bit for bit:
// the same sorted float32 points both ways, (a - b)^2 = (b - a)^2 and the
// same FMA order over d. So its walk takes only the tile pairs ti <= tj,
// and on a diagonal tile pair only the sub-tiles sj >= si: every unit whose
// rows are not its columns counts twice, and half the work is gone. A list
// without its mirror walks all its sub-tile pairs at weight 1, on this same
// kernel (`symmetric` false).
//
// What bounds it on this card: per pair d subtract/FMAs, one correctly
// rounded sqrt (MUFU.RSQ and four FP32 operations), one IEEE expf (MUFU.EX2
// and seven FP32 operations), one compare-select and one FMA for k^2,
// against O(units + n d) words of traffic that mostly hit the L2 cache -
// instruction issue, with the SFU close behind, as in matern_matmat.cu.
//
// What the design does about it (the dense traces' design,
// matern_matmat.cu):
//   * the symmetric walk above: half the pairs of the list;
//   * one unit of 128 x 128 points per block (more where the partials
//     would outgrow their cap), each block writing one float64 partial, no
//     atomics: the same bits run to run;
//   * k from matern_exact_d2 (matern_mma.cuh): the bits of sqrtf and expf
//     without the branch nvcc puts around sqrtf;
//   * each thread owns kR = 4 rows and a quarter of the unit's columns, so
//     each column point read from shared memory (a warp-wide broadcast)
//     serves 4 pairs, and 4 independent sqrt/exp chains interleave (1 or 2
//     rows time the same within 1%, but sum 64 or 128 columns per float32
//     partial, 4-9x further from float64; 256 threads are 7% slower);
//   * nu (four closed forms) and d = 2 are template parameters, other
//     d <= 8 run over zero-padded coordinates;
//   * ragged sub-tiles (a tile that is not a multiple of 128, the last
//     tile's end at n) are masked, not padded.
// Every pair of a unit is evaluated, also those beyond the taper radius.
// Precision: built WITHOUT --use_fast_math. Each thread sums the k^2 of a
// row over its at most 32 columns of the unit in float32, then in float64.
//
// The hard taper compares float32 k with float32 tau. A pair whose k lies
// within rounding of tau can fall on the other side than in float64; the
// comparisons against the plain float64 version therefore use thresholds
// that no pair comes close to (see ops/cuda_kernels.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"
#include "matern_trace.cuh"

using namespace gppe;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;  // rows per thread: lane + 32 r of its row set
constexpr int kRowSets = kTraceTile / (32 * kR);
constexpr int kColGroups = kWarps / kRowSets;
constexpr int kColsPerThread = kTraceTile / kColGroups;
static_assert(kRowSets * 32 * kR == kTraceTile && kColGroups >= 1 &&
                  kColGroups * kRowSets == kWarps,
              "the threads must tile the 128 x 128 unit exactly");

// tapered k^2 of one column point y with the thread's kR rows, added into
// their float32 sums
template <int NU, int KD>
__device__ __forceinline__ void taper_column(const float (&x)[kR][KD],
                                             const float* y_smem, float tau,
                                             float (&part)[kR]) {
  float y[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) y[k] = y_smem[k];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const float diff = x[r][k] - y[k];
      d2 = fmaf(diff, diff, d2);
    }
    float kv = matern_exact_d2<NU>(d2);
    kv = kv >= tau ? kv : 0.0f;  // the hard taper
    part[r] = fmaf(kv, kv, part[r]);
  }
}

// D: the point dimension, or 0 for any d <= kMaxD (zero-padded
// coordinates). units[u] = (first row, first column) of unit u.
template <int NU, int D>
__global__ void __launch_bounds__(kThreads)
    blocksparse_trace_kernel(const float* __restrict__ pts,
                             const int2* __restrict__ units,
                             double* __restrict__ partials, int n, int d,
                             int tile, int64_t num_units, int per_block,
                             bool symmetric, float tau) {
  constexpr int kD = D > 0 ? D : kMaxD;
  __shared__ __align__(16) float s_pts[kTraceTile][kD];
  __shared__ double s_warp[kWarps];

  const int dim = D > 0 ? D : d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp % kRowSets) * 32 * kR + lane;
  const int col0 = (warp / kRowSets) * kColsPerThread;

  double acc = 0.0;
  const int64_t u_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t u_end =
      u_begin + per_block < num_units ? u_begin + per_block : num_units;
  for (int64_t u = u_begin; u < u_end; ++u) {
    const int2 unit = units[u];
    const int rn = sub_tile_points(unit.x, tile, n);
    const int cn = sub_tile_points(unit.y, tile, n);
    __syncthreads();  // every thread is done with the previous unit
    for (int e = threadIdx.x; e < kTraceTile * kD; e += kThreads) {
      const int j = e / kD;
      const int k = e % kD;
      s_pts[j][k] = (j < cn && k < dim)
                        ? pts[static_cast<int64_t>(unit.y + j) * dim + k]
                        : 0.0f;
    }
    float x[kR][kD];
    bool live[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = row0 + 32 * r;
      live[r] = row < rn;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        x[r][k] = (live[r] && k < dim)
                      ? pts[static_cast<int64_t>(unit.x + row) * dim + k]
                      : 0.0f;
      }
    }
    __syncthreads();

    float part[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) part[r] = 0.0f;
    const int jn = min(kColsPerThread, cn - col0);
    if (jn == kColsPerThread) {
#pragma unroll 8
      for (int j = col0; j < col0 + kColsPerThread; ++j) {
        taper_column<NU, kD>(x, s_pts[j], tau, part);
      }
    } else {
      for (int j = col0; j < col0 + jn; ++j) {
        taper_column<NU, kD>(x, s_pts[j], tau, part);
      }
    }
    double sum = 0.0;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (live[r]) sum += static_cast<double>(part[r]);
    }
    // the mirror unit (columns, rows) has the same k^2, bit for bit
    acc += (symmetric && unit.x != unit.y ? 2.0 : 1.0) * sum;
  }
  const double total = block_sum<kWarps>(acc, s_warp);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

struct Args {
  const float* pts;
  const int2* units;
  double* partials;
  int n, d, tile;
  int64_t num_units;
  int per_block, blocks;
  bool symmetric;
  float tau;
  cudaStream_t stream;
};

template <int NU, int D>
cudaError_t launch(const Args& a) {
  blocksparse_trace_kernel<NU, D><<<a.blocks, kThreads, 0, a.stream>>>(
      a.pts, a.units, a.partials, a.n, a.d, a.tile, a.num_units, a.per_block,
      a.symmetric, a.tau);
  return cudaGetLastError();
}

template <int NU>
cudaError_t launch_d(const Args& a) {
  return a.d == 2 ? launch<NU, 2>(a) : launch<NU, 0>(a);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `pts` holds at least n points;
// `units` num_units (first row, first column) int32 pairs, each the start of
// a sub-tile of a tile of `tile` points (cuda_kernels.
// blocksparse_trace_schedule); `symmetric` counts every unit whose rows are
// not its columns twice. `partials` (`blocks` float64) receives one
// weighted k^2 sum per block of `per_block` units; the blocks must cover
// the units exactly.
extern "C" int gppe_matern_blocksparse(const void* pts, const void* units,
                                       void* partials, int n, int d,
                                       int tile, int num_units,
                                       int symmetric, float tau,
                                       int nu_code, int per_block,
                                       int blocks, void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || tile <= 0 || units == nullptr ||
      partials == nullptr || !trace_grid_ok(num_units, per_block, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const int2*>(units),
               static_cast<double*>(partials),
               n,
               d,
               tile,
               num_units,
               per_block,
               blocks,
               symmetric != 0,
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
