// The tapered (block-sparse) Matern correlation at a general nu, on Hopper
// (sm_90a): two entries over the general-nu device function matern_general
// (matern_bessel.cuh) and the tapered kernels' pair list,
//
//   (a) product: out = K_tau @ V,
//       K_tau[i, j] = k >= tau ? k : 0,  k = k_nu(|x_i - x_j|),
//       over the active tile pairs only, K never stored, float32 FMA sums;
//   (b) trace: partials[b] = sum over block b's units of weight * sum
//       K_tau[i, j]^2, float64 partials that the caller sums (adding the
//       diagonal's ones on the symmetric walk) to trace(K_tau^2).
//
// x (n_pad, d) are spatially sorted points already divided by the
// correlation scale and padded to a multiple of `tile`, float32; only the
// first n rows and columns are real, and pad rows and columns take no part
// (pad rows of out are written as zero).
//
// Replaces no Pallas kernel: the reference sets use_pallas only for the
// closed forms (gppe_tpu/ops/taper.py:238-239) and runs a general nu on the
// XLA scans TaperedMaternOperator._matmat_blocked (taper.py:273-301) and
// .trace_pow (:303-330), which evaluate kernels.matern per active tile pair
// and keep k >= tau. XLA fuses the Bessel loop there; eager PyTorch would
// run its ~2,000 elementwise steps on every tile pair. This source is that
// fused loop on the closed-form kernels' pair list: the product walks the
// row-tile pointer array of matern_blocksparse_mma.cu, the trace units of
// 64 x 128 points of the list's tile pairs
// (ops/cuda_kernels.py::blocksparse_general_trace_schedule).
//
// What bounds it on this card: per pair within the taper radius one k, the
// branch its argument takes in matern_general (Temme below z = 2, CF2 from
// 2 up, then round(nu) upward steps: hundreds of FP32 operations and a few
// MUFU operations), against d + 1 operations for the distance and the
// compare of every pair of an active tile pair, 2r for the product (2 for
// k^2 in the trace). The traffic, O(n (d + r)) words and the pair list,
// mostly hits the L2 cache: FP32 issue bounds both entries, as it bounds
// matern_general.cu's.
//
// What the design does about it:
//   * nu is a per-launch constant: the float64 host table of
//     ops/cuda_kernels.py::_general_consts, passed by value;
//   * the taper's skip: past the skip radius (`skip2`, its square, from
//     ops/cuda_kernels.py::blocksparse_skip_radius) float64 k lies below
//     tau by more than the kernel's error bound, so the rule k >= tau would
//     drop the pair anyway: it takes no k and is an exact 0. Inside it the
//     rule stands (the float32 k against the float32 tau, the rule of
//     matern_blocksparse_mma.cu), so the kept set and its values are those
//     of evaluating every pair;
//   * the product: a block holds 64 rows of one row tile and walks the 128
//     column sub-tiles of that tile's active column tiles; a sub-tile pair
//     whose bounding boxes lie past the skip radius is skipped whole (the
//     boxes' gap is computed in the pairs' own float32 arithmetic, so it is
//     never larger than any pair's distance), the others fill one
//     branch-binned k tile of their kept pairs (matern_general_tile.cuh)
//     and add K_t @ V to the rows' sums in registers, in the list's order:
//     the output is row-owned, no atomics, the same bits run to run. Widths
//     above 32 run as launches of 32 columns;
//   * the trace: the symmetric half of the pair list (K_tau is symmetric
//     bit for bit: (a - b)^2 = (b - a)^2 and the same FMA order over d both
//     ways) in units of the product's 64 x 128 sub-tile pairs: the tile
//     pairs ti <= tj, and of a diagonal tile pair the units that hold a
//     pair above K's diagonal. A unit counts only its pairs above the
//     diagonal (column past row), each at weight 2; K[i, i] = 1 for every
//     real point and the caller adds those n ones. A unit whose boxes lie
//     past the skip radius is skipped whole, the others fill the binned k
//     tile with the taper skip as the product does, and each thread sums
//     k^2 over its fixed pairs in float32 FMAs, then adds that in float64
//     to its sum over the block's units: float64 block partials, no
//     atomics. A skipped pair or unit adds an exact 0 (its float32 k would
//     be tapered to 0), so the trace is the same bits with and without the
//     skip. The tile holds no V operands (TraceTileSmem): four blocks share
//     an SM. A list without its mirror walks every unit at weight 1.
// Built WITHOUT --use_fast_math: sqrtf, expf, logf and the divisions are
// the IEEE versions.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_bessel.cuh"
#include "matern_common.cuh"
#include "matern_general_tile.cuh"
#include "matern_trace.cuh"

using namespace gppe;

namespace {

constexpr int kProductMaxCols = 32;  // widest instance; wider V in launches

// the squared gap between the boxes s_lo[0] .. s_hi[0] (the rows) and
// s_lo[1] .. s_hi[1] (the columns), as a pair's d2: no pair is nearer (the
// boxes' gap in the pairs' own float32 arithmetic)
__device__ __forceinline__ float box_gap2(const float (&s_lo)[2][kMaxD],
                                          const float (&s_hi)[2][kMaxD],
                                          int d) {
  float gap2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    if (k < d) {
      const float g = fmaxf(fmaxf(s_lo[0][k] - s_hi[1][k],
                                  s_lo[1][k] - s_hi[0][k]),
                            0.0f);
      gap2 = fmaf(g, g, gap2);
    }
  }
  return gap2;
}

// RC: the instance's widest r. Block b takes rows kTileRows (b %
// blocks_per_tile) .. + kTileRows - 1 of row tile b / blocks_per_tile and
// the real columns of that tile's column tiles col_tiles[row_ptr[ti] ..
// row_ptr[ti + 1]), in sub-tiles of kTileCols.
template <int RC>
__global__ void __launch_bounds__(kTileThreads, 3)
    blocksparse_general_product_kernel(
        const float* __restrict__ pts, const float* __restrict__ V,
        float* __restrict__ out, const int* __restrict__ row_ptr,
        const int* __restrict__ col_tiles, int n, int d, int r, int ldv,
        int ldo, int tile, int blocks_per_tile, float tau, float skip2,
        const MaternGeneralConsts c) {
  extern __shared__ float4 smem_raw[];
  TileSmem<RC, 1>& s = *reinterpret_cast<TileSmem<RC, 1>*>(smem_raw);
  __shared__ TilePoints t;
  __shared__ float s_lo[2][kMaxD], s_hi[2][kMaxD];  // rows', columns' boxes
  const int warp = threadIdx.x >> 5;
  const int ti = blockIdx.x / blocks_per_tile;
  const int row0 = ti * tile + (blockIdx.x % blocks_per_tile) * kTileRows;
  const int tile_end = (ti + 1) * tile;
  const int nrows = max(0, min(kTileRows, min(tile_end, n) - row0));
  float acc[2][RC / 8] = {};

  if (nrows > 0) {  // uniform over the block: pad-only blocks skip
    for (int e = threadIdx.x; e < kMaxD * kTileRows; e += kTileThreads) {
      const int k = e / kTileRows;
      const int i = e % kTileRows;
      t.rx[k][i] = (k < d && i < nrows)
                       ? pts[static_cast<int64_t>(row0 + i) * d + k]
                       : 0.0f;
    }
    __syncthreads();
    if (warp < d) {
      float lo, hi;
      warp_bounds(t.rx[warp], nrows, lo, hi);
      s_lo[0][warp] = lo;
      s_hi[0][warp] = hi;
    }
    const int p_end = row_ptr[ti + 1];
    for (int p = row_ptr[ti]; p < p_end; ++p) {
      const int cj = col_tiles[p] * tile;
      const int cend = min(cj + tile, n);
      for (int j0 = cj; j0 < cend; j0 += kTileCols) {
        const int ncols = min(kTileCols, cend - j0);
        __syncthreads();  // the previous sub-tile is done with cx and v
        for (int e = threadIdx.x; e < kMaxD * kTileCols;
             e += kTileThreads) {
          const int k = e / kTileCols;
          const int j = e % kTileCols;
          t.cx[k][j] = (k < d && j < ncols)
                           ? pts[static_cast<int64_t>(j0 + j) * d + k]
                           : 0.0f;
        }
        __syncthreads();
        if (warp < d) {
          float lo, hi;
          warp_bounds(t.cx[warp], ncols, lo, hi);
          s_lo[1][warp] = lo;
          s_hi[1][warp] = hi;
        }
        __syncthreads();
        // uniform: every pair lies past the skip radius
        if (box_gap2(s_lo, s_hi, d) > skip2) continue;
        if (!tile_classify(s, t, nrows, ncols, d, skip2, c)) continue;
        tile_evaluate<true>(s, t, c, tau);
        stage_v<RC>(s.v[0], V, j0, ncols, r, ldv);  // where the list was
        __syncthreads();
        tile_times_v<RC>(s.k, s.v[0], acc);
      }
    }
  }
  const int q0 = (threadIdx.x % 8) * (RC / 8);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + threadIdx.x / 8 + 32 * h;
    if (row < tile_end) {
#pragma unroll
      for (int u = 0; u < RC / 8; ++u) {
        if (q0 + u < r) {
          out[static_cast<int64_t>(row) * ldo + q0 + u] = acc[h][u];
        }
      }
    }
  }
}

// units[u] = (first row, first column) of unit u: the real rows of
// kTileRows from its first row by the real columns of kTraceTile from
// its first column (sub_tile_points). Symmetric: only the
// pairs above K's diagonal count, at weight 2; else every pair, weight 1.
__global__ void __launch_bounds__(kTileThreads, 4)
    blocksparse_general_trace_kernel(const float* __restrict__ pts,
                                     const int2* __restrict__ units,
                                     double* __restrict__ partials, int n,
                                     int d, int tile, int64_t num_units,
                                     int per_block, bool symmetric, float tau,
                                     float skip2,
                                     const MaternGeneralConsts c) {
  extern __shared__ float4 smem_raw[];
  TraceTileSmem& s = *reinterpret_cast<TraceTileSmem*>(smem_raw);
  __shared__ TilePoints t;
  __shared__ float s_lo[2][kMaxD], s_hi[2][kMaxD];  // rows', columns' boxes
  __shared__ double s_warp[kTileWarps];
  const int warp = threadIdx.x >> 5;
  const double weight = symmetric ? 2.0 : 1.0;
  double acc = 0.0;
  const int64_t u_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t u_end =
      u_begin + per_block < num_units ? u_begin + per_block : num_units;
  for (int64_t u = u_begin; u < u_end; ++u) {
    const int2 unit = units[u];
    const int nrows = sub_tile_points<kTileRows>(unit.x, tile, n);
    const int ncols = sub_tile_points(unit.y, tile, n);
    __syncthreads();  // every thread is done with the previous unit's boxes
    for (int e = threadIdx.x; e < kMaxD * kTileRows; e += kTileThreads) {
      const int k = e / kTileRows;
      const int i = e % kTileRows;
      t.rx[k][i] = (k < d && i < nrows)
                       ? pts[static_cast<int64_t>(unit.x + i) * d + k]
                       : 0.0f;
    }
    for (int e = threadIdx.x; e < kMaxD * kTileCols; e += kTileThreads) {
      const int k = e / kTileCols;
      const int j = e % kTileCols;
      t.cx[k][j] = (k < d && j < ncols)
                       ? pts[static_cast<int64_t>(unit.y + j) * d + k]
                       : 0.0f;
    }
    __syncthreads();
    if (warp < d) {
      float lo, hi;
      warp_bounds(t.rx[warp], nrows, lo, hi);
      s_lo[0][warp] = lo;
      s_hi[0][warp] = hi;
      warp_bounds(t.cx[warp], ncols, lo, hi);
      s_lo[1][warp] = lo;
      s_hi[1][warp] = hi;
    }
    __syncthreads();
    // uniform: every pair lies past the skip radius
    if (box_gap2(s_lo, s_hi, d) > skip2) continue;
    acc += weight * static_cast<double>(tile_trace<true>(
                        s, t, nrows, ncols, d, skip2,
                        symmetric ? unit.x - unit.y : -kTileRows, c, tau));
  }
  const double total = block_sum<kTileWarps>(acc, s_warp);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <int RC>
cudaError_t launch_product(const float* pts, const float* V, float* out,
                           const int* row_ptr, const int* col_tiles, int n,
                           int d, int r, int ldv, int ldo, int tile,
                           int num_tiles, int blocks_per_tile, float tau,
                           float skip2, const MaternGeneralConsts& c,
                           cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(TileSmem<RC, 1>));
  cudaError_t err = cudaFuncSetAttribute(
      blocksparse_general_product_kernel<RC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  blocksparse_general_product_kernel<RC>
      <<<num_tiles * blocks_per_tile, kTileThreads, bytes, stream>>>(
          pts, V, out, row_ptr, col_tiles, n, d, r, ldv, ldo, tile,
          blocks_per_tile, tau, skip2, c);
  return cudaGetLastError();
}

}  // namespace

// (a) out[:, :r] = K_tau @ V[:, :r] over the pair list, for r <= 32: pts
// (num_tiles * tile, d) sorted scaled points, the first n real; V and out
// rows of strides ldv and ldo in the same order; row tile ti multiplies
// the column tiles col_tiles[row_ptr[ti] .. row_ptr[ti + 1]) (num_tiles + 1
// int32 pointers). `consts` is a host pointer to the per-launch constants
// (gppe_matern_general_consts_bytes bytes). A pair whose float32 squared
// distance exceeds skip2 (+inf: none) is 0 without its k. Every row of out
// is written, pad rows as zero. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise and allocates
// nothing.
extern "C" int gppe_matern_blocksparse_general_product(
    const void* pts, const void* V, void* out, const void* row_ptr,
    const void* col_tiles, int n, int d, int r, int ldv, int ldo, int tile,
    int num_tiles, float tau, float skip2, const void* consts,
    void* stream) {
  const MaternGeneralConsts c = *static_cast<const MaternGeneralConsts*>(
      consts);
  const int blocks_per_tile = (tile + kTileRows - 1) / kTileRows;
  if (n <= 0 || d < 1 || d > kMaxD || r < 1 || r > kProductMaxCols ||
      ldv < r || ldo < r || tile <= 0 || num_tiles <= 0 ||
      n > static_cast<int64_t>(num_tiles) * tile ||
      static_cast<int64_t>(num_tiles) * blocks_per_tile > 0x7fffffff ||
      row_ptr == nullptr || col_tiles == nullptr || !consts_ok(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p_pts = static_cast<const float*>(pts);
  const float* p_v = static_cast<const float*>(V);
  float* p_out = static_cast<float*>(out);
  const int* p_ptr = static_cast<const int*>(row_ptr);
  const int* p_cols = static_cast<const int*>(col_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 8) {
    return static_cast<int>(launch_product<8>(
        p_pts, p_v, p_out, p_ptr, p_cols, n, d, r, ldv, ldo, tile, num_tiles,
        blocks_per_tile, tau, skip2, c, s));
  }
  if (r <= 16) {
    return static_cast<int>(launch_product<16>(
        p_pts, p_v, p_out, p_ptr, p_cols, n, d, r, ldv, ldo, tile, num_tiles,
        blocks_per_tile, tau, skip2, c, s));
  }
  return static_cast<int>(launch_product<32>(
      p_pts, p_v, p_out, p_ptr, p_cols, n, d, r, ldv, ldo, tile, num_tiles,
      blocks_per_tile, tau, skip2, c, s));
}

// (b) partials[b] = block b's weighted sum of tapered k^2 over `per_block`
// units of `units` (num_units (first row, first column) int32 pairs: 64
// rows of a tile of `tile` points by 128 columns of another;
// cuda_kernels.blocksparse_general_trace_schedule); `symmetric` counts
// only the pairs above K's diagonal, each twice (the caller adds the
// diagonal's n ones). A pair whose float32 squared distance exceeds skip2
// (+inf: none) is 0 without its k, a unit whose boxes lie past it is
// skipped. The blocks must cover the units exactly. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise and
// allocates nothing.
extern "C" int gppe_matern_blocksparse_general_trace(
    const void* pts, const void* units, void* partials, int n, int d,
    int tile, int num_units, int symmetric, float tau, float skip2,
    int per_block, int blocks, const void* consts, void* stream) {
  const MaternGeneralConsts c = *static_cast<const MaternGeneralConsts*>(
      consts);
  if (n <= 0 || d < 1 || d > kMaxD || tile <= 0 || units == nullptr ||
      partials == nullptr || !trace_grid_ok(num_units, per_block, blocks) ||
      !consts_ok(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = static_cast<int>(sizeof(TraceTileSmem));
  const cudaError_t err = cudaFuncSetAttribute(
      blocksparse_general_trace_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blocksparse_general_trace_kernel<<<blocks, kTileThreads, bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int2*>(units),
      static_cast<double*>(partials), n, d, tile, num_units, per_block,
      symmetric != 0, tau, skip2, c);
  return static_cast<int>(cudaGetLastError());
}
