// The general-nu Matern correlation on Hopper (sm_90a): three entries over
// one device function, matern_general (matern_bessel.cuh):
//
//   (a) elementwise: out[i] = k(x[i]; nu) over a buffer of scaled
//       distances, the assembly of a dense K;
//   (b) product: out_b = K_b @ V_b for a batch of B (scale, nu) points of
//       one grid chunk (B = 1: one operator), K_b[i, j] =
//       k(|x_i - y_j| / scale_b; nu_b), K never stored, float32 FMA sums;
//   (c) trace: out_b = trace(K_b^2) for a batch of (scale, nu) points,
//       on the walk of matern_trace.cuh, float64 block partials summed in
//       order by a second kernel.
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
//   * nu is a per-launch (per grid point) constant: everything that depends
//     on nu alone is computed once on the host in float64, so a pair only
//     runs its branch's loop and the recurrence, and leaves the loop when
//     its own series has converged;
//   * the product fills branch-binned k tiles (matern_general_tile.cuh):
//     a warp evaluates 32 pairs of one branch and alike trips, where one
//     row a lane ran both branches in most warps;
//   * the product walks the tile pairs of 128 x 128 points row tile by
//     row tile (only tj >= ti of a square K, symmetric bit for bit in the
//     difference form, as matern_trace.cuh argues), each tile pair one
//     block, in two k tiles of 64 rows. Each k serves both K[i, j] and
//     K[j, i]: out[ti] += K_t @ V[tj] and, off the diagonal, out[tj] +=
//     K_t^T @ V[ti]. The block writes each side's float32 sums to a slot
//     of its own, and a second kernel adds each row tile's slots to its
//     rows in the order of their column tile: no atomics, the same bits
//     run to run;
//   * the slots are bounded: a launch takes a band of consecutive tile
//     pairs of the walk whose slots fit the caller's scratch
//     (ops/cuda_kernels.py, GENERAL_SLOT_BYTES), and each band's sum
//     continues from the rows the bands before it wrote. In that walk the
//     pairs that write a row tile come in the order of their column tile,
//     so the sum is the same bits however the walk is cut. The product
//     takes that scratch and O(n r) a point, where one slot per tile pair
//     would take n^2 r / 32 bytes a point;
//   * each launch covers the whole batch: grid.y is the point, each block
//     copies its point's constants (1752 bytes) and scale into shared
//     memory and divides its points by the scale itself (IEEE division),
//     so a point gives the same bits alone or in any batch (and in any
//     bands). Widths above 32 run as launches of 32 columns;
//   * the trace on the same binned k tiles: the walk of matern_trace.cuh
//     (on a square K the tile pairs tj >= ti of 128 x 128 points), each
//     tile pair two k tiles of 64 rows. On the square K a tile counts only
//     its pairs above K's diagonal (column past row), each at weight 2, so
//     a diagonal tile pair evaluates its upper triangle once; K[i, i] = 1
//     for every point, and the sum kernel adds those n ones. A thread sums
//     k^2 over its fixed pairs of a tile in float32 FMAs and adds that, in
//     float64, to its sum over the block's tile pairs; the block's sum (a
//     fixed tree) is its partial, and a second kernel sums each point's
//     partials in a fixed order. A launch covers a batch of points as the
//     product does (grid.y the point, its constants and scale copied into
//     shared memory), so a point's trace is the same bits alone or in any
//     batch. The tile holds no V operands (TraceTileSmem), so four blocks
//     share an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "matern_bessel.cuh"
#include "matern_common.cuh"
#include "matern_general_tile.cuh"
#include "matern_trace.cuh"

using namespace gppe;

namespace {

constexpr int kElemThreads = 256;
constexpr int kProductMaxCols = 32;  // widest instance; wider V in launches

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

// The product's walk: the tile pairs row tile by row tile (only tj >= ti
// on the symmetric walk, where row tile ti starts at pair ti T - ti (ti -
// 1) / 2 of T tiles), so that the pairs that write a row tile's sums come
// in the order of their column index s (s < ti: the mirror of pair (s,
// ti); s >= ti: the row side of pair (ti, s)). A launch takes a band of
// consecutive pairs of that walk.
__host__ __device__ inline int64_t product_row_start(int ti, int tiles) {
  return static_cast<int64_t>(ti) * tiles -
         static_cast<int64_t>(ti) * (ti - 1) / 2;
}

__host__ __device__ inline TilePair product_pair(int64_t g, int tiles_r,
                                                 int tiles_c,
                                                 bool symmetric) {
  if (!symmetric) {
    return {static_cast<int>(g / tiles_c), static_cast<int>(g % tiles_c),
            1.0};
  }
  int lo = 0, hi = tiles_r - 1;  // the last row tile that starts by g
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (product_row_start(mid, tiles_r) <= g) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return {lo, lo + static_cast<int>(g - product_row_start(lo, tiles_r)),
          1.0};
}

// the walk's index of the pair that writes row tile x's slot s
__device__ __forceinline__ int64_t product_slot_pair(int x, int s,
                                                     int tiles_r,
                                                     int tiles_c,
                                                     bool symmetric) {
  if (!symmetric) return static_cast<int64_t>(x) * tiles_c + s;
  return s < x ? product_row_start(s, tiles_r) + (x - s)
               : product_row_start(x, tiles_r) + (s - x);
}

// the first s < count whose pair is at or past g (count where none is):
// the pairs of a row tile's slots rise with s
__device__ __forceinline__ int product_first_slot(int64_t g, int x,
                                                  int count, int tiles_r,
                                                  int tiles_c,
                                                  bool symmetric) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (product_slot_pair(x, mid, tiles_r, tiles_c, symmetric) < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// RC: the instance's widest r. Block (p, b): pair g0 + p of the walk for
// point b, its rows in k tiles of kTileRows; the row side's sums to slot
// side 0 of pair p, the mirror's to side 1, each kTraceTile x r floats at
// slots + ((b slot_pairs + p) sides + side) kTraceTile r.
template <int RC>
__global__ void __launch_bounds__(kTileThreads, RC == 16 ? 4 : 3)
    matern_general_product_kernel(
        const float* __restrict__ rows, const float* __restrict__ cols,
        const float* __restrict__ scales,
        const MaternGeneralConsts* __restrict__ consts,
        const float* __restrict__ V, float* __restrict__ slots, int nr,
        int nc, int d, int r, int ldv, int64_t v_stride, int tiles_r,
        int tiles_c, bool symmetric, int64_t g0, int64_t slot_pairs) {
  extern __shared__ float4 smem_raw[];
  TileSmem<RC, 2>& s = *reinterpret_cast<TileSmem<RC, 2>*>(smem_raw);
  __shared__ TilePoints t;
  __shared__ MaternGeneralConsts c;
  __shared__ float s_scale[kMaxD];
  const int b = blockIdx.y;
  {
    const int* src = reinterpret_cast<const int*>(consts + b);
    int* dst = reinterpret_cast<int*>(&c);
    for (int w = threadIdx.x; w < static_cast<int>(sizeof(c) / 4);
         w += kTileThreads) {
      dst[w] = src[w];
    }
  }
  if (threadIdx.x < kMaxD) {
    s_scale[threadIdx.x] =
        threadIdx.x < d ? scales[b * d + threadIdx.x] : 1.0f;
  }
  const TilePair tp = product_pair(g0 + blockIdx.x, tiles_r, tiles_c,
                                   symmetric);
  const bool mirror = symmetric && tp.ti != tp.tj;
  const int i0 = tp.ti * kTraceTile;
  const int j0 = tp.tj * kTraceTile;
  const int ncols = min(kTraceTile, nc - j0);
  const int nrows_tile = min(kTraceTile, nr - i0);
  const float* Vb = V + b * v_stride;
  const int sides = symmetric ? 2 : 1;
  const int64_t slot = static_cast<int64_t>(kTraceTile) * r;
  // the pair's place in the band, g - g0, from the tile pair and not from
  // blockIdx.x, here and for the mirror below, written out as it stands:
  // so the kernel keeps within its registers (ptxas: 78 / 64 at RC = 32 /
  // 16, no spill), where blockIdx.x, or the same index through a helper,
  // spilled 48-96 / 72-144 bytes
  float* row_slot =
      slots + ((b * slot_pairs +
                (symmetric ? product_row_start(tp.ti, tiles_r) +
                                 (tp.tj - tp.ti)
                           : static_cast<int64_t>(tp.ti) * tiles_c + tp.tj) -
                g0) * sides) * slot;
  __syncthreads();  // the scale
  for (int e = threadIdx.x; e < kMaxD * kTileCols; e += kTileThreads) {
    const int k = e / kTileCols;
    const int j = e % kTileCols;
    t.cx[k][j] = (k < d && j < ncols)
                     ? cols[static_cast<int64_t>(j0 + j) * d + k] / s_scale[k]
                     : 0.0f;
  }

  float mirror_acc[2][RC / 4] = {};
  for (int h = 0; h * kTileRows < nrows_tile; ++h) {
    const int r0 = h * kTileRows;
    const int nrows = min(kTileRows, nrows_tile - r0);
    for (int e = threadIdx.x; e < kMaxD * kTileRows; e += kTileThreads) {
      const int k = e / kTileRows;
      const int i = e % kTileRows;
      t.rx[k][i] =
          (k < d && i < nrows)
              ? rows[static_cast<int64_t>(i0 + r0 + i) * d + k] / s_scale[k]
              : 0.0f;
    }
    tile_classify(s, t, nrows, ncols, d, kInf, c);
    tile_evaluate<false>(s, t, c, 0.0f);
    // the V rows of the tile's columns and (mirror) of its rows, where the
    // list was
    stage_v<RC>(s.v[0], Vb, j0, ncols, r, ldv);
    if (mirror) stage_v<RC>(s.v[1], Vb, i0 + r0, nrows, r, ldv);
    __syncthreads();
    float acc[2][RC / 8] = {};
    tile_times_v<RC>(s.k, s.v[0], acc);
    const int i = r0 + threadIdx.x / 8;
    const int q0 = (threadIdx.x % 8) * (RC / 8);
#pragma unroll
    for (int u = 0; u < RC / 8; ++u) {
      if (q0 + u < r) {
        row_slot[i * r + q0 + u] = acc[0][u];
        row_slot[(i + 32) * r + q0 + u] = acc[1][u];
      }
    }
    if (mirror) tile_t_times_v<RC>(s.k, s.v[1], mirror_acc);
    __syncthreads();  // the next k tile overwrites the tile and the rows
  }
  if (mirror) {
    float* col_slot =
        slots + ((b * slot_pairs +
                  (symmetric ? product_row_start(tp.ti, tiles_r) +
                                   (tp.tj - tp.ti)
                             : static_cast<int64_t>(tp.ti) * tiles_c +
                                   tp.tj) -
                  g0) * sides + 1) * slot;
    const int j = threadIdx.x % 64;
    const int q0 = (threadIdx.x / 64) * (RC / 4);
#pragma unroll
    for (int u = 0; u < RC / 4; ++u) {
      if (q0 + u < r) {
        col_slot[j * r + q0 + u] = mirror_acc[0][u];
        col_slot[(j + 64) * r + q0 + u] = mirror_acc[1][u];
      }
    }
  }
}

// The band's sum, one thread an entry (b, row, q) of rows [row0, row1):
// the slots of the band's pairs g0 <= g < g1 that write the row's tile x,
// in order of s, added to out_b[row, q] (to 0 where the band holds the
// tile's first slot). Band after band in the walk's order, this is the
// one sum over s of the tile's slots, the same bits whatever the bands.
__global__ void __launch_bounds__(256)
    matern_general_product_sum_kernel(const float* __restrict__ slots,
                                      float* __restrict__ out, int r,
                                      int ldo, int64_t out_stride, int row0,
                                      int rows, int tiles_r, int tiles_c,
                                      bool symmetric, int64_t g0,
                                      int64_t g1, int64_t slot_pairs,
                                      int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  const int q = static_cast<int>(e % r);
  const int64_t br = e / r;
  const int row = row0 + static_cast<int>(br % rows);
  const int64_t b = br / rows;
  const int x = row / kTraceTile;
  const int count = symmetric ? tiles_r : tiles_c;
  const int s_lo =
      product_first_slot(g0, x, count, tiles_r, tiles_c, symmetric);
  const int s_hi =
      product_first_slot(g1, x, count, tiles_r, tiles_c, symmetric);
  if (s_lo >= s_hi) return;
  const int sides = symmetric ? 2 : 1;
  const int64_t slot = static_cast<int64_t>(kTraceTile) * r;
  const float* src = slots + b * slot_pairs * sides * slot +
                     (row % kTraceTile) * r + q;
  float* dst = out + b * out_stride + static_cast<int64_t>(row) * ldo + q;
  float sum = s_lo == 0 ? 0.0f : *dst;
  for (int s = s_lo; s < s_hi; ++s) {
    const int64_t p =
        product_slot_pair(x, s, tiles_r, tiles_c, symmetric) - g0;
    sum += src[(p * sides + (symmetric && s < x ? 1 : 0)) * slot];
  }
  *dst = sum;
}

// Block (q, b): tile pairs [q per_block, (q + 1) per_block) of the walk
// (matern_trace.cuh) for point b, each as k tiles of kTileRows rows; on
// the symmetric walk only the pairs above K's diagonal, at weight 2, else
// every pair at weight 1. partials[b blocks + q] = the block's float64 sum.
__global__ void __launch_bounds__(kTileThreads, 4)
    matern_general_trace_kernel(
        const float* __restrict__ rows, const float* __restrict__ cols,
        const float* __restrict__ scales,
        const MaternGeneralConsts* __restrict__ consts,
        double* __restrict__ partials, int nr, int nc, int d, int tiles_r,
        int tiles_c, int64_t pairs, int per_block, int blocks,
        bool symmetric) {
  extern __shared__ float4 smem_raw[];
  TraceTileSmem& s = *reinterpret_cast<TraceTileSmem*>(smem_raw);
  __shared__ TilePoints t;
  __shared__ MaternGeneralConsts c;
  __shared__ float s_scale[kMaxD];
  __shared__ double s_warp[kTileWarps];
  const int b = blockIdx.y;
  {
    const int* src = reinterpret_cast<const int*>(consts + b);
    int* dst = reinterpret_cast<int*>(&c);
    for (int w = threadIdx.x; w < static_cast<int>(sizeof(c) / 4);
         w += kTileThreads) {
      dst[w] = src[w];
    }
  }
  if (threadIdx.x < kMaxD) {
    s_scale[threadIdx.x] =
        threadIdx.x < d ? scales[b * d + threadIdx.x] : 1.0f;
  }
  __syncthreads();  // the scale and the constants
  double acc = 0.0;
  const int64_t p_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int count = static_cast<int>(
      p_begin + per_block < pairs ? per_block : pairs - p_begin);
  for (int q = 0; q < count; ++q) {
    const TilePair tp = trace_tile_pair(
        static_cast<int64_t>(blockIdx.x) * per_block + q, tiles_r, tiles_c,
        symmetric);
    const int i0 = tp.ti * kTraceTile;
    const int j0 = tp.tj * kTraceTile;
    const int ncols = min(kTraceTile, nc - j0);
    const int nrows_tile = min(kTraceTile, nr - i0);
    for (int e = threadIdx.x; e < kMaxD * kTileCols; e += kTileThreads) {
      const int k = e / kTileCols;
      const int j = e % kTileCols;
      t.cx[k][j] = (k < d && j < ncols)
                       ? cols[static_cast<int64_t>(j0 + j) * d + k] /
                             s_scale[k]
                       : 0.0f;
    }
    for (int r0 = 0; r0 < nrows_tile; r0 += kTileRows) {
      const int nrows = min(kTileRows, nrows_tile - r0);
      for (int e = threadIdx.x; e < kMaxD * kTileRows; e += kTileThreads) {
        const int k = e / kTileRows;
        const int i = e % kTileRows;
        t.rx[k][i] =
            (k < d && i < nrows)
                ? rows[static_cast<int64_t>(i0 + r0 + i) * d + k] / s_scale[k]
                : 0.0f;
      }
      // the square K: pair (i, j) counts where column j0 + j > row
      // i0 + r0 + i; any pair of a rectangular K (j - i > -kTileRows)
      acc += static_cast<double>(tile_trace<false>(
          s, t, nrows, ncols, d, kInf,
          symmetric ? i0 + r0 - j0 : -kTileRows, c, 0.0f));
    }
  }
  // each counted pair twice on the square K: the weight, a power of two,
  // scales every sum exactly
  const double total = block_sum<kTileWarps>(acc, s_warp);
  if (threadIdx.x == 0) {
    partials[static_cast<int64_t>(blockIdx.y) * blocks + blockIdx.x] =
        symmetric ? 2.0 * total : total;
  }
}

// out[b] = point b's partials summed in a fixed order (thread x its
// partials x, x + 256, ..., then the block's tree), plus `diagonal`
__global__ void __launch_bounds__(256)
    matern_general_trace_sum_kernel(const double* __restrict__ partials,
                                    double* __restrict__ out, int blocks,
                                    double diagonal) {
  __shared__ double s_warp[8];
  const double* src = partials + static_cast<int64_t>(blockIdx.x) * blocks;
  double acc = 0.0;
  for (int q = threadIdx.x; q < blocks; q += 256) acc += src[q];
  const double total = block_sum<8>(acc, s_warp);
  if (threadIdx.x == 0) out[blockIdx.x] = total + diagonal;
}

template <int RC>
cudaError_t launch_product(const float* rows, const float* cols,
                           const float* scales,
                           const MaternGeneralConsts* consts, const float* V,
                           float* slots, int nr, int nc, int d, int r,
                           int ldv, int64_t v_stride, int tiles_r,
                           int tiles_c, int band_pairs, int batch,
                           bool symmetric, int64_t g0, int64_t slot_pairs,
                           cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(TileSmem<RC, 2>));
  cudaError_t err = cudaFuncSetAttribute(
      matern_general_product_kernel<RC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  matern_general_product_kernel<RC>
      <<<dim3(static_cast<unsigned>(band_pairs), batch), kTileThreads,
         bytes, stream>>>(rows, cols, scales, consts, V, slots, nr, nc, d, r,
                          ldv, v_stride, tiles_r, tiles_c, symmetric, g0,
                          slot_pairs);
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

// (b) out_b[:, :r] = K_b @ V_b[:, :r] for b < batch, r <= 32, one band of
// the walk: rows (nr, d), cols (nc, d) unscaled points; scales (batch, d)
// float32 and consts (batch structs of gppe_matern_general_consts_bytes
// bytes), both on the device; V_b at V + b v_stride, rows of stride ldv;
// out_b at out + b out_stride, rows of stride ldo; `symmetric` (cols is
// rows) walks tj >= ti. The band is the walk's pairs [g0, g0 +
// band_pairs), tiles of 128 points (product_pair); the bands of a product
// are launched in the walk's order, each adding to the rows that earlier
// ones wrote. slots: a float32 scratch of batch * slot_pairs * sides * 128
// * r floats, slot_pairs >= band_pairs, sides 2 on the symmetric walk else
// 1 (ops/cuda_kernels.py, general_product_bands). Launches the tile kernel
// and the band's sum on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise and allocates nothing. The constants are
// not read on the host: the caller builds them.
extern "C" int gppe_matern_general_product(
    const void* rows, const void* cols, const void* scales,
    const void* consts, const void* V, void* out, void* slots, int nr,
    int nc, int d, int r, int ldv, int ldo, int64_t v_stride,
    int64_t out_stride, int batch, int symmetric, int64_t g0,
    int band_pairs, int64_t slot_pairs, void* stream) {
  const int tiles_r = (nr + kTraceTile - 1) / kTraceTile;
  const int tiles_c = (nc + kTraceTile - 1) / kTraceTile;
  if (nr <= 0 || nc <= 0 || d < 1 || d > kMaxD || r < 1 ||
      r > kProductMaxCols || ldv < r || ldo < r || batch < 1 ||
      batch > 65535 || (symmetric && (nr != nc || rows != cols)) ||
      g0 < 0 || band_pairs < 1 || slot_pairs < band_pairs ||
      g0 + band_pairs > trace_pairs(tiles_r, tiles_c, symmetric != 0) ||
      rows == nullptr || cols == nullptr || scales == nullptr ||
      consts == nullptr || V == nullptr || out == nullptr ||
      slots == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool sym = symmetric != 0;
  const float* p_rows = static_cast<const float*>(rows);
  const float* p_cols = static_cast<const float*>(cols);
  const float* p_scales = static_cast<const float*>(scales);
  const MaternGeneralConsts* p_consts =
      static_cast<const MaternGeneralConsts*>(consts);
  const float* p_v = static_cast<const float*>(V);
  float* p_slots = static_cast<float*>(slots);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r <= 8) {
    err = launch_product<8>(p_rows, p_cols, p_scales, p_consts, p_v, p_slots,
                            nr, nc, d, r, ldv, v_stride, tiles_r, tiles_c,
                            band_pairs, batch, sym, g0, slot_pairs, s);
  } else if (r <= 16) {
    err = launch_product<16>(p_rows, p_cols, p_scales, p_consts, p_v,
                             p_slots, nr, nc, d, r, ldv, v_stride, tiles_r,
                             tiles_c, band_pairs, batch, sym, g0,
                             slot_pairs, s);
  } else {
    err = launch_product<32>(p_rows, p_cols, p_scales, p_consts, p_v,
                             p_slots, nr, nc, d, r, ldv, v_stride, tiles_r,
                             tiles_c, band_pairs, batch, sym, g0,
                             slot_pairs, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the row tiles the band writes: from its first pair's row tile to its
  // last pair's column tile, or to the last tile where it spans a row tile
  // (the mirrors of a whole row tile reach every tile after it)
  const int64_t g1 = g0 + band_pairs;
  const TilePair first = product_pair(g0, tiles_r, tiles_c, sym);
  const TilePair last = product_pair(g1 - 1, tiles_r, tiles_c, sym);
  const int x0 = first.ti;
  const int x1 = !sym ? last.ti + 1
                      : (last.ti > first.ti ? tiles_r : last.tj + 1);
  const int row0 = x0 * kTraceTile;
  const int rows_sum = min(x1 * kTraceTile, nr) - row0;
  const int64_t total = static_cast<int64_t>(batch) * rows_sum * r;
  const int64_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  matern_general_product_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                                      s>>>(
      p_slots, static_cast<float*>(out), r, ldo, out_stride, row0, rows_sum,
      tiles_r, tiles_c, sym, g0, g1, slot_pairs, total);
  return static_cast<int>(cudaGetLastError());
}

// (c) out[b] = trace(K_b^2) for b < batch, float64: rows (nr, d), cols
// (nc, d) unscaled points; scales (batch, d) float32 and consts (batch
// structs), both on the device, as the product takes them; `symmetric`
// (cols is rows) walks tj >= ti. partials: a float64 scratch of batch *
// blocks entries, the blocks covering the walk's pairs `per_block` each
// (cuda_kernels.trace_schedule). Launches the tile kernel and the sum
// kernel on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise and allocates nothing.
extern "C" int gppe_matern_general_trace(
    const void* rows, const void* cols, const void* scales,
    const void* consts, void* partials, void* out, int nr, int nc, int d,
    int symmetric, int per_block, int blocks, int batch, void* stream) {
  const int tiles_r = (nr + kTraceTile - 1) / kTraceTile;
  const int tiles_c = (nc + kTraceTile - 1) / kTraceTile;
  const int64_t pairs = trace_pairs(tiles_r, tiles_c, symmetric != 0);
  if (nr <= 0 || nc <= 0 || d < 1 || d > kMaxD || batch < 1 ||
      batch > 65535 || (symmetric && (nr != nc || rows != cols)) ||
      !trace_grid_ok(pairs, per_block, blocks) || rows == nullptr ||
      cols == nullptr || scales == nullptr || consts == nullptr ||
      partials == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(sizeof(TraceTileSmem));
  cudaError_t err = cudaFuncSetAttribute(
      matern_general_trace_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  matern_general_trace_kernel<<<dim3(static_cast<unsigned>(blocks), batch),
                                kTileThreads, bytes, s>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cols),
      static_cast<const float*>(scales),
      static_cast<const MaternGeneralConsts*>(consts),
      static_cast<double*>(partials), nr, nc, d, tiles_r, tiles_c, pairs,
      per_block, blocks, symmetric != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the diagonal of a square K: one 1 a point
  matern_general_trace_sum_kernel<<<batch, 256, 0, s>>>(
      static_cast<const double*>(partials), static_cast<double*>(out), blocks,
      symmetric ? static_cast<double>(nr) : 0.0);
  return static_cast<int>(cudaGetLastError());
}
