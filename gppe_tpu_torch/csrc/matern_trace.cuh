// Shared by the trace(K^2) kernels (matern_matmat.cu, matern_multirho.cu,
// matern_blocksparse.cu): the tile of the walk, the dense kernels' walk
// over tile pairs, the check of a grid against its schedule and the
// block's float64 sum. The tapered kernel walks a flat list of 128 x 128
// units instead, built by the caller (see matern_blocksparse.cu).
//
// A trace kernel sums k^2 over tile pairs (ti, tj) of kTraceTile rows by
// kTraceTile columns, one or more pairs per block, and each block writes
// one float64 partial (per rho) into a buffer the caller sizes and sums.
// No atomics: every partial is summed in a fixed order, so the result is
// the same bits run to run.
//
// A square K (the rows are the columns, the difference form) is symmetric
// bit for bit: (a - b)^2 = (b - a)^2 in float32 and the FMA order over the
// dimensions is the same both ways. Its walk takes only the T (T + 1) / 2
// pairs tj >= ti of T tiles and weighs each pair off the diagonal twice.
// Pair p of that triangle: rows ti = q and T - 1 - q of the triangle hold
// T + 1 pairs together, so q = p / (T + 1) names the fold and c = p % (T + 1)
// the place in it - row q first (T - q pairs), then row T - 1 - q (q + 1
// pairs; for odd T the middle row stands alone). The arithmetic is integer
// and every block costs one tile pair, so no SM waits on long row tiles. A
// rectangular K walks all Tr x Tc pairs row-major with weight 1.
// gppe_tpu_torch/ops/cuda_kernels.py (trace_schedule, trace_tile_pair) is
// the Python mirror, which sizes the partials.
#pragma once

#include <cstdint>

namespace gppe {

constexpr int kTraceTile = 128;  // rows and columns of a tile pair

__host__ __device__ inline int64_t trace_pairs(int tiles_r, int tiles_c,
                                               bool symmetric) {
  return symmetric ? static_cast<int64_t>(tiles_r) * (tiles_r + 1) / 2
                   : static_cast<int64_t>(tiles_r) * tiles_c;
}

// `blocks` blocks of `per_block` consecutive pairs each cover `pairs`, the
// last block perhaps fewer: what the caller's schedule must give
inline bool trace_grid_ok(int64_t pairs, int per_block, int blocks) {
  return per_block >= 1 && blocks >= 1 &&
         static_cast<int64_t>(blocks - 1) * per_block < pairs &&
         static_cast<int64_t>(blocks) * per_block >= pairs;
}

struct TilePair {
  int ti, tj;
  double weight;  // 2 off the diagonal of the symmetric walk, else 1
};

__device__ __forceinline__ TilePair trace_tile_pair(int64_t p, int tiles_r,
                                                    int tiles_c,
                                                    bool symmetric) {
  if (!symmetric) {
    return {static_cast<int>(p / tiles_c), static_cast<int>(p % tiles_c),
            1.0};
  }
  const int64_t fold = static_cast<int64_t>(tiles_r) + 1;
  const int q = static_cast<int>(p / fold);
  const int c = static_cast<int>(p % fold);
  int ti, tj;
  if (c < tiles_r - q) {
    ti = q;
    tj = q + c;
  } else {  // tj = ti + c - (tiles_r - q)
    ti = tiles_r - 1 - q;
    tj = c - 1;
  }
  return {ti, tj, ti == tj ? 1.0 : 2.0};
}

// The tapered kernels' units (matern_blocksparse.cu,
// matern_blocksparse_general.cu): the real points of the sub-tile that
// starts at point p0, at most kSize (the general-nu trace's rows: 64),
// none past the end of its tile of `tile` points or past n
template <int kSize = kTraceTile>
__device__ __forceinline__ int sub_tile_points(int p0, int tile, int n) {
  const int tile_end = (p0 / tile + 1) * tile;
  return min(kSize, min(tile_end, n) - p0);
}

// The block's sum of one value per thread, in a fixed order (the warp's
// butterfly, then warp by warp), valid in thread 0. `s_warp` holds one
// double per warp; the block may call this again right after.
template <int kWarps>
__device__ __forceinline__ double block_sum(double v, double* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  }
  __syncthreads();
  return total;
}

}  // namespace gppe
