// The branch-binned k tile of the general-nu kernels (matern_general.cu,
// matern_blocksparse_general.cu): one block of kTileThreads threads fills a
// tile of kTileRows x kTileCols pairs with k(x; nu) in shared memory and
// multiplies it with the V rows it needs (the products) or sums its k^2
// (the traces).
//
// Why binned. matern_general (matern_bessel.cuh) runs Temme's series below
// z = sqrt(2 nu) x = 2 and CF2 from 2 up, each until its own series has
// converged: the trips fall with z in CF2 and rise with it in Temme. A warp
// whose 32 lanes hold pairs of different z runs both branches and its
// slowest lane's trips. So the tile is filled in three passes:
//
//   1. classify: each pair's squared distance, from the row and column
//      points staged dimension-major in shared memory (the FMA order over
//      the dimensions of the kernels before, so k keeps its bits); a pair
//      past `skip2`, or a pad row or column, is an exact 0, a pair at
//      distance 0 is 1 (matern_general's own value there); the others
//      store their scaled distance x = sqrtf(d2) in the tile, and their
//      bin: kTemmeBins half-octaves of z below 2, kCf2Bins half-octaves
//      from 2 up (the last of each open-ended), counted per bin by one
//      shared-memory atomic per group of lanes that share a bin
//      (__match_any_sync);
//   2. scatter: each pair's bin again from its x, its index into one list
//      ordered by bin, each group of lanes placed by its leader's atomic
//      and its rank in the group;
//   3. evaluate: lane e of the block takes list entries e, e + 256, ..., so
//      a warp's 32 pairs come from one bin (two at a bin's edge): one
//      branch, trips alike. k replaces x in the tile.
//
// The order in which pairs are evaluated depends on the atomics; each
// pair's k does not, and the products and the traces below read the tile
// in a fixed order, so the results are the same bits run to run. No float
// atomics.
//
// The products (float32 FMAs, fixed order):
//   * tile_times_v: acc += K_t @ Vc for the tile's rows, each thread two
//     rows and RC / 8 columns, Vc the V rows of the tile's columns;
//   * tile_t_times_v: acc += K_t^T @ Vr for the tile's columns (the
//     symmetric walk's mirror), each thread two columns and RC / 4 columns
//     of Vr, the V rows of the tile's rows;
// each V load (a float4 where it fits) serves two rows or columns.
//
// The traces (tile_trace): the tile classified with only the pairs above
// K's diagonal counted where the walk is symmetric (the caller adds the
// diagonal's ones), evaluated, then k^2 summed in float32 FMAs over each
// thread's fixed pairs, which the caller adds to its float64 sum.
//
// Shared memory: the k tile (its columns permuted per row, k_index), and
// in one place the list (16-bit indices, passes 2 and 3) and then the NV V
// operands of kTileCols x RC floats, staged once the tile is evaluated
// (TileSmem, dynamic: above 48 KB); the staged points and the bin counters
// (TilePoints, static). A block of G1 takes 56 KB at RC <= 16, so four
// blocks of 8 warps share an SM (three at RC = 32: 72 KB); one of G2
// (NV = 1) 54 KB at RC = 32. A trace's tile (TraceTileSmem) holds no V
// operands: the k tile and the list, 48 KB dynamic.
#pragma once

#include <cstdint>

#include "matern_bessel.cuh"
#include "matern_common.cuh"

namespace gppe {

constexpr int kTileRows = 64;     // rows of a k tile
constexpr int kTileCols = 128;    // its columns
constexpr int kTilePairs = kTileRows * kTileCols;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTemmeBins = 4;     // z in [1.5, 2), [1, 1.5), [0.75, 1), < 0.75
constexpr int kCf2Bins = 6;       // z in [2, 3), [3, 4), ..., [8, 12), >= 12
constexpr int kBins = kTemmeBins + kCf2Bins;
constexpr int kNoBin = 255;       // a pair that is not evaluated
constexpr float kInf = __builtin_huge_valf();
static_assert(kTilePairs % kTileThreads == 0 && kTilePairs <= 65536,
              "the list holds 16-bit pair indices");
static_assert(kTileWarps >= kMaxD, "one warp per dimension for the boxes");

template <int RC, int NV>
struct TileSmem {
  float k[kTilePairs];              // pair (i, j) at k_index(i, j)
  union {
    uint16_t list[kTilePairs];      // passes 2 and 3: the pairs, by bin
    float v[NV][kTileCols * RC];    // the products: V operands, 0 past r
  };
};

// The traces' layout: no V operands (a trace multiplies nothing), so the
// list needs no union
template <>
struct TileSmem<0, 0> {
  float k[kTilePairs];
  uint16_t list[kTilePairs];
};
using TraceTileSmem = TileSmem<0, 0>;

// where pair (i, j) of the k tile lies: row-major, the columns of row i
// permuted by an XOR with 8 (i % 4), so that the four rows a warp of the
// row-side product reads at one column lie on four banks
__device__ __forceinline__ int k_index(int i, int j) {
  return i * kTileCols + (j ^ ((i & 3) << 3));
}

struct TilePoints {
  float rx[kMaxD][kTileRows];     // the rows' points, dimension-major
  float cx[kMaxD][kTileCols];     // the columns'
  int cursor[kBins];              // counts, then each bin's next slot
  int listed;                     // the list's length
};

// the bin of a pair of scaled distance x > 0 (z as matern_general takes
// it): half-octaves of z, read from its exponent and first mantissa bit
__device__ __forceinline__ int k_bin(float x, const MaternGeneralConsts& c) {
  const float z = fmaxf(c.sqrt2nu * x, 1e-30f);
  const int h = __float_as_int(z) >> 22;  // 256 at z = 2, +1 a half-octave
  return z < 2.0f ? min(255 - h, kTemmeBins - 1)
                  : kTemmeBins + min(h - 256, kCf2Bins - 1);
}

// a pair's float32 squared distance from the staged points, the FMA order
// over the dimensions of the kernels before (d = 2 unrolled)
__device__ __forceinline__ float pair_d2(const TilePoints& t, int i, int j,
                                         int d) {
  float d2 = 0.0f;
  if (d == 2) {
    const float a = t.rx[0][i] - t.cx[0][j];
    d2 = fmaf(a, a, d2);
    const float b = t.rx[1][i] - t.cx[1][j];
    return fmaf(b, b, d2);
  }
  for (int k = 0; k < d; ++k) {
    const float diff = t.rx[k][i] - t.cx[k][j];
    d2 = fmaf(diff, diff, d2);
  }
  return d2;
}

// Passes 1 and 2 over rows < nrows and columns < ncols of the staged
// points (the rest are pad pairs): the tile holds x where a pair is to be
// evaluated and its k (0 or 1) elsewhere, the list the pairs to evaluate.
// Between the passes a pair that is not evaluated holds -1 - k, so that
// pass 2 reads each pair's bin back from its x. With UPPER, pair (i, j)
// is a pad pair too unless j - i > diag (the traces: diag = the tile's
// first row less its first column, so only the pairs above K's diagonal
// count). Returns, to every thread, whether any pair is nonzero. Starts
// and ends with a barrier.
template <bool UPPER = false, int RC, int NV>
__device__ bool tile_classify(TileSmem<RC, NV>& s, TilePoints& t, int nrows,
                              int ncols, int d, float skip2,
                              const MaternGeneralConsts& c, int diag = 0) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kBins) t.cursor[threadIdx.x] = 0;
  __syncthreads();
  bool any = false;
  for (int m = 0; m < kTilePairs / kTileThreads; ++m) {
    const int e = m * kTileThreads + threadIdx.x;
    const int i = e / kTileCols;
    const int j = e % kTileCols;
    int bin = kNoBin;
    float v = -1.0f;  // k = 0
    if (i < nrows && j < ncols && (!UPPER || j - i > diag)) {
      const float d2 = pair_d2(t, i, j, d);
      if (d2 == 0.0f) {
        v = -2.0f;  // k = 1
      } else if (!(d2 > skip2)) {
        v = sqrtf(d2);
        bin = k_bin(v, c);
      }
    }
    any = any || v != -1.0f;
    s.k[k_index(i, j)] = v;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin != kNoBin && lane == __ffs(peers) - 1) {
      atomicAdd(&t.cursor[bin], __popc(peers));
    }
  }
  any = __syncthreads_or(any) != 0;
  if (threadIdx.x == 0) {
    int total = 0;
    for (int b = 0; b < kBins; ++b) {
      const int count = t.cursor[b];
      t.cursor[b] = total;
      total += count;
    }
    t.listed = total;
  }
  __syncthreads();
  for (int m = 0; m < kTilePairs / kTileThreads; ++m) {
    const int e = m * kTileThreads + threadIdx.x;
    float* kp = s.k + k_index(e / kTileCols, e % kTileCols);
    const float v = *kp;
    int bin = kNoBin;
    if (v > 0.0f) {
      bin = k_bin(v, c);
    } else {
      *kp = -1.0f - v;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (bin != kNoBin && lane == leader) {
      base = atomicAdd(&t.cursor[bin], __popc(peers));
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    if (bin != kNoBin) {
      s.list[base + __popc(peers & ((1u << lane) - 1u))] =
          static_cast<uint16_t>(e);
    }
  }
  __syncthreads();
  return any;
}

// Pass 3: k of every listed pair in place of its x; with TAPER, k < tau
// is 0 (the hard taper of the tapered kernels). Ends with a barrier.
template <bool TAPER, int RC, int NV>
__device__ void tile_evaluate(TileSmem<RC, NV>& s, const TilePoints& t,
                              const MaternGeneralConsts& c, float tau) {
  for (int e = threadIdx.x; e < t.listed; e += kTileThreads) {
    const int p = s.list[e];
    float* kp = s.k + k_index(p / kTileCols, p % kTileCols);
    const float kv = matern_general(*kp, c);
    *kp = (!TAPER || kv >= tau) ? kv : 0.0f;
  }
  __syncthreads();
}

// The tile's k^2 in a fixed order: thread x sums pairs x, x + 256, ...
// of the row-major tile in float32 FMAs (0 for a pair not counted)
__device__ __forceinline__ float tile_sum_k2(const TraceTileSmem& s) {
  float part = 0.0f;
#pragma unroll 8
  for (int m = 0; m < kTilePairs / kTileThreads; ++m) {
    const int e = m * kTileThreads + threadIdx.x;
    const float kv = s.k[k_index(e / kTileCols, e % kTileCols)];
    part = fmaf(kv, kv, part);
  }
  return part;
}

// One k tile of a trace over the staged points (as tile_classify, UPPER,
// with skip2 and diag; with TAPER k < tau is 0): each thread's float32
// sum of k^2 over its fixed pairs, 0 where the tile has no nonzero pair
// (the sum of its zeros). Starts with a barrier; the caller may restage
// the points right after, not the tile.
template <bool TAPER>
__device__ __forceinline__ float tile_trace(TraceTileSmem& s, TilePoints& t,
                                            int nrows, int ncols, int d,
                                            float skip2, int diag,
                                            const MaternGeneralConsts& c,
                                            float tau) {
  if (!tile_classify<true>(s, t, nrows, ncols, d, skip2, c, diag)) {
    return 0.0f;
  }
  tile_evaluate<TAPER>(s, t, c, tau);
  return tile_sum_k2(s);
}

// Q consecutive floats of shared memory (aligned to 4 Q bytes) in one load
template <int Q>
__device__ __forceinline__ void load_q(const float* p, float (&v)[Q]) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int u = 0; u < Q; u += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + u);
      v[u] = w.x;
      v[u + 1] = w.y;
      v[u + 2] = w.z;
      v[u + 3] = w.w;
    }
  } else if constexpr (Q == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int u = 0; u < Q; ++u) v[u] = p[u];
  }
}

// The products' thread layouts: tile_times_v gives thread x rows
// x / 8 and x / 8 + 32 and columns (x % 8) RC / 8 + u, u < RC / 8;
// tile_t_times_v gives it tile columns x % 64 and x % 64 + 64 and columns
// (x / 64) RC / 4 + u, u < RC / 4: each V load serves two rows or
// columns, each k load RC / 8 or RC / 4 columns.
static_assert(kTileThreads == 256 && kTileRows == 64 && kTileCols == 128,
              "the products' thread layouts");

// acc[h][u] += sum_j K_t[x / 8 + 32 h, j] vc[j, q0 + u] in order of j (vc:
// kTileCols rows of RC floats), q0 = (x % 8) RC / 8, x = threadIdx.x
template <int RC>
__device__ __forceinline__ void tile_times_v(const float* __restrict__ k,
                                             const float* __restrict__ vc,
                                             float (&acc)[2][RC / 8]) {
  constexpr int Q = RC / 8;
  const int i = threadIdx.x / 8;
  const float* k0 = k + i * kTileCols;
  const float* k1 = k0 + 32 * kTileCols;
  const int swz = (i & 3) << 3;  // rows i and i + 32: the same permutation
  const float* v = vc + (threadIdx.x % 8) * Q;
#pragma unroll 4
  for (int j = 0; j < kTileCols; ++j) {
    const float a0 = k0[j ^ swz];
    const float a1 = k1[j ^ swz];
    float w[Q];
    load_q<Q>(v + j * RC, w);
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      acc[0][u] = fmaf(a0, w[u], acc[0][u]);
      acc[1][u] = fmaf(a1, w[u], acc[1][u]);
    }
  }
}

// acc[h][u] += sum_i K_t[i, x % 64 + 64 h] vr[i, q0 + u] in order of i
// (vr: kTileRows rows of RC floats), q0 = (x / 64) RC / 4
template <int RC>
__device__ __forceinline__ void tile_t_times_v(const float* __restrict__ k,
                                               const float* __restrict__ vr,
                                               float (&acc)[2][RC / 4]) {
  constexpr int Q = RC / 4;
  const int c = threadIdx.x % 64;
  const float* v = vr + (threadIdx.x / 64) * Q;
#pragma unroll 4
  for (int i = 0; i < kTileRows; ++i) {
    const float a0 = k[k_index(i, c)];
    const float a1 = k[k_index(i, c + 64)];
    float w[Q];
    load_q<Q>(v + i * RC, w);
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      acc[0][u] = fmaf(a0, w[u], acc[0][u]);
      acc[1][u] = fmaf(a1, w[u], acc[1][u]);
    }
  }
}

// rows [row0, row0 + count) of V (row stride ldv) into vs, kTileCols rows
// of RC floats, zero past count and past r
template <int RC>
__device__ __forceinline__ void stage_v(float* __restrict__ vs,
                                        const float* __restrict__ V,
                                        int64_t row0, int count, int r,
                                        int ldv) {
  for (int e = threadIdx.x; e < kTileCols * RC; e += kTileThreads) {
    const int j = e / RC;
    const int q = e % RC;
    vs[e] = (j < count && q < r) ? V[(row0 + j) * ldv + q] : 0.0f;
  }
}

// The smallest and largest of x[0 .. count) over the calling warp (+inf
// and -inf where count is 0), in every lane.
__device__ __forceinline__ void warp_bounds(const float* x, int count,
                                            float& lo, float& hi) {
  lo = kInf;
  hi = -kInf;
  for (int p = threadIdx.x & 31; p < count; p += 32) {
    lo = fminf(lo, x[p]);
    hi = fmaxf(hi, x[p]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

}  // namespace gppe
