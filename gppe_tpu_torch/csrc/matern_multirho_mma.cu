// Fused multi-rho Matern correlation matmat on the tensor cores, for Hopper
// (sm_90a):
//
//     out[b] = K(rho_b) @ V[b],   K(rho)[i, j] = k_nu(|x_i - x_j| / rho),
//
// at all three tile-dot precisions, one kernel template:
//   * 'highest' (3xTF32): k and V split into a tf32 high part and the tf32
//     rounding of the residual, k_hi v_hi + k_lo v_hi + k_hi v_lo (only
//     lo*lo, about 2^-22 relative, is dropped), k from the IEEE sqrt and
//     expf: the exact mode, at float32 grade;
//   * 'bf16x3': both operands split into a bfloat16 high part and the
//     bfloat16 rounding of the residual, the same three products;
//   * 'bf16': K and V rounded to bfloat16.
// All take float32 sums. x (n, d) are the raw (unscaled) points, inv_rho
// (B,) the float32 1 / rho_b, V and out (B, n, r) row-major, all float32 in
// device memory. No K(rho_b) is ever stored, in any precision.
//
// Replaces gppe_tpu/ops/pallas_kernels.py::_multirho_kernel with its tile
// dot ::_tile_dot in every mode. Every trace(K_b^2) stays in
// matern_multirho.cu (it sums the unrounded k^2). It keeps that kernel's
// order of work: d^2 by differences on the raw points, one sqrt, then per
// rho one multiply by a factor of 1 / rho_b and the closed form from the
// distance.
//
// 'highest' keeps the exact kernel's k bit for bit: the correctly rounded
// sqrt (sqrt_rn_nonneg, matern_mma.cuh), then per rho the multiply by the
// float32 1 / rho_b and matern_from_r with IEEE expf. The bf16 modes take
// sqrt.approx and ex2.approx, the bare SFU results (matern_approx in
// matern_mma.cuh; each within 2^-22 relative; for nu = 1/2 log2(e) / rho_b
// is folded into the one multiply): k is rounded to bf16 parts right away
// and the error is 20 times under what the 'bf16x3' split costs. With the
// IEEE routines, 4 rhos per block and unpaired conversions the 'bf16x3'
// kernel took 122.1 ms where that design took 104.3 with the
// approximations, and 67.5 as it is now (n = 10^5, B = 8, r = 16; NVIDIA
// H100 80GB HBM3, 700 W, all in one run).
//
// What bounds it on this card. Per pair one distance and one sqrt, and per
// pair and rho one multiply, one exp and the rounding or split of k, on the
// CUDA cores and the SFU. The r multiply-adds per pair and rho go to the
// tensor cores: 2 n^2 B r bf16 operations, three times that under 'bf16x3'
// and as tf32 under 'highest'. Traffic is O(B n r) words. The bf16 modes
// are held by the SFU: it retires 16 results per clock and SM, so a warp's
// 16 sqrt and 32 exp2 per 16-column step hold it for 384 clocks, against
// about 290 scheduler slots for all the warp's instructions; that alone is
// 32 ms at the grid path's shape. 'highest' is held by instruction issue:
// the IEEE expf is eight or so instructions around its MUFU, the split
// five, the sqrt six, and the tf32 products take six m16n8k8 mma per 16
// columns, rho and n8 tile. Probes at the grid path's shape, each one
// change timed in turns with the kernel (115.5 ms then, V staged per
// block): k from the SFU approximations 95.8 ms, the hi*hi product alone
// 92.5, V staged for the first tile only 92.9, the residual left for the
// tensor core to truncate 112.8. So IEEE k, the two small products and
// staging V cost a sixth to a fifth each; the pre-pass below took the
// kernel to 100.3 with the same bits.
//
// What the design does about it:
//   * the product is mma.sync, and a thread computes exactly the K entries
//     its own A fragments hold (matern_mma.cuh), as in
//     matern_matmat_mma.cu: K never passes through shared memory. The bf16
//     modes take m16n8k16, 'highest' two m16n8k8 tf32 steps per 16 columns
//     with the depth permuted as in matern_matmat_mma.cu, so a thread owns
//     the same K entries in every mode;
//   * per 16-column step a thread computes the distance and the sqrt of
//     its rows x 4 columns ONCE and then walks the block's BT rhos: scale,
//     closed form, split or round and pack, and the n8 products into that
//     rho's tile accumulators;
//   * a block owns 128 rows and BT rhos; a warp owns MT m16 tiles (16 MT
//     rows), so a B fragment read from shared memory serves MT products.
//     In the bf16 modes, at r <= 16 (NT = 2 n8 tiles; the grid engine's
//     block) BT = 2 and MT = 2: 32 tile sums and 32 running sums per
//     thread, the footprint of matern_matmat_mma.cu, 122-127 registers, 4
//     blocks of 4 warps per SM. Timed in one run at the grid path's shape,
//     'bf16x3' / 'bf16': BT = 4, MT = 1 (a distance shared by 4 rhos, 8
//     warps, 2 blocks per SM) 96.3 / 53.5 ms; BT = 2, MT = 1 80.3 / 64.3
//     ms, and 71.3 / 55.6 ms held to 80 registers for 3 blocks per SM;
//     BT = 2, MT = 2 67.5 / 54.0 ms. Sharing a B fragment and keeping the
//     occupancy buy more than sharing a distance further: the distance and
//     sqrt are computed B / 2 times per pair. r <= 8 takes BT = 4, MT = 2
//     and r in (16, 24] BT = 2, MT = 1 with NT = 3, each the same count of
//     sums;
//   * 'highest' holds twice the tile sums (the small terms lo*hi and hi*lo
//     apart from hi*hi, as in matern_matmat_mma.cu) and a compensation term
//     beside each running sum, so it takes half the sums: BT = 2, MT = 1
//     at r <= 16 (8 warps, 2 blocks per SM, 116-121 registers), BT = 4,
//     MT = 1 at r <= 8 and BT = 1, MT = 1, NT = 3 at r in (16, 24]. At
//     the grid path's shape BT = 2, MT = 2 at 3 blocks per SM took 116.1
//     ms against 115.0 and BT = 1, MT = 2 130.4 (V staged per block);
//   * V is staged per rho, transposed, and pre-split into high and
//     residual arrays (row stride kLdV, conflict-free B loads). The bf16
//     modes stage it per block and tile (26 KB of static shared memory
//     with the points at NT = 2). Under 'highest' a pre-pass splits V once
//     per launch into the tiles' images in tf32 bit patterns, and the
//     tiles' points beside them, in a scratch buffer the caller allocates
//     (110 MB at n = 10^5, B = 8, r = 16); a block copies each tile's
//     images with cp.async, 16 bytes a thread, into a two-stage ring of
//     dynamic shared memory (70 KB at BT = 2, NT = 2, d = 2): the copy of
//     tile t + 1 overlaps the products of tile t, as in
//     matern_matmat_mma.cu;
//   * V columns are taken 8, 16 or 24 at a time (r = 24 costs 3 n8 tiles);
//     wider V is split into 16-column chunks over grid.y, each recomputing
//     K;
//   * accumulation: a column tile's products (8 steps) are summed in fresh
//     accumulator fragments, which are then added to running float32 sums
//     in ordinary registers (tensor-core accumulators do not round to
//     nearest), the two-level sum of matern_matmat_mma.cu. Under 'highest'
//     that fold is Kahan-compensated: at the grid path's largest rho K is
//     nearly dense, the row sums reach 268, and a plain float32 sum of
//     n / 128 = 782 tile sums carried 6.4e-4 of max-abs error against
//     float64 (over the grid path's 8 rhos, n = 10^5; bound 5e-4), the
//     compensated one 1.5e-4 and 3.7e-7 Frobenius, float64 running sums
//     the same at 128.8 ms against 115.0 (V staged per block). Folding
//     every 32 columns instead of every 128 halves the error (7.4e-5,
//     1.7e-7) and cuts the tensor core's truncation bias, which moves the
//     grid path's eta* by up to 2.7e-3 from that of float64 products at
//     the larger rhos (6.8e-4 folding every 32), for 9.6% more time (108.6
//     ms against 99.1); every 16 columns 111.2 ms and 1.7e-3;
//   * ragged edges are masked: a column past n is staged with zero
//     coordinates and v = 0 and adds nothing, rows past n are computed and
//     not written, and a rho past B is skipped.
// Times: n = 10^5, B = 8, r = 16, nu = 1/2; NVIDIA H100 80GB HBM3 at 700
// W; the variants timed in turns in one run (chip_profile.py variants,
// copies of this source with one change each). The kernel took 98.5 ms
// under 'highest' where the FP32 kernel it replaced took 142.6, in turns
// in one run (chip_profile.py modes).
// Not yet used: wgmma, TMA, the pre-pass for the bf16 modes (V staged for
// the first tile only took 'bf16x3' from 67.4 to 48.6 ms), part of the
// exp2 as a polynomial on the FMA pipe; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"

using namespace gppe;

namespace {

constexpr int kRows = 128;                 // output rows per block
constexpr int kCols = kMmaCols;            // column points per staged tile
constexpr int kStep = kMmaStep;            // depth of one bf16 mma
constexpr int kChunkNT = 2;                // n8 tiles per chunk of a wide V
constexpr int kPrepThreads = 256;

// Bytes of the image of one column tile of one rho's V under 'highest':
// its tf32 high parts [kRC][kLdV], then its residuals.
template <int NT>
__host__ __device__ constexpr int image_bytes() {
  return 2 * NT * 8 * kLdV * 4;
}

// The pre-pass under 'highest', grid (tiles, chunks, B): V[b]'s columns
// c0 .. c0 + 8 NT of column tile t, split into tf32 high and residual
// parts and transposed into rows of kLdV values, zeros past n and r;
// blocks (t, 0, 0) also write tile t's column points dimension-major,
// zeros past n. `images` (B, chunks, tiles) images, `cols` (tiles, d,
// kCols): what a block copies into shared memory, once for every block.
template <int NT>
__global__ void __launch_bounds__(kPrepThreads)
    stage_images_kernel(const float* __restrict__ pts,
                        const float* __restrict__ V,
                        unsigned char* __restrict__ images,
                        float* __restrict__ cols, int n, int d, int r,
                        int tiles) {
  constexpr int kRC = NT * 8;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * kRC;
  const int b = blockIdx.z;
  const int j0 = t * kCols;
  const int tc = min(kCols, n - j0);
  uint32_t* vhi = reinterpret_cast<uint32_t*>(
      images +
      ((static_cast<int64_t>(b) * gridDim.y + blockIdx.y) * tiles + t) *
          image_bytes<NT>());
  for (int e = threadIdx.x; e < kRC * kLdV; e += kPrepThreads) {
    const int c = e / kLdV;
    const int j = e % kLdV;
    const float v =
        (j < tc && c0 + c < r)
            ? V[(static_cast<int64_t>(b) * n + j0 + j) * r + c0 + c]
            : 0.0f;
    split_tf32(v, vhi[e], vhi[kRC * kLdV + e]);
  }
  if (blockIdx.y == 0 && b == 0) {
    float* out = cols + static_cast<int64_t>(t) * d * kCols;
    for (int e = threadIdx.x; e < d * kCols; e += kPrepThreads) {
      const int k = e / kCols;
      const int j = e % kCols;
      out[e] = j < tc ? pts[static_cast<int64_t>(j0 + j) * d + k] : 0.0f;
    }
  }
}

// Starts the copies of column tile t into `stage`: the images of the
// block's rhos (those past B skipped), then the tile's points; 16 bytes a
// thread.
template <int NT, int BT>
__device__ __forceinline__ void copy_tile(unsigned char* stage,
                                          const unsigned char* images,
                                          const float* cols, int b0, int B,
                                          int chunk, int chunks, int tiles,
                                          int t, int d, int threads) {
  for (int u = 0; u < BT && b0 + u < B; ++u) {
    const unsigned char* src =
        images +
        ((static_cast<int64_t>(b0 + u) * chunks + chunk) * tiles + t) *
            image_bytes<NT>();
    for (int o = 16 * threadIdx.x; o < image_bytes<NT>(); o += 16 * threads) {
      cp_async16(stage + u * image_bytes<NT>() + o, src + o);
    }
  }
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      cols + static_cast<int64_t>(t) * d * kCols);
  for (int o = 16 * threadIdx.x; o < 4 * d * kCols; o += 16 * threads) {
    cp_async16(stage + BT * image_bytes<NT>() + o, src + o);
  }
}

// FMT: the dot code. NT: n8 tiles of V columns per block. BT: rhos per
// block. MT: m16 tiles (16 rows) per warp; a block has 8 / MT warps.
// grid.x: row blocks; grid.y: rho group * column chunks + column chunk.
// Under 'highest', `images` and `cols` are the pre-pass's output and the
// dynamic shared memory holds two stages of BT images and d * kCols
// points; the bf16 modes stage V from `V` themselves.
template <int NU, int FMT, int NT, int BT, int MT>
__global__ void __launch_bounds__(kRows / (16 * MT) * 32, 2 * MT)
    multirho_mma_kernel(const float* __restrict__ pts,
                        const float* __restrict__ inv_rho,
                        const float* __restrict__ V,
                        const unsigned char* __restrict__ images,
                        const float* __restrict__ cols,
                        float* __restrict__ out, int n, int d, int B, int r) {
  constexpr int kRC = NT * 8;
  constexpr int kWarpRows = 16 * MT;
  constexpr int kThreads = kRows / kWarpRows * 32;
  constexpr bool kExact = FMT == kDotHighest;
  constexpr bool X3 = FMT == kDotBf16x3;
  // the bf16 modes' staging (one element under 'highest')
  constexpr bool kStaged = !kExact;
  __shared__ float s_rows[kMaxD][kRows];
  __shared__ __align__(8) float s_cols[kStaged ? kMaxD : 1]
                                      [kStaged ? kCols : 1];
  __shared__ __align__(16) uint16_t s_vhi[kStaged ? BT : 1]
                                         [kStaged ? kRC : 1]
                                         [kStaged ? kLdV : 2];
  __shared__ __align__(16)
      uint16_t s_vlo[X3 ? BT : 1][X3 ? kRC : 1][X3 ? kLdV : 2];
  extern __shared__ __align__(16) unsigned char ring[];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in group: the fragment's column pair
  const int wrow = (threadIdx.x >> 5) * kWarpRows;  // warp's first row
  const int row0 = blockIdx.x * kRows;
  const int chunks = (r + kRC - 1) / kRC;
  const int b0 = (blockIdx.y / chunks) * BT;
  const int chunk = blockIdx.y % chunks;
  const int c0 = chunk * kRC;
  const int tiles = (n + kCols - 1) / kCols;
  const int stage_bytes = BT * image_bytes<NT>() + 4 * d * kCols;

  // the block's row points, dimension-major; rows past n are zeros
  for (int e = threadIdx.x; e < d * kRows; e += kThreads) {
    const int k = e / kRows;
    const int i = e % kRows;
    s_rows[k][i] =
        row0 + i < n ? pts[static_cast<int64_t>(row0 + i) * d + k] : 0.0f;
  }
  // what rho_t contributes to the closed form: under 'highest' the float32
  // 1 / rho_t itself, else its rho_weight
  float w[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    const float inv = b0 + t < B ? inv_rho[b0 + t] : 0.0f;
    w[t] = kExact ? inv : rho_weight<NU>(inv);
  }

  // acc[rho][m16 tile * NT + n8 tile][fragment element]: the running sums,
  // and under 'highest' their Kahan compensation terms
  float acc[BT][MT * NT][4], comp[kExact ? BT : 1][MT * NT][4];
#pragma unroll
  for (int t = 0; t < BT; ++t) {
#pragma unroll
    for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[t][q][i] = 0.0f;
        if constexpr (kExact) comp[t][q][i] = 0.0f;
      }
    }
  }

  if constexpr (kExact) {
    copy_tile<NT, BT>(ring, images, cols, b0, B, chunk, chunks, tiles, 0, d,
                      kThreads);
    cp_async_commit();
  }
  for (int j0 = 0; j0 < n; j0 += kCols) {
    const int tc = min(kCols, n - j0);
    // under 'highest' the tile's images and points are in a stage of the
    // ring; the copy of the next tile goes into the other stage, which
    // every warp left at the end of the previous iteration. The bf16 modes
    // stage the tile here.
    const unsigned char* stage = ring;
    if constexpr (kExact) {
      const int tile = j0 / kCols;
      stage = ring + (tile & 1) * stage_bytes;
      if (tile + 1 < tiles) {
        copy_tile<NT, BT>(ring + ((tile + 1) & 1) * stage_bytes, images,
                          cols, b0, B, chunk, chunks, tiles, tile + 1, d,
                          kThreads);
      }
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
    } else {
      __syncthreads();  // every warp is done with the previous tile
      for (int e = threadIdx.x; e < d * kCols; e += kThreads) {
        const int k = e / kCols;
        const int j = e % kCols;
        s_cols[k][j] =
            j < tc ? pts[static_cast<int64_t>(j0 + j) * d + k] : 0.0f;
      }
      for (int e = threadIdx.x; e < BT * kCols * kRC; e += kThreads) {
        const int c = e % kRC;
        const int j = (e / kRC) % kCols;
        const int t = e / (kRC * kCols);
        const float v =
            (j < tc && c0 + c < r && b0 + t < B)
                ? V[(static_cast<int64_t>(b0 + t) * n + j0 + j) * r + c0 + c]
                : 0.0f;
        stage_split<X3>(v, s_vhi[t][c][j],
                        s_vlo[X3 ? t : 0][X3 ? c : 0][X3 ? j : 0]);
      }
      __syncthreads();
    }

    // this tile's products, in fresh accumulators: under 'highest' the
    // hi*hi terms, and the small terms apart
    float part[BT][MT * NT][4], part_lo[kExact ? BT : 1][MT * NT][4];
#pragma unroll
    for (int t = 0; t < BT; ++t) {
#pragma unroll
      for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[t][q][i] = 0.0f;
          if constexpr (kExact) part_lo[t][q][i] = 0.0f;
        }
      }
    }

    for (int kk = 0; kk < tc; kk += kStep) {
      // the thread's 2 MT rows (m16 tile mt, half h: row wrow + 16 mt + 8 h
      // + g) x 4 columns (kk + 2 tig, + 1, + 8, + 9): the unscaled
      // distances, once for every rho of the block
      float r0[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 4; ++c) r0[mt][h][c] = 0.0f;
        }
      }
      for (int k = 0; k < d; ++k) {
        // the column points of dimension k
        const float* yk;
        if constexpr (kExact) {
          yk = reinterpret_cast<const float*>(stage + BT * image_bytes<NT>()) +
               k * kCols;
        } else {
          yk = s_cols[k];
        }
        const float2 ya = *reinterpret_cast<const float2*>(yk + kk + 2 * tig);
        const float2 yb =
            *reinterpret_cast<const float2*>(yk + kk + 8 + 2 * tig);
        const float y[4] = {ya.x, ya.y, yb.x, yb.y};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = s_rows[k][wrow + 16 * mt + 8 * h + g];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float diff = x - y[c];
              r0[mt][h][c] = fmaf(diff, diff, r0[mt][h][c]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (kExact) {
              r0[mt][h][c] = sqrt_rn_nonneg(r0[mt][h][c]);
            } else {
              r0[mt][h][c] = sqrt_approx(r0[mt][h][c]);
            }
          }
        }
      }

#pragma unroll
      for (int t = 0; t < BT; ++t) {
        if (b0 + t >= B) continue;  // the same for every thread of the block
        if constexpr (kExact) {
          // two m16n8k8 steps: columns kk + 8 s + 2 tig and + 1 at the
          // depths tig and tig + 4
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                split_tf32(matern_from_r<NU>(r0[mt][h][2 * s] * w[t]),
                           a_hi[mt][h], a_lo[mt][h]);
                split_tf32(matern_from_r<NU>(r0[mt][h][2 * s + 1] * w[t]),
                           a_hi[mt][2 + h], a_lo[mt][2 + h]);
              }
            }
            // rho t's image: tf32 high parts, then residuals
            const uint32_t* vhi = reinterpret_cast<const uint32_t*>(
                stage + t * image_bytes<NT>());
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const Tf32B b = load_b_tf32(vhi + (nt * 8 + g) * kLdV,
                                          vhi + (kRC + nt * 8 + g) * kLdV,
                                          kk + 8 * s, tig);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const int q = mt * NT + nt;
                mma_tf32(part[t][q], a_hi[mt], b.h0, b.h1);
                mma_tf32(part_lo[t][q], a_lo[mt], b.h0, b.h1);
                mma_tf32(part_lo[t][q], a_hi[mt], b.l0, b.l1);
              }
            }
          }
        } else {
          // k(rho_t), rounded, into the A fragments
          uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float kv[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                kv[c] = matern_approx<NU>(r0[mt][h][c], w[t]);
              }
              pack_pair<X3>(kv[0], kv[1], a_hi[mt][h], a_lo[mt][h]);
              pack_pair<X3>(kv[2], kv[3], a_hi[mt][2 + h], a_lo[mt][2 + h]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const BFragment b =
                load_b<X3>(s_vhi[t][nt * 8 + g],
                           s_vlo[X3 ? t : 0][X3 ? nt * 8 + g : 0], kk, tig);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_tile_dot<X3>(part[t][mt * NT + nt], a_hi[mt], a_lo[mt], b);
            }
          }
        }
      }
    }

#pragma unroll
    for (int t = 0; t < BT; ++t) {
#pragma unroll
      for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kExact) {
            // acc - comp holds the sum to about one float32 rounding
            const float y =
                (part[t][q][i] + part_lo[t][q][i]) - comp[t][q][i];
            const float sum = acc[t][q][i] + y;
            comp[t][q][i] = (sum - acc[t][q][i]) - y;
            acc[t][q][i] = sum;
          } else {
            acc[t][q][i] += part[t][q][i];
          }
        }
      }
    }
    if constexpr (kExact) __syncthreads();  // every warp is done with stage
  }

  // fragment element i: row g (+ 8 for i >= 2), column 2 tig + (i & 1)
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    if (b0 + t >= B) continue;
#pragma unroll
    for (int q = 0; q < MT * NT; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + wrow + 16 * (q / NT) + 8 * (i >> 1) + g;
        const int col = c0 + (q % NT) * 8 + 2 * tig + (i & 1);
        if (row < n && col < r) {
          float sum = acc[t][q][i];
          if constexpr (kExact) sum -= comp[t][q][i];
          out[(static_cast<int64_t>(b0 + t) * n + row) * r + col] = sum;
        }
      }
    }
  }
}

struct Args {
  const float* pts;
  const float* inv_rho;
  const float* V;
  float* out;
  unsigned char* scratch;
  int n, d, B, r;
  cudaStream_t stream;
};

// n8 tiles per block under 'highest', by width (see launch_nt)
int highest_nt(int r) {
  return r <= 8 ? 1 : (r > 16 && r <= 24) ? 3 : kChunkNT;
}

// Bytes of the pre-pass's output under 'highest': the images of every
// rho, chunk and column tile, then every tile's points.
template <int NT>
int64_t scratch_bytes(int n, int d, int B, int r) {
  const int64_t tiles = (n + kCols - 1) / kCols;
  const int64_t chunks = (r + NT * 8 - 1) / (NT * 8);
  return B * chunks * tiles * image_bytes<NT>() + tiles * d * kCols * 4;
}

template <int NU, int FMT, int NT, int BT, int MT>
cudaError_t launch(const Args& a) {
  constexpr int kThreads = kRows / (16 * MT) * 32;
  const int chunks = (a.r + NT * 8 - 1) / (NT * 8);
  const int tiles = (a.n + kCols - 1) / kCols;
  const int64_t grid_y = static_cast<int64_t>((a.B + BT - 1) / BT) * chunks;
  if (grid_y > 65535 || (FMT == kDotHighest && a.B > 65535)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((a.n + kRows - 1) / kRows, static_cast<unsigned>(grid_y));
  auto* kernel = multirho_mma_kernel<NU, FMT, NT, BT, MT>;
  int ring_bytes = 0;
  unsigned char* images = nullptr;
  float* cols = nullptr;
  if constexpr (FMT == kDotHighest) {
    images = a.scratch;
    cols = reinterpret_cast<float*>(
        a.scratch + static_cast<int64_t>(a.B) * chunks * tiles *
                        image_bytes<NT>());
    stage_images_kernel<NT><<<dim3(tiles, chunks, a.B), kPrepThreads, 0,
                              a.stream>>>(a.pts, a.V, images, cols, a.n, a.d,
                                          a.r, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ring_bytes = 2 * (BT * image_bytes<NT>() + 4 * a.d * kCols);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, ring_bytes, a.stream>>>(
      a.pts, a.inv_rho, a.V, images, cols, a.out, a.n, a.d, a.B, a.r);
  return cudaGetLastError();
}

template <int NU, int FMT>
cudaError_t launch_nt(const Args& a) {
  // <NT, BT, MT>: BT * MT * NT = 8 or 6 sets of sums in the bf16 modes,
  // 4 or 3 under 'highest' (see the header)
  if constexpr (FMT == kDotHighest) {
    switch (highest_nt(a.r)) {
      case 1: return launch<NU, FMT, 1, 4, 1>(a);
      case 3: return launch<NU, FMT, 3, 1, 1>(a);
      default: return launch<NU, FMT, kChunkNT, 2, 1>(a);
    }
  } else {
    if (a.r <= 8) return launch<NU, FMT, 1, 4, 2>(a);
    if (a.r > 16 && a.r <= 24) return launch<NU, FMT, 3, 2, 1>(a);
    return launch<NU, FMT, kChunkNT, 2, 2>(a);
  }
}

template <int NU>
cudaError_t launch_mode(const Args& a, int dot_code) {
  switch (dot_code) {
    case kDotHighest: return launch_nt<NU, kDotHighest>(a);
    case kDotBf16x3: return launch_nt<NU, kDotBf16x3>(a);
    default: return launch_nt<NU, kDotBf16>(a);
  }
}

bool valid_mode(int dot_code) {
  return dot_code == kDotHighest || dot_code == kDotBf16x3 ||
         dot_code == kDotBf16;
}

}  // namespace

// Bytes of scratch the product needs: the pre-pass's output under
// 'highest', none in the bf16 modes. -1 on arguments the product does not
// take.
extern "C" int64_t gppe_matern_multirho_mma_scratch_bytes(int n, int d, int B,
                                                          int r,
                                                          int dot_code) {
  if (n < 0 || d < 1 || d > kMaxD || B < 1 || r < 1 ||
      !valid_mode(dot_code)) {
    return -1;
  }
  if (dot_code != kDotHighest) return 0;
  switch (highest_nt(r)) {
    case 1: return scratch_bytes<1>(n, d, B, r);
    case 3: return scratch_bytes<3>(n, d, B, r);
    default: return scratch_bytes<kChunkNT>(n, d, B, r);
  }
}

// Launches on `stream` (under 'highest' the pre-pass, then the product)
// and returns the first error of cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing: `scratch` holds
// gppe_matern_multirho_mma_scratch_bytes bytes, 16-byte aligned (null when
// that is 0), and must live until the product has run. `inv_rho` holds B
// float32 values 1/rho_b; `dot_code` is kDotHighest, kDotBf16x3 or
// kDotBf16; r >= 1.
extern "C" int gppe_matern_multirho_mma(const void* pts, const void* inv_rho,
                                        const void* V, void* out,
                                        void* scratch, int n, int d, int B,
                                        int r, int nu_code, int dot_code,
                                        void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || B <= 0 || r < 1 ||
      !valid_mode(dot_code) ||
      (dot_code == kDotHighest && scratch == nullptr) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(pts),
               static_cast<const float*>(inv_rho),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               static_cast<unsigned char*>(scratch),
               n,
               d,
               B,
               r,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (nu_code) {
    case kNuHalf: err = launch_mode<kNuHalf>(a, dot_code); break;
    case kNuThreeHalf: err = launch_mode<kNuThreeHalf>(a, dot_code); break;
    case kNuFiveHalf: err = launch_mode<kNuFiveHalf>(a, dot_code); break;
    case kNuGauss: err = launch_mode<kNuGauss>(a, dot_code); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
