// Fused Matern correlation matmat on the tensor cores, for Hopper (sm_90a):
//
//     out = K @ V,   K[i, j] = k_nu(|x_i - y_j|),
//
// at all three tile-dot precisions, one kernel template:
//   * 'highest' (3xTF32): k and V split into a tf32 high part and the tf32
//     rounding of the residual, k_hi v_hi + k_lo v_hi + k_hi v_lo with
//     float32 sums (only lo*lo, about 2^-22 relative, is dropped), k from
//     the IEEE sqrtf and expf: the exact mode, at float32 grade;
//   * 'bf16x3': the same split into bfloat16 parts (about 5e-6 of relative
//     error), k from sqrt.approx / ex2.approx (matern_mma.cuh);
//   * 'bf16': k and V rounded to bfloat16, float32 sums.
// x (nr, d), y (nc, d): row and column points already divided by the
// correlation scale; V (nc, r), out (nr, r) row-major; all float32 in
// device memory. K is never stored, in any precision.
//
// Replaces gppe_tpu/ops/pallas_kernels.py::_matmat_kernel with its tile dot
// ::_tile_dot in every mode and, with the Gram distance form, inside
// ::_matmat_kernel_gram (squared distance |x|^2 + |y|^2 - 2 x.y clamped at
// 0, on points the caller centred and with the norms the caller computed;
// the d <= 8 contraction is d float32 FMAs on the CUDA cores). Every
// trace(K^2) pass stays in matern_matmat.cu (it sums the unrounded k^2).
//
// What bounds it on this card. Per pair (i, j): the distance and k on the
// CUDA cores and the SFU, and the split of k into the A fragments; the r
// multiply-adds per pair go to the tensor cores, 2 n^2 r x 3 tf32 (or bf16)
// operations. Device-memory traffic is O(n (d + r)) words. So the kernel is
// bound by the instructions that produce K and by the tensor pipe:
// 'highest' issues about 25 instructions per pair (distance 4, sqrt 5,
// expf 8, the split 5) and 6 m16n8k8 mma per 16 pairs and thread, which
// mma.sync runs well below the card's tf32 peak (one product instead of
// three took 3.8 of 13.7 ms off); the bf16 modes are held by the SFU and
// the conversion pipe (two MUFU and one or half a bf16 conversion per
// pair).
//
// What the design does about it:
//   * a thread computes exactly the K entries its own A fragments hold (two
//     rows x four columns of each 16-column step and m16 tile), splits or
//     rounds them and packs them in registers: K never passes through
//     shared memory and a warp needs no barrier between computing K and
//     multiplying it. 'highest' takes two m16n8k8 tf32 steps per 16
//     columns, with the depth permuted so a thread owns the same entries
//     as in the bf16 m16n8k16 step (matern_mma.cuh);
//   * 'highest' keeps IEEE k, bit for bit, at a third of its cost: the
//     correctly rounded sqrt without the branch nvcc wraps it in (that
//     branch kept a thread's 16 sqrts from overlapping: 19.4 ms with it,
//     13.7 without) and the tf32 rounding of k in two integer operations
//     (15.3 ms as cvt.rna); matern_mma.cuh says why both keep the bits;
//   * a block of 4 warps owns 128 rows, 32 per warp (two m16 tiles, so a B
//     fragment serves two products), and walks the columns in tiles of 128
//     points;
//   * V is split once per launch: a pre-pass kernel writes, for every
//     column tile, the tile's image in shared memory - V's high and
//     residual parts transposed into rows of kLdV values, the column points
//     dimension-major, their norms for the Gram form, zeros past nc - into
//     a scratch buffer the caller allocates. A block then copies each image
//     with cp.async, 16 bytes a thread, into a two-stage ring: the copy of
//     tile t + 1 overlaps the products of tile t;
//   * d = 2 (the engines' points) keeps the thread's row coordinates in
//     registers for the whole launch; the Gram form and other d keep a
//     run-time loop over staged coordinates;
//   * 'highest' sums the small terms (lo*hi and hi*lo) in accumulators of
//     their own, folded in once per tile: the tensor core's truncating
//     accumulation touches the large hi*hi sum a third as often. One
//     accumulator gave 1.1e-6 Frobenius and 3.6e-4 max-abs against
//     float64 at n = 10^5, two give 6.6e-7 and 2.9e-4, at the same speed
//     (13.9 and 13.7 ms).
//     'bf16x3' keeps one, the sums of matern_multirho_mma.cu, which it
//     agrees with to a quarter of the mode's own error;
//   * accumulation: tensor-core accumulators do not round to nearest, so
//     one column tile's products are summed in fresh accumulator fragments,
//     which are then added to running float32 sums in ordinary registers;
//   * 4 blocks per SM (registers held to 128): 3 per SM, whose 396 slots
//     take the 782 blocks of n = 10^5 in 1.97 waves instead of 1.48, was
//     not faster (14.0 / 8.4 / 6.7 ms against 13.7 / 7.9 / 6.7): the
//     blocks of the last wave run faster for sharing their SM with fewer;
//   * V is taken 8, 16, 24 or 32 columns at a time (NT n8 tiles: the
//     engine's r = 24 is 3 x 8, no padded column); wider V is split into
//     32-column chunks over grid.y, and each chunk recomputes K;
//   * ragged edges are masked, not padded with far points: a column past
//     nc is staged with zero coordinates, so its k is finite, and with
//     v = 0, so it adds nothing; rows past nr are computed and not written.
// Times: n = 10^5, r = 24, nu = 1/2, in the order 'highest' / 'bf16x3' /
// 'bf16', the versions timed in turns in one run on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_profile.py variants, copies of this source with one
// change each).
// Splitting V makes the map V -> K V not exactly linear: u.Kv and v.Ku
// differ at the 1e-8 level under 'highest', 1e-7 under 'bf16x3'.
// Not yet used: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "matern_common.cuh"
#include "matern_mma.cuh"

using namespace gppe;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 32;              // two m16 tiles per warp
constexpr int kRows = kWarps * kWarpRows;  // output rows per block
constexpr int kCols = kMmaCols;            // column points per staged tile
constexpr int kStep = kMmaStep;            // column points per step
constexpr int kMaxNT = 4;                  // n8 tiles per block: 32 V columns
constexpr int kMinBlocks = 4;              // blocks per SM (see the header)
constexpr int kPrepThreads = 256;

// the distance forms: d = 2 with the row coordinates in registers, any
// d <= 8 over staged coordinates, and the Gram form (any d)
constexpr int kDiff2 = 0;
constexpr int kDiffAny = 1;
constexpr int kGram = 2;

template <int FMT>
__host__ __device__ constexpr bool split_format() {
  return FMT != kDotBf16;
}

// bytes of one staged V value: tf32 bits under 'highest', else bf16 bits
template <int FMT>
__host__ __device__ constexpr int v_bytes() {
  return FMT == kDotHighest ? 4 : 2;
}

// The image of one column tile, in shared memory and in the scratch buffer
// alike: V's high parts [kRC][kLdV], its residuals (split formats), the
// column points [d][kCols], their norms [kCols] (Gram form). Every part is
// a multiple of 16 bytes.
template <int FMT, int NT>
__host__ __device__ constexpr int v_part_bytes() {
  return NT * 8 * kLdV * v_bytes<FMT>();
}

template <int FMT, int NT>
int image_bytes(int d, bool gram) {
  return v_part_bytes<FMT, NT>() * (split_format<FMT>() ? 2 : 1) +
         4 * kCols * (d + (gram ? 1 : 0));
}

// One column tile's image per block, grid (tiles, chunks): V's columns
// c0 .. c0 + 8 NT of chunk blockIdx.y, split or rounded once for every
// block of the product kernel.
template <int FMT, int NT, bool GRAM>
__global__ void __launch_bounds__(kPrepThreads)
    stage_images_kernel(const float* __restrict__ cols,
                        const float* __restrict__ cols_norm,
                        const float* __restrict__ V,
                        unsigned char* __restrict__ images, int nc, int d,
                        int r, int tiles, int bytes) {
  constexpr int kRC = NT * 8;
  const int j0 = blockIdx.x * kCols;
  const int c0 = blockIdx.y * kRC;
  const int tc = min(kCols, nc - j0);
  unsigned char* img =
      images + (static_cast<int64_t>(blockIdx.y) * tiles + blockIdx.x) * bytes;
  for (int e = threadIdx.x; e < kRC * kLdV; e += kPrepThreads) {
    const int c = e / kLdV;
    const int j = e % kLdV;
    const float v = (j < tc && c0 + c < r)
                        ? V[static_cast<int64_t>(j0 + j) * r + c0 + c]
                        : 0.0f;
    if constexpr (FMT == kDotHighest) {
      uint32_t* vhi = reinterpret_cast<uint32_t*>(img);
      split_tf32(v, vhi[e], vhi[kRC * kLdV + e]);
    } else {
      uint16_t* vhi = reinterpret_cast<uint16_t*>(img);
      uint16_t lo = 0;
      stage_split<FMT == kDotBf16x3>(v, vhi[e], lo);
      if constexpr (FMT == kDotBf16x3) vhi[kRC * kLdV + e] = lo;
    }
  }
  float* pts = reinterpret_cast<float*>(
      img + v_part_bytes<FMT, NT>() * (split_format<FMT>() ? 2 : 1));
  for (int e = threadIdx.x; e < d * kCols; e += kPrepThreads) {
    const int k = e / kCols;
    const int j = e % kCols;
    pts[e] = j < tc ? cols[static_cast<int64_t>(j0 + j) * d + k] : 0.0f;
  }
  if constexpr (GRAM) {
    for (int j = threadIdx.x; j < kCols; j += kPrepThreads) {
      pts[d * kCols + j] = j < tc ? cols_norm[j0 + j] : 0.0f;
    }
  }
}

__device__ __forceinline__ void copy_image(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  for (int o = 16 * threadIdx.x; o < bytes; o += 16 * kThreads) {
    cp_async16(dst + o, src + o);
  }
}

// k_nu from the squared scaled distance: IEEE under 'highest', the bare
// SFU approximations in the bf16 modes.
template <int NU, int FMT>
__device__ __forceinline__ float k_of(float d2) {
  if constexpr (FMT == kDotHighest) {
    return matern_exact_d2<NU>(d2);
  } else {
    return matern_approx_d2<NU>(d2);
  }
}

// NT: n8 tiles of V columns per block. FMT: the dot code. DIST: the
// distance form. grid.x: row blocks; grid.y: chunks of NT * 8 V columns.
// Dynamic shared memory: two stages of image_bytes<FMT, NT>(d, GRAM).
template <int NU, int FMT, int NT, int DIST>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    matern_matmat_mma_kernel(const float* __restrict__ rows,
                             const float* __restrict__ rows_norm,
                             const unsigned char* __restrict__ images,
                             float* __restrict__ out, int nr, int nc, int d,
                             int r, int bytes) {
  constexpr int kRC = NT * 8;
  constexpr bool kSplit = split_format<FMT>();
  constexpr bool kGramForm = DIST == kGram;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_rows[DIST == kDiff2 ? 1 : kMaxD]
                         [DIST == kDiff2 ? 1 : kRows];
  __shared__ float s_rnorm[kGramForm ? kRows : 1];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in group: the fragment's column pair
  const int wrow = (threadIdx.x >> 5) * kWarpRows;  // warp's first row
  const int row0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kRC;
  const int tiles = (nc + kCols - 1) / kCols;
  const unsigned char* img =
      images + static_cast<int64_t>(blockIdx.y) * tiles * bytes;

  // the block's row points: for d = 2 the thread's own four rows (m16 tile
  // mt, half h: row wrow + 16 mt + 8 h + g) in registers, else all rows
  // dimension-major in shared memory; rows past nr are zeros
  float x0[2][2], x1[2][2];
  if constexpr (DIST == kDiff2) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wrow + 16 * mt + 8 * h + g;
        const float2 p = row < nr
                             ? *reinterpret_cast<const float2*>(
                                   rows + 2 * static_cast<int64_t>(row))
                             : make_float2(0.0f, 0.0f);
        x0[mt][h] = p.x;
        x1[mt][h] = p.y;
      }
    }
  } else {
    for (int e = threadIdx.x; e < d * kRows; e += kThreads) {
      const int k = e / kRows;
      const int i = e % kRows;
      s_rows[k][i] = row0 + i < nr
                         ? rows[static_cast<int64_t>(row0 + i) * d + k]
                         : 0.0f;
    }
    if constexpr (kGramForm) {
      for (int i = threadIdx.x; i < kRows; i += kThreads) {
        s_rnorm[i] = row0 + i < nr ? rows_norm[row0 + i] : 0.0f;
      }
    }
  }

  // acc[m16 tile][n8 tile][fragment element]: the running sums
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }

  if (tiles > 0) copy_image(smem, img, bytes);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    // stage t & 1 holds tile t; tile t + 1 goes into the other stage, which
    // every warp left at the end of the previous iteration
    if (t + 1 < tiles) {
      copy_image(smem + ((t + 1) & 1) * bytes,
                 img + static_cast<int64_t>(t + 1) * bytes, bytes);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const unsigned char* stage = smem + (t & 1) * bytes;
    const float* s_cols = reinterpret_cast<const float*>(
        stage + v_part_bytes<FMT, NT>() * (kSplit ? 2 : 1));
    const float* s_cnorm = s_cols + d * kCols;
    const int tc = min(kCols, nc - t * kCols);

    // this tile's products in fresh accumulators: under 'highest' the
    // hi*hi terms, and the small terms apart
    float part[2][NT][4], part_lo[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[mt][nt][i] = 0.0f;
          part_lo[mt][nt][i] = 0.0f;
        }
      }
    }

    for (int kk = 0; kk < tc; kk += kStep) {
      // the thread's 4 rows x 4 columns (kk + 2 tig, + 1, + 8, + 9):
      // squared distances, or for the Gram form the dot products first
      float d2[2][2][4];
      if constexpr (DIST == kDiff2) {
        const float2 ya = *reinterpret_cast<const float2*>(
            s_cols + kk + 2 * tig);
        const float2 yb = *reinterpret_cast<const float2*>(
            s_cols + kk + 8 + 2 * tig);
        const float2 za = *reinterpret_cast<const float2*>(
            s_cols + kCols + kk + 2 * tig);
        const float2 zb = *reinterpret_cast<const float2*>(
            s_cols + kCols + kk + 8 + 2 * tig);
        const float y[4] = {ya.x, ya.y, yb.x, yb.y};
        const float z[4] = {za.x, za.y, zb.x, zb.y};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              // the order of the any-d loop below: the same bits
              const float dx = x0[mt][h] - y[c];
              const float dy = x1[mt][h] - z[c];
              d2[mt][h][c] = fmaf(dy, dy, dx * dx);
            }
          }
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int c = 0; c < 4; ++c) d2[mt][h][c] = 0.0f;
          }
        }
        for (int k = 0; k < d; ++k) {
          const float2 ya = *reinterpret_cast<const float2*>(
              s_cols + k * kCols + kk + 2 * tig);
          const float2 yb = *reinterpret_cast<const float2*>(
              s_cols + k * kCols + kk + 8 + 2 * tig);
          const float y[4] = {ya.x, ya.y, yb.x, yb.y};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float x = s_rows[k][wrow + 16 * mt + 8 * h + g];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if constexpr (kGramForm) {
                  d2[mt][h][c] = fmaf(x, y[c], d2[mt][h][c]);
                } else {
                  const float diff = x - y[c];
                  d2[mt][h][c] = fmaf(diff, diff, d2[mt][h][c]);
                }
              }
            }
          }
        }
        if constexpr (kGramForm) {
          const float2 na =
              *reinterpret_cast<const float2*>(s_cnorm + kk + 2 * tig);
          const float2 nb =
              *reinterpret_cast<const float2*>(s_cnorm + kk + 8 + 2 * tig);
          const float yn[4] = {na.x, na.y, nb.x, nb.y};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float xn = s_rnorm[wrow + 16 * mt + 8 * h + g];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                d2[mt][h][c] =
                    fmaxf(fmaf(-2.0f, d2[mt][h][c], xn + yn[c]), 0.0f);
              }
            }
          }
        }
      }

      if constexpr (FMT == kDotHighest) {
        const uint32_t* s_vhi = reinterpret_cast<const uint32_t*>(stage);
        const uint32_t* s_vlo = s_vhi + kRC * kLdV;
        // two m16n8k8 steps: columns kk + 8 s + 2 tig and + 1 at the depths
        // tig and tig + 4
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              split_tf32(k_of<NU, FMT>(d2[mt][h][2 * s]), a_hi[mt][h],
                         a_lo[mt][h]);
              split_tf32(k_of<NU, FMT>(d2[mt][h][2 * s + 1]),
                         a_hi[mt][2 + h], a_lo[mt][2 + h]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const Tf32B b = load_b_tf32(s_vhi + (nt * 8 + g) * kLdV,
                                        s_vlo + (nt * 8 + g) * kLdV,
                                        kk + 8 * s, tig);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_tf32(part[mt][nt], a_hi[mt], b.h0, b.h1);
              mma_tf32(part_lo[mt][nt], a_lo[mt], b.h0, b.h1);
              mma_tf32(part_lo[mt][nt], a_hi[mt], b.l0, b.l1);
            }
          }
        }
      } else {
        constexpr bool X3 = FMT == kDotBf16x3;
        const uint16_t* s_vhi = reinterpret_cast<const uint16_t*>(stage);
        const uint16_t* s_vlo = s_vhi + (X3 ? kRC * kLdV : 0);
        // k, rounded, into the A fragments: a[0] row g, columns 2 tig, + 1;
        // a[1] row g + 8, same columns; a[2], a[3] the same rows, columns + 8
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float kv[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) kv[c] = k_of<NU, FMT>(d2[mt][h][c]);
            pack_pair<X3>(kv[0], kv[1], a_hi[mt][h], a_lo[mt][h]);
            pack_pair<X3>(kv[2], kv[3], a_hi[mt][2 + h], a_lo[mt][2 + h]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const BFragment b = load_b<X3>(s_vhi + (nt * 8 + g) * kLdV,
                                         s_vlo + (nt * 8 + g) * kLdV, kk,
                                         tig);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tile_dot<X3>(part[mt][nt], a_hi[mt], a_lo[mt], b);
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[mt][nt][i] += FMT == kDotHighest
                                ? part[mt][nt][i] + part_lo[mt][nt][i]
                                : part[mt][nt][i];
        }
      }
    }
    __syncthreads();  // every warp is done with stage t & 1
  }

  // fragment element i: row g (+ 8 for i >= 2), column 2 tig + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + wrow + 16 * mt + 8 * (i >> 1) + g;
        const int col = c0 + nt * 8 + 2 * tig + (i & 1);
        if (row < nr && col < r) {
          out[static_cast<int64_t>(row) * r + col] = acc[mt][nt][i];
        }
      }
    }
  }
}

struct Args {
  const float* rows;
  const float* cols;
  const float* rows_norm;  // both norms null: the difference form
  const float* cols_norm;
  const float* V;
  float* out;
  unsigned char* scratch;
  int nr, nc, d, r;
  cudaStream_t stream;
};

int width_nt(int r) {
  return r <= 8 ? 1 : r <= 16 ? 2 : r <= 24 ? 3 : kMaxNT;
}

template <int FMT, int NT>
int64_t scratch_bytes(int nc, int d, int r, bool gram) {
  const int64_t tiles = (nc + kCols - 1) / kCols;
  const int64_t chunks = (r + NT * 8 - 1) / (NT * 8);
  return chunks * tiles * image_bytes<FMT, NT>(d, gram);
}

template <int FMT>
int64_t scratch_nt(int nc, int d, int r, bool gram) {
  switch (width_nt(r)) {
    case 1: return scratch_bytes<FMT, 1>(nc, d, r, gram);
    case 2: return scratch_bytes<FMT, 2>(nc, d, r, gram);
    case 3: return scratch_bytes<FMT, 3>(nc, d, r, gram);
    default: return scratch_bytes<FMT, kMaxNT>(nc, d, r, gram);
  }
}

template <int NU, int FMT, int NT, int DIST>
cudaError_t launch(const Args& a) {
  constexpr bool kGramForm = DIST == kGram;
  const int tiles = (a.nc + kCols - 1) / kCols;
  const int chunks = (a.r + NT * 8 - 1) / (NT * 8);
  if (chunks > 65535) return cudaErrorInvalidValue;
  const int bytes = image_bytes<FMT, NT>(a.d, kGramForm);
  if (tiles > 0) {
    stage_images_kernel<FMT, NT, kGramForm>
        <<<dim3(tiles, chunks), kPrepThreads, 0, a.stream>>>(
            a.cols, a.cols_norm, a.V, a.scratch, a.nc, a.d, a.r, tiles,
            bytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto* kernel = matern_matmat_mma_kernel<NU, FMT, NT, DIST>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nr + kRows - 1) / kRows, chunks);
  kernel<<<grid, kThreads, 2 * bytes, a.stream>>>(
      a.rows, a.rows_norm, a.scratch, a.out, a.nr, a.nc, a.d, a.r, bytes);
  return cudaGetLastError();
}

template <int NU, int FMT, int NT>
cudaError_t launch_dist(const Args& a) {
  if (a.rows_norm != nullptr) return launch<NU, FMT, NT, kGram>(a);
  return a.d == 2 ? launch<NU, FMT, NT, kDiff2>(a)
                  : launch<NU, FMT, NT, kDiffAny>(a);
}

template <int NU, int FMT>
cudaError_t launch_nt(const Args& a) {
  switch (width_nt(a.r)) {
    case 1: return launch_dist<NU, FMT, 1>(a);
    case 2: return launch_dist<NU, FMT, 2>(a);
    case 3: return launch_dist<NU, FMT, 3>(a);
    default: return launch_dist<NU, FMT, kMaxNT>(a);
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

// Bytes of scratch the product needs: the staged images of every column
// tile and chunk of V. -1 on arguments the product does not take.
extern "C" int64_t gppe_matern_matmat_mma_scratch_bytes(int nc, int d, int r,
                                                        int dot_code,
                                                        int gram) {
  if (nc < 0 || d < 1 || d > kMaxD || r < 1 || !valid_mode(dot_code)) {
    return -1;
  }
  switch (dot_code) {
    case kDotHighest: return scratch_nt<kDotHighest>(nc, d, r, gram != 0);
    case kDotBf16x3: return scratch_nt<kDotBf16x3>(nc, d, r, gram != 0);
    default: return scratch_nt<kDotBf16>(nc, d, r, gram != 0);
  }
}

// Launches the pre-pass and the product on `stream` and returns the first
// error of cudaGetLastError() (0 on success). Does not synchronise and
// allocates nothing: `scratch` holds gppe_matern_matmat_mma_scratch_bytes
// bytes, 16-byte aligned, and must live until the product has run.
// `dot_code` is kDotHighest, kDotBf16x3 or kDotBf16. `rows_norm` (nr) and
// `cols_norm` (nc) are both null for the difference form, or hold the
// squared norms of the (centred) rows and cols for the Gram form. r >= 1.
extern "C" int gppe_matern_matmat_mma(const void* rows, const void* cols,
                                      const void* rows_norm,
                                      const void* cols_norm, const void* V,
                                      void* out, void* scratch, int nr,
                                      int nc, int d, int r, int nu_code,
                                      int dot_code, void* stream) {
  if (nr <= 0 || nc < 0 || d < 1 || d > kMaxD || r < 1 ||
      !valid_mode(dot_code) ||
      (rows_norm == nullptr) != (cols_norm == nullptr) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(rows),
               static_cast<const float*>(cols),
               static_cast<const float*>(rows_norm),
               static_cast<const float*>(cols_norm),
               static_cast<const float*>(V),
               static_cast<float*>(out),
               static_cast<unsigned char*>(scratch),
               nr,
               nc,
               d,
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
