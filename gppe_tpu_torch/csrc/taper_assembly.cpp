// Host-native tapered correlation assembly (C++17 + OpenMP).
//
// The role of the reference's Cython/OpenMP sparse assembly
// (reference: gaussian_proc/generate_correlation/_generate_sparse_correlation.pyx:
// 129-197), redesigned:
//   * cell-binned neighbor search: O(n * k) instead of the reference's
//     O(n^2) all-pairs scan — the taper radius defines the cell size, so
//     only 3^d neighbor cells are visited per point;
//   * lock-free two-pass CSR construction (parallel count, exclusive
//     scan, parallel fill) instead of the reference's OpenMP-lock COO
//     append + retry-on-overflow loop (:143-177, :550-577);
//   * closed-form Matern branches (nu = 1/2, 3/2, 5/2, Gaussian limit),
//     matching _kernels.pyx:76-93. General nu stays on the Python path.
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).
//
// gppe_tpu_torch's copy of native/taper_assembly.cpp, code unchanged; built
// with the same flags at first use by gppe_tpu_torch/native.py.

#include <cmath>
#include <cstdint>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline double matern(double r, double nu) {
  if (r == 0.0) return 1.0;
  if (nu == 0.5) return std::exp(-r);
  if (nu == 1.5) {
    const double s = std::sqrt(3.0) * r;
    return (1.0 + s) * std::exp(-s);
  }
  if (nu == 2.5) {
    const double s = std::sqrt(5.0) * r;
    return (1.0 + s + 5.0 / 3.0 * r * r) * std::exp(-s);
  }
  // nu >= 100: Gaussian limit
  return std::exp(-0.5 * r * r);
}

struct CellGrid {
  // uniform grid over the scaled bounding box with cell size = radius
  int d;
  double cell;
  std::vector<double> lo;
  std::vector<int64_t> dims;     // cells per axis
  std::vector<int64_t> strides;
  std::vector<int64_t> cell_start;  // size ncells+1
  std::vector<int64_t> order;       // point ids sorted by cell

  int64_t cell_of(const double* p) const {
    int64_t idx = 0;
    for (int k = 0; k < d; ++k) {
      int64_t c = (int64_t)((p[k] - lo[k]) / cell);
      if (c < 0) c = 0;
      if (c >= dims[k]) c = dims[k] - 1;
      idx += c * strides[k];
    }
    return idx;
  }
};

CellGrid build_grid(const double* pts, int64_t n, int d, double radius) {
  CellGrid g;
  g.d = d;
  g.cell = radius > 0 ? radius : 1.0;
  g.lo.assign(d, 1e300);
  std::vector<double> hi(d, -1e300);
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < d; ++k) {
      g.lo[k] = std::min(g.lo[k], pts[i * d + k]);
      hi[k] = std::max(hi[k], pts[i * d + k]);
    }
  g.dims.resize(d);
  g.strides.resize(d);
  int64_t ncells = 1;
  for (int k = 0; k < d; ++k) {
    g.dims[k] = std::max<int64_t>(
        1, (int64_t)((hi[k] - g.lo[k]) / g.cell) + 1);
    // guard absurd grids (degenerate radius): cap total cells at 8n
    if (ncells * g.dims[k] > 8 * n + 64) g.dims[k] = std::max<int64_t>(
        1, (8 * n + 64) / std::max<int64_t>(ncells, 1));
    ncells *= g.dims[k];
  }
  int64_t s = 1;
  for (int k = d - 1; k >= 0; --k) { g.strides[k] = s; s *= g.dims[k]; }

  // counting sort points into cells
  std::vector<int64_t> counts(ncells + 1, 0);
  std::vector<int64_t> cell_id(n);
  for (int64_t i = 0; i < n; ++i) {
    cell_id[i] = g.cell_of(pts + i * d);
    counts[cell_id[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  g.cell_start = counts;
  g.order.resize(n);
  std::vector<int64_t> cursor(g.cell_start.begin(), g.cell_start.end() - 1);
  for (int64_t i = 0; i < n; ++i) g.order[cursor[cell_id[i]]++] = i;
  return g;
}

// visit all points within `radius` of point i; F(j, r) for each
template <typename F>
inline void for_neighbors(const CellGrid& g, const double* pts, int64_t n,
                          int64_t i, double radius, F&& f) {
  const int d = g.d;
  const double r2max = radius * radius;
  // iterate the 3^d neighborhood of i's cell
  int64_t base[8];
  for (int k = 0; k < d; ++k) {
    int64_t c = (int64_t)((pts[i * d + k] - g.lo[k]) / g.cell);
    if (c < 0) c = 0;
    if (c >= g.dims[k]) c = g.dims[k] - 1;
    base[k] = c;
  }
  int64_t ncomb = 1;
  for (int k = 0; k < d; ++k) ncomb *= 3;
  for (int64_t m = 0; m < ncomb; ++m) {
    int64_t idx = 0;
    int64_t mm = m;
    bool ok = true;
    for (int k = 0; k < d; ++k) {
      int64_t off = (mm % 3) - 1;
      mm /= 3;
      int64_t c = base[k] + off;
      if (c < 0 || c >= g.dims[k]) { ok = false; break; }
      idx += c * g.strides[k];
    }
    if (!ok) continue;
    for (int64_t t = g.cell_start[idx]; t < g.cell_start[idx + 1]; ++t) {
      int64_t j = g.order[t];
      double r2 = 0.0;
      for (int k = 0; k < d; ++k) {
        const double dk = pts[i * d + k] - pts[j * d + k];
        r2 += dk * dk;
      }
      if (r2 <= r2max) f(j, std::sqrt(r2));
    }
  }
}

}  // namespace

extern "C" {

// Phase 1: per-row neighbor counts -> indptr (size n+1); returns nnz.
// points_scaled: (n, d) row-major, ALREADY divided by the correlation
// scale; radius: taper radius in scaled distance.
int64_t gppe_taper_count(const double* points_scaled, int64_t n, int d,
                         double radius, int64_t* indptr) {
  if (d > 8) return -2;
  CellGrid g = build_grid(points_scaled, n, d, radius);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n; ++i) {
    int64_t cnt = 0;
    for_neighbors(g, points_scaled, n, i, radius,
                  [&](int64_t, double) { ++cnt; });
    indptr[i + 1] = cnt;
  }
  indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
  return indptr[n];
}

// Phase 2: fill CSR indices/values using the indptr from phase 1.
// tau: kernel threshold — entries with k < tau are *kept only if* within
// radius (radius and tau encode the same cut; radius decides membership,
// the kernel value is stored). Returns 0 on success.
int32_t gppe_taper_fill(const double* points_scaled, int64_t n, int d,
                        double radius, double nu, const int64_t* indptr,
                        int64_t* indices, double* values) {
  if (d > 8) return -2;
  CellGrid g = build_grid(points_scaled, n, d, radius);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n; ++i) {
    int64_t pos = indptr[i];
    for_neighbors(g, points_scaled, n, i, radius,
                  [&](int64_t j, double r) {
                    indices[pos] = j;
                    values[pos] = matern(r, nu);
                    ++pos;
                  });
    // deterministic column order within the row
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    std::vector<int64_t> perm(hi - lo);
    for (int64_t t = 0; t < hi - lo; ++t) perm[t] = t;
    std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
      return indices[lo + a] < indices[lo + b];
    });
    std::vector<int64_t> ci(hi - lo);
    std::vector<double> cv(hi - lo);
    for (int64_t t = 0; t < hi - lo; ++t) {
      ci[t] = indices[lo + perm[t]];
      cv[t] = values[lo + perm[t]];
    }
    std::copy(ci.begin(), ci.end(), indices + lo);
    std::copy(cv.begin(), cv.end(), values + lo);
  }
  return 0;
}

int32_t gppe_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
