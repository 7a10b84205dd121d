"""Kernel tapering ("sparse" correlation): the host CSR and the block-sparse
operator.

Counterpart of :mod:`gppe_tpu.ops.taper`. The reference sparsifies K by
dropping entries whose kernel value falls below a threshold estimated from
the requested density via d-ball geometry. The same object comes in two
forms:

* :func:`generate_tapered_correlation`: the exact tapered K as a scipy CSR
  on the host. For a closed-form nu the native C++/OpenMP cell-binned
  builder (:mod:`gppe_tpu_torch.native`) keeps every pair within the taper
  radius; for a general nu the blocked rule keeps k >= threshold, a block
  of rows at a time: on the card k from the points by the assembly entry
  of the general-nu kernel, only the kept entries copied back; on the CPU
  the plain ``kernels.matern`` of the distances.
* :class:`TaperedMaternOperator`: the scalable form. Points are spatially
  sorted (grid-cell keys) so near points share tiles, a tile-pair adjacency
  mask is computed from tile bounding boxes and the taper radius, and
  matvecs touch only active tiles. The kernel value mask (k >= threshold)
  matches the reference's hard taper exactly. On a CUDA device the active
  tiles run through the fused CUDA kernels
  (:func:`gppe_tpu_torch.ops.cuda_kernels.matern_matmat_blocksparse`: a
  closed-form nu on ``csrc/matern_blocksparse_mma.cu`` and
  ``csrc/matern_blocksparse.cu``, a general nu on
  ``csrc/matern_blocksparse_general.cu``); on the CPU through their plain
  version. K is never materialized.

Since k(.; nu) is monotone decreasing, the taper "k >= threshold" is the
distance ball "d <= kernel_radius" - tiles are pruned on distance, entries
masked on kernel value.

The threshold geometry and the tile-pair geometry are host numpy, copied
from the reference so that ``perm``, ``pair_i`` and ``pair_j`` agree with
its operator at the same ``tile``.
"""

import numpy as np
import torch

from . import assembly, cuda_kernels, kernels
from .. import native
from ..utils.config import resolve_device, setup


# -- d-ball threshold math ---------------------------------------------------

def gamma_function(dimension):
    """Gamma(dimension/2 + 1) by half-integer recursion."""
    if dimension % 2 == 0:
        k = 0.5 * dimension
        gamma = 1.0
        while k > 0.0:
            gamma *= k
            k -= 1.0
    else:
        k = np.ceil(0.5 * dimension)
        gamma = np.sqrt(np.pi)
        while k > 0.0:
            gamma *= k - 0.5
            k -= 1.0
    return gamma


def ball_radius(volume, dimension):
    """Radius of the d-ball of given volume."""
    return (gamma_function(dimension) * volume) ** (1.0 / dimension) \
        / np.sqrt(np.pi)


def ball_volume(radius, dimension):
    """Volume of the d-ball of given radius."""
    return (radius * np.sqrt(np.pi)) ** dimension / gamma_function(dimension)


def estimate_kernel_radius(matrix_size, dimension, density,
                           correlation_scale):
    """Scaled taper radius (in units of d/rho) for a target density.

    A point should keep ``a = density * n`` neighbors; for ~uniform points
    in the unit hypercube with spacing ``l = 1/(n^{1/d}-1)``, those
    neighbors occupy a d-ball of volume ``a * l^d``, whose radius is the
    physical taper radius."""
    adjacency = density * matrix_size
    if adjacency < 1.0:
        raise ValueError(
            f"Adjacency {adjacency:.2f} < 1: correlation matrix "
            "would become identity. Increase density or correlation_scale.")

    scale = np.atleast_1d(np.asarray(correlation_scale, dtype=float))
    geometric_mean_scale = np.prod(scale) ** (1.0 / dimension)

    grid_axis_num_points = matrix_size ** (1.0 / dimension)
    grid_size = 1.0 / max(grid_axis_num_points - 1.0, 1.0)
    kernel_radius = ball_radius(adjacency * grid_size ** dimension,
                                dimension)
    # physical radius -> scaled-distance radius
    return kernel_radius / geometric_mean_scale


def estimate_kernel_threshold(matrix_size, dimension, density,
                              correlation_scale, nu):
    """Taper threshold tau = k(kernel_radius; nu), in float64."""
    r = estimate_kernel_radius(matrix_size, dimension, density,
                               correlation_scale)
    return float(kernels.matern(torch.as_tensor(r, dtype=torch.float64),
                                float(nu)))


def estimate_max_nnz(matrix_size, correlation_scale, dimension, density):
    """Upper estimate of nnz; informational - the operator sizes its
    arrays exactly."""
    estimated_nnz = int(np.ceil(density * matrix_size ** 2))
    scale = np.atleast_1d(np.asarray(correlation_scale, dtype=float))
    normalized = scale / scale.max()
    geometric_mean_radius = np.prod(normalized) ** (1.0 / dimension)
    safety = 1.0 / ball_radius(geometric_mean_radius, dimension)
    return int(np.ceil(safety * estimated_nnz))


# -- the host CSR -----------------------------------------------------------

# the reference's rows per block of the blocked rule, taken on the CPU
BLOCK_ROWS = 2048


def _tapered_block_rows(n, d, nu, device, dtype):
    """Rows per block of the blocked rule on ``device``: the reference's
    BLOCK_ROWS on the CPU; on the card as many as half the free device
    memory holds at what a block holds per entry, at most 2^31 - 1
    entries a block: a general nu at d <= 8 (the general-nu kernel's
    assembly entry) its k and the mask, a word and a byte; any other the
    distance intermediates too (the differences, their squares, the
    distances, k and the mask: 2 d + 3 words and a byte)."""
    if device.type != "cuda":
        return BLOCK_ROWS
    free, _ = torch.cuda.mem_get_info(device)
    fused = not kernels.is_closed_form(nu) and d <= cuda_kernels._MAX_D
    words = 1 if fused else 2 * d + 3
    per_row = n * (words * torch.finfo(dtype).bits // 8 + 1)
    return max(1, min(n, free // 2 // per_row, (2 ** 31 - 1) // n))


def _blocked_csr(pts_scaled, nu, tau, block_rows, device, dtype):
    """The blocked rule: each block of rows against every point, k of the
    pre-scaled points at scale 1 (``assembly.correlation_of_points``: a
    general nu on the card by the general-nu kernel's assembly entry, the
    block's rows on every tile pair), the entries with k >= tau (compared
    in ``dtype``) kept in row-major order. Returns host numpy (values
    float64, indices int64, indptr int64)."""
    n, d = pts_scaled.shape
    pts = torch.as_tensor(pts_scaled, dtype=dtype, device=device).contiguous()
    if block_rows is None:
        block_rows = _tapered_block_rows(n, d, nu, device, dtype)
    rows, cols, vals = [], [], []
    for start in range(0, n, block_rows):
        kblk = assembly.correlation_of_points(
            pts, 1.0, nu, rows=(start, min(start + block_rows, n)))
        r, c = torch.nonzero(kblk >= tau, as_tuple=True)
        vals.append(kblk[r, c].cpu().numpy().astype(np.float64))
        rows.append(r.cpu().numpy() + start)
        cols.append(c.cpu().numpy())
        del kblk, r, c  # a block fills half the free device memory
    rows = np.concatenate(rows)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return np.concatenate(vals), np.concatenate(cols).astype(np.int64), indptr


def generate_tapered_correlation(points, scale, nu, density, verbose=False,
                                 block_rows=None, *, dtype=torch.float32,
                                 device="cuda"):
    """Exact tapered correlation as a scipy CSR (n x n, float64 values):
    the reference's ``generate_tapered_correlation``.

    A closed-form nu (and d <= 8) takes the native builder on the host,
    which keeps every pair within the taper radius (``device`` and
    ``dtype`` are not used). Any other nu takes the blocked rule, which
    keeps k >= threshold: ``block_rows`` rows at a time (default: the
    reference's 2048 on the CPU, sized to free device memory on the card),
    k in ``dtype`` on ``device``: on the card a general nu's k comes from
    the general-nu kernel's assembly entry (float32 only) and only the kept
    entries are copied to the host; on the CPU from the plain
    ``kernels.matern`` of the distances."""
    import scipy.sparse

    points = np.asarray(points, dtype=float)
    n, d = points.shape
    scale = np.atleast_1d(np.asarray(scale, dtype=float))
    if scale.size == 1:
        scale = np.repeat(scale, d)
    tau = estimate_kernel_threshold(n, d, density, scale, nu)
    radius = estimate_kernel_radius(n, d, density, scale)
    pts_scaled = points / scale

    if native.serves(nu, d):
        values, indices, indptr = native.taper_csr(pts_scaled, radius, nu)
        how = f"native, {native.num_threads()} threads"
    else:
        setup()
        values, indices, indptr = _blocked_csr(
            pts_scaled, nu, tau, block_rows, resolve_device(device), dtype)
        how = "blocked"
    csr = scipy.sparse.csr_matrix((values, indices, indptr), shape=(n, n))
    if verbose:
        print(f"tapered correlation ({how}): n={n} tau={tau:.3e} "
              f"nnz={csr.nnz} density={csr.nnz / n ** 2:.3e}")
    return csr


# -- spatial sorting and the block-sparse operator ---------------------------

def spatial_sort(points, cell_size):
    """Sort points by grid-cell key (row-major cells of width cell_size in
    scaled coordinates) so that spatial neighbors are contiguous.
    Returns the permutation."""
    pts = np.asarray(points)
    cells = np.floor(pts / cell_size).astype(np.int64)
    # lexicographic cell key, then original index for determinism
    order = np.lexsort(tuple(cells[:, k] for k in range(pts.shape[1] - 1,
                                                        -1, -1)))
    return order


class TaperedMaternOperator:
    """Block-sparse tapered Matern operator: matvec touches only tile
    pairs within the taper radius.

    API: ``shape``, ``matmat``, ``matvec``, ``trace_pow`` - what the Krylov
    engines consume - ``nnz_estimate``, and the geometry ``perm``,
    ``inv_perm``, ``pair_i``, ``pair_j`` (numpy), ``tile_density``,
    ``radius``, ``threshold``. ``nu`` is any positive number: a closed form
    (0.5, 1.5, 2.5 or >= 100) or a general nu (the Bessel form)."""

    def __init__(self, points, scale, nu=0.5, density=0.001, tile=512,
                 device="cuda", dtype=torch.float32):
        """``device``/``dtype``: where and in what the sorted points and
        every product live (the CUDA kernel takes float32)."""
        setup()
        self.device = resolve_device(device)
        self.dtype = dtype
        points = np.asarray(points, dtype=np.float64)
        n, d = points.shape
        scale_arr = np.atleast_1d(np.asarray(scale, dtype=float))
        if scale_arr.size == 1:
            scale_arr = np.repeat(scale_arr, d)

        self.nu = cuda_kernels.check_nu(nu)
        self.density = density
        self.tile = int(min(tile, n))
        self.radius = estimate_kernel_radius(n, d, density, scale_arr)
        self.threshold = estimate_kernel_threshold(n, d, density,
                                                   scale_arr, nu)

        # sort by spatial cells of the taper radius (scaled coordinates)
        pts_scaled = points / scale_arr
        self.perm = spatial_sort(pts_scaled, max(self.radius, 1e-12))
        self.inv_perm = np.argsort(self.perm)
        pts_sorted = pts_scaled[self.perm]

        # pad to a tile multiple with far-away points (the tile geometry
        # below sees them; the products mask them)
        t = self.tile
        n_pad = -(-n // t) * t
        if n_pad > n:
            pad = np.zeros((n_pad - n, d))
            pad[:, 0] = 1e6 * (2.0 + np.arange(n_pad - n))
            pts_sorted = np.concatenate([pts_sorted, pad], axis=0)
        self._n = n
        self.n_pad = n_pad
        num_tiles = n_pad // t

        # tile bounding boxes -> active pairs (bbox distance <= radius)
        boxes_lo = pts_sorted.reshape(num_tiles, t, d).min(axis=1)
        boxes_hi = pts_sorted.reshape(num_tiles, t, d).max(axis=1)
        gap = np.maximum(
            np.maximum(boxes_lo[:, None, :] - boxes_hi[None, :, :],
                       boxes_lo[None, :, :] - boxes_hi[:, None, :]), 0.0)
        tile_dist = np.sqrt((gap ** 2).sum(-1))
        active = tile_dist <= self.radius
        pi, pj = np.nonzero(active)
        order = np.lexsort((pj, pi))      # sort by row tile then col tile
        self.pair_i = pi[order].astype(np.int32)
        self.pair_j = pj[order].astype(np.int32)
        self.num_tiles = num_tiles
        self.tile_density = len(self.pair_i) / num_tiles ** 2

        # on the device: the sorted points, the permutations, the pair list
        # as the row-tile pointer array the products walk, and the trace's
        # walk (the list is mirrored, so its sub-tile pairs of tiles
        # ti <= tj: 128 x 128 points each for a closed-form nu, 64 x 128 for
        # a general nu)
        self.points_sorted = torch.as_tensor(pts_sorted, dtype=dtype,
                                             device=self.device)
        self._perm = torch.as_tensor(self.perm, device=self.device)
        self._inv_perm = torch.as_tensor(self.inv_perm, device=self.device)
        self._row_ptr = torch.as_tensor(
            cuda_kernels.blocksparse_row_ptr(self.pair_i, num_tiles),
            device=self.device)
        self._pair_j = torch.as_tensor(self.pair_j, device=self.device)
        walk = cuda_kernels.blocksparse_trace_schedule_for(self.nu)(
            self.pair_i, self.pair_j, t, n)
        self._trace_walk = walk._replace(
            units=torch.as_tensor(walk.units, device=self.device))

    @property
    def shape(self):
        return (self._n, self._n)

    def nnz_estimate(self):
        """The reference's upper estimate of nnz (its arguments: unit
        scale, 2 dimensions)."""
        return estimate_max_nnz(self._n, 1.0, 2, self.density)

    def _product(self, Vs, frobenius=False):
        return cuda_kernels.matern_matmat_blocksparse(
            self.points_sorted, Vs, self.nu, self.threshold, self.pair_i,
            self._pair_j, self.tile, n=self._n, frobenius=frobenius,
            row_ptr=self._row_ptr, trace_walk=self._trace_walk)

    def matmat(self, V):
        V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        # permute into sorted order, zero rows for the pad
        Vs = torch.zeros((self.n_pad, V.shape[1]), dtype=self.dtype,
                         device=self.device)
        Vs[:self._n] = V[self._perm]
        out = self._product(Vs)[:self._n][self._inv_perm]
        return out[:, 0] if squeeze else out

    def matvec(self, v):
        return self.matmat(v)

    def trace_pow(self, exponent):
        """Exact trace(K^p) of the tapered K for p in {0, 1, 2}: its
        diagonal is 1 (k(0) = 1 >= threshold); trace(K^2) is the sum of
        squared tapered entries, from one trace-only pass (on the card
        over half the list, by symmetry). The products mask the pad, so
        there is no padded diagonal to subtract."""
        if exponent in (0, 1):
            return torch.tensor(float(self._n), dtype=self.dtype,
                                device=self.device)
        if exponent == 2:
            _, fro = self._product(None, frobenius=True)
            return fro
        raise ValueError("exponent must be 0, 1 or 2")
