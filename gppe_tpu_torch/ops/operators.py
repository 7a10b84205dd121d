"""Linear operators for the Krylov engines: the matrix-free Matern
correlation operator (K @ V without storing K) and a sparse K's operator.

Counterpart of ``gppe_tpu.ops.operators.MaternOperator`` and
``SparseOperator``. On a CUDA
device ``matmat`` and ``trace_pow(2)`` launch the fused CUDA kernels
(:func:`gppe_tpu_torch.ops.cuda_kernels.matern_matmat`): for a closed-form
nu the tensor-core kernel for the products in every dot mode and the FP32
kernel for the trace, as the reference takes Pallas for them
(``gppe_tpu/ops/operators.py:98-101``); for a general nu the general-nu
kernel ``csrc/matern_general.cu`` for both, where the reference runs its
row-blocked XLA path. On the CPU they run the plain row-blocked PyTorch
version. The points live on the device (0.8 MB at n = 10^5); K (40 GB at
n = 10^5) never exists.

:class:`SparseOperator` holds a scipy-sparse K (a tapered CSR) on the
device as a torch sparse CSR tensor; its product is one
``torch.sparse.mm`` (cuSPARSE's SpMM on the card), where the reference
scans a padded-ELL repack on its XLA path (no Pallas kernel).

:class:`GridMaternOperator` is the exact operator of a regular grid: its
products are ``torch.fft`` transforms of the circulant embedding of the
unique-offset kernel table (cuFFT on the card, a library call, as the
reference's ``jnp.fft``), O(n log n) at any nu; the table's general-nu k
runs the general-nu kernel's elementwise entry for a float32 operator.
The grid helpers (:func:`grid_geometry`, :func:`grid_distance_table`,
:func:`circulant_rfft`, :func:`grid_trace_pow2`) serve it and the
(rho, nu) posterior surface.
"""

import warnings

import numpy as np
import torch

from . import assembly, cuda_kernels, kernels
from ..utils.config import resolve_device, setup


class MaternOperator:
    """Assembly-free Matern correlation operator.

    API: ``shape``, ``matmat``, ``matvec``, ``trace_pow``, ``dense`` — what
    the Krylov engines consume. ``nu`` is any positive number: a closed
    form (0.5, 1.5, 2.5 or >= 100) or a general nu (the Bessel form).
    """

    def __init__(self, points, scale, nu=0.5, block_rows=1024,
                 device="cuda", dtype=torch.float32, dot_mode=None):
        """``device``/``dtype``: where and in what the points and every
        product live (the CUDA kernel takes float32). ``block_rows``: rows
        per block of the plain CPU path. ``dot_mode``: tile-dot precision
        of ``matmat``, one of ``cuda_kernels.DOT_MODES``; None follows
        ``cuda_kernels.DEFAULT_DOT_MODE`` ('highest', exact float32) at
        each call. 'bf16x3' rounds the operand, so u.(Kv) and v.(Ku) differ
        at ~1e-6: harmless to Lanczos, which re-measures its residuals, but
        not for consumers with tolerances below that floor. ``dot_mode``
        does not apply to a general nu, whose products are exact float32
        FMA sums, as the reference's XLA path ignores it."""
        setup()
        if dot_mode is not None:
            cuda_kernels.resolve_dot_mode(dot_mode)
        self.nu = cuda_kernels.check_nu(nu)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.points = torch.as_tensor(points, dtype=dtype,
                                      device=self.device).contiguous()
        n, d = self.points.shape
        self.scale = kernels.broadcast_scale(scale, d, dtype=dtype,
                                             device=self.device)
        self.block_rows = int(min(block_rows, n))
        self.dot_mode = dot_mode
        self._n = n

    @property
    def shape(self):
        return (self._n, self._n)

    def matmat(self, V):
        V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = cuda_kernels.matern_matmat(
            self.points, self.scale, V.contiguous(), self.nu,
            dot_mode=self.dot_mode, block_rows=self.block_rows)
        return out[:, 0] if squeeze else out

    def matvec(self, v):
        return self.matmat(v)

    def trace_pow(self, exponent):
        """Exact trace(K^p) for p in {0, 1, 2}: diag(K) = 1 so the trace is
        n; trace(K^2) = ||K||_F^2 from one Frobenius-only pass, exact in
        every dot mode."""
        if exponent == 0 or exponent == 1:
            return torch.tensor(float(self._n), dtype=self.dtype,
                                device=self.device)
        if exponent == 2:
            _, fro = cuda_kernels.matern_matmat(
                self.points, self.scale, None, self.nu, dot_mode="highest",
                frobenius=True, block_rows=self.block_rows)
            return fro
        raise ValueError("exponent must be 0, 1 or 2")

    def dense(self):
        """Materialize K (small-n debugging only); a general nu through the
        general-nu kernel's assembly entry on the card, one launch."""
        return assembly.correlation_of_points(self.points, self.scale,
                                              self.nu)


class SparseOperator:
    """Device operator view of a scipy-sparse (CSR, COO, ...) square K.

    API: ``shape``, ``nnz``, ``matmat``, ``matvec``, ``trace_pow``,
    ``dense``, ``device``, ``dtype``. K is converted once, here: to a torch
    sparse CSR tensor of ``dtype`` values on ``device``, with int32 row
    pointers and column indices while nnz < 2^31 (int64 beyond), so each
    ``matmat`` is one ``torch.sparse.mm`` (cuSPARSE's SpMM on the card, the
    CPU's sparse product in the tests). trace(K) and trace(K^2) are summed
    once from the host CSR's float64 data (the reference's
    ``trace_pow``); trace(K^2) as the sum of squared entries assumes K
    symmetric, as the reference does.

    Left out of the reference's ``SparseOperator``: its padded-ELL repack
    and scan and the ``max_ell_bytes`` guard on that layout's size, the
    form its TPU runs well; cuSPARSE takes the CSR as it is."""

    def __init__(self, K_sparse, device="cuda", dtype=torch.float32):
        import scipy.sparse

        setup()
        self.device = resolve_device(device)
        self.dtype = dtype
        K = scipy.sparse.csr_matrix(K_sparse)
        if K.shape[0] != K.shape[1]:
            raise ValueError(f"K must be square; got {K.shape}")
        if not K.has_sorted_indices:
            K = K.sorted_indices()
        self._n = K.shape[0]
        self.nnz = int(K.nnz)
        self._trace1 = float(K.diagonal().sum())
        self._trace2 = float(np.sum(np.square(K.data, dtype=np.float64)))
        index = np.int32 if self.nnz < 2 ** 31 else np.int64
        with warnings.catch_warnings():
            # torch flags its sparse CSR layout as beta on first use, and
            # some versions warn of the invariant checks declined below (the
            # scipy CSR is valid and its column indices sorted)
            warnings.filterwarnings("ignore", message=".*beta state.*")
            warnings.filterwarnings("ignore",
                                    message=".*invariant checks.*")
            self._csr = torch.sparse_csr_tensor(
                torch.as_tensor(K.indptr.astype(index, copy=False),
                                device=self.device),
                torch.as_tensor(K.indices.astype(index, copy=False),
                                device=self.device),
                torch.as_tensor(K.data, dtype=dtype, device=self.device),
                size=K.shape, check_invariants=False)

    @property
    def shape(self):
        return (self._n, self._n)

    def matmat(self, V):
        V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = torch.sparse.mm(self._csr, V)
        return out[:, 0] if squeeze else out

    def matvec(self, v):
        return self.matmat(v)

    def trace_pow(self, exponent):
        """Exact trace(K^p) for p in {0, 1, 2}, float64 on the device."""
        if exponent not in (0, 1, 2):
            raise ValueError("exponent must be 0, 1 or 2")
        value = (float(self._n), self._trace1, self._trace2)[exponent]
        return torch.tensor(value, dtype=torch.float64, device=self.device)

    def dense(self):
        """Materialize K (small-n exact paths and debugging)."""
        return self._csr.to_dense()


def grid_geometry(points):
    """The regular-grid structure of a point set.

    Returns ``(ms, hs, to_raster, from_raster)``: per-axis sizes and
    spacings, and the permutations between the caller's point order and
    raster (row-major) order as int64 numpy arrays. Raises ValueError
    when the points do not form a full uniform 1-D, 2-D or 3-D grid. The
    reference's numpy function (``gppe_tpu.ops.operators.grid_geometry``),
    copied with its tolerances: coordinates grouped at 9 decimals, spacing
    uniform to rtol 1e-5 and atol 3e-9, and each spacing taken from the
    raw coordinate extremes."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim == 1:
        pts = pts[:, None]
    n, d = pts.shape
    if d > 3:
        raise ValueError("grid operators support 1-D, 2-D or "
                         f"3-D grids (got dimension {d})")

    ms, hs, idx = [], [], []
    for j in range(d):
        ax = np.unique(np.round(pts[:, j], 9))
        m = ax.size
        if m > 1:
            h = np.diff(ax)
            # atol 3e-9: the 9-decimal grouping injects +-1e-9 jitter into
            # adjacent differences
            if not np.allclose(h, h.mean(), rtol=1e-5, atol=3e-9):
                raise ValueError(f"grid spacing is not uniform (axis {j})")
        # spacing from the raw coordinate extremes: the rounded values only
        # group (deriving h from them would bias every kernel value by
        # ~1e-9 of a coordinate)
        lo, hi = pts[:, j].min(), pts[:, j].max()
        h = float((hi - lo) / (m - 1)) if m > 1 else 1.0
        ms.append(m)
        hs.append(h)
        idx.append(np.rint((pts[:, j] - lo) / h).astype(np.int64))
    if int(np.prod(ms)) != n:
        raise ValueError(
            "points do not form a full regular grid "
            f"({' x '.join(map(str, ms))} axis values vs n = {n})")

    raster = idx[0]
    for j in range(1, d):
        raster = raster * ms[j] + idx[j]
    if np.unique(raster).size != n:
        raise ValueError("duplicate grid points")
    return tuple(ms), tuple(hs), np.argsort(raster), raster


def grid_distance_table(ms, hs, scale):
    """Scaled-offset distance table (m_1, ..., m_d), float64 numpy: entry
    a holds the anisotropic distance of grid offset a under per-axis
    ``scale``."""
    scale_d = np.broadcast_to(np.asarray(scale, dtype=np.float64),
                              (len(ms),))
    offs = [np.arange(m) * (h / s_) for m, h, s_ in zip(ms, hs, scale_d)]
    grids = np.meshgrid(*offs, indexing="ij")
    return np.sqrt(sum(g ** 2 for g in grids))


def circulant_rfft(k_tab, ms):
    """Real FFT of the circulant embedding of an offset kernel table.

    ``k_tab``: a real tensor (..., m_1, ..., m_d), leading batch axes
    allowed (the (rho, nu) surface passes a chunk of nodes at once). The
    embedding wraps each axis to 2 m_j; the Nyquist planes never reach the
    cropped corner block, so their clipped values are moot. The transform
    runs on the table's device in its precision (complex64 spectra for a
    float32 table)."""
    d = len(ms)
    wrap = [torch.as_tensor(np.clip(np.minimum(np.arange(2 * m),
                                               2 * m - np.arange(2 * m)),
                                    0, m - 1), device=k_tab.device)
            for m in ms]
    c = k_tab
    for j, w in enumerate(wrap):
        c = torch.index_select(c, k_tab.ndim - d + j, w)
    return torch.fft.rfftn(c, dim=tuple(range(-d, 0)))


def grid_trace_pow2(k_tab, ms):
    """Exact trace(K^2) from the offset kernel table, float64 on the
    table's device: offset a occurs prod_j (m_j - |a_j|) times (twice per
    nonzero component's sign). Leading batch axes of ``k_tab`` pass
    through."""
    k_tab = torch.as_tensor(k_tab)
    w = k_tab.to(torch.float64) ** 2
    rem = len(ms)
    for m in ms:
        a = torch.arange(m, dtype=torch.float64, device=k_tab.device)
        fac = torch.where(a == 0, 1.0, 2.0) * (m - a)
        # the first grid axis not yet contracted sits at ndim - rem
        w = torch.tensordot(w, fac, dims=([w.ndim - rem], [0]))
        rem -= 1
    return w


def grid_kernel_table(dist, nu, dtype):
    """k(dist; nu) over a float64 tensor of scaled offset distances, as a
    float64 tensor: the table of a :class:`GridMaternOperator` of
    ``dtype``.

    A closed form (1/2, 3/2, 5/2, >= 100) is evaluated elementwise in
    float64 (:func:`kernels.matern`), as the reference evaluates it. A
    general nu for a float32 operator takes the general-nu kernel's
    elementwise entry (:func:`cuda_kernels.matern_general`: on the card
    one launch over the float32 distances, on the CPU its plain version),
    its float32 k widened to float64. A float64 operator's general-nu
    table takes the float64 :func:`kernels.matern`: no hand kernel gives a
    float64 k (``csrc/matern_bessel.cuh`` is float32), and the reference's
    table is float64. That is a rule of the dtype, not a fallback: a
    float32 table on the card never reaches the plain form, and a failed
    launch raises. The float32 operator's route is the cheap one: over a
    1024 x 1024 table the plain float64 form takes 128 ms on an H100
    (80GB HBM3, 700 W), the kernel 0.23 ms, against 0.77 s for the whole
    fit of ``main_fft_grid``'s point (chip_profile.py fft-table-costs);
    its k lies within 7.7e-7 of float64."""
    if kernels.is_closed_form(nu) or dtype == torch.float64:
        return kernels.matern(dist.to(torch.float64), nu)
    k = cuda_kernels.matern_general(dist.to(torch.float32).contiguous(), nu)
    return k.to(torch.float64)


def _grid_matern_matmat_fft(V, chat, to_raster, from_raster, ms):
    """K @ V on a regular grid: gather to raster order, zero-pad to
    (2 m_1, ..., 2 m_d), real FFT, multiply by the embedded table's
    spectrum ``chat``, inverse FFT, crop, gather back.

    ``V``: (n, r), or (B, n, r) with ``chat`` (B, 2 m_1, ..., m_d + 1)
    (a batch of tables over one grid). The block is laid out as
    (..., r, 2 m_1, ..., 2 m_d): the columns are the batch dimension of
    the transforms over the last d axes, each a contiguous plane. Returns
    the product in V's layout, as a transposed view of a contiguous
    (..., r, n) tensor."""
    d = len(ms)
    r, n = V.shape[-1], V.shape[-2]
    corner = (Ellipsis,) + tuple(slice(0, m) for m in ms)
    Vr = V.transpose(-1, -2).index_select(-1, to_raster)     # (..., r, n)
    Vp = torch.zeros(V.shape[:-2] + (r,) + tuple(2 * m for m in ms),
                     dtype=V.dtype, device=V.device)
    Vp[corner] = Vr.reshape(V.shape[:-2] + (r,) + tuple(ms))
    dims = tuple(range(-d, 0))
    F = torch.fft.rfftn(Vp, dim=dims)
    del Vp
    F.mul_(chat.unsqueeze(chat.ndim - d))
    Y = torch.fft.irfftn(F, s=tuple(2 * m for m in ms), dim=dims)
    del F
    y = Y[corner].reshape(V.shape[:-2] + (r, n))
    return y.index_select(-1, from_raster).transpose(-1, -2)


class GridMaternOperator:
    """Exact Matern operator on a regular grid in O(n log n) a product, by
    circulant embedding and multi-dimensional FFT (1-D, 2-D or 3-D grids).

    Counterpart of ``gppe_tpu.ops.operators.GridMaternOperator``. A
    stationary kernel on a regular grid makes K (nested) block-Toeplitz:
    the unique-offset kernel table, embedded in a circulant along every
    axis, gives each product as pad -> rfftn -> multiply -> irfftn -> crop,
    exact (only the corner block, which is K, is read). Points may come
    in any order: the operator finds the grid and permutes internally.

    API: ``shape``, ``matmat``, ``matvec``, ``trace_pow``, ``dense``,
    ``device``, ``dtype`` - those of :class:`MaternOperator`. The offset
    table is float64 on ``device`` (:func:`grid_kernel_table`: a general
    nu of a float32 operator on the general-nu kernel's elementwise entry,
    where the reference evaluated it on the host CPU); the products run
    ``torch.fft`` (cuFFT on the card, a library call, as the reference
    computes them with ``jnp.fft``) in ``dtype``: float32 operands give
    complex64 spectra. Left out of the reference's class: its
    ``jit_operands`` (an argument-passing rule of its TPU compiler)."""

    def __init__(self, points, scale, nu=0.5, device="cuda",
                 dtype=torch.float32):
        setup()
        self.nu = cuda_kernels.check_nu(nu)
        self.device = resolve_device(device)
        self.dtype = dtype
        ms, hs, to_raster, from_raster = grid_geometry(points)
        self.ms = ms
        self._n = int(np.prod(ms))
        self._to_raster = torch.as_tensor(to_raster, device=self.device)
        self._from_raster = torch.as_tensor(from_raster, device=self.device)
        dist = torch.as_tensor(grid_distance_table(ms, hs, scale),
                               device=self.device)
        self._k_tab = grid_kernel_table(dist, self.nu, dtype)
        self._chat = circulant_rfft(self._k_tab.to(dtype), ms)

    @property
    def shape(self):
        return (self._n, self._n)

    def matmat(self, V):
        V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = _grid_matern_matmat_fft(V, self._chat, self._to_raster,
                                      self._from_raster, self.ms)
        return out[:, 0] if squeeze else out

    def matvec(self, v):
        return self.matmat(v)

    def trace_pow(self, exponent):
        """Exact trace(K^p) for p in {0, 1, 2}: n, n, and trace(K^2) from
        the float64 offset table (:func:`grid_trace_pow2`), a float64
        tensor on the device."""
        if exponent == 0 or exponent == 1:
            return torch.tensor(float(self._n), dtype=self.dtype,
                                device=self.device)
        if exponent == 2:
            return grid_trace_pow2(self._k_tab, self.ms)
        raise ValueError("exponent must be 0, 1 or 2")

    def dense(self):
        """Materialize K in ``dtype`` from the offset table (small-n
        debugging only): K[i, j] is the table at |a_i - a_j|, a_i the grid
        coordinates of point i."""
        coords = torch.stack(torch.unravel_index(self._from_raster, self.ms),
                             dim=1)                          # (n, d)
        offs = torch.abs(coords[:, None, :] - coords[None, :, :])
        return self._k_tab[tuple(offs.unbind(-1))].to(self.dtype)
