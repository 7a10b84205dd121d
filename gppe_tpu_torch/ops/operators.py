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
