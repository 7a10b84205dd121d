"""The mixed-correlation operator K + eta*I.

Counterpart of :mod:`gppe_tpu.models.mixed_correlation` (the reference's
``MixedCorrelation`` over imate, mixed_correlation.py:25-335), with the
same surface — ``trace``, ``traceinv``, ``logdet``, ``solve``, ``dot``,
``get_matrix_size`` with an ``eta`` and an integer ``exponent`` — and
backends:

* ``eigenvalue`` (the default, as the reference's likelihood.py:41): one
  float64 eigendecomposition on the card up front (:func:`linalg.eigh`),
  then every trace / traceinv / logdet / solve at any eta is a diagonal
  operation; ``rotate`` exposes the eigenbasis, so the likelihood layer
  works in rotated coordinates at O(n m) per evaluation;
* ``cholesky``: a per-eta factorization on the card, with exact logdet
  and traceinv from the factor;
* ``hutchinson`` / ``slq``: :class:`~gppe_tpu_torch.ops.stochastic.
  StochasticTraceEngine` (built on first use) and batched CG solves;
* ``interpolate=True``: eta -> traceinv from a few exact values
  (:class:`~gppe_tpu_torch.ops.interpolate.TraceinvInterpolator`).

Device and dtype: a dense K is held on ``device`` (default the card) in
float64, which the H100 runs natively, so the eigendecomposition, the
rotation, Cholesky and the Lanczos passes over it run there in float64.
A matrix-free operator (anything with ``matvec``, such as
:class:`~gppe_tpu_torch.ops.operators.MaternOperator`) keeps its own
dtype, float32 through its kernel, must live on ``device``, and takes the
stochastic backends: ``eigenvalue`` and ``cholesky`` switch to ``slq``
with the reference's warning. A scipy-sparse K (the reference accepts CSR
throughout, mixed_correlation.py:44) is densified, float64 on ``device``
like a dense K, for ``eigenvalue`` and ``cholesky`` up to
``dense_threshold`` points; otherwise it becomes a float64
:class:`~gppe_tpu_torch.ops.operators.SparseOperator` on ``device``
(cuSPARSE's SpMM on the card) and the method switches to ``slq`` with the
reference's warning.

Every scalar method returns a 0-d tensor.
"""

import warnings

import numpy as np
import torch

from ..ops import linalg
from ..utils.config import resolve_device, setup


def _is_scipy_sparse(K):
    try:
        import scipy.sparse
    except ImportError:  # pragma: no cover
        return False
    return scipy.sparse.issparse(K)


class MixedCorrelation:
    """Operator view of K + eta*I with pluggable trace/solve backends."""

    def __init__(self, K, method="eigenvalue", interpolate=False,
                 interpolant_points=None, options=None, dense_threshold=4096,
                 *, device="cuda"):
        """``options``: keyword arguments of the stochastic engine
        (``num_probes``, ``lanczos_steps``, ``key``, ``generator``,
        ``probes``, ``v_defl``, ``deflate``, ...). ``dense_threshold``: a
        scipy-sparse K under ``eigenvalue`` or ``cholesky`` is densified up
        to this n; a larger one, or one under another method, is held as a
        :class:`SparseOperator` (and the exact methods switch to
        ``slq``)."""
        setup()
        self.device = resolve_device(device)
        self.is_sparse = _is_scipy_sparse(K)
        if self.is_sparse:
            n = K.shape[0]
            if method in ("eigenvalue", "cholesky") and n <= dense_threshold:
                K = K.toarray()
            else:
                from ..ops.operators import SparseOperator
                K = SparseOperator(K, device=self.device, dtype=torch.float64)
                if method in ("eigenvalue", "cholesky"):
                    warnings.warn(
                        f"method={method!r} on a sparse K with n={n} > "
                        f"dense_threshold={dense_threshold}: switching to "
                        "'slq' (stochastic Lanczos quadrature) - the exact "
                        "spectral backend would densify an n x n matrix",
                        stacklevel=2)
                    method = "slq"
        if hasattr(K, "matvec"):
            op_device = resolve_device(getattr(K, "device", self.device))
            if op_device != self.device:
                raise ValueError(f"operator is on {op_device}, "
                                 f"MixedCorrelation on {self.device}")
            self.dtype = K.dtype
        else:
            K = torch.as_tensor(K, dtype=torch.float64, device=self.device)
            self.dtype = torch.float64
        self.K = K
        self.n = K.shape[0]
        self.method = method
        self.options = dict(options or {})
        self.interpolate = interpolate
        self._traceinv_interp = None
        self.eigenvalues = None
        self.eigenvectors = None

        if hasattr(K, "matvec"):
            # matrix-free: only the stochastic methods apply, so the exact
            # defaults switch with a warning and the facade (default
            # 'eigenvalue', as the reference's) works on operator input
            if method in ("eigenvalue", "cholesky"):
                warnings.warn(
                    f"method={method!r} requires a materialized K; "
                    "switching to 'slq' for the matrix-free operator",
                    stacklevel=2)
                self.method = "slq"
        elif method == "eigenvalue":
            # one O(n^3) float64 eigendecomposition on K's device
            self.eigenvalues, self.eigenvectors = linalg.eigh(self.K)

        # the stochastic engine is built on first trace/logdet use: its
        # Lanczos passes are wasted on callers that only solve
        self._stoch = None

        if interpolate:
            from ..ops.interpolate import TraceinvInterpolator
            if interpolant_points is None:
                interpolant_points = np.logspace(-4, 3, 8)
            self._traceinv_interp = TraceinvInterpolator(
                self, np.asarray(interpolant_points, dtype=np.float64))

    # -- basic queries ----------------------------------------------------

    def get_matrix_size(self):
        return self.n

    @property
    def shape(self):
        return (self.n, self.n)

    def _get_stoch(self):
        if self._stoch is None and self.method in ("slq", "hutchinson"):
            from ..ops.stochastic import StochasticTraceEngine
            self._stoch = StochasticTraceEngine(self.K, **self.options)
        return self._stoch

    def _tensor(self, Y):
        return torch.as_tensor(Y, dtype=self.dtype, device=self.device)

    def rotate(self, V):
        """Q^T V — coordinates in the eigenbasis (eigenvalue method only),
        float64 on the device."""
        if self.eigenvectors is None:
            raise ValueError("rotate() requires method='eigenvalue'")
        return self.eigenvectors.T @ self._tensor(V)

    # -- trace family -----------------------------------------------------

    def trace(self, eta, exponent=1):
        """trace((K + eta I)^exponent); exact for exponent in {0, 1, 2} by
        the binomial expansion (reference mixed_correlation.py:108-125),
        spectral or stochastic otherwise."""
        eta = float(eta)
        if exponent == 0:
            return torch.tensor(float(self.n), dtype=torch.float64)
        if exponent == 1:
            return self._trace_K(1) + eta * self.n
        if exponent == 2:
            return (self._trace_K(2) + 2.0 * eta * self._trace_K(1)
                    + eta ** 2 * self.n)
        if self.eigenvalues is not None:
            return torch.sum((self.eigenvalues + eta) ** exponent)
        stoch = self._get_stoch()
        if stoch is not None:
            return torch.tensor(stoch.trace_pow(eta, exponent))
        raise ValueError("trace with exponent>2 needs eigenvalue or "
                         "stochastic method")

    def _trace_K(self, exponent):
        if self.eigenvalues is not None:
            return torch.sum(self.eigenvalues ** exponent)
        if hasattr(self.K, "trace_pow"):
            return self.K.trace_pow(exponent)
        if exponent == 1:
            return torch.trace(self.K)
        if exponent == 2:
            return torch.sum(self.K * self.K)
        raise ValueError(exponent)

    def traceinv(self, eta, exponent=1):
        """trace((K + eta I)^-exponent)."""
        if self._traceinv_interp is not None and exponent == 1:
            return self._traceinv_interp(eta)
        return self._traceinv_exact(eta, exponent)

    def _traceinv_exact(self, eta, exponent=1):
        eta = float(eta)
        if self.eigenvalues is not None:
            return torch.sum((self.eigenvalues + eta) ** -exponent)
        if self.method == "cholesky":
            return linalg.cholesky_traceinv(self._factor(eta), exponent)
        stoch = self._get_stoch()
        if stoch is not None:
            return torch.tensor(stoch.traceinv(eta, exponent))
        raise ValueError(f"no traceinv backend for method={self.method!r}")

    def logdet(self, eta, exponent=1):
        """exponent * log det(K + eta I) (reference
        mixed_correlation.py:221-274)."""
        eta = float(eta)
        if self.eigenvalues is not None:
            return exponent * torch.sum(torch.log(self.eigenvalues + eta))
        if (self.method in ("cholesky", "hutchinson")
                and not hasattr(self.K, "matvec")):
            # hutchinson has no logdet; the reference falls back to
            # cholesky there too (mixed_correlation.py:250-261). A
            # matrix-free K cannot be factorized: SLQ below
            return exponent * linalg.cholesky_logdet(self._factor(eta))
        stoch = self._get_stoch()
        if stoch is not None:
            return exponent * torch.tensor(stoch.logdet(eta))
        raise ValueError(f"no logdet backend for method={self.method!r}")

    # -- solve / dot ------------------------------------------------------

    def _factor(self, eta):
        eye = torch.eye(self.n, dtype=self.K.dtype, device=self.device)
        return linalg.cholesky_factor(self.K + float(eta) * eye)

    def solve(self, eta, Y, tol=1e-6):
        """(K + eta I)^-1 Y (reference mixed_correlation.py:280-299): a
        spectral solve, batched CG through an operator's ``matmat``, or a
        Cholesky solve of a dense K."""
        Y = self._tensor(Y)
        eta = float(eta)
        if self.eigenvalues is not None:
            Q = self.eigenvectors
            D = 1.0 / (self.eigenvalues + eta)
            Yt = Q.T @ Y
            return Q @ (D * Yt if Y.ndim == 1 else D[:, None] * Yt)
        if hasattr(self.K, "matvec"):
            return linalg.cg_solve(self.K.matmat, Y, tol=tol, shift=eta)
        return linalg.cholesky_solve(self._factor(eta), Y)

    def dot(self, eta, x, exponent=1):
        """(K + eta I)^exponent x, the operator applied ``exponent`` times
        (the reference's version accumulates q (K x + eta x) instead,
        mixed_correlation.py:328-335)."""
        if not isinstance(exponent, int) or exponent < 0:
            raise ValueError("exponent must be a non-negative integer")
        y = self._tensor(x)
        eta = float(eta)
        for _ in range(exponent):
            if hasattr(self.K, "matvec"):
                Ky = self.K.matmat(y)
            else:
                Ky = self.K @ y
            y = Ky + eta * y
        return y
