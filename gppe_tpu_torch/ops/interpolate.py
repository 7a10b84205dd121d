"""Interpolation of eta -> trace((K + eta I)^-1).

Counterpart of :mod:`gppe_tpu.ops.interpolate` (the role of
imate.InterpolateTraceInv, reference mixed_correlation.py:52-66,167-170):
traceinv at a few interpolant etas, then any eta in O(1). The default
kind 'loglog-spline' is a natural cubic spline in (log eta, log traceinv);
'rational' is the low-order rational fit of the reference's GCV data
(no path of the port asks for it: MixedCorrelation builds the spline).
Host float64 numpy, copied from the reference; an evaluation returns a
0-d float64 tensor.
"""

import numpy as np
import torch


def _natural_cubic_spline_coeffs(x, y):
    """Natural cubic spline second-derivative table (tridiagonal solve)."""
    n = len(x)
    h = np.diff(x)
    rhs = np.zeros(n)
    rhs[1:-1] = 6.0 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    A = np.zeros((n, n))
    A[0, 0] = 1.0
    A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2.0 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
    return np.linalg.solve(A, rhs)   # second derivatives at knots


class TraceinvInterpolator:
    """Callable eta -> trace((K + eta I)^-1) from ``K_mixed``'s exact
    traceinv at ``interpolant_points``."""

    def __init__(self, K_mixed, interpolant_points, kind="loglog-spline",
                 order=2):
        pts = np.sort(np.asarray(interpolant_points, dtype=np.float64))
        if np.any(pts <= 0):
            raise ValueError("interpolant points must be positive")
        self.n = K_mixed.get_matrix_size()
        values = np.array([float(K_mixed._traceinv_exact(e)) for e in pts])
        self.points = pts
        self.values = values
        self.kind = kind

        if kind == "loglog-spline":
            self._x = np.log(pts)
            self._y = np.log(values)
            self._m = _natural_cubic_spline_coeffs(self._x, self._y)
        elif kind == "rational":
            self._fit_rational(order)
        else:
            raise ValueError(f"unknown interpolation kind {kind!r}")

    def _fit_rational(self, p):
        """traceinv(eta) ~= n (s^{p-1} + a_{p-2} s^{p-2} + ... ) /
        (s^p + b_{p-1} s^{p-1} + ...) with s = eta/scale; 2p-1
        collocation points."""
        npts = 2 * p - 1
        if len(self.points) < npts:
            raise ValueError(f"rational order {p} needs {npts} points")
        idx = np.linspace(0, len(self.points) - 1, npts).round().astype(int)
        self._scale = np.exp(np.mean(np.log(self.points[idx])))
        e = self.points[idx] / self._scale
        t = self.values[idx] / self.n * self._scale
        A = np.zeros((npts, npts))
        rhs = np.zeros(npts)
        for i, (ei, ti) in enumerate(zip(e, t)):
            A[i, :p - 1] = ei ** np.arange(p - 1)
            A[i, p - 1:] = -ti * ei ** np.arange(p)
            rhs[i] = ti * ei ** p - ei ** (p - 1)
        coef = np.linalg.solve(A, -rhs)
        self.num_coef = np.concatenate([coef[:p - 1], [1.0]])
        self.den_coef = np.concatenate([coef[p - 1:], [1.0]])
        self.order = p

    def __call__(self, eta):
        eta = np.asarray(eta.cpu() if torch.is_tensor(eta) else eta,
                         dtype=np.float64)
        if self.kind == "rational":
            s = eta / self._scale
            num = np.polyval(self.num_coef[::-1], s)
            den = np.polyval(self.den_coef[::-1], s)
            return torch.as_tensor(self.n / self._scale * num / den)

        x = np.log(np.clip(eta, self.points[0], self.points[-1]))
        xs, ys, ms = self._x, self._y, self._m
        i = np.clip(np.searchsorted(xs, x) - 1, 0, len(xs) - 2)
        x0, x1 = xs[i], xs[i + 1]
        h = x1 - x0
        tA = (x1 - x) / h
        tB = (x - x0) / h
        y = (tA * ys[i] + tB * ys[i + 1]
             + ((tA ** 3 - tA) * ms[i] + (tB ** 3 - tB) * ms[i + 1])
             * h * h / 6.0)
        return torch.as_tensor(np.exp(y))
