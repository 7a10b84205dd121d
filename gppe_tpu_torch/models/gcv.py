"""Generalized cross-validation noise estimation.

Counterpart of :mod:`gppe_tpu.models.gcv`. For the model
z ~ N(X beta, sigma^2 K + sigma0^2 I) with the REML projector M(eta)
(reference _direct_likelihood.py:276-340), the smoother residual is
eta M z, giving the Golub-Heath-Wahba functional

    V(eta) = n * z^T M^2 z / trace(M)^2,

whose minimizer estimates eta and the noise through
sigma0_hat^2 = eta z^T M^2 z / trace(M). Its pieces are the spectral
O(n m) quantities of the profile likelihood (float64, host), batched over
a tensor of etas; dV/d(log eta) comes from ``torch.func.grad``.
"""

import numpy as np
import torch

from ..ops import root_finding
from .profile_likelihood import _eta_stats, _trace_M


def gcv_function(data, eta):
    """V(eta) for a tensor of etas of any shape."""
    lam, Xt, zt = data
    n = Xt.shape[0]
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
    zM2z = torch.sum(Mzt * Mzt, dim=-1)
    return n * zM2z / _trace_M(D, Yt, Binv) ** 2


def minimize_gcv(data, interval_eta=(1e-4, 1e3), tol=1e-8):
    """Minimize V over eta: the root of dV/d(log10 eta) by bracket and
    Chandrupatla (autodiff derivative), with a grid fallback."""
    dV_scalar = torch.func.grad(
        lambda le: gcv_function(data, 10.0 ** le))

    def dV(le):
        le = torch.as_tensor(le, dtype=torch.float64)
        return torch.func.vmap(dV_scalar)(le.reshape(-1)).reshape(le.shape)

    lo, hi = np.log10(interval_eta[0]), np.log10(interval_eta[1])
    found, bracket, fvals = root_finding.find_interval_with_sign_change(
        lambda le: float(dV(le)), [lo, hi], 4)
    if found:
        root, _ = root_finding.chandrupatla(
            dV, bracket[0], bracket[1], f0=fvals[0], f1=fvals[1],
            eps_m=tol, eps_a=tol)
        eta = float(10.0 ** float(root))
    else:
        grid = np.logspace(lo, hi, 200)
        vals = gcv_function(data, torch.as_tensor(grid)).numpy()
        eta = float(grid[np.argmin(vals)])

    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
    trace_M = float(_trace_M(D, Yt, Binv))
    zM2z = float(Mzt @ Mzt)
    sigma0_sq = eta * zM2z / trace_M
    return {
        "eta": eta,
        "sigma0": float(np.sqrt(max(sigma0_sq, 0.0))),
        "gcv": float(gcv_function(data, eta)),
    }
