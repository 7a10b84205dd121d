"""Generalized cross-validation noise estimation.

Counterpart of :mod:`gppe_tpu.models.gcv`. For the model
z ~ N(X beta, sigma^2 K + sigma0^2 I) with the REML projector M(eta)
(reference _direct_likelihood.py:276-340), the smoother residual is
eta M z, giving the Golub-Heath-Wahba functional

    V(eta) = n * z^T M^2 z / trace(M)^2,

whose minimizer estimates eta and the noise through
sigma0_hat^2 = eta z^T M^2 z / trace(M). Its pieces are the spectral
O(n m) quantities of the profile likelihood (float64, host), batched over
a tensor of etas. dV/d(log10 eta) is closed form: dM/d eta = -M^2 (the
REML projector's identity, as in the profile likelihood's second
derivative), so d(z^T M^2 z) = -2 z^T M^3 z and d trace(M) = -trace(M^2)
per unit eta: about the cost of one evaluation of V, which matters where
a noise sweep runs hundreds of minimisations.
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


def gcv_der1_log_eta(data, log_eta):
    """dV / d(log10 eta) for a tensor of log10 etas of any shape."""
    lam, Xt, zt = data
    n = Xt.shape[0]
    log_eta = torch.as_tensor(log_eta, dtype=lam.dtype)
    eta = 10.0 ** log_eta
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
    # M (M z) in the eigenbasis, M = D - Yt B^-1 Yt^T
    c = torch.einsum("...ij,...j->...i", Binv,
                     torch.einsum("...ni,...n->...i", Yt, Mzt))
    M2zt = D * Mzt - torch.einsum("...ni,...i->...n", Yt, c)
    zM2z = torch.sum(Mzt * Mzt, dim=-1)
    zM3z = torch.sum(Mzt * M2zt, dim=-1)
    A = Binv @ torch.einsum("...ni,...nj->...ij", Yt, Yt)
    C = Binv @ torch.einsum("...ni,...nj->...ij", Yt, D[..., :, None] * Yt)
    trace_M = _trace_M(D, Yt, Binv)
    trace_M2 = (torch.sum(D * D, dim=-1)
                - 2.0 * torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)
                + torch.diagonal(A @ A, dim1=-2, dim2=-1).sum(-1))
    dV_deta = (2.0 * n * (zM2z * trace_M2 - zM3z * trace_M)
               / trace_M ** 3)
    return eta * np.log(10.0) * dV_deta


def minimize_gcv(data, interval_eta=(1e-4, 1e3), tol=1e-8):
    """Minimize V over eta: the root of dV/d(log10 eta)
    (:func:`gcv_der1_log_eta`) by bracket and Chandrupatla, with a grid
    fallback."""
    def dV(le):
        return gcv_der1_log_eta(data, le)

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
