"""Direct (sigma, sigma0) restricted maximum likelihood.

Counterpart of :mod:`gppe_tpu.models.direct_likelihood` (the reference's
DirectLikelihood, _direct_likelihood.py:25-405) in the eigenbasis of K:
with K = Q diag(lam) Q^T, every quantity of the REML log-likelihood

    lp = -1/2 (n-m) log 2pi - 1/2 logdet(S) - 1/2 logdet(X^T S^-1 X)
         - 1/2 z^T M z,      S = sigma^2 K + sigma0^2 I

is diagonal arithmetic on the rotated design Xt = Q^T X and data
zt = Q^T z. The rotation is an O(n^2 m) float64 product on the card
(:meth:`MixedCorrelation.rotate`); the O(n m) data it leaves, and every
likelihood, derivative and optimizer step on it, is float64 on the host:
a design choice (the per-eta scalars are tiny and sequential), as in the
reference's ``inference_device`` on a TPU. The optimizer differentiates
``log_likelihood`` with ``torch.func`` through :class:`SpectralData`,
never through the eigendecomposition, so each derivative stays O(n m).
"""

import math
from typing import NamedTuple

import torch

from ..ops.optimize import trust_region_minimize

_SIGMA_TOL = 1e-8


class SpectralData(NamedTuple):
    """Problem data rotated into the eigenbasis of K (float64, host)."""
    lam: torch.Tensor   # (n,) eigenvalues of K
    Xt: torch.Tensor    # (n, m) Q^T X
    zt: torch.Tensor    # (n,)  Q^T z


def make_spectral_data(K_mixed, X, z):
    """Rotate (X, z) into the eigenbasis held by a MixedCorrelation (on its
    device, float64) and bring the O(n m) result to the host in float64."""
    def host(a):
        return a.to(device="cpu", dtype=torch.float64)

    return SpectralData(lam=host(K_mixed.eigenvalues),
                        Xt=host(K_mixed.rotate(X)),
                        zt=host(K_mixed.rotate(z)))


def _spd_inv_logdet(B):
    """Inverse and logdet of small SPD matrices (..., m, m) via Cholesky."""
    L = torch.linalg.cholesky(B)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    Binv = torch.cholesky_solve(eye.expand(B.shape), L)
    logdet_B = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                               dim=-1)
    return Binv, logdet_B


def _projector_stats(data, D):
    """Shared pieces: Yt = D*Xt (rotated Kn^-1 X), B, Binv, logdet_B and
    the rotated M z without its 1/sigma^2, with
    M = Kn^-1 (I - X (X^T Kn^-1 X)^-1 X^T Kn^-1). ``D`` is (..., n): every
    leading index is one eta."""
    lam, Xt, zt = data
    Yt = D[..., :, None] * Xt
    B = torch.einsum("ni,...nj->...ij", Xt, Yt)
    Binv, logdet_B = _spd_inv_logdet(B)
    Ytz = torch.einsum("...nj,n->...j", Yt, zt)
    c = torch.einsum("...ij,...j->...i", Binv, Ytz)
    Mzt = D * zt - torch.einsum("...ni,...i->...n", Yt, c)
    return Yt, B, Binv, logdet_B, Mzt


def log_likelihood(data, sigma, sigma0):
    """REML log-likelihood at (sigma, sigma0), differentiable by
    ``torch.func``. Matches reference _direct_likelihood.py:32-83,
    including the degenerate sigma -> 0 branch (:50-55), selected with a
    NaN-safe double ``where``."""
    lam, Xt, zt = data
    n, m = Xt.shape
    sigma = torch.as_tensor(sigma, dtype=zt.dtype)
    sigma0 = torch.as_tensor(sigma0, dtype=zt.dtype)

    degenerate = torch.abs(sigma) < _SIGMA_TOL
    sigma_safe = torch.where(degenerate, 1.0, sigma)

    # --- regular branch (sigma > 0): work with Kn = K + eta I -----------
    eta = (sigma0 / sigma_safe) ** 2
    D = 1.0 / (lam + eta)
    logdet_S_reg = (n * torch.log(sigma_safe ** 2)
                    + torch.sum(torch.log(lam + eta)))
    Yt, B, Binv, logdet_B, Mzt = _projector_stats(data, D)
    logdet_XtSinvX_reg = logdet_B - m * torch.log(sigma_safe ** 2)
    zMz_reg = (zt @ Mzt) / sigma_safe ** 2

    # --- degenerate branch (sigma ~ 0): S = sigma0^2 I ------------------
    logdet_S_deg = n * torch.log(sigma0 ** 2)
    B0inv, logdet_B0 = _spd_inv_logdet(Xt.T @ Xt)
    logdet_XtSinvX_deg = logdet_B0 - m * torch.log(sigma0 ** 2)
    Mzt_deg = zt - Xt @ (B0inv @ (Xt.T @ zt))
    zMz_deg = (zt @ Mzt_deg) / sigma0 ** 2

    logdet_S = torch.where(degenerate, logdet_S_deg, logdet_S_reg)
    logdet_XtSinvX = torch.where(degenerate, logdet_XtSinvX_deg,
                                 logdet_XtSinvX_reg)
    zMz = torch.where(degenerate, zMz_deg, zMz_reg)
    return (-0.5 * (n - m) * math.log(2.0 * math.pi) - 0.5 * logdet_S
            - 0.5 * logdet_XtSinvX - 0.5 * zMz)


def log_likelihood_jacobian(data, sigma, sigma0):
    """Analytic (d lp / d sigma^2, d lp / d sigma0^2) (identities of
    reference _direct_likelihood.py:89-157, in the sigma^2 coordinates the
    reference's trace identities hold in):
    d lp/d(sigma^2) = -1/2 tr(KM) + 1/2 z M K M z,
    d lp/d(sigma0^2) = -1/2 tr(M) + 1/2 z M M z."""
    lam, Xt, zt = data
    n, m = Xt.shape
    eta = (sigma0 / sigma) ** 2
    D = 1.0 / (lam + eta)
    Yt, B, Binv, logdet_B, Mzt = _projector_stats(data, D)
    Mzt = Mzt / sigma ** 2                      # true M z (rotated)
    KMzt = lam * Mzt
    zMMz = Mzt @ Mzt
    zMKMz = Mzt @ KMzt

    trace_Sinv = torch.sum(D) / sigma ** 2
    trace_BinvYtY = torch.trace(Binv @ (Yt.T @ Yt))  # scale-free
    trace_M = trace_Sinv - trace_BinvYtY / sigma ** 2
    trace_KM = (n - m) / sigma ** 2 - eta * trace_M

    der_sigma2 = -0.5 * trace_KM + 0.5 * zMKMz
    der_sigma02 = -0.5 * trace_M + 0.5 * zMMz
    return torch.stack([der_sigma2, der_sigma02])


def log_likelihood_hessian(data, sigma, sigma0):
    """Analytic Hessian in (sigma^2, sigma0^2) coordinates (identities of
    reference _direct_likelihood.py:163-270)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    eta = (sigma0 / sigma) ** 2
    D = 1.0 / (lam + eta)
    Yt, B, Binv, logdet_B, Mzt_raw = _projector_stats(data, D)

    s2 = sigma ** 2
    Mzt = Mzt_raw / s2
    YtY = Yt.T @ Yt
    YtV = (D[:, None] * Yt).T @ Yt   # = Xt^T D^3 Xt (scale-free pieces)
    A = Binv @ YtY                   # scale-free: B^-1 (Xt^T D^2 Xt)
    C = Binv @ YtV

    # true-scale projector (rotated): M v = [D v - Yt B^-1 Yt^T v] / s2
    def M_dot(v):
        return (D * v - Yt @ (Binv @ (Yt.T @ v))) / s2

    MMzt = M_dot(Mzt)
    KMzt = lam * Mzt
    MKMzt = M_dot(KMzt)

    zMMMz = Mzt @ MMzt
    zMMKMz = MMzt @ KMzt
    zMKMKMz = KMzt @ MKMzt

    trace_Sinv = torch.sum(D) / s2
    trace_M = trace_Sinv - torch.trace(A) / s2
    trace_S2inv = torch.sum(D * D) / s2 ** 2
    trace_M2 = (trace_S2inv - 2.0 * torch.trace(C) / s2 ** 2
                + torch.trace(A @ A) / s2 ** 2)
    trace_KMKM = ((n - m) / s2 ** 2 - (2 * eta / s2) * trace_M
                  + eta ** 2 * trace_M2)
    trace_KMM = trace_M / s2 - eta * trace_M2

    der2_s02_s02 = 0.5 * (trace_M2 - 2.0 * zMMMz)
    der2_s2_s2 = 0.5 * (trace_KMKM - 2.0 * zMKMKMz)
    der2_s2_s02 = 0.5 * (trace_KMM - 2.0 * zMMKMz)
    return torch.stack([torch.stack([der2_s2_s2, der2_s2_s02]),
                        torch.stack([der2_s2_s02, der2_s02_s02])])


def maximize_log_likelihood(data, tol=1e-3, hyperparam_guess=(0.2, 0.2),
                            max_iter=100, verbose=False):
    """MLE over (sigma, sigma0) by trust-region Newton on the spectral
    likelihood; mirrors reference _direct_likelihood.py:346-405 (guess
    [0.2, 0.2], tol 1e-3, trust region with the exact Hessian)."""
    def neg_lp(hp):
        return -log_likelihood(data, hp[0], hp[1])

    res = trust_region_minimize(
        neg_lp, torch.as_tensor(hyperparam_guess, dtype=data.lam.dtype),
        gtol=tol, max_iter=max_iter, initial_radius=0.1)
    sigma = abs(float(res.x[0]))
    sigma0 = abs(float(res.x[1]))
    if verbose:
        print(f"direct MLE: iters={res.iterations} "
              f"|grad|={res.grad_norm:.3e} success={res.success}")
    eta = (sigma0 / sigma) ** 2 if sigma > 0 else float("inf")
    return {
        "sigma": sigma,
        "sigma0": sigma0,
        "eta": eta,
        "max_lp": -res.fun,
        "iterations": res.iterations,
        "success": bool(res.success),
    }
