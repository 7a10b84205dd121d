"""Profile likelihood over eta with sigma profiled out analytically.

Counterpart of :mod:`gppe_tpu.models.profile_likelihood` (the reference's
ProfileLikelihood, _profile_likelihood.py:32-542): sigma^2(eta) =
z^T M z / (n - m) is substituted, and the MLE over eta is the zero of
d lp / d eta, found by bracketing and Chandrupatla (reference :244-415).
Every per-eta quantity is a diagonal operation in the eigenbasis, float64
on the host (see :mod:`.direct_likelihood`). The per-eta pieces are
batched formulas over a tensor of etas, so a scan of many etas is one
set of tensor operations, not a Python loop over etas.
"""

import warnings

import numpy as np
import torch

from ..ops import root_finding
from .direct_likelihood import (SpectralData, _spd_inv_logdet,  # noqa: F401
                                make_spectral_data)


def _eta_stats(data, eta):
    """Shared per-eta pieces for a tensor ``eta`` of any shape S: D (S, n),
    Yt = D Xt (S, n, m), B, Binv (S, m, m), logdet_B (S) and the rotated
    M z (S, n) at Kn scale (no sigma)."""
    lam, Xt, zt = data
    eta = torch.as_tensor(eta, dtype=lam.dtype)
    D = 1.0 / (lam + eta[..., None])
    Yt = D[..., :, None] * Xt
    B = torch.einsum("ni,...nj->...ij", Xt, Yt)
    Binv, logdet_B = _spd_inv_logdet(B)
    Ytz = torch.einsum("...nj,n->...j", Yt, zt)
    Mzt = D * zt - torch.einsum("...ni,...i->...n", Yt,
                                torch.einsum("...ij,...j->...i", Binv, Ytz))
    return D, Yt, B, Binv, logdet_B, Mzt


def _trace_M(D, Yt, Binv):
    """trace(M) at Kn scale: trace(Kn^-1) - trace(B^-1 Y^T Y)."""
    YtY = torch.einsum("...ni,...nj->...ij", Yt, Yt)
    return (torch.sum(D, dim=-1)
            - torch.einsum("...ij,...ji->...", Binv, YtY))


def log_likelihood(data, sigma, eta):
    """lp(sigma, eta) (reference _profile_likelihood.py:38-85)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    sigma = torch.as_tensor(sigma, dtype=lam.dtype)
    eta = torch.as_tensor(eta, dtype=lam.dtype)
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
    logdet_Kn = torch.sum(torch.log(lam + eta[..., None]), dim=-1)
    zMz = Mzt @ zt
    return (-0.5 * (n - m) * torch.log(sigma ** 2) - 0.5 * logdet_Kn
            - 0.5 * logdet_B - 0.5 / sigma ** 2 * zMz)


def log_likelihood_der1_eta(data, log_eta):
    """d lp / d eta at the profiled sigma^2(eta), input in log10(eta)
    (reference _profile_likelihood.py:91-132), for a tensor of log-etas of
    any shape at once."""
    lam, Xt, zt = data
    n, m = Xt.shape
    log_eta = torch.as_tensor(log_eta, dtype=lam.dtype)
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, 10.0 ** log_eta)
    zMz = Mzt @ zt
    zM2z = torch.sum(Mzt * Mzt, dim=-1)
    sigma2 = zMz / (n - m)
    return -0.5 * (_trace_M(D, Yt, Binv) - zM2z / sigma2)


def log_likelihood_der2_eta(data, eta):
    """d^2 lp / d eta^2 at the profiled sigma (reference :138-192)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)

    YtY = Yt.T @ Yt
    A = Binv @ YtY
    trace_M = torch.sum(D) - torch.trace(A)

    YtV = Yt.T @ (D[:, None] * Yt)          # = Xt^T D^3 Xt
    C = Binv @ YtV
    trace_M2 = torch.sum(D * D) - 2.0 * torch.trace(C) + torch.trace(A @ A)

    MMzt = D * Mzt - Yt @ (Binv @ (Yt.T @ Mzt))
    zMz = zt @ Mzt
    zM3z = Mzt @ MMzt
    sigma2 = zMz / (n - m)
    return (0.5 / sigma2) * ((trace_M2 / (n - m)
                              + (trace_M / (n - m)) ** 2) * zMz - 2.0 * zM3z)


def find_optimal_sigma(data, eta):
    """Closed-form sigma(eta) (reference :259-275)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    Mzt = _eta_stats(data, eta)[-1]
    return torch.sqrt((Mzt @ zt) / (n - m))


def find_optimal_sigma0(data):
    """sigma0 at eta -> inf where sigma = 0 (reference :281-295)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    B0inv, _ = _spd_inv_logdet(Xt.T @ Xt)
    v = Xt @ (B0inv @ (Xt.T @ zt))
    return torch.sqrt((zt @ (zt - v)) / (n - m))


def compute_bounds_der1_eta(data, eta):
    """Analytic upper/lower bounds of d lp/d eta from the extreme
    eigenvalues (reference :456-477)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    ub = 0.5 * (n - m) * (1.0 / (eta + lam[0]) - 1.0 / (eta + lam[-1]))
    return ub, -ub


def compute_asymptote_der1_eta(K, X, z, eta):
    """Dense host float64 evaluation of the reference's asymptote formulas
    (reference _profile_likelihood.py:483-542), copied unchanged; ``K``
    may be a tensor on any device."""
    if torch.is_tensor(K):
        K = K.detach().cpu().numpy()
    K = np.asarray(K, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    eta = np.atleast_1d(np.asarray(eta, dtype=float))
    n, m = X.shape
    I_n = np.eye(n)
    Q = X @ np.linalg.solve(X.T @ X, X.T)
    R = I_n - Q
    N = K @ R
    N2 = N @ N
    N3 = N2 @ N
    N4 = N3 @ N
    mtrN = np.trace(N) / (n - m)
    mtrN2 = np.trace(N2) / (n - m)
    A0 = -R @ (mtrN * I_n - N)
    A1 = R @ (mtrN * N + mtrN2 * I_n - 2 * N2)
    A2 = -R @ (mtrN * N2 + mtrN2 * N - 2 * N3)
    A3 = R @ (mtrN2 * N2 - N4)
    zRz = z @ (R @ z)
    zc = z / np.sqrt(zRz)
    a0 = zc @ (A0 @ zc)
    a1 = zc @ (A1 @ zc)
    a2 = zc @ (A2 @ zc)
    a3 = zc @ (A3 @ zc)
    asym1 = (-0.5 * (n - m)) * (a0 + a1 / eta) / eta ** 2
    asym2 = (-0.5 * (n - m)) * (a0 + a1 / eta + a2 / eta ** 2
                                + a3 / eta ** 3) / eta ** 2
    roots1 = np.roots([a0, a1])
    roots2 = np.roots([a0, a1, a2, a3])
    roots2 = np.sort(np.real(roots2[np.abs(np.imag(roots2)) < 1e-10]))
    return asym1, asym2, roots1, roots2


def find_log_likelihood_der1_zeros(data, interval_eta, tol=1e-6,
                                   max_iterations=100, num_bracket_trials=3,
                                   verbose=False):
    """Root of d lp/d eta = 0 in log10(eta) (reference :244-415), with the
    boundary-optimum fallback from the sign of the second derivative at
    eta = 0 (:352-405) when no bracket is found."""
    def der1(le):
        return log_likelihood_der1_eta(data, le)

    found, bracket, bracket_values = (
        root_finding.find_interval_with_sign_change(
            lambda le: float(der1(le)),
            [float(np.log10(interval_eta[0])),
             float(np.log10(interval_eta[1]))],
            num_bracket_trials, verbose=verbose))

    if found:
        root, iters = root_finding.chandrupatla(
            der1, bracket[0], bracket[1], f0=bracket_values[0],
            f1=bracket_values[1], eps_m=tol, eps_a=tol,
            max_iter=max_iterations)
        eta = float(10.0 ** float(root))
        sigma = float(find_optimal_sigma(data, eta))
        return {"sigma": sigma, "sigma0": float(np.sqrt(eta) * sigma),
                "eta": eta, "success": True, "iterations": int(iters)}

    # no sign change: the boundary optimum from the sign of the second
    # derivative at eta = 0
    f_left, f_right = bracket_values
    d2_zero = float(log_likelihood_der2_eta(data, 0.0))
    if f_left > 0 and f_right > 0:
        eta = 0.0 if d2_zero > 0 else np.inf
    elif f_left < 0 and f_right < 0:
        eta = 0.0 if d2_zero < 0 else np.inf
    else:
        # mixed signs but the bracket search failed anyway: degenerate
        # (the reference reasons about it through der2 too and warns,
        # _profile_likelihood.py:383-405)
        warnings.warn(
            "profile-likelihood derivative has mixed signs at the "
            "interval ends but no sign-change bracket was found: "
            "degenerate case, falling back to the eta = 0 boundary; "
            "widen interval_eta or raise num_bracket_trials",
            stacklevel=2)
        eta = 0.0
    if eta == 0.0:
        result = {"sigma": float(find_optimal_sigma(data, 0.0)),
                  "sigma0": 0.0, "eta": 0.0, "success": True}
    else:
        result = {"sigma": 0.0, "sigma0": float(find_optimal_sigma0(data)),
                  "eta": np.inf, "success": True}
    result["iterations"] = 0
    return result


def maximize_log_likelihood_with_sigma_eta(data, tol=1e-6,
                                           hyperparam_guess=(0.1, 0.1)):
    """Two-parameter (sigma, eta) maximization (reference :198-238, which
    uses Nelder-Mead; here trust-region Newton on log-parameters for
    positivity, as in the JAX package)."""
    from ..ops.optimize import trust_region_minimize

    def neg_lp(q):
        return -log_likelihood(data, torch.exp(q[0]), torch.exp(q[1]))

    q0 = torch.log(torch.as_tensor(hyperparam_guess, dtype=torch.float64))
    res = trust_region_minimize(neg_lp, q0, gtol=tol, max_iter=200,
                                initial_radius=1.0)
    sigma = float(torch.exp(res.x[0]))
    eta = float(torch.exp(res.x[1]))
    return {"sigma": sigma, "sigma0": float(np.sqrt(eta) * sigma),
            "eta": eta, "max_lp": -res.fun, "success": bool(res.success)}
