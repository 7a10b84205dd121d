"""Posterior and likelihood over the outer kernel hyperparameters, dense.

Counterpart of ``gppe_tpu.models.kernel_posterior``. The reference's
outer loop evaluates, for each (rho, nu), the profile likelihood at the
inner-optimal (sigma, sigma0) (reference:
examples/FindOptimalCovarianceParameters.py:87-199,
PartialLikelihoodFunction). Here ``profile_loglik(log10_eta, log10_rho)``
is one differentiable pipeline of float64 torch on the given device:
the dense Matern K (the plain ``ops/kernels.matern``), its Cholesky
factorization (cuSOLVER on the card), the triangular solves and sigma^2
profiled as zMz / (n - m). Samplers take gradients with
``torch.func.grad`` (or ``jacfwd``) and batch chains with
``torch.func.vmap``, so every function here avoids Python branches on
tensor values.

The reference wraps each evaluation in
``jax.default_matmul_precision("highest")`` because the TPU's default
float32 products are bf16-grade. Nothing here needs it: every product is
float64, native on the H100.

A Cholesky factorization that fails (K + eta I not positive definite in
float64) gives NaN, as the reference's does, instead of raising: the
samplers reject such a point, and the profiled target's eta search lets a
NaN lane lose.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import kernels
from ..utils.config import resolve_device, setup

F64 = torch.float64
_LN10 = math.log(10.0)
_MARGIN = 1e-6


def _cholesky(A):
    """Lower Cholesky factor of A, NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, math.nan))


def _profile_lp(K, eta, z, X):
    """The profile REML log-likelihood with sigma profiled out (reference
    _profile_likelihood.py:38-85, 259-275): at sigma^2 = zMz / (n - m) the
    data term collapses to (n - m) / 2."""
    n, m = X.shape
    L = _cholesky(K + eta * torch.eye(n, dtype=K.dtype, device=K.device))
    rhs = torch.cat([z[:, None], X], dim=1)
    W = torch.cholesky_solve(rhs, L)
    w = W[:, 0]
    Y = W[:, 1:]
    B = X.T @ Y
    LB = _cholesky(0.5 * (B + B.T))
    logdet_B = 2.0 * torch.sum(torch.log(torch.diagonal(LB)))
    Xw = X.T @ w
    c = torch.cholesky_solve(Xw[:, None], LB)[:, 0]
    zMz = z @ w - Xw @ c
    sigma2 = zMz / (n - m)
    logdet_Kn = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return (-0.5 * (n - m) * torch.log(sigma2) - 0.5 * logdet_Kn
            - 0.5 * logdet_B - 0.5 * (n - m))


def _constants(points, z, X, dtype, device):
    setup()
    device = resolve_device(device)
    dtype = dtype or F64

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)
    return dev(points), dev(z), dev(X), dtype, device


def make_profile_loglik(points, z, X, nu=0.5, dtype=None, *, device="cuda"):
    """lp(log10_eta, log10_rho): the profile REML log-likelihood as a
    function of the outer hyperparameters (reference :25-68). ``nu`` is a
    number. The data are closed over as ``dtype`` (float64) tensors on
    ``device``."""
    pts, z_, X_, dtype, device = _constants(points, z, X, dtype, device)
    nu = float(nu)

    def lp(log10_eta, log10_rho):
        eta = torch.pow(10.0, torch.as_tensor(log10_eta, dtype=dtype,
                                              device=device))
        rho = torch.pow(10.0, torch.as_tensor(log10_rho, dtype=dtype,
                                              device=device))
        dist = kernels.pairwise_scaled_distance(pts, pts, rho)
        K = kernels.matern(dist, nu)
        return _profile_lp(K, eta, z_, X_)

    return lp


def _nu_kernel(points, dtype, device, unique_distances, max_order):
    """K(log10_rho, nu) of the points, nu a tensor through the Bessel
    K_nu, on the distinct distances and gathered
    back when ``unique_distances`` (None: when they are under 5% of n^2,
    as on a regular grid)."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    diff = pts[:, None, :] - pts[None, :, :]
    r0 = np.sqrt((diff * diff).sum(-1))
    uniq, inv = np.unique(np.round(r0, 10), return_inverse=True)
    if unique_distances is None:
        unique_distances = uniq.size < 0.05 * n * n
    if unique_distances:
        dists = torch.as_tensor(uniq, dtype=dtype, device=device)
        gather = torch.as_tensor(inv.reshape(n, n), device=device)
    else:
        dists = torch.as_tensor(r0, dtype=dtype, device=device)

    def kernel(log10_rho, nu):
        rho = torch.pow(10.0, torch.as_tensor(log10_rho, dtype=dtype,
                                              device=device))
        nu = torch.as_tensor(nu, dtype=dtype, device=device)
        K = kernels.matern(dists / rho, nu, max_order=max_order)
        return K[gather] if unique_distances else K

    return kernel


def make_profile_loglik_nu(points, z, X, dtype=None, unique_distances=None,
                           *, device="cuda", max_order=128):
    """lp(log10_eta, log10_rho, nu) with nu a tensor through the Bessel
    K_nu (``ops/special``), so gradients flow through the kernel order
    too (reference :71-139). The same Cholesky pipeline as
    :func:`make_profile_loglik`.

    ``unique_distances`` (default: when the distinct distances are under
    5% of n^2, as on a regular grid): k is evaluated on the distinct
    distances and gathered back, far fewer Bessel loops. ``max_order``:
    the recurrence's cap, the reference's 128 by default; under the
    samplers' ``torch.func`` transforms the Bessel loops run fixed trips,
    the recurrence all of them, so a target over nu <= nu_max passes
    round(nu_max) (the bounded targets do)."""
    _, z_, X_, dtype, device = _constants(points, z, X, dtype, device)
    kernel = _nu_kernel(points, dtype, device, unique_distances, max_order)

    def lp(log10_eta, log10_rho, nu):
        eta = torch.pow(10.0, torch.as_tensor(log10_eta, dtype=dtype,
                                              device=device))
        return _profile_lp(kernel(log10_rho, nu), eta, z_, X_)

    return lp


def _bounded(log_post_theta, lo, hi, device):
    """(log_post_u, u_to_theta) over unconstrained u: theta = lo + (hi -
    lo) s(u), s a sigmoid kept 1e-6 inside (0, 1) (a saturated sigmoid
    must not put theta on the edge, where 10**theta can fall outside a
    natural-parameter prior's bound), the log-Jacobian added."""
    lo = torch.as_tensor(lo, dtype=F64, device=device)
    hi = torch.as_tensor(hi, dtype=F64, device=device)

    def u_to_theta(u):
        s = _MARGIN + (1.0 - 2.0 * _MARGIN) * torch.sigmoid(
            torch.as_tensor(u, dtype=F64, device=device))
        return lo + (hi - lo) * s

    def log_post_u(u):
        u = torch.as_tensor(u, dtype=F64, device=device)
        log_jac = torch.sum(torch.log(hi - lo) + math.log1p(-2.0 * _MARGIN)
                            + F.logsigmoid(u) + F.logsigmoid(-u))
        return log_post_theta(u_to_theta(u)) + log_jac

    return log_post_u, u_to_theta


def make_bounded_log_posterior_nu(points, z, X,
                                  log10_bounds=((-3.0, 4.0), (-2.0, 0.0)),
                                  nu_bounds=(1.0, 25.0), log_prior=None, *,
                                  device="cuda"):
    """Posterior over theta = [log10_eta, log10_rho, nu] in unconstrained
    sigmoid coordinates (reference :142-182). nu is sampled in natural
    units over ``nu_bounds``; ``log_prior(eta, rho, nu)`` takes natural
    parameters, and the log10 Jacobian applies to eta and rho only.
    Returns (log_post_u, u_to_theta)."""
    device = resolve_device(device)
    lp = make_profile_loglik_nu(
        points, z, X, device=device,
        max_order=math.floor(float(nu_bounds[1]) + 0.5))

    def log_post_theta(theta):
        l_eta, l_rho, nu = theta[0], theta[1], theta[2]
        val = lp(l_eta, l_rho, nu)
        if log_prior is not None:
            val = val + log_prior(torch.pow(10.0, l_eta),
                                  torch.pow(10.0, l_rho), nu)
            val = val + (l_eta + l_rho) * _LN10
        return val

    return _bounded(log_post_theta,
                    [log10_bounds[0][0], log10_bounds[1][0], nu_bounds[0]],
                    [log10_bounds[0][1], log10_bounds[1][1], nu_bounds[1]],
                    device=device)


def make_profiled_rho_nu_posterior(points, z, X,
                                   log10_eta_bounds=(-3.0, 4.0),
                                   log10_rho_bounds=(-1.3, -0.3),
                                   nu_bounds=(1.0, 25.0),
                                   log_prior=None, eta_grid=29,
                                   golden_iters=22, *, device="cuda"):
    """Posterior over (log10 rho, nu) on the eta-profiled surface, the
    Bayesian counterpart of the reference's MAP sweep (reference
    :185-263): per (rho, nu), eta is maximized out by a coarse grid over
    ``log10_eta_bounds`` and ``golden_iters`` golden-section steps inside
    the target, the gradient flowing through the refined iterate (at the
    inner maximum the eta-partial vanishes). The joint posterior
    legitimately concentrates on the high-eta plateau at the reference's
    configuration; this target's mode is the reference's MAP. Returns
    (log_post_u, u_to_theta), theta = [log10_rho, nu]."""
    _, z_, X_, dtype, device = _constants(points, z, X, None, device)
    kernel = _nu_kernel(points, dtype, device, None,
                        math.floor(float(nu_bounds[1]) + 0.5))
    lo_e, hi_e = log10_eta_bounds
    gr = 0.5 * (math.sqrt(5.0) - 1.0)
    grid = torch.as_tensor(np.linspace(lo_e, hi_e, eta_grid), dtype=dtype,
                           device=device)

    def _safe(v):
        # a NaN lane (a failed factorization at the small-eta end of the
        # grid) must lose the argmax and the golden comparisons
        return torch.where(torch.isnan(v), torch.full_like(v, -math.inf), v)

    def lp_prof(l_rho, nu):
        # K does not depend on eta: one Bessel evaluation per (rho, nu),
        # a Cholesky factorization per eta
        K = kernel(l_rho, nu)

        def lp_eta(le):
            return _safe(_profile_lp(K, torch.pow(10.0, le), z_, X_))

        vals = torch.func.vmap(lp_eta)(grid)
        i0 = torch.argmax(vals).reshape(1)
        lo = torch.gather(grid, 0, torch.clamp(i0 - 1, min=0))[0]
        hi = torch.gather(grid, 0, torch.clamp(i0 + 1, max=eta_grid - 1))[0]
        for _ in range(golden_iters):
            x1 = hi - gr * (hi - lo)
            x2 = lo + gr * (hi - lo)
            keep_lo = lp_eta(x1) > lp_eta(x2)
            lo, hi = (torch.where(keep_lo, lo, x1),
                      torch.where(keep_lo, x2, hi))
        return lp_eta(0.5 * (lo + hi))

    def log_post_theta(theta):
        l_rho, nu = theta[0], theta[1]
        val = lp_prof(l_rho, nu)
        if log_prior is not None:
            val = val + log_prior(torch.pow(10.0, l_rho), nu)
            val = val + l_rho * _LN10
        return val

    return _bounded(log_post_theta,
                    [log10_rho_bounds[0], nu_bounds[0]],
                    [log10_rho_bounds[1], nu_bounds[1]], device=device)


def make_log_posterior(points, z, X, nu=0.5, log_prior=None, *,
                       device="cuda"):
    """lp + prior as a function of theta = [log10_eta, log10_rho]
    (reference :266-286). ``log_prior(eta, rho)`` takes natural
    parameters; the change of variables to log10 adds
    (log10 eta + log10 rho) ln 10."""
    lp = make_profile_loglik(points, z, X, nu=nu, device=device)

    def log_post(theta):
        log10_eta, log10_rho = theta[0], theta[1]
        val = lp(log10_eta, log10_rho)
        if log_prior is not None:
            val = val + log_prior(torch.pow(10.0, log10_eta),
                                  torch.pow(10.0, log10_rho))
            val = val + (log10_eta + log10_rho) * _LN10
        return val

    return log_post


def make_bounded_log_posterior(points, z, X, nu=0.5,
                               log10_bounds=((-3.0, 4.0), (-2.0, 0.0)),
                               log_prior=None, *, device="cuda"):
    """Posterior over unconstrained coordinates u for box-bounded
    hyperparameters: theta = lo + (hi - lo) sigmoid(u) maps R^2 onto the
    log10 box, its log-Jacobian included (reference :289-319). A hard
    prior boundary would put leapfrog steps on log p = -inf. Returns
    (log_post_u, u_to_theta)."""
    device = resolve_device(device)
    return _bounded(make_log_posterior(points, z, X, nu=nu,
                                       log_prior=log_prior, device=device),
                    [b[0] for b in log10_bounds],
                    [b[1] for b in log10_bounds], device=device)


def grid_evaluate(lp_fn, log10_etas, log10_rhos):
    """The dense (eta, rho) grid of ``lp_fn`` as one vmapped batch
    (reference :322-328, in place of the reference's process-pool grid):
    (len(log10_etas), len(log10_rhos)), on the tensors' device."""
    f = torch.func.vmap(torch.func.vmap(lp_fn, in_dims=(None, 0)),
                        in_dims=(0, None))
    return f(torch.as_tensor(log10_etas, dtype=F64),
             torch.as_tensor(log10_rhos, dtype=F64))
