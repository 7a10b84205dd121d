"""Exact trust-region Newton for small hyperparameter spaces.

Counterpart of :mod:`gppe_tpu.ops.optimize` (the role of the reference's
``scipy.optimize.minimize(method='trust-exact')``,
_direct_likelihood.py:346-405). The objective is a float64 torch function
of a (k,) tensor, k = 2..4, evaluated on the host: its value and gradient
come from ``torch.func.grad_and_value`` and its Hessian from
``torch.func.hessian``, where the reference takes ``jax.value_and_grad``
and ``jax.hessian``. The iteration is a Python loop with the reference's
radius policy and its exact subproblem solve (eigendecomposition, then
bisection on the Levenberg parameter).
"""

import math
from typing import NamedTuple

import torch


class TrustRegionResult(NamedTuple):
    x: torch.Tensor
    fun: float
    grad_norm: float
    iterations: int
    success: bool


def _solve_subproblem(g, H, radius, n_bisect=60):
    """Exact solution of min_p g.p + 0.5 p.H.p  s.t. ||p|| <= radius.

    H = U diag(s) U^T; p(lmb) = -U (s + lmb)^-1 U^T g with
    lmb >= max(0, -s_min) chosen so that ||p|| <= radius (the secular
    equation by bisection)."""
    s, U = torch.linalg.eigh(H)
    gt = U.T @ g
    s_min = float(s[0])

    def p_norm(lmb):
        d = s + lmb
        d = torch.where(torch.abs(d) < 1e-300, 1e-300, d)
        p = gt / d
        return float(torch.sqrt(torch.sum(p * p)))

    lmb_lo = max(0.0, -s_min) + 1e-12
    # the interior Newton step if H is PD and the step fits in the region
    interior_ok = s_min > 0 and p_norm(0.0) <= radius
    g_norm = float(torch.sqrt(torch.sum(g * g)))
    lmb_hi = lmb_lo + g_norm / max(radius, 1e-300) + 1.0
    lo, hi = lmb_lo, lmb_hi
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        if p_norm(mid) > radius:
            lo = mid
        else:
            hi = mid
    lmb = 0.0 if interior_ok else 0.5 * (lo + hi)
    d = s + lmb
    d = torch.where(torch.abs(d) < 1e-300, 1e-300, d)
    p = -(U @ (gt / d))
    # hard case: if the boundary solve still undershoots (g orthogonal to
    # the lowest eigenvector), pad along that eigenvector to the boundary
    pn = float(torch.sqrt(torch.sum(p * p)))
    if not interior_ok and pn < 0.9 * radius:
        p = p + math.sqrt(max(radius ** 2 - pn ** 2, 0.0)) * U[:, 0]
    return p


def trust_region_minimize(fun, x0, gtol=1e-5, max_iter=100,
                          initial_radius=1.0, max_radius=1e3):
    """Minimize ``fun`` (R^k -> R, a torch function) by exact trust-region
    Newton from ``x0``; derivatives by ``torch.func``."""
    x = torch.as_tensor(x0, dtype=torch.float64).clone()
    grad_and_value = torch.func.grad_and_value(fun)
    hess = torch.func.hessian(fun)

    g, f = grad_and_value(x)
    f = float(f)
    radius = float(initial_radius)
    it = 0
    done = False
    while it < max_iter and not done:
        H = hess(x)
        p = _solve_subproblem(g, H, radius)
        pred = -float(g @ p + 0.5 * p @ (H @ p))    # predicted decrease
        x_new = x + p
        g_new, f_new = grad_and_value(x_new)
        f_new = float(f_new)
        rho = (f - f_new) / (pred if pred > 0 else 1e-300)
        step_norm = float(torch.sqrt(torch.sum(p * p)))
        if rho < 0.25:
            radius = 0.25 * radius
        elif rho > 0.75 and step_norm > 0.8 * radius:
            radius = min(2.0 * radius, max_radius)
        if rho > 0.1:
            x, f, g = x_new, f_new, g_new
        g_norm = float(torch.sqrt(torch.sum(g * g)))
        done = g_norm < gtol or radius < 1e-12
        it += 1
    g_norm = float(torch.sqrt(torch.sum(g * g)))
    return TrustRegionResult(x=x, fun=f, grad_norm=g_norm, iterations=it,
                             success=g_norm < 10 * gtol)
