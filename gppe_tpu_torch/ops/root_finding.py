"""Bracketing and Chandrupatla root finding.

Counterpart of :mod:`gppe_tpu.ops.root_finding` (the reference's
_root_finding.py:21-148 bracketing, :155-309 Chandrupatla):

* :func:`find_interval_with_sign_change`, the reference's bracket policy
  on the host;
* :func:`chandrupatla`, vectorized over tensors of root problems, each
  lane frozen once it terminates; a Python loop where the reference
  compiles a ``while_loop``;
* :func:`chandrupatla_scalar` for the sequential host callers (the Krylov
  engines' per-eta evaluation is O(k^2) host numpy), copied unchanged.
"""

import numpy as np
import torch


def find_interval_with_sign_change(f, bracket, num_bracket_trials=3,
                                   verbose=False):
    """Search for [x0, x1] with sign(f(x0)) != sign(f(x1)): try the given
    interval; on failure probe the midpoint, then extend outward on the
    side with the larger |f|. Returns (found, bracket, bracket_values)."""
    x0, x1 = float(bracket[0]), float(bracket[1])
    f0 = float(f(x0))
    f1 = float(f(x1))

    for _ in range(num_bracket_trials):
        if np.sign(f0) != np.sign(f1):
            return True, [x0, x1], [f0, f1]

        if verbose:
            print(f"bracket search: x0={x0:.3g} f0={f0:.3g} "
                  f"x1={x1:.3g} f1={f1:.3g}")

        # probe the midpoint
        x_new = 0.5 * (x0 + x1)
        f_new = float(f(x_new))
        if np.sign(f0) != np.sign(f_new):
            if abs(f0) < abs(f1):
                return True, [x0, x_new], [f0, f_new]
            return True, [x_new, x1], [f_new, f1]

        if abs(f_new) < min(abs(f0), abs(f1)):
            # refine toward the smaller-|f| side
            if abs(f0) < abs(f1):
                x1, f1 = x_new, f_new
            else:
                x0, f0 = x_new, f_new
            continue

        # extend outward on the side with larger |f|
        t = 1.5 if abs(f0) > abs(f1) else -0.5
        x_new = x0 * (1 - t) + x1 * t
        f_new = float(f(x_new))
        if np.sign(f0) != np.sign(f_new):
            if abs(f0) > abs(f1):
                return True, [x_new, x0], [f_new, f0]
            return True, [x1, x_new], [f1, f_new]
        if t > 0:
            x0, f0, x1, f1 = x1, f1, x_new, f_new
        else:
            x1, f1, x0, f0 = x0, f0, x_new, f_new

    return False, [x0, x1], [f0, f1]


def chandrupatla_scalar(f, x0, x1, f0, f1, tol=1e-6, max_iter=100):
    """Host-mode scalar Chandrupatla (float64 python floats).

    For the sequential host caller
    models.large_scale.KrylovProfileLikelihood.fit, whose per-eta
    evaluation is O(k^2) host numpy. ``f0``/``f1`` are the
    already-computed bracket values. Returns (root, iterations)."""
    b, a = x0, x1
    fb, fa = f0, f1
    c, fc = a, fa
    t = 0.5
    iters = 0
    xm, fm = (a, fa) if abs(fa) < abs(fb) else (b, fb)
    while iters < max_iter:
        xt = a + t * (b - a)
        ft = f(xt)
        if np.sign(ft) == np.sign(fa):
            c, fc = a, fa
        else:
            c, b, fc, fb = b, a, fb, fa
        a, fa = xt, ft
        if abs(fa) < abs(fb):
            xm, fm = a, fa
        else:
            xm, fm = b, fb
        tol_x = 2 * tol * abs(xm) + tol
        tlim = tol_x / max(abs(b - c), 1e-300)
        if fm == 0 or tlim > 0.5:
            return xm, iters
        xi = (a - b) / (c - b)
        phi = (fa - fb) / (fc - fb)
        if phi ** 2 < xi and (1 - phi) ** 2 < 1 - xi:
            t = (fa / (fb - fa) * fc / (fb - fc)
                 + (c - a) / (b - a) * fa / (fc - fa) * fb / (fc - fb))
        else:
            t = 0.5
        t = min(1 - tlim, max(tlim, t))
        iters += 1
    return xm, iters


def chandrupatla(f, x0, x1, f0=None, f1=None, eps_m=None, eps_a=None,
                 max_iter=50):
    """Vectorized Chandrupatla root finder (derivative-free, bracketed).

    ``x0``, ``x1``: scalars or tensors, one root problem per lane; ``f``
    maps a tensor to a tensor elementwise. Every lane runs the same
    iteration; a lane that has terminated keeps its root. Returns
    (root tensor, iterations)."""
    # float64 unless a floating tensor is given (a Python float would
    # become torch's default float32)
    if not (torch.is_tensor(x0) and x0.is_floating_point()):
        x0 = torch.as_tensor(x0, dtype=torch.float64)
    x1 = torch.as_tensor(x1, dtype=x0.dtype)
    shape = torch.broadcast_shapes(x0.shape, x1.shape)
    b = torch.broadcast_to(x0, shape)
    a = torch.broadcast_to(x1, shape)
    fa = torch.broadcast_to(torch.as_tensor(f(a) if f1 is None else f1,
                                            dtype=x0.dtype), shape)
    fb = torch.broadcast_to(torch.as_tensor(f(b) if f0 is None else f0,
                                            dtype=x0.dtype), shape)
    c, fc = a, fa

    eps = torch.finfo(x0.dtype).eps
    eps_m = eps if eps_m is None else eps_m
    eps_a = 2 * eps if eps_a is None else eps_a

    t = torch.full(shape, 0.5, dtype=x0.dtype)
    terminate = torch.zeros(shape, dtype=torch.bool)
    xm = torch.where(torch.abs(fa) < torch.abs(fb), a, b)

    def safe(x):
        return torch.where(x == 0, 1.0, x)

    it = 0
    while it < max_iter and not bool(terminate.all()):
        xt = a + t * (b - a)
        ft = torch.as_tensor(f(xt), dtype=x0.dtype)

        samesign = torch.sign(ft) == torch.sign(fa)
        c, b, fc, fb = (torch.where(samesign, a, b),
                        torch.where(samesign, b, a),
                        torch.where(samesign, fa, fb),
                        torch.where(samesign, fb, fa))
        a, fa = xt, ft

        fa_smaller = torch.abs(fa) < torch.abs(fb)
        xm_n = torch.where(fa_smaller, a, b)
        fm_n = torch.where(fa_smaller, fa, fb)

        tol = 2 * eps_m * torch.abs(xm_n) + eps_a
        tlim = tol / torch.where(b == c, 1.0, torch.abs(b - c))
        # frozen lanes keep their previous xm
        xm = torch.where(terminate, xm, xm_n)
        terminate = terminate | (fm_n == 0) | (tlim > 0.5)

        # inverse quadratic interpolation vs bisection
        xi = (a - b) / torch.where(c == b, 1.0, c - b)
        phi = (fa - fb) / torch.where(fc == fb, 1.0, fc - fb)
        iqi = (phi ** 2 < xi) & ((1 - phi) ** 2 < 1 - xi)
        t_iqi = (fa / safe(fb - fa) * fc / safe(fb - fc)
                 + (c - a) / safe(b - a) * fa / safe(fc - fa)
                 * fb / safe(fc - fb))
        t = torch.where(iqi, t_iqi, 0.5)
        t = torch.minimum(1 - tlim, torch.maximum(tlim, t))
        it += 1
    return xm, it
