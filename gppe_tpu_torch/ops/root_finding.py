"""Host scalar Chandrupatla root finding.

Counterpart of ``gppe_tpu.ops.root_finding.chandrupatla_scalar`` (the
reference's Chandrupatla, _root_finding.py:155-309), copied unchanged:
the profile-likelihood fit evaluates its derivative in O(k^2) host numpy,
so the iteration runs on the host in float64 Python floats.
"""

import numpy as np


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
