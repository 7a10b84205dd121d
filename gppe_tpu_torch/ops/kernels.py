"""Matern correlation kernel and anisotropic distances, on torch tensors.

Counterpart of :mod:`gppe_tpu.ops.kernels`, with the reference's branch
semantics: x == 0 -> 1; nu in {1/2, 3/2, 5/2} closed forms; nu < 100 the
general Bessel form, evaluated in log space through
:func:`gppe_tpu_torch.ops.special.log_kv`; nu >= 100 the Gaussian limit
exp(-x^2/2).

This module is the plain version. On the card the general form runs the
hand-written kernel ``csrc/matern_general.cu`` instead
(:func:`gppe_tpu_torch.ops.cuda_kernels.matern_general`, and the
general-nu products and traces of ``matern_matmat``).
"""

import math

import numpy as np
import torch

from . import special

_GAUSSIAN_NU_CUTOFF = 100.0

CLOSED_FORM_NUS = (0.5, 1.5, 2.5)


def is_closed_form(nu):
    """True for a Python or numpy number nu with a closed form (1/2, 3/2,
    5/2, or the Gaussian limit from 100), which the closed-form kernels
    take; False for a general nu, whose form needs the Bessel K_nu."""
    nu = float(nu)
    return nu in CLOSED_FORM_NUS or nu >= _GAUSSIAN_NU_CUTOFF


def _matern_general(x, nu, max_order=128):
    """2^{1-nu}/Gamma(nu) (sqrt(2 nu) x)^nu K_nu(sqrt(2 nu) x) for x > 0,
    in log space: the prefactor underflows and K_nu overflows float32
    separately around nu ~ 10, while their product is a correlation in
    (0, 1]. The two logs (~ +-nu |log z|) cancel, and the float32 error of
    their sum (~1e-5 at nu ~ 25) can push the result above its bound 1:
    clamped. ``max_order``: as :func:`matern`'s."""
    z = torch.sqrt(2.0 * nu) * x
    z = torch.clamp(z, min=1e-30)
    log_pref = ((1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
                + nu * torch.log(z))
    return torch.clamp(torch.exp(log_pref + special.log_kv(
        nu, z, max_order=max_order)), max=1.0)


def matern(x, nu, max_order=128):
    """Matern correlation k(x; nu) of the scaled distance x = r / rho.

    ``nu`` a Python or numpy number evaluates one branch (the recurrence of
    the general form runs exactly round(nu) steps); a tensor nu evaluates
    every branch and selects elementwise, the reference's traced nu (the
    form to differentiate or batch over nu). ``max_order`` caps the
    recurrence of a tensor nu, as :func:`special.kv`'s: inside a
    ``torch.func`` transform, where the Bessel loops run fixed trips, it
    runs exactly that many steps, so a target over nu <= nu_max passes
    round(nu_max)."""
    if not torch.is_tensor(nu):
        nu = float(nu)
        if nu == 0.5:
            k = torch.exp(-x)
        elif nu == 1.5:
            sqrt3 = math.sqrt(3.0)
            k = (1.0 + sqrt3 * x) * torch.exp(-sqrt3 * x)
        elif nu == 2.5:
            sqrt5 = math.sqrt(5.0)
            k = (1.0 + sqrt5 * x + (5.0 / 3.0) * x * x) * torch.exp(
                -sqrt5 * x)
        elif nu < _GAUSSIAN_NU_CUTOFF:
            k = _matern_general(x, torch.as_tensor(nu, dtype=x.dtype,
                                                   device=x.device))
        else:
            k = torch.exp(-0.5 * x * x)
        return torch.where(x == 0, torch.ones_like(x), k)

    nu = nu.to(dtype=x.dtype, device=x.device)
    sqrt3, sqrt5 = math.sqrt(3.0), math.sqrt(5.0)
    k_half = torch.exp(-x)
    k_three_half = (1.0 + sqrt3 * x) * torch.exp(-sqrt3 * x)
    k_five_half = (1.0 + sqrt5 * x + (5.0 / 3.0) * x * x) * torch.exp(
        -sqrt5 * x)
    k_gauss = torch.exp(-0.5 * x * x)
    k_general = _matern_general(
        x, torch.where(nu < _GAUSSIAN_NU_CUTOFF, nu, torch.ones_like(nu)),
        max_order)

    k = k_general
    k = torch.where(nu >= _GAUSSIAN_NU_CUTOFF, k_gauss, k)
    k = torch.where(nu == 0.5, k_half, k)
    k = torch.where(nu == 1.5, k_three_half, k)
    k = torch.where(nu == 2.5, k_five_half, k)
    return torch.where(x == 0, torch.ones_like(x), k)


def scaled_distance(p1, p2, scale):
    """Anisotropic Euclidean distance sqrt(sum_d ((p1_d-p2_d)/scale_d)^2)."""
    diff = (p1 - p2) / scale
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def pairwise_scaled_distance(points_a, points_b, scale):
    """All-pairs anisotropic distance matrix (na, nb).

    For d <= 8 the exact difference form sum_d ((a_d-b_d)/s_d)^2 is used
    (cancellation-free); above it the Gram form |a|^2+|b|^2-2a.b. The
    sqrt is NaN-safe under autograd: zero distances get a zero gradient
    (k(0) = 1 does not depend on the scale)."""
    a = points_a / scale
    b = points_b / scale
    if a.shape[-1] <= 8:
        diff = a[:, None, :] - b[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
    else:
        aa = torch.sum(a * a, dim=-1)
        bb = torch.sum(b * b, dim=-1)
        d2 = aa[:, None] + bb[None, :] - 2.0 * (a @ b.T)
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)),
                       torch.zeros_like(d2))


def broadcast_scale(scale, dimension: int, dtype=None, device=None):
    """Scalar -> per-dimension correlation scale, as a 1-D tensor.

    A Python or numpy scale becomes float64 (the reference's
    ``result_type(scale, 0.0)``) unless ``dtype`` is given."""
    if not torch.is_tensor(scale):
        scale = np.asarray(scale)
        scale = torch.as_tensor(scale.astype(np.result_type(scale, 0.0)))
    scale = torch.atleast_1d(scale.to(dtype=dtype, device=device))
    if scale.shape[0] == 1 and dimension > 1:
        scale = scale.repeat(dimension)
    return scale
