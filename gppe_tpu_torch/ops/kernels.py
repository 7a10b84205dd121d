"""Matern correlation kernel and anisotropic distances, on torch tensors.

Counterpart of :mod:`gppe_tpu.ops.kernels`. The closed-form nu branches
(nu in {1/2, 3/2, 5/2} and the Gaussian limit nu >= 100) keep the
reference's branch semantics, including x == 0 -> 1. General nu needs the
Bessel K_nu of ``gppe_tpu.ops.special``, which belongs to the general-nu
slice of the port and is not here yet.
"""

import math

import numpy as np
import torch

_GAUSSIAN_NU_CUTOFF = 100.0

CLOSED_FORM_NUS = (0.5, 1.5, 2.5)


def check_static_nu(nu):
    """``nu`` as a float if a closed form exists for it, else raise."""
    nu = float(nu)
    if nu in CLOSED_FORM_NUS or nu >= _GAUSSIAN_NU_CUTOFF:
        return nu
    raise NotImplementedError(
        f"Matern nu = {nu}: only the closed forms nu in {{0.5, 1.5, 2.5}} "
        f"and nu >= {_GAUSSIAN_NU_CUTOFF:g} are ported; general nu (Bessel "
        f"K_nu) comes with the general-nu slice of gppe_tpu_torch")


def matern(x, nu):
    """Matern correlation k(x; nu) of the scaled distance x = r / rho.

    ``nu`` is a Python number selecting one closed-form branch."""
    nu = check_static_nu(nu)
    if nu == 0.5:
        k = torch.exp(-x)
    elif nu == 1.5:
        sqrt3 = math.sqrt(3.0)
        k = (1.0 + sqrt3 * x) * torch.exp(-sqrt3 * x)
    elif nu == 2.5:
        sqrt5 = math.sqrt(5.0)
        k = (1.0 + sqrt5 * x + (5.0 / 3.0) * x * x) * torch.exp(-sqrt5 * x)
    else:
        k = torch.exp(-0.5 * x * x)
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
