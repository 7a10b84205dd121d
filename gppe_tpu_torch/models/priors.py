"""Priors over kernel hyperparameters, on torch tensors.

Counterpart of :mod:`gppe_tpu.models.priors` (reference:
examples/FindOptimalCovarianceParameters.py:73-146): uniform within bounds
and the inverse-square family 1/(1 + x/scale)^2, as unnormalized float64
log-densities, -inf outside the support. A number or a tensor of any shape
is taken; a number becomes a float64 tensor on the CPU.
"""

import math

import torch


def _as_float(x):
    if torch.is_tensor(x) and x.is_floating_point():
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def uniform_log_prior(x, bounds):
    """0 inside [lo, hi], -inf outside (reference :73-81)."""
    x = _as_float(x)
    lo, hi = bounds
    inside = (x >= lo) & (x <= hi)
    return torch.where(inside, torch.zeros_like(x),
                       torch.full_like(x, -math.inf))


def inverse_square_log_prior(x, scale=1.0):
    """log 1/(1 + x/scale)^2 for x >= 0, -inf below (reference :128-130)."""
    x = _as_float(x)
    return (-2.0 * torch.log1p(torch.clamp(x, min=0.0) / scale)
            + torch.where(x >= 0, torch.zeros_like(x),
                          torch.full_like(x, -math.inf)))
