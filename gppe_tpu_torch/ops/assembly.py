"""Dense Matern correlation assembly.

Counterpart of :mod:`gppe_tpu.ops.assembly`. The reference assembles K
with XLA (a fused pairwise distance and Matern evaluation, in no Pallas
kernel). The port computes the scaled distances of a block of rows against
all points in plain PyTorch on the device, then k(.; nu): a closed form in
plain PyTorch, a general nu through the Bessel K_nu - on the card the
elementwise entry of the hand-written kernel ``csrc/matern_general.cu``
(:func:`gppe_tpu_torch.ops.cuda_kernels.matern_general`, float32 only),
on the CPU its plain version :func:`gppe_tpu_torch.ops.kernels.matern`.
Assembly runs in the compute dtype, float32 on the card, as the
reference's does on its accelerator; the likelihood layer promotes what it
needs to float64. ``sparse=True`` returns the tapered correlation as a
scipy CSR (:func:`gppe_tpu_torch.ops.taper.generate_tapered_correlation`).

Not ported yet, and refused with the ROADMAP item that brings it: the
plot (A15).
"""

import numpy as np
import torch

from . import cuda_kernels, kernels
from ..utils.config import resolve_device, setup


def correlation_of_distances(dist, nu):
    """k(dist; nu) of a tensor of scaled distances: a closed form in plain
    PyTorch, a general nu through :func:`cuda_kernels.matern_general`
    (the kernel on the card, its plain version on the CPU)."""
    if kernels.is_closed_form(nu):
        return kernels.matern(dist, nu)
    return cuda_kernels.matern_general(dist.contiguous(), nu)

# rows per block: at n = 8192 the distance intermediate stays 4096 x n
BLOCK_ROWS = 4096


def dense_correlation(points, scale, nu, dtype=torch.float32, device="cuda"):
    """Dense Matern correlation matrix K (n x n) of ``points`` (n x d), in
    ``dtype`` on ``device``, for any positive ``nu``."""
    points = torch.as_tensor(points, dtype=dtype,
                             device=resolve_device(device))
    scale = kernels.broadcast_scale(scale, points.shape[1], dtype=dtype,
                                    device=points.device)
    dist = kernels.pairwise_scaled_distance(points, points, scale)
    return correlation_of_distances(dist, nu)


def dense_correlation_blocked(points, scale, nu, block_size=BLOCK_ROWS,
                              dtype=torch.float32, device="cuda"):
    """:func:`dense_correlation` by blocks of ``block_size`` rows, which
    bounds the distance intermediate to block_size x n (the reference's
    row-parallel loop)."""
    points = torch.as_tensor(points, dtype=dtype,
                             device=resolve_device(device))
    n, d = points.shape
    if n <= block_size:
        return dense_correlation(points, scale, nu, dtype, points.device)
    scale = kernels.broadcast_scale(scale, d, dtype=dtype,
                                    device=points.device)
    K = torch.empty((n, n), dtype=dtype, device=points.device)
    for start in range(0, n, block_size):
        rows = points[start:start + block_size]
        dist = kernels.pairwise_scaled_distance(rows, points, scale)
        K[start:start + block_size] = correlation_of_distances(dist, nu)
    return K


def generate_correlation(points, correlation_scale=0.1, nu=0.5, grid=True,
                         sparse=False, density=0.001, plot=False,
                         verbose=False, *, dtype=torch.float32,
                         device="cuda"):
    """Front end with the reference's signature
    (generate_correlation/generate_correlation.py:32-40): the dense K of
    ``points`` as a ``dtype`` tensor on ``device``, or with ``sparse=True``
    the tapered K at ``density`` as a scipy CSR (float64 values; a
    general nu's blocked rule runs in ``dtype`` on ``device``, see
    :func:`~gppe_tpu_torch.ops.taper.generate_tapered_correlation`).
    ``grid`` is accepted for that signature."""
    setup()
    points_np = (points.detach().cpu().numpy() if torch.is_tensor(points)
                 else np.asarray(points))
    if points_np.ndim != 2:
        raise ValueError("points must be a 2D array (n, dimension)")
    scale = kernels.broadcast_scale(correlation_scale, points_np.shape[1])
    if bool((scale <= 0.0).any()):
        raise ValueError("correlation_scale must be positive")
    # the Matern class is defined for nu > 0 only (the reference's
    # general-nu branch divides by gamma(nu), _kernels.pyx:83-88)
    try:
        nu_ok = float(nu) > 0.0
    except (TypeError, ValueError):
        nu_ok = False
    if not nu_ok:
        raise ValueError(f"nu must be a positive scalar, got {nu!r}")
    if plot:
        raise NotImplementedError(
            "generate_correlation(plot=True): plotting comes with "
            "ROADMAP A15")

    if sparse:
        from . import taper
        matrix = taper.generate_tapered_correlation(
            points_np, scale.cpu().numpy(), nu, density, verbose=verbose,
            dtype=dtype, device=device)
    else:
        matrix = dense_correlation_blocked(points, scale, nu, dtype=dtype,
                                           device=device)
    if verbose:
        n = points_np.shape[0]
        print(f"generated {n}x{n} correlation matrix "
              f"(sparse={sparse}, nu={nu})")
    return matrix
