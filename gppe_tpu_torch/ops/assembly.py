"""Dense Matern correlation assembly.

Counterpart of :mod:`gppe_tpu.ops.assembly`. The reference assembles K
with XLA (a fused pairwise distance and Matern evaluation, in no Pallas
kernel). The port assembles K from the points: a general nu in one fused
pass of the hand-written kernel ``csrc/matern_general.cu`` on the card
(:func:`gppe_tpu_torch.ops.cuda_kernels.matern_general_assemble`: the
scaled distance and k of each pair of the upper triangle once, written to
K[i, j] and K[j, i], float32 points only, a batch of (scale, nu) points a
launch), on the CPU its plain version (the scaled distances in plain
PyTorch, then :func:`gppe_tpu_torch.ops.kernels.matern`); a closed form in
plain PyTorch, the distances then k. Assembly runs in the compute dtype,
float32 on the card, as the reference's does on its accelerator; the
likelihood layer promotes what it needs to float64. ``sparse=True``
returns the tapered correlation as a scipy CSR
(:func:`gppe_tpu_torch.ops.taper.generate_tapered_correlation`).

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
    (the elementwise kernel on the card, its plain version on the CPU)."""
    if kernels.is_closed_form(nu):
        return kernels.matern(dist, nu)
    return cuda_kernels.matern_general(dist.contiguous(), nu)


def correlations_of_points(points, scales, nus, rows=None, out_dtype=None):
    """K_b (B, nr, n) of ``points`` (n, d) at B (scale, nu) points, each
    scale a scalar or d per-dimension ones: the rows r0 <= i < r1 of each
    K (``rows=(r0, r1)``; None: all n) against every point, in
    ``out_dtype`` (None: the points' dtype).

    The general nus take one call of
    :func:`cuda_kernels.matern_general_assemble` (on the card one fused
    launch for all of them; on the CPU its plain version); a closed form,
    and on the card a general nu at d > 8 (past the kernel's staged
    dimensions), the scaled distances in plain PyTorch, then
    :func:`correlation_of_distances`."""
    out_dtype = points.dtype if out_dtype is None else out_dtype
    n, d = points.shape
    r0, r1 = (0, n) if rows is None else rows
    nus = [cuda_kernels.check_nu(nu) for nu in nus]
    scales = torch.as_tensor(scales, dtype=points.dtype,
                             device=points.device)
    if scales.ndim == 1:
        scales = scales[:, None].expand(len(nus), d)
    fused = points.device.type == "cpu" or d <= cuda_kernels._MAX_D
    general = [b for b, nu in enumerate(nus)
               if fused and not kernels.is_closed_form(nu)]
    if len(general) == len(nus):
        return cuda_kernels.matern_general_assemble(
            points, scales, nus, rows=(r0, r1), out_dtype=out_dtype)

    def unfused(b):
        return correlation_of_distances(kernels.pairwise_scaled_distance(
            points[r0:r1], points, scales[b]), nus[b]).to(out_dtype)
    if not general:
        Ks = [unfused(b) for b in range(len(nus))]
        return Ks[0][None] if len(Ks) == 1 else torch.stack(Ks)
    out = torch.empty((len(nus), r1 - r0, n), dtype=out_dtype,
                      device=points.device)
    out[general] = cuda_kernels.matern_general_assemble(
        points, scales[general], [nus[b] for b in general], rows=(r0, r1),
        out_dtype=out_dtype)
    for b in range(len(nus)):
        if b not in general:
            out[b] = unfused(b)
    return out


def correlation_of_points(points, scale, nu, rows=None, out_dtype=None):
    """K (nr, n) of ``points`` at one ``scale`` (a scalar or d
    per-dimension ones) and ``nu``: :func:`correlations_of_points` of one
    (scale, nu) point."""
    scale = kernels.broadcast_scale(scale, points.shape[1],
                                    dtype=points.dtype, device=points.device)
    return correlations_of_points(points, scale[None], (nu,), rows,
                                  out_dtype)[0]


# rows per block: at n = 8192 a block of 4096 rows (the distance
# intermediates of a closed form, or the float32 block of K that the
# general-nu kernel writes) holds 4096 x n entries
BLOCK_ROWS = 4096


def dense_correlation(points, scale, nu, dtype=torch.float32, device="cuda"):
    """Dense Matern correlation matrix K (n x n) of ``points`` (n x d), in
    ``dtype`` on ``device``, for any positive ``nu``."""
    points = torch.as_tensor(points, dtype=dtype,
                             device=resolve_device(device))
    return correlation_of_points(points.contiguous(), scale, nu)


def dense_correlation_blocked(points, scale, nu, block_size=BLOCK_ROWS,
                              dtype=torch.float32, device="cuda"):
    """:func:`dense_correlation` by blocks of ``block_size`` rows, which
    bounds the intermediates to block_size x n (the reference's
    row-parallel loop); a general nu on the card writes K in one launch,
    its symmetric walk evaluating each pair once."""
    points = torch.as_tensor(points, dtype=dtype,
                             device=resolve_device(device)).contiguous()
    n, d = points.shape
    if n <= block_size or (points.device.type == "cuda"
                           and not kernels.is_closed_form(nu)
                           and d <= cuda_kernels._MAX_D):
        return dense_correlation(points, scale, nu, dtype, points.device)
    K = torch.empty((n, n), dtype=dtype, device=points.device)
    for start in range(0, n, block_size):
        K[start:start + block_size] = correlation_of_points(
            points, scale, nu, rows=(start, min(start + block_size, n)))
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
