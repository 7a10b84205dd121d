"""The hard-tapered Matern correlation on a regular grid, in float64.

The taper keeps k(x_ij) where k(x_ij) >= tau and zeroes the rest. Its
radius and threshold follow from the requested density by the reference's
d-ball rule: a point keeps ``a = density * n`` neighbours, which on a grid
of spacing ``h = 1 / (n^(1/d) - 1)`` fill a d-ball of volume ``a h^d``; the
ball's radius over rho is the radius in scaled distance, and tau = k(radius).

On a grid K is a convolution: entry (i, j) depends on the offset between
the two points alone. Its product is the convolution of each vector, laid
out on the grid, with the stencil of kept k values, taken by float64 FFTs
of a size that no wrap-around reaches.
"""

import math

import numpy as np
import scipy.special
import torch

from ..data import grid_points
from .tf32 import tf32

# stencil and FFT sizes are worked out once per grid and kernel
_COLUMNS_PER_FFT = 64


def correlation(x, nu):
    """k(x; nu) in float64 numpy, any nu > 0 (closed forms at 1/2, 3/2,
    5/2; the Bessel form otherwise)."""
    x = np.asarray(x, dtype=np.float64)
    if nu == 0.5:
        return np.exp(-x)
    if nu == 1.5:
        s = math.sqrt(3.0) * x
        return (1.0 + s) * np.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * x
        return (1.0 + s + s * s / 3.0) * np.exp(-s)
    z = np.sqrt(2.0 * nu) * x
    with np.errstate(invalid="ignore", divide="ignore"):
        k = (2.0 ** (1.0 - nu) / scipy.special.gamma(nu) * z ** nu
             * scipy.special.kv(nu, z))
    return np.where(x == 0, 1.0, k)


def radius_threshold(n, dimension, density, rho, nu):
    """(radius in units of rho, tau) of the taper at this density."""
    adjacency = density * n
    spacing = 1.0 / max(n ** (1.0 / dimension) - 1.0, 1.0)
    volume = adjacency * spacing ** dimension
    unit_ball_gamma = scipy.special.gamma(dimension / 2.0 + 1.0)
    radius = (unit_ball_gamma * volume) ** (1.0 / dimension) / math.sqrt(
        math.pi)
    radius /= rho
    return radius, float(correlation(radius, nu))


class GridTaper:
    """The stencil of the tapered K on a ``side`` x ``side`` grid."""

    def __init__(self, side, rho, nu, density):
        if side < 2:
            raise ValueError("the grid needs two points an axis")
        self.side = int(side)
        self.n = self.side ** 2
        h = 1.0 / (self.side - 1)
        self.radius, self.tau = radius_threshold(self.n, 2, density, rho, nu)
        half = int(math.floor(self.radius * rho / h)) + 1
        offsets = np.arange(-half, half + 1)
        a, b = np.meshgrid(offsets, offsets, indexing="ij")
        k = correlation(np.sqrt(a * a + b * b) * h / rho, nu)
        kept = k >= self.tau
        # no kept offset may sit on the threshold's rounding
        self.margin = float(np.min(np.abs(k - self.tau)) / self.tau)
        self.stencil = np.where(kept, k, 0.0)
        self.half = half
        self.offsets = (a, b)
        self.kept = kept
        counts = ((self.side - np.abs(a)).clip(min=0)
                  * (self.side - np.abs(b)).clip(min=0))
        self.kept_ordered_pairs = int(np.sum(counts * kept))
        self.trace_k2 = float(np.sum(counts * self.stencil ** 2))
        self.fft_size = -(-(self.side + half) // 64) * 64

    def check_points(self, points):
        grid = grid_points(self.side)
        if points.shape != grid.shape or not np.allclose(points, grid,
                                                         rtol=0, atol=0):
            raise ValueError("the tapered reference takes the configured "
                             "grid only")

    def _stencil_fft(self, stencil, device):
        L = self.fft_size
        circ = np.zeros((L, L))
        a, b = self.offsets
        circ[a % L, b % L] = stencil
        return torch.fft.rfft2(torch.as_tensor(circ, device=device))

    def apply(self, vectors, stencil=None):
        """K @ vectors in float64; ``vectors`` (n, m) float64 on a device.
        ``stencil``: another stencil of the same offsets (the control's)."""
        n, m = vectors.shape
        L, side = self.fft_size, self.side
        kf = self._stencil_fft(self.stencil if stencil is None else stencil,
                               vectors.device)
        out = torch.empty_like(vectors)
        for c0 in range(0, m, _COLUMNS_PER_FFT):
            c1 = min(c0 + _COLUMNS_PER_FFT, m)
            grid = vectors[:, c0:c1].T.reshape(c1 - c0, side, side)
            conv = torch.fft.irfft2(torch.fft.rfft2(grid, s=(L, L)) * kf,
                                    s=(L, L))
            out[:, c0:c1] = conv[:, :side, :side].reshape(c1 - c0, n).T
        return out


def apply(points, rho, nu, vectors, config):
    """(K @ vectors, trace(K^2)) of the tapered K of the configured grid."""
    taper = GridTaper(int(config["points"]["side"]), rho, nu,
                      float(config["density"]))
    taper.check_points(points)
    return taper.apply(vectors), taper.trace_k2


class ControlOperator:
    """The reference in the program's place, one precision step below the
    configured float32: a product of TF32-rounded k values and operands
    (what a TF32 tensor-core product takes), summed in float64, returned in
    float32."""

    def __init__(self, points, rho, nu, config, device):
        self.taper = GridTaper(int(config["points"]["side"]), rho, nu,
                               float(config["density"]))
        self.taper.check_points(points)
        n = self.taper.n
        self.shape = (n, n)
        self.device = device
        self.dtype = torch.float32
        self._stencil = tf32(torch.as_tensor(
            self.taper.stencil, dtype=torch.float32)).double().numpy()

    def matmat(self, V):
        V64 = tf32(V.to(torch.float32)).to(torch.float64)
        return self.taper.apply(V64, self._stencil).to(torch.float32)

    def trace_pow(self, exponent):
        if exponent != 2:
            raise ValueError("the control holds trace(K^2) only")
        return torch.tensor(self.taper.trace_k2, dtype=torch.float32)
