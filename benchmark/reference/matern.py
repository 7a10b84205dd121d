"""The dense Matern correlation K(rho, nu) of a set of points, applied in
float64 a block of rows at a time; K itself is never held.

k(x; nu) = 2^(1-nu) / Gamma(nu) (sqrt(2 nu) x)^nu K_nu(sqrt(2 nu) x) of the
scaled distance x = |p_i - p_j| / rho, with k(0) = 1; the closed forms at
nu = 1/2, 3/2, 5/2.
"""

import math

import torch

from .tf32 import tf32

# rows of K a block: (BLOCK_ROWS, n) float64 temporaries, 1.6 GB at n = 10^5
BLOCK_ROWS = 2048


def correlation(x, nu):
    """k(x; nu) in float64 for a closed-form nu (x a tensor)."""
    if nu == 0.5:
        return torch.exp(-x)
    if nu == 1.5:
        s = math.sqrt(3.0) * x
        return (1.0 + s) * torch.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * x
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise NotImplementedError(f"the dense reference has no nu = {nu} yet")


def apply(points, rho, nu, vectors, block_rows=BLOCK_ROWS):
    """(K @ vectors, trace(K^2)) in float64. ``points`` (n, d) float64 and
    ``vectors`` (n, m) float64 on one device."""
    n = points.shape[0]
    out = torch.empty_like(vectors)
    trace_k2 = torch.zeros((), dtype=torch.float64, device=points.device)
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        d2 = torch.zeros((r1 - r0, n), dtype=torch.float64,
                         device=points.device)
        for a in range(points.shape[1]):
            d2 += (points[r0:r1, a, None] - points[None, :, a]) ** 2
        k = correlation(torch.sqrt(d2) / rho, nu)
        del d2
        out[r0:r1] = k @ vectors
        trace_k2 += torch.sum(k * k)
        del k
    return out, float(trace_k2)


def tf32_product(points, rho, nu, V, block_rows=BLOCK_ROWS):
    """K @ V as a TF32 product: k and V rounded to TF32, summed in float32
    (k worked out in float32 first: its error is far below TF32's);
    ``V`` (n, r)."""
    pts = points.to(torch.float32)
    Vt = tf32(V)
    n = pts.shape[0]
    out = torch.empty((n, V.shape[1]), dtype=torch.float32,
                      device=pts.device)
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        d2 = torch.zeros((r1 - r0, n), dtype=torch.float32, device=pts.device)
        for a in range(pts.shape[1]):
            d2 += (pts[r0:r1, a, None] - pts[None, :, a]) ** 2
        out[r0:r1] = tf32(correlation(torch.sqrt(d2) / rho, nu)) @ Vt
        del d2
    return out


class ControlOperator:
    """The reference in the program's place, one precision step below the
    configured float32: every product a TF32 product."""

    def __init__(self, points, rho, nu, config, device):
        self.points = torch.as_tensor(points, dtype=torch.float64,
                                      device=device)
        self.rho, self.nu = float(rho), float(nu)
        n = self.points.shape[0]
        self.shape = (n, n)
        self.device = device
        self.dtype = torch.float32

    def matmat(self, V):
        return tf32_product(self.points, self.rho, self.nu, V)

    def trace_pow(self, exponent):
        if exponent != 2:
            raise ValueError("the control holds trace(K^2) only")
        zero = torch.zeros((self.shape[0], 1), dtype=torch.float64,
                           device=self.device)
        return torch.tensor(apply(self.points, self.rho, self.nu, zero)[1])


def control_multirho(points, rhos, W, nu, **kwargs):
    """The multi-rho product (``(B, n, r)`` for B scales) as TF32 products,
    in the program's batched product's place; a trace-only call
    (``W`` None) returns each scale's float64 trace(K^2)."""
    pts = points.to(torch.float64)
    rhos = [float(r) for r in rhos]
    if W is None:
        zero = torch.zeros((pts.shape[0], 1), dtype=torch.float64,
                           device=pts.device)
        traces = torch.tensor([apply(pts, r, nu, zero)[1] for r in rhos],
                              dtype=torch.float64, device=pts.device)
        return None, traces
    return torch.stack([tf32_product(pts, r, nu, W[b])
                        for b, r in enumerate(rhos)])
