"""Matrix-free Matern correlation operator: K @ V without storing K.

Counterpart of ``gppe_tpu.ops.operators.MaternOperator``. On a CUDA
device ``matmat`` and ``trace_pow(2)`` launch the fused CUDA kernel
(:func:`gppe_tpu_torch.ops.cuda_kernels.matern_matmat`); on the CPU they
run its plain row-blocked PyTorch version. The points live on the device
(0.8 MB at n = 10^5); K (40 GB at n = 10^5) never exists.
"""

import torch

from . import cuda_kernels, kernels
from ..utils.config import resolve_device, setup


class MaternOperator:
    """Assembly-free Matern correlation operator.

    API: ``shape``, ``matmat``, ``matvec``, ``trace_pow``, ``dense`` — what
    the Krylov engines consume. ``nu`` is a static float with a closed
    form (0.5, 1.5, 2.5 or >= 100).
    """

    def __init__(self, points, scale, nu=0.5, block_rows=1024,
                 device="cuda", dtype=torch.float32, dot_mode=None):
        """``device``/``dtype``: where and in what the points and every
        product live (the CUDA kernel takes float32). ``block_rows``: rows
        per block of the plain CPU path. ``dot_mode``: None or 'highest'
        (exact float32, the only ported mode)."""
        setup()
        cuda_kernels._check_modes(dot_mode, "diff")
        self.nu = kernels.check_static_nu(nu)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.points = torch.as_tensor(points, dtype=dtype,
                                      device=self.device).contiguous()
        n, d = self.points.shape
        self.scale = kernels.broadcast_scale(scale, d, dtype=dtype,
                                             device=self.device)
        self.block_rows = int(min(block_rows, n))
        self.dot_mode = dot_mode
        self._n = n

    @property
    def shape(self):
        return (self._n, self._n)

    def matmat(self, V):
        V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = cuda_kernels.matern_matmat(
            self.points, self.scale, V.contiguous(), self.nu,
            dot_mode=self.dot_mode, block_rows=self.block_rows)
        return out[:, 0] if squeeze else out

    def matvec(self, v):
        return self.matmat(v)

    def trace_pow(self, exponent):
        """Exact trace(K^p) for p in {0, 1, 2}: diag(K) = 1 so the trace is
        n; trace(K^2) = ||K||_F^2 from one Frobenius-only pass."""
        if exponent == 0 or exponent == 1:
            return torch.tensor(float(self._n), dtype=self.dtype,
                                device=self.device)
        if exponent == 2:
            _, fro = cuda_kernels.matern_matmat(
                self.points, self.scale, None, self.nu, frobenius=True,
                block_rows=self.block_rows)
            return fro
        raise ValueError("exponent must be 0, 1 or 2")

    def dense(self):
        """Materialize K (small-n debugging only)."""
        dist = kernels.pairwise_scaled_distance(self.points, self.points,
                                                self.scale)
        return kernels.matern(dist, self.nu)
