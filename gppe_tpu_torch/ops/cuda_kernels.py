"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of :mod:`gppe_tpu.ops.pallas_kernels`. Each public function
takes the plain PyTorch version for tensors on the CPU and launches its
CUDA kernel for tensors on a CUDA device; there is no fallback from one to
the other.

``matern_matmat`` (kernel source ``csrc/matern_matmat.cu``) replaces the
TPU kernel ``pallas_kernels._matmat_kernel``: K @ V with K the Matern
correlation of the scaled points, never stored, plus an optional
trace(K^2) output that replaces the XLA pass
``operators._matern_frobenius2_blocked``. It computes in IEEE float32 (the
reference's ``'highest'`` dot mode).

``launch_counts`` counts launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else.
"""

import torch

from . import kernels
from ..utils.config import setup

launch_counts = {"matern_matmat": 0}

# nu -> template code of csrc/matern_matmat.cu (kNuHalf ... kNuGauss)
_NU_CODES = {0.5: 0, 1.5: 1, 2.5: 2}
_GAUSS_CODE = 3
_MAX_D = 8


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _check_modes(dot_mode, dist_mode):
    if dot_mode not in (None, "highest"):
        raise NotImplementedError(
            f"dot_mode={dot_mode!r}: only the exact float32 'highest' mode is "
            f"ported; the reference's 'bf16x3' and 'bf16' tile-dot modes are "
            f"still to port")
    if dist_mode != "diff":
        raise NotImplementedError(
            f"dist_mode={dist_mode!r}: only the difference-form distance "
            f"'diff' is ported; the Gram-form kernel is still to port")


def matern_matmat_plain(points, scale, V, nu, points_cols=None,
                        frobenius=False, block_rows=1024):
    """Plain PyTorch K @ V by row blocks, in the inputs' dtype.

    Each block's correlation tile is computed, multiplied and discarded
    (the form of ``gppe_tpu.ops.operators._matern_matmat_blocked``). With
    ``frobenius`` also returns sum K^2 (trace(K^2) for square K; the form
    of ``_matern_frobenius2_blocked``). ``V`` may be None when only the
    sum is wanted."""
    setup()  # K @ V on the card must not run in TF32
    cols = points if points_cols is None else points_cols
    nr = points.shape[0]
    out = None if V is None else torch.empty(
        (nr, V.shape[1]), dtype=V.dtype, device=V.device)
    fro = torch.zeros((), dtype=points.dtype, device=points.device)
    for i in range(0, nr, block_rows):
        dist = kernels.pairwise_scaled_distance(
            points[i:i + block_rows], cols, scale)
        Kblk = kernels.matern(dist, nu)
        if out is not None:
            out[i:i + block_rows] = Kblk @ V
        if frobenius:
            fro = fro + torch.sum(Kblk * Kblk)
    return (out, fro) if frobenius else out


def matern_matmat(points, scale, V, nu, points_cols=None, dot_mode=None,
                  frobenius=False, dist_mode="diff", block_rows=1024):
    """K @ V with K the Matern correlation of ``points`` (rows) and
    ``points_cols`` (columns, default the same points), K never stored.

    ``points`` (nr, d) with d <= 8, ``V`` (nc, r) or None (only with
    ``frobenius``); ``scale`` is a scalar or per-dimension correlation
    scale. Returns out (nr, r), and with ``frobenius=True`` the pair
    (out, sum K^2), out None when V is None; the sum is a 0-d tensor,
    float64 on the CUDA path.

    CPU tensors take :func:`matern_matmat_plain` (in their own dtype,
    ``block_rows`` rows at a time); CUDA tensors launch the float32 kernel
    and must be float32 and contiguous."""
    _check_modes(dot_mode, dist_mode)
    nu = kernels.check_static_nu(nu)
    if V is None and not frobenius:
        raise ValueError("V=None is only meaningful with frobenius=True")
    device = points.device
    for name, t in (("points_cols", points_cols), ("V", V)):
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, points on {device}")
    if points.ndim != 2:
        raise ValueError(f"points must be (n, d); got {tuple(points.shape)}")
    nr, d = points.shape
    scale = kernels.broadcast_scale(scale, d, dtype=points.dtype,
                                    device=device)
    if scale.shape != (d,):
        raise ValueError(f"scale must be a scalar or have {d} entries")
    if device.type == "cpu":
        return matern_matmat_plain(points, scale, V, nu, points_cols,
                                   frobenius, block_rows)
    if device.type != "cuda":
        raise ValueError(f"matern_matmat runs on cpu or cuda, not {device}")
    return _matern_matmat_cuda(points, scale, V, nu, points_cols, frobenius)


def _matern_matmat_cuda(points, scale, V, nu, points_cols, frobenius):
    from . import _build

    nr, d = points.shape
    if d < 1 or d > _MAX_D:
        raise ValueError(f"the CUDA kernel takes 1 <= d <= {_MAX_D}; got {d}")
    cols = points if points_cols is None else points_cols
    if cols.ndim != 2 or cols.shape[1] != d:
        raise ValueError(f"points_cols must be (nc, {d}); "
                         f"got {tuple(cols.shape)}")
    nc = cols.shape[0]
    r = 0 if V is None else V.shape[1]
    for name, t in (("points", points), ("points_cols", cols), ("V", V)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if V is not None and (V.ndim != 2 or V.shape[0] != nc):
        raise ValueError(f"V must be ({nc}, r); got {tuple(V.shape)}")
    if max(nr, nc, r) >= 2 ** 31:
        raise ValueError("sizes must fit in int32")

    rows_s = (points / scale).contiguous()
    cols_s = rows_s if points_cols is None else (cols / scale).contiguous()
    out = None if V is None else torch.empty(
        (nr, r), dtype=torch.float32, device=points.device)
    fro_rows = (torch.zeros(nr, dtype=torch.float64, device=points.device)
                if frobenius else None)
    if nr == 0 or (r == 0 and not frobenius):
        return (out, fro_rows.sum()) if frobenius else out

    lib = _build.load()
    code = _NU_CODES.get(nu, _GAUSS_CODE)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gppe_matern_matmat(
            rows_s.data_ptr(), cols_s.data_ptr(),
            None if V is None else V.data_ptr(),
            None if out is None else out.data_ptr(),
            None if fro_rows is None else fro_rows.data_ptr(),
            nr, nc, d, r, code, stream)
    if err != 0:
        raise RuntimeError(
            f"matern_matmat kernel launch failed: "
            f"{lib.gppe_cuda_error_string(err).decode()} (cudaError {err})")
    launch_counts["matern_matmat"] += 1
    if frobenius:
        return out, fro_rows.sum()
    return out
