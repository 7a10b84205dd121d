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

``matern_matmat_multirho`` (``csrc/matern_multirho.cu``) replaces
``pallas_kernels._multirho_kernel``: K(rho_b) @ V_b for a batch of
isotropic scales over one set of raw points, with per-rho trace(K_b^2).

``matern_matmat_blocksparse`` (``csrc/matern_blocksparse.cu``) replaces
``pallas_kernels._blocksparse_kernel``: the hard-tapered K @ V over a list
of active tile pairs, plus an optional trace(K^2) output that replaces the
XLA scan of ``taper.TaperedMaternOperator.trace_pow``.

``launch_counts`` counts launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else.
"""

import numpy as np
import torch

from . import kernels
from ..utils.config import setup

launch_counts = {"matern_matmat": 0, "matern_matmat_multirho": 0,
                 "matern_matmat_blocksparse": 0}

# nu -> template code of csrc/matern_matmat.cu (kNuHalf ... kNuGauss)
_NU_CODES = {0.5: 0, 1.5: 1, 2.5: 2}
_GAUSS_CODE = 3
_MAX_D = 8


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _check_modes(dot_mode, dist_mode="diff"):
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
    cols = points if points_cols is None else points_cols
    if cols.ndim != 2 or cols.shape[1] != d:
        raise ValueError(f"points_cols must be (nc, {d}); "
                         f"got {tuple(cols.shape)}")
    nc = cols.shape[0]
    r = 0 if V is None else V.shape[1]
    _check_cuda_operands(d, (("points", points), ("points_cols", cols),
                             ("V", V)))
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
    _raise_on_cuda_error(lib, err, "matern_matmat")
    launch_counts["matern_matmat"] += 1
    if frobenius:
        return out, fro_rows.sum()
    return out


def _check_cuda_operands(d, tensors):
    """What every kernel asks of its tensors: 1 <= d <= 8, float32,
    contiguous. ``tensors``: (name, tensor or None) pairs."""
    if d < 1 or d > _MAX_D:
        raise ValueError(f"the CUDA kernel takes 1 <= d <= {_MAX_D}; got {d}")
    for name, t in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on_cuda_error(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.gppe_cuda_error_string(err).decode()} (cudaError {err})")


# -- multi-rho -------------------------------------------------------------

def matern_matmat_multirho_plain(points, rhos, V, nu, return_frobenius=False,
                                 block_rows=1024):
    """Plain PyTorch K(rho_b) @ V_b by row blocks, in the inputs' dtype.

    One distance block serves the whole rho batch, in the kernel's
    arithmetic order: d^2 by differences on the raw points, one sqrt, then
    per rho a multiply by 1/rho_b and the closed form. ``V`` (B, n, r) in
    any strides, or None when only the traces are wanted."""
    setup()
    n = points.shape[0]
    inv = 1.0 / rhos
    B = rhos.shape[0]
    out = None if V is None else torch.empty(
        V.shape, dtype=V.dtype, device=V.device)
    fro = torch.zeros(B, dtype=points.dtype, device=points.device)
    for i in range(0, n, block_rows):
        r0 = kernels.pairwise_scaled_distance(points[i:i + block_rows],
                                              points, 1.0)
        for b in range(B):
            Kblk = kernels.matern(r0 * inv[b], nu)
            if out is not None:
                out[b, i:i + block_rows] = Kblk @ V[b]
            if return_frobenius:
                fro[b] += torch.sum(Kblk * Kblk)
    return (out, fro) if return_frobenius else out


def matern_matmat_multirho(points, rhos, V, nu, dot_mode=None,
                           return_frobenius=False, block_rows=1024):
    """K(rho_b) @ V_b for a batch of isotropic correlation scales, fused.

    ``points`` (n, d) RAW (unscaled) points with d <= 8; ``rhos`` (B,);
    ``V`` (B, n, r), or None with ``return_frobenius`` when only the traces
    are wanted. Returns out (B, n, r) and, with ``return_frobenius=True``,
    the pair (out, trace(K_b^2) (B,)), out None when V is None; the traces
    are float64 on the CUDA path.

    CPU tensors take :func:`matern_matmat_multirho_plain` (in their own
    dtype, ``block_rows`` rows at a time); CUDA tensors launch the float32
    kernel and must be float32 and contiguous."""
    _check_modes(dot_mode)
    nu = kernels.check_static_nu(nu)
    if V is None and not return_frobenius:
        raise ValueError("V=None is only meaningful with return_frobenius")
    if points.ndim != 2:
        raise ValueError(f"points must be (n, d); got {tuple(points.shape)}")
    n, d = points.shape
    device = points.device
    rhos = torch.as_tensor(rhos, dtype=points.dtype, device=device)
    if rhos.ndim != 1:
        raise ValueError(f"rhos must be (B,); got {tuple(rhos.shape)}")
    B = rhos.shape[0]
    if V is not None:
        if V.device != device:
            raise ValueError(f"V is on {V.device}, points on {device}")
        if V.ndim != 3 or V.shape[:2] != (B, n):
            raise ValueError(f"V must be ({B}, {n}, r); "
                             f"got {tuple(V.shape)}")
    if device.type == "cpu":
        return matern_matmat_multirho_plain(points, rhos, V, nu,
                                            return_frobenius, block_rows)
    if device.type != "cuda":
        raise ValueError(f"matern_matmat_multirho runs on cpu or cuda, "
                         f"not {device}")
    return _matern_matmat_multirho_cuda(points, rhos, V, nu,
                                        return_frobenius)


def _matern_matmat_multirho_cuda(points, rhos, V, nu, return_frobenius):
    from . import _build

    n, d = points.shape
    B = rhos.shape[0]
    r = 0 if V is None else V.shape[2]
    _check_cuda_operands(d, (("points", points), ("V", V)))
    if max(n, r, B) >= 2 ** 31:
        raise ValueError("sizes must fit in int32")

    inv_rho = (1.0 / rhos).contiguous()
    out = None if V is None else torch.empty(
        (B, n, r), dtype=torch.float32, device=points.device)
    fro_rows = (torch.zeros((B, n), dtype=torch.float64, device=points.device)
                if return_frobenius else None)
    if n > 0 and B > 0 and (r > 0 or return_frobenius):
        lib = _build.load()
        code = _NU_CODES.get(nu, _GAUSS_CODE)
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.gppe_matern_multirho(
                points.data_ptr(), inv_rho.data_ptr(),
                None if V is None else V.data_ptr(),
                None if out is None else out.data_ptr(),
                None if fro_rows is None else fro_rows.data_ptr(),
                n, d, B, r, code, stream)
        _raise_on_cuda_error(lib, err, "matern_matmat_multirho")
        launch_counts["matern_matmat_multirho"] += 1
    return (out, fro_rows.sum(dim=1)) if return_frobenius else out


# -- block-sparse (tapered) --------------------------------------------------

def blocksparse_row_ptr(pair_i, num_tiles):
    """Row-tile pointer array of a pair list sorted by row tile: row tile
    ti owns pairs ``row_ptr[ti]:row_ptr[ti + 1]``. (num_tiles + 1,) int32
    numpy. Raises if the list is not sorted or a row tile has no pair
    (every tile is adjacent to itself, so none may be empty)."""
    pair_i = np.asarray(pair_i)
    if pair_i.size and (np.any(np.diff(pair_i) < 0) or pair_i[0] < 0
                        or pair_i[-1] >= num_tiles):
        raise ValueError("pair_i must be sorted and lie in [0, num_tiles)")
    row_ptr = np.searchsorted(pair_i, np.arange(num_tiles + 1)).astype(
        np.int32)
    if np.any(np.diff(row_ptr) <= 0):
        raise ValueError("every row tile needs at least one active pair")
    return row_ptr


def _blocksparse_tile_columns(pair_j, row_ptr, ti, tile, n):
    """Indices of the real columns that row tile ``ti`` multiplies."""
    tiles = pair_j[int(row_ptr[ti]):int(row_ptr[ti + 1])].to(torch.int64)
    cols = (tiles[:, None] * tile + torch.arange(
        tile, device=pair_j.device)[None, :]).reshape(-1)
    return cols[cols < n]


def _blocksparse_geometry(points_sorted, pair_i, pair_j, tile, n, row_ptr):
    n_pad = points_sorted.shape[0]
    tile = int(tile)
    if n_pad % tile:
        raise ValueError(f"points_sorted has {n_pad} rows, not a multiple "
                         f"of tile = {tile}")
    n = n_pad if n is None else int(n)
    if not n_pad - tile < n <= n_pad:
        raise ValueError(f"n = {n} real points do not fill {n_pad // tile} "
                         f"tiles of {tile}")
    pair_j = torch.as_tensor(pair_j, dtype=torch.int32,
                             device=points_sorted.device)
    if row_ptr is None:
        # an unprepared pair list: check it here, on the host
        if torch.is_tensor(pair_i):
            pair_i = pair_i.cpu().numpy()
        row_ptr = torch.as_tensor(
            blocksparse_row_ptr(pair_i, n_pad // tile),
            device=points_sorted.device)
        if pair_j.shape != (len(pair_i),) or (pair_j.numel() and not (
                0 <= int(pair_j.min()) and int(pair_j.max()) < n_pad // tile)):
            raise ValueError("pair_j must pair up with pair_i and lie in "
                             "[0, num_tiles)")
    return tile, n, n_pad // tile, row_ptr, pair_j


def matern_matmat_blocksparse_plain(points_sorted, V, nu, tau, pair_i,
                                    pair_j, tile, n=None, frobenius=False,
                                    row_ptr=None):
    """Plain PyTorch tapered K @ V, one row tile at a time against that
    tile's active column tiles, in the inputs' dtype; the hard taper
    ``k >= tau ? k : 0`` is taken in that dtype too. Arguments as
    :func:`matern_matmat_blocksparse`."""
    setup()
    tile, n, num_tiles, row_ptr, pair_j = _blocksparse_geometry(
        points_sorted, pair_i, pair_j, tile, n, row_ptr)
    out = None if V is None else torch.zeros(
        V.shape, dtype=V.dtype, device=V.device)
    fro = torch.zeros((), dtype=points_sorted.dtype,
                      device=points_sorted.device)
    row_ptr = row_ptr.cpu()
    for ti in range(num_tiles):
        rows = slice(ti * tile, min((ti + 1) * tile, n))
        cols = _blocksparse_tile_columns(pair_j, row_ptr, ti, tile, n)
        dist = kernels.pairwise_scaled_distance(points_sorted[rows],
                                                points_sorted[cols], 1.0)
        Kblk = kernels.matern(dist, nu)
        Kblk = torch.where(Kblk >= tau, Kblk, torch.zeros_like(Kblk))
        if out is not None:
            out[rows] = Kblk @ V[cols]
        if frobenius:
            fro = fro + torch.sum(Kblk * Kblk)
    return (out, fro) if frobenius else out


def blocksparse_count_near_threshold(points_sorted, nu, tau, pair_i, pair_j,
                                     tile, n=None, rel=1e-5, row_ptr=None):
    """How many entries of the active tile pairs have a kernel value
    within ``rel * tau`` of ``tau``, in the points' dtype."""
    tile, n, num_tiles, row_ptr, pair_j = _blocksparse_geometry(
        points_sorted, pair_i, pair_j, tile, n, row_ptr)
    row_ptr = row_ptr.cpu()
    count = 0
    for ti in range(num_tiles):
        rows = slice(ti * tile, min((ti + 1) * tile, n))
        cols = _blocksparse_tile_columns(pair_j, row_ptr, ti, tile, n)
        dist = kernels.pairwise_scaled_distance(points_sorted[rows],
                                                points_sorted[cols], 1.0)
        Kblk = kernels.matern(dist, nu)
        count += int(torch.count_nonzero(
            torch.abs(Kblk - tau) < rel * tau))
    return count


def blocksparse_clear_threshold(points_sorted, nu, tau, pair_i, pair_j, tile,
                                n=None, rel=1e-5, row_ptr=None):
    """``tau``, moved up in steps of ``3 * rel`` (relative) until no entry
    of the active tile pairs lies within ``rel * tau`` of it.

    The hard taper flips an entry that close to the threshold between k
    and 0 on a float32 rounding error, and one flipped entry (k ~ tau, not
    small) is a visible error in the product. So a float32 product is held
    to a float64 one at a threshold that is clear of every pair, found
    here on float64 points. Moving tau up only shrinks the taper ball, so
    a pair list built for ``tau`` still covers it."""
    for step in range(200):
        clear = tau * (1.0 + 3.0 * rel * step)
        if blocksparse_count_near_threshold(
                points_sorted, nu, clear, pair_i, pair_j, tile, n, rel,
                row_ptr) == 0:
            return clear
    raise ValueError("no threshold clear of every pair within 200 steps")


def matern_matmat_blocksparse(points_sorted, V, nu, tau, pair_i, pair_j,
                              tile, n=None, dot_mode=None, frobenius=False,
                              row_ptr=None):
    """Tapered (block-sparse) K @ V over active tile pairs only.

    ``points_sorted`` (n_pad, d): spatially sorted, *already scaled*
    points, padded to a multiple of ``tile``; only the first ``n`` (default
    all) are real, and pad rows and columns take no part: pad rows of the
    result are zero. ``V`` (n_pad, r) in the same order, or None with
    ``frobenius`` when only the trace is wanted. ``pair_i``/``pair_j``:
    active tile index pairs sorted by row tile
    (:class:`gppe_tpu_torch.ops.taper.TaperedMaternOperator` builds them);
    ``row_ptr``: the int32 tensor of :func:`blocksparse_row_ptr` on the
    points' device; when absent it is built here from ``pair_i`` and the
    pair list is checked, on the host (a caller that multiplies often
    passes it, and ``pair_j`` as an int32 tensor on the device, and
    answers for both). ``tau``: the taper threshold; entries with k < tau
    are zero.

    Returns out (n_pad, r), and with ``frobenius=True`` the pair (out, sum
    of squared tapered entries = trace(K^2)), out None when V is None; the
    sum is a 0-d tensor, float64 on the CUDA path.

    CPU tensors take :func:`matern_matmat_blocksparse_plain`; CUDA tensors
    launch the float32 kernel and must be float32 and contiguous."""
    _check_modes(dot_mode)
    nu = kernels.check_static_nu(nu)
    if V is None and not frobenius:
        raise ValueError("V=None is only meaningful with frobenius=True")
    if points_sorted.ndim != 2:
        raise ValueError(f"points_sorted must be (n_pad, d); "
                         f"got {tuple(points_sorted.shape)}")
    device = points_sorted.device
    if V is not None:
        if V.device != device:
            raise ValueError(f"V is on {V.device}, points on {device}")
        if V.ndim != 2 or V.shape[0] != points_sorted.shape[0]:
            raise ValueError(f"V must be ({points_sorted.shape[0]}, r); "
                             f"got {tuple(V.shape)}")
    if device.type == "cpu":
        return matern_matmat_blocksparse_plain(
            points_sorted, V, nu, tau, pair_i, pair_j, tile, n, frobenius,
            row_ptr)
    if device.type != "cuda":
        raise ValueError(f"matern_matmat_blocksparse runs on cpu or cuda, "
                         f"not {device}")
    return _matern_matmat_blocksparse_cuda(
        points_sorted, V, nu, tau, pair_i, pair_j, tile, n, frobenius,
        row_ptr)


def _matern_matmat_blocksparse_cuda(points_sorted, V, nu, tau, pair_i,
                                    pair_j, tile, n, frobenius, row_ptr):
    from . import _build

    n_pad, d = points_sorted.shape
    _check_cuda_operands(d, (("points_sorted", points_sorted), ("V", V)))
    tile, n, num_tiles, row_ptr, pair_j = _blocksparse_geometry(
        points_sorted, pair_i, pair_j, tile, n, row_ptr)
    r = 0 if V is None else V.shape[1]
    for name, t, size in (("row_ptr", row_ptr, num_tiles + 1),
                          ("pair_j", pair_j, pair_j.numel())):
        if (t.dtype != torch.int32 or t.device != points_sorted.device
                or not t.is_contiguous() or t.shape != (size,)):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"{size} entries on {points_sorted.device}")
    # every product of sizes that becomes an offset in the kernel
    if n_pad >= 2 ** 31 or n_pad * max(r, d, 1) >= 2 ** 63:
        raise ValueError("sizes must fit in int32, offsets in int64")

    out = None if V is None else torch.empty(
        (n_pad, r), dtype=torch.float32, device=points_sorted.device)
    fro_rows = (torch.zeros(n_pad, dtype=torch.float64,
                            device=points_sorted.device)
                if frobenius else None)
    if r > 0 or frobenius:
        lib = _build.load()
        code = _NU_CODES.get(nu, _GAUSS_CODE)
        with torch.cuda.device(points_sorted.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.gppe_matern_blocksparse(
                points_sorted.data_ptr(),
                None if V is None else V.data_ptr(),
                None if out is None else out.data_ptr(),
                None if fro_rows is None else fro_rows.data_ptr(),
                row_ptr.data_ptr(), pair_j.data_ptr(),
                n, d, r, tile, num_tiles, float(tau), code, stream)
        _raise_on_cuda_error(lib, err, "matern_matmat_blocksparse")
        launch_counts["matern_matmat_blocksparse"] += 1
    return (out, fro_rows.sum()) if frobenius else out
