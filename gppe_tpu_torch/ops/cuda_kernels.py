"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of :mod:`gppe_tpu.ops.pallas_kernels`. Each public function
takes the plain PyTorch version for tensors on the CPU and launches its
CUDA kernel for tensors on a CUDA device; there is no fallback from one to
the other.

``matern_matmat`` replaces the TPU kernels ``pallas_kernels._matmat_kernel``
and ``_matmat_kernel_gram``: K @ V with K the Matern correlation of the
scaled points, never stored, plus an optional trace(K^2) output that
replaces the XLA pass ``operators._matern_frobenius2_blocked``. Its
products run ``csrc/matern_matmat_mma.cu`` in every tile-dot mode of
``pallas_kernels._tile_dot``, on the tensor cores with float32 sums: the
exact mode ``'highest'`` as 3xTF32 (tf32 high and residual parts, IEEE
sqrt and exp; :func:`_tf32x3_dot_plain` is its plain version), ``'bf16x3'``
and ``'bf16'`` with bf16 operands. Every trace(K^2) pass runs
``csrc/matern_matmat.cu`` (IEEE float32 k^2, float64 block partials).
``dist_mode='gram'`` takes d^2 = |x|^2 + |y|^2 - 2 x.y on points centred
on the column mean instead of the exact difference form, in both.

``matern_matmat_multirho`` replaces ``pallas_kernels._multirho_kernel``:
K(rho_b) @ V_b for a batch of isotropic scales over one set of raw points,
with per-rho trace(K_b^2).

``matern_matmat_blocksparse`` replaces
``pallas_kernels._blocksparse_kernel``: the hard-tapered K @ V over a list
of active tile pairs, plus an optional trace(K^2) output that replaces the
XLA scan of ``taper.TaperedMaternOperator.trace_pow``. A general nu there
runs ``csrc/matern_blocksparse_general.cu`` (below).

Both take the same three dot modes as ``matern_matmat``, the same way: every
product runs a tensor-core kernel (``csrc/matern_multirho_mma.cu``,
``csrc/matern_blocksparse_mma.cu``), 'highest' as 3xTF32 with IEEE k, and
every trace an FP32 kernel that holds nothing else
(``csrc/matern_multirho.cu``, ``csrc/matern_blocksparse.cu``).
:func:`_launch_plan` is the routing table of all three wrappers.

The tile-dot modes round the operands only: a trace(K^2) output always
sums the unrounded k^2 (the reference's ``trace_pow(2)`` is the exact pass
in every mode). The dense trace kernels walk tile pairs of 128 x 128
points, only those with tj >= ti where K is symmetric bit for bit, and
write one float64 partial per block (and rho) that the wrapper sums:
:func:`trace_schedule` and :func:`trace_tile_pair` mirror that walk. The
tapered trace kernel walks 128 x 128 units of the pair list's tiles in
the same way, only those of the tile pairs ti <= tj (and of the sub-tile
triangle on diagonal tiles) where the list holds its mirror:
:func:`blocksparse_trace_schedule` builds that walk and mirrors it.

``matern_general`` (elementwise), ``matern_general_matmat`` (the product
and trace(K^2)), ``matern_general_matmat_batched`` and
``matern_general_trace_batched`` (the product and the trace for a batch of
(scale, nu) points) run ``csrc/matern_general.cu``, the Matern
correlation of a general nu (outside 1/2, 3/2, 5/2 and the Gaussian limit)
through the Bessel K_nu in registers. It replaces no Pallas kernel: on the
TPU the general-nu assembly, the row-blocked products and traces of
``operators.MaternOperator`` and the general branch of the grid engine ran
XLA-fused. Its product fills branch-binned k tiles
(``csrc/matern_general_tile.cuh``) on a symmetric walk of tile pairs, each k
serving K[i, j] and K[j, i], and sums each row tile's slots in a fixed
order; its walk runs in bands whose slots fit :data:`GENERAL_SLOT_BYTES`
(:func:`general_product_bands`), and each band's launch serves a whole
grid chunk. Its trace fills the same k tiles on the dense traces' walk,
counting the pairs above K's diagonal of a square K, and one launch
serves a grid chunk too (:func:`general_trace_batches`). ``matern_matmat`` hands a general nu to it, so
``MaternOperator`` takes every nu; the multi-rho kernel takes the closed
forms only (a general-nu grid calls ``matern_general_matmat_batched``).
``matern_matmat_blocksparse`` hands a general nu to
``csrc/matern_blocksparse_general.cu``, the same device function over the
tapered kernels' pair list and trace walk (the product on the binned k
tiles of the pairs within :func:`blocksparse_skip_radius`, one launch per
32 columns of V, and the trace on the same tiles over the walk of
:func:`blocksparse_general_trace_schedule`), where the reference runs its
XLA scans;
so ``TaperedMaternOperator`` takes every nu too.

``launch_counts`` counts launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else.
"""

import functools
import math

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from ..utils.config import setup

DOT_MODES = ("highest", "bf16x3", "bf16")
# ``dot_mode=None`` means this module default, read at call time (a caller
# may change it by assignment; it then reaches every engine that passes no
# mode of its own)
DEFAULT_DOT_MODE = "highest"
DIST_MODES = ("diff", "gram")

launch_counts = {"matern_matmat": 0, "matern_matmat_mma": 0,
                 "matern_matmat_multirho": 0,
                 "matern_matmat_multirho_mma": 0,
                 "matern_matmat_blocksparse": 0,
                 "matern_matmat_blocksparse_mma": 0,
                 "matern_general_elementwise": 0,
                 "matern_general_product": 0, "matern_general_trace": 0,
                 "matern_blocksparse_general_product": 0,
                 "matern_blocksparse_general_trace": 0}

# nu -> template code of csrc/matern_common.cuh (kNuHalf ... kNuGauss)
_NU_CODES = {0.5: 0, 1.5: 1, 2.5: 2}
_GAUSS_CODE = 3
# dot mode -> code of csrc/matern_common.cuh (kDotHighest, kDotBf16x3,
# kDotBf16), as the tensor-core kernels take it
_DOT_CODES = {"highest": 0, "bf16x3": 1, "bf16": 2}
_MAX_D = 8
# the trace kernels' walk (csrc/matern_trace.cuh): tile pairs (the
# tapered kernel's units) of _TRACE_TILE x _TRACE_TILE points, at most
# _TRACE_MAX_BLOCKS blocks of consecutive pairs, each writing one float64
# partial (per rho); the multi-rho one holds _TRACE_RHOS rhos per thread,
# more over grid.y
_TRACE_TILE, _TRACE_MAX_BLOCKS, _TRACE_RHOS = 128, 1 << 19, 8
# the general-nu product kernels (csrc/matern_general.cu,
# matern_blocksparse_general.cu): at most 32 columns of V per launch
_GENERAL_MAX_COLS = 32
# the rows of their branch-binned k tile (csrc/matern_general_tile.cuh),
# the general-nu traces' unit of rows
_TILE_ROWS = 64
# the most float64 partials one launch of the general-nu trace writes
# (32 MiB): a larger batch of points runs as launches of fewer points
_GENERAL_TRACE_PARTIALS = 1 << 22
# the most slot scratch one general-nu product (csrc/matern_general.cu)
# takes: its walk runs in bands of tile pairs whose slots fit (at least
# one pair a band), and the grid engine counts it in its chunk's budget
GENERAL_SLOT_BYTES = 256 << 20
# the general-nu kernel's k against float64: the reference's own float32
# error at nu ~ 25 (gppe_tpu/ops/kernels.py:33-36), the bound chip_smoke.py
# holds it to (9.1e-7 measured); the tapered product's skip radius rests
# on it
GENERAL_K_ATOL = 3e-5


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def resolve_dot_mode(dot_mode):
    """``dot_mode``, or the module default for None; raises on a name that
    is not one of ``DOT_MODES``."""
    dot_mode = DEFAULT_DOT_MODE if dot_mode is None else dot_mode
    if dot_mode not in DOT_MODES:
        raise ValueError(f"dot_mode must be one of {DOT_MODES}; got "
                         f"{dot_mode}")
    return dot_mode


def _check_dist_mode(dist_mode):
    if dist_mode not in DIST_MODES:
        raise ValueError(f"dist_mode must be 'diff' or 'gram'; got "
                         f"{dist_mode}")


def _bf16_round(x):
    return x.to(torch.bfloat16).to(x.dtype)


def tile_dot_plain(K, V, dot_mode):
    """K @ V at the precision of ``pallas_kernels._tile_dot``, whatever the
    inputs' dtype: 'highest' multiplies them as they are; 'bf16' rounds
    both operands to bfloat16 and multiplies in the inputs' dtype; 'bf16x3'
    splits each operand into a bfloat16 high part and the bfloat16 rounding
    of the residual and sums hi.hi + lo.hi + hi.lo (only lo.lo is dropped).
    """
    dot_mode = resolve_dot_mode(dot_mode)
    if dot_mode == "highest":
        return K @ V
    k_hi, v_hi = _bf16_round(K), _bf16_round(V)
    if dot_mode == "bf16":
        return k_hi @ v_hi
    k_lo, v_lo = _bf16_round(K - k_hi), _bf16_round(V - v_hi)
    return k_hi @ v_hi + k_lo @ v_hi + k_hi @ v_lo


def _tf32_round(x):
    """float32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 stored mantissa bits, ties away from zero, the low 13 bits zero
    (adding half a tf32 unit to the magnitude bits and truncating). A value
    that rounds past the largest float32 becomes inf; inf and NaN pass
    unchanged. Module-private: the plain version of the split that the
    tensor-core kernels take under 'highest'."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded, bits).view(torch.float32)


def _tf32x3_dot_plain(K, V):
    """K @ V as the tensor-core kernels compute it under 'highest', in
    float32: each operand split into hi = tf32(x) and lo = tf32(x - hi)
    (:func:`_tf32_round`), hi.hi + lo.hi + hi.lo (lo.lo dropped) summed
    over 128 columns of K at a time (the kernels' column tile), and those
    partial products added in float32, the two-level sum of
    ``csrc/matern_matmat_mma.cu`` (``csrc/matern_multirho_mma.cu``
    compensates that last sum). Not a dot mode: the plain 'highest' product
    stays K @ V; the plain multi-rho and block-sparse versions take this
    one through their module-private ``_product``."""
    K, V = K.float(), V.float()
    k_hi, v_hi = _tf32_round(K), _tf32_round(V)
    k_lo, v_lo = _tf32_round(K - k_hi), _tf32_round(V - v_hi)
    out = torch.zeros((K.shape[0], V.shape[1]), dtype=torch.float32,
                      device=K.device)
    for j in range(0, K.shape[1], 128):
        cols = slice(j, j + 128)
        out += (k_hi[:, cols] @ v_hi[cols]
                + (k_lo[:, cols] @ v_hi[cols] + k_hi[:, cols] @ v_lo[cols]))
    return out


def _gram_operands(rows_s, cols_s):
    """The Gram form's operands from the scaled row and column points:
    both centred on the column mean (distances do not change, and smaller
    |x|^2 loses less to cancellation), and their squared norms."""
    center = cols_s.mean(dim=0, keepdim=True)
    rows_c = (rows_s - center).contiguous()
    cols_c = (cols_s - center).contiguous()
    return (rows_c, cols_c, (rows_c * rows_c).sum(dim=1),
            (cols_c * cols_c).sum(dim=1))


def _gram_distance(rows_c, cols_c, rows_norm, cols_norm):
    d2 = (rows_norm[:, None] + cols_norm[None, :]
          - 2.0 * (rows_c @ cols_c.T))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def matern_matmat_plain(points, scale, V, nu, points_cols=None,
                        frobenius=False, block_rows=1024, dot_mode=None,
                        dist_mode="diff"):
    """Plain PyTorch K @ V by row blocks, in the inputs' dtype.

    Each block's correlation tile is computed, multiplied and discarded
    (the form of ``gppe_tpu.ops.operators._matern_matmat_blocked``); the
    product is :func:`tile_dot_plain` at ``dot_mode``. ``dist_mode='gram'``
    takes the distance as |x|^2 + |y|^2 - 2 x.y on points centred on the
    mean of the scaled column points, clamped at 0. With ``frobenius`` also
    returns sum K^2 of the unrounded K (trace(K^2) for square K; the form
    of ``_matern_frobenius2_blocked``). ``V`` may be None when only the sum
    is wanted."""
    setup()  # K @ V on the card must not run in TF32
    dot_mode = resolve_dot_mode(dot_mode)
    _check_dist_mode(dist_mode)
    cols = points if points_cols is None else points_cols
    nr = points.shape[0]
    if dist_mode == "gram":
        rows_c, cols_c, rows_norm, cols_norm = _gram_operands(
            points / scale, cols / scale)
    out = None if V is None else torch.empty(
        (nr, V.shape[1]), dtype=V.dtype, device=V.device)
    fro = torch.zeros((), dtype=points.dtype, device=points.device)
    for i in range(0, nr, block_rows):
        if dist_mode == "gram":
            dist = _gram_distance(rows_c[i:i + block_rows], cols_c,
                                  rows_norm[i:i + block_rows], cols_norm)
        else:
            dist = kernels.pairwise_scaled_distance(
                points[i:i + block_rows], cols, scale)
        Kblk = kernels.matern(dist, nu)
        if out is not None:
            out[i:i + block_rows] = tile_dot_plain(Kblk, V, dot_mode)
        if frobenius:
            fro = fro + torch.sum(Kblk * Kblk)
    return (out, fro) if frobenius else out


def matern_matmat(points, scale, V, nu, points_cols=None, dot_mode=None,
                  frobenius=False, dist_mode="diff", block_rows=1024):
    """K @ V with K the Matern correlation of ``points`` (rows) and
    ``points_cols`` (columns, default the same points), K never stored.

    ``points`` (nr, d) with d <= 8, ``V`` (nc, r) or None (only with
    ``frobenius``); ``scale`` is a scalar or per-dimension correlation
    scale. ``dot_mode``: one of ``DOT_MODES`` (None: ``DEFAULT_DOT_MODE``),
    the precision of the K-tile times V product; 'bf16x3' and 'bf16' round
    V, so the map is not exactly linear and u.Kv differs from v.Ku at the
    1e-6 level. ``dist_mode``: 'diff' (exact differences) or 'gram'
    (|x|^2 + |y|^2 - 2 x.y on centred points: about 1e-3 of kernel error on
    near-coincident pairs). Returns out (nr, r), and with
    ``frobenius=True`` the pair (out, sum K^2), out None when V is None;
    the sum is a 0-d tensor of the unrounded k^2, float64 on the CUDA path.

    CPU tensors take :func:`matern_matmat_plain` (in their own dtype,
    ``block_rows`` rows at a time); CUDA tensors launch float32 kernels
    and must be float32 and contiguous: the tensor-core kernel for the
    product in every mode, the FP32-FMA kernel for the sum K^2 (so a call
    that asks for both launches both)."""
    dot_mode = resolve_dot_mode(dot_mode)
    _check_dist_mode(dist_mode)
    nu = check_nu(nu)
    if not kernels.is_closed_form(nu):
        if dist_mode != "diff":
            raise ValueError("a general nu takes the difference form only "
                             "(dist_mode='diff')")
        return matern_general_matmat(points, scale, V, nu, points_cols,
                                     frobenius, block_rows)
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
                                   frobenius, block_rows, dot_mode,
                                   dist_mode)
    if device.type != "cuda":
        raise ValueError(f"matern_matmat runs on cpu or cuda, not {device}")
    return _matern_matmat_cuda(points, scale, V, nu, points_cols, frobenius,
                               dot_mode, dist_mode)


def _matern_matmat_cuda(points, scale, V, nu, points_cols, frobenius,
                        dot_mode, dist_mode):
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
    rows_norm = cols_norm = None
    if dist_mode == "gram" and nr > 0 and nc > 0:
        # the kernels take the centred points and their norms from here
        rows_s, cols_s, rows_norm, cols_norm = _gram_operands(rows_s, cols_s)
    out = None if V is None else torch.empty(
        (nr, r), dtype=torch.float32, device=points.device)
    # the trace walks half the tile pairs where K is symmetric bit for bit:
    # square, and the difference form (the Gram form walks them all)
    symmetric = points_cols is None and dist_mode == "diff"
    _, _, _, per_block, blocks = trace_schedule(nr, nc, symmetric)
    partials = (torch.zeros(blocks, dtype=torch.float64,
                            device=points.device) if frobenius else None)
    if nr == 0 or (r == 0 and not frobenius):
        return (out, partials.sum()) if frobenius else out

    lib = _build.load()
    code = _NU_CODES.get(nu, _GAUSS_CODE)
    geometry = (rows_s.data_ptr(), cols_s.data_ptr(),
                None if rows_norm is None else rows_norm.data_ptr(),
                None if cols_norm is None else cols_norm.data_ptr())
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        for entry, counter in _launch_plan("matmat", r, frobenius):
            if entry == "gppe_matern_matmat_mma":
                # V's split images, written once per launch by the kernel's
                # pre-pass; freed after the launch in stream order
                scratch = torch.empty(
                    lib.gppe_matern_matmat_mma_scratch_bytes(
                        nc, d, r, _DOT_CODES[dot_mode],
                        int(rows_norm is not None)),
                    dtype=torch.uint8, device=points.device)
                err = lib.gppe_matern_matmat_mma(
                    *geometry, V.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), nr, nc, d, r, code,
                    _DOT_CODES[dot_mode], stream)
            elif blocks == 0:
                continue  # no columns: nothing to sum
            else:
                err = lib.gppe_matern_matmat(
                    *geometry, partials.data_ptr(), nr, nc, d, code,
                    int(symmetric), per_block, blocks, stream)
            _raise_on_cuda_error(lib, err, counter)
            launch_counts[counter] += 1
    if frobenius:
        return out, partials.sum()
    return out


def trace_schedule(nr, nc, symmetric):
    """The walk of the dense trace kernels over an nr x nc K:
    ``(tiles_r, tiles_c, pairs, per_block, blocks)``. ``symmetric`` (the
    rows are the columns) walks the ``pairs`` = T (T + 1) / 2 tile pairs
    with tj >= ti, else all tiles_r * tiles_c; ``blocks`` blocks take
    ``per_block`` consecutive pairs each (the last perhaps fewer), so the
    partials buffer has ``blocks`` entries per rho."""
    tiles_r, tiles_c = -(-nr // _TRACE_TILE), -(-nc // _TRACE_TILE)
    pairs = (tiles_r * (tiles_r + 1) // 2 if symmetric
             else tiles_r * tiles_c)
    return (tiles_r, tiles_c, pairs, *trace_blocks(pairs))


def trace_blocks(pairs):
    """``(per_block, blocks)``: the fewest consecutive pairs (or units) per
    block that keep the blocks, and so the partials, at most
    ``_TRACE_MAX_BLOCKS``; the last block perhaps takes fewer. Every trace
    kernel's grid (``csrc/matern_trace.cuh::trace_grid_ok``)."""
    per_block = max(1, -(-pairs // _TRACE_MAX_BLOCKS))
    return per_block, -(-pairs // per_block)


def trace_tile_pair(p, tiles_r, tiles_c, symmetric):
    """Tile pair ``p`` of the walk as ``(ti, tj, weight)``, the integer
    arithmetic of ``csrc/matern_trace.cuh::trace_tile_pair``; ``p`` is an
    int or an integer array (numpy or torch). Symmetric: rows q and
    T - 1 - q of the triangle tj >= ti hold T + 1 pairs together,
    q = p // (T + 1), row q first; weight 2 off the diagonal. Otherwise
    row-major over all pairs, weight 1."""
    if not symmetric:
        return p // tiles_c, p % tiles_c, 1 + 0 * p
    q, c = p // (tiles_r + 1), p % (tiles_r + 1)
    folded = c >= tiles_r - q   # in row T - 1 - q, at column c - 1
    ti = q + folded * (tiles_r - 1 - 2 * q)
    tj = q + c - folded * (q + 1)
    return ti, tj, 1 + (ti != tj)


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
                                 block_rows=1024, dot_mode=None,
                                 _product=None):
    """Plain PyTorch K(rho_b) @ V_b by row blocks, in the inputs' dtype.

    One distance block serves the whole rho batch, in the kernel's
    arithmetic order: d^2 by differences on the raw points, one sqrt, then
    per rho a multiply by 1/rho_b and the closed form; the product is
    :func:`tile_dot_plain` at ``dot_mode``, the traces sum the unrounded
    k^2. ``V`` (B, n, r) in any strides, or None when only the traces are
    wanted. ``_product`` (module-private): a function (K block, V) -> the
    product, in place of the tile dot; :func:`_tf32x3_dot_plain` makes this
    the plain version of the 'highest' kernel."""
    setup()
    dot_mode = resolve_dot_mode(dot_mode)
    if _product is None:
        _product = lambda K, W: tile_dot_plain(K, W, dot_mode)  # noqa: E731
    n = points.shape[0]
    inv = 1.0 / rhos
    B = rhos.shape[0]
    out = None if V is None else torch.empty(
        V.shape, dtype=V.dtype, device=V.device)
    if V is not None:
        # one layout whatever V's strides: the CPU's matmul takes another
        # route, and sums in another order, for a strided operand
        V = V.contiguous()
    fro = torch.zeros(B, dtype=points.dtype, device=points.device)
    for i in range(0, n, block_rows):
        r0 = kernels.pairwise_scaled_distance(points[i:i + block_rows],
                                              points, 1.0)
        for b in range(B):
            Kblk = kernels.matern(r0 * inv[b], nu)
            if out is not None:
                out[b, i:i + block_rows] = _product(Kblk, V[b])
            if return_frobenius:
                fro[b] += torch.sum(Kblk * Kblk)
    return (out, fro) if return_frobenius else out


def matern_matmat_multirho(points, rhos, V, nu, dot_mode=None,
                           return_frobenius=False, block_rows=1024):
    """K(rho_b) @ V_b for a batch of isotropic correlation scales, fused.

    ``points`` (n, d) RAW (unscaled) points with d <= 8; ``rhos`` (B,);
    ``V`` (B, n, r), or None with ``return_frobenius`` when only the traces
    are wanted. ``dot_mode`` as in :func:`matern_matmat`. Returns out
    (B, n, r) and, with ``return_frobenius=True``, the pair (out,
    trace(K_b^2) (B,)), out None when V is None; the traces are float64 on
    the CUDA path.

    CPU tensors take :func:`matern_matmat_multirho_plain` (in their own
    dtype, ``block_rows`` rows at a time); CUDA tensors must be float32
    and contiguous and launch float32 kernels: the product the tensor-core
    kernel (``csrc/matern_multirho_mma.cu``) in every mode, 'highest' as
    3xTF32, the traces the FP32 kernel (``csrc/matern_multirho.cu``), so a
    call that asks for both launches both."""
    dot_mode = resolve_dot_mode(dot_mode)
    nu = check_nu(nu)
    if not kernels.is_closed_form(nu):
        raise NotImplementedError(
            f"matern_matmat_multirho takes the closed forms of nu (1/2, "
            f"3/2, 5/2, >= 100), as the reference's multi-rho kernel does; "
            f"a grid over general nu = {nu} maps matern_general_matmat over "
            f"its points (GridKrylovProfileLikelihood)")
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
                                            return_frobenius, block_rows,
                                            dot_mode)
    if device.type != "cuda":
        raise ValueError(f"matern_matmat_multirho runs on cpu or cuda, "
                         f"not {device}")
    return _matern_matmat_multirho_cuda(points, rhos, V, nu,
                                        return_frobenius, dot_mode)


def _launch_plan(kernel, r, frobenius):
    """The launches of one ``matern_matmat`` call on the card (``kernel``
    'matmat') or of one ``matern_matmat_<kernel>`` call ('multirho',
    'blocksparse'), as (C entry, launch counter) pairs, in launch order,
    the same in every dot mode: the product (r > 0) is one launch of the
    tensor-core kernel, which takes the mode's code; it sums no k^2, so the
    sums, where asked for, are a trace-only launch of the FP32 kernel (they
    never round). ``kernel`` 'general' (a general nu, in
    ``matern_general_matmat`` and ``matern_general_matmat_batched``): the
    product on ``matern_general.cu``, one entry per 32 columns of V for
    the whole batch (launched once per band of its walk), then its trace
    entry; ``kernel`` 'blocksparse_general' (a general nu in
    ``matern_matmat_blocksparse``) one launch per 32 columns of
    ``matern_blocksparse_general.cu``'s product, then its trace."""
    if kernel in ("general", "blocksparse_general"):
        name = ("matern_general" if kernel == "general"
                else "matern_blocksparse_general")
        plan = [(f"gppe_{name}_product", f"{name}_product")
                ] * -(-r // _GENERAL_MAX_COLS)
        if frobenius:
            plan.append((f"gppe_{name}_trace", f"{name}_trace"))
        return plan
    trace = ("gppe_matern_matmat", "matern_matmat") if kernel == "matmat" \
        else (f"gppe_matern_{kernel}", f"matern_matmat_{kernel}")
    plan = [(f"{trace[0]}_mma", f"{trace[1]}_mma")] if r > 0 else []
    if frobenius:
        plan.append(trace)
    return plan


def _matern_matmat_multirho_cuda(points, rhos, V, nu, return_frobenius,
                                 dot_mode):
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
    # K(rho_b) is symmetric bit for bit: the traces walk half the tile pairs
    _, _, _, per_block, blocks = trace_schedule(n, n, True)
    partials = (torch.zeros((B, blocks), dtype=torch.float64,
                            device=points.device)
                if return_frobenius else None)
    if n > 0 and B > 0 and (r > 0 or return_frobenius):
        lib = _build.load()
        code = _NU_CODES.get(nu, _GAUSS_CODE)
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream().cuda_stream
            for entry, counter in _launch_plan("multirho", r,
                                               return_frobenius):
                if entry == "gppe_matern_multirho_mma":
                    # under 'highest' V's split images, written once per
                    # launch by the kernel's pre-pass; freed after the
                    # launch in stream order
                    nbytes = lib.gppe_matern_multirho_mma_scratch_bytes(
                        n, d, B, r, _DOT_CODES[dot_mode])
                    scratch = torch.empty(nbytes, dtype=torch.uint8,
                                          device=points.device)
                    err = lib.gppe_matern_multirho_mma(
                        points.data_ptr(), inv_rho.data_ptr(), V.data_ptr(),
                        out.data_ptr(), scratch.data_ptr() if nbytes else None,
                        n, d, B, r, code, _DOT_CODES[dot_mode], stream)
                else:
                    err = lib.gppe_matern_multirho(
                        points.data_ptr(), inv_rho.data_ptr(),
                        partials.data_ptr(), n, d, B, code, per_block,
                        blocks, stream)
                _raise_on_cuda_error(lib, err, counter)
                launch_counts[counter] += 1
    return (out, partials.sum(dim=1)) if return_frobenius else out


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


class BlocksparseTraceWalk(NamedTuple):
    """The walk of a tapered trace kernel over a pair list: ``units``
    (U, 2) int32, the first row and the first column of each pair of
    sub-tiles, of at most ``unit_rows`` rows and ``_TRACE_TILE`` columns
    (numpy, or a tensor on the points' device); ``weights`` (U,) the count
    of each unit's pairs (the kernel derives them the same way).
    ``unit_rows`` ``_TRACE_TILE``: the closed-form kernel's walk
    (``csrc/matern_blocksparse.cu``, :func:`blocksparse_trace_schedule`);
    ``_TILE_ROWS``: the general-nu kernel's
    (``csrc/matern_blocksparse_general.cu``,
    :func:`blocksparse_general_trace_schedule`)."""
    units: object
    weights: np.ndarray
    symmetric: bool
    unit_rows: int = _TRACE_TILE


def blocksparse_sub_tile_points(starts, tile, n, size=_TRACE_TILE):
    """The real points of the sub-tiles that start at ``starts`` (numpy):
    at most ``size``, none past the end of their tile of ``tile`` points or
    past ``n`` (``matern_trace.cuh::sub_tile_points``)."""
    starts = np.asarray(starts, dtype=np.int64)
    return np.minimum(size,
                      np.minimum((starts // tile + 1) * tile, n) - starts)


def blocksparse_trace_schedule(pair_i, pair_j, tile, n, symmetric=True):
    """The tapered trace kernel's walk over the tile-pair list ``pair_i``,
    ``pair_j`` (tiles of ``tile`` points, the first ``n`` real), as a
    :class:`BlocksparseTraceWalk`, on the host.

    Each tile holds ceil(real points / 128) sub-tiles, the last perhaps
    short. The symmetric walk takes the list's pairs ti <= tj and, on a
    diagonal tile pair, the sub-tiles sj >= si, each unit off the
    sub-diagonal at weight 2: every ordered pair of points of the list once.
    It needs the list to hold (j, i) with every (i, j), as the operator's
    does, and is taken where ``symmetric`` and the list is mirrored; else
    every sub-tile pair of the list is walked at weight 1. Units come in
    the list's order, sub-tile pairs row-major within a tile pair."""
    pair_i = np.asarray(pair_i, dtype=np.int64)
    pair_j = np.asarray(pair_j, dtype=np.int64)
    num_tiles = -(-n // tile)
    symmetric = symmetric and _mirrored(pair_i, pair_j, num_tiles)
    if symmetric:
        upper = pair_i <= pair_j
        pair_i, pair_j = pair_i[upper], pair_j[upper]
    starts = tile * np.arange(num_tiles)
    subs = -(-np.minimum(tile, n - starts) // _TRACE_TILE)
    side = -(-tile // _TRACE_TILE)
    si, sj = np.divmod(np.arange(side * side), side)
    take = ((si[None] < subs[pair_i][:, None])
            & (sj[None] < subs[pair_j][:, None]))
    if symmetric:
        take &= (pair_i != pair_j)[:, None] | (sj >= si)[None]
    rows = (pair_i[:, None] * tile + si[None] * _TRACE_TILE)[take]
    cols = (pair_j[:, None] * tile + sj[None] * _TRACE_TILE)[take]
    return BlocksparseTraceWalk(
        np.stack([rows, cols], axis=1).astype(np.int32),
        np.where(symmetric & (rows != cols), 2, 1), bool(symmetric))


def _mirrored(pair_i, pair_j, num_tiles):
    """Whether the list holds (j, i) with every (i, j)."""
    return np.array_equal(np.sort(pair_i * num_tiles + pair_j),
                          np.sort(pair_j * num_tiles + pair_i))


def blocksparse_general_trace_schedule(pair_i, pair_j, tile, n,
                                       symmetric=True):
    """The tapered general-nu trace kernel's walk
    (``csrc/matern_blocksparse_general.cu``) over the tile-pair list
    ``pair_i``, ``pair_j`` (tiles of ``tile`` points, the first ``n``
    real), as a :class:`BlocksparseTraceWalk` of ``unit_rows`` =
    ``_TILE_ROWS``, on the host: units of the product's sub-tile pairs,
    ``_TILE_ROWS`` rows of a row tile by ``_TRACE_TILE`` columns of a
    column tile (the last of each tile perhaps short), row-major within a
    tile pair, in the list's order.

    Where ``symmetric`` and the list holds its mirror, the walk takes the
    tile pairs ti <= tj and, of a diagonal tile pair, only the units with
    a column past a row; the kernel counts only the pairs of a unit whose
    column is past its row (above K's diagonal), each at weight 2, and the
    caller adds the diagonal's n ones (K[i, i] = 1): every unordered pair
    of points of the list once. Else every unit of the list, each of its
    pairs at weight 1."""
    pair_i = np.asarray(pair_i, dtype=np.int64)
    pair_j = np.asarray(pair_j, dtype=np.int64)
    num_tiles = -(-n // tile)
    symmetric = symmetric and _mirrored(pair_i, pair_j, num_tiles)
    if symmetric:
        upper = pair_i <= pair_j
        pair_i, pair_j = pair_i[upper], pair_j[upper]
    real = np.minimum(tile, n - tile * np.arange(num_tiles))
    row_subs, col_subs = -(-real // _TILE_ROWS), -(-real // _TRACE_TILE)
    side_r, side_c = -(-tile // _TILE_ROWS), -(-tile // _TRACE_TILE)
    si, sj = np.divmod(np.arange(side_r * side_c), side_c)
    take = ((si[None] < row_subs[pair_i][:, None])
            & (sj[None] < col_subs[pair_j][:, None]))
    rows = pair_i[:, None] * tile + si[None] * _TILE_ROWS
    cols = pair_j[:, None] * tile + sj[None] * _TRACE_TILE
    if symmetric:
        # the unit's last column past its first row
        last = cols + blocksparse_sub_tile_points(cols, tile, n) - 1
        take &= last > rows
    rows, cols = rows[take], cols[take]
    return BlocksparseTraceWalk(
        np.stack([rows, cols], axis=1).astype(np.int32),
        np.full(len(rows), 2 if symmetric else 1), bool(symmetric),
        _TILE_ROWS)


def blocksparse_trace_schedule_for(nu):
    """The schedule of the tapered trace kernel that ``nu`` runs:
    :func:`blocksparse_general_trace_schedule` for a general nu, else
    :func:`blocksparse_trace_schedule`."""
    return (blocksparse_trace_schedule if kernels.is_closed_form(nu)
            else blocksparse_general_trace_schedule)


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


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
        pair_i = _host(pair_i)
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
                                    row_ptr=None, dot_mode=None,
                                    _product=None):
    """Plain PyTorch tapered K @ V, one row tile at a time against that
    tile's active column tiles, in the inputs' dtype; the hard taper
    ``k >= tau ? k : 0`` is taken in that dtype too, on the unrounded k,
    and the product is :func:`tile_dot_plain` at ``dot_mode``, or
    ``_product`` as in :func:`matern_matmat_multirho_plain`. Arguments as
    :func:`matern_matmat_blocksparse`."""
    setup()
    dot_mode = resolve_dot_mode(dot_mode)
    if _product is None:
        _product = lambda K, W: tile_dot_plain(K, W, dot_mode)  # noqa: E731
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
            out[rows] = _product(Kblk, V[cols])
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
                              row_ptr=None, trace_walk=None):
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
    are zero. ``dot_mode`` as in :func:`matern_matmat`. ``trace_walk``:
    the trace kernel's :class:`BlocksparseTraceWalk` of this pair list,
    its units an int32 tensor on the points' device: of
    :func:`blocksparse_trace_schedule_for` ``nu`` (its ``unit_rows`` is
    checked); when absent (and ``frobenius``) it is built here on the
    host, symmetric where the list holds its mirror (a caller
    that asks for traces often passes it, and answers for it). The plain
    version sums the full list and takes no walk.

    Returns out (n_pad, r), and with ``frobenius=True`` the pair (out, sum
    of squared tapered entries = trace(K^2)), out None when V is None; the
    sum is a 0-d tensor, float64 on the CUDA path.

    CPU tensors take :func:`matern_matmat_blocksparse_plain`; CUDA tensors
    must be float32 and contiguous and launch float32 kernels: for a
    closed-form nu the product the tensor-core kernel
    (``csrc/matern_blocksparse_mma.cu``) in every mode, 'highest' as 3xTF32
    with the taper on the IEEE float32 k, the trace the FP32 kernel
    (``csrc/matern_blocksparse.cu``, over ``trace_walk``, with the same k
    and taper), so a call that asks for both launches both; for a general
    nu both entries of ``csrc/matern_blocksparse_general.cu`` the same way
    (the product one launch per 32 columns of V, in float32 FMA sums, each
    pair past :func:`blocksparse_skip_radius` an exact 0 without its k, in
    the trace too, whose symmetric walk sums the pairs above the diagonal
    twice and adds the diagonal's n ones here; ``dot_mode`` does not
    apply)."""
    dot_mode = resolve_dot_mode(dot_mode)
    nu = check_nu(nu)
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
            row_ptr, dot_mode)
    if device.type != "cuda":
        raise ValueError(f"matern_matmat_blocksparse runs on cpu or cuda, "
                         f"not {device}")
    return _matern_matmat_blocksparse_cuda(
        points_sorted, V, nu, tau, pair_i, pair_j, tile, n, frobenius,
        row_ptr, dot_mode, trace_walk)


def _trace_units(walk, device):
    """The walk's units as the kernel takes them: a contiguous (U, 2)
    int32 tensor on ``device``, 8-byte aligned (one int2 load a unit)."""
    units = walk.units
    if not torch.is_tensor(units):
        units = torch.as_tensor(units, device=device)
    if (units.dtype != torch.int32 or units.device != device
            or not units.is_contiguous() or units.ndim != 2
            or units.shape[1] != 2 or units.data_ptr() % 8
            or units.shape[0] >= 2 ** 31):
        raise ValueError(f"trace_walk.units must be a contiguous, aligned "
                         f"(U, 2) int32 tensor on {device}")
    return units


def _matern_matmat_blocksparse_cuda(points_sorted, V, nu, tau, pair_i,
                                    pair_j, tile, n, frobenius, row_ptr,
                                    dot_mode, trace_walk=None):
    from . import _build

    n_pad, d = points_sorted.shape
    device = points_sorted.device
    _check_cuda_operands(d, (("points_sorted", points_sorted), ("V", V)))
    tile, n, num_tiles, row_ptr, pair_j = _blocksparse_geometry(
        points_sorted, pair_i, pair_j, tile, n, row_ptr)
    r = 0 if V is None else V.shape[1]
    for name, t, size in (("row_ptr", row_ptr, num_tiles + 1),
                          ("pair_j", pair_j, pair_j.numel())):
        if (t.dtype != torch.int32 or t.device != device
                or not t.is_contiguous() or t.shape != (size,)):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"{size} entries on {device}")
    # every product of sizes that becomes an offset in the kernel
    if n_pad >= 2 ** 31 or n_pad * max(r, d, 1) >= 2 ** 63:
        raise ValueError("sizes must fit in int32, offsets in int64")

    out = None if V is None else torch.empty(
        (n_pad, r), dtype=torch.float32, device=device)
    general = not kernels.is_closed_form(nu)
    if frobenius:
        unit_rows = _TILE_ROWS if general else _TRACE_TILE
        if trace_walk is None:
            # an unprepared walk: built here, on the host
            trace_walk = blocksparse_trace_schedule_for(nu)(
                _host(pair_i), _host(pair_j), tile, n)
        if trace_walk.unit_rows != unit_rows:
            raise ValueError(f"trace_walk has units of "
                             f"{trace_walk.unit_rows} rows; this nu's "
                             f"trace kernel takes {unit_rows}")
        units = _trace_units(trace_walk, device)
        per_block, blocks = trace_blocks(units.shape[0])
        partials = torch.zeros(blocks, dtype=torch.float64, device=device)
    if r > 0 or frobenius:
        if general:
            lib, kernel = _general_library(), "blocksparse_general"
            consts = _general_consts(nu).ctypes.data
            skip2 = _blocksparse_skip2(nu, float(tau))
        else:
            lib, kernel = _build.load(), "blocksparse"
            code = _NU_CODES.get(nu, _GAUSS_CODE)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            c0 = 0
            for entry, counter in _launch_plan(kernel, r, frobenius):
                if entry == "gppe_matern_blocksparse_mma":
                    err = lib.gppe_matern_blocksparse_mma(
                        points_sorted.data_ptr(), V.data_ptr(),
                        out.data_ptr(), row_ptr.data_ptr(),
                        pair_j.data_ptr(), n, d, r, tile, num_tiles,
                        float(tau), code, _DOT_CODES[dot_mode], stream)
                elif entry == "gppe_matern_blocksparse":
                    err = lib.gppe_matern_blocksparse(
                        points_sorted.data_ptr(), units.data_ptr(),
                        partials.data_ptr(), n, d, tile, units.shape[0],
                        int(trace_walk.symmetric), float(tau), code,
                        per_block, blocks, stream)
                elif entry == "gppe_matern_blocksparse_general_product":
                    width = min(_GENERAL_MAX_COLS, r - c0)
                    err = lib.gppe_matern_blocksparse_general_product(
                        points_sorted.data_ptr(), V.data_ptr() + 4 * c0,
                        out.data_ptr() + 4 * c0, row_ptr.data_ptr(),
                        pair_j.data_ptr(), n, d, width, r, r, tile,
                        num_tiles, float(tau), skip2, consts, stream)
                    c0 += width
                else:
                    err = lib.gppe_matern_blocksparse_general_trace(
                        points_sorted.data_ptr(), units.data_ptr(),
                        partials.data_ptr(), n, d, tile, units.shape[0],
                        int(trace_walk.symmetric), float(tau), skip2,
                        per_block, blocks, consts, stream)
                _raise_on_cuda_error(lib, err, counter)
                launch_counts[counter] += 1
    if not frobenius:
        return out
    fro = partials.sum()
    # the general-nu kernel's symmetric walk: the diagonal's ones
    return out, (fro + n if general and trace_walk.symmetric else fro)


@functools.lru_cache(maxsize=256)
def blocksparse_skip_radius(nu, tau):
    """The scaled distance past which the tapered general-nu product
    (``csrc/matern_blocksparse_general.cu``) skips a pair, in float64.

    The kernel keeps k >= tau, k its float32 k and tau rounded to float32;
    its k lies within :data:`GENERAL_K_ATOL` of float64 k (chip_smoke.py
    phase 21). So a pair whose float64 k is below float32(tau) -
    GENERAL_K_ATOL is dropped by that rule, and past the radius x* where
    float64 k falls to that level (k decreases with x) every pair is. The
    radius returned is x* (1 + 1e-6): the float32 sqrt of the kernel's
    float32 squared distance rounds by 6e-8 at most, so a pair the kernel
    finds past it is past x*. ``inf`` where float32(tau) <= GENERAL_K_ATOL
    (no pair is skipped). Slightly beyond the taper radius, whose k is tau
    itself."""
    target = float(np.float32(tau)) - GENERAL_K_ATOL
    if not target > 0.0:
        return math.inf
    nu = check_nu(nu)

    def k(x):
        return kernels.matern(torch.as_tensor(x, dtype=torch.float64),
                              nu).numpy()

    hi = 1.0
    while k(hi) >= target:
        hi *= 2.0
    lo = 0.0
    for _ in range(4):          # each round narrows the bracket 1024 times
        x = np.linspace(lo, hi, 1025)
        first = int(np.argmax(k(x) < target))   # k(x[0]) >= target
        lo, hi = x[first - 1], x[first]
    return float(hi) * (1.0 + 1e-6)


def _blocksparse_skip2(nu, tau):
    """The kernel's ``skip2``: the skip radius squared, rounded up to
    float32 (a pair skipped by d2 > skip2 is past the radius)."""
    radius = blocksparse_skip_radius(nu, tau)
    if math.isinf(radius):
        return math.inf
    skip2 = np.float32(radius * radius)
    if float(skip2) < radius * radius:
        skip2 = np.nextafter(skip2, np.float32(np.inf))
    return float(skip2)


# -- general nu ---------------------------------------------------------------

def check_nu(nu):
    """``nu`` as a float; raises unless it is a positive number (the Matern
    class is defined for nu > 0)."""
    try:
        nu = float(nu)
    except (TypeError, ValueError):
        raise ValueError(f"nu must be a positive number, got {nu!r}") \
            from None
    if not nu > 0.0:
        raise ValueError(f"nu must be a positive number, got {nu!r}")
    return nu


# the layout of csrc/matern_bessel.cuh::MaternGeneralConsts
_TEMME_TERMS, _CF2_STEPS, _MAX_ORDER = 30, 59, 128
_GENERAL_CODE = 4
_CONSTS_DTYPE = np.dtype([
    ("mode", "<i4"), ("nl", "<i4"), ("scalars", "<f4", (11,)),
    ("temme", "<f4", (4, _TEMME_TERMS)), ("cf2", "<f4", (3, _CF2_STEPS)),
    ("rec_w", "<f4", (_MAX_ORDER,))])


@functools.lru_cache(maxsize=256)
def _general_consts(nu):
    """The per-launch constants of ``csrc/matern_general.cu`` for ``nu``,
    computed in float64 and stored as the kernel's float32 struct (a numpy
    record): the mode (a closed form's code, else general), round(nu),
    sqrt(2 nu), mu, Temme's constants and divisors, CF2's per-step
    constants and the normalized recurrence's weights."""
    c = np.zeros((), dtype=_CONSTS_DTYPE)
    closed = {0.5: 0, 1.5: 1, 2.5: 2}
    if nu in closed or nu >= kernels._GAUSSIAN_NU_CUTOFF:
        c["mode"] = closed.get(nu, _GAUSS_CODE)
        return c
    nl = math.floor(nu + 0.5)
    mu = nu - nl
    pimu = math.pi * mu
    fact = 1.0 if abs(pimu) < 1e-30 else pimu / math.sin(pimu)
    rg_plus = math.exp(-math.lgamma(1.0 + mu))
    rg_minus = math.exp(-math.lgamma(1.0 - mu))
    gam2 = 0.5 * (rg_minus + rg_plus)
    gam1 = (-0.57721566490153286 if abs(mu) < 1e-8
            else (rg_minus - rg_plus) / (2.0 * mu))
    a1 = 0.25 - mu * mu
    c["mode"], c["nl"] = _GENERAL_CODE, nl
    c["scalars"] = (
        math.sqrt(2.0 * nu), mu, a1, fact, gam1, gam2,
        0.5 * math.gamma(1.0 + mu), 0.5 * math.gamma(1.0 - mu),
        2.0 ** (1.0 - mu) / math.gamma(mu) if nl == 0 else 0.0,
        2.0 ** -mu / math.gamma(1.0 + mu),
        2.0 ** -mu / (2.0 * math.gamma(2.0 + mu)))
    i = np.arange(1, _TEMME_TERMS + 1, dtype=np.float64)
    c["temme"] = (1.0 / (i * i - mu * mu), 1.0 / (i - mu), 1.0 / (i + mu),
                  1.0 / i)
    i = np.arange(2, _CF2_STEPS + 2, dtype=np.float64)
    a = -a1 - i * (i - 1.0)
    c["cf2"] = (a, 1.0 / a, -a / i)
    v = mu + np.arange(2, _MAX_ORDER + 2, dtype=np.float64)
    c["rec_w"] = 1.0 / (4.0 * v * (v - 1.0))
    return c


def _general_library():
    """The kernel library, with the constants' layout checked against the
    compiled struct's size."""
    from . import _build

    lib = _build.load()
    size = lib.gppe_matern_general_consts_bytes()
    if size != _CONSTS_DTYPE.itemsize:
        raise RuntimeError(f"MaternGeneralConsts is {size} bytes in the "
                           f"library, {_CONSTS_DTYPE.itemsize} here")
    return lib


def matern_general(x, nu):
    """k(x; nu) elementwise over a tensor of scaled distances, for any
    positive nu (closed forms included: the kernel takes their branch).

    CPU tensors take the plain version :func:`kernels.matern` (the
    reference's log-space form over ``special.log_kv``, in the tensor's
    dtype); CUDA tensors must be float32 and contiguous and launch the
    elementwise entry of ``csrc/matern_general.cu``."""
    nu = check_nu(nu)
    device = x.device
    if device.type == "cpu":
        return kernels.matern(x, nu)
    if device.type != "cuda":
        raise ValueError(f"matern_general runs on cpu or cuda, not {device}")
    return _matern_general_cuda(x, nu)


def _matern_general_cuda(x, nu):
    _check_cuda_operands(1, (("x", x),))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _general_library()
    consts = _general_consts(nu)
    with torch.cuda.device(x.device):
        err = lib.gppe_matern_general_elementwise(
            x.data_ptr(), out.data_ptr(), x.numel(), consts.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_cuda_error(lib, err, "matern_general_elementwise")
    launch_counts["matern_general_elementwise"] += 1
    return out


class GeneralProductBands(NamedTuple):
    """The general-nu product's walk cut into bands (one launch each):
    ``pairs`` tile pairs of 128 x 128 points in all, ``band_pairs`` per
    band (the last perhaps fewer), ``bands`` of them, ``sides`` slots a
    pair (2 on the symmetric walk: the row side and the mirror), and
    ``slot_floats`` float32 entries of scratch they take."""
    pairs: int
    band_pairs: int
    bands: int
    sides: int
    slot_floats: int


def general_product_bands(nr, nc, r, batch, symmetric):
    """The bands of one launch width ``r`` <= 32 of the general-nu product
    (``csrc/matern_general.cu``): as many consecutive pairs of its walk as
    keep the slot scratch, ``batch * band_pairs * sides * 128 * r``
    floats, within :data:`GENERAL_SLOT_BYTES` (at least one pair)."""
    tiles_r, tiles_c = -(-nr // _TRACE_TILE), -(-nc // _TRACE_TILE)
    pairs = (tiles_r * (tiles_r + 1) // 2 if symmetric
             else tiles_r * tiles_c)
    sides = 2 if symmetric else 1
    per_pair = batch * sides * _TRACE_TILE * r
    band_pairs = max(1, min(pairs, GENERAL_SLOT_BYTES // (4 * per_pair),
                            2 ** 31 - 1))
    return GeneralProductBands(pairs, band_pairs, -(-pairs // band_pairs),
                               sides, band_pairs * per_pair)


@functools.lru_cache(maxsize=64)
def _general_consts_device(nus, device):
    """The constants of ``nus`` (a tuple), one struct per point, as one
    uint8 tensor on ``device``: the batched product's per-point table."""
    host = np.stack([_general_consts(nu) for nu in nus])
    return torch.from_numpy(host.view(np.uint8).copy()).to(device)


def _general_product_cuda(points, cols, scales, V, nus, symmetric):
    """out_b = K_b @ V_b on the card for (B, nc, r) float32 V, B = len(nus)
    points of (B, d) float32 ``scales``: the product entry of
    ``csrc/matern_general.cu`` once per band of its walk
    (:func:`general_product_bands`) and 32 columns, for the whole batch.
    Each call of the entry launches the tile kernel and its band's sum
    kernel, and counts once under ``matern_general_product``."""
    B, nc, r = V.shape
    nr, d = points.shape
    device = points.device
    if nr == 0 or nc == 0 or r == 0:
        return torch.zeros((B, nr, r), dtype=torch.float32, device=device)
    out = torch.empty((B, nr, r), dtype=torch.float32, device=device)
    lib = _general_library()
    consts = _general_consts_device(nus, device)
    walk = general_product_bands(nr, nc, min(r, _GENERAL_MAX_COLS), B,
                                 symmetric)
    slots = torch.empty(walk.slot_floats, dtype=torch.float32,
                        device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        c0 = 0
        for entry, counter in _launch_plan("general", r, False):
            width = min(_GENERAL_MAX_COLS, r - c0)
            for g0 in range(0, walk.pairs, walk.band_pairs):
                err = lib.gppe_matern_general_product(
                    points.data_ptr(), cols.data_ptr(), scales.data_ptr(),
                    consts.data_ptr(), V.data_ptr() + 4 * c0,
                    out.data_ptr() + 4 * c0, slots.data_ptr(), nr, nc, d,
                    width, r, r, nc * r, nr * r, B, int(symmetric), g0,
                    min(walk.band_pairs, walk.pairs - g0), walk.band_pairs,
                    stream)
                _raise_on_cuda_error(lib, err, counter)
                launch_counts[counter] += 1
            c0 += width
    return out


def matern_general_matmat(points, scale, V, nu, points_cols=None,
                          frobenius=False, block_rows=1024):
    """K @ V and (``frobenius``) sum K^2 for a Matern K of any positive nu,
    K never stored: :func:`matern_matmat`'s arguments and returns, without
    the dot and distance modes (the product is exact float32, the distance
    the difference form, as on the reference's XLA path).

    CPU tensors take :func:`matern_matmat_plain` ('highest', the inputs'
    dtype, ``block_rows`` rows at a time); CUDA tensors must be float32 and
    contiguous and launch ``csrc/matern_general.cu``: the product entry
    once per band and 32 columns of V (the batch of one of
    :func:`matern_general_matmat_batched`, the same bits), the trace entry
    for the sum (float64; the batch of one of
    :func:`matern_general_trace_batched`, the same bits)."""
    nu = check_nu(nu)
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
                                   frobenius, block_rows, "highest")
    if device.type != "cuda":
        raise ValueError(f"matern_general_matmat runs on cpu or cuda, not "
                         f"{device}")
    return _matern_general_matmat_cuda(points, scale, V, nu, points_cols,
                                       frobenius)


def _matern_general_matmat_cuda(points, scale, V, nu, points_cols,
                                frobenius):
    nr, d = points.shape
    cols = points if points_cols is None else points_cols
    if cols.ndim != 2 or cols.shape[1] != d:
        raise ValueError(f"points_cols must be (nc, {d}); "
                         f"got {tuple(cols.shape)}")
    nc = cols.shape[0]
    _check_cuda_operands(d, (("points", points), ("points_cols", cols),
                             ("V", V), ("scale", scale)))
    if V is not None and (V.ndim != 2 or V.shape[0] != nc):
        raise ValueError(f"V must be ({nc}, r); got {tuple(V.shape)}")
    if max(nr, nc) >= 2 ** 31:
        raise ValueError("sizes must fit in int32")
    symmetric = points_cols is None
    out = None if V is None else _general_product_cuda(
        points, cols, scale[None], V[None], (nu,), symmetric)[0]
    if not frobenius:
        return out
    return out, _general_trace_cuda(points, cols, scale[None], (nu,),
                                    symmetric)[0]


def general_trace_batches(nr, nc, batch, symmetric):
    """``(per_block, blocks, points)`` of the general-nu trace
    (``csrc/matern_general.cu``) over an nr x nc K for a batch of
    ``batch`` points: each point's blocks as the dense traces'
    (:func:`trace_schedule`), and ``points`` of the batch a launch, as
    many as keep their float64 partials, points * blocks of them, within
    ``_GENERAL_TRACE_PARTIALS`` (at least one)."""
    per_block, blocks = trace_schedule(nr, nc, symmetric)[3:]
    return per_block, blocks, max(1, min(batch, 65535,
                                         _GENERAL_TRACE_PARTIALS // blocks))


def _general_trace_cuda(points, cols, scales, nus, symmetric):
    """trace(K_b^2) (B,) float64 on the card for B = len(nus) points of
    (B, d) float32 ``scales``: the trace entry of ``csrc/matern_general.cu``
    once per launch's points of :func:`general_trace_batches`, counted
    once each under ``matern_general_trace``. Each call of the entry
    launches the tile kernel over its points and their sum kernel; each
    point runs on blocks of its own and its sum in a fixed order, so it
    has the same bits alone or in any batch."""
    B = len(nus)
    nr, d = points.shape
    nc = cols.shape[0]
    device = points.device
    out = torch.zeros(B, dtype=torch.float64, device=device)
    if nr == 0 or nc == 0:
        return out
    per_block, blocks, per_launch = general_trace_batches(nr, nc, B,
                                                          symmetric)
    partials = torch.empty(min(B, per_launch) * blocks, dtype=torch.float64,
                           device=device)
    lib = _general_library()
    consts = _general_consts_device(nus, device)
    size = _CONSTS_DTYPE.itemsize
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, B, per_launch):
            err = lib.gppe_matern_general_trace(
                points.data_ptr(), cols.data_ptr(),
                scales.data_ptr() + 4 * d * b0,
                consts.data_ptr() + size * b0, partials.data_ptr(),
                out.data_ptr() + 8 * b0, nr, nc, d, int(symmetric),
                per_block, blocks, min(per_launch, B - b0), stream)
            _raise_on_cuda_error(lib, err, "matern_general_trace")
            launch_counts["matern_general_trace"] += 1
    return out


def _general_batch(points, scales, nus):
    """The batched general-nu wrappers' points, scales and nus, checked:
    ``nus`` as a tuple of positive floats, ``scales`` as a (B, d) tensor
    in the points' dtype on their device (B scalars, or B rows of d
    per-dimension scales)."""
    nus = tuple(check_nu(nu) for nu in nus)
    if points.ndim != 2:
        raise ValueError(f"points must be (n, d); got {tuple(points.shape)}")
    B, d = len(nus), points.shape[1]
    scales = torch.as_tensor(scales, dtype=points.dtype, device=points.device)
    if scales.ndim == 1:
        scales = scales[:, None].expand(B, d)
    if scales.shape != (B, d):
        raise ValueError(f"scales must be ({B},) or ({B}, {d}); got "
                         f"{tuple(scales.shape)}")
    return nus, scales


def matern_general_matmat_batched(points, scales, V, nus, block_rows=1024):
    """K_b @ V_b for a batch of B Matern correlations over one set of
    points, K_b[i, j] = k(|x_i - x_j| / scale_b; nu_b), each nu positive
    (a closed form too), K never stored: the product of a matrix-free grid
    chunk.

    ``points`` (n, d); ``scales`` B scales, each a scalar or d per-dimension
    ones (a (B,) or (B, d) tensor on the points' device, or anything
    ``torch.as_tensor`` takes); ``V`` (B, n, r); ``nus`` B numbers.
    Returns (B, n, r).

    CPU tensors take :func:`matern_matmat_plain` point by point ('highest',
    the inputs' dtype, ``block_rows`` rows at a time); CUDA tensors must be
    float32 and contiguous and launch the product entry of
    ``csrc/matern_general.cu`` once per band and 32 columns of V for the
    whole batch, each point with the bits it has alone in
    :func:`matern_general_matmat`."""
    nus, scales = _general_batch(points, scales, nus)
    device = points.device
    n, d = points.shape
    B = len(nus)
    if V.device != device:
        raise ValueError(f"V is on {V.device}, points on {device}")
    if V.ndim != 3 or V.shape[:2] != (B, n):
        raise ValueError(f"V must be ({B}, {n}, r); got {tuple(V.shape)}")
    if device.type == "cpu":
        return torch.stack([
            matern_matmat_plain(points, scales[b], V[b], nu, None, False,
                                block_rows, "highest")
            for b, nu in enumerate(nus)])
    if device.type != "cuda":
        raise ValueError(f"matern_general_matmat_batched runs on cpu or "
                         f"cuda, not {device}")
    scales = scales.contiguous()
    _check_cuda_operands(d, (("points", points), ("V", V),
                             ("scales", scales)))
    if n >= 2 ** 31 or B > 65535:
        raise ValueError("n must fit in int32, the batch in 65535")
    return _general_product_cuda(points, points, scales, V, nus, True)


def matern_general_trace_batched(points, scales, nus, block_rows=1024):
    """trace(K_b^2) for a batch of B Matern correlations over one set of
    points, K_b[i, j] = k(|x_i - x_j| / scale_b; nu_b), each nu positive
    (a closed form too), K never stored: the traces of a matrix-free grid
    chunk. Arguments as :func:`matern_general_matmat_batched`; returns
    (B,).

    CPU tensors take :func:`matern_matmat_plain`'s sum point by point (the
    inputs' dtype, ``block_rows`` rows at a time); CUDA tensors must be
    float32 and contiguous and launch the trace entry of
    ``csrc/matern_general.cu`` once for the whole batch (for a batch whose
    partials pass ``_GENERAL_TRACE_PARTIALS``, once per
    :func:`general_trace_batches` points), float64, each point with the
    bits it has alone in :func:`matern_general_matmat`."""
    nus, scales = _general_batch(points, scales, nus)
    device = points.device
    n, d = points.shape
    if device.type == "cpu":
        return torch.stack([
            matern_matmat_plain(points, scales[b], None, nu, None, True,
                                block_rows, "highest")[1]
            for b, nu in enumerate(nus)])
    if device.type != "cuda":
        raise ValueError(f"matern_general_trace_batched runs on cpu or "
                         f"cuda, not {device}")
    scales = scales.contiguous()
    _check_cuda_operands(d, (("points", points), ("scales", scales)))
    if n >= 2 ** 31:
        raise ValueError("n must fit in int32")
    return _general_trace_cuda(points, points, scales, nus, True)
