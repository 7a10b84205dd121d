"""The ported tile-dot modes ('bf16x3', 'bf16') and the Gram distance form
vs the JAX reference, on the CPU.

Inputs come from numpy seeds and go through both packages. The port runs
its plain PyTorch versions (its wrappers take them for CPU tensors); the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
One thing the JAX side cannot show on the CPU: ``Precision.DEFAULT`` in
interpret mode is an exact float32 dot, so the reference's 'bf16' body does
not round here. The port's 'bf16' is therefore held tightly to a numpy
oracle that rounds with ``ml_dtypes.bfloat16``, and to the JAX body only
within the band the rounding must produce.
"""

import os
import re
from contextlib import nullcontext
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu.ops import pallas_kernels as jpk  # noqa: E402
from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch.models import grid_krylov as tgk  # noqa: E402
from gppe_tpu_torch.models import large_scale as tls  # noqa: E402
from gppe_tpu_torch.ops import _build, cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


F32, F64 = torch.float32, torch.float64
# what rounding both operands to bfloat16 must cost (the reference records
# 2.2e-3 on the chip): more than any float32 effect, less than 5e-3
BF16_BAND = (1e-4, 5e-3)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def frob(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def dense_k(rows, cols, scale, nu=0.5):
    d = np.sqrt((((rows[:, None, :] - cols[None, :, :]) / scale) ** 2).sum(-1))
    if nu == 0.5:
        return np.exp(-d)
    return (1 + np.sqrt(3) * d) * np.exp(-np.sqrt(3) * d)


def bf16(a):
    """Round to bfloat16 through float32, the path a float64 torch tensor
    takes, and come back to float64."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def problem(n=300, r=5, seed=4):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2).astype(np.float32)
    cols = rng.rand(n // 2 + 7, 2).astype(np.float32)
    V = rng.standard_normal((n, r)).astype(np.float32)
    Vc = rng.standard_normal((cols.shape[0], r)).astype(np.float32)
    return pts, cols, V, Vc, np.array([0.1, 0.17])


# -- bf16x3 -------------------------------------------------------------------

@pytest.mark.parametrize("rect", [False, True])
def test_bf16x3_plain_vs_pallas_interpret(rect):
    """float32 on both sides, ragged n = 300 over 128-wide tiles: the two
    split the same operands the same way, so they agree like two float32
    sums do. 2e-5 is the exact mode's bound."""
    pts, cols, V, Vc, scale = problem()
    Vr = Vc if rect else V
    want = jpk.matern_matmat(pts, scale, Vr, 0.5, tile_m=128, tile_n=128,
                             points_cols=cols if rect else None,
                             dot_mode="bf16x3", interpret=True)
    got = cuda_kernels.matern_matmat(
        _t(pts, F32), scale, _t(Vr, F32), 0.5,
        points_cols=_t(cols, F32) if rect else None, dot_mode="bf16x3")
    assert got.dtype == F32
    assert frob(got.numpy(), want) < 2e-5


def test_bf16x3_oracle_and_accuracy():
    """float64 against a numpy oracle that splits with ml_dtypes (1e-6:
    only summation order differs), and the mode's cost against the exact
    product: a few 1e-6, the reference's 4.7e-6."""
    pts, _, V, _, scale = problem()
    K = dense_k(pts.astype(np.float64), pts.astype(np.float64), scale)
    V64 = V.astype(np.float64)
    k_hi, v_hi = bf16(K), bf16(V64)
    k_lo, v_lo = bf16(K - k_hi), bf16(V64 - v_hi)
    oracle = k_hi @ v_hi + k_lo @ v_hi + k_hi @ v_lo
    got = cuda_kernels.matern_matmat(_t(pts), scale, _t(V), 0.5,
                                     dot_mode="bf16x3").numpy()
    assert frob(got, oracle) < 1e-6
    assert 1e-7 < frob(got, K @ V64) < 2e-5


def test_bf16x3_symmetry():
    """tests/test_kernels.py::test_bf16x3_symmetry on the port: 'highest'
    is symmetric to float32 roundoff; 'bf16x3' rounds v, so u.(Kv) and
    v.(Ku) differ, by less than 1e-4, and it stays that close to exact."""
    rng = np.random.RandomState(9)
    pts = _t(rng.rand(128, 2), F32)
    u = _t(rng.standard_normal((128, 1)), F32)
    v = _t(rng.standard_normal((128, 1)), F32)

    def pairing(dot_mode):
        Ku = cuda_kernels.matern_matmat(pts, 0.1, u, 0.5, dot_mode=dot_mode)
        Kv = cuda_kernels.matern_matmat(pts, 0.1, v, 0.5, dot_mode=dot_mode)
        return float(torch.vdot(u[:, 0], Kv[:, 0])), float(
            torch.vdot(v[:, 0], Ku[:, 0]))

    a, b = pairing("highest")
    scale = max(abs(a), 1.0)
    assert abs(a - b) / scale < 1e-6
    a3, b3 = pairing("bf16x3")
    assert abs(a3 - b3) / scale < 1e-4
    assert abs(a3 - a) / scale < 1e-4


# -- bf16 ---------------------------------------------------------------------

@pytest.mark.parametrize("rect", [False, True])
def test_bf16_plain_vs_numpy_oracle(rect):
    pts, cols, V, Vc, scale = problem(seed=5)
    c = cols if rect else pts
    Vr = (Vc if rect else V).astype(np.float64)
    K = dense_k(pts.astype(np.float64), c.astype(np.float64), scale)
    oracle = bf16(K) @ bf16(Vr)
    got = cuda_kernels.matern_matmat(
        _t(pts), scale, _t(Vr), 0.5, points_cols=_t(c) if rect else None,
        dot_mode="bf16", block_rows=97).numpy()
    assert frob(got, oracle) < 1e-6
    assert BF16_BAND[0] < frob(got, K @ Vr) < BF16_BAND[1]


def test_bf16_plain_vs_pallas_interpret_band():
    """The JAX body computes an exact float32 dot on the CPU; the port
    rounds. The gap between them is the rounding: inside the band."""
    pts, _, V, _, scale = problem(seed=6)
    jax_body = jpk.matern_matmat(pts, scale, V, 0.5, tile_m=128, tile_n=128,
                                 dot_mode="bf16", interpret=True)
    got = cuda_kernels.matern_matmat(_t(pts, F32), scale, _t(V, F32), 0.5,
                                     dot_mode="bf16").numpy()
    assert BF16_BAND[0] < frob(got, jax_body) < BF16_BAND[1]


def test_tile_dot_plain_rounds_whatever_the_dtype():
    rng = np.random.RandomState(1)
    K, V = rng.rand(40, 30), rng.standard_normal((30, 3))
    for dtype in (F32, F64):
        Kt, Vt = _t(K, dtype), _t(V, dtype)
        exact = cuda_kernels.tile_dot_plain(Kt, Vt, "highest")
        assert torch.equal(exact, Kt @ Vt)
        got = cuda_kernels.tile_dot_plain(Kt, Vt, "bf16")
        assert got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), bf16(K) @ bf16(V), rtol=1e-5)
        assert BF16_BAND[0] < frob(got.numpy(), K @ V) < BF16_BAND[1]
        x3 = cuda_kernels.tile_dot_plain(Kt, Vt, "bf16x3")
        assert frob(x3.numpy(), K @ V) < 2e-5
        assert not torch.equal(x3, exact)


# -- the Gram form ------------------------------------------------------------

@pytest.mark.parametrize("rect", [False, True])
def test_gram_vs_pallas_interpret_and_dense(rect):
    """tests/test_kernels.py::test_gram_dist_mode_accuracy, on both
    packages in float32: each within the reference's envelope of float64
    dense (1e-3 Frobenius, 2e-2 max-abs), and within 1e-3 of each other."""
    rng = np.random.RandomState(5)
    pts = rng.rand(640, 2).astype(np.float32)
    cols = rng.rand(333, 2).astype(np.float32) if rect else pts
    V = rng.standard_normal((cols.shape[0], 4)).astype(np.float32)
    want = dense_k(pts.astype(np.float64), cols.astype(np.float64),
                   0.1) @ V.astype(np.float64)
    jax_gram = np.asarray(jpk.matern_matmat(
        pts, 0.1, V, 0.5, points_cols=cols if rect else None,
        dist_mode="gram", interpret=True))
    got = cuda_kernels.matern_matmat(
        _t(pts, F32), 0.1, _t(V, F32), 0.5,
        points_cols=_t(cols, F32) if rect else None,
        dist_mode="gram").numpy()
    for out in (got, jax_gram):
        assert frob(out, want) < 1e-3
        assert np.max(np.abs(out - want)) < 2e-2
    assert frob(got, jax_gram) < 1e-3


def test_gram_float64_matches_diff_and_takes_modes():
    pts, cols, _, Vc, scale = problem(seed=7)
    args = (_t(pts), scale, _t(Vc), 1.5)
    want = cuda_kernels.matern_matmat(*args, points_cols=_t(cols))
    got = cuda_kernels.matern_matmat(*args, points_cols=_t(cols),
                                     dist_mode="gram")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    x3 = cuda_kernels.matern_matmat(*args, points_cols=_t(cols),
                                    dist_mode="gram", dot_mode="bf16x3")
    assert 1e-7 < frob(x3.numpy(), want.numpy()) < 2e-5


def test_gram_centres_on_the_column_mean():
    """The operands are centred on the mean of the scaled COLUMN points,
    and that is what keeps float32 usable: points far from the origin
    (offset 50 scaled units) stay inside the envelope."""
    rng = np.random.RandomState(8)
    rows, cols = _t(rng.rand(50, 2), F32), _t(rng.rand(31, 2) + 3.0, F32)
    rows_c, cols_c, rows_norm, cols_norm = cuda_kernels._gram_operands(
        rows, cols)
    centre = cols.mean(dim=0)
    assert torch.allclose(cols_c.mean(dim=0), torch.zeros(2), atol=1e-6)
    assert torch.allclose(rows_c, rows - centre, atol=1e-6)
    assert torch.allclose(cols_norm, (cols_c ** 2).sum(1))
    assert torch.allclose(rows_norm, (rows_c ** 2).sum(1))

    pts = rng.rand(400, 2).astype(np.float32)
    V = rng.standard_normal((400, 3)).astype(np.float32)
    want = dense_k(pts.astype(np.float64), pts.astype(np.float64),
                   0.1) @ V.astype(np.float64)
    moved = cuda_kernels.matern_matmat(_t(pts + 5.0, F32), 0.1, _t(V, F32),
                                       0.5, dist_mode="gram").numpy()
    assert frob(moved, want) < 1e-3


# -- the modes in the multi-rho and the block-sparse products -----------------

@pytest.mark.parametrize("dot_mode", ["bf16x3", "bf16"])
def test_multirho_modes_vs_pallas_interpret(dot_mode):
    rng = np.random.RandomState(3)
    n = 300
    pts = rng.rand(n, 2)
    rhos = np.asarray([0.07, 0.15])
    V = rng.standard_normal((2, n, 3)).astype(np.float32)
    want, want_tk2 = jpk.matern_matmat_multirho(
        pts, rhos, V, 0.5, tile=128, dot_mode=dot_mode, interpret=True,
        return_frobenius=True)
    got, tk2 = cuda_kernels.matern_matmat_multirho(
        _t(pts, F32), _t(rhos, F32), _t(V, F32), 0.5, dot_mode=dot_mode,
        return_frobenius=True, block_rows=128)
    err = frob(got.numpy(), want)
    if dot_mode == "bf16x3":
        assert err < 2e-5
    else:       # the JAX body does not round on the CPU
        assert BF16_BAND[0] < err < BF16_BAND[1]
    # the traces never go through the tile dot
    exact = cuda_kernels.matern_matmat_multirho(
        _t(pts, F32), _t(rhos, F32), None, 0.5, return_frobenius=True,
        block_rows=128)[1]
    assert torch.equal(tk2, exact)
    np.testing.assert_allclose(tk2.numpy(), np.asarray(want_tk2), rtol=1e-5)


@pytest.mark.parametrize("dot_mode", ["bf16x3", "bf16"])
def test_blocksparse_modes_vs_pallas_interpret(dot_mode):
    """The geometry of tests/test_torch_taper.py (this seed has no pair
    within 1e-5 of the threshold), float32 on both sides."""
    rng = np.random.RandomState(11)
    n = 600
    pts = rng.rand(n, 2)
    jop = jtaper.TaperedMaternOperator(pts, 0.05, nu=0.5, density=0.02,
                                       tile=128, use_pallas=False)
    V = np.asarray(rng.standard_normal((n, 3)), np.float32)
    Vs = np.concatenate(
        [V[jop.perm], np.zeros((jop.n_pad - n, 3), np.float32)], axis=0)
    want = np.asarray(jpk.matern_matmat_blocksparse(
        jop.points_sorted, Vs, jop.nu, jop.threshold, jop.pair_i,
        jop.pair_j, jop.tile, dot_mode=dot_mode, interpret=True))
    pts_sorted = _t(np.array(jop.points_sorted), F32)
    geometry = (0.5, jop.threshold, jop.pair_i, jop.pair_j, jop.tile)
    got, fro = cuda_kernels.matern_matmat_blocksparse(
        pts_sorted, _t(Vs, F32), *geometry, n=n, dot_mode=dot_mode,
        frobenius=True)
    err = frob(got.numpy()[:n], want[:n])
    if dot_mode == "bf16x3":
        assert err < 2e-5
    else:
        assert BF16_BAND[0] < err < BF16_BAND[1]
    assert not got.numpy()[n:].any()
    exact = cuda_kernels.matern_matmat_blocksparse(
        pts_sorted, None, *geometry, n=n, frobenius=True)[1]
    assert torch.equal(fro, exact)


# -- which kernel a call launches on the card ---------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gppe_tpu_torch", "csrc")


@pytest.mark.parametrize("kernel", ["multirho", "blocksparse", "matmat"])
@pytest.mark.parametrize("dot_mode", cuda_kernels.DOT_MODES)
@pytest.mark.parametrize("r, frobenius", [(0, True), (1, False), (1, True),
                                          (16, False), (24, True),
                                          (40, False)])
def test_launch_plan_routes_modes_to_kernels(kernel, dot_mode, r, frobenius):
    """The routing table of the three wrappers on the card, the same for
    all three: in every mode the product is one launch of the tensor-core
    kernel ('highest' as 3xTF32), counted under its own name, which takes
    the mode's code; it sums no k^2 (they are never rounded), so the sums
    are a trace-only launch of the FP32 kernel, and so is a call without
    V. No mode reaches an FP32-FMA product: the FP32 sources hold only
    their trace kernels."""
    if kernel == "matmat":
        trace = ("gppe_matern_matmat", "matern_matmat")
    else:
        trace = (f"gppe_matern_{kernel}", f"matern_matmat_{kernel}")
    mma = (f"{trace[0]}_mma", f"{trace[1]}_mma")
    plan = cuda_kernels._launch_plan(kernel, r, frobenius)
    assert plan == ([mma] if r else []) + ([trace] if frobenius else [])
    for entry, counter in plan:
        assert counter in cuda_kernels.launch_counts
        source = f"matern_{kernel}_mma.cu" if entry.endswith("_mma") \
            else f"matern_{kernel}.cu"
        assert source in _build.SOURCES
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        entry_args = text[text.index(f'extern "C" int {entry}('):]
        entry_args = entry_args[:entry_args.index(")")]
        if entry.endswith("_mma"):
            # the tensor-core entry takes the mode's code and accepts it
            assert "dot_code" in entry_args
            assert re.search(
                rf"dot_code [!=]= {_MODE_CONSTANTS[dot_mode]}\b", text)
        else:
            # the FP32 entry takes neither V nor a width nor a mode
            assert "V" not in entry_args.split(",")
            assert "int r" not in entry_args and "dot_code" not in entry_args


# cuda_kernels._DOT_CODES, by their names in csrc/matern_common.cuh
_MODE_CONSTANTS = {"highest": "kDotHighest", "bf16x3": "kDotBf16x3",
                   "bf16": "kDotBf16"}


def test_dot_codes_match_the_sources():
    with open(os.path.join(CSRC, "matern_common.cuh")) as f:
        text = f.read()
    for mode, name in _MODE_CONSTANTS.items():
        assert f"constexpr int {name} = {cuda_kernels._DOT_CODES[mode]};" \
            in text


class _FakeLibrary:
    """Stands in for the kernel library: records each C entry called, with
    the arguments the routing decides (norm pointers, V, widths, codes)."""

    def __init__(self):
        self.calls = []

    def gppe_matern_matmat_mma_scratch_bytes(self, nc, d, r, dot_code,
                                             gram):
        return 16 * nc

    def gppe_matern_matmat_mma(self, rows, cols, rows_norm, cols_norm, V,
                               out, scratch, nr, nc, d, r, nu_code, dot_code,
                               stream):
        self.calls.append(("gppe_matern_matmat_mma", rows_norm is not None,
                           cols_norm is not None, r, dot_code))
        return 0

    def gppe_matern_matmat(self, rows, cols, rows_norm, cols_norm, partials,
                           nr, nc, d, nu_code, symmetric, per_block, blocks,
                           stream):
        # the symmetric walk exactly where the rows are the columns in the
        # difference form, over the blocks of the mirrored schedule
        assert symmetric == int(rows == cols and rows_norm is None)
        assert (per_block, blocks) == cuda_kernels.trace_schedule(
            nr, nc, symmetric)[3:]
        self.calls.append(("gppe_matern_matmat", rows_norm is not None,
                           cols_norm is not None, 0, None))
        return 0

    def gppe_matern_multirho_mma_scratch_bytes(self, n, d, B, r, dot_code):
        return 16 * n * B if dot_code == 0 else 0

    def gppe_matern_multirho_mma(self, pts, inv_rho, V, out, scratch, n, d,
                                 B, r, nu_code, dot_code, stream):
        # 'highest' alone takes scratch
        assert (scratch is not None) == (dot_code == 0)
        self.calls.append(("gppe_matern_multirho_mma", B, r, dot_code))
        return 0

    def gppe_matern_multirho(self, pts, inv_rho, partials, n, d, B, nu_code,
                             per_block, blocks, stream):
        assert (per_block, blocks) == cuda_kernels.trace_schedule(
            n, n, True)[3:]
        self.calls.append(("gppe_matern_multirho", B, 0, None))
        return 0

    def gppe_matern_blocksparse_mma(self, pts, V, out, row_ptr, col_tiles,
                                    n, d, r, tile, num_tiles, tau, nu_code,
                                    dot_code, stream):
        self.calls.append(("gppe_matern_blocksparse_mma", num_tiles, r,
                           dot_code))
        return 0

    def gppe_matern_blocksparse(self, pts, units, partials, n, d, tile,
                                num_units, symmetric, tau, nu_code,
                                per_block, blocks, stream):
        # the symmetric walk of a mirrored list, over the blocks its units
        # need
        assert symmetric == 1
        assert (per_block, blocks) == cuda_kernels.trace_blocks(num_units)
        self.calls.append(("gppe_matern_blocksparse", num_units, 0, None))
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    """The card path of the wrappers, driven on CPU tensors against a
    stand-in library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    cuda_kernels.reset_launch_counts()
    return lib


@pytest.mark.parametrize("dot_mode", cuda_kernels.DOT_MODES)
@pytest.mark.parametrize("dist_mode", cuda_kernels.DIST_MODES)
@pytest.mark.parametrize("r", [0, 24])
@pytest.mark.parametrize("frobenius", [False, True])
def test_matmat_wrapper_launches_what_the_plan_says(
        dot_mode, dist_mode, r, frobenius, fake_library):
    """The card path of matern_matmat, driven on CPU tensors against a
    stand-in library: every product goes to matern_matmat_mma with the
    mode's code, in both distance forms; every sum of k^2 is a second,
    trace-only launch of matern_matmat; the Gram form hands both kernels
    the norms; each launch adds one to its own counter and to no other."""
    lib = fake_library
    rng = np.random.RandomState(r)
    pts = _t(rng.rand(40, 2), F32)
    V = _t(rng.standard_normal((40, r)), F32) if r else None
    out = cuda_kernels._matern_matmat_cuda(
        pts, _t([0.1, 0.1], F32), V, 0.5, None, frobenius, dot_mode,
        dist_mode)
    gram = dist_mode == "gram"
    want = [("gppe_matern_matmat_mma", gram, gram, r,
             cuda_kernels._DOT_CODES[dot_mode])] if r else []
    if frobenius:
        want.append(("gppe_matern_matmat", gram, gram, 0, None))
    assert lib.calls == want
    assert [entry for entry, _ in cuda_kernels._launch_plan(
        "matmat", r, frobenius)] == [call[0] for call in want]
    if frobenius:
        out, fro = out
        assert fro.dtype == F64
    assert (out is None) == (r == 0)
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_matmat_mma": int(r > 0), "matern_matmat": int(frobenius)}


@pytest.mark.parametrize("dot_mode", cuda_kernels.DOT_MODES)
@pytest.mark.parametrize("r", [0, 16])
@pytest.mark.parametrize("frobenius", [False, True])
def test_multirho_wrapper_launches_what_the_plan_says(
        dot_mode, r, frobenius, fake_library):
    """matern_matmat_multirho's card path against the stand-in library:
    the product, in every mode 'highest' included, goes to
    matern_multirho_mma with the mode's code and the batch; the traces are
    a trace-only launch of matern_multirho (no V, no width, no mode)."""
    rng = np.random.RandomState(r)
    B, n = 3, 40
    pts = _t(rng.rand(n, 2), F32)
    V = _t(rng.standard_normal((B, n, r)), F32) if r else None
    out = cuda_kernels._matern_matmat_multirho_cuda(
        pts, _t([0.05, 0.1, 0.3], F32), V, 0.5, frobenius, dot_mode)
    want = [("gppe_matern_multirho_mma", B, r,
             cuda_kernels._DOT_CODES[dot_mode])] if r else []
    if frobenius:
        want.append(("gppe_matern_multirho", B, 0, None))
    assert fake_library.calls == want
    if frobenius:
        out, tk2 = out
        assert tk2.shape == (B,) and tk2.dtype == F64
    assert (out is None) == (r == 0)
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_matmat_multirho_mma": int(r > 0),
        "matern_matmat_multirho": int(frobenius)}


@pytest.mark.parametrize("dot_mode", cuda_kernels.DOT_MODES)
@pytest.mark.parametrize("r", [0, 24])
@pytest.mark.parametrize("frobenius", [False, True])
def test_blocksparse_wrapper_launches_what_the_plan_says(
        dot_mode, r, frobenius, fake_library):
    """matern_matmat_blocksparse's card path against the stand-in library:
    the product, in every mode 'highest' included, goes to
    matern_blocksparse_mma with the mode's code; the trace is a trace-only
    launch of matern_blocksparse (no V, no width, no mode) over the
    symmetric walk of the mirrored list: its 5 units of tile pairs
    ti <= tj (one sub-tile a tile of 32 points)."""
    rng = np.random.RandomState(r)
    tile, num_tiles, n = 32, 3, 80
    pts = _t(rng.rand(tile * num_tiles, 2), F32)
    V = _t(rng.standard_normal((tile * num_tiles, r)), F32) if r else None
    pair_i = np.asarray([0, 0, 1, 1, 1, 2, 2], np.int32)
    pair_j = np.asarray([0, 1, 0, 1, 2, 1, 2], np.int32)
    out = cuda_kernels._matern_matmat_blocksparse_cuda(
        pts, V, 0.5, 0.1, pair_i, pair_j, tile, n, frobenius, None,
        dot_mode)
    want = [("gppe_matern_blocksparse_mma", num_tiles, r,
             cuda_kernels._DOT_CODES[dot_mode])] if r else []
    if frobenius:
        want.append(("gppe_matern_blocksparse", 5, 0, None))
    assert fake_library.calls == want
    if frobenius:
        out, fro = out
        assert fro.dtype == F64
    assert (out is None) == (r == 0)
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_matmat_blocksparse_mma": int(r > 0),
        "matern_matmat_blocksparse": int(frobenius)}


# -- the operator and the engines ---------------------------------------------

def engine_problem(n=1024):
    rng = np.random.RandomState(0)
    pts = rng.rand(n, 2)
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2),
            np.sign(rng.standard_normal((n, 16))),
            rng.standard_normal((n, 1)))


def test_engine_bf16x3_vs_float64_highest():
    """The n = 1024 profile MLE with a float32 'bf16x3' operator against
    the float64 'highest' engine on the same random block: eta rtol 5e-2,
    sigma0 rtol 5e-3 (the card's engine bounds)."""
    pts, z, X, probes, v_defl = engine_problem()
    fits = []
    for dtype, mode in ((F32, "bf16x3"), (F64, "highest")):
        op = tops.MaternOperator(pts, 0.1, nu=0.5, device="cpu", dtype=dtype,
                                 dot_mode=mode)
        fits.append(tls.KrylovProfileLikelihood(
            op, X, z, lanczos_steps=32, num_probes=16, device="cpu",
            dtype=dtype, probes=probes, v_defl=v_defl).fit())
    got, want = fits
    assert got["success"] and want["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=5e-3)


def test_operator_trace_is_exact_in_every_mode():
    pts = np.random.RandomState(2).rand(300, 2)
    V = _t(np.random.RandomState(3).standard_normal((300, 2)))
    ops = {mode: tops.MaternOperator(pts, 0.1, nu=1.5, device="cpu",
                                     dtype=F64, dot_mode=mode)
           for mode in (None,) + cuda_kernels.DOT_MODES}
    traces = {mode: op.trace_pow(2) for mode, op in ops.items()}
    for mode in cuda_kernels.DOT_MODES:
        assert torch.equal(traces[mode], traces[None])
    assert torch.equal(ops[None].matmat(V), ops["highest"].matmat(V))
    assert not torch.equal(ops["bf16x3"].matmat(V), ops["highest"].matmat(V))


@pytest.fixture
def seen_modes(monkeypatch):
    """Every dot mode that reaches the plain tile dot while the fixture is
    active."""
    seen = []
    plain = cuda_kernels.tile_dot_plain

    def spy(K, V, dot_mode):
        seen.append(dot_mode)
        return plain(K, V, dot_mode)

    monkeypatch.setattr(cuda_kernels, "tile_dot_plain", spy)
    return seen


@pytest.mark.parametrize("engine", ["operator", "grid", "tapered"])
def test_default_dot_mode_assignment_reaches(engine, seen_modes, monkeypatch):
    """``DEFAULT_DOT_MODE`` is read at call time: assigning it after the
    import (as ``profile_kernel_matrix.run_one`` does) reaches every engine
    that passes no mode of its own."""
    rng = np.random.RandomState(1)
    n = 96
    pts = rng.rand(n, 2)
    V = rng.standard_normal((n, 2))

    def run():
        if engine == "operator":
            tops.MaternOperator(pts, 0.1, device="cpu", dtype=F64).matmat(V)
        elif engine == "tapered":
            ttaper.TaperedMaternOperator(pts, 0.1, density=0.1, tile=32,
                                         device="cpu", dtype=F64).matmat(V)
        else:
            tgk.GridKrylovProfileLikelihood(
                pts, tdata.generate_basis_functions(pts, 1),
                tdata.generate_data(pts, 0.2), [0.1, 0.2], [0.5, 0.5],
                nu_static=0.5, lanczos_steps=4, num_probes=2,
                matrix_free=True, device="cpu", dtype=F64)

    run()
    assert seen_modes and set(seen_modes) == {"highest"}
    del seen_modes[:]
    monkeypatch.setattr(cuda_kernels, "DEFAULT_DOT_MODE", "bf16")
    run()
    assert seen_modes and set(seen_modes) == {"bf16"}


@pytest.mark.parametrize("kernel", ["matmat", "multirho", "blocksparse",
                                    "operator", "default"])
def test_unknown_modes_raise(kernel, monkeypatch):
    pts = torch.rand(64, 2, dtype=F64)
    V = torch.rand(64, 2, dtype=F64)
    match = "dot_mode must be one of"
    with pytest.raises(ValueError, match=match):
        if kernel == "matmat":
            cuda_kernels.matern_matmat(pts, 0.1, V, 0.5, dot_mode="fp8")
        elif kernel == "multirho":
            cuda_kernels.matern_matmat_multirho(pts, [0.1], V[None], 0.5,
                                                dot_mode="HIGHEST")
        elif kernel == "blocksparse":
            pair = np.arange(2, dtype=np.int32)
            cuda_kernels.matern_matmat_blocksparse(pts, V, 0.5, 0.1, pair,
                                                   pair, 32, dot_mode="tf32")
        elif kernel == "operator":
            tops.MaternOperator(pts, 0.1, device="cpu", dot_mode="bf16x2")
        else:
            monkeypatch.setattr(cuda_kernels, "DEFAULT_DOT_MODE", "fast")
            cuda_kernels.matern_matmat(pts, 0.1, V, 0.5)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="dist_mode must be 'diff' or"):
        cuda_kernels.matern_matmat(pts, 0.1, V, 0.5, dist_mode="l1")
