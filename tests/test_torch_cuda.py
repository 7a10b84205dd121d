"""gppe_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU (sm_90a) and nvcc and skips
without them. This file imports neither JAX nor gppe_tpu, so it runs where
JAX is not installed; tests/conftest.py sets JAX up, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Bounds are those of the reference's on-chip tier
(tests_tpu/test_onchip.py): float32 distance rounding puts ~|d| eps_f32 on
each kernel entry, so the product is judged by its Frobenius-relative
error (< 2e-5) and its largest absolute error (< 5e-4); trace(K^2) to
rtol 1e-5; u.Kv vs v.Ku to 1e-6 of |u| |Kv|. The tapered product is
compared at a threshold that no pair comes within 1e-5 (relative) of, so
that float32 and float64 taper the same entries.

The products of all three wrappers run on their tensor-core kernels
(matern_matmat_mma, matern_matmat_multirho_mma,
matern_matmat_blocksparse_mma) in every mode, 'highest' as 3xTF32 (held to
the bounds above), and every trace(K^2) on the FP32 kernels
(matern_matmat, matern_matmat_multirho, matern_matmat_blocksparse). The
first two walk only the tile pairs tj >= ti of a square K in the
difference form, the third only the 128 x 128 units of the tile pairs
ti <= tj of a mirrored pair list, and all three sum float64 block
partials: their traces must give the same bits run to run and in every
mode.

The tile-dot modes and the Gram form: 'bf16x3' keeps the exact mode's
Frobenius bound and must sit closer to its own plain version (same
rounding) than the rounding is large; 'bf16' must show its rounding
(1e-4 < error < 5e-3); the Gram form has the reference's envelope (1e-3,
max-abs 2e-2; tests/test_kernels.py::test_gram_dist_mode_accuracy). The
bf16 modes of all three tensor-core kernels (matern_matmat_mma,
matern_matmat_multirho_mma, matern_matmat_blocksparse_mma) take sqrt and
exp2 as the bare hardware approximations (2^-22 relative): far inside the
same bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gppe_tpu_torch  # noqa: E402
from gppe_tpu_torch.drivers import (  # noqa: E402
    profile_kernel_matrix, roofline_matvec)
from gppe_tpu_torch.models.grid_krylov import (  # noqa: E402
    GridKrylovProfileLikelihood)
from gppe_tpu_torch.models.krylov_posterior import (  # noqa: E402
    KrylovPosteriorSurface, KrylovPosteriorSurfaceRhoNu)
from gppe_tpu_torch.models.large_scale import (  # noqa: E402
    KrylovProfileLikelihood)
from gppe_tpu_torch.ops import cuda_kernels, kernels, linalg  # noqa: E402
from gppe_tpu_torch.ops.operators import (  # noqa: E402
    GridMaternOperator, MaternOperator)
from gppe_tpu_torch.ops.taper import TaperedMaternOperator  # noqa: E402
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402

pytestmark = pytest.mark.cuda
F32, F64 = torch.float32, torch.float64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(dev, n, r, nu, d=2, scale=0.1, n_cols=None, seed=0):
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
    cols = (None if n_cols is None else
            torch.as_tensor(rng.rand(n_cols, d), dtype=F32, device=dev))
    nc = n if n_cols is None else n_cols
    V = (torch.as_tensor(rng.standard_normal((nc, r)), dtype=F32, device=dev)
         if r else None)
    got, fro = cuda_kernels.matern_matmat(pts, scale, V, nu,
                                          points_cols=cols, frobenius=True)
    torch.cuda.synchronize()
    want, fro_want = cuda_kernels.matern_matmat_plain(
        pts.double(),
        kernels.broadcast_scale(scale, d, dtype=F64, device=dev),
        None if V is None else V.double(), nu,
        points_cols=None if cols is None else cols.double(),
        frobenius=True, block_rows=n)
    np.testing.assert_allclose(float(fro), float(fro_want), rtol=1e-5)
    if r:
        got, want = got.double().cpu().numpy(), want.cpu().numpy()
        assert got.shape == want.shape == (n, r)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-5
        assert np.max(np.abs(got - want)) < 5e-4


@pytest.mark.parametrize("n", [1024, 3001])
@pytest.mark.parametrize("r", [0, 1, 7, 24, 33])
def test_kernel_widths(dev, n, r):
    _check(dev, n, r, 0.5)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_kernel_branches_and_dims(dev, nu, d):
    _check(dev, 1500, 9, nu, d=d, seed=d)


def test_kernel_anisotropic_rectangular(dev):
    _check(dev, 3001, 24, 1.5, scale=[0.1, 0.25])
    _check(dev, 3001, 7, 0.5, scale=[0.08, 0.2], n_cols=1025, seed=2)


def test_kernel_symmetry(dev):
    rng = np.random.RandomState(2)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    u, v = (torch.as_tensor(rng.standard_normal((3001, 1)), dtype=F32,
                            device=dev) for _ in range(2))
    # dots in float64, so only the kernel's float32 sums show; relative to
    # |u| |Kv|, the scale that rounding is relative to (|u.Kv| itself can
    # be small by chance cancellation)
    Kv = cuda_kernels.matern_matmat(pts, 0.1, v, 0.5).double()
    Ku = cuda_kernels.matern_matmat(pts, 0.1, u, 0.5).double()
    a = float((u.double() * Kv).sum())
    b = float((v.double() * Ku).sum())
    scale = float(torch.linalg.norm(u.double()) * torch.linalg.norm(Kv))
    assert abs(a - b) / scale < 1e-6


def test_wrapper_counts_launches_and_checks_inputs(dev):
    """'highest': the product on the tensor-core kernel, the trace on the
    FP32 kernel; a refused call launches nothing."""
    pts = torch.rand(300, 2, device=dev)
    V = torch.rand(300, 3, device=dev)
    cuda_kernels.reset_launch_counts()
    op = MaternOperator(pts, 0.1, device=dev)
    op.matmat(V)
    op.trace_pow(2)
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat"] == 1
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_matmat(pts.double(), 0.1, V.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.matern_matmat(pts, 0.1, V.T.contiguous().T, 0.5)
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat"] == 1


def test_engine_n1024_cuda_matches_cpu(dev):
    """The profile MLE on the card (float32 kernel path) against the same
    engine on the CPU (float64 plain path), from the same data and random
    block; bounds of tests_tpu/test_onchip.py::test_krylov_profile_fit_n1024.
    """
    rng = np.random.RandomState(0)
    pts = rng.rand(1024, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    probes = np.sign(rng.standard_normal((1024, 16)))
    v_defl = rng.standard_normal((1024, 1))
    fits = []
    for device, dtype in ((dev, F32), ("cpu", F64)):
        op = MaternOperator(pts, 0.1, nu=0.5, device=device, dtype=dtype)
        fits.append(KrylovProfileLikelihood(
            op, X, z, lanczos_steps=32, num_probes=16, device=device,
            dtype=dtype, probes=probes, v_defl=v_defl).fit())
    got, want = fits
    assert got["success"] and want["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=5e-3)


# -- matern_matmat_multirho ---------------------------------------------------

def _assert_within_bounds(got, want):
    got, want = got.double().cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-5
    assert np.max(np.abs(got - want)) < 5e-4


def _check_multirho(dev, n, B, r, nu, d=2, seed=0):
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
    rhos = torch.as_tensor(np.linspace(0.06, 0.3, B), dtype=F32, device=dev)
    V = None
    if r:
        V = torch.as_tensor(rng.standard_normal((B, n, r)), dtype=F32,
                            device=dev)
    got, tk2 = cuda_kernels.matern_matmat_multirho(pts, rhos, V, nu,
                                                   return_frobenius=True)
    torch.cuda.synchronize()
    # the plain version sees what the kernel sees: float32 1/rho_b
    want, tk2_want = cuda_kernels.matern_matmat_multirho_plain(
        pts.double(), 1.0 / (1.0 / rhos).double(),
        None if V is None else V.double(), nu, return_frobenius=True)
    np.testing.assert_allclose(tk2.cpu().numpy(), tk2_want.cpu().numpy(),
                               rtol=1e-5)
    if r:
        _assert_within_bounds(got, want)


@pytest.mark.parametrize("n", [1024, 3001])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("r", [0, 1, 16, 24])
def test_multirho_batches_and_widths(dev, n, B, r):
    _check_multirho(dev, n, B, r, 0.5)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_multirho_branches_and_dims(dev, nu, d):
    _check_multirho(dev, 1500, 3, 9, nu, d=d, seed=d)


def test_multirho_single_rho_vs_matern_matmat(dev):
    """B = 1 against the single-scale kernel at the same rho, both 3xTF32
    under 'highest': the two order their arithmetic differently (scaled
    distance vs scaled points, a compensated vs a plain sum of tile sums),
    so within the bounds, not bit for bit."""
    rng = np.random.RandomState(4)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    V = torch.as_tensor(rng.standard_normal((3001, 16)), dtype=F32,
                        device=dev)
    got = cuda_kernels.matern_matmat_multirho(
        pts, torch.tensor([0.1], device=dev), V[None], 0.5)
    _assert_within_bounds(got[0], cuda_kernels.matern_matmat(
        pts, 0.1, V, 0.5).double())


def test_multirho_counts_launches_and_checks_inputs(dev):
    """'highest': the product on the tensor-core kernel, the traces on the
    FP32 kernel; a refused call launches nothing."""
    pts = torch.rand(300, 2, device=dev)
    rhos = torch.tensor([0.1, 0.2], device=dev)
    V = torch.rand(2, 300, 3, device=dev)
    cuda_kernels.reset_launch_counts()
    cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5)
    cuda_kernels.matern_matmat_multirho(pts, rhos, None, 0.5,
                                        return_frobenius=True)
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 1
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_matmat_multirho(pts.double(), rhos.double(),
                                            V.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.matern_matmat_multirho(
            pts, rhos, torch.rand(2, 300, 6, device=dev)[:, :, ::2], 0.5)
    with pytest.raises(ValueError, match="d <= 8"):
        cuda_kernels.matern_matmat_multirho(
            torch.rand(300, 9, device=dev), rhos, V, 0.5)
    with pytest.raises(ValueError, match="dot_mode must be one of"):
        cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5,
                                            dot_mode="bf16x2")
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 1
    # a call that asks for the product and the traces launches both
    # kernels, in every mode: the tensor-core one multiplies, the FP32 one
    # sums k^2
    cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5, dot_mode="bf16x3",
                                        return_frobenius=True)
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 2
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 2
    cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5, dot_mode="bf16")
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 3
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 2
    assert cuda_kernels.launch_counts["matern_matmat"] == 0
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 0


def test_grid_engine_n1024_cuda_matches_cpu_and_single_operator(dev):
    """One matrix-free chunk of three rhos on the card against the same
    grid engine on the CPU in float64 from the same random block (eta rtol
    5e-2, sigma0 rtol 5e-3) and against fresh single-operator engines (eta
    rtol 0.1, sigma0 rtol 1e-2: the bounds of
    tests_tpu/test_onchip.py::test_grid_krylov_multirho_chunk)."""
    rng = np.random.RandomState(0)
    pts = rng.rand(1024, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    rhos = np.asarray([0.08, 0.1, 0.15])
    kw = dict(nu_static=0.5, lanczos_steps=32, num_probes=8,
              matrix_free=True, chunk=3,
              probes=np.sign(rng.standard_normal((1024, 8))),
              v_defl=rng.standard_normal((1024, 1)))
    cuda_kernels.reset_launch_counts()
    got = GridKrylovProfileLikelihood(pts, X, z, rhos, np.full(3, 0.5),
                                      device=dev, **kw).fit_all()
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 32
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 1
    want = GridKrylovProfileLikelihood(pts, X, z, rhos, np.full(3, 0.5),
                                       device="cpu", dtype=F64,
                                       **kw).fit_all()
    for g, w, rho in zip(got, want, rhos):
        assert g["success"]
        np.testing.assert_allclose(g["eta"], w["eta"], rtol=5e-2)
        np.testing.assert_allclose(g["sigma0"], w["sigma0"], rtol=5e-3)
        ref = KrylovProfileLikelihood(
            MaternOperator(pts, float(rho), nu=0.5, device=dev), X, z,
            lanczos_steps=32, num_probes=16, device=dev).fit()
        np.testing.assert_allclose(g["eta"], ref["eta"], rtol=0.1)
        np.testing.assert_allclose(g["sigma0"], ref["sigma0"], rtol=1e-2)


# -- matern_matmat_blocksparse ------------------------------------------------

def _tapered(dev, n, nu, tile, grid=False, seed=0):
    if grid:
        side = int(round(np.sqrt(n)))
        pts = data_utils.generate_points(side, dimension=2)[:n]
    else:
        pts = np.random.RandomState(seed).rand(n, 2)
    op = TaperedMaternOperator(pts, 0.05, nu=nu, density=0.02, tile=tile,
                               device=dev)
    geometry = (op.pair_i, op._pair_j, op.tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    tau = cuda_kernels.blocksparse_clear_threshold(
        op.points_sorted.double(), nu, op.threshold, *geometry, **kw)
    return op, (nu, tau, *geometry), kw


def _check_blocksparse(dev, n, r, nu, tile, grid=False, seed=0):
    op, args, kw = _tapered(dev, n, nu, tile, grid, seed)
    rng = np.random.RandomState(seed + 1)
    V = None
    if r:
        V = torch.zeros((op.n_pad, r), device=dev)
        V[:n] = torch.as_tensor(rng.standard_normal((n, r)), dtype=F32)
    got, fro = cuda_kernels.matern_matmat_blocksparse(
        op.points_sorted, V, *args, frobenius=True, **kw)
    torch.cuda.synchronize()
    want, fro_want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), None if V is None else V.double(), *args,
        frobenius=True, **kw)
    np.testing.assert_allclose(float(fro), float(fro_want), rtol=1e-5)
    if r:
        _assert_within_bounds(got, want)
        assert not bool(got[n:].any())      # pad rows are zero


@pytest.mark.parametrize("n", [1024, 3001])
@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("grid", [False, True], ids=["random", "grid"])
@pytest.mark.parametrize("r", [0, 1, 24])
def test_blocksparse_geometries_and_widths(dev, n, tile, grid, r):
    _check_blocksparse(dev, n, r, 0.5, tile, grid=grid, seed=n % 7)


@pytest.mark.parametrize("nu", [1.5, 2.5])
@pytest.mark.parametrize("r", [7, 33])
def test_blocksparse_branches(dev, nu, r):
    _check_blocksparse(dev, 3001, r, nu, 128, seed=3)


def test_blocksparse_symmetry_and_determinism(dev):
    """u.Kv vs v.Ku (dots in float64, relative to |u| |Kv|) to 1e-6, and
    two launches give the same bits: a block owns its rows, no atomics."""
    n = 3001
    op, args, kw = _tapered(dev, n, 0.5, 128, seed=2)
    rng = np.random.RandomState(5)
    u, v = torch.zeros((2, op.n_pad, 1), device=dev)
    u[:n] = torch.as_tensor(rng.standard_normal((n, 1)), dtype=F32)
    v[:n] = torch.as_tensor(rng.standard_normal((n, 1)), dtype=F32)
    product = lambda w: cuda_kernels.matern_matmat_blocksparse(  # noqa: E731
        op.points_sorted, w, *args, **kw)
    Kv, Ku = product(v).double(), product(u).double()
    a = float((u.double() * Kv).sum())
    b = float((v.double() * Ku).sum())
    scale = float(torch.linalg.norm(u.double()) * torch.linalg.norm(Kv))
    assert abs(a - b) / scale < 1e-6
    assert torch.equal(product(v).double(), Kv)


def test_blocksparse_counts_launches_and_checks_inputs(dev):
    n = 700
    op, args, kw = _tapered(dev, n, 0.5, 128)
    V = torch.rand(op.n_pad, 3, device=dev)
    cuda_kernels.reset_launch_counts()
    op.matmat(V[:n])
    op.trace_pow(2)
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 1
    pts = op.points_sorted
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_matmat_blocksparse(pts.double(), V.double(),
                                               *args, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.matern_matmat_blocksparse(
            pts, torch.rand(op.n_pad, 6, device=dev)[:, ::2], *args, **kw)
    with pytest.raises(ValueError, match="d <= 8"):
        cuda_kernels.matern_matmat_blocksparse(
            torch.rand(op.n_pad, 9, device=dev), V, *args, **kw)
    with pytest.raises(ValueError, match="dot_mode must be one of"):
        cuda_kernels.matern_matmat_blocksparse(pts, V, *args,
                                               dot_mode="bf8", **kw)
    with pytest.raises(ValueError, match="int32"):
        cuda_kernels.matern_matmat_blocksparse(
            pts, V, *args, n=n, row_ptr=op._row_ptr.long())
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse_mma"] == 1
    # a call that asks for the product and the trace launches both kernels,
    # in every mode
    _, fro = cuda_kernels.matern_matmat_blocksparse(
        pts, V, *args, dot_mode="bf16x3", frobenius=True, **kw)
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse_mma"] == 2
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 2
    cuda_kernels.matern_matmat_blocksparse(pts, V, *args, dot_mode="bf16",
                                           **kw)
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse_mma"] == 3
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 2
    _, exact = cuda_kernels.matern_matmat_blocksparse(pts, None, *args,
                                                      frobenius=True, **kw)
    assert float(fro) == float(exact)       # the trace never rounds
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 3
    # the trace's walk: int32 units on the points' device, or numpy
    walk = op._trace_walk
    for units in (walk.units.long(), walk.units.cpu(), walk.units[:, :1]):
        with pytest.raises(ValueError, match="trace_walk"):
            cuda_kernels.matern_matmat_blocksparse(
                pts, None, *args, frobenius=True,
                trace_walk=walk._replace(units=units), **kw)
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 3
    _, own = cuda_kernels.matern_matmat_blocksparse(
        pts, None, *args, frobenius=True,
        trace_walk=walk._replace(units=walk.units.cpu().numpy()), **kw)
    assert float(own) == float(exact)
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 4


def test_tapered_engine_n16384_cuda_matches_cpu(dev):
    """The tapered profile MLE on the card (float32 kernel path) against
    the same engine on the CPU (float64 plain path), from the same data and
    random block; eta rtol 5e-2, sigma0 rtol 5e-3."""
    side = 128
    n = side * side
    pts = data_utils.generate_points(side, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    rng = np.random.RandomState(3)
    probes = np.sign(rng.standard_normal((n, 16)))
    v_defl = rng.standard_normal((n, 1))
    fits = []
    for device, dtype in ((dev, F32), ("cpu", F64)):
        op = TaperedMaternOperator(pts, 0.005, nu=0.5, density=1e-3,
                                   device=device, dtype=dtype)
        fits.append(KrylovProfileLikelihood(
            op, X, z, lanczos_steps=64, num_probes=16, device=device,
            dtype=dtype, probes=probes, v_defl=v_defl).fit())
    got, want = fits
    assert got["success"] and want["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=5e-3)


# -- the tile-dot modes and the Gram form -------------------------------------

def _frob(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _assert_mode_bounds(got, own, want, dot_mode, dist_mode="diff"):
    """``got``: the kernel; ``own``: its plain version in float32 with the
    same rounding (under 'highest' plain float32, or its 3xTF32 version);
    ``want``: plain float64 'highest'."""
    err, signature = _frob(got, want), _frob(own, want)
    if dot_mode == "bf16":
        assert 1e-4 < err < 5e-3
    else:
        assert err < (1e-3 if dist_mode == "gram" else 2e-5)
    if dot_mode == "highest" and dist_mode == "diff":
        assert float(torch.max(torch.abs(got.double() - want))) < 5e-4
        assert _frob(got, own) < 2e-5
    if dist_mode == "gram":
        assert _frob(got, own) < 1e-3
        if dot_mode != "bf16":
            assert float(torch.max(torch.abs(got.double() - want))) < 2e-2
    elif dot_mode != "highest":
        # an exact kernel in the mode's place would sit a signature away
        assert _frob(got, own) < 0.5 * signature


def _check_mode(dev, dot_mode, dist_mode, n, r, nu, d=2, scale=0.1,
                n_cols=None, seed=0):
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
    cols = (None if n_cols is None else
            torch.as_tensor(rng.rand(n_cols, d), dtype=F32, device=dev))
    nc = n if n_cols is None else n_cols
    V = torch.as_tensor(rng.standard_normal((nc, r)), dtype=F32, device=dev)
    kw = dict(points_cols=cols, dot_mode=dot_mode, dist_mode=dist_mode)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.matern_matmat(pts, scale, V, nu, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat"] == 0
    own = cuda_kernels.matern_matmat_plain(
        pts, kernels.broadcast_scale(scale, d, dtype=F32, device=dev), V, nu,
        block_rows=n, **kw)
    want = cuda_kernels.matern_matmat_plain(
        pts.double(), kernels.broadcast_scale(scale, d, dtype=F64,
                                              device=dev),
        V.double(), nu, points_cols=None if cols is None else cols.double(),
        block_rows=n, dot_mode="highest")
    assert got.shape == (n, r) and bool(torch.isfinite(got).all())
    _assert_mode_bounds(got, own, want, dot_mode, dist_mode)


@pytest.mark.parametrize("dot_mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("r", [1, 8, 23, 24, 40])
def test_mma_kernel_widths(dev, dot_mode, r):
    _check_mode(dev, dot_mode, "diff", 3001, r, 0.5)


@pytest.mark.parametrize("dot_mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_mma_kernel_branches_and_dims(dev, dot_mode, nu, d):
    _check_mode(dev, dot_mode, "diff", 1500, 9, nu, d=d, seed=d)


@pytest.mark.parametrize("dot_mode", ["highest", "bf16x3", "bf16"])
@pytest.mark.parametrize("nu", [0.5, 2.5])
@pytest.mark.parametrize("r", [7, 24, 40])
def test_gram_form(dev, dot_mode, nu, r):
    _check_mode(dev, dot_mode, "gram", 3001, r, nu, seed=r)


@pytest.mark.parametrize("dist_mode", ["diff", "gram"])
@pytest.mark.parametrize("dot_mode", ["highest", "bf16x3", "bf16"])
def test_modes_anisotropic_rectangular(dev, dot_mode, dist_mode):
    if (dot_mode, dist_mode) != ("highest", "diff"):    # covered above
        _check_mode(dev, dot_mode, dist_mode, 3001, 7, 0.5,
                    scale=[0.08, 0.2], n_cols=1025, seed=2)
    _check_mode(dev, dot_mode, dist_mode, 515, 24, 1.5, d=3,
                scale=[0.1, 0.25, 0.3], n_cols=130, seed=3)


def test_bf16x3_skew_is_bounded(dev):
    """'bf16x3' rounds v, so u.Kv and v.Ku differ: by less than 1e-4 of
    |u| |Kv| (the reference's bound), where 'highest' keeps 1e-6."""
    rng = np.random.RandomState(2)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    u, v = (torch.as_tensor(rng.standard_normal((3001, 1)), dtype=F32,
                            device=dev) for _ in range(2))
    Kv = cuda_kernels.matern_matmat(pts, 0.1, v, 0.5,
                                    dot_mode="bf16x3").double()
    Ku = cuda_kernels.matern_matmat(pts, 0.1, u, 0.5,
                                    dot_mode="bf16x3").double()
    a = float((u.double() * Kv).sum())
    b = float((v.double() * Ku).sum())
    scale = float(torch.linalg.norm(u.double()) * torch.linalg.norm(Kv))
    assert abs(a - b) / scale < 1e-4


def test_mma_wrapper_counts_launches(dev):
    """The tensor-core kernel multiplies, the FP32 kernel sums k^2: a call
    that asks for both launches both, in every mode, and the trace is the
    exact one."""
    pts = torch.rand(300, 2, device=dev)
    V = torch.rand(300, 3, device=dev)
    cuda_kernels.reset_launch_counts()
    out, fro = cuda_kernels.matern_matmat(pts, 0.1, V, 0.5,
                                          dot_mode="bf16x3", frobenius=True)
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat"] == 1
    _, exact = cuda_kernels.matern_matmat(pts, 0.1, None, 0.5,
                                          frobenius=True)
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat"] == 2
    assert float(fro) == float(exact)
    _, fro = cuda_kernels.matern_matmat(pts, 0.1, V, 0.5, frobenius=True)
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 2
    assert cuda_kernels.launch_counts["matern_matmat"] == 3
    assert float(fro) == float(exact)
    op = MaternOperator(pts, 0.1, device=dev, dot_mode="bf16")
    cuda_kernels.reset_launch_counts()
    op.matmat(V)
    op.trace_pow(2)
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat"] == 1
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_matmat(pts.double(), 0.1, V.double(), 0.5,
                                   dot_mode="bf16x3")
    with pytest.raises(ValueError, match="dot_mode must be one of"):
        cuda_kernels.matern_matmat(pts, 0.1, V, 0.5, dot_mode="tf32")
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1


@pytest.mark.parametrize("dot_mode", ["highest", "bf16x3", "bf16"])
@pytest.mark.parametrize("r", [7, 24])
def test_mma_d2_instance_matches_any_d(dev, dot_mode, r):
    """The d = 2 instance (row coordinates in registers) against the any-d
    instance (staged coordinates, a run-time loop) on the same points with
    a zero third coordinate: the squared distances are summed in the same
    order and a zero term adds nothing, so the two give the same bits; and
    the pair is within the mode's bounds."""
    rng = np.random.RandomState(r)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    V = torch.as_tensor(rng.standard_normal((3001, r)), dtype=F32,
                        device=dev)
    flat = torch.cat([pts, torch.zeros_like(pts[:, :1])], dim=1)
    got2 = cuda_kernels.matern_matmat(pts, 0.1, V, 1.5, dot_mode=dot_mode)
    got3 = cuda_kernels.matern_matmat(flat, 0.1, V, 1.5, dot_mode=dot_mode)
    assert torch.equal(got2, got3)
    own = cuda_kernels.matern_matmat_plain(
        pts, kernels.broadcast_scale(0.1, 2, dtype=F32, device=dev), V, 1.5,
        dot_mode=dot_mode)
    want = cuda_kernels.matern_matmat_plain(
        pts.double(), kernels.broadcast_scale(0.1, 2, dtype=F64, device=dev),
        V.double(), 1.5)
    _assert_mode_bounds(got3, own, want, dot_mode)


def _skew(u, v, Ku, Kv):
    """|u.Kv - v.Ku| relative to |u| |Kv|, dots in float64."""
    a = float((u.double() * Kv.double()).sum())
    b = float((v.double() * Ku.double()).sum())
    return abs(a - b) / float(torch.linalg.norm(u.double())
                              * torch.linalg.norm(Kv.double()))


# every width class of the tensor-core multi-rho kernel (1, 2, 3 n8 tiles,
# 16-column chunks), batches that fill, half fill and overflow a block's
# group of 4 rhos, ragged n, every nu, d up to 8
MULTIRHO_MODE_CASES = (
    [(3001, 3, r, 1.5, 2) for r in (1, 8, 16, 23, 24, 40)]
    + [(1024, 8, 16, 0.5, 2), (3001, 9, 16, 2.5, 2), (2050, 1, 24, 150.0, 2),
       (3001, 3, 8, 0.5, 1), (3001, 3, 7, 2.5, 3), (2050, 8, 16, 1.5, 8)])


def _multirho_problem(dev, n, B, r, d, seed):
    """The grid path's rho batch, stretched by sqrt(d / 2) so the scaled
    distances stay of its order in any d."""
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
    rhos = torch.as_tensor(np.linspace(0.06, 0.3, B) * np.sqrt(d / 2),
                           dtype=F32, device=dev)
    V = torch.as_tensor(rng.standard_normal((B, n, r)), dtype=F32,
                        device=dev)
    return pts, rhos, V


# under 'highest', the kernel's own plain version: the 3xTF32 product
TF32X3 = dict(_product=cuda_kernels._tf32x3_dot_plain)


@pytest.mark.parametrize("dot_mode", ["highest", "bf16x3", "bf16"])
@pytest.mark.parametrize("n, B, r, nu, d", MULTIRHO_MODE_CASES)
def test_multirho_modes(dev, dot_mode, n, B, r, nu, d):
    pts, rhos, V = _multirho_problem(dev, n, B, r, d, seed=r + d)
    cuda_kernels.reset_launch_counts()
    got, tk2 = cuda_kernels.matern_matmat_multirho(
        pts, rhos, V, nu, dot_mode=dot_mode, return_frobenius=True)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 1
    own = cuda_kernels.matern_matmat_multirho_plain(
        pts, rhos, V, nu, dot_mode=dot_mode,
        **(TF32X3 if dot_mode == "highest" else {}))
    want, tk2_want = cuda_kernels.matern_matmat_multirho_plain(
        pts.double(), 1.0 / (1.0 / rhos).double(), V.double(), nu,
        return_frobenius=True, dot_mode="highest")
    assert got.shape == (B, n, r) and bool(torch.isfinite(got).all())
    _assert_mode_bounds(got, own, want, dot_mode)
    np.testing.assert_allclose(tk2.cpu().numpy(), tk2_want.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("dot_mode", ["bf16x3", "bf16"])
def test_multirho_mma_single_rho_vs_matern_matmat_mma(dev, dot_mode):
    """B = 1 against the single-scale tensor-core kernel on pre-scaled
    points. The two scale at different places (the distance here, the
    points there) and this kernel takes sqrt and exp2 as approximations, so
    k differs in its last bits before it is rounded to bf16: the products
    agree to a quarter of what the mode's rounding itself costs."""
    rng = np.random.RandomState(4)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    V = torch.as_tensor(rng.standard_normal((3001, 16)), dtype=F32,
                        device=dev)
    got = cuda_kernels.matern_matmat_multirho(
        pts, torch.tensor([0.1], device=dev), V[None], 0.5,
        dot_mode=dot_mode)[0]
    ref = cuda_kernels.matern_matmat(pts, 0.1, V, 0.5, dot_mode=dot_mode)
    want = cuda_kernels.matern_matmat_plain(
        pts.double(), kernels.broadcast_scale(0.1, 2, dtype=F64, device=dev),
        V.double(), 0.5)
    signature = _frob(ref, want)
    assert _frob(got, ref) < 0.25 * signature


def test_multirho_highest_at_the_largest_rho(dev):
    """'highest' at the grid path's largest rho and full n: K(0.3) is
    nearly dense, the row sums reach a few hundred and each is the sum of
    782 tile sums, where a plain float32 running sum carried 5.0e-4 of
    max-abs error. The kernel compensates that sum: max-abs < 5e-4,
    Frobenius < 2e-5 against float64."""
    n = 100_000
    rng = np.random.RandomState(7)
    pts = torch.as_tensor(rng.rand(n, 2), dtype=F32, device=dev)
    rhos = torch.tensor([0.3], device=dev)
    V = torch.as_tensor(rng.standard_normal((1, n, 16)), dtype=F32,
                        device=dev)
    got = cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5)
    want = cuda_kernels.matern_matmat_multirho_plain(
        pts.double(), 1.0 / (1.0 / rhos).double(), V.double(), 0.5,
        block_rows=4096)
    _assert_within_bounds(got, want)


# as MULTIRHO_MODE_CASES, for the block-sparse tensor-core kernel: every
# width class up to the 32-column chunks, tiles 128 and 512, ragged n (pad
# rows and columns), every nu, d up to 8: (n, r, nu, tile, d, scale, seed),
# each seed one whose geometry has a threshold clear of every pair
BLOCKSPARSE_MODE_CASES = (
    [(3001, r, 0.5, 128, 2, 0.05, 3) for r in (1, 8, 16, 23, 24, 40)]
    + [(3001, 16, 1.5, 512, 2, 0.05, 4), (2050, 24, 2.5, 512, 2, 0.05, 5),
       (3001, 7, 150.0, 128, 2, 0.05, 6), (3001, 8, 0.5, 128, 1, 0.005, 7),
       (3001, 24, 1.5, 128, 3, 0.2, 8), (2050, 8, 0.5, 512, 8, 1.0, 9)])


def _tapered_any_d(dev, n, nu, tile, d, scale, seed):
    rng = np.random.RandomState(seed)
    if d <= 3:
        pts = rng.rand(n, d)
    else:
        # a flat cloud of side 10 turned into d dimensions: in a cube of
        # that many dimensions the taper ball holds most of the points and
        # no threshold is clear of every pair
        q, _ = np.linalg.qr(rng.standard_normal((d, 2)))
        pts = (10.0 * rng.rand(n, 2)) @ q.T
    op = TaperedMaternOperator(pts, scale, nu=nu, density=0.02, tile=tile,
                               device=dev)
    geometry = (op.pair_i, op._pair_j, op.tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    tau = cuda_kernels.blocksparse_clear_threshold(
        op.points_sorted.double(), op.nu, op.threshold, *geometry, **kw)
    return op, (op.nu, tau, *geometry), kw


def _padded_normal(op, n, r, rng, dev):
    V = torch.zeros((op.n_pad, r), device=dev)
    V[:n] = torch.as_tensor(rng.standard_normal((n, r)), dtype=F32)
    return V


@pytest.mark.parametrize("dot_mode", ["highest", "bf16x3", "bf16"])
@pytest.mark.parametrize("n, r, nu, tile, d, scale, seed",
                         BLOCKSPARSE_MODE_CASES)
def test_blocksparse_modes(dev, dot_mode, n, r, nu, tile, d, scale, seed):
    op, args, kw = _tapered_any_d(dev, n, nu, tile, d, scale, seed)
    V = _padded_normal(op, n, r, np.random.RandomState(r), dev)
    cuda_kernels.reset_launch_counts()
    got, fro = cuda_kernels.matern_matmat_blocksparse(
        op.points_sorted, V, *args, dot_mode=dot_mode, frobenius=True, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse_mma"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 1
    own = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted, V, *args, dot_mode=dot_mode,
        **(TF32X3 if dot_mode == "highest" else {}), **kw)
    want, fro_want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), V.double(), *args, frobenius=True,
        dot_mode="highest", **kw)
    assert got.shape == (op.n_pad, r) and bool(torch.isfinite(got).all())
    _assert_mode_bounds(got, own, want, dot_mode)
    np.testing.assert_allclose(float(fro), float(fro_want), rtol=1e-5)
    assert not bool(got[n:].any())


@pytest.mark.parametrize("dot_mode", ["highest", "bf16x3"])
@pytest.mark.parametrize("kernel", ["multirho", "blocksparse"])
def test_mma_kernels_skew_and_determinism(dev, kernel, dot_mode):
    """Both tensor-core kernels: u.Kv vs v.Ku within 1e-6 of |u| |Kv| under
    'highest' (V split into tf32 parts drops only lo*lo) and 1e-4 under
    'bf16x3' (V is rounded, so the map is not exactly linear), and two
    launches give the same bits (a block owns its rows and walks its
    columns in a fixed order; no atomics)."""
    skew = 1e-6 if dot_mode == "highest" else 1e-4
    n = 3001
    rng = np.random.RandomState(6)
    if kernel == "multirho":
        pts, rhos, _ = _multirho_problem(dev, n, 3, 1, 2, seed=6)
        u, v = (torch.as_tensor(rng.standard_normal((3, n, 1)), dtype=F32,
                                device=dev) for _ in range(2))
        product = lambda w: cuda_kernels.matern_matmat_multirho(  # noqa: E731
            pts, rhos, w, 0.5, dot_mode=dot_mode)
        Ku, Kv = product(u), product(v)
        for b in range(3):
            assert _skew(u[b], v[b], Ku[b], Kv[b]) < skew
    else:
        op, args, kw = _tapered(dev, n, 0.5, 128, seed=2)
        u, v = (_padded_normal(op, n, 1, rng, dev) for _ in range(2))
        product = lambda w: cuda_kernels.matern_matmat_blocksparse(  # noqa: E731
            op.points_sorted, w, *args, dot_mode=dot_mode, **kw)
        Ku, Kv = product(u), product(v)
        assert _skew(u, v, Ku, Kv) < skew
    assert torch.equal(product(v), Kv)
    wide = torch.cat([v] * 24, dim=-1).contiguous()
    assert torch.equal(product(wide), product(wide))


def test_engine_n1024_bf16x3_matches_cpu_highest(dev):
    rng = np.random.RandomState(0)
    pts = rng.rand(1024, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    probes = np.sign(rng.standard_normal((1024, 16)))
    v_defl = rng.standard_normal((1024, 1))
    fits = []
    cuda_kernels.reset_launch_counts()
    for device, dtype, mode in ((dev, F32, "bf16x3"), ("cpu", F64,
                                                       "highest")):
        op = MaternOperator(pts, 0.1, nu=0.5, device=device, dtype=dtype,
                            dot_mode=mode)
        fits.append(KrylovProfileLikelihood(
            op, X, z, lanczos_steps=32, num_probes=16, device=device,
            dtype=dtype, probes=probes, v_defl=v_defl).fit())
    got, want = fits
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 32
    assert cuda_kernels.launch_counts["matern_matmat"] == 1
    assert got["success"] and want["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=5e-3)


def test_entry_points_on_the_card(dev):
    """Both entry points at n = 4096: the mode's kernel is the one that
    ran, and no share of a peak reads above 100."""
    rec = profile_kernel_matrix.run_one("bf16x3", n=4096, device=dev,
                                        lanczos_steps=16, num_probes=4,
                                        chain_reps=5)
    assert rec["launches_per_construction"] == {"matern_matmat_mma": 16,
                                                "matern_matmat": 1}
    assert 1e-7 < rec["rel_err_vs_plain"] < 2e-5
    out = roofline_matvec.main(n=4096, device=dev, warm=1, reps=3,
                               verbose=False)
    assert len(out["rows"]) == 12
    for row in out["rows"]:
        assert 0 <= row["pct_f32_peak"] <= 100
        assert 0 <= row["pct_bf16_peak"] <= 100
        assert 0 <= row["pct_tf32_peak"] <= 100
        assert row["launches"] == {"matern_matmat_mma": 4}


# -- the dense trace(K^2) kernels ---------------------------------------------

TRACE_NS = [1, 127, 129, 1000, 4097]


@pytest.mark.parametrize("n", TRACE_NS)
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
def test_trace_kernel_square_rectangular_gram(dev, n, nu):
    """matern_matmat's trace-only launch against the plain float64 sum at
    ragged n, d in {1, 2, 3}: the square call (the symmetric walk, half the
    tile pairs), the rectangular one (every pair) and the Gram form (every
    pair: its trace equals that of the rectangular Gram call on a copy of
    the points, bit for bit). Each twice, with the same bits. Bounds:
    rtol 1e-5 in the difference form; 2e-3 in the Gram form, whose
    entries carry the reference's 1e-3 Frobenius envelope and
    |sum K~^2 - sum K^2| <= (2 eps + eps^2) sum K^2."""
    for d in (1, 2, 3):
        rng = np.random.RandomState(n + d)
        pts = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
        cols = torch.as_tensor(rng.rand(777, d), dtype=F32, device=dev)
        scale = 0.1 * np.sqrt(d / 2)
        for kw, rtol in (({}, 1e-5), ({"points_cols": cols}, 1e-5),
                         ({"dist_mode": "gram"}, 2e-3)):
            cuda_kernels.reset_launch_counts()
            _, got = cuda_kernels.matern_matmat(pts, scale, None, nu,
                                                frobenius=True, **kw)
            _, again = cuda_kernels.matern_matmat(pts, scale, None, nu,
                                                  frobenius=True, **kw)
            assert cuda_kernels.launch_counts["matern_matmat"] == 2
            assert float(got) == float(again)
            c = kw.get("points_cols")
            _, want = cuda_kernels.matern_matmat_plain(
                pts.double(), kernels.broadcast_scale(scale, d, dtype=F64,
                                                      device=dev),
                None, nu, frobenius=True,
                points_cols=None if c is None else c.double())
            np.testing.assert_allclose(float(got), float(want), rtol=rtol)
        _, rect = cuda_kernels.matern_matmat(
            pts, scale, None, nu, frobenius=True, points_cols=pts.clone(),
            dist_mode="gram")
        assert float(rect) == float(got)


@pytest.mark.parametrize("n", TRACE_NS)
@pytest.mark.parametrize("B", [1, 7, 8, 9, 17])
def test_multirho_trace_kernel(dev, n, B):
    """matern_matmat_multirho's trace-only launch (the symmetric walk, one
    to three groups of 8 rhos) against the plain float64 traces, rho by
    rho, rtol 1e-5, for every nu and d in {1, 2, 3}; twice, with the same
    bits."""
    for nu in (0.5, 1.5, 2.5, 150.0):
        for d in (1, 2, 3):
            pts, rhos, _ = _multirho_problem(dev, n, B, 0, d, seed=n + d)
            _, got = cuda_kernels.matern_matmat_multirho(
                pts, rhos, None, nu, return_frobenius=True)
            _, again = cuda_kernels.matern_matmat_multirho(
                pts, rhos, None, nu, return_frobenius=True)
            assert got.shape == (B,) and torch.equal(got, again)
            _, want = cuda_kernels.matern_matmat_multirho_plain(
                pts.double(), 1.0 / (1.0 / rhos).double(), None, nu,
                return_frobenius=True)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-5)


def test_traces_with_several_tile_pairs_per_block(dev, monkeypatch):
    """Both dense traces at n = 4097 with the partials buffer capped at 7
    blocks, so every block walks many tile pairs in its loop, the route of
    every n above ~131,000 (81 of the square walk's 561 pairs, 33 of the
    rectangular 4097 x 777 walk's 231, 156 of the Gram form's 1089):
    against the plain float64 sums (rtol 1e-5; 2e-3 in the Gram form, as
    in test_trace_kernel_square_rectangular_gram) and against the same
    calls at one tile pair per block, to 1e-12 relative, since only the
    float64 order of the partials changes."""
    rng = np.random.RandomState(41)
    n, nu, scale = 4097, 1.5, 0.1
    pts = torch.as_tensor(rng.rand(n, 2), dtype=F32, device=dev)
    cols = torch.as_tensor(rng.rand(777, 2), dtype=F32, device=dev)
    rhos = torch.as_tensor(np.linspace(0.05, 0.3, 9), dtype=F32, device=dev)
    calls = {"square": {}, "rectangular": {"points_cols": cols},
             "gram": {"dist_mode": "gram"}}

    def traces():
        out = {k: float(cuda_kernels.matern_matmat(
            pts, scale, None, nu, frobenius=True, **kw)[1])
            for k, kw in calls.items()}
        out["multirho"] = cuda_kernels.matern_matmat_multirho(
            pts, rhos, None, nu, return_frobenius=True)[1].double().cpu()
        return out

    one = traces()
    monkeypatch.setattr(cuda_kernels, "_TRACE_MAX_BLOCKS", 7)
    for nc, symmetric, per_block in ((n, True, 81), (777, False, 33),
                                     (n, False, 156)):
        assert cuda_kernels.trace_schedule(n, nc, symmetric)[3:] == (
            per_block, 7)
    many = traces()
    S = kernels.broadcast_scale(scale, 2, dtype=F64, device=dev)
    for name, kw in calls.items():
        c = kw.get("points_cols")
        want = float(cuda_kernels.matern_matmat_plain(
            pts.double(), S, None, nu, frobenius=True,
            points_cols=None if c is None else c.double())[1])
        np.testing.assert_allclose(many[name], want,
                                   rtol=2e-3 if name == "gram" else 1e-5)
        np.testing.assert_allclose(many[name], one[name], rtol=1e-12)
    want = cuda_kernels.matern_matmat_multirho_plain(
        pts.double(), 1.0 / (1.0 / rhos).double(), None, nu,
        return_frobenius=True)[1].cpu()
    np.testing.assert_allclose(many["multirho"].numpy(), want.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(many["multirho"].numpy(),
                               one["multirho"].numpy(), rtol=1e-12)


def test_traces_one_launch_each_and_the_same_in_every_mode(dev):
    """trace_pow(2) and the grid engine's trace call launch the trace
    kernel once and nothing else, and give the same bits under every dot
    mode (the traces never round)."""
    rng = np.random.RandomState(9)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    rhos = torch.as_tensor(np.linspace(0.05, 0.3, 8), dtype=F32, device=dev)
    fro, tk2 = {}, {}
    for mode in cuda_kernels.DOT_MODES:
        cuda_kernels.reset_launch_counts()
        fro[mode] = float(MaternOperator(pts, 0.1, device=dev,
                                         dot_mode=mode).trace_pow(2))
        tk2[mode] = cuda_kernels.matern_matmat_multirho(
            pts, rhos, None, 0.5, dot_mode=mode, return_frobenius=True)[1]
        assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} \
            == {"matern_matmat": 1, "matern_matmat_multirho": 1}
    assert fro["bf16x3"] == fro["highest"] == fro["bf16"]
    assert torch.equal(tk2["bf16x3"], tk2["highest"])
    assert torch.equal(tk2["bf16"], tk2["highest"])


# -- the tapered trace(K^2) kernel --------------------------------------------

# the symmetric and the full walk of one list sum the same float32 k^2, but
# in other float32 partials (a row's at most 32 columns of a unit; k^2 >= 0,
# each added with an error <= 2^-24 of the partial): each walk lies within
# 31 * 2^-24 = 1.85e-6 of the exact sum of those k^2, so the two within
# 4e-6 of each other. One unit dropped or counted twice moves the trace at
# these sizes by more than 1e-4
WALKS_RTOL = 4e-6
# correlation scales that put the taper radius (density 0.02) 1.6 to 3
# scales out in d = 1, 2, 3: where it lies closer, k is so flat near tau
# that no threshold is clear of every pair by 1e-5
TAPER_SCALES = {1: 0.005, 2: 0.05, 3: 0.05 * np.sqrt(1.5)}


@pytest.mark.parametrize("n, tile", [(1000, 128), (3001, 200), (2050, 512),
                                     (100, 512)])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
def test_blocksparse_trace_kernel(dev, n, tile, nu):
    """matern_matmat_blocksparse's trace-only launch over the operator's
    symmetric walk at ragged n, tile 128, 200 (units of 128 and 72 points),
    512 and 100 (n < 128), every nu, d in {1, 2, 3}, at a threshold clear of
    every pair: against the plain float64 full-list sum (rtol 1e-5); the
    same bits twice, under every dot mode and from the walk the wrapper
    builds itself; against the full walk of the same list passed without
    its mirror flag (WALKS_RTOL). One launch of the trace kernel a call."""
    for d in (1, 2, 3):
        op, args, kw = _tapered_any_d(dev, n, nu, tile, d, TAPER_SCALES[d],
                                      seed=n + d)

        def trace(**extra):
            return float(cuda_kernels.matern_matmat_blocksparse(
                op.points_sorted, None, *args, frobenius=True, **kw,
                **extra)[1])

        cuda_kernels.reset_launch_counts()
        got = trace(trace_walk=op._trace_walk)
        assert trace(trace_walk=op._trace_walk) == got
        for mode in cuda_kernels.DOT_MODES:
            assert trace(trace_walk=op._trace_walk, dot_mode=mode) == got
        assert trace() == got
        assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} \
            == {"matern_matmat_blocksparse": 6}
        _, want = cuda_kernels.matern_matmat_blocksparse_plain(
            op.points_sorted.double(), None, *args, frobenius=True, **kw)
        np.testing.assert_allclose(got, float(want), rtol=1e-5)
        full = cuda_kernels.blocksparse_trace_schedule(
            op.pair_i, op.pair_j, op.tile, n, symmetric=False)
        np.testing.assert_allclose(got, trace(trace_walk=full),
                                   rtol=WALKS_RTOL)


def test_blocksparse_trace_with_several_units_per_block(dev, monkeypatch):
    """The tapered trace at n = 3001, tile 200, with the partials buffer
    capped at 7 blocks, so that every block walks many units in its loop:
    against the plain float64 sum (rtol 1e-5) and against the same call at
    one unit per block, to 1e-12 relative, since only the float64 order of
    the partials changes."""
    op, args, kw = _tapered_any_d(dev, 3001, 1.5, 200, 2, 0.05, seed=41)
    units = len(op._trace_walk.units)

    def trace():
        return float(cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, None, *args, frobenius=True,
            trace_walk=op._trace_walk, **kw)[1])

    one = trace()
    assert cuda_kernels.trace_blocks(units) == (1, units)
    monkeypatch.setattr(cuda_kernels, "_TRACE_MAX_BLOCKS", 7)
    per_block, blocks = cuda_kernels.trace_blocks(units)
    assert blocks == 7 and per_block > 1
    many = trace()
    _, want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), None, *args, frobenius=True, **kw)
    np.testing.assert_allclose(many, float(want), rtol=1e-5)
    np.testing.assert_allclose(many, one, rtol=1e-12)


# -- the exact dense path and the public API ---------------------------------

@pytest.mark.parametrize("method", ["direct", "profiled"])
def test_dense_facade_n1024_cuda_matches_cpu(dev, method):
    """GaussianProcess(X, K, method).train(z) on the card (float32
    assembly, float64 eigendecomposition and rotation there) against the
    same facade on the CPU in float64, from the same points: eta rtol 1e-5
    (a float32 assembly moves eta by ~1.5e-7 on the CPU), sigma0 rtol
    1e-6."""
    pts = data_utils.generate_points(32, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    fits = []
    for device, dtype in ((dev, F32), ("cpu", F64)):
        K = gppe_tpu_torch.generate_correlation(pts, 0.1, nu=0.5,
                                                device=device, dtype=dtype)
        assert K.device.type == torch.device(device).type
        gp = gppe_tpu_torch.GaussianProcess(X, K, method, device=device)
        assert gp.likelihood.K_mixed.eigenvalues.device == K.device
        fits.append(gp.train(z))
    got, want = fits
    assert got["success"] and want["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=1e-5)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=1e-6)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-5)


@pytest.mark.parametrize("r", [1, 6, 32])
def test_cg_through_the_operator(dev, r):
    """Batched CG on a cuda MaternOperator (every product on
    matern_matmat_mma, 'highest') at the operator route's widths against a
    plain float64 solve on the card: n = 4096, eta = 1, tol 1e-6; the
    solution within 1e-4 (Frobenius-relative) of float64, each column's
    iterations counted, one kernel launch per iteration."""
    n, eta = 4096, 1.0
    rng = np.random.RandomState(r)
    pts = rng.rand(n, 2)
    B = torch.as_tensor(rng.standard_normal((n, r)), dtype=F32, device=dev)
    op = MaternOperator(pts, 0.1, nu=0.5, device=dev)
    cuda_kernels.reset_launch_counts()
    X, its = linalg.cg_solve(op.matmat, B, tol=1e-6, shift=eta,
                             return_iterations=True)
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.launch_counts)
    K = cuda_kernels.matern_matmat_plain(
        torch.as_tensor(pts, dtype=F64, device=dev),
        kernels.broadcast_scale(0.1, 2, dtype=F64, device=dev),
        torch.eye(n, dtype=F64, device=dev), 0.5, block_rows=1024)
    want = torch.linalg.solve(K + eta * torch.eye(n, dtype=F64, device=dev),
                              B.double())
    err = float(torch.linalg.norm(X.double() - want)
                / torch.linalg.norm(want))
    assert err < 1e-4
    assert its.shape == (r,) and int(its.min()) > 0
    assert launches["matern_matmat_mma"] == int(its.max())
    assert launches["matern_matmat"] == 0


# -- general nu: csrc/matern_general.cu ---------------------------------------

GENERAL_NUS = [0.01, 0.3, 1.2, 3.7, 10.0, 24.9]


@pytest.mark.parametrize("nu", GENERAL_NUS + [0.5, 2.5, 150.0])
def test_general_elementwise(dev, nu):
    """k(x; nu) over x in geomspace(1e-5, 40) and 0 against float64 on the
    card: within 3e-5 (the reference's own float32 error at nu ~ 25);
    finite and in [0, 1] at the general orders; 1 at x = 0; the closed
    forms through the kernel's own branch for them."""
    x = torch.cat([torch.zeros(1, device=dev),
                   torch.logspace(-5, np.log10(40.0), 50_001,
                                  device=dev)]).float()
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.matern_general(x, nu)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_elementwise"] == 1
    want = kernels.matern(x.double(), nu)
    assert float((got.double() - want).abs().max()) < 3e-5
    assert float(got[0]) == 1.0 and bool(torch.isfinite(got).all())
    if not kernels.is_closed_form(nu):
        assert bool(((got >= 0) & (got <= 1)).all())


@pytest.mark.parametrize("n", [1000, 3001])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("nu", GENERAL_NUS)
def test_general_product_and_trace(dev, n, d, nu):
    """K @ V at r in {1, 7, 24, 33} and trace(K^2) against float64 on the
    card at ragged n: Frobenius-relative 1e-5, trace rtol 1e-5; a width
    above 32 runs as two launches; the trace the same bits run to run.
    The points are scaled by 1/rho in float32 first and handed over at
    scale 1, so the float64 version sees the kernel's own inputs: at
    nu = 0.01 k falls by three quarters between x = 0 and x = 1e-5, and the
    ulp that float32 scaling moves a near 1-D pair by moved the product by
    1.1e-5 (the plain float64 product of the two scalings, n = 1000)."""
    rng = np.random.RandomState(n + d)
    P = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev) / 0.1
    V = torch.as_tensor(rng.standard_normal((n, 33)), dtype=F32, device=dev)
    scale = kernels.broadcast_scale(1.0, d, dtype=F64, device=dev)
    want, fro_want = cuda_kernels.matern_matmat_plain(
        P.double(), scale, V.double(), nu, frobenius=True)
    for r in (1, 7, 24, 33):
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.matern_general_matmat(P, 1.0, V[:, :r].contiguous(),
                                                 nu)
        torch.cuda.synchronize()
        assert cuda_kernels.launch_counts["matern_general_product"] == (
            2 if r > 32 else 1)
        err = float(torch.linalg.norm(got.double() - want[:, :r])
                    / torch.linalg.norm(want[:, :r]))
        assert err < 1e-5, (r, err)
    fro = cuda_kernels.matern_general_matmat(P, 1.0, None, nu,
                                             frobenius=True)[1]
    again = cuda_kernels.matern_general_matmat(P, 1.0, None, nu,
                                               frobenius=True)[1]
    assert fro.dtype == F64 and float(fro) == float(again)
    assert abs(float(fro) - float(fro_want)) / float(fro_want) < 1e-5


@pytest.mark.parametrize("n, d", [(1000, 2), (3001, 2), (700, 3)])
@pytest.mark.parametrize("nu", [0.3, 1.2, 24.9])
def test_general_product_symmetric_rectangular_batched(dev, n, d, nu):
    """The general-nu product on its symmetric walk (rows are columns) and
    on the rectangular one (distinct column points, every tile pair)
    against float64 (Frobenius 1e-5, chip_smoke.py's GENERAL_FROB_TOL), at
    r = 16 and 40; the same bits twice; a batch of three (scale, nu)
    points equal bit for bit to its single calls."""
    rng = np.random.RandomState(n + d)
    P = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
    C = torch.as_tensor(rng.rand(n // 2 + 3, d), dtype=F32, device=dev)
    scale = kernels.broadcast_scale(0.1, d, dtype=F32, device=dev)
    for r in (16, 40):
        V = torch.as_tensor(rng.standard_normal((n, r)), dtype=F32,
                            device=dev)
        W = V[:C.shape[0]].contiguous()
        for cols, rhs in ((None, V), (C, W)):
            got = cuda_kernels.matern_general_matmat(P, scale, rhs, nu,
                                                     points_cols=cols)
            again = cuda_kernels.matern_general_matmat(P, scale, rhs, nu,
                                                       points_cols=cols)
            assert torch.equal(got, again)
            want = cuda_kernels.matern_matmat_plain(
                P.double(), scale.double(), rhs.double(), nu,
                points_cols=None if cols is None else cols.double())
            err = float(torch.linalg.norm(got.double() - want)
                        / torch.linalg.norm(want))
            assert err < 1e-5, (r, cols is None, err)
    rhos, nus = [0.1, 0.25, 0.05], [nu, 3.7, 1.5]
    Vb = torch.as_tensor(rng.standard_normal((3, n, 24)), dtype=F32,
                         device=dev)
    cuda_kernels.reset_launch_counts()
    batch = cuda_kernels.matern_general_matmat_batched(
        P, torch.tensor(rhos, device=dev), Vb, nus)
    assert cuda_kernels.launch_counts["matern_general_product"] == 1
    for b in range(3):
        assert torch.equal(batch[b], cuda_kernels.matern_general_matmat(
            P, rhos[b], Vb[b], nus[b]))


@pytest.mark.parametrize("symmetric", [True, False])
def test_general_product_bands(dev, monkeypatch, symmetric):
    """The general-nu product's walk in bands: at n = 40,000, r = 32 its
    slots for every tile pair would take 1.6 GB (the symmetric walk), over
    six times GENERAL_SLOT_BYTES; it runs in bands within that budget
    (the scratch the wrapper allocates, measured by the allocator's peak),
    its first and last 200 rows against float64 (Frobenius 1e-5); and
    with the walk cut into bands of 5 tile pairs a batch of two equals its
    one-band result and its single calls bit for bit (n = 3001)."""
    rng = np.random.RandomState(40)
    n = 40_000
    P = torch.as_tensor(rng.rand(n, 2), dtype=F32, device=dev)
    C = None if symmetric else torch.as_tensor(rng.rand(n // 2, 2),
                                               dtype=F32, device=dev)
    nc = n if symmetric else n // 2
    V = torch.as_tensor(rng.standard_normal((nc, 32)), dtype=F32, device=dev)
    walk = cuda_kernels.general_product_bands(n, nc, 32, 1, symmetric)
    assert walk.bands > 1
    assert 4 * walk.slot_floats <= cuda_kernels.GENERAL_SLOT_BYTES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.matern_general_matmat(P, 0.1, V, 1.2, points_cols=C)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_product"] == walk.bands
    assert (torch.cuda.max_memory_allocated(dev) - base
            <= 4 * walk.slot_floats + 4 * n * 32 + (1 << 20))
    rows = torch.cat([torch.arange(200, device=dev),
                      torch.arange(n - 200, n, device=dev)])
    want = cuda_kernels.matern_matmat_plain(
        P[rows].double(), kernels.broadcast_scale(0.1, 2, dtype=F64,
                                                  device=dev),
        V.double(), 1.2, points_cols=(P if C is None else C).double())
    err = float(torch.linalg.norm(got[rows].double() - want)
                / torch.linalg.norm(want))
    assert err < 1e-5, err

    n = 3001
    P = P[:n].contiguous()
    rhos, nus = [0.1, 0.05], [1.2, 24.9]
    Vb = torch.as_tensor(rng.standard_normal((2, n, 24)), dtype=F32,
                         device=dev)
    whole = cuda_kernels.matern_general_matmat_batched(
        P, torch.tensor(rhos, device=dev), Vb, nus)
    per_pair = 4 * 2 * 2 * 128 * 24
    monkeypatch.setattr(cuda_kernels, "GENERAL_SLOT_BYTES", 5 * per_pair)
    cuda_kernels.reset_launch_counts()
    banded = cuda_kernels.matern_general_matmat_batched(
        P, torch.tensor(rhos, device=dev), Vb, nus)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_product"] == (
        -(-(24 * 25 // 2) // 5))
    assert torch.equal(banded, whole)
    for b in range(2):
        assert torch.equal(whole[b], cuda_kernels.matern_general_matmat(
            P, rhos[b], Vb[b], nus[b]))


@pytest.mark.parametrize("n", [10_000, 40_000])
def test_general_trace_against_float64(dev, n):
    """The general-nu trace on the binned k tile at n = 10^4 and 40,000
    random points (rho 0.1, nu = 1.2: the operator route's shape) against
    the plain float64 trace, on the square K's walk (the pairs above the
    diagonal, twice, and n) and on the rectangular one (the points given
    as columns: every pair): rtol 1e-5 (chip_smoke.py's
    GENERAL_TRACE_RTOL); one launch each; the same bits twice."""
    P = torch.as_tensor(np.random.RandomState(n).rand(n, 2), dtype=F32,
                        device=dev)
    cuda_kernels.reset_launch_counts()
    fro = cuda_kernels.matern_general_matmat(P, 0.1, None, 1.2,
                                             frobenius=True)[1]
    rect = cuda_kernels.matern_general_matmat(P, 0.1, None, 1.2,
                                              points_cols=P.clone(),
                                              frobenius=True)[1]
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_trace"] == 2
    assert fro.dtype == F64 and float(fro) == float(
        cuda_kernels.matern_general_matmat(P, 0.1, None, 1.2,
                                           frobenius=True)[1])
    want = float(cuda_kernels.matern_matmat_plain(
        P.double(), kernels.broadcast_scale(0.1, 2, dtype=F64, device=dev),
        None, 1.2, frobenius=True, block_rows=2048)[1])
    for got in (fro, rect):
        assert abs(float(got) - want) / want < 1e-5, (float(got), want)


def test_general_trace_batch_equals_single_calls(dev, monkeypatch):
    """A batch of six (scale, nu) points (per-dimension scales, a closed
    form among them) in one trace launch equals its six single calls bit
    for bit, and so do launches of two points each (the partials capped);
    each within 1e-5 of float64."""
    n = 3001
    rng = np.random.RandomState(6)
    P = torch.as_tensor(rng.rand(n, 2), dtype=F32, device=dev)
    nus = (0.3, 1.2, 1.5, 3.7, 10.0, 24.9)
    scales = torch.as_tensor(0.05 + 0.2 * rng.rand(6, 2), dtype=F32,
                             device=dev)
    cuda_kernels.reset_launch_counts()
    batch = cuda_kernels.matern_general_trace_batched(P, scales, nus)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_trace"] == 1
    blocks = cuda_kernels.trace_schedule(n, n, True)[4]
    monkeypatch.setattr(cuda_kernels, "_GENERAL_TRACE_PARTIALS", 2 * blocks)
    cuda_kernels.reset_launch_counts()
    pairs = cuda_kernels.matern_general_trace_batched(P, scales, nus)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_trace"] == 3
    assert torch.equal(batch, pairs)
    for b, nu in enumerate(nus):
        single = cuda_kernels.matern_general_matmat(P, scales[b], None, nu,
                                                    frobenius=True)[1]
        assert float(batch[b]) == float(single)
        want = float(cuda_kernels.matern_matmat_plain(
            P.double(), scales[b].double(), None, nu, frobenius=True)[1])
        assert abs(float(single) - want) / want < 1e-5, (nu, want)


def test_general_through_the_public_entry_points(dev):
    """matern_matmat and MaternOperator at a general nu run the general
    kernel (no closed-form launch) in every dot mode, with the same bits;
    the anisotropic, rectangular product against float64; the tapered
    operator at a general nu runs the tapered general-nu kernel only; a
    float64 CUDA tensor is refused."""
    rng = np.random.RandomState(5)
    P = torch.as_tensor(rng.rand(700, 2), dtype=F32, device=dev)
    C = torch.as_tensor(rng.rand(450, 2), dtype=F32, device=dev)
    V = torch.as_tensor(rng.standard_normal((450, 5)), dtype=F32, device=dev)
    scale = torch.tensor([0.08, 0.2], dtype=F32, device=dev)
    cuda_kernels.reset_launch_counts()
    outs = [cuda_kernels.matern_matmat(P, scale, V, 3.7, points_cols=C,
                                       dot_mode=m)
            for m in cuda_kernels.DOT_MODES]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert cuda_kernels.launch_counts["matern_general_product"] == 3
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 0
    want = cuda_kernels.matern_matmat_plain(
        P.double(), scale.double(), V.double(), 3.7, points_cols=C.double())
    assert float(torch.linalg.norm(outs[0].double() - want)
                 / torch.linalg.norm(want)) < 1e-5
    op = MaternOperator(P.cpu().numpy(), 0.1, nu=1.2, device=dev)
    W = torch.randn((700, 3), device=dev)
    assert torch.equal(op.matmat(W), cuda_kernels.matern_general_matmat(
        P, 0.1, W, 1.2))
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_general(torch.rand(10, dtype=F64, device=dev),
                                    1.2)
    top = TaperedMaternOperator(P.cpu().numpy(), 0.1, nu=1.2, density=0.05,
                                device=dev)
    cuda_kernels.reset_launch_counts()
    top.matmat(W)
    top.trace_pow(2)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} == {
        "matern_blocksparse_general_product": 1,
        "matern_blocksparse_general_trace": 1}


def test_general_operator_dense_runs_the_elementwise_kernel(dev):
    """MaternOperator.dense() at a general nu: one launch of the general-nu
    kernel's assembly entry (no plain Bessel on the card, no elementwise
    launch), K within 3e-5 of float64."""
    pts = np.random.RandomState(6).rand(500, 2)
    op = MaternOperator(pts, 0.1, nu=3.7, device=dev)
    cuda_kernels.reset_launch_counts()
    K = op.dense()
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} == {
        "matern_general_assembly": 1}
    P = torch.as_tensor(pts, dtype=F64, device=dev)
    want = kernels.matern(kernels.pairwise_scaled_distance(P, P, 0.1), 3.7)
    assert K.dtype == F32
    assert float((K.double() - want).abs().max()) < 3e-5


@pytest.mark.parametrize("n, d", [(1000, 2), (3001, 2), (700, 3),
                                  (257, 1)])
def test_general_assembly(dev, n, d):
    """The general-nu assembly entry at ragged n over phase 21's nus (a
    closed form among them through the kernel's own branch): K within 3e-5
    of float64, symmetric bit for bit, a diagonal of exactly 1; one launch
    for the batch, which equals its single calls bit for bit; float64
    output the float32 output widened bit for bit; a block of rows the
    square's rows bit for bit (each k of the rectangular walk has the bits
    of its mirror's on the symmetric one)."""
    rng = np.random.RandomState(n + d)
    P = torch.as_tensor(rng.rand(n, d), dtype=F32, device=dev)
    nus = tuple(GENERAL_NUS) + (1.5,)
    scales = torch.as_tensor(0.05 + 0.2 * rng.rand(len(nus), d), dtype=F32,
                             device=dev)
    cuda_kernels.reset_launch_counts()
    K = cuda_kernels.matern_general_assemble(P, scales, nus)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} == {
        "matern_general_assembly": 1}
    assert K.shape == (len(nus), n, n) and K.dtype == F32
    K64 = cuda_kernels.matern_general_assemble(P, scales, nus,
                                               out_dtype=F64)
    assert K64.dtype == F64 and torch.equal(K64, K.double())
    for b, nu in enumerate(nus):
        assert torch.equal(K[b], K[b].T)
        assert bool(torch.all(torch.diagonal(K[b]) == 1.0))
        # float64 on the kernel's own float32 scaled points: at nu = 0.01
        # the ulp that float32 scaling moves a near 1-D pair by moved k
        # by 1.3e-4 (n = 257)
        S = (P / scales[b]).double()
        want = kernels.matern(kernels.pairwise_scaled_distance(S, S, 1.0),
                              nu)
        assert float((K[b].double() - want).abs().max()) < 3e-5, nu
        one = cuda_kernels.matern_general_assemble(P, scales[b:b + 1], (nu,))
        assert torch.equal(one[0], K[b])
    for rows in ((0, 129), (n // 3, n), (n - 1, n)):
        block = cuda_kernels.matern_general_assemble(P, scales, nus,
                                                     rows=rows)
        assert torch.equal(block, K[:, rows[0]:rows[1]])


@pytest.mark.parametrize("nr, nc, symmetric", [(3001, 3001, True),
                                               (1000, 1000, True),
                                               (700, 450, False)])
@pytest.mark.parametrize("r", [1, 7, 16, 24, 32])
def test_general_product_sum_kernel_equals_plain(dev, nr, nc, symmetric, r):
    """The product's band-sum kernel against its plain version bit for
    bit, band after band (bands of 5 tile pairs, each adding to what the
    bands before wrote) on random slots, into the columns of a wider out:
    every width instance (8, 16, 32 columns)."""
    g = torch.Generator(device=dev).manual_seed(nr + r)
    B, band_pairs = 3, 5
    sides = 2 if symmetric else 1
    tiles_r, tiles_c = -(-nr // 128), -(-nc // 128)
    pairs = tiles_r * (tiles_r + 1) // 2 if symmetric else tiles_r * tiles_c
    out = torch.randn((B, nr, r + 9), generator=g, device=dev)
    want = out.clone()
    cuda_kernels.reset_launch_counts()
    for g0 in range(0, pairs, band_pairs):
        band = min(band_pairs, pairs - g0)
        slots = torch.randn(B * band_pairs * sides * 128 * r, generator=g,
                            device=dev)
        cuda_kernels.general_product_sum(slots, out[:, :, 4:4 + r], nc,
                                         symmetric, g0, band, band_pairs)
        cuda_kernels.general_product_sum_plain(
            slots, want[:, :, 4:4 + r], nc, symmetric, g0, band, band_pairs)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts["matern_general_product_sum"] == (
        -(-pairs // band_pairs))
    assert torch.equal(out, want)


def test_general_grid_engine_cuda_matches_cpu(dev):
    """The grid engine over general nus, matrix-free (one batched product
    launch a step, one band at n = 400, one trace launch for both points),
    against the same engine on the CPU in float64 from the same random
    block, at n = 400 (the CPU's plain version is slow): each point's eta
    within 5e-2 and sigma0 within 5e-3 (the reference's cuda-vs-cpu
    bounds)."""
    n = 400
    rng = np.random.RandomState(3)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    probes = np.sign(rng.standard_normal((n, 6)))
    v_defl = rng.standard_normal((n, 1))
    kw = dict(lanczos_steps=12, num_probes=6, matrix_free=True,
              probes=probes, v_defl=v_defl)
    rhos, nus = np.array([0.08, 0.15]), np.array([1.2, 6.3])
    cuda_kernels.reset_launch_counts()
    got = GridKrylovProfileLikelihood(pts, X, z, rhos, nus, device=dev,
                                      **kw).fit_all()
    assert cuda_kernels.launch_counts["matern_general_product"] == 12
    assert cuda_kernels.launch_counts["matern_general_trace"] == 1
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 0
    want = GridKrylovProfileLikelihood(pts, X, z, rhos, nus, device="cpu",
                                       dtype=F64, **kw).fit_all()
    for a, b in zip(got, want):
        assert a["success"] and b["success"]
        assert abs(a["eta"] - b["eta"]) / b["eta"] < 5e-2
        assert abs(a["sigma0"] - b["sigma0"]) / b["sigma0"] < 5e-3


# -- the tapered general-nu kernel (matern_blocksparse_general.cu) ------------

# every nu at one small 2-D shape; one nu at a ragged 2-D shape of 16
# tiles, in 3-D and in 1-D (chip_smoke.py's phase 25 runs the whole
# nu x shape grid; the float64 plain version at 3001 points takes 20-50 s
# a nu on the card)
BLOCKSPARSE_GENERAL_CASES = ([(1000, 128, 2, nu)
                              for nu in (0.3, 1.2, 3.7, 24.9)]
                             + [(3001, 200, 2, 24.9), (1000, 512, 3, 3.7),
                                (100, 512, 1, 0.3)])


@pytest.mark.parametrize("n, tile, d, nu", BLOCKSPARSE_GENERAL_CASES)
def test_blocksparse_general_kernel(dev, n, tile, d, nu):
    """matern_matmat_blocksparse at a general nu, at a threshold clear of
    every pair: the product at r in {1, 7, 24, 40} (40: two launches) and
    the trace against the plain float64 version (Frobenius 1e-5, the
    general-nu kernel's bounds; trace rtol 1e-5); pad rows zero; the trace
    the same bits twice and from the walk the wrapper builds itself; only
    the general-nu entries launch, one product launch per 32 columns."""
    op, args, kw = _tapered_any_d(dev, n, nu, tile, d, TAPER_SCALES[d],
                                  seed=n + d)
    V = _padded_normal(op, n, 40, np.random.RandomState(d), dev)
    want, fro_want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), V.double(), *args, frobenius=True, **kw)
    for r in (1, 7, 24, 40):
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, V[:, :r].contiguous(), *args, **kw)
        torch.cuda.synchronize()
        assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} \
            == {"matern_blocksparse_general_product": 2 if r > 32 else 1}
        assert not bool(got[n:].any())
        err = float(torch.linalg.norm(got.double() - want[:, :r])
                    / torch.linalg.norm(want[:, :r]))
        assert err < 1e-5, (r, err)

    def trace(**extra):
        return float(cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, None, *args, frobenius=True, **kw, **extra)[1])

    got = trace(trace_walk=op._trace_walk)
    assert trace(trace_walk=op._trace_walk) == got and trace() == got
    np.testing.assert_allclose(got, float(fro_want), rtol=1e-5)


@pytest.mark.parametrize("n, tile, d, nu", [(1000, 128, 2, 1.2),
                                             (2000, 512, 2, 24.9),
                                             (1000, 512, 3, 0.3)])
def test_blocksparse_general_skip(dev, monkeypatch, n, tile, d, nu):
    """The tapered general-nu product skips the pairs past the skip radius
    (and the sub-tile pairs whose boxes lie past it): at the operator's
    threshold and at one clear of every pair, the same bits as with no
    pair skipped (a skipped pair adds an exact 0 in the same order), and
    within 1e-5 (Frobenius) of float64 at the clear threshold."""
    op, args, kw = _tapered_any_d(dev, n, nu, tile, d, TAPER_SCALES[d],
                                  seed=n + d)
    V = _padded_normal(op, n, 24, np.random.RandomState(d), dev)
    skip2 = cuda_kernels._blocksparse_skip2
    for tau in (op.threshold, args[1]):
        targs = (args[0], tau, *args[2:])
        got = cuda_kernels.matern_matmat_blocksparse(op.points_sorted, V,
                                                     *targs, **kw)
        assert np.isfinite(skip2(nu, tau))
        monkeypatch.setattr(cuda_kernels, "_blocksparse_skip2",
                            lambda nu, tau: float("inf"))
        every = cuda_kernels.matern_matmat_blocksparse(op.points_sorted, V,
                                                       *targs, **kw)
        monkeypatch.setattr(cuda_kernels, "_blocksparse_skip2", skip2)
        assert torch.equal(got, every)
    want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), V.double(), *args, **kw)
    err = float(torch.linalg.norm(got.double() - want)
                / torch.linalg.norm(want))
    assert err < 1e-5, err


def _traces_with_and_without_skip(monkeypatch, trace):
    """``trace()`` with the taper skip, and with no pair skipped."""
    skip2 = cuda_kernels._blocksparse_skip2
    got = trace()
    monkeypatch.setattr(cuda_kernels, "_blocksparse_skip2",
                        lambda nu, tau: float("inf"))
    every = trace()
    monkeypatch.setattr(cuda_kernels, "_blocksparse_skip2", skip2)
    return got, every


@pytest.mark.parametrize("n, tile, d, nu", [(1000, 128, 2, 1.2),
                                             (2000, 512, 2, 24.9),
                                             (1000, 512, 3, 0.3)])
def test_blocksparse_general_trace_skip(dev, monkeypatch, n, tile, d, nu):
    """The tapered general-nu trace skips the pairs past the skip radius
    and the units whose boxes lie past it: at the operator's threshold and
    at one clear of every pair, the same bits as with no pair skipped (a
    skipped pair or unit adds an exact 0), and within 1e-5 of float64 at
    the clear one; one launch each, on the operator's walk of 64-row
    units."""
    op, args, kw = _tapered_any_d(dev, n, nu, tile, d, TAPER_SCALES[d],
                                  seed=n + d)
    assert op._trace_walk.unit_rows == 64
    for tau in (op.threshold, args[1]):
        targs = (args[0], tau, *args[2:])

        def trace():
            return cuda_kernels.matern_matmat_blocksparse(
                op.points_sorted, None, *targs, frobenius=True,
                trace_walk=op._trace_walk, **kw)[1]
        assert np.isfinite(cuda_kernels._blocksparse_skip2(nu, tau))
        cuda_kernels.reset_launch_counts()
        got, every = _traces_with_and_without_skip(monkeypatch, trace)
        torch.cuda.synchronize()
        assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} \
            == {"matern_blocksparse_general_trace": 2}
        assert got.dtype == F64 and float(got) == float(every)
    want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), None, *args, frobenius=True, **kw)[1]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_blocksparse_general_trace_on_the_path_sub_list(dev, monkeypatch):
    """The tapered path's trace at nu = 1.2 (chip_smoke.py phase 28: a
    1024 x 1024 grid, rho 0.005, density 1e-3, tiles of 512) on the pair
    list of its first 32 row tiles among themselves (94 tile pairs,
    n = 16384): with and without the skip the same bits, within 1e-5 of
    float64 at a threshold clear of every pair."""
    pts = data_utils.generate_points(1024, dimension=2)
    op = TaperedMaternOperator(pts, 0.005, nu=1.2, density=1e-3, device=dev)
    keep = (op.pair_i < 32) & (op.pair_j < 32)
    pi, pj = op.pair_i[keep], op.pair_j[keep]
    assert len(pi) == 94
    n = 32 * op.tile
    P = op.points_sorted[:n]
    kw = dict(n=n, row_ptr=torch.as_tensor(
        cuda_kernels.blocksparse_row_ptr(pi, 32), device=dev))
    geometry = (pi, torch.as_tensor(pj, device=dev), op.tile)
    walk = cuda_kernels.blocksparse_general_trace_schedule(pi, pj, op.tile, n)
    walk = walk._replace(units=torch.as_tensor(walk.units, device=dev))
    tau = cuda_kernels.blocksparse_clear_threshold(
        P.double(), 1.2, op.threshold, *geometry, **kw)

    def trace():
        return cuda_kernels.matern_matmat_blocksparse(
            P, None, 1.2, tau, *geometry, frobenius=True, trace_walk=walk,
            **kw)[1]
    got, every = _traces_with_and_without_skip(monkeypatch, trace)
    assert float(got) == float(every)
    want = cuda_kernels.matern_matmat_blocksparse_plain(
        P.double(), None, 1.2, tau, *geometry, frobenius=True, **kw)[1]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_blocksparse_general_symmetry_and_closed_forms(dev):
    """The tapered general-nu product is symmetric (u.Kv against v.Ku to
    1e-6 of |u| |Kv|) and the same bits run to run and in every dot mode
    (which it ignores); at the closed forms the same wrapper launches the
    closed-form kernels only."""
    op, args, kw = _tapered_any_d(dev, 3001, 1.2, 512, 2, 0.05, seed=9)
    rng = np.random.RandomState(2)
    u = _padded_normal(op, 3001, 1, rng, dev)
    v = _padded_normal(op, 3001, 1, rng, dev)
    Ku = cuda_kernels.matern_matmat_blocksparse(op.points_sorted, u, *args,
                                                **kw)
    Kv = cuda_kernels.matern_matmat_blocksparse(op.points_sorted, v, *args,
                                                **kw)
    skew = abs(float((u * Kv).sum() - (v * Ku).sum()))
    assert skew < 1e-6 * float(torch.linalg.norm(u) * torch.linalg.norm(Kv))
    for mode in cuda_kernels.DOT_MODES:
        assert torch.equal(cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, v, *args, dot_mode=mode, **kw), Kv)
    for nu in (0.5, 1.5, 2.5, 150.0):
        cop, cargs, ckw = _tapered_any_d(dev, 1000, nu, 128, 2, 0.05, seed=3)
        cuda_kernels.reset_launch_counts()
        cuda_kernels.matern_matmat_blocksparse(
            cop.points_sorted, _padded_normal(cop, 1000, 7, rng, dev),
            *cargs, frobenius=True, **ckw)
        assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} \
            == {"matern_matmat_blocksparse_mma": 1,
                "matern_matmat_blocksparse": 1}


def test_tapered_general_engine_cuda_matches_cpu(dev):
    """TaperedMaternOperator at nu = 1.2 through KrylovProfileLikelihood on
    the card (the tapered general-nu kernel, float32) against the same on
    the CPU in float64 from the same random block, at n = 400 (rho 0.1,
    density 0.1: eta ~123 on the CPU): eta within 5e-2 and sigma0 within
    5e-3 (the reference's cuda-vs-cpu bounds)."""
    n = 400
    rng = np.random.RandomState(4)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    kw = dict(lanczos_steps=16, num_probes=8,
              probes=np.sign(rng.standard_normal((n, 8))),
              v_defl=rng.standard_normal((n, 1)))
    fits = {}
    for name, device, dtype in (("cuda", dev, F32), ("cpu", "cpu", F64)):
        op = TaperedMaternOperator(pts, 0.1, nu=1.2, density=0.1, tile=128,
                                   device=device, dtype=dtype)
        cuda_kernels.reset_launch_counts()
        fits[name] = KrylovProfileLikelihood(op, X, z, device=device,
                                             dtype=dtype, **kw).fit()
        if name == "cuda":
            assert {k: v for k, v in cuda_kernels.launch_counts.items()
                    if v} == {"matern_blocksparse_general_product": 16,
                              "matern_blocksparse_general_trace": 1}
    a, b = fits["cuda"], fits["cpu"]
    assert a["success"] and b["success"] and np.isfinite(b["eta"])
    assert abs(a["eta"] - b["eta"]) / b["eta"] < 5e-2
    assert abs(a["sigma0"] - b["sigma0"]) / b["sigma0"] < 5e-3


def test_sparse_operator_and_csr_route_on_the_card(dev):
    """A scipy CSR on the card: SparseOperator (float32 and float64, one
    torch.sparse.mm a product) against the host product; the general-nu CSR
    builder on the card (the assembly entry) against the same builder on
    the CPU in float64, the kept entries equal apart from those within
    1e-5 of the threshold; GaussianProcess over a CSR above the dense
    threshold runs the Krylov route."""
    import scipy.sparse

    from gppe_tpu_torch.ops import taper
    from gppe_tpu_torch.ops.operators import SparseOperator

    pts = data_utils.generate_points(40, dimension=2)
    K = gppe_tpu_torch.generate_correlation(pts, 0.03, sparse=True,
                                            density=0.05, device=dev)
    assert scipy.sparse.isspmatrix_csr(K)
    V = np.random.RandomState(0).standard_normal((K.shape[0], 5))
    for dtype, tol in ((F32, 1e-5), (F64, 1e-12)):
        op = SparseOperator(K, device=dev, dtype=dtype)
        got = op.matmat(torch.as_tensor(V, device=dev)).cpu().numpy()
        want = K @ V
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < tol
    cuda_kernels.reset_launch_counts()
    G = taper.generate_tapered_correlation(pts, 0.03, 1.2, 0.05, device=dev)
    assert cuda_kernels.launch_counts["matern_general_assembly"] > 0
    assert cuda_kernels.launch_counts["matern_general_elementwise"] == 0
    H = taper.generate_tapered_correlation(pts, 0.03, 1.2, 0.05,
                                           device="cpu", dtype=F64)
    tau = taper.estimate_kernel_threshold(len(pts), 2, 0.05, [0.03] * 2, 1.2)
    # entries kept by one builder only: float64 k within 1e-5 of tau
    flipped = abs(G.sign() - H.sign()).tocoo()
    P = pts / 0.03
    k64 = kernels.matern(torch.as_tensor(np.linalg.norm(
        P[flipped.row] - P[flipped.col], axis=1)), 1.2).numpy()
    assert np.all(np.abs(k64 - tau) < 1e-5 * tau)
    assert abs(G.multiply(H.sign()) - H.multiply(G.sign())).max() < 3e-5
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    with pytest.warns(UserWarning, match="slq"):
        gp = gppe_tpu_torch.GaussianProcess(X, K, "profiled",
                                            dense_threshold=0, device=dev)
    assert gp.likelihood.operator_mode
    res = gp.train(z)
    assert res["success"] and 0.15 < res["sigma0"] < 0.25


# -- the structured-grid slice: the FFT grid operator and the surfaces -------

@pytest.mark.parametrize("nu", [0.5, 2.2])
def test_grid_fft_operator_against_float64(dev, nu):
    """GridMaternOperator at n = 1024 (a 32 x 32 grid, rho 0.1; the
    reference's on-chip case, tests_tpu/test_onchip.py:159-199): matmat
    of 5 columns (cuFFT, complex64 spectra) within 2e-5 (Frobenius) of
    float64 dense K @ V, trace(K^2) rtol 1e-6; at a general nu the table
    one elementwise launch of the general-nu kernel (no other kernel)."""
    pts = data_utils.generate_points(32, dimension=2)
    cuda_kernels.reset_launch_counts()
    op = GridMaternOperator(pts, 0.1, nu=nu, device=dev)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} == (
        {} if nu == 0.5 else {"matern_general_elementwise": 1})
    P = torch.as_tensor(pts, dtype=F64, device=dev)
    K = kernels.matern(kernels.pairwise_scaled_distance(P, P, 0.1), nu)
    V = torch.as_tensor(np.random.RandomState(0).standard_normal((1024, 5)),
                        device=dev)
    got = op.matmat(V.float())
    assert got.dtype == F32 and got.shape == (1024, 5)
    want = K @ V
    assert float(torch.linalg.norm(got.double() - want)
                 / torch.linalg.norm(want)) < 2e-5
    assert abs(float(op.trace_pow(2)) / float(torch.sum(K * K)) - 1) < 1e-6


def test_grid_fft_general_table_against_float64(dev):
    """The float32 operator's general-nu table (the elementwise entry,
    widened) within 3e-5 of the float64 operator's (kernels.matern in
    float64), at nu in {0.3, 2.2, 24.9} on a 64 x 64 grid; the float64
    operator launches no kernel."""
    pts = data_utils.generate_points(64, dimension=2)
    for nu in (0.3, 2.2, 24.9):
        cuda_kernels.reset_launch_counts()
        op64 = GridMaternOperator(pts, 0.05, nu=nu, device=dev, dtype=F64)
        assert not any(cuda_kernels.launch_counts.values())
        op32 = GridMaternOperator(pts, 0.05, nu=nu, device=dev)
        assert cuda_kernels.launch_counts["matern_general_elementwise"] == 1
        gap = float(torch.max(torch.abs(op32._k_tab - op64._k_tab)))
        assert gap < cuda_kernels.GENERAL_K_ATOL, (nu, gap)


def test_posterior_surface_cuda_matches_cpu(dev):
    """A float32 KrylovPosteriorSurface on the card (the multi-rho kernel,
    nu = 1/2) against the same float32 surface on the CPU (its plain
    version) at n = 400 random points, from the same random block: within
    0.5 nats at three (eta, rho) (the reference's envelope for two routes
    with the same probes, tests/test_krylov_posterior.py:156-185)."""
    rng = np.random.RandomState(0)
    pts = rng.rand(400, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    probes = np.sign(rng.standard_normal((400, 12)))
    v_defl = rng.standard_normal((400, 1))
    kw = dict(nu=0.5, log10_rho_bounds=(-1.5, -0.5), num_nodes=12,
              lanczos_steps=32, num_probes=12, probes=probes, v_defl=v_defl,
              dtype=F32)
    cuda_kernels.reset_launch_counts()
    card = KrylovPosteriorSurface(pts, z, X, device=dev, **kw)
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 32
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 1
    cpu = KrylovPosteriorSurface(pts, z, X, device="cpu", **kw)
    for th in ((0.0, -1.2), (1.0, -0.9), (2.0, -0.6)):
        assert abs(float(card.profile_loglik(*th))
                   - float(cpu.profile_loglik(*th))) < 0.5, th


def test_rho_nu_surface_on_the_card(dev):
    """KrylovPosteriorSurfaceRhoNu on a 24 x 24 grid, 3 x 3 nodes: float32
    nodes take one elementwise launch per nu (3), float64 nodes none, and
    the two surfaces agree within 3 nats at the 9 nodes (log10 eta in {1,
    2, 3}), where the surface needs no interpolation."""
    pts = data_utils.generate_points(24, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    kw = dict(log10_rho_bounds=(-1.2, -0.6), num_rho_nodes=3,
              num_nu_nodes=3, lanczos_steps=24, num_probes=8, device=dev)
    cuda_kernels.reset_launch_counts()
    f32 = KrylovPosteriorSurfaceRhoNu(pts, z, X, **kw)
    assert {k: v for k, v in cuda_kernels.launch_counts.items() if v} == {
        "matern_general_elementwise": 3}
    cuda_kernels.reset_launch_counts()
    f64 = KrylovPosteriorSurfaceRhoNu(pts, z, X, node_dtype=F64, **kw)
    assert not any(cuda_kernels.launch_counts.values())
    for lr in f32.log10_rho_nodes:
        for nu in np.exp(f32.log_nu_nodes):
            for le in (1.0, 2.0, 3.0):
                a = float(f32.profile_loglik(le, lr, nu))
                b = float(f64.profile_loglik(le, lr, nu))
                assert np.isfinite(a) and abs(a - b) < 3.0, (le, lr, nu)


@pytest.mark.parametrize("kind", ["eta_rho", "rho_nu"])
def test_surface_vmap_equals_pointwise_at_64_chains(dev, kind):
    """The bounded targets of both Krylov surfaces on the card (float32
    nodes: n = 400 random points at nu = 1/2, 12 nodes; a 24 x 24 grid,
    3 x 3 (rho, nu) nodes), their values and gradients vmapped over 64
    points as the samplers' chains see them, against each point's lone
    evaluation: values at rtol 1e-14, gradients within 1e-10 of the
    point's largest component. Not bit for bit: at 64 chains the batch's
    gradients part from the lone ones by up to 5e-12 with the surfaces'
    column solve and with an unrolled one alike (chip_profile.py
    solve-turns: 1.7e-12 and 5.8e-13 on phase 35's target, 5.0e-12 with
    either on phase 36's)."""
    from gppe_tpu_torch.models import hmc
    if kind == "eta_rho":
        pts = np.random.RandomState(0).rand(400, 2)
        surface_cls, dim = KrylovPosteriorSurface, 2
        kw = dict(nu=0.5, log10_rho_bounds=(-1.5, -0.5), num_nodes=12,
                  lanczos_steps=32, num_probes=12)
        target = dict(log10_eta_bounds=(-3.0, 3.0))
    else:
        pts = data_utils.generate_points(24, dimension=2)
        surface_cls, dim = KrylovPosteriorSurfaceRhoNu, 3
        kw = dict(log10_rho_bounds=(-1.2, -0.6), num_rho_nodes=3,
                  num_nu_nodes=3, lanczos_steps=24, num_probes=8)
        target = dict(log10_eta_bounds=(0.5, 4.0),
                      log_prior=hmc._reference_prior)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    surface = surface_cls(pts, z, X, device=dev, **kw)
    f = surface.make_bounded_log_posterior(**target)[0]
    g = torch.Generator(device=dev).manual_seed(0)
    u = 0.5 * torch.randn((64, dim), generator=g, dtype=F64, device=dev)
    grads, vals = torch.func.vmap(torch.func.grad_and_value(f))(u)
    for c in range(64):
        grad, val = torch.func.grad_and_value(f)(u[c])
        np.testing.assert_allclose(vals[c].item(), val.item(), rtol=1e-14,
                                   atol=1e-14)
        np.testing.assert_allclose(
            grads[c].cpu().numpy(), grad.cpu().numpy(), rtol=0,
            atol=1e-10 * float(torch.max(torch.abs(grad))))


def test_hmc_chunked_resume_bits_on_the_card(dev):
    """models.hmc on the card: the dense (eta, rho) sampler at n = 64, 4
    chains, its generator on the card: chunk_steps never changes the bits,
    and a resume from a saved state (a CUDA generator's state through a
    pickle) equals the unbroken run's last steps bit for bit."""
    from gppe_tpu_torch.models import hmc
    from gppe_tpu_torch.utils import checkpoint
    pts = data_utils.generate_points(8, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    kw = dict(num_chains=4, num_warmup=10, num_leapfrog=5,
              support_log10=((-3.0, 4.0), (-2.0, 0.0)), device=dev)
    whole = hmc.sample_posterior(pts, z, X, num_samples=12, **kw)
    assert whole.samples.is_cuda and bool(torch.isfinite(whole.samples).all())
    chunked = hmc.sample_posterior(pts, z, X, num_samples=12, chunk_steps=7,
                                   **kw)
    assert torch.equal(chunked.samples, whole.samples)
    first = hmc.sample_posterior(pts, z, X, num_samples=6, **kw)
    import pickle
    state = pickle.loads(pickle.dumps({
        k: (v if isinstance(v, bytes) else v.cpu().numpy())
        for k, v in first.state().items()}))
    more = hmc.sample_posterior(pts, z, X, num_samples=6,
                                resume_state=state, **kw)
    assert torch.equal(more.samples, whole.samples[6:])


def test_sample_posterior_large_on_b2(dev):
    """sample_posterior_large at n = 4096 random points on the card: the
    surface's nodes on the multi-rho kernel (its launches counted), 16
    chains sampled with no kernel launch, finite samples in the box,
    accept rate above 0.5."""
    from gppe_tpu_torch.models import hmc
    rng = np.random.RandomState(7)
    pts = rng.rand(4096, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    cuda_kernels.reset_launch_counts()
    surface = KrylovPosteriorSurface(pts, z, X, nu=0.5, num_nodes=8,
                                     lanczos_steps=32, num_probes=12,
                                     device=dev)
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] > 0
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] > 0
    cuda_kernels.reset_launch_counts()
    res, _ = hmc.sample_posterior_large(pts, z, X, num_chains=16,
                                        num_samples=30, num_warmup=30,
                                        surface=surface)
    assert not any(cuda_kernels.launch_counts.values())
    s = res.samples
    assert s.is_cuda and bool(torch.isfinite(s).all())
    assert bool(((s[..., 0] > -3) & (s[..., 0] < 3)).all())
    assert bool(((s[..., 1] > -1.5) & (s[..., 1] < -0.5)).all())
    assert float(res.accept_rate.mean()) > 0.5


_COV_PREC = np.linalg.inv(np.array([[1.0, 0.6], [0.6, 2.0]]))


def _gauss(x):
    """A correlated 2-D Gaussian, elementwise: a chain's value and gradient
    the same bits alone and in a batch."""
    d0, d1 = x[0] - 1.0, x[1] + 2.0
    return -0.5 * (_COV_PREC[0, 0] * d0 * d0 + 2.0 * _COV_PREC[0, 1] * d0 * d1
                   + _COV_PREC[1, 1] * d1 * d1)


def test_nuts_resume_bits_on_the_card(dev):
    """models.nuts on the card, its generator on the card: the dense (eta,
    rho) sampler at n = 64, 4 chains, max_depth 6; a resume from a saved
    state (a CUDA generator's state through a pickle) equals the unbroken
    run's last steps bit for bit."""
    import pickle

    from gppe_tpu_torch.models import nuts
    pts = data_utils.generate_points(8, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    kw = dict(num_chains=4, num_warmup=10, max_depth=6,
              support_log10=((-3.0, 4.0), (-2.0, 0.0)), device=dev)
    whole = nuts.sample_posterior(pts, z, X, num_samples=12, **kw)
    assert whole.samples.is_cuda and bool(torch.isfinite(whole.samples).all())
    first = nuts.sample_posterior(pts, z, X, num_samples=6, **kw)
    assert torch.equal(first.samples, whole.samples[:6])
    state = pickle.loads(pickle.dumps({
        k: (v if isinstance(v, bytes) else v.cpu().numpy())
        for k, v in first.state().items()}))
    more = nuts.sample_posterior(pts, z, X, num_samples=6,
                                 resume_state=state, **kw)
    assert torch.equal(more.samples, whole.samples[6:])
    assert more.final_generator_state == whole.final_generator_state


def test_nuts_chains_independent_on_the_card(dev):
    """models.nuts on the card on the Gaussian target: 3 chains together
    equal each chain alone on its own rows of the same draws, bit for bit,
    and the run that reads no loop condition on the host (every leaf up to
    max_depth, the stopped chains masked) equals the one that does."""
    from gppe_tpu_torch.models import hmc, nuts
    g = torch.Generator(device=dev).manual_seed(5)
    steps, max_depth = 20, 5
    draws = [nuts._draws(g, 3, 2, max_depth, F64, dev) for _ in range(steps)]
    init = 0.5 * torch.randn((3, 2), generator=g, dtype=F64, device=dev)
    gv = hmc._batched(_gauss, "rev", F64)

    def run(theta, blocks, early_exit=True):
        carry = nuts._nuts_carry0(gv, theta, 0.1, None)
        return nuts._sample_loop(gv, carry, 10, steps - 10, max_depth, 0.8,
                                 lambda it: blocks[it], early_exit)
    together = run(init, draws)
    assert together.samples.is_cuda
    for c in range(3):
        alone = run(init[c:c + 1],
                    [tuple(a[c:c + 1] for a in block) for block in draws])
        assert torch.equal(alone.samples[:, 0], together.samples[:, c])
        assert torch.equal(alone.step_size[0], together.step_size[c])
    full = run(init, draws, early_exit=False)
    assert torch.equal(full.samples, together.samples)
    assert torch.equal(full.accept_rate, together.accept_rate)
    assert set(full.leaves_per_step) == {2 ** max_depth - 1}


# -- the multi-device slice (gppe_tpu_torch.parallel) on the card -------------

def _staging_rank():
    """A gloo rank on the shared card: every collective of the mesh moves
    its CUDA operands through host buffers and counts the bytes."""
    from gppe_tpu_torch.parallel import mesh as par_mesh
    mesh = par_mesh.make_mesh(device="cuda")
    rank = mesh.rank
    x = torch.full((1000, 3), float(rank + 1), device=mesh.device)
    total = mesh.all_reduce(x, "block")
    gathered = mesh.all_gather(x[:10], "block")
    received = mesh.ring_start(x).wait()
    flag = mesh.all_reduce(torch.tensor([rank], dtype=torch.int32,
                                        device=mesh.device), "block",
                           op="max")
    return {"staged": mesh.staged, "bytes": mesh.staged_bytes,
            "copies": mesh.staged_copies,
            "devices": [str(t.device) for t in (total, gathered, received)],
            "total": total.cpu().numpy(), "gathered": gathered.cpu().numpy(),
            "received": received.cpu().numpy(), "x": x.cpu().numpy(),
            "flag": int(flag[0]), "rank": rank}


def test_mesh_host_staging_round_trip(dev):
    """Two gloo ranks on one card: sum, gather, ring and max come back on
    the card with the right values, each operand one host copy each way
    (12,000 + 12,000 bytes the sum, 120 + 240 the gather, 12,000 + 12,000
    the ring, 4 + 4 the max)."""
    from gppe_tpu_torch.parallel import mesh as par_mesh
    r0, r1 = par_mesh.spawn(_staging_rank, 2, "gloo")
    for r, other in ((r0, r1), (r1, r0)):
        assert r["staged"] and all(d.startswith("cuda") for d in r["devices"])
        np.testing.assert_array_equal(r["total"], np.full((1000, 3), 3.0))
        np.testing.assert_array_equal(
            r["gathered"], np.concatenate([r0["x"][:10], r1["x"][:10]]))
        np.testing.assert_array_equal(r["received"], other["x"])
        assert r["flag"] == 1
        assert r["copies"] == 8
        assert r["bytes"] == 2 * 12000 + 120 + 240 + 2 * 12000 + 8


def _nccl_rank(n, r):
    """World 1 on NCCL: the ring and the all-gather products (no transfer
    at one block) against the kernel's own call, and the mesh's sum."""
    from gppe_tpu_torch.parallel import mesh as par_mesh
    from gppe_tpu_torch.parallel import sharded
    mesh = par_mesh.make_mesh(device="cuda")
    g = torch.Generator(device=mesh.device).manual_seed(3)
    pts = torch.rand((n, 2), generator=g, device=mesh.device)
    V = torch.randn((n, r), generator=g, device=mesh.device)
    scale = torch.full((2,), 0.1, device=mesh.device)
    want = cuda_kernels.matern_matmat(pts, scale, V, 0.5)
    out = {"backend": mesh.backend, "staged": mesh.staged}
    for comm, fn in (("ring", sharded.ring_matern_matmat),
                     ("allgather", sharded.allgather_matern_matmat)):
        out[comm] = bool(torch.equal(fn(mesh, pts, pts, scale, V, 0.5),
                                     want))
    s = mesh.all_reduce(V[:4], "block")
    out["sum_equal"] = bool(torch.equal(s, V[:4]))
    torch.cuda.synchronize()
    return out


def test_world1_nccl_ring(dev):
    from gppe_tpu_torch.parallel import mesh as par_mesh
    (r,) = par_mesh.spawn(_nccl_rank, 1, "nccl", 4096, 24)
    assert r == {"backend": "nccl", "staged": False, "ring": True,
                 "allgather": True, "sum_equal": True}


def test_rect_trace_at_a_ring_block(dev):
    """B1's trace on the rectangular walk of a world-2 ring block (8,192
    rows against 16,384 columns) against its plain float64 version, and
    the two halves' rectangles summing to the square trace."""
    g = torch.Generator(device=dev).manual_seed(5)
    pts = torch.rand((16384, 2), generator=g, device=dev)
    halves = [cuda_kernels.matern_matmat(pts[i:i + 8192], 0.1, None, 0.5,
                                         points_cols=pts, frobenius=True)[1]
              for i in (0, 8192)]
    want = cuda_kernels.matern_matmat_plain(
        pts[:8192].double(), 0.1, None, 0.5, points_cols=pts.double(),
        frobenius=True)[1]
    assert abs(float(halves[0]) - float(want)) < 1e-5 * float(want)
    square = cuda_kernels.matern_matmat(pts, 0.1, None, 0.5,
                                        frobenius=True)[1]
    assert abs(float(sum(halves)) - float(square)) < 1e-5 * float(square)


def test_noise_sweep_on_the_card(dev):
    """compare_various_noise_level.sweep on the card (K in float32, its
    float64 eigendecomposition and the batch's rotation on the card)
    against the CPU's float64 sweep, 10 x 10 points, 12 levels, the
    degree-2 basis: the same lanes take a boundary, the rest within
    5e-2 (eta) and 5e-3 (sigma, sigma0, gcv_sigma0), the card-against-CPU
    bounds of the engines."""
    from gppe_tpu_torch.drivers import compare_various_noise_level as drv
    pts = data_utils.generate_points(10, dimension=2)
    X = data_utils.generate_basis_functions(pts, 2)
    levels = np.logspace(-2, 1, 12)
    card = drv.sweep(pts, X, levels, device=dev)
    cpu = drv.sweep(pts, X, levels, device="cpu")
    for key, rtol in (("eta", 5e-2), ("sigma", 5e-3), ("sigma0", 5e-3),
                      ("gcv_sigma0", 5e-3)):
        got, want = card[key], cpu[key]
        boundary = ~np.isfinite(want) | (want == 0)
        np.testing.assert_array_equal(got[boundary], want[boundary])
        np.testing.assert_allclose(got[~boundary], want[~boundary],
                                   rtol=rtol, err_msg=key)


def test_grid_chunk_profile_on_the_card(dev, tmp_path):
    """profile_grid_chunk.main at its defaults on the card (n = 100,000, 8
    rhos, k = 40; ~13 s): every product one launch of B2's tensor-core
    kernel (2 in the warm chunk, 3 x 40 timed), its trace kernel once a
    chunk (2), every derived cost finite and not negative, the full chunk
    at least the base Lanczos, the file only at out_path. At much smaller
    sizes the reorthogonalisation and the projections (~50 ms each here)
    fall within the clock's noise."""
    from gppe_tpu_torch.drivers import profile_grid_chunk
    path = tmp_path / "profile.json"
    out = profile_grid_chunk.main(out_path=str(path), verbose=False,
                                  device=dev)
    assert out["launches"] == {"matern_matmat_multirho_mma": 2 + 3 * 40,
                               "matern_matmat_multirho": 2}
    assert path.is_file()
    assert all(np.isfinite(v) and v >= 0 for v in out["derived"].values()), \
        out
    assert out["full_factorize_chunk"] >= out["lanczos_ps_True_reorth_True"]
