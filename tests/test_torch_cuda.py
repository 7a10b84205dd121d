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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu_torch.models.grid_krylov import (  # noqa: E402
    GridKrylovProfileLikelihood)
from gppe_tpu_torch.models.large_scale import (  # noqa: E402
    KrylovProfileLikelihood)
from gppe_tpu_torch.ops import cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.ops.operators import MaternOperator  # noqa: E402
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
    pts = torch.rand(300, 2, device=dev)
    V = torch.rand(300, 3, device=dev)
    cuda_kernels.reset_launch_counts()
    op = MaternOperator(pts, 0.1, device=dev)
    op.matmat(V)
    op.trace_pow(2)
    assert cuda_kernels.launch_counts["matern_matmat"] == 2
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_matmat(pts.double(), 0.1, V.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.matern_matmat(pts, 0.1, V.T.contiguous().T, 0.5)
    assert cuda_kernels.launch_counts["matern_matmat"] == 2


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
    """B = 1 against the single-scale kernel at the same rho: the two order
    their arithmetic differently, so within the bounds, not bit for bit."""
    rng = np.random.RandomState(4)
    pts = torch.as_tensor(rng.rand(3001, 2), dtype=F32, device=dev)
    V = torch.as_tensor(rng.standard_normal((3001, 16)), dtype=F32,
                        device=dev)
    got = cuda_kernels.matern_matmat_multirho(
        pts, torch.tensor([0.1], device=dev), V[None], 0.5)
    _assert_within_bounds(got[0], cuda_kernels.matern_matmat(
        pts, 0.1, V, 0.5).double())


def test_multirho_counts_launches_and_checks_inputs(dev):
    pts = torch.rand(300, 2, device=dev)
    rhos = torch.tensor([0.1, 0.2], device=dev)
    V = torch.rand(2, 300, 3, device=dev)
    cuda_kernels.reset_launch_counts()
    cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5)
    cuda_kernels.matern_matmat_multirho(pts, rhos, None, 0.5,
                                        return_frobenius=True)
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 2
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.matern_matmat_multirho(pts.double(), rhos.double(),
                                            V.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.matern_matmat_multirho(
            pts, rhos, torch.rand(2, 300, 6, device=dev)[:, :, ::2], 0.5)
    with pytest.raises(ValueError, match="d <= 8"):
        cuda_kernels.matern_matmat_multirho(
            torch.rand(300, 9, device=dev), rhos, V, 0.5)
    with pytest.raises(NotImplementedError, match="bf16x3"):
        cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5,
                                            dot_mode="bf16x3")
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 2
    assert cuda_kernels.launch_counts["matern_matmat"] == 0


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
    assert cuda_kernels.launch_counts["matern_matmat_multirho"] == 33
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
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 2
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
    with pytest.raises(NotImplementedError, match="bf16"):
        cuda_kernels.matern_matmat_blocksparse(pts, V, *args,
                                               dot_mode="bf16", **kw)
    with pytest.raises(ValueError, match="int32"):
        cuda_kernels.matern_matmat_blocksparse(
            pts, V, *args, n=n, row_ptr=op._row_ptr.long())
    assert cuda_kernels.launch_counts["matern_matmat_blocksparse"] == 2


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
