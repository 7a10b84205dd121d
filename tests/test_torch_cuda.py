"""gppe_tpu_torch's CUDA kernel against its plain PyTorch version, on the
card. Every test here needs an NVIDIA GPU (sm_90a) and nvcc and skips
without them. This file imports neither JAX nor gppe_tpu, so it runs where
JAX is not installed; tests/conftest.py sets JAX up, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Bounds are those of the reference's on-chip tier
(tests_tpu/test_onchip.py): float32 distance rounding puts ~|d| eps_f32 on
each kernel entry, so the product is judged by its Frobenius-relative
error (< 2e-5) and its largest absolute error (< 5e-4); trace(K^2) to
rtol 1e-5; u.Kv vs v.Ku to 1e-6 of |u| |Kv|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu_torch.models.large_scale import (  # noqa: E402
    KrylovProfileLikelihood)
from gppe_tpu_torch.ops import cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.ops.operators import MaternOperator  # noqa: E402
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
