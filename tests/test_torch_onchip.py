"""The on-chip tier: the production paths of gppe_tpu_torch on the card.

The port's mirror of the reference's nine on-chip tests
(tests_tpu/test_onchip.py), with their tolerances: the hand-written
kernels compiled for the card, float32 device math, float64 inference
scalars, small n throughout (the cost is the first build, not the
compute). Every test needs an NVIDIA GPU (sm_90a) and nvcc and skips
without them. This file imports neither JAX nor gppe_tpu; tests/conftest.py
sets JAX up, so skip it where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_onchip.py -q

``GPPE_SKIP_HEAVY=1`` skips the n = 2^20 FFT-grid smoke, as the
reference's tier does.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu_torch.models import direct_likelihood as dl  # noqa: E402
from gppe_tpu_torch.models import profile_likelihood as pl_mod  # noqa: E402
from gppe_tpu_torch.models.large_scale import (  # noqa: E402
    KrylovProfileLikelihood)
from gppe_tpu_torch.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation)
from gppe_tpu_torch.ops import cuda_kernels, kernels, operators  # noqa: E402
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402

pytestmark = pytest.mark.cuda
F32, F64 = torch.float32, torch.float64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def problem_1k():
    rng = np.random.RandomState(0)
    pts = rng.rand(1024, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    return pts, z, X


def host_k(pts, rho=0.1):
    """float64 exp(-d / rho) on the host: K at nu = 1/2."""
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / rho
    return np.exp(-d)


def test_b1_product_matches_host_f64(dev, problem_1k):
    """B1 (matern_matmat, the tensor-core kernel, 'highest') against the
    host float64 dense K @ V: float32 distance rounding puts
    ~|d| eps_f32 ~ 4e-6 on each entry, so judged by norm."""
    pts, _, _ = problem_1k
    V = np.asarray(np.random.RandomState(1).standard_normal((1024, 7)),
                   np.float32)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.matern_matmat(
        torch.as_tensor(pts, dtype=F32, device=dev), 0.1,
        torch.as_tensor(V, device=dev), 0.5).double().cpu().numpy()
    assert cuda_kernels.launch_counts["matern_matmat_mma"] == 1
    want = host_k(pts) @ V.astype(np.float64)
    frob = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert frob < 2e-5, frob
    assert np.max(np.abs(got - want)) < 5e-4


def test_bf16x3_symmetry_bound(dev, problem_1k):
    """u.(K v) against v.(K u): 'highest' symmetric to 1e-6 relative,
    'bf16x3' (bf16 operands) to 5e-5."""
    pts, _, _ = problem_1k
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    rng = np.random.RandomState(2)
    u = torch.as_tensor(rng.standard_normal((1024, 1)), dtype=F32,
                        device=dev)
    v = torch.as_tensor(rng.standard_normal((1024, 1)), dtype=F32,
                        device=dev)
    for mode, tol in [("highest", 1e-6), ("bf16x3", 5e-5)]:
        Kv = cuda_kernels.matern_matmat(P, 0.1, v, 0.5, dot_mode=mode)
        Ku = cuda_kernels.matern_matmat(P, 0.1, u, 0.5, dot_mode=mode)
        a = float(u[:, 0].double() @ Kv[:, 0].double())
        b = float(v[:, 0].double() @ Ku[:, 0].double())
        assert abs(a - b) / max(abs(a), 1.0) < tol, (mode, a, b)


def test_krylov_profile_fit_n1024(dev, problem_1k):
    """The profile MLE on the card (MaternOperator on B1, float32 Lanczos,
    float64 scalars) against the float64 spectral answer on the same K."""
    pts, z, X = problem_1k
    op = operators.MaternOperator(pts, 0.1, nu=0.5, device=dev)
    got = KrylovProfileLikelihood(op, X, z, lanczos_steps=32, num_probes=16,
                                  device=dev).fit()
    K = torch.as_tensor(host_k(pts), device=dev)
    data = dl.make_spectral_data(MixedCorrelation(K, device=dev), X, z)
    want = pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])
    assert got["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=5e-3)


def test_grid_krylov_multirho_chunk(dev, problem_1k):
    """One matrix-free chunk on the multi-rho kernel (B2): each point's fit
    against a fresh single-operator engine at the same rho."""
    from gppe_tpu_torch.models.grid_krylov import (
        GridKrylovProfileLikelihood)

    pts, z, X = problem_1k
    rhos = np.asarray([0.08, 0.1, 0.15])
    cuda_kernels.reset_launch_counts()
    g = GridKrylovProfileLikelihood(pts, X, z, rhos, np.full(3, 0.5),
                                    nu_static=0.5, lanczos_steps=32,
                                    num_probes=8, matrix_free=True, chunk=3,
                                    device=dev)
    assert cuda_kernels.launch_counts["matern_matmat_multirho_mma"] == 32
    results = g.fit_all()
    assert len(results) == 3
    for r, rho in zip(results, rhos):
        op = operators.MaternOperator(pts, float(rho), nu=0.5, device=dev)
        ref = KrylovProfileLikelihood(op, X, z, lanczos_steps=32,
                                      num_probes=16, device=dev).fit()
        if np.isfinite(ref["eta"]) and ref["eta"] > 0:
            np.testing.assert_allclose(r["eta"], ref["eta"], rtol=0.1)
        np.testing.assert_allclose(r["sigma0"], ref["sigma0"], rtol=1e-2)


def test_traced_nu_matern_f32_finite(dev):
    """The float32 general-nu Matern across the samplers' nu range, finite
    and in [0, 1]: the traced nu of kernels.matern (a tensor nu) and the
    general-nu kernel's elementwise entry (G1)."""
    x = torch.as_tensor(np.geomspace(1e-5, 20, 256), dtype=F32, device=dev)
    for nu in [3.5, 10.0, 24.9]:
        for k in (kernels.matern(x, torch.tensor(nu, dtype=F32)),
                  cuda_kernels.matern_general(x, nu)):
            k = k.cpu().numpy()
            assert k.dtype == np.float32
            assert np.all(np.isfinite(k)), nu
            assert np.all((k >= 0) & (k <= 1.0)), nu


def test_sharded_step_one_rank(dev, problem_1k, tmp_path):
    """The sharded profile step on a one-rank NCCL mesh (B1's product on
    its rectangular form): traceinv and logdet against the host float64
    eigenvalues."""
    import torch.distributed as dist

    from gppe_tpu_torch.parallel import mesh as mesh_mod
    from gppe_tpu_torch.parallel import sharded

    if dist.is_initialized():
        pytest.skip("a process group is already initialised")
    pts, z, X = problem_1k
    n = pts.shape[0]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh(1, device="cuda")
        step = sharded.build_sharded_profile_step(mesh, nu=0.5,
                                                  lanczos_steps=30)
        probes = np.random.default_rng(0).choice([-1.0, 1.0], size=(n, 16))
        der1, ti, ld = step(pts, [0.1, 0.1], X, z, probes,
                            np.asarray([0.3, 3.0, 30.0]))
    finally:
        dist.destroy_process_group()
    lam = np.linalg.eigvalsh(host_k(pts))
    assert np.all(np.isfinite(der1))
    for i, eta in enumerate([0.3, 3.0, 30.0]):
        want_ti = (1.0 / (lam + eta)).sum()
        want_ld = np.log(lam + eta).sum()
        assert abs(ti[i] - want_ti) / want_ti < 0.1, (eta, ti[i], want_ti)
        assert abs(ld[i] - want_ld) / n < 0.05, (eta, ld[i], want_ld)


def test_fft_grid_operator_f32(dev):
    """GridMaternOperator on the card at a general nu (its float32 table on
    G1's elementwise entry, products on cuFFT): matmat against float64
    dense K @ V, and the profile fit against the float64 spectral
    answer."""
    pts = data_utils.generate_points(32, dimension=2)     # n = 1024 grid
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    op = operators.GridMaternOperator(pts, 0.1, nu=2.2, device=dev)
    V = np.asarray(np.random.RandomState(4).standard_normal((1024, 5)),
                   np.float32)
    got = op.matmat(torch.as_tensor(V, device=dev)).double().cpu().numpy()
    K = op.dense().double()
    want = K.cpu().numpy() @ V.astype(np.float64)
    frob = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert frob < 2e-5, frob

    got_fit = KrylovProfileLikelihood(op, X, z, lanczos_steps=48,
                                      num_probes=16, device=dev).fit()
    data = dl.make_spectral_data(MixedCorrelation(K, device=dev), X, z)
    want_fit = pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])
    np.testing.assert_allclose(got_fit["eta"], want_fit["eta"], rtol=0.1)
    np.testing.assert_allclose(got_fit["sigma0"], want_fit["sigma0"],
                               rtol=1e-2)


def test_fft_grid_fit_n2e20_smoke(dev):
    """The exact FFT-grid Krylov fit at n = 2^20 on the card, lean (k = 32,
    8 probes): a does-the-hot-path-run check, not a benchmark."""
    if os.environ.get("GPPE_SKIP_HEAVY") == "1":
        pytest.skip("GPPE_SKIP_HEAVY=1")
    pts = data_utils.generate_points(1024, dimension=2)   # n = 2^20
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    t0 = time.perf_counter()
    op = operators.GridMaternOperator(pts, 0.005, nu=0.5, device=dev)
    res = KrylovProfileLikelihood(op, X, z, lanczos_steps=32, num_probes=8,
                                  device=dev).fit()
    total = time.perf_counter() - t0
    assert res["success"]
    assert np.isfinite(res["eta"]) and 1.0 < res["eta"] < 1e3, res
    assert res["sigma0"] > 0
    assert total < 600, total


def test_chunked_hmc_on_rho_nu_surface(dev):
    """HMC in chunks of 8 steps on the (rho, nu) FFT posterior surface
    (float32 nodes on the card, tables on G1's elementwise entry), the
    adaptation carried across the chunks."""
    from gppe_tpu_torch.models import hmc
    from gppe_tpu_torch.models.krylov_posterior import (
        KrylovPosteriorSurfaceRhoNu)

    pts = data_utils.generate_points(32, dimension=2)     # n = 1024 grid
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    surface = KrylovPosteriorSurfaceRhoNu(
        pts, z, X, log10_rho_bounds=(-1.2, -0.6), nu_bounds=(1.0, 25.0),
        num_rho_nodes=5, num_nu_nodes=6, lanczos_steps=24, num_probes=8,
        key=3, device=dev)
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=(-2.0, 3.0))
    g = torch.Generator(device=dev).manual_seed(0)
    init = 0.3 * torch.randn((4, 3), generator=g, dtype=F64, device=dev)
    res = hmc.hmc_sample(log_post, init, torch.Generator(
        device=dev).manual_seed(1), num_samples=12, num_warmup=12,
        num_leapfrog=6, chunk_steps=8)
    s = torch.func.vmap(torch.func.vmap(u_to_theta))(res.samples)
    s = s.cpu().numpy()
    assert s.shape == (12, 4, 3)
    assert np.all(np.isfinite(s))
    assert np.all((s[..., 2] >= 1.0) & (s[..., 2] <= 25.0))
    assert float(res.accept_rate.mean()) > 0.2
