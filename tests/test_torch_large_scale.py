"""The ported n = 1024 profile-likelihood engine vs the JAX reference.

Both engines see the same data and the same random block: the test draws
the reference's own probes and deflation start (the calls of
gppe_tpu/models/large_scale.py: ``jax.random.split(PRNGKey(0))``, then
``rademacher`` and ``normal`` in float64) and hands them to the port as
``probes=`` / ``v_defl=``. The port runs on ``device="cpu"`` in float64.
Both are also held against the exact spectral answer, with the bounds of
tests_tpu/test_onchip.py::test_krylov_profile_fit_n1024.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import direct_likelihood as dl  # noqa: E402
from gppe_tpu.models import large_scale as jls  # noqa: E402
from gppe_tpu.models import profile_likelihood as pl_mod  # noqa: E402
from gppe_tpu.models.mixed_correlation import MixedCorrelation  # noqa: E402
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu_torch.models import large_scale as tls  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


N, STEPS, PROBES = 1024, 32, 16
LOG_ETAS = [-3.0, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    pts = rng.rand(N, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    return pts, z, X


@pytest.fixture(scope="module")
def engines(problem):
    pts, z, X = problem
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(0))
    probes = np.array(jax.random.rademacher(k_probe, (N, PROBES),
                                            dtype=jnp.float64))
    v_defl = np.array(jax.random.normal(k_defl, (N, 1), dtype=jnp.float64))
    jeng = jls.KrylovProfileLikelihood(
        jops.MaternOperator(pts, 0.1, nu=0.5), X, z,
        lanczos_steps=STEPS, num_probes=PROBES, key=0)
    teng = tls.KrylovProfileLikelihood(
        tops.MaternOperator(pts, 0.1, nu=0.5, device="cpu",
                            dtype=torch.float64), X, z,
        lanczos_steps=STEPS, num_probes=PROBES, device="cpu",
        dtype=torch.float64, probes=probes, v_defl=v_defl)
    return jeng, teng


@pytest.fixture(scope="module")
def fits(engines):
    jeng, teng = engines
    return jeng.fit(), teng.fit()


@pytest.fixture(scope="module")
def spectral(problem):
    pts, z, X = problem
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / 0.1
    data = dl.make_spectral_data(MixedCorrelation(jnp.asarray(np.exp(-d))),
                                 X, z)
    return pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])


def test_factorization_matches(engines):
    jeng, teng = engines
    for name in ("alphas", "betas", "U", "G", "rhs_norms", "AtA"):
        np.testing.assert_allclose(getattr(teng, name), getattr(jeng, name),
                                   rtol=1e-8, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(teng.traces.nodes, jeng.traces.nodes,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(teng.traces.weights, jeng.traces.weights,
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("log_eta", LOG_ETAS)
def test_der1_matches(engines, log_eta):
    jeng, teng = engines
    np.testing.assert_allclose(teng.der1(log_eta), jeng.der1(log_eta),
                               rtol=1e-6)


def test_der2_at_zero_matches(engines):
    jeng, teng = engines
    np.testing.assert_allclose(teng.der2(0.0), jeng.der2(0.0), rtol=1e-6)


def test_fit_matches(fits):
    jfit, tfit = fits
    assert tfit["success"] and jfit["success"]
    np.testing.assert_allclose(tfit["eta"], jfit["eta"], rtol=1e-6)
    np.testing.assert_allclose(tfit["sigma0"], jfit["sigma0"], rtol=1e-6)
    np.testing.assert_allclose(tfit["sigma"], jfit["sigma"], rtol=1e-6)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_fit_vs_spectral_oracle(fits, spectral, which):
    got = fits[0] if which == "jax" else fits[1]
    np.testing.assert_allclose(got["eta"], spectral["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], spectral["sigma0"], rtol=5e-3)


def test_own_random_block_fit(problem, spectral):
    """Without a carried-over block the port draws its own probes from a
    seeded torch.Generator; the fit still lands on the spectral answer."""
    pts, z, X = problem
    op = tops.MaternOperator(pts, 0.1, nu=0.5, device="cpu",
                             dtype=torch.float64)
    gen = torch.Generator(device="cpu").manual_seed(3)
    eng = tls.KrylovProfileLikelihood(op, X, z, lanczos_steps=STEPS,
                                      num_probes=PROBES, device="cpu",
                                      dtype=torch.float64, generator=gen)
    got = eng.fit()
    assert got["success"]
    np.testing.assert_allclose(got["eta"], spectral["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], spectral["sigma0"], rtol=5e-3)


def test_dense_operator_and_tridiag_solves(problem):
    """A dense K tensor is accepted as the operator (no trace_pow), and the
    tridiagonal solves are the reference's."""
    pts, z, X = problem
    n = 200
    d = np.sqrt(((pts[:n, None, :] - pts[None, :n, :]) ** 2).sum(-1)) / 0.1
    K = torch.as_tensor(np.exp(-d))
    eng = tls.KrylovProfileLikelihood(K, X[:n], z[:n], lanczos_steps=12,
                                      num_probes=4, device="cpu",
                                      dtype=torch.float64, key=1)
    assert np.isfinite(eng.der1(0.0))
    rng = np.random.RandomState(9)
    a, b, rhs = rng.rand(12) + 2.0, rng.rand(11), rng.rand(12)
    np.testing.assert_array_equal(tls._tridiag_solve(a, b, 0.3, rhs),
                                  jls._tridiag_solve(a, b, 0.3, rhs))
    np.testing.assert_array_equal(tls._tridiag_solve_e1(a, b, 0.3, 2.0),
                                  jls._tridiag_solve_e1(a, b, 0.3, 2.0))


def test_engine_rejects_operator_on_another_device(problem):
    pts, z, X = problem
    op = tops.MaternOperator(pts[:64], 0.1, device="cpu")
    with pytest.raises(ValueError, match="operator is on"):
        tls.KrylovProfileLikelihood(op, X[:64], z[:64], lanczos_steps=4,
                                    num_probes=2, device="meta")
