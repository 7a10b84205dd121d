"""gppe_tpu_torch's spectral likelihoods, root finding, trust region, GCV
and traceinv interpolation vs gppe_tpu's, on the CPU in float64 (the JAX
package under x64, tests/conftest.py).

The problem is tests/test_end_to_end.py's: a 20 x 20 grid (n = 400),
noise 0.2, degree-2 basis, Matern nu = 1/2 at rho = 0.1. Both packages
get the same SpectralData (the reference's eigenbasis, handed to the port
as float64 tensors), so the likelihood math alone is compared.
Tolerances: values, derivatives and Hessians rtol 1e-9 (the same float64
formulas, summed in another order); roots and optima rtol 1e-7.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import direct_likelihood as jdl  # noqa: E402
from gppe_tpu.models import gcv as jgcv  # noqa: E402
from gppe_tpu.models import profile_likelihood as jpl  # noqa: E402
from gppe_tpu.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation as JMixed)
from gppe_tpu.ops import interpolate as jinterp  # noqa: E402
from gppe_tpu.ops import optimize as jopt  # noqa: E402
from gppe_tpu.ops import root_finding as jroot  # noqa: E402
from gppe_tpu_torch.models import direct_likelihood as tdl  # noqa: E402
from gppe_tpu_torch.models import gcv as tgcv  # noqa: E402
from gppe_tpu_torch.models import profile_likelihood as tpl  # noqa: E402
from gppe_tpu_torch.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation as TMixed)
from gppe_tpu_torch.ops import interpolate as tinterp  # noqa: E402
from gppe_tpu_torch.ops import optimize as topt  # noqa: E402
from gppe_tpu_torch.ops import root_finding as troot  # noqa: E402
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts six test workers on the host's cores: torch's
    own pool of one thread per core in each worker made these small
    problems ~15x slower there. One thread for this module, restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

HYPERPARAMS = [(0.05, 0.2), (0.3, 0.1), (1.0, 1e-3), (1e-9, 0.2)]


@pytest.fixture(scope="module")
def problem():
    pts = data_utils.generate_points(20, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)) / 0.1
    return np.exp(-d), X, z


@pytest.fixture(scope="module")
def data(problem):
    K, X, z = problem
    jdata = jdl.make_spectral_data(JMixed(jnp.asarray(K)), X, z)
    tdata = tdl.SpectralData(*(torch.as_tensor(np.array(a))
                               for a in jdata))
    return jdata, tdata


@pytest.mark.parametrize("hp", HYPERPARAMS)
def test_direct_lp_jacobian_hessian(data, hp):
    jdata, tdata = data
    np.testing.assert_allclose(float(tdl.log_likelihood(tdata, *hp)),
                               float(jdl.log_likelihood(jdata, *hp)),
                               rtol=1e-9)
    if hp[0] < 1e-8:
        return      # the analytic forms have no degenerate branch
    np.testing.assert_allclose(
        tdl.log_likelihood_jacobian(tdata, *hp).numpy(),
        np.asarray(jdl.log_likelihood_jacobian(jdata, *hp)), rtol=1e-9)
    np.testing.assert_allclose(
        tdl.log_likelihood_hessian(tdata, *hp).numpy(),
        np.asarray(jdl.log_likelihood_hessian(jdata, *hp)), rtol=1e-8,
        atol=1e-8)


def test_autodiff_matches_analytic_jacobian(data):
    """torch.func.grad of lp in (sigma, sigma0) equals the analytic
    sigma^2-coordinate jacobian times the chain factor 2 sigma."""
    _, tdata = data
    hp = torch.tensor([0.07, 0.19], dtype=torch.float64)
    g = torch.func.grad(lambda h: tdl.log_likelihood(tdata, h[0], h[1]))(hp)
    jac = tdl.log_likelihood_jacobian(tdata, 0.07, 0.19)
    np.testing.assert_allclose(g.numpy(), (2 * hp * jac).numpy(), rtol=1e-8)


def test_degenerate_branch_has_finite_gradient(data):
    _, tdata = data
    hp = torch.tensor([0.0, 0.2], dtype=torch.float64)
    g = torch.func.grad(lambda h: tdl.log_likelihood(tdata, h[0], h[1]))(hp)
    assert bool(torch.isfinite(g).all())


def test_direct_mle_matches(data):
    jdata, tdata = data
    want = jdl.maximize_log_likelihood(jdata)
    got = tdl.maximize_log_likelihood(tdata)
    assert got["success"] and got["iterations"] == want["iterations"]
    for k in ("sigma", "sigma0", "eta", "max_lp"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, err_msg=k)


def test_profile_der1_vectorized(data):
    """A (3, 5) tensor of log-etas in one call equals the reference's
    vmapped der1, element by element."""
    jdata, tdata = data
    log_eta = np.linspace(-3.5, 2.5, 15).reshape(3, 5)
    got = tpl.log_likelihood_der1_eta(tdata, torch.as_tensor(log_eta))
    want = np.asarray(jpl.log_likelihood_der1_eta(jdata,
                                                  jnp.asarray(log_eta)))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-10)
    scalar = tpl.log_likelihood_der1_eta(tdata, 0.25)
    assert scalar.ndim == 0
    np.testing.assert_allclose(
        float(scalar), float(jpl.log_likelihood_der1_eta(jdata, 0.25)),
        rtol=1e-9)


@pytest.mark.parametrize("eta", [0.0, 1e-3, 0.5, 16.0, 300.0])
def test_profile_der2_sigma_and_lp(data, eta):
    jdata, tdata = data
    np.testing.assert_allclose(
        float(tpl.log_likelihood_der2_eta(tdata, eta)),
        float(jpl.log_likelihood_der2_eta(jdata, eta)), rtol=1e-9)
    np.testing.assert_allclose(float(tpl.find_optimal_sigma(tdata, eta)),
                               float(jpl.find_optimal_sigma(jdata, eta)),
                               rtol=1e-10)
    if eta > 0:
        np.testing.assert_allclose(
            float(tpl.log_likelihood(tdata, 0.05, eta)),
            float(jpl.log_likelihood(jdata, 0.05, eta)), rtol=1e-10)
        ub, lb = tpl.compute_bounds_der1_eta(tdata, eta)
        jub, jlb = jpl.compute_bounds_der1_eta(jdata, eta)
        np.testing.assert_allclose([float(ub), float(lb)],
                                   [float(jub), float(jlb)], rtol=1e-12)


def test_profile_boundary_pieces(problem, data):
    jdata, tdata = data
    np.testing.assert_allclose(float(tpl.find_optimal_sigma0(tdata)),
                               float(jpl.find_optimal_sigma0(jdata)),
                               rtol=1e-10)
    K, X, z = problem
    got = tpl.compute_asymptote_der1_eta(torch.as_tensor(K), X, z,
                                         [1.0, 10.0])
    want = jpl.compute_asymptote_der1_eta(K, X, z, [1.0, 10.0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-8)


def test_profile_root_finder(data):
    jdata, tdata = data
    want = jpl.find_log_likelihood_der1_zeros(jdata, [1e-4, 1e3])
    got = tpl.find_log_likelihood_der1_zeros(tdata, [1e-4, 1e3])
    assert got["success"] and got["iterations"] == want["iterations"]
    for k in ("sigma", "sigma0", "eta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["eta"], 16.2312, atol=0.05)


def test_profile_boundary_fallback(data):
    """An interval with no sign change takes the boundary optimum from the
    sign of der2 at eta = 0, as the reference does."""
    jdata, tdata = data
    want = jpl.find_log_likelihood_der1_zeros(jdata, [1e2, 1e3],
                                              num_bracket_trials=0)
    got = tpl.find_log_likelihood_der1_zeros(tdata, [1e2, 1e3],
                                             num_bracket_trials=0)
    assert got["iterations"] == 0
    assert got["eta"] == want["eta"]
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=1e-10)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-10)


def test_sigma_eta_maximization(data):
    jdata, tdata = data
    want = jpl.maximize_log_likelihood_with_sigma_eta(jdata)
    got = tpl.maximize_log_likelihood_with_sigma_eta(tdata)
    assert got["success"] == want["success"]
    for k in ("sigma", "eta", "max_lp"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, err_msg=k)


def _rosenbrock(x, lib):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2 + lib.sum(
        x[2:] ** 2)


def _rosenbrock_jax(x):
    # one function object: the reference compiles per objective
    return _rosenbrock(x, jnp)


@pytest.mark.parametrize("x0", [(-1.2, 1.0, 0.5), (2.0, -1.0, -3.0)])
def test_trust_region_minimize(x0):
    """The same iterates as the reference on a non-convex function (its
    Hessian is indefinite at the second start)."""
    want = jopt.trust_region_minimize(_rosenbrock_jax,
                                      jnp.asarray(x0), gtol=1e-8,
                                      max_iter=200)
    got = topt.trust_region_minimize(lambda x: _rosenbrock(x, torch),
                                     torch.as_tensor(x0), gtol=1e-8,
                                     max_iter=200)
    assert got.success and got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), [1.0, 1.0, 0.0], atol=1e-7)


def test_subproblem_hard_case():
    """g orthogonal to the lowest eigenvector of an indefinite H: the step
    is padded along it to the boundary, in both packages."""
    H = np.diag([-2.0, 1.0])
    g = np.array([0.0, 0.1])
    want = np.asarray(jopt._solve_subproblem(jnp.asarray(g), jnp.asarray(H),
                                             0.5))
    got = topt._solve_subproblem(torch.as_tensor(g), torch.as_tensor(H), 0.5)
    np.testing.assert_allclose(np.abs(got.numpy()), np.abs(want), rtol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(got.numpy()), 0.5, rtol=1e-6)


def test_bracket_search_and_vectorized_chandrupatla():
    def f(x):
        return np.tanh(x - 1.3) + 0.05 * x

    for bracket in ([-1.0, 0.0], [-5.0, 4.0], [2.0, 3.0]):
        assert (troot.find_interval_with_sign_change(f, bracket, 4)
                == jroot.find_interval_with_sign_change(f, bracket, 4))

    # three root problems in one call, one lane per shift
    shifts = np.array([-0.5, 0.3, 1.7])
    x0, x1 = np.full(3, -3.0), np.full(3, 4.0)
    want, want_it = jroot.chandrupatla(
        lambda x: jnp.tanh(x - jnp.asarray(shifts)), jnp.asarray(x0),
        jnp.asarray(x1), eps_m=1e-12, eps_a=1e-12)
    got, got_it = troot.chandrupatla(
        lambda x: torch.tanh(x - torch.as_tensor(shifts)), x0, x1,
        eps_m=1e-12, eps_a=1e-12)
    assert got.dtype == torch.float64 and got_it == int(want_it)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), shifts, atol=1e-10)


def test_gcv(data):
    jdata, tdata = data
    etas = np.logspace(-3, 2, 7)
    np.testing.assert_allclose(
        tgcv.gcv_function(tdata, torch.as_tensor(etas)).numpy(),
        np.asarray(jgcv.gcv_function(jdata, jnp.asarray(etas))), rtol=1e-9)
    want = jgcv.minimize_gcv(jdata)
    got = tgcv.minimize_gcv(tdata)
    for k in ("eta", "sigma0", "gcv"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind, order", [("loglog-spline", 2),
                                         ("rational", 2), ("rational", 3)])
def test_traceinv_interpolator(problem, kind, order):
    K = problem[0]
    pts = np.logspace(-4, 3, 8)
    jint = jinterp.TraceinvInterpolator(JMixed(jnp.asarray(K)), pts,
                                        kind=kind, order=order)
    tint = tinterp.TraceinvInterpolator(TMixed(K, device="cpu"), pts,
                                        kind=kind, order=order)
    np.testing.assert_allclose(tint.values, jint.values, rtol=1e-10)
    for eta in (1e-4, 3e-3, 0.7, 16.0, 999.0):
        got = tint(eta)
        assert got.dtype == torch.float64 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(jint(eta)), rtol=1e-9)
    with pytest.raises(ValueError):
        tinterp.TraceinvInterpolator(TMixed(K, device="cpu"), [-1.0, 1.0])
