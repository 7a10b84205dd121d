"""gppe_tpu_torch.GaussianProcess(X, K, method).train(z) vs gppe_tpu's, on
the CPU in float64 (the JAX package under x64, tests/conftest.py).

The problem is tests/test_end_to_end.py's (20 x 20 grid, n = 400, noise
0.2, degree-2 basis, Matern nu = 1/2, rho = 0.1); each package assembles
its own K from the same points. Tolerances:

* the spectral route (imate_method 'eigenvalue', with or without
  interpolate): eta, sigma and sigma0 rtol 1e-6, lp rtol 1e-10, and the
  known optimum of tests/test_end_to_end.py (eta 16.2312 +- 0.05, sigma0
  0.20385 +- 5e-4);
* the Krylov route ('cholesky', 'slq', 'hutchinson' on the dense K, and a
  MaternOperator K): each package draws its own probes, so the fits agree
  to the estimator's accuracy, eta rtol 2e-2 and sigma0 rtol 1e-3, with
  each other and with the spectral optimum; lp through Cholesky rtol
  1e-9; lp through SLQ with the reference's own probes and deflation
  start handed in (``options``) to 1e-5 absolute (the SLQ logdet agrees
  to ~3e-7 relative, tests/test_torch_stochastic_engine.py).
"""

import os
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse  # noqa: E402

import gppe_tpu  # noqa: E402
import gppe_tpu_torch  # noqa: E402
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu_torch.drivers import (  # noqa: E402
    maximize_likelihood_direct_method as tdriver)
from gppe_tpu_torch.models.large_scale import (  # noqa: E402
    KrylovProfileLikelihood)
from gppe_tpu_torch.ops.operators import MaternOperator  # noqa: E402
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    pts = data_utils.generate_points(20, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    jK = gppe_tpu.generate_correlation(pts, 0.1, nu=0.5)
    tK = gppe_tpu_torch.generate_correlation(pts, 0.1, nu=0.5, dtype=F64,
                                             **CPU)
    return pts, z, X, jK, tK


@pytest.fixture(scope="module")
def spectral_fits(problem):
    _, z, X, jK, tK = problem
    fits = {}
    for m in ("direct", "profiled"):
        fits[m] = (gppe_tpu.GaussianProcess(X, jK, m).train(z),
                   gppe_tpu_torch.GaussianProcess(X, tK, m, **CPU).train(z))
    return fits


def _quiet(fn, *a, **kw):
    """Run ``fn``, hiding the operator route's switch-to-slq warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*a, **kw)


@pytest.mark.parametrize("method", ["direct", "profiled"])
def test_train_matches_reference(spectral_fits, method):
    want, got = spectral_fits[method]
    assert got["success"] and want["success"]
    assert got["iterations"] == want["iterations"]
    for k in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    # the known optimum (tests/test_end_to_end.py:25-30)
    assert got["eta"] == pytest.approx(16.2312, abs=0.05)
    assert got["sigma0"] == pytest.approx(0.20385, abs=5e-4)


def test_direct_agrees_with_profiled(spectral_fits):
    got_d, got_p = spectral_fits["direct"][1], spectral_fits["profiled"][1]
    assert got_d["eta"] == pytest.approx(got_p["eta"], rel=1e-3)
    assert got_d["sigma"] == pytest.approx(got_p["sigma"], rel=1e-3)


@pytest.mark.parametrize("hp", [(0.05, 0.2), (0.3, 0.1), (1e-9, 0.2)])
def test_spectral_likelihood_matches(problem, hp):
    _, z, X, jK, tK = problem
    want = gppe_tpu.GaussianProcess(X, jK).likelihood.likelihood(z, hp)
    got = gppe_tpu_torch.GaussianProcess(X, tK, **CPU).likelihood.likelihood(
        z, hp)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_interpolate(problem, spectral_fits):
    """interpolate=True builds the traceinv interpolant; the spectral fit
    does not consult it, so eta is the eigenvalue route's."""
    _, z, X, jK, tK = problem
    jgp = gppe_tpu.GaussianProcess(X, jK, "profiled", interpolate=True)
    tgp = gppe_tpu_torch.GaussianProcess(X, tK, "profiled", interpolate=True,
                                         **CPU)
    got = tgp.train(z)
    np.testing.assert_allclose(got["eta"], spectral_fits["profiled"][1]["eta"],
                               rtol=1e-12)
    for eta in (1e-3, 0.5, 16.0):
        np.testing.assert_allclose(
            float(tgp.likelihood.K_mixed.traceinv(eta)),
            float(jgp.likelihood.K_mixed.traceinv(eta)), rtol=1e-9)


def _reference_options(n, key=0, num_probes=16):
    """The reference SLQ engine's draws for ``key``, as port options."""
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
    return {"probes": np.array(jax.random.rademacher(
                k_probe, (n, num_probes), dtype=jnp.float64)),
            "v_defl": np.array(jax.random.normal(k_defl, (n, 1),
                                                 dtype=jnp.float64))}


@pytest.mark.parametrize("imate", ["cholesky", "slq", "hutchinson"])
def test_krylov_route_on_dense_K(problem, spectral_fits, imate):
    """The dense K under these methods has no eigendecomposition: the fit
    runs the Krylov engine over the dense matrix (80 steps, 16 probes), in
    both packages; lp takes Cholesky ('cholesky', 'hutchinson') or SLQ."""
    _, z, X, jK, tK = problem
    n = X.shape[0]
    jgp = gppe_tpu.GaussianProcess(X, jK, "profiled", imate_method=imate)
    tgp = gppe_tpu_torch.GaussianProcess(
        X, tK, "profiled", imate_method=imate,
        options=_reference_options(n), **CPU)
    assert tgp.likelihood.operator_mode
    want, got = jgp.train(z), tgp.train(z)
    spectral = spectral_fits["profiled"][1]
    assert got["success"]
    for ref in (want, spectral):
        np.testing.assert_allclose(got["eta"], ref["eta"], rtol=2e-2)
        np.testing.assert_allclose(got["sigma0"], ref["sigma0"], rtol=1e-3)
    hp = (spectral["sigma"], spectral["sigma0"])
    lp_want = jgp.likelihood.likelihood(z, hp)
    lp_got = tgp.likelihood.likelihood(z, hp)
    if imate == "slq":
        np.testing.assert_allclose(lp_got, lp_want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(lp_got, lp_want, rtol=1e-9)


@pytest.fixture(scope="module")
def operator_gps(problem):
    pts, z, X, _, _ = problem
    jgp = _quiet(gppe_tpu.GaussianProcess, X,
                 jops.MaternOperator(pts, 0.1, nu=0.5), "profiled",
                 options={})
    top = MaternOperator(pts, 0.1, nu=0.5, dtype=F64, **CPU)
    tgp = _quiet(gppe_tpu_torch.GaussianProcess, X, top, "profiled",
                 options=_reference_options(X.shape[0]), **CPU)
    return jgp, tgp, top


def test_matern_operator_route_fit(problem, spectral_fits, operator_gps):
    """A MaternOperator K takes the Krylov route; the facade adds no
    arithmetic to the engine (the same bits as the engine called
    directly)."""
    _, z, X, _, _ = problem
    jgp, tgp, top = operator_gps
    assert tgp.likelihood.operator_mode
    assert tgp.likelihood.K_mixed.method == "slq"
    got, want = tgp.train(z), jgp.train(z)
    direct = KrylovProfileLikelihood(top, X, z, lanczos_steps=80,
                                     num_probes=16, device="cpu",
                                     dtype=F64).fit()
    assert got == direct
    for ref in (want, spectral_fits["profiled"][1]):
        np.testing.assert_allclose(got["eta"], ref["eta"], rtol=2e-2)
        np.testing.assert_allclose(got["sigma0"], ref["sigma0"], rtol=1e-3)


def test_matern_operator_route_likelihood(problem, spectral_fits,
                                          operator_gps):
    """lp through CG (widths 6 and 1) and SLQ with the reference's draws
    equals the reference's operator lp, and the spectral lp to 1e-3."""
    _, z, X, _, _ = problem
    jgp, tgp, _ = operator_gps
    spectral = spectral_fits["profiled"][1]
    hp = (spectral["sigma"], spectral["sigma0"])
    got = tgp.likelihood.likelihood(z, hp)
    np.testing.assert_allclose(got, jgp.likelihood.likelihood(z, hp),
                               rtol=0, atol=1e-5)
    exact = gppe_tpu_torch.GaussianProcess(
        X, problem[4], **CPU).likelihood.likelihood(z, hp)
    np.testing.assert_allclose(got, exact, rtol=1e-3)
    # the degenerate branch needs no solve
    np.testing.assert_allclose(
        tgp.likelihood.likelihood(z, (1e-9, 0.2)),
        jgp.likelihood.likelihood(z, (1e-9, 0.2)), rtol=1e-10)


def test_unported_and_invalid_inputs(problem):
    pts, z, X, _, tK = problem
    with pytest.raises(ValueError):
        gppe_tpu_torch.GaussianProcess(X, tK, "bogus", **CPU)
    with pytest.raises(NotImplementedError, match="A9"):
        gppe_tpu_torch.GaussianProcess(
            X, scipy.sparse.csr_matrix(tK.numpy()), **CPU)
    gp = gppe_tpu_torch.GaussianProcess(X, tK, "profiled", **CPU)
    with pytest.raises(NotImplementedError, match="A15"):
        gp.train(z, plot=True)
    with pytest.raises(ValueError, match="operator is on"):
        gppe_tpu_torch.GaussianProcess(
            X, MaternOperator(pts, 0.1, **CPU), device="meta")


def test_default_device_is_the_card(problem):
    """Without device=, the dense path goes to "cuda": on a host without a
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works there")
    _, z, X, _, tK = problem
    with pytest.raises((RuntimeError, AssertionError)):
        gppe_tpu_torch.GaussianProcess(X, tK)
    with pytest.raises((RuntimeError, AssertionError)):
        gppe_tpu_torch.generate_correlation(problem[0], 0.1)


def test_driver(tmp_path):
    """The timed driver at n = 400 on the CPU: both methods fit and agree,
    every time is reported, and the file is written only when asked."""
    out = tmp_path / "direct.json"
    res = tdriver.main(num_points=20, device="cpu", verbose=False,
                       out_path=str(out))
    assert res["n"] == 400 and res["device"] == "cpu"
    assert res["assembly_s"] >= 0
    for m in ("direct", "profiled"):
        assert res[m]["success"]
        assert res[m]["precompute_s"] >= 0 and res[m]["optimize_s"] >= 0
    assert res["direct"]["eta"] == pytest.approx(res["profiled"]["eta"],
                                                 rel=1e-3)
    assert out.is_file()
    assert sorted(os.listdir(tmp_path)) == ["direct.json"]


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|gppe_tpu)(?:\.|\s|$)",
                     re.MULTILINE)


def test_port_and_smoke_script_import_no_jax():
    """No module of gppe_tpu_torch, and not chip_smoke.py, imports jax or
    gppe_tpu (gppe_tpu_torch itself is allowed)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gppe_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        offenders += [(os.path.relpath(path, REPO), m.group(0).strip())
                      for m in _IMPORT.finditer(src)]
    assert offenders == []
