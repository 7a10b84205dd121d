"""gppe_tpu_torch.utils.plot, utils.display and the two plot drivers
against gppe_tpu's, on the CPU in float64 (the JAX package under x64,
tests/conftest.py).

The plots' numbers need no matplotlib and are held to the reference's:
the derivative plot's curves (exact, bounds, asymptotes, inset) at rtol
1e-8 on an 8 x 8 grid (n = 64; both packages assemble K from the same
points and take their own eigendecompositions), the likelihood surface's
Z and the refined contour at rtol 1e-10, the Matern family's
max |k_25 - k_gauss| to 1e-10. Every figure is drawn on matplotlib's Agg
backend (without a display) into ``tmp_path`` and must leave its .svg
there.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse  # noqa: E402

import gppe_tpu  # noqa: E402
from gppe_tpu.models import direct_likelihood as jdl  # noqa: E402
from gppe_tpu.models import profile_likelihood as jpl  # noqa: E402
from gppe_tpu.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation as JMixed)
from gppe_tpu.utils import plot as jplot  # noqa: E402
from gppe_tpu_torch.drivers import plot_log_likelihood_der1  # noqa: E402
from gppe_tpu_torch.drivers import plot_matern_kernel  # noqa: E402
from gppe_tpu_torch.models import direct_likelihood as tdl  # noqa: E402
from gppe_tpu_torch.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation)
from gppe_tpu_torch.ops import assembly as tasm  # noqa: E402
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402
from gppe_tpu_torch.utils import display  # noqa: E402
from gppe_tpu_torch.utils import plot as tplot  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F64 = torch.float64
CURVE_RTOL = 1e-8


@pytest.fixture
def agg(tmp_path, monkeypatch):
    """matplotlib on Agg, no display, the working directory tmp_path."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    monkeypatch.setenv("GPPE_NO_DISPLAY", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture(scope="module")
def problem():
    pts = data_utils.generate_points(8, dimension=2)          # n = 64
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 1)
    jK = gppe_tpu.generate_correlation(pts, 0.15, nu=0.5)
    tK = tasm.generate_correlation(pts, 0.15, nu=0.5, dtype=F64,
                                   device="cpu")
    jdata = jdl.make_spectral_data(JMixed(jK), X, z)
    tdata = tdl.make_spectral_data(MixedCorrelation(tK, device="cpu"), X, z)
    return pts, z, X, np.asarray(jK), tK, jdata, tdata


def reference_curves(jdata, K, X, z, optimal_eta):
    """The numbers gppe_tpu/utils/plot.py:147-200 draws, computed by its
    own calls."""
    eta = np.logspace(-3, 3, 100)
    bounds = [jpl.compute_bounds_der1_eta(jdata, e) for e in eta]
    asym1, asym2, roots1, roots2 = jpl.compute_asymptote_der1_eta(
        K, X, z, np.logspace(1, 3, 50))
    e_in = np.logspace(np.log10(optimal_eta) - 0.5,
                       np.log10(optimal_eta) + 0.5, 60)
    return {"eta": eta,
            "der1": np.asarray(jpl.log_likelihood_der1_eta(
                jdata, jnp.log10(jnp.asarray(eta)))),
            "upper": np.asarray([float(u) for u, _ in bounds]),
            "lower": np.asarray([float(lo) for _, lo in bounds]),
            "asym1": np.asarray(asym1), "asym2": np.asarray(asym2),
            "roots1": np.asarray(roots1), "roots2": np.asarray(roots2),
            "eta_inset": e_in,
            "der1_inset": np.asarray(jpl.log_likelihood_der1_eta(
                jdata, jnp.log10(jnp.asarray(e_in))))}


@pytest.mark.parametrize("key", ["der1", "upper", "lower", "asym1",
                                 "asym2", "roots1", "roots2",
                                 "der1_inset"])
def test_der1_curves_match_reference(problem, key):
    """Without matplotlib: the curves of the derivative plot, float64."""
    pts, z, X, jK, tK, jdata, tdata = problem
    got = tplot.der1_eta_curves(tdata, tK, X, z, optimal_eta=5.0)
    want = reference_curves(jdata, jK, X, z, 5.0)
    assert got[key].dtype == np.float64
    np.testing.assert_allclose(np.sort_complex(got[key]) if key.startswith(
        "roots") else got[key], np.sort_complex(want[key]) if
        key.startswith("roots") else want[key], rtol=CURVE_RTOL, atol=0)


def test_der1_curves_without_root(problem):
    """No finite positive root: no inset, the rest as with one."""
    pts, z, X, jK, tK, jdata, tdata = problem
    for eta in (None, np.inf, 0.0):
        got = tplot.der1_eta_curves(tdata, tK, X, z, optimal_eta=eta)
        assert "eta_inset" not in got and "der1_inset" not in got
        assert np.all(np.isfinite(got["der1"]))


def test_plot_der1_eta(agg, problem):
    pts, z, X, jK, tK, jdata, tdata = problem
    curves = tplot.plot_log_likelihood_der1_eta(
        tdata, tK, X, z, optimal_eta=5.0, filename="der1_test")
    assert os.path.isfile(agg / "der1_test.svg")
    np.testing.assert_allclose(curves["der1"],
                               reference_curves(jdata, jK, X, z,
                                                5.0)["der1"],
                               rtol=CURVE_RTOL)


def test_likelihood_surface_matches_reference(agg, problem):
    pts, z, X, jK, tK, jdata, tdata = problem
    xs, ys = np.linspace(0.05, 0.3, 6), np.linspace(0.05, 0.3, 5)
    Zj = jplot.plot_likelihood_surface(
        lambda s, s0: float(jdl.log_likelihood(jdata, s, s0)), xs, ys,
        "sigma", "sigma0", filename="surf_ref")
    Zt = tplot.plot_likelihood_surface(
        lambda s, s0: tdl.log_likelihood(tdata, s, s0), xs, ys, "sigma",
        "sigma0", optimum=(0.1, 0.1, 0.0), filename="surf_test")
    assert os.path.isfile(agg / "surf_test.svg")
    assert Zt.shape == (5, 6) and Zt.dtype == np.float64
    np.testing.assert_allclose(Zt, Zj, rtol=1e-10)
    np.testing.assert_array_equal(
        tplot.likelihood_surface(
            lambda s, s0: tdl.log_likelihood(tdata, s, s0), xs, ys), Zt)


@pytest.mark.parametrize("smooth_sigma, upsample", [(1.0, 4), (0.0, 1)],
                         ids=["smoothed-upsampled", "raw"])
def test_contour_grid_matches_reference(agg, smooth_sigma, upsample):
    x = np.linspace(0.1, 0.3, 8)
    y = np.linspace(1.0, 25.0, 10)
    Xg, Yg = np.meshgrid(x, y, indexing="ij")
    Z = -((Xg - 0.2) ** 2 + ((Yg - 10.0) / 50.0) ** 2)
    want = jplot.plot_contour_grid(x, y, Z, "rho", "nu", optimum=(0.2, 10.0),
                                   smooth_sigma=smooth_sigma,
                                   upsample=upsample, filename="contour_ref")
    got = tplot.plot_contour_grid(x, y, Z, "rho", "nu", optimum=(0.2, 10.0),
                                  smooth_sigma=smooth_sigma,
                                  upsample=upsample, title="lp",
                                  filename="contour_test")
    assert os.path.isfile(agg / "contour_test.svg")
    np.testing.assert_allclose(got, want, rtol=1e-10)
    x_f, y_f, Zf = tplot.refine_contour_grid(x, y, Z, smooth_sigma,
                                             upsample)
    np.testing.assert_array_equal(Zf, got)
    assert (len(x_f), len(y_f)) == got.shape


@pytest.mark.parametrize("kind", ["dense-tensor", "scipy-sparse"])
def test_plot_matrix(agg, problem, kind):
    tK = problem[4]
    matrix = (tK if kind == "dense-tensor" else
              scipy.sparse.csr_matrix(np.where(tK.numpy() > 0.5, tK.numpy(),
                                               0.0)))
    tplot.plot_matrix(matrix, sparse=kind != "dense-tensor",
                      filename="mat_test")
    assert os.path.isfile(agg / "mat_test.svg")


def test_krylov_der1_curve(agg, problem):
    """The operator route's plot: the Krylov engine's d lp / d eta, here on
    the dense K (an engine is any object with der1(log10 eta))."""
    pts, z, X, jK, tK, jdata, tdata = problem
    from gppe_tpu_torch.models import profile_likelihood as tpl

    class Exact:
        def der1(self, le):
            return float(tpl.log_likelihood_der1_eta(tdata, le))

    eta, der1 = tplot.krylov_der1_curve(Exact(), optimal_eta=5.0,
                                        filename="krylov_test")
    assert os.path.isfile(agg / "krylov_test.svg")
    np.testing.assert_allclose(
        der1, reference_curves(jdata, jK, X, z, 5.0)["der1"],
        rtol=CURVE_RTOL)


def test_missing_matplotlib_is_named(monkeypatch, problem):
    """Only drawing needs matplotlib: its absence is named when a figure
    is asked for, and the numbers still come."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tplot._get_plt()
    pts, z, X, jK, tK, jdata, tdata = problem
    assert np.all(np.isfinite(tplot.der1_eta_curves(tdata, tK, X, z)["der1"]))
    assert plot_matern_kernel.main(test=True, device="cpu") < 0.02


@pytest.mark.parametrize("env, notebook, want", [
    ({}, False, False), ({"DISPLAY": ":0"}, False, True),
    ({"DISPLAY": ":0", "GPPE_NO_DISPLAY": "1"}, False, False),
    ({"DISPLAY": ":0", "IMATE_NO_DISPLAY": "1"}, False, False),
    ({}, True, True)], ids=["none", "display", "gppe-no-display",
                            "imate-no-display", "notebook"])
def test_has_display_matches_reference(monkeypatch, env, notebook, want):
    from gppe_tpu.utils import display as jdisplay
    for var in ("DISPLAY", "GPPE_NO_DISPLAY", "IMATE_NO_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if notebook:
        class ZMQInteractiveShell:
            pass
        monkeypatch.setattr("builtins.get_ipython",
                            lambda: ZMQInteractiveShell(), raising=False)
    assert display.is_notebook() == jdisplay.is_notebook() == notebook
    assert display.has_display() == jdisplay.has_display() == want


def test_plot_matern_kernel_matches_reference(agg):
    """main(test=True) draws nothing and returns the reference's number;
    main() draws the family."""
    from drivers import plot_matern_kernel as jdrv
    got = plot_matern_kernel.main(test=True, device="cpu")
    assert got < 0.02                     # the reference's claim (:93-96)
    assert abs(got - jdrv.main(test=True)) <= 1e-10
    assert not os.listdir(agg)
    x, ks = plot_matern_kernel.curves("cpu")
    for nu, k in ks.items():
        assert k.dtype == np.float64 and k[0] == 1.0
        assert np.all(np.isfinite(k)) and np.all((k > 0) & (k <= 1.0)), nu
    plot_matern_kernel.main(filename="matern_test", device="cpu")
    assert os.path.isfile(agg / "matern_test.svg")


def test_plot_log_likelihood_der1_driver(agg):
    """The entry point's root against the reference's on a 10 x 10 grid, and
    its figure; plot=False draws nothing."""
    from drivers import plot_log_likelihood_der1 as jdrv
    got = plot_log_likelihood_der1.main(num_points=10, verbose=False,
                                        plot=False, device="cpu")
    assert not os.listdir(agg)
    want = jdrv.main(num_points=10, verbose=False)   # draws its own
    os.remove(agg / "log_likelihood_first_derivative.svg")
    for key in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    plot_log_likelihood_der1.main(num_points=10, verbose=False,
                                  device="cpu")
    assert os.path.isfile(agg / "log_likelihood_first_derivative.svg")


@pytest.mark.parametrize("route", ["direct", "profiled", "operator"])
def test_train_plot(agg, route):
    """GaussianProcess.train(plot=True) on each route draws its figure and
    returns the fit it returns without: the direct lp surface, the
    profiled derivative plot, and on the operator route (a
    MaternOperator K) the Krylov engine's derivative."""
    import gppe_tpu_torch
    from gppe_tpu_torch.ops.operators import MaternOperator

    pts = data_utils.generate_points(10, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 1)
    if route == "operator":
        K = MaternOperator(pts, 0.15, device="cpu", dtype=F64)
        with pytest.warns(UserWarning, match="slq"):
            gp = gppe_tpu_torch.GaussianProcess(
                X, K, "profiled", device="cpu", lanczos_steps=24,
                num_probes=8)
    else:
        K = tasm.generate_correlation(pts, 0.15, dtype=F64, device="cpu")
        gp = gppe_tpu_torch.GaussianProcess(X, K, route, device="cpu")
    res = gp.train(z, plot=True)
    assert res == gp.train(z)
    name = {"direct": "log_likelihood.svg"}.get(
        route, "log_likelihood_first_derivative.svg")
    assert os.listdir(agg) == [name]
