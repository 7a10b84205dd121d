"""The (rho, nu) search of gppe_tpu_torch vs gppe_tpu, on the CPU.

``drivers/find_optimal_covariance.py``'s twin, the priors, differential
evolution and the results checkpoint. The objective is held to the
reference's ``build_objective`` (``spectral_on_host=False``, float64 under
x64, tests/conftest.py) on the same numpy problem: lp(rho, nu) and lp4 at
three points, rtol 1e-8 (two float64 eigendecompositions and the same
eta search; measured ~1e-12). The priors exactly. Differential evolution
draws from a torch.Generator, so it is held to the minimum of a quadratic,
as tests/test_drivers.py holds the reference's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from drivers import find_optimal_covariance as jdrv  # noqa: E402
from gppe_tpu.models import priors as jpriors  # noqa: E402
from gppe_tpu_torch.drivers import (  # noqa: E402
    compare_various_num_points as tcmp)
from gppe_tpu_torch.drivers import find_optimal_covariance as tdrv  # noqa
from gppe_tpu_torch.models import priors  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops.global_opt import (  # noqa: E402
    MinimizeTerminator, differential_evolution)
from gppe_tpu_torch.utils import checkpoint  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

F64 = torch.float64
POINTS = [(0.15, 1.5), (0.2, 3.7), (0.12, 12.3)]


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


# -- priors -------------------------------------------------------------------

@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-3, np.inf),
                                    (1e-2, 25.0)])
def test_uniform_log_prior_exact(bounds):
    x = np.array([-1.0, 0.0, 1e-3, 0.5, 1.0, 1.5, 25.0, 26.0])
    want = np.asarray(jpriors.uniform_log_prior(jnp.asarray(x), bounds))
    got = priors.uniform_log_prior(torch.as_tensor(x), bounds).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(priors.uniform_log_prior(0.5, (0.0, 1.0))) == 0.0


@pytest.mark.parametrize("scale", [1.0, 25.0])
def test_inverse_square_log_prior_exact(scale):
    x = np.array([-0.5, 0.0, 0.1, 1.0, 7.5, 25.0])
    want = np.asarray(jpriors.inverse_square_log_prior(jnp.asarray(x),
                                                       scale=scale))
    got = priors.inverse_square_log_prior(torch.as_tensor(x),
                                          scale=scale).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64


# -- differential evolution ---------------------------------------------------

def test_differential_evolution_quadratic():
    """The reference's test (tests/test_drivers.py): the minimum of a
    quadratic on [-2, 2]^2 to 1e-3, the population one batched call per
    generation."""
    target = torch.tensor([0.3, -1.2], dtype=F64)
    shapes = []

    def obj(pop):
        shapes.append(tuple(pop.shape))
        return torch.sum((pop - target) ** 2, dim=1)

    res = differential_evolution(obj, [[-2.0, 2.0], [-2.0, 2.0]],
                                 generator=0, popsize=30,
                                 max_generations=150)
    np.testing.assert_allclose(res.x.numpy(), target.numpy(), atol=1e-3)
    assert set(shapes) == {(30, 2)}
    assert len(shapes) == res.num_generations + 1


def test_differential_evolution_stops_on_the_mask():
    """The reference's convergence mask: spread < tol stops the run at that
    generation; terminate_atol stops it when the best value improves by
    less; non-finite values count as +inf; the same seed, the same run."""
    def obj(pop):
        f = torch.sum(pop ** 2, dim=1)
        return torch.where(pop[:, 0] > 1.5, torch.full_like(f, float("nan")),
                           f)

    a = differential_evolution(obj, [[-2.0, 2.0]] * 3, generator=7,
                               popsize=20, max_generations=400, tol=1e-8)
    assert a.converged and a.num_generations < 400
    assert torch.isfinite(a.fun) and float(a.fun) < 1e-6
    b = differential_evolution(obj, [[-2.0, 2.0]] * 3,
                               generator=torch.Generator().manual_seed(7),
                               popsize=20, max_generations=400, tol=1e-8)
    assert torch.equal(a.x, b.x) and a.num_generations == b.num_generations
    c = differential_evolution(obj, [[-2.0, 2.0]] * 3, generator=7,
                               popsize=20, max_generations=400, tol=0.0,
                               terminate_atol=1e-1)
    assert c.converged and c.num_generations < a.num_generations
    d = differential_evolution(obj, [[-2.0, 2.0]] * 3, generator=7,
                               popsize=20, max_generations=3, tol=0.0)
    assert not d.converged and d.num_generations == 3


def test_minimize_terminator():
    mt = MinimizeTerminator(atol=1e-3, patience=2)
    mt([1.0, 1.0])
    mt([1.0001, 1.0])
    with pytest.raises(MinimizeTerminator.Terminated):
        mt([1.0001, 1.0])


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "r.pickle")
    calls = []

    def compute():
        calls.append(1)
        return {"a": np.arange(3)}

    assert not checkpoint.results_exist(path)
    first = checkpoint.run_or_resume(path, compute)
    again = checkpoint.run_or_resume(path, compute)
    np.testing.assert_array_equal(again["a"], first["a"])
    assert len(calls) == 1 and checkpoint.results_exist(path)
    checkpoint.run_or_resume(path, compute, use_saved=False)
    assert len(calls) == 2
    assert checkpoint.run_or_resume(None, compute)["a"].shape == (3,)
    assert len(calls) == 3


# -- the objective ------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    pts = tdata.generate_points(10, dimension=2)
    return pts, tdata.generate_data(pts, 0.1), tdata.generate_basis_functions(
        pts, 2)


@pytest.fixture(scope="module")
def objectives(problem):
    pts, z, X = problem
    ref = jdrv.build_objective(pts, z, X, with_prior=True,
                               spectral_on_host=False)
    port = tdrv.build_objective(pts, z, X, with_prior=True, device="cpu")
    return ref, port


@pytest.mark.parametrize("rho, nu", POINTS)
def test_lp_matches_reference(objectives, rho, nu):
    (jlp, jobj), (tlp, tobj) = objectives
    want = float(jax.jit(jlp)(rho, nu))
    got = tlp(rho, nu)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_lp_batched_equals_pointwise(objectives):
    """A chunk of (rho, nu) points through one batched eigendecomposition
    gives each point's lp."""
    _, (tlp, tobj) = objectives
    rhos, nus = np.array(POINTS).T
    batched = tlp(rhos, nus)
    np.testing.assert_allclose(batched, [tlp(r, n) for r, n in POINTS],
                               rtol=1e-12)


@pytest.mark.parametrize("rho, nu", POINTS)
def test_lp4_matches_reference(objectives, rho, nu):
    (jlp, jobj), (tlp, tobj) = objectives
    for sigma, sigma0 in ((0.3, 0.1), (1.1, 0.05)):
        want = float(jobj.lp4(rho, nu, sigma, sigma0))
        np.testing.assert_allclose(tobj.lp4(rho, nu, sigma, sigma0), want,
                                   rtol=1e-8)


def test_objectives_match_reference(objectives):
    """The negative log posteriors with the priors (two parameters) and the
    four-parameter one, including a row outside the uniform support."""
    (jlp, jobj), (tlp, tobj) = objectives
    rows = np.array(POINTS)
    want = [float(jax.jit(jobj)(jnp.asarray(r))) for r in rows]
    np.testing.assert_allclose(tobj(torch.as_tensor(rows)).numpy(), want,
                               rtol=1e-8)
    rows4 = np.array([[0.15, 1.5, 0.3, 0.1], [0.15, 26.0, 0.1, 0.1]])
    got4 = tobj.four_param(torch.as_tensor(rows4)).numpy()
    np.testing.assert_allclose(got4[0], float(jobj.four_param(rows4[0])),
                               rtol=1e-8)
    assert got4[1] == np.inf == float(jobj.four_param(rows4[1]))


# -- the entry points ---------------------------------------------------------

def test_main_writes_nothing_and_finds_the_grid_argmax(tmp_path,
                                                       monkeypatch):
    """main at a small size on the CPU: the surface is lp over the grid
    (with the priors added), its argmax is reported, DE runs batched
    generations inside the box, and no file is written without a path."""
    monkeypatch.chdir(tmp_path)
    res = tdrv.main(num_points=8, noise=0.05, with_prior=True, grid_rho=3,
                    grid_nu=3, verbose=False, device="cpu", popsize=6,
                    max_generations=2)
    assert os.listdir(tmp_path) == []
    assert res["Lp"].shape == (3, 3) and np.all(np.isfinite(res["Lp"]))
    i, j = np.unravel_index(np.argmax(res["Lp"]), (3, 3))
    assert (res["optimal_rho"], res["optimal_nu"]) == (res["rhos"][i],
                                                      res["nus"][j])
    assert 0.1 <= res["de_rho"] <= 0.3 and 1.0 <= res["de_nu"] <= 25.0
    assert 1 <= res["de_generations"] <= 2 and np.isfinite(res["de_lp"])
    saved = tdrv.main(num_points=6, grid_rho=2, grid_nu=2, run_de=False,
                      verbose=False, device="cpu",
                      results_path=str(tmp_path / "oc.pickle"))
    assert checkpoint.load_results(str(tmp_path / "oc.pickle"))[
        "max_lp"] == saved["max_lp"]


def test_main_large_general_nu_grid(monkeypatch):
    """main_large at n = 150 on the CPU: the grid engine over general nus
    (dense below n = 8192), one plain general-nu assembly per point; every
    point fits."""
    cuda_kernels.reset_launch_counts()
    res = tdrv.main_large(n=150, grid_rho=2, grid_nu=2, lanczos_steps=10,
                          num_probes=4, verbose=False, device="cpu")
    assert res["Lp"].shape == (2, 2) and np.all(np.isfinite(res["Lp"]))
    assert not res["matrix_free"] and res["seconds_per_point"] > 0
    assert [r["nu"] for r in res["results"]] == [1.0, 25.0, 1.0, 25.0]
    assert not any(cuda_kernels.launch_counts.values())


def test_main_fft_grid_runs():
    """main_fft_grid is ported (tests/test_torch_grid_fft.py holds it
    against the reference): at side 10 on the CPU one general-nu point
    fits, its lp finite with the priors added."""
    cuda_kernels.reset_launch_counts()
    res = tdrv.main_fft_grid(side=10, noise=0.05, rhos=[0.15], nus=[1.2],
                             lanczos_steps=6, num_probes=4, verbose=False,
                             device="cpu")
    row, = res["rows"]
    assert res["n"] == 100 and (row["rho"], row["nu"]) == (0.15, 1.2)
    assert row["success"] and np.isfinite(row["lp"]) and row["eta"] > 0
    assert res["max_lp"] == row["lp"]
    assert not any(cuda_kernels.launch_counts.values())


def test_unported_entry_points_name_their_roadmap_item(tmp_path,
                                                       monkeypatch):
    """Every entry point is ported, ``plot=True`` (A15) too: each draws its
    figure into the working directory (matplotlib on Agg): the (rho, nu)
    contour with the DE optimum, and the log-log timing plots of the
    dense and the tapered scaling races."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    monkeypatch.setenv("GPPE_NO_DISPLAY", "1")
    monkeypatch.chdir(tmp_path)
    res = tdrv.main(num_points=5, grid_rho=5, grid_nu=4, popsize=4,
                    max_generations=2, plot=True, verbose=False,
                    device="cpu")
    assert "de_rho" in res
    assert (tmp_path / "optimal_covariance_without_prior.svg").is_file()
    dense = tcmp.main(dense_sides=(5, 6), krylov_ns=(200,), plot=True,
                      verbose=False, device="cpu")
    assert len(dense["dense"]) == 2
    assert (tmp_path / "various_number_of_points.svg").is_file()
    sparse = tcmp.main_sparse(ns=(256,), density=0.1, scale=0.05,
                              plot=True, verbose=False, device="cpu")
    assert sparse["sparse"][0]["success"]
    assert (tmp_path / "various_number_of_points_sparse.svg").is_file()
    tcmp.plot_results(dense, filename="timing", reference_rows={
        529: 0.40, 729: 0.71}, verbose=False)
    assert (tmp_path / "timing.svg").is_file()
