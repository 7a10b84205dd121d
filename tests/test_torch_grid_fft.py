"""The ported FFT grid operator and its helpers vs the JAX reference, on
the CPU in float64.

Inputs come from numpy seeds and go through both packages: the grid
helpers (``grid_geometry``, ``grid_distance_table``, ``circulant_rfft``,
``grid_trace_pow2``), ``GridMaternOperator`` (products rtol 1e-10,
trace(K^2) rtol 1e-11, as tests/test_operators.py holds the reference),
``KrylovProfileLikelihood`` over it (fit rtol 1e-6) and the entry points
of the drivers ``find_optimal_covariance.main_fft_grid`` and
``compare_various_num_points.run_krylov(fft=True)``. The engines see the
reference's own random block (``jax.random`` from ``PRNGKey(0)``, handed
to the port). On a regular grid the constant column's Krylov space is
exhausted after a few steps and the tails of the two packages' bases part
(ROADMAP, watch list), so the fits stop before that: k = 8 at n = 144 and
n = 400 (where the surfaces agree to ~1e-12).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from drivers import compare_various_num_points as jcmp  # noqa: E402
from drivers import find_optimal_covariance as jdrv  # noqa: E402
from gppe_tpu.models import large_scale as jls  # noqa: E402
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu_torch.drivers import (  # noqa: E402
    compare_various_num_points as tcmp)
from gppe_tpu_torch.drivers import find_optimal_covariance as tdrv  # noqa
from gppe_tpu_torch.models import large_scale as tls  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import stochastic  # noqa: E402
from gppe_tpu_torch.utils import checkpoint  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F32, F64 = torch.float32, torch.float64
# Lanczos steps of the fits on a grid: before the constant column's
# Krylov space is exhausted
GRID_STEPS = 8


def jax_block(n, p, key=0):
    """The reference engines' random block for ``key``
    (gppe_tpu/models/large_scale.py: split PRNGKey(key), rademacher and
    normal in float64)."""
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
    return (np.array(jax.random.rademacher(k_probe, (n, p),
                                           dtype=jnp.float64)),
            np.array(jax.random.normal(k_defl, (n, 1), dtype=jnp.float64)))


def shuffled_grid(side, d, seed):
    pts = tdata.generate_points(side, dimension=d)
    return pts[np.random.RandomState(seed).permutation(len(pts))]


# -- the grid helpers ---------------------------------------------------------

@pytest.mark.parametrize("d, side", [(1, 37), (2, 13), (3, 6)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_grid_geometry_matches(d, side, shuffle):
    """Sizes, spacings (exactly) and both permutations equal the
    reference's; the permutations invert each other."""
    pts = (shuffled_grid(side, d, d) if shuffle
           else tdata.generate_points(side, dimension=d))
    if d == 1:
        pts = pts[:, 0]
    want = jops.grid_geometry(pts)
    got = tops.grid_geometry(pts)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[3][got[2]], np.arange(len(pts)))


def test_grid_geometry_anisotropic_spacing():
    """A 7 x 11 grid of unequal spacings, offset from the origin."""
    x, y = np.meshgrid(0.3 + 0.05 * np.arange(7), -1 + 0.2 * np.arange(11),
                       indexing="ij")
    pts = np.stack([x.ravel(), y.ravel()], axis=1)[::-1]
    want = jops.grid_geometry(pts)
    got = tops.grid_geometry(pts)
    assert got[0] == want[0] == (7, 11) and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("case, match", [
    ("random", "not uniform"), ("missing", "full regular grid"),
    ("duplicate", "duplicate"), ("uneven", "not uniform"), ("4d", "3-D")])
def test_grid_geometry_rejects(case, match):
    """The reference's refusals: random points, a 6 x 6 grid with one
    site missing (the axis product is not n), the same grid with one site
    repeated in place of another (the product is n, the sites are not
    distinct), uneven spacing, more than three dimensions."""
    rng = np.random.RandomState(0)
    pts = {"random": rng.rand(100, 2),
           "missing": tdata.generate_points(6)[:-1],
           "duplicate": np.concatenate([tdata.generate_points(6)[:-1],
                                        tdata.generate_points(6)[:1]]),
           "uneven": np.array([[0.0], [0.1], [0.3], [0.4]]),
           "4d": rng.rand(16, 4)}[case]
    for geometry in (jops.grid_geometry, tops.grid_geometry):
        with pytest.raises(ValueError, match=match):
            geometry(pts)


@pytest.mark.parametrize("ms, hs, scale", [
    ((9,), (0.1,), 0.07), ((6, 5), (0.2, 0.25), [0.3, 0.11]),
    ((4, 3, 5), (0.1, 0.2, 0.3), 0.5)])
def test_distance_table_rfft_and_trace(ms, hs, scale):
    """The distance table to 1e-15, the embedded table's spectrum (one
    table and a batch of three) rtol 1e-12, trace(K^2) from the table
    (batch axes too) rtol 1e-12."""
    dist = tops.grid_distance_table(ms, hs, scale)
    np.testing.assert_allclose(dist, jops.grid_distance_table(ms, hs, scale),
                               rtol=1e-15, atol=0)
    tabs = np.stack([np.exp(-dist * f) for f in (1.0, 0.5, 2.0)])
    got = tops.circulant_rfft(torch.as_tensor(tabs), ms).numpy()
    want = np.asarray(jops.circulant_rfft(tabs, ms, jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    got1 = tops.circulant_rfft(torch.as_tensor(tabs[1]), ms).numpy()
    np.testing.assert_allclose(got1, want[1], rtol=1e-12, atol=1e-12)
    tk2 = tops.grid_trace_pow2(torch.as_tensor(tabs), ms)
    assert tk2.dtype == F64 and tk2.shape == (3,)
    np.testing.assert_allclose(tk2.numpy(), jops.grid_trace_pow2(tabs, ms),
                               rtol=1e-12)


# -- the operator -------------------------------------------------------------

@pytest.mark.parametrize("nu", [0.5, 1.5, 2.2])
def test_operator_matmat_matches(nu):
    """matmat of 5 columns and matvec on a shuffled 2-D grid (17 x 13)
    under an anisotropic scale, against the reference's operator: rtol
    1e-10; trace(K^2) rtol 1e-11; dense() against the dense float64 K."""
    x, y = np.meshgrid(np.linspace(0, 1, 17), np.linspace(0, 0.6, 13),
                       indexing="ij")
    pts = np.stack([x.ravel(), y.ravel()], axis=1)
    pts = pts[np.random.RandomState(1).permutation(len(pts))]
    scale = [0.12, 0.2]
    V = np.random.RandomState(2).standard_normal((len(pts), 5))
    jop = jops.GridMaternOperator(pts, scale, nu=nu)
    top = tops.GridMaternOperator(pts, scale, nu=nu, device="cpu",
                                  dtype=F64)
    assert top.shape == jop.shape and top.dtype == F64
    np.testing.assert_allclose(top.matmat(torch.as_tensor(V)).numpy(),
                               np.asarray(jop.matmat(V)), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(top.matvec(torch.as_tensor(V[:, 0])).numpy(),
                               np.asarray(jop.matvec(V[:, 0])), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(top.trace_pow(2)),
                               float(jop.trace_pow(2)), rtol=1e-11)
    assert float(top.trace_pow(1)) == float(top.trace_pow(0)) == len(pts)
    tpts = torch.as_tensor(pts)
    K = kernels.matern(kernels.pairwise_scaled_distance(
        tpts, tpts, torch.as_tensor(scale, dtype=F64)), nu).numpy()
    np.testing.assert_allclose(top.dense().numpy(), K, rtol=1e-12,
                               atol=1e-13)
    with pytest.raises(ValueError, match="exponent"):
        top.trace_pow(3)


@pytest.mark.parametrize("d, side, scale, nu", [(1, 200, 0.07, 1.5),
                                                (3, 7, 0.2, 0.5),
                                                (3, 6, 0.3, 3.7)])
def test_operator_1d_and_3d(d, side, scale, nu):
    """The d-general form (tests/test_operators.py:249-270): products and
    trace(K^2) on 1-D and 3-D grids against dense float64 K and the
    reference, atol 1e-11 / rtol 1e-11."""
    pts = tdata.generate_points(side, dimension=d)
    v = np.random.default_rng(2).standard_normal(len(pts))
    top = tops.GridMaternOperator(pts, scale, nu=nu, device="cpu",
                                  dtype=F64)
    tpts = torch.as_tensor(pts)
    K = kernels.matern(kernels.pairwise_scaled_distance(tpts, tpts, scale),
                       nu).numpy()
    np.testing.assert_allclose(top.matvec(torch.as_tensor(v)).numpy(), K @ v,
                               atol=1e-11)
    np.testing.assert_allclose(float(top.trace_pow(2)), np.sum(K * K),
                               rtol=1e-11)
    jop = jops.GridMaternOperator(pts, scale, nu=nu)
    np.testing.assert_allclose(top.matvec(torch.as_tensor(v)).numpy(),
                               np.asarray(jop.matvec(v)), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("nu, dtype, launches", [(2.2, F32, 1),
                                                 (2.2, F64, 0),
                                                 (1.5, F32, 0)])
def test_table_precision_rule(monkeypatch, nu, dtype, launches):
    """The dtype rule of the offset table: a float32 operator's general-nu
    table goes through the general-nu kernel's entry
    (``cuda_kernels.matern_general``, one call over the float32 table); a
    float64 operator's, and any closed form's, through the float64
    ``kernels.matern``. The float32 table within 3e-5 of float64 (the
    kernel's bound, GENERAL_K_ATOL), and a float32 product within 1e-5
    (Frobenius) of the float64 one."""
    calls = []
    real = cuda_kernels.matern_general

    def spy(x, nu_):
        calls.append((x.dtype, x.shape, nu_))
        return real(x, nu_)

    monkeypatch.setattr(cuda_kernels, "matern_general", spy)
    pts = shuffled_grid(16, 2, 3)
    op = tops.GridMaternOperator(pts, 0.1, nu=nu, device="cpu", dtype=dtype)
    assert len(calls) == launches
    assert all(c[0] == F32 and c[1] == (16, 16) for c in calls)
    assert op._k_tab.dtype == F64
    ref = tops.GridMaternOperator(pts, 0.1, nu=nu, device="cpu", dtype=F64)
    assert float(torch.max(torch.abs(op._k_tab - ref._k_tab))) < (
        cuda_kernels.GENERAL_K_ATOL)
    V = torch.as_tensor(np.random.RandomState(0).standard_normal((256, 3)))
    got = op.matmat(V.to(dtype)).double()
    want = ref.matmat(V)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-5


# -- the engine and the entry points -----------------------------------------

def test_krylov_fit_over_fft_operator_matches():
    """KrylovProfileLikelihood over the FFT operator (20 x 20 grid, nu =
    2.2, k = 8, 8 probes) against the reference's engine over its own, on
    the reference's random block: factorization and fit rtol 1e-6."""
    pts = tdata.generate_points(20, dimension=2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    probes, v_defl = jax_block(len(pts), 8)
    jeng = jls.KrylovProfileLikelihood(
        jops.GridMaternOperator(pts, 0.1, nu=2.2), X, z,
        lanczos_steps=GRID_STEPS, num_probes=8, key=0)
    teng = tls.KrylovProfileLikelihood(
        tops.GridMaternOperator(pts, 0.1, nu=2.2, device="cpu", dtype=F64),
        X, z, lanczos_steps=GRID_STEPS, num_probes=8, device="cpu",
        dtype=F64, probes=probes, v_defl=v_defl)
    for name in ("alphas", "betas", "U", "G"):
        np.testing.assert_allclose(getattr(teng, name), getattr(jeng, name),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    jr, tr = jeng.fit(), teng.fit()
    assert tr["success"] and np.isfinite(tr["eta"])
    for key in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(tr[key], jr[key], rtol=1e-6, err_msg=key)


@pytest.fixture
def jax_random_block(monkeypatch):
    """The port's engines draw the reference's block for key 0."""
    real = stochastic.random_block

    def block(n, num_probes, key, device, dtype, generator=None,
              probes=None, v_defl=None):
        p, v = jax_block(n, num_probes, key)
        return real(n, num_probes, key, device, dtype, generator,
                    p if probes is None else probes,
                    v if v_defl is None else v_defl)

    monkeypatch.setattr(stochastic, "random_block", block)


FFT_CUT = dict(side=12, noise=0.05, rhos=[0.1, 0.2], nus=[0.5, 2.2],
               lanczos_steps=GRID_STEPS, num_probes=4)


def test_main_fft_grid_matches_reference(tmp_path, monkeypatch,
                                         jax_random_block):
    """main_fft_grid at side 12 (a 2 x 2 cut of its (rho, nu) grid, k = 8,
    4 probes, the priors on) against the reference driver at the same cut
    (its results file in tmp_path): every row's eta, sigma, sigma0 and lp
    rtol 1e-6, the same MAP; the port writes nothing without a path, and
    its file when given one."""
    monkeypatch.chdir(tmp_path)
    want = jdrv.main_fft_grid(results_path=str(tmp_path / "jax.pickle"),
                              verbose=False, **FFT_CUT)
    got = tdrv.main_fft_grid(verbose=False, device="cpu", **FFT_CUT)
    assert os.listdir(tmp_path) == ["jax.pickle"]
    assert len(got["rows"]) == len(want["rows"]) == 4
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["rho"], g["nu"]) == (w["rho"], w["nu"])
        assert np.isfinite(g["lp"]) and g["seconds"] > 0
        for key in ("eta", "sigma", "sigma0", "lp"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6,
                                       err_msg=key)
    assert (got["optimal_rho"], got["optimal_nu"]) == (want["optimal_rho"],
                                                      want["optimal_nu"])
    assert got["n"] == 144 and got["with_prior"]
    saved = tdrv.main_fft_grid(verbose=False, device="cpu",
                               results_path=str(tmp_path / "t.pickle"),
                               **{**FFT_CUT, "rhos": [0.1], "nus": [2.2]})
    assert checkpoint.load_results(str(tmp_path / "t.pickle"))[
        "max_lp"] == saved["max_lp"]


@pytest.mark.parametrize("nu", [0.5, 2.2])
def test_run_krylov_fft_matches_reference(jax_random_block, nu):
    """run_krylov(fft=True, grid=True) at n = 144 (k = 8, 4 probes): the
    fit against the reference driver's, rtol 1e-6."""
    kw = dict(noise=0.05, scale=0.15, nu=nu, grid=True, fft=True,
              lanczos_steps=GRID_STEPS, num_probes=4)
    want = jcmp.run_krylov(144, **kw)
    got = tcmp.run_krylov(144, device="cpu", **kw)
    assert got["pre_s"] > 0 and got["opt_s"] > 0 and got["success"]
    for key in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_run_dense_matches_reference():
    """run_dense at side 12 (noise 0.05, rho 0.15, nu 1/2): the derivative
    method's and the direct MLE's estimates against the reference
    driver's (the same spectral problem, both float64), rtol 1e-6 (the
    direct MLE's trust region stops at its gradient tolerance 1e-3, so
    its estimates rtol 1e-3)."""
    n, want = jcmp.run_dense(12, noise=0.05, scale=0.15)
    n_t, got = tcmp.run_dense(12, noise=0.05, scale=0.15, device="cpu")
    assert n == n_t == 144
    for key in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got["derivative"][key],
                                   want["derivative"][key], rtol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(got["direct"][key], want["direct"][key],
                                   rtol=1e-3, err_msg=key)
    assert got["direct"]["pre_s"] == got["derivative"]["pre_s"] > 0


@pytest.mark.parametrize("route", ["matern", "tapered"])
def test_run_krylov_routes_match_reference(jax_random_block, route):
    """run_krylov's other two operators against the reference driver's:
    MaternOperator at n = 300 random points (k = 24), and the tapered
    operator on a 24 x 24 grid (density 0.05, k = 8); fits rtol 1e-6."""
    kw = (dict(n=300, noise=0.05, scale=0.15, lanczos_steps=24,
               num_probes=4) if route == "matern" else
          dict(n=576, noise=0.05, scale=0.1, density=0.05, grid=True,
               lanczos_steps=GRID_STEPS, num_probes=4))
    want = jcmp.run_krylov(**kw)
    got = tcmp.run_krylov(device="cpu", **kw)
    for key in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_main_and_average_runs(tmp_path, monkeypatch):
    """main at small sizes on the CPU: rows per n, the slope, nothing
    written without a path; average_runs averages the timing fields of
    two runs and refits the slope, as the reference's does."""
    monkeypatch.chdir(tmp_path)
    res = tcmp.main(dense_sides=(6, 8), krylov_ns=(200,), verbose=False,
                    device="cpu")
    assert os.listdir(tmp_path) == []
    assert [r["n"] for r in res["dense"]] == [36, 64]
    assert [r["n"] for r in res["krylov"]] == [200]
    assert np.isfinite(res["derivative_slope"])
    other = copy_with_times(res, 2.0)
    avg = tcmp.average_runs([res, other])
    want = jcmp.average_runs([res, other])
    assert avg["num_runs"] == 2
    for a, w in zip(avg["dense"], want["dense"]):
        assert a["derivative"]["pre_s"] == w["derivative"]["pre_s"]
        assert a["direct"]["opt_s"] == w["direct"]["opt_s"]
    assert avg["krylov"][0]["pre_s"] == want["krylov"][0]["pre_s"]
    assert avg["derivative_slope"] == want["derivative_slope"]
    sparse = {"sparse": [{"n": 100, "pre_s": 1.0, "opt_s": 1.0,
                          "total_s": 2.0},
                         {"n": 400, "pre_s": 3.0, "opt_s": 1.0,
                          "total_s": 4.0}]}
    got = tcmp.average_runs([sparse, copy_with_times(sparse, 3.0)])
    assert got["sparse_slope"] == jcmp.average_runs(
        [sparse, copy_with_times(sparse, 3.0)])["sparse_slope"]
    assert tcmp.log_regression([1, 2, 4], [1.0, 4.0, 16.0]) == \
        pytest.approx(2.0)


def copy_with_times(res, factor):
    """A deep copy of a results dict with every timing field scaled."""
    import copy

    out = copy.deepcopy(res)

    def scale(d):
        for k, v in d.items():
            if k in ("pre_s", "opt_s", "total_s"):
                d[k] = v * factor
            elif isinstance(v, dict):
                scale(v)

    for key in ("dense", "krylov", "sparse"):
        for row in out.get(key, []):
            scale(row)
    return out
