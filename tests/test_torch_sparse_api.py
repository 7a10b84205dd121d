"""The tapered CSR and a scipy-sparse K through the public API:
gppe_tpu_torch against gppe_tpu, on the CPU in float64.

Inputs come from numpy seeds and go through both packages (JAX under x64,
tests/conftest.py). Tolerances:

* ``generate_tapered_correlation``: the indices and row pointers equal;
  the values to rtol 1e-14 where both packages take the native builder
  (the same C++ source and flags; FMA contraction may differ between
  builds), 1e-12 where either takes the blocked rule (a general nu, or the
  reference's own blocked rule when its native library is not built);
* ``SparseOperator`` products to atol 1e-12, its traces to rtol 1e-12;
* ``MixedCorrelation`` densified to rtol 1e-10; above the dense threshold
  its SLQ with the reference's own probes and deflation start handed in
  to rtol 1e-6, its CG solve to atol 1e-5 of the dense solve;
* ``GaussianProcess(X, Kcsr).train(z)``: the densified route to rtol
  1e-6; the Krylov engine over the SparseOperator, with the reference's
  draws, to rtol 1e-6 on random points (on a regular grid the constant
  column of X exhausts its Krylov space early; ROADMAP C).
"""

import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse  # noqa: E402

import gppe_tpu  # noqa: E402
import gppe_tpu_torch  # noqa: E402
from gppe_tpu import native as jnative  # noqa: E402
from gppe_tpu.models import large_scale as jls  # noqa: E402
from gppe_tpu.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation as JMixed)
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch import native  # noqa: E402
from gppe_tpu_torch.models import large_scale as tls  # noqa: E402
from gppe_tpu_torch.models.mixed_correlation import (  # noqa: E402
    MixedCorrelation as TMixed)
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

F64 = torch.float64
CPU = dict(device="cpu")


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


# -- the tapered CSR ----------------------------------------------------------

def _assert_same_csr(got, want, rtol):
    assert scipy.sparse.isspmatrix_csr(got) and got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=0)
    assert got.data.dtype == np.float64


@pytest.mark.parametrize("nu, d", [(0.5, 2), (1.5, 2), (2.5, 2), (1.2, 2),
                                   (0.5, 3), (1.2, 3)])
def test_generate_tapered_correlation(nu, d):
    """The port's builder against the reference's at the same points,
    scale and density: the native builder for the closed forms (d <= radius),
    the blocked rule at nu = 1.2 (k >= tau), in 2-D and 3-D."""
    pts = np.random.RandomState(d).rand(300, d)
    scale, density = 0.05 * d, 0.05
    want = jtaper.generate_tapered_correlation(pts, scale, nu, density)
    got = ttaper.generate_tapered_correlation(pts, scale, nu, density,
                                              dtype=F64, **CPU)
    both_native = native.serves(nu, d) and jnative.available()
    _assert_same_csr(got, want, 1e-14 if both_native else 1e-12)
    assert got.nnz > 300                    # more than the diagonal
    np.testing.assert_allclose(got.diagonal(), 1.0, rtol=0)


def test_blocked_rule_block_sizes_and_verbose(capsys):
    """The blocked rule keeps the same entries at any block size (their
    values within an ulp: the plain Bessel loop vectorises by shape);
    verbose names the builder."""
    pts = np.random.RandomState(5).rand(257, 2)
    full = ttaper.generate_tapered_correlation(pts, 0.08, 3.7, 0.05,
                                               verbose=True, dtype=F64,
                                               **CPU)
    assert "blocked" in capsys.readouterr().out
    for rows in (100, 1000):
        _assert_same_csr(ttaper.generate_tapered_correlation(
            pts, 0.08, 3.7, 0.05, block_rows=rows, dtype=F64, **CPU),
            full, 1e-15)
    ttaper.generate_tapered_correlation(pts, 0.08, 0.5, 0.05, verbose=True)
    assert "native" in capsys.readouterr().out


def test_native_shim():
    """The shim serves the closed forms in at most 8 dimensions and builds
    nothing until it is called there; its CSR is the reference shim's."""
    assert native.serves(0.5, 2) and native.serves(150.0, 8)
    assert not native.serves(0.77, 2) and not native.serves(0.5, 9)
    pts = np.random.default_rng(1).random((200, 3)) / 0.2
    assert native.taper_csr(pts, 1.0, 0.77) is None
    got = native.taper_csr(pts, 1.0, 1.5)
    assert native.available() and native.library_path().is_file()
    assert native.library_path().parent.name == "build"
    assert native.num_threads() >= 1
    if jnative.available():
        want = jnative.taper_csr(pts, 1.0, 1.5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-14, atol=0)


def _private_build(monkeypatch, tmp_path, cxxs):
    """Point the shim at a fresh library path under ``tmp_path`` and at the
    compilers ``cxxs``."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libnative_test.so")
    monkeypatch.setattr(native, "compilers", lambda: cxxs)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A build that fails with every compiler raises with their output;
    nothing falls back to the blocked rule, and nothing is left behind."""
    _private_build(monkeypatch, tmp_path, ["false"])
    assert native.available()
    with pytest.raises(RuntimeError, match="exit code"):
        ttaper.generate_tapered_correlation(
            np.random.RandomState(0).rand(100, 2), 0.1, 0.5, 0.1)
    assert list(tmp_path.iterdir()) == []
    _private_build(monkeypatch, tmp_path, [])
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load()


def test_native_build_tries_the_next_compiler(monkeypatch, tmp_path):
    """A compiler that cannot build with the reference's flags (one whose
    OpenMP runtime is missing comes first on some hosts' PATH) is passed
    over for the next one, which builds the same CSR with those flags; the
    order is ``$CXX``, ``g++`` on PATH, ``/usr/bin/g++``."""
    script = tmp_path / "cxx_without_openmp"
    script.write_text('#!/bin/sh\ncase "$*" in *-fopenmp*) echo "cannot '
                      'read spec file libgomp.spec" >&2; exit 1;; esac\n'
                      f'exec {shutil.which("g++")} "$@"\n')
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    assert native.compilers()[:2] == [str(script), shutil.which("g++")]
    pts = np.random.RandomState(4).rand(300, 2) / 0.05
    want = native.taper_csr(pts, 2.0, 1.5)
    _private_build(monkeypatch, tmp_path / "lib", [str(script),
                                                   shutil.which("g++")])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = native.taper_csr(pts, 2.0, 1.5)
    assert native.num_threads() >= 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _private_build(monkeypatch, tmp_path / "only", [str(script)])
    with pytest.raises(RuntimeError, match="libgomp"):
        native.load()


def test_generate_correlation_sparse():
    """generate_correlation(sparse=True) against the reference's, closed
    form and general nu, anisotropic scale."""
    pts = np.random.RandomState(2).rand(250, 2)
    scale = np.array([0.06, 0.1])
    for nu in (0.5, 0.8):
        want = gppe_tpu.generate_correlation(pts, scale, nu=nu, sparse=True,
                                             density=0.08)
        got = gppe_tpu_torch.generate_correlation(
            pts, scale, nu=nu, sparse=True, density=0.08, dtype=F64, **CPU)
        _assert_same_csr(got, want, 1e-12)
    with pytest.raises(ValueError, match="Adjacency"):
        gppe_tpu_torch.generate_correlation(pts, 0.1, sparse=True,
                                            density=1e-3, **CPU)


def test_nnz_estimate():
    pts = np.random.RandomState(3).rand(500, 2)
    for nu in (0.5, 1.2):
        kw = dict(nu=nu, density=0.05, tile=128)
        assert ttaper.TaperedMaternOperator(
            pts, 0.05, device="cpu", dtype=F64, **kw).nnz_estimate() == \
            jtaper.TaperedMaternOperator(pts, 0.05, use_pallas=False,
                                         **kw).nnz_estimate()


# -- SparseOperator and MixedCorrelation (tests/test_sparse_api.py) -----------

@pytest.fixture(scope="module")
def sparse_problem():
    """tests/test_sparse_api.py's problem: n = 400 grid, rho 0.03, density
    0.15, nu = 1/2, each package's own CSR (equal, see above)."""
    pts = data_utils.generate_points(20, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    jcsr = gppe_tpu.generate_correlation(pts, 0.03, nu=0.5, sparse=True,
                                         density=0.15)
    tcsr = gppe_tpu_torch.generate_correlation(pts, 0.03, nu=0.5,
                                               sparse=True, density=0.15,
                                               **CPU)
    return pts, z, X, jcsr, tcsr


def test_sparse_operator(sparse_problem):
    _, _, _, jcsr, tcsr = sparse_problem
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jop = jops.SparseOperator(jcsr)
    top = tops.SparseOperator(tcsr, device="cpu", dtype=F64)
    assert top.shape == jop.shape and top.nnz == jop.nnz == tcsr.nnz
    assert top._csr.crow_indices().dtype == torch.int32
    assert top._csr.col_indices().dtype == torch.int32
    rng = np.random.default_rng(0)
    V = rng.standard_normal((400, 3))
    np.testing.assert_allclose(top.matmat(V).numpy(),
                               np.asarray(jop.matmat(jnp.asarray(V))),
                               rtol=0, atol=1e-12)
    v = rng.standard_normal(400)
    got = top.matvec(v)
    assert got.shape == (400,)
    np.testing.assert_allclose(got.numpy(), tcsr @ v, rtol=0, atol=1e-12)
    for p in (0, 1, 2):
        assert top.trace_pow(p).dtype == F64
        np.testing.assert_allclose(float(top.trace_pow(p)),
                                   float(jop.trace_pow(p)), rtol=1e-12)
    with pytest.raises(ValueError, match="exponent"):
        top.trace_pow(3)
    np.testing.assert_array_equal(top.dense().numpy(), tcsr.toarray())
    # a COO input, and float32 values
    op32 = tops.SparseOperator(tcsr.tocoo(), device="cpu",
                               dtype=torch.float32)
    assert op32.matmat(V).dtype == torch.float32
    np.testing.assert_allclose(op32.matmat(V).numpy(), tcsr @ V, atol=1e-5)
    with pytest.raises(ValueError, match="square"):
        tops.SparseOperator(scipy.sparse.csr_matrix(np.ones((3, 4))),
                            device="cpu")


def test_mixed_correlation_densified(sparse_problem):
    _, _, _, jcsr, tcsr = sparse_problem
    for method in ("eigenvalue", "cholesky"):
        jm = JMixed(jcsr, method=method)
        tm = TMixed(tcsr, method=method, **CPU)
        assert tm.is_sparse and jm.is_sparse and tm.method == method
        assert torch.is_tensor(tm.K) and tm.K.dtype == F64
        for eta in (0.3, 7.0):
            np.testing.assert_allclose(float(tm.traceinv(eta)),
                                       float(jm.traceinv(eta)), rtol=1e-10)
            np.testing.assert_allclose(float(tm.logdet(eta)),
                                       float(jm.logdet(eta)), rtol=1e-10)


def _reference_options(n, key=0, num_probes=16):
    """The reference SLQ engine's draws for ``key``, as port options."""
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
    return {"probes": np.array(jax.random.rademacher(
                k_probe, (n, num_probes), dtype=jnp.float64)),
            "v_defl": np.array(jax.random.normal(k_defl, (n, 1),
                                                 dtype=jnp.float64))}


def test_mixed_correlation_operator_route(random_csr_problem):
    """dense_threshold=0: the CSR becomes a float64 SparseOperator and
    'eigenvalue' switches to 'slq' with the reference's warning; traceinv
    and logdet against the reference's SLQ from the same draws (on random
    points: on tests/test_sparse_api.py's grid the two agree to 7e-5), the
    CG solve against the dense solve."""
    z, _, csr = random_csr_problem
    n = csr.shape[0]
    opts = dict(num_probes=16)
    with pytest.warns(UserWarning, match="switching to 'slq'"):
        jm = JMixed(csr, method="eigenvalue", dense_threshold=0,
                    options=opts)
    with pytest.warns(UserWarning, match="switching to 'slq'"):
        tm = TMixed(csr, method="eigenvalue", dense_threshold=0,
                    options={**opts, **_reference_options(n)}, **CPU)
    assert tm.method == "slq" and isinstance(tm.K, tops.SparseOperator)
    assert tm.K.dtype == F64 and tm.dtype == F64
    Kd = csr.toarray()
    for eta in (0.5, 5.0):
        np.testing.assert_allclose(float(tm.traceinv(eta)),
                                   float(jm.traceinv(eta)), rtol=1e-6)
        np.testing.assert_allclose(float(tm.logdet(eta)),
                                   float(jm.logdet(eta)), rtol=1e-6)
        np.testing.assert_allclose(
            tm.solve(eta, z).numpy(),
            np.linalg.solve(Kd + eta * np.eye(n), np.asarray(z)), atol=1e-5)
    # another method keeps its name; no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TMixed(csr, method="hutchinson", **CPU).method == "hutchinson"


# -- GaussianProcess over a CSR -----------------------------------------------

@pytest.mark.parametrize("method", ["direct", "profiled"])
def test_train_densified_matches_reference(sparse_problem, method):
    _, z, X, jcsr, tcsr = sparse_problem
    want = gppe_tpu.GaussianProcess(X, jcsr, method).train(z)
    got = gppe_tpu_torch.GaussianProcess(X, tcsr, method, **CPU).train(z)
    assert got["success"] and want["success"]
    for name in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)


@pytest.fixture(scope="module")
def random_csr_problem():
    """Random points (a regular grid exhausts the Krylov space of X's
    constant column early): n = 400, rho 0.04, density 0.1."""
    pts = np.random.RandomState(8).rand(400, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    csr = gppe_tpu_torch.generate_correlation(pts, 0.04, nu=0.5,
                                              sparse=True, density=0.1,
                                              **CPU)
    return z, X, csr


def test_krylov_engine_over_csr_matches_reference(random_csr_problem):
    """KrylovProfileLikelihood over each package's SparseOperator of the
    same CSR, from the reference's own draws for key 0: factorization, der1
    and the fit to rtol 1e-6."""
    z, X, csr = random_csr_problem
    steps, probes = 24, 8
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(0))
    draws = dict(
        probes=np.array(jax.random.rademacher(k_probe, (400, probes),
                                              dtype=jnp.float64)),
        v_defl=np.array(jax.random.normal(k_defl, (400, 1),
                                          dtype=jnp.float64)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jeng = jls.KrylovProfileLikelihood(
            jops.SparseOperator(csr), X, z, lanczos_steps=steps,
            num_probes=probes, key=0)
    teng = tls.KrylovProfileLikelihood(
        tops.SparseOperator(csr, device="cpu", dtype=F64), X, z,
        lanczos_steps=steps, num_probes=probes, device="cpu", dtype=F64,
        **draws)
    for name in ("alphas", "betas", "U", "G"):
        np.testing.assert_allclose(getattr(teng, name), getattr(jeng, name),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    got, want = teng.fit(), jeng.fit()
    assert got["success"] and want["success"]
    for name in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)


@pytest.mark.parametrize("method", ["direct", "profiled"])
def test_train_operator_route(random_csr_problem, method):
    """dense_threshold=0 through the facade: the Krylov route over a
    float64 SparseOperator, both methods the same fit (the engine with its
    own draws for key 0, bit for bit), and near the exact route's (eta
    5e-2, sigma0 1e-2: the reference's own bounds for this route)."""
    z, X, csr = random_csr_problem
    with pytest.warns(UserWarning, match="slq"):
        gp = gppe_tpu_torch.GaussianProcess(
            X, csr, method, dense_threshold=0, lanczos_steps=24,
            num_probes=8, **CPU)
    assert gp.likelihood.operator_mode
    got = gp.train(z)
    engine = tls.KrylovProfileLikelihood(
        tops.SparseOperator(csr, device="cpu", dtype=F64), X, z,
        lanczos_steps=24, num_probes=8, device="cpu", dtype=F64).fit()
    for name in ("eta", "sigma", "sigma0"):
        assert got[name] == engine[name]
    exact = gppe_tpu_torch.GaussianProcess(X, csr, "profiled",
                                           **CPU).train(z)
    assert got["eta"] == pytest.approx(exact["eta"], rel=5e-2)
    assert got["sigma0"] == pytest.approx(exact["sigma0"], rel=1e-2)
