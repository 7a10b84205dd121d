"""gppe_tpu_torch.ops.linalg vs gppe_tpu.ops.linalg, on the CPU in
float64 (the JAX package under x64, tests/conftest.py).

A Matern nu = 1/2 correlation of 200 seeded random points (condition
number ~1e2 at eta = 0.05) and seeded right-hand sides go through both
packages. Tolerances: the direct factorizations 1e-10 relative; the
iterative solvers at tol 1e-10 agree with each other to 1e-8 and with a
float64 dense solve to 1e-8 (relative to the solution).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gppe_tpu.ops import linalg as jla  # noqa: E402
from gppe_tpu_torch.ops import linalg as tla  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

N = 200


@pytest.fixture(scope="module")
def K():
    pts = np.random.RandomState(1).rand(N, 2)
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)) / 0.1
    return np.exp(-d)


@pytest.fixture(scope="module")
def rhs():
    return np.random.RandomState(2).standard_normal((N, 5))


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_eigh_float64_matches_reference(K):
    lam, Q = tla.eigh(torch.as_tensor(K, dtype=torch.float32))
    assert lam.dtype == Q.dtype == torch.float64
    jlam, jQ = jla.host_eigh(jnp.asarray(K))
    # the float32 input rounds K at 6e-8: the spectra agree to that level
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), atol=1e-6)
    lam, Q = tla.eigh(torch.as_tensor(K))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-10,
                               atol=1e-12)
    # eigenvectors up to sign: Q diag(lam) Q^T rebuilds K
    np.testing.assert_allclose((Q * lam) @ Q.T, K, atol=1e-12)


def test_cholesky_family(K, rhs):
    Kn = K + 0.3 * np.eye(N)
    L = tla.cholesky_factor(torch.as_tensor(Kn))
    jL = jla.cholesky_factor(jnp.asarray(Kn))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-10,
                               atol=1e-13)
    for B in (rhs, rhs[:, 0]):
        np.testing.assert_allclose(
            tla.cholesky_solve(L, torch.as_tensor(B)).numpy(),
            np.asarray(jla.cholesky_solve(jL, jnp.asarray(B))), rtol=1e-10)
    np.testing.assert_allclose(float(tla.cholesky_logdet(L)),
                               float(jla.cholesky_logdet(jL)), rtol=1e-12)
    for p in (1, 2):
        np.testing.assert_allclose(float(tla.cholesky_traceinv(L, p)),
                                   float(jla.cholesky_traceinv(jL, p)),
                                   rtol=1e-10)
    with pytest.raises(ValueError):
        tla.cholesky_traceinv(L, 3)


@pytest.mark.parametrize("form", ["dense", "callable"])
@pytest.mark.parametrize("shift", [0.05, 2.0])
def test_cg_batched_with_shift(K, rhs, form, shift):
    Kt = torch.as_tensor(K)
    A = Kt if form == "dense" else (lambda V: Kt @ V)
    got = tla.cg_solve(A, torch.as_tensor(rhs), tol=1e-10, shift=shift)
    jA = jnp.asarray(K) if form == "dense" else jla_callable(K)
    want = np.asarray(jla.cg_solve(jA, jnp.asarray(rhs), tol=1e-10,
                                   shift=shift))
    exact = np.linalg.solve(K + shift * np.eye(N), rhs)
    assert _rel(got.numpy(), exact) < 1e-8
    assert _rel(got.numpy(), want) < 1e-8


_CALLABLES = {}


def jla_callable(K):
    """A stable callable per matrix: the reference's CG takes it as a
    static jit argument."""
    key = id(K)
    if key not in _CALLABLES:
        Kj = jnp.asarray(K)
        _CALLABLES[key] = lambda V: jnp.matmul(Kj, V, precision="highest")
    return _CALLABLES[key]


def test_cg_masks_converged_columns(K, rhs):
    """A column that converges stops moving: a right-hand side of zeros
    is never updated, an easy column stops early, and the iteration counts
    say so; a single vector gives the solution of that column."""
    Kt = torch.as_tensor(K)
    B = torch.as_tensor(rhs[:, :3]).clone()
    B[:, 1] = 0.0
    B[:, 2] = Kt @ B[:, 0] + 2.0 * B[:, 0]   # exact solution B[:, 0]
    X, its = tla.cg_solve(Kt, B, tol=1e-10, shift=2.0,
                          return_iterations=True)
    assert its.dtype == torch.int64 and its[1] == 0
    assert torch.all(X[:, 1] == 0)
    assert 0 < its[2] <= its[0]
    assert _rel(X[:, 2].numpy(), rhs[:, 0]) < 1e-8
    x = tla.cg_solve(Kt, B[:, 0], tol=1e-10, shift=2.0)
    assert x.shape == (N,)
    np.testing.assert_allclose(x.numpy(), X[:, 0].numpy(), rtol=1e-12)
    # max_iter bounds every column's count
    _, its = tla.cg_solve(Kt, B, tol=1e-14, shift=0.01, max_iter=5,
                          return_iterations=True)
    assert int(its.max()) == 5


def test_cg_jacobi_preconditioner(K, rhs):
    Kn = K + np.diag(np.linspace(0.5, 50.0, N))
    M = torch.as_tensor(np.diag(Kn).copy())
    got = tla.cg_solve(torch.as_tensor(Kn), torch.as_tensor(rhs), tol=1e-10,
                       M_diag=M)
    want = np.asarray(jla.cg_solve(jnp.asarray(Kn), jnp.asarray(rhs),
                                   tol=1e-10, M_diag=jnp.asarray(M.numpy())))
    assert _rel(got.numpy(), np.linalg.solve(Kn, rhs)) < 1e-8
    assert _rel(got.numpy(), want) < 1e-8


@pytest.mark.parametrize("form", ["dense", "callable"])
def test_minres_indefinite(K, rhs, form):
    """K - 0.3 I is indefinite (K has eigenvalues below and above 0.3)."""
    shift = -0.3
    assert np.linalg.eigvalsh(K).min() < 0.3 < np.linalg.eigvalsh(K).max()
    Kt = torch.as_tensor(K)
    A = Kt if form == "dense" else (lambda V: Kt @ V)
    got = tla.minres_solve(A, torch.as_tensor(rhs), tol=1e-10, shift=shift,
                           max_iter=2000)
    jA = jnp.asarray(K) if form == "dense" else jla_callable(K)
    want = np.asarray(jla.minres_solve(jA, jnp.asarray(rhs), tol=1e-10,
                                       shift=shift, max_iter=2000))
    exact = np.linalg.solve(K + shift * np.eye(N), rhs)
    assert _rel(got.numpy(), exact) < 1e-7
    assert _rel(got.numpy(), want) < 1e-7
    x = tla.minres_solve(A, torch.as_tensor(rhs[:, 0]), tol=1e-10,
                         shift=shift, max_iter=2000)
    assert x.shape == (N,)
    assert _rel(x.numpy(), exact[:, 0]) < 1e-7
