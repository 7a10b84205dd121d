"""The float64 reference against exact dense float64 at tiny sizes: its
products, its tapered stencil and kept pairs, and its Galerkin estimate on a
full basis, which is the exact profile-likelihood fit."""

import numpy as np
import pytest
import scipy.optimize
import scipy.spatial
import torch

from benchmark.data import grid_points, polynomial_basis
from benchmark.reference import krylov, matern, tapered


def _dense_k(points, rho, nu):
    x = scipy.spatial.distance.cdist(points, points) / rho
    return tapered.correlation(x, nu)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_dense_product(nu):
    rng = np.random.default_rng(0)
    points = rng.random((300, 2))
    V = rng.standard_normal((300, 5))
    K = _dense_k(points, 0.1, nu)
    out, trace_k2 = matern.apply(torch.as_tensor(points), 0.1, nu,
                                 torch.as_tensor(V), block_rows=64)
    np.testing.assert_allclose(out.numpy(), K @ V, rtol=1e-12, atol=1e-12)
    assert trace_k2 == pytest.approx(float(np.sum(K * K)), rel=1e-13)


@pytest.mark.parametrize("nu", [0.5, 1.2])
def test_tapered_product_and_pairs(nu):
    side, rho, density = 12, 0.08, 0.1
    taper = tapered.GridTaper(side, rho, nu, density)
    points = grid_points(side)
    K = _dense_k(points, rho, nu)
    K = np.where(K >= taper.tau, K, 0.0)
    assert taper.kept_ordered_pairs == int(np.count_nonzero(K))
    assert taper.trace_k2 == pytest.approx(float(np.sum(K * K)), rel=1e-13)
    V = np.random.default_rng(1).standard_normal((side * side, 3))
    out = taper.apply(torch.as_tensor(V))
    np.testing.assert_allclose(out.numpy(), K @ V, rtol=1e-12, atol=1e-12)
    assert taper.margin > 1e-6


def test_radius_matches_the_density_rule():
    """n = 2^20 at density 1e-3: 1048.6 neighbours in a disc of 18.27 grid
    spacings, 3.5717 in units of rho = 0.005 (the program's operator)."""
    radius, tau = tapered.radius_threshold(1 << 20, 2, 1e-3, 0.005, 0.5)
    assert radius == pytest.approx(3.5717, abs=1e-4)
    assert tau == pytest.approx(np.exp(-radius), rel=1e-14)


def _problem(n=60, seed=3):
    """A draw of the model itself, sigma = 1 and sigma0 = 0.3, whose
    optimum lies inside the interval."""
    rng = np.random.default_rng(seed)
    points = rng.random((n, 2))
    K = _dense_k(points, 0.2, 0.5)
    X = polynomial_basis(points, 2)
    z = (np.linalg.cholesky(K) @ rng.standard_normal(n)
         + 0.3 * rng.standard_normal(n))
    return K, X, z


def _full_basis_engine(K, X, z):
    """The reference engine on a full basis (k = n) whose first vector is
    each column's own: its Galerkin solves are exact, and with the
    eigenvalues of K as its quadrature so are its traces."""
    n, m = X.shape
    A = np.concatenate([z[:, None], X], axis=1)
    rng = np.random.default_rng(5)
    Ks = torch.as_tensor(K)
    T, B, Q = [], [], []
    for j in range(m + 1):
        V = torch.as_tensor(np.concatenate(
            [A[:, j:j + 1], rng.standard_normal((n, n - 1))], axis=1))
        Qj, R, Tj = krylov.project(V, Ks @ V)
        assert torch.all(torch.diagonal(R) > 0)
        np.testing.assert_allclose(Tj.numpy(), (Qj.T @ Ks @ Qj).numpy(),
                                   atol=1e-10)
        T.append(Tj.numpy())
        B.append((Qj.T @ torch.as_tensor(A)).numpy())
        Q.append(Qj)
    G = np.array([[(Qi.T @ Qj).numpy() for Qj in Q] for Qi in Q])
    quad = krylov.Quadrature(np.linalg.eigvalsh(K), np.ones(n))
    return krylov.Engine(np.array(T), np.array(B), G, quad, n, m, A.T @ A)


def _exact_lp(K, X, z, eta):
    n, m = X.shape
    Kn = K + eta * np.eye(n)
    Kinv = np.linalg.inv(Kn)
    B = X.T @ Kinv @ X
    M = Kinv - Kinv @ X @ np.linalg.solve(B, X.T @ Kinv)
    zMz = z @ M @ z
    sigma2 = zMz / (n - m)
    lp = (-0.5 * (n - m) * np.log(sigma2) - 0.5 * np.linalg.slogdet(Kn)[1]
          - 0.5 * np.linalg.slogdet(B)[1] - 0.5 * zMz / sigma2)
    return lp, zMz, z @ M @ M @ z, B


def test_engine_solves_are_exact():
    K, X, z = _problem()
    engine = _full_basis_engine(K, X, z)
    for eta in (0.01, 0.3, 5.0):
        st = engine._eta_stats(eta)
        _, zMz, zM2z, B = _exact_lp(K, X, z, eta)
        assert st["zMz"] == pytest.approx(zMz, rel=1e-9)
        assert st["zM2z"] == pytest.approx(zM2z, rel=1e-8)
        np.testing.assert_allclose(st["B"], B, rtol=1e-9)


def test_engine_fit_is_the_exact_estimate():
    K, X, z = _problem()
    n, m = X.shape
    engine = _full_basis_engine(K, X, z)
    fit = engine.fit()
    best = scipy.optimize.minimize_scalar(
        lambda t: -_exact_lp(K, X, z, 10.0 ** t)[0], bounds=(-4, 3),
        method="bounded", options={"xatol": 1e-10})
    eta = 10.0 ** best.x
    assert fit["eta"] == pytest.approx(eta, rel=1e-5)
    lp, zMz, _, _ = _exact_lp(K, X, z, eta)
    assert fit["sigma"] == pytest.approx(np.sqrt(zMz / (n - m)), rel=1e-5)
    assert fit["lp"] == pytest.approx(lp, abs=1e-8)
