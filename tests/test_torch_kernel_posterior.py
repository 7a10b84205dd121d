"""The ported dense posterior targets (models.kernel_posterior) vs the JAX
reference, on the CPU in float64.

Both packages see the same numpy data (random points and an 8 x 8 grid,
n = 64). Values are held to rtol 1e-10 against
``gppe_tpu.models.kernel_posterior``; gradients by ``torch.func.grad``
against ``jax.grad``, and where nu is a coordinate, forward mode
(``torch.func.jacfwd``) and ``torch.func.grad`` against ``jax.jacfwd``,
to rtol 1e-8 with an absolute floor of 1e-8 of the largest component.
Under those transforms the Bessel K_nu runs its fixed-trip form, which
``torch.func.vmap`` batches over chains.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import kernel_posterior as jkp  # noqa: E402
from gppe_tpu_torch.models import kernel_posterior as tkp  # noqa: E402
from gppe_tpu_torch.models import priors as tpriors  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F64 = torch.float64
RTOL, GRAD_RTOL = 1e-10, 1e-8
CPU = {"device": "cpu"}


def problem(kind):
    pts = (tdata.generate_points(8, dimension=2) if kind == "grid"
           else np.random.RandomState(3).rand(64, 2))
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2))


def assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.max(np.abs(want)))


def check(f_t, f_j, thetas, modes=("rev",)):
    """Values (vmapped over the points) at RTOL and the gradient of each
    mode in ``modes`` at GRAD_RTOL, port against reference: "rev" alone
    against ``jax.grad``; with "fwd", every mode against ``jax.jacfwd``
    (one JAX transform per target: its compile dominates the file)."""
    th = np.asarray(thetas, dtype=np.float64)
    np.testing.assert_allclose(
        torch.func.vmap(f_t)(torch.as_tensor(th)).numpy(),
        np.asarray(jax.jit(jax.vmap(f_j))(th)), rtol=RTOL)
    jf = jax.jacfwd if "fwd" in modes else jax.grad
    want = jax.jit(jax.vmap(jf(f_j)))(th)
    for mode in modes:
        tf = {"rev": torch.func.grad, "fwd": torch.func.jacfwd}[mode]
        assert_grad_close(torch.func.vmap(tf(f_t))(torch.as_tensor(th)),
                          want)


ETA_RHO = [(-1.0, -1.2), (0.3, -0.9), (1.0, -0.6), (2.5, -0.35)]


@pytest.mark.parametrize("nu", [0.5, 1.5, 1.2])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_profile_loglik(kind, nu):
    """lp(log10 eta, log10 rho) and its gradient at nu = 1/2, 3/2 and a
    general 1.2 (the Bessel form)."""
    pts, z, X = problem(kind)
    lp_t = tkp.make_profile_loglik(pts, z, X, nu=nu, **CPU)
    lp_j = jkp.make_profile_loglik(pts, z, X, nu=nu)
    check(lambda t: lp_t(t[0], t[1]), lambda t: lp_j(t[0], t[1]), ETA_RHO)


ETA_RHO_NU = [(-0.5, -1.1, 1.3), (0.4, -0.8, 2.5), (1.0, -0.6, 7.7),
              (2.0, -0.4, 19.0)]


@pytest.mark.parametrize("kind,unique", [("grid", None), ("grid", False),
                                         ("random", None)])
def test_profile_loglik_nu(kind, unique):
    """lp(log10 eta, log10 rho, nu) with nu traced: on a grid through the
    distinct distances (the default there) and through all n^2, on random
    points through all n^2 (the default there); the values, the reverse
    gradient and forward mode in all three coordinates."""
    pts, z, X = problem(kind)
    lp_t = tkp.make_profile_loglik_nu(pts, z, X, unique_distances=unique,
                                      max_order=20, **CPU)
    lp_j = jkp.make_profile_loglik_nu(pts, z, X, unique_distances=unique)
    check(lambda t: lp_t(t[0], t[1], t[2]), lambda t: lp_j(t[0], t[1], t[2]),
          ETA_RHO_NU, modes=("rev", "fwd"))


def test_log_posterior_with_prior():
    """make_log_posterior with a natural-parameter prior (and its log10
    Jacobian), values and gradients."""
    pts, z, X = problem("random")
    post_t = tkp.make_log_posterior(
        pts, z, X, nu=1.5, log_prior=lambda e, r: (
            tpriors.inverse_square_log_prior(r)
            + tpriors.uniform_log_prior(e, (1e-3, 1e4))), **CPU)
    from gppe_tpu.models import priors as jpriors
    post_j = jkp.make_log_posterior(
        pts, z, X, nu=1.5, log_prior=lambda e, r: (
            jpriors.inverse_square_log_prior(r)
            + jpriors.uniform_log_prior(e, (1e-3, 1e4))))
    check(post_t, post_j, ETA_RHO)


U2 = [(-20.0, 20.0), (20.0, -20.0), (0.0, 0.0), (1.3, -0.7)]


def test_bounded_log_posterior():
    """The sigmoid-bounded (eta, rho) target: u_to_theta at u = +-20 stays
    inside the box (the 1e-6 margin) and equals the reference's; values
    and gradients inside."""
    pts, z, X = problem("grid")
    bounds = ((-3.0, 4.0), (-2.0, 0.0))
    post_t, u2t_t = tkp.make_bounded_log_posterior(
        pts, z, X, nu=0.5, log10_bounds=bounds, **CPU)
    post_j, u2t_j = jkp.make_bounded_log_posterior(pts, z, X, nu=0.5,
                                                   log10_bounds=bounds)
    u = np.asarray(U2)
    th = u2t_t(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(th, np.asarray(u2t_j(jnp.asarray(u))),
                               rtol=1e-12)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    assert np.all((th > lo) & (th < hi))
    check(post_t, post_j, U2[2:] + [(-1.0, 0.5), (0.7, 1.9)])


def test_bounded_log_posterior_nu():
    """The sigmoid-bounded (eta, rho, nu) target with the reference's
    inverse-square priors: the box at u = +-20, values, reverse and
    forward gradients."""
    pts, z, X = problem("grid")
    from gppe_tpu.models import priors as jpriors

    def prior(mod):
        return lambda e, r, nu: (mod.inverse_square_log_prior(r)
                                 + mod.inverse_square_log_prior(nu, 25.0))
    kw = dict(log10_bounds=((-3.0, 4.0), (-2.0, 0.0)), nu_bounds=(1.0, 25.0))
    post_t, u2t_t = tkp.make_bounded_log_posterior_nu(
        pts, z, X, log_prior=prior(tpriors), **kw, **CPU)
    post_j, u2t_j = jkp.make_bounded_log_posterior_nu(
        pts, z, X, log_prior=prior(jpriors), **kw)
    u = np.array([[-20.0, 20.0, -20.0], [20.0, -20.0, 20.0]])
    th = u2t_t(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(th, np.asarray(u2t_j(jnp.asarray(u))),
                               rtol=1e-12)
    assert np.all((th[:, 2] > 1.0) & (th[:, 2] < 25.0))
    check(post_t, post_j, [(0.0, 0.0, 0.0), (1.0, -0.5, -1.0),
                           (-0.8, 0.6, 1.4)], modes=("rev", "fwd"))


def test_profiled_rho_nu_posterior():
    """The eta-profiled (rho, nu) target: values at rtol 1e-10 and forward
    gradients at 1e-8 (the grid search and the golden-section refinement
    inside the target, eta maximized out), the box at u = +-20."""
    pts, z, X = problem("grid")
    kw = dict(log10_eta_bounds=(-3.0, 4.0), log10_rho_bounds=(-1.3, -0.3),
              nu_bounds=(1.0, 25.0), eta_grid=15, golden_iters=12)
    post_t, u2t_t = tkp.make_profiled_rho_nu_posterior(pts, z, X, **kw,
                                                       **CPU)
    post_j, u2t_j = jkp.make_profiled_rho_nu_posterior(pts, z, X, **kw)
    u = np.array([[-20.0, 20.0], [20.0, -20.0]])
    np.testing.assert_allclose(u2t_t(torch.as_tensor(u)).numpy(),
                               np.asarray(u2t_j(jnp.asarray(u))), rtol=1e-12)
    check(post_t, post_j, [(0.0, 0.0), (1.0, -1.0), (-0.7, 1.2)],
          modes=("fwd",))


def test_grid_evaluate():
    """grid_evaluate over a 3 x 4 (eta, rho) grid equals the reference's
    and the pointwise values."""
    pts, z, X = problem("random")
    lp_t = tkp.make_profile_loglik(pts, z, X, nu=0.5, **CPU)
    lp_j = jkp.make_profile_loglik(pts, z, X, nu=0.5)
    etas, rhos = np.linspace(-1.0, 2.0, 3), np.linspace(-1.3, -0.4, 4)
    got = tkp.grid_evaluate(lp_t, etas, rhos).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jkp.grid_evaluate(lp_j, jnp.asarray(etas),
                                          jnp.asarray(rhos))), rtol=RTOL)
    np.testing.assert_allclose(got[1, 2], float(lp_t(etas[1], rhos[2])),
                               rtol=1e-14)


def test_failed_factorization_is_nan():
    """K + eta I not positive definite gives NaN, as the reference's
    Cholesky does (``jnp.linalg.cholesky``), and does not raise; vmapped
    over eta beside a healthy lane, only the failed lane is NaN."""
    _, z, X = problem("random")
    K = torch.eye(64, dtype=F64)
    vals = torch.func.vmap(lambda eta: tkp._profile_lp(
        K, eta, torch.as_tensor(z), torch.as_tensor(X)))(
        torch.tensor([1.0, -2.0], dtype=F64))
    assert np.isfinite(float(vals[0])) and np.isnan(float(vals[1]))
    assert np.isnan(np.asarray(jnp.linalg.cholesky(-jnp.eye(4)))).any()


@pytest.mark.parametrize("nu", [0.3, 1.2, 3.7, 24.9])
def test_fixed_trip_bessel_form(nu):
    """kernels.matern under torch.func.vmap (the fixed-trip Bessel loops
    that every transform runs) equals its plain early-exit evaluation, for
    a number nu and a tensor nu capped at max_order = 25, within 1e-14
    over x in geomspace(1e-5, 40); vmapped over (rho, nu) points under
    jacfwd it equals the pointwise reverse-mode gradients (rtol 1e-12,
    absolute floor 1e-12 of the largest component)."""
    from gppe_tpu_torch.ops import kernels
    x = torch.as_tensor(np.geomspace(1e-5, 40.0, 64))
    xs = torch.stack([x, x])
    batched = torch.func.vmap(lambda r: kernels.matern(r, nu))(xs)
    for row in batched:
        np.testing.assert_allclose(row.numpy(), kernels.matern(x, nu).numpy(),
                                   rtol=1e-14, atol=1e-300)
    t = torch.tensor([nu, nu], dtype=F64)
    batched = torch.func.vmap(
        lambda v: kernels.matern(x, v, max_order=25))(t)
    for row in batched:
        np.testing.assert_allclose(
            row.numpy(), kernels.matern(x, t[0], max_order=25).numpy(),
            rtol=1e-14, atol=1e-300)

    def f(v):
        return torch.sum(kernels.matern(x / v[0], v[1], max_order=25))
    vs = torch.tensor([[0.5, nu], [2.0, nu * 0.9]], dtype=F64)
    batched = torch.func.vmap(torch.func.jacfwd(f))(vs)
    for v, g in zip(vs, batched):
        want = torch.func.grad(f)(v).numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
