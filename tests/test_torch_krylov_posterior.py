"""The ported posterior surfaces (models.krylov_posterior) vs the JAX
reference, on the CPU in float64.

Both packages see the same numpy data and the reference's own random
block (``jax.random`` from ``PRNGKey(key)``, handed to the port as
``probes=`` / ``v_defl=``). Surface values, ``logdet`` and gradients
(``torch.autograd`` against ``jax.grad``) are held to rtol 1e-8 where
Lanczos stops before the Krylov space is exhausted: on random points
(n = 400, k = 32; n = 120, k = 12) and, on the 12 x 12 grid (n = 144),
at k = 8 (ROADMAP, watch list: past exhaustion the tails of the two
packages' bases part). Gradients get an absolute floor of 1e-8 of their
largest component, for the components that vanish at a node.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import krylov_posterior as jkp  # noqa: E402
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu_torch.models import krylov_posterior as tkp  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F32, F64 = torch.float32, torch.float64
RTOL = 1e-8
GRID_STEPS = 8


def jax_block(n, p, key):
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
    return (np.array(jax.random.rademacher(k_probe, (n, p),
                                           dtype=jnp.float64)),
            np.array(jax.random.normal(k_defl, (n, 1), dtype=jnp.float64)))


def problem(pts):
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2))


def surfaces(pts, key=3, jax_kw=None, torch_kw=None, rho_nu=False, **kw):
    """The reference's surface and the port's on the same data and
    random block."""
    pts, z, X = problem(pts)
    probes, v_defl = jax_block(len(pts), kw["num_probes"], key)
    cls = ("KrylovPosteriorSurfaceRhoNu" if rho_nu
           else "KrylovPosteriorSurface")
    js = getattr(jkp, cls)(pts, z, X, key=key, **kw, **(jax_kw or {}))
    ts = getattr(tkp, cls)(pts, z, X, key=key, device="cpu", dtype=F64,
                           probes=probes, v_defl=v_defl, **kw,
                           **(torch_kw or {}))
    return js, ts


def assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(want)))


def check_points(js, ts, points):
    """lp, logdet and the gradient of lp at each point (the reference's
    three jitted once over the batch of points)."""
    thetas = jnp.asarray(points, dtype=jnp.float64)
    lp = jax.jit(jax.vmap(lambda t: js.profile_loglik(*t)))(thetas)
    ld = jax.jit(jax.vmap(lambda t: js.logdet(*t)))(thetas)
    grads = jax.jit(jax.vmap(jax.grad(lambda t: js.profile_loglik(*t))))(
        thetas)
    for th, want_lp, want_ld, want in zip(points, lp, ld, grads):
        np.testing.assert_allclose(float(ts.profile_loglik(*th)),
                                   float(want_lp), rtol=RTOL)
        np.testing.assert_allclose(float(ts.logdet(*th)), float(want_ld),
                                   rtol=RTOL)
        t = torch.tensor(th, dtype=F64, requires_grad=True)
        got, = torch.autograd.grad(ts.profile_loglik(*t), t)
        assert_grad_close(got.numpy(), want)


# -- the helpers --------------------------------------------------------------

def test_cholesky_solve_small_matches():
    """A batch of SPD 6 x 6 systems: x and logdet rtol 1e-12 against the
    reference's unrolled solve; a sick (indefinite) one stays finite at
    the pivot floor, as the reference's does, where
    torch.linalg.cholesky raises."""
    rng = np.random.RandomState(0)
    M = rng.standard_normal((5, 6, 6))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(6)
    b = rng.standard_normal((5, 6))
    wx, wl = jkp._cholesky_solve_small(jnp.asarray(A), jnp.asarray(b))
    gx, gl = tkp._cholesky_solve_small(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-12)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-12)
    np.testing.assert_allclose(gx.numpy(), np.linalg.solve(A, b[..., None])
                               [..., 0], rtol=1e-10)
    sick = A[0].copy()
    sick[3, 3] = -1.0
    wx, wl = jkp._cholesky_solve_small(jnp.asarray(sick), jnp.asarray(b[0]))
    gx, gl = tkp._cholesky_solve_small(torch.as_tensor(sick),
                                       torch.as_tensor(b[0]))
    assert bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gl))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-10)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.as_tensor(sick))


@pytest.mark.parametrize("num", [2, 3, 9, 12])
def test_chebyshev_lobatto_matches(num):
    for got, want in zip(tkp._chebyshev_lobatto(-1.5, -0.5, num),
                         jkp._chebyshev_lobatto(-1.5, -0.5, num)):
        np.testing.assert_array_equal(got, want)


# -- KrylovPosteriorSurface ---------------------------------------------------

@pytest.fixture(scope="module")
def random_surfaces():
    """n = 400 random points, nu = 1/2, 12 nodes, k = 32, 12 probes: the
    multi-rho kernel's route (its plain version here)."""
    pts = np.random.RandomState(0).rand(400, 2)
    return surfaces(pts, nu=0.5, log10_rho_bounds=(-1.5, -0.5),
                    num_nodes=12, lanczos_steps=32, num_probes=12,
                    block_rows=128, jax_kw={"use_pallas": False})


POINTS_2D = [(-1.0, -1.3), (0.5, -0.9), (1.2, -0.77), (2.0, -0.55),
             (0.3, -0.5)]


def test_surface_random_points_match(random_surfaces):
    js, ts = random_surfaces
    np.testing.assert_array_equal(ts.log10_rho_nodes, js.log10_rho_nodes)
    check_points(js, ts, POINTS_2D)


def test_surface_node_hit_is_finite(random_surfaces):
    """At an exact node the clamped barycentric weights give the node's
    value and a finite gradient, as the reference's."""
    js, ts = random_surfaces
    node = float(ts.log10_rho_nodes[4])
    check_points(js, ts, [(1.0, node)])


def test_surface_general_nu_matches():
    """A general nu (1.2) on the default route: the general-nu kernel's
    batched product and trace (their plain versions), n = 120 random
    points, 3 nodes, k = 12."""
    pts = np.random.RandomState(0).rand(120, 2)
    js, ts = surfaces(pts, nu=1.2, log10_rho_bounds=(-1.2, -0.6),
                      num_nodes=3, lanczos_steps=12, num_probes=6,
                      block_rows=64, jax_kw={"use_pallas": False})
    check_points(js, ts, [(0.5, -0.8), (1.5, -1.0)])


def test_surface_through_operator_factories(random_surfaces):
    """operator_factory=MaternOperator on the random points gives the
    default route's surface (rtol 1e-8: the same products, one node at a
    time); operator_factory=GridMaternOperator on the 12 x 12 grid (k = 8)
    the reference's surface over its FFT operator."""
    js, ts = random_surfaces
    pts, z, X = problem(np.random.RandomState(0).rand(400, 2))
    probes, v_defl = jax_block(400, 12, 3)
    route = tkp.KrylovPosteriorSurface(
        pts, z, X, nu=0.5, log10_rho_bounds=(-1.5, -0.5), num_nodes=12,
        lanczos_steps=32, num_probes=12, device="cpu", dtype=F64,
        probes=probes, v_defl=v_defl,
        operator_factory=lambda rho: tops.MaternOperator(
            pts, rho, nu=0.5, device="cpu", dtype=F64))
    for th in POINTS_2D:
        np.testing.assert_allclose(float(route.profile_loglik(*th)),
                                   float(ts.profile_loglik(*th)), rtol=RTOL)

    grid = tdata.generate_points(12, dimension=2)
    js, ts = surfaces(
        grid, nu=0.5, log10_rho_bounds=(-1.2, -0.6), num_nodes=6,
        lanczos_steps=GRID_STEPS, num_probes=8,
        jax_kw={"operator_factory": lambda rho: jops.GridMaternOperator(
            grid, rho, nu=0.5)},
        torch_kw={"operator_factory": lambda rho: tops.GridMaternOperator(
            grid, rho, nu=0.5, device="cpu", dtype=F64)})
    check_points(js, ts, [(0.0, -0.9), (1.0, -1.1), (-1.0, -0.7)])


def test_surface_targets(random_surfaces):
    """make_log_posterior (with a prior and its log10 Jacobian) and the
    bounded target's box and value against the reference's; the same
    values under torch.func.vmap over a batch of points, and vmap(grad)
    equal to the pointwise gradients."""
    js, ts = random_surfaces
    prior_j = lambda eta, rho: -2.0 * jnp.log1p(rho)   # noqa: E731
    prior_t = lambda eta, rho: -2.0 * torch.log1p(rho)  # noqa: E731
    thetas = np.array(POINTS_2D)
    lp_j = js.make_log_posterior(prior_j)
    want = jax.jit(jax.vmap(lp_j))(thetas)
    want_grads = jax.jit(jax.vmap(jax.grad(lp_j)))(thetas)
    lp = ts.make_log_posterior(prior_t)
    got = torch.func.vmap(lp)(torch.as_tensor(thetas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    grads = torch.func.vmap(torch.func.grad(lp))(torch.as_tensor(thetas))
    for g, w in zip(grads, want_grads):
        assert_grad_close(g.numpy(), w)

    lpu_j, u2t_j = js.make_bounded_log_posterior(log10_eta_bounds=(-2., 3.))
    lpu_t, u2t_t = ts.make_bounded_log_posterior(log10_eta_bounds=(-2., 3.))
    u = np.array([[-20.0, 20.0], [0.0, 0.0], [5.0, -5.0]])
    th = torch.func.vmap(u2t_t)(torch.as_tensor(u))
    np.testing.assert_allclose(
        th.numpy(), np.asarray(jax.jit(jax.vmap(u2t_j))(u)), rtol=1e-12)
    assert bool(torch.all((th[:, 0] >= -2.0) & (th[:, 0] <= 3.0)))
    assert bool(torch.all((th[:, 1] >= -1.5) & (th[:, 1] <= -0.5)))
    np.testing.assert_allclose(
        torch.func.vmap(lpu_t)(torch.as_tensor(u)).numpy(),
        np.asarray(jax.jit(jax.vmap(lpu_j))(u)), rtol=RTOL)



def test_surface_vmap_equals_pointwise(random_surfaces):
    """The (eta, rho) surface and its gradient under torch.func.vmap over
    a batch of points equal the pointwise ones: the values bit for bit,
    the gradients at rtol and atol 1e-14 (the samplers' chains see what a
    lone evaluation sees)."""
    _, ts = random_surfaces
    thetas = torch.as_tensor(POINTS_2D, dtype=F64)

    def f(t):
        return ts.profile_loglik(t[0], t[1])

    vals = torch.func.vmap(f)(thetas)
    grads = torch.func.vmap(torch.func.grad(f))(thetas)
    for t, v, g in zip(thetas, vals, grads):
        assert float(v) == float(f(t))
        np.testing.assert_allclose(g.numpy(), torch.func.grad(f)(t).numpy(),
                                   rtol=1e-14, atol=1e-14)

# -- KrylovPosteriorSurfaceRhoNu ----------------------------------------------

RHO_NU = dict(log10_rho_bounds=(-1.2, -0.6), nu_bounds=(1.0, 25.0),
              num_rho_nodes=3, num_nu_nodes=3, lanczos_steps=GRID_STEPS,
              num_probes=8)
POINTS_3D = [(0.5, -0.93, 3.0), (1.0, -1.1, 1.3), (1.5, -0.8, 20.0),
             (1.2, -0.77, 12.5)]


@pytest.fixture(scope="module")
def rho_nu_surfaces():
    """The 12 x 12 grid (n = 144), 3 x 3 nodes, k = 8, 8 probes."""
    return surfaces(tdata.generate_points(12, dimension=2), rho_nu=True,
                    **RHO_NU)


def test_rho_nu_surface_matches(rho_nu_surfaces):
    """lp, logdet and the gradient in all three coordinates, rtol 1e-8,
    at off-node points and at a node."""
    js, ts = rho_nu_surfaces
    np.testing.assert_array_equal(ts.log_nu_nodes, js.log_nu_nodes)
    check_points(js, ts, POINTS_3D + [(0.5, -0.9, 5.0)])


def test_rho_nu_vmap_and_targets(rho_nu_surfaces):
    """The surface and its gradient under torch.func.vmap over a batch of
    points equal the pointwise values; the bounded target's box holds the
    nu bounds, and its values match the reference's."""
    js, ts = rho_nu_surfaces
    thetas = torch.as_tensor(POINTS_3D, dtype=F64)

    def f(t):
        return ts.profile_loglik(t[0], t[1], t[2])

    vals = torch.func.vmap(f)(thetas)
    grads = torch.func.vmap(torch.func.grad(f))(thetas)
    for t, v, g in zip(thetas, vals, grads):
        assert float(v) == float(f(t))
        np.testing.assert_allclose(g.numpy(), torch.func.grad(f)(t).numpy(),
                                   rtol=1e-14, atol=1e-14)
    lpu_j, u2t_j = js.make_bounded_log_posterior(log10_eta_bounds=(-2., 3.))
    lpu_t, u2t_t = ts.make_bounded_log_posterior(log10_eta_bounds=(-2., 3.))
    u = np.array([[-20.0, 20.0, 0.0], [0.0, 0.0, 5.0], [5.0, -5.0, -30.0]])
    th = torch.func.vmap(u2t_t)(torch.as_tensor(u))
    assert bool(torch.all((th[:, 2] >= 1.0) & (th[:, 2] <= 25.0)))
    assert bool(torch.all((th[:, 1] >= -1.2) & (th[:, 1] <= -0.6)))
    np.testing.assert_allclose(
        th.numpy(), np.asarray(jax.jit(jax.vmap(u2t_j))(u)), rtol=1e-12)
    # the values inside the box (log10 eta >= 0.5: at its -2 edge the
    # two packages' small-eta quadratures part by 2.5e-7)
    u = np.array([[0.0, 0.0, 5.0], [1.0, -2.0, 0.0], [2.0, 1.0, -3.0]])
    np.testing.assert_allclose(
        torch.func.vmap(lpu_t)(torch.as_tensor(u)).numpy(),
        np.asarray(jax.jit(jax.vmap(lpu_j))(u)), rtol=RTOL)
    prior_t = lambda e, r, nu: -2.0 * torch.log1p(nu / 25.0)  # noqa: E731
    prior_j = lambda e, r, nu: -2.0 * jnp.log1p(nu / 25.0)    # noqa: E731
    np.testing.assert_allclose(
        torch.func.vmap(ts.make_log_posterior(prior_t))(thetas).numpy(),
        np.asarray(jax.jit(jax.vmap(js.make_log_posterior(prior_j)))(
            np.array(POINTS_3D))), rtol=RTOL)


def test_rho_nu_node_tables(monkeypatch):
    """The node tables' dtype rule: float32 nodes take the general-nu
    kernel's entry once per distinct nu (3 calls for 3 x 3 nodes, each
    over the stacked float32 tables of that nu's three rhos), float64
    nodes never; the float64-node surface of a float32 surface equals the
    all-float64 surface (rtol 1e-8) and the reference's node_dtype=float64
    option; the float32-node surface lies within 0.05 nats of it."""
    calls = []
    real = cuda_kernels.matern_general

    def spy(x, nu):
        calls.append((x.dtype, tuple(x.shape)))
        return real(x, nu)

    monkeypatch.setattr(cuda_kernels, "matern_general", spy)
    pts, z, X = problem(tdata.generate_points(12, dimension=2))
    probes, v_defl = jax_block(len(pts), 8, 3)
    kw = dict(RHO_NU, key=3, device="cpu", probes=probes, v_defl=v_defl)
    f32 = tkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, dtype=F64,
                                          node_dtype=F32, **kw)
    assert calls == [(F32, (3, 12, 12))] * 3
    calls.clear()
    f64 = tkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, dtype=F32,
                                          node_dtype=F64, **kw)
    assert calls == []
    full = tkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, dtype=F64, **kw)
    ref = jkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, node_dtype=jnp.float64,
                                          **{k: v for k, v in RHO_NU.items()},
                                          key=3)
    for th in POINTS_3D:
        a = float(f64.profile_loglik(*th))
        np.testing.assert_allclose(a, float(full.profile_loglik(*th)),
                                   rtol=RTOL)
        np.testing.assert_allclose(a, float(ref.profile_loglik(*th)),
                                   rtol=RTOL)
        assert abs(float(f32.profile_loglik(*th)) - a) < 0.05


def test_rho_nu_rejects_non_grid_points():
    rng = np.random.RandomState(0)
    pts = rng.rand(100, 2)
    with pytest.raises(ValueError, match="grid"):
        tkp.KrylovPosteriorSurfaceRhoNu(
            pts, rng.standard_normal(100), np.ones((100, 1)),
            num_rho_nodes=3, num_nu_nodes=3, lanczos_steps=8, num_probes=4,
            device="cpu", dtype=F64)


@pytest.mark.parametrize("nu", [0.5, 1.2])
def test_surface_node_chunks_agree(nu):
    """Nodes factorized two a chunk (``chunk_bytes`` at two nodes' basis,
    the general nu's slot scratch added) give the one-chunk surface:
    rtol 1e-10 (the same products, batched otherwise)."""
    pts, z, X = problem(np.random.RandomState(1).rand(90, 2))
    probes, v_defl = jax_block(90, 4, 0)
    kw = dict(nu=nu, log10_rho_bounds=(-1.2, -0.6), num_nodes=5,
              lanczos_steps=10, num_probes=4, device="cpu", dtype=F64,
              probes=probes, v_defl=v_defl, block_rows=32)
    per_node = 10 * 90 * (X.shape[1] + 2 + 4) * 8
    slots = 0 if nu == 0.5 else cuda_kernels.GENERAL_SLOT_BYTES
    one = tkp.KrylovPosteriorSurface(pts, z, X, **kw)
    two = tkp.KrylovPosteriorSurface(pts, z, X,
                                     chunk_bytes=2 * per_node + slots, **kw)
    for th in ((0.5, -0.8), (1.5, -1.0), (2.0, -0.65)):
        np.testing.assert_allclose(float(two.profile_loglik(*th)),
                                   float(one.profile_loglik(*th)),
                                   rtol=1e-10)
