"""The ported HMC sampler (models.hmc) and its chain state
(utils.checkpoint) vs the JAX reference, on the CPU in float64.

The step is a pure function of its draws, so the reference's own
``jax.random`` draws (rebuilt from its key the way ``_hmc_chunk`` splits
it) are fed to the port's step, and every carry entry is held to the
reference's ``_hmc_chunk`` over 30 steps across the warmup boundary at
rtol 1e-10; ``_leapfrog`` against the reference's at rtol 1e-12. Then the
port's own contracts, bit for bit: chunked and unchunked runs, resume from
a saved state, and the save / load round trip; the samplers end to end on
small problems (n <= 144, at most 4 chains, at most 20 steps).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import hmc as jhmc  # noqa: E402
from gppe_tpu.models import kernel_posterior as jkp  # noqa: E402
from gppe_tpu.utils import checkpoint as jckpt  # noqa: E402
from gppe_tpu_torch.models import hmc as thmc  # noqa: E402
from gppe_tpu_torch.models import kernel_posterior as tkp  # noqa: E402
from gppe_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F64 = torch.float64
CPU = torch.device("cpu")

COV = np.array([[1.0, 0.6], [0.6, 2.0]])
PREC = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def gauss_j(x):
    d = x - MEAN
    return -0.5 * d @ (PREC @ d)


_PREC_T = torch.as_tensor(PREC)
_MEAN_T = torch.as_tensor(MEAN)


def gauss_t(x):
    d = x - _MEAN_T
    return -0.5 * d @ (_PREC_T @ d)


def flat_j(x):
    return 0.0 * jnp.sum(x)


def flat_t(x):
    return 0.0 * torch.sum(x)


def grid_problem(side):
    pts = tdata.generate_points(side, dimension=2)
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2))


@pytest.fixture(scope="module")
def bounded_targets():
    """The bounded (eta, rho) kernel posterior of an 8 x 8 grid in both
    packages."""
    pts, z, X = grid_problem(8)
    bounds = ((-3.0, 4.0), (-2.0, 0.0))
    lp_j, _ = jkp.make_bounded_log_posterior(pts, z, X, log10_bounds=bounds)
    lp_t, _ = tkp.make_bounded_log_posterior(pts, z, X, log10_bounds=bounds,
                                             device="cpu")
    return lp_j, lp_t


def gv(f):
    return torch.func.grad_and_value(f)


def test_leapfrog_matches_reference(bounded_targets):
    """One chain's trajectory (end point and momentum) against the
    reference's _leapfrog at rtol 1e-12, on a correlated Gaussian and on
    the bounded kernel posterior; the value returned is the target's at the
    end point; a batch of chains equals its chains one by one."""
    lp_j, lp_t = bounded_targets
    rng = np.random.RandomState(0)
    for f_j, f_t, th0 in ((gauss_j, gauss_t, np.array([0.3, -1.0])),
                          (lp_j, lp_t, np.array([0.2, -0.4]))):
        mo0 = rng.standard_normal(2)
        im = np.array([0.7, 1.3])
        want = jhmc._leapfrog(jax.grad(f_j), jnp.asarray(th0),
                              jnp.asarray(mo0), 0.05, jnp.asarray(im), 7)
        th, mo, val = thmc._leapfrog(gv(f_t), torch.as_tensor(th0),
                                     torch.as_tensor(mo0), 0.05,
                                     torch.as_tensor(im), 7)
        np.testing.assert_allclose(th.numpy(), np.asarray(want[0]),
                                   rtol=1e-12)
        np.testing.assert_allclose(mo.numpy(), np.asarray(want[1]),
                                   rtol=1e-12)
        assert float(val) == float(f_t(th))
    ths = torch.as_tensor(rng.standard_normal((3, 2)))
    mos = torch.as_tensor(rng.standard_normal((3, 2)))
    eps = torch.tensor([0.05, 0.1, 0.02], dtype=F64)
    batch = thmc._leapfrog(torch.func.vmap(gv(gauss_t)), ths, mos,
                           eps[:, None], torch.ones(3, 2, dtype=F64), 5)
    for c in range(3):
        one = thmc._leapfrog(gv(gauss_t), ths[c], mos[c], eps[c],
                             torch.ones(2, dtype=F64), 5)
        for b, o in zip(batch, one):
            np.testing.assert_allclose(b[c].numpy(), o.numpy(), rtol=1e-14)


def reference_draws(key, steps, chains, dim):
    """The reference's draws of ``steps`` steps, split from ``key`` as
    its ``_hmc_chunk`` step splits it."""
    out = []
    for _ in range(steps):
        key, k_mo, k_u = jax.random.split(key, 3)
        out.append((torch.as_tensor(np.asarray(jax.random.normal(
                        k_mo, (chains, dim), jnp.float64))),
                    torch.as_tensor(np.asarray(jax.random.uniform(
                        k_u, (chains,), jnp.float64)))))
    return out


CARRY = ("theta", "lp", "log_eps", "log_eps_bar", "h_bar", "w_mean", "w_m2",
         "inv_mass", "n_accept")


def run_both(f_j, f_t, init, steps=30, num_warmup=20, num_leapfrog=6,
             step_size=0.1, each_step=None):
    """The reference's _hmc_chunk over ``steps`` global steps and the
    port's _hmc_step fed the same draws; both final carries. With
    ``each_step(jc, tc)``, the port also takes each step from the
    reference's carry of the step before, and both carries go to
    ``each_step`` after every step."""
    key = jax.random.PRNGKey(11)
    jc = jhmc._hmc_carry0(f_j, jnp.asarray(init), key, step_size, None)
    gvb = thmc._batched(f_t, "rev", F64)
    tc = thmc._hmc_carry0(gvb, torch.as_tensor(init), step_size, None)
    kw = dict(num_warmup=num_warmup, num_leapfrog=num_leapfrog,
              target_accept=0.8)
    draws = reference_draws(key, steps, *init.shape)
    jc0 = jc
    for it, (normals, uniforms) in enumerate(draws):
        if each_step is not None:
            from_ref = {k: torch.as_tensor(np.array(v)) for k, v in
                        jc.items() if k != "key"}
            from_ref["step_size"] = torch.exp(from_ref["log_eps"])
            jc = jhmc._hmc_chunk(f_j, jc, it, 1, num_warmup, num_leapfrog,
                                 0.8, "rev")[0]
            each_step(jc, thmc._hmc_step(gvb, from_ref, it, normals,
                                         uniforms, **kw))
        tc = thmc._hmc_step(gvb, tc, it, normals, uniforms, **kw)
    if each_step is None:
        jc = jhmc._hmc_chunk(f_j, jc0, 0, steps, num_warmup, num_leapfrog,
                             0.8, "rev")[0]
    return jc, tc


def assert_carry_close(jc, tc, rtol):
    for k in CARRY:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=rtol, atol=1e-300, err_msg=k)


def test_step_matches_reference_carry():
    """30 steps across the warmup boundary (num_warmup = 20: dual
    averaging, the Welford window from step 10, the mass switch at step
    19, the frozen step size after) on the correlated Gaussian, fed the
    reference's draws: at each step, from the reference's carry of the step
    before, every carry entry equals the reference's _hmc_chunk step at
    rtol 1e-10. Run free over the 30 steps, the two stay within 1e-7: dual
    averaging feeds each step's acceptance back into the next step size
    (log eps moves by sqrt(t) / 0.05 times h_bar), so the packages'
    last-bit differences in exp and in the target grow about twofold a
    step (measured: 2e-15 after the first step, 3e-8 in theta at step 21,
    8e-10 at step 30)."""
    init = np.random.RandomState(1).standard_normal((4, 2)) * 0.5
    jc, tc = run_both(gauss_j, gauss_t, init, each_step=lambda j, t:
                      assert_carry_close(j, t, 1e-10))
    assert_carry_close(jc, tc, 1e-7)
    assert float(tc["n_accept"].sum()) > 0
    assert not np.allclose(tc["inv_mass"].numpy(), 1.0)


def test_step_matches_reference_carry_kernel_posterior(bounded_targets):
    """The same 30 steps on the bounded kernel posterior of an 8 x 8 grid,
    each from the reference's carry of the step before: every entry at
    rtol 1e-7. The first step to part beyond 1e-10 is step 1: at the
    reference's carry there the packages' gradients differ by up to
    1.6e-11 of the largest component, not a last bit; each lies within
    1.1e-11 of the exact gradient, the two mostly on opposite sides
    (test_gradient_gap_is_rounding_of_both), so the gap is float64
    rounding of both Cholesky pipelines. Dual averaging takes the step
    size to 1.43 there, six leapfrog steps at that size magnify the gap to
    6e-10 in the end point (and its acceptance), and the update of log eps
    multiplies that by sqrt(t) / 0.05 (measured: 1.1e-8 in log eps at step
    1, under 1e-10 elsewhere but step 2's 7e-9); run free, an acceptance
    flips within 30 steps, so only the step is compared."""
    f_j, f_t = bounded_targets
    init = np.random.RandomState(1).standard_normal((4, 2)) * 0.5
    run_both(f_j, f_t, init, each_step=lambda j, t:
             assert_carry_close(j, t, 1e-7))


def _exact_bounded_posterior(pts, z, X, bounds, digits=40):
    """The bounded (eta, rho) posterior at nu = 1/2 in mpmath at ``digits``
    digits: a function of u (two mpf) as make_bounded_log_posterior
    defines it, for the exact gradient by central differences."""
    mp = pytest.importorskip("mpmath")
    n, m = X.shape
    with mp.workdps(digits):
        P = [[mp.mpf(float(v)) for v in p] for p in pts]
        D = [[mp.sqrt(sum((P[i][k] - P[j][k]) ** 2 for k in range(2)))
              for j in range(n)] for i in range(n)]
    zs = [mp.mpf(float(v)) for v in z]
    Xs = [[mp.mpf(float(v)) for v in row] for row in X]
    margin = mp.mpf(1e-6)

    def solve(L, b):                     # L L^T x = b, L an mpmath matrix
        k = L.rows
        y = [None] * k
        for i in range(k):
            y[i] = (b[i] - sum(L[i, j] * y[j] for j in range(i))) / L[i, i]
        x = [None] * k
        for i in reversed(range(k)):
            x[i] = (y[i] - sum(L[j, i] * x[j] for j in range(i + 1, k))
                    ) / L[i, i]
        return x

    def f(u):
        th, log_jac = [], 0
        for k, (lo, hi) in enumerate(bounds):
            sg = 1 / (1 + mp.exp(-u[k]))
            th.append(lo + (hi - lo) * (margin + (1 - 2 * margin) * sg))
            log_jac += (mp.log(hi - lo) + mp.log(1 - 2 * margin)
                        + mp.log(sg) + mp.log(1 - sg))
        eta, rho = mp.power(10, th[0]), mp.power(10, th[1])
        L = mp.cholesky(mp.matrix([[mp.exp(-D[i][j] / rho)
                                    + (eta if i == j else 0)
                                    for j in range(n)] for i in range(n)]))
        w = solve(L, zs)
        Y = [solve(L, [Xs[i][c] for i in range(n)]) for c in range(m)]
        LB = mp.cholesky(mp.matrix([[sum(Xs[i][a] * Y[b][i]
                                         for i in range(n))
                                     for b in range(m)] for a in range(m)]))
        Xw = [sum(Xs[i][a] * w[i] for i in range(n)) for a in range(m)]
        c = solve(LB, Xw)
        zMz = (sum(zs[i] * w[i] for i in range(n))
               - sum(Xw[a] * c[a] for a in range(m)))
        logdet = 2 * sum(mp.log(L[i, i]) for i in range(n))
        logdet_B = 2 * sum(mp.log(LB[i, i]) for i in range(m))
        return (-mp.mpf(n - m) / 2 * mp.log(zMz / (n - m)) - logdet / 2
                - logdet_B / 2 - mp.mpf(n - m) / 2 + log_jac)

    def grad(u):
        out = []
        with mp.workdps(digits):
            h = mp.mpf("1e-15")
            for k in range(2):
                up = [mp.mpf(float(v)) for v in u]
                dn = list(up)
                up[k] += h
                dn[k] -= h
                out.append(float((f(up) - f(dn)) / (2 * h)))
        return np.array(out)
    return grad


def test_gradient_gap_is_rounding_of_both(bounded_targets):
    """At the reference's carry of step 1 (the kernel-posterior parity
    test's first step to part beyond 1e-10), each package's gradient of the
    bounded posterior against the exact one (mpmath at 40 digits, central
    differences at h = 1e-15): the port's error, relative to the largest
    component, at most twice the reference's largest plus 1e-12, and both
    under 5e-11 (measured: port 8.4e-12, reference 1.06e-11, the two
    1.6e-11 apart on chain 2)."""
    f_j, f_t = bounded_targets
    init = np.random.RandomState(1).standard_normal((4, 2)) * 0.5
    key = jax.random.PRNGKey(11)
    jc = jhmc._hmc_carry0(f_j, jnp.asarray(init), key, 0.1, None)
    jc = jhmc._hmc_chunk(f_j, jc, 0, 1, 20, 6, 0.8, "rev")[0]
    ths = np.array(jc["theta"])
    got = torch.func.vmap(torch.func.grad(f_t))(torch.as_tensor(ths)).numpy()
    ref = np.asarray(jax.vmap(jax.grad(f_j))(jnp.asarray(ths)))
    exact_grad = _exact_bounded_posterior(*grid_problem(8),
                                          ((-3.0, 4.0), (-2.0, 0.0)))
    err_port, err_ref = [], []
    for c in range(ths.shape[0]):
        exact = exact_grad(ths[c])
        scale = np.abs(exact).max()
        err_port.append(np.abs(got[c] - exact).max() / scale)
        err_ref.append(np.abs(ref[c] - exact).max() / scale)
    assert max(err_ref) < 5e-11 and max(err_port) < 5e-11
    assert max(err_port) <= 2.0 * max(err_ref) + 1e-12


def test_dual_averaging_bit_for_bit():
    """On a flat target every proposal is accepted with probability 1
    exactly in both packages, so the dual-averaging arithmetic alone
    drives h_bar, log_eps and log_eps_bar: the port's equal the reference's
    bit for bit over 30 steps at t = it + 1 (mu = log(10 * 0.1) = 0)."""
    init = np.random.RandomState(2).standard_normal((3, 2))
    jc, tc = run_both(flat_j, flat_t, init)
    for k in ("h_bar", "log_eps", "log_eps_bar"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                      err_msg=k)


def standard_normal(x):
    return -0.5 * torch.sum(x * x)


def test_standard_normal_moments():
    """The port's own generator: a 3-D standard normal at 32 chains, 200
    warmup and 500 samples, 10 leapfrog steps: means within 0.1 of 0,
    variances within 0.15 of 1, split R-hat under 1.05, finite log probs
    of the right shape."""
    res = thmc.hmc_sample(standard_normal, torch.zeros((32, 3), dtype=F64),
                          0, num_samples=500, num_warmup=200,
                          num_leapfrog=10)
    flat = res.samples.reshape(-1, 3).numpy()
    assert res.samples.shape == (500, 32, 3)
    assert res.log_probs.shape == (500, 32)
    assert bool(torch.isfinite(res.log_probs).all())
    assert float(res.accept_rate.min()) > 0.5
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(flat.var(0), 1.0, atol=0.15)
    from gppe_tpu_torch.models import diagnostics
    assert np.all(diagnostics.split_rhat(res.samples) < 1.05)


def test_chunked_equals_unchunked_and_resume():
    """chunk_steps never changes the bits; resume_hmc from state() for 10
    steps equals 10 more steps of the unbroken run, bit for bit, also
    through save_hmc_state / load_hmc_state."""
    init = torch.zeros((3, 2), dtype=F64)
    kw = dict(num_warmup=20, num_leapfrog=5)
    whole = thmc.hmc_sample(gauss_t, init, 5, num_samples=40, **kw)
    for chunk in (1, 7, 20, 100):
        part = thmc.hmc_sample(gauss_t, init, 5, num_samples=40,
                               chunk_steps=chunk, **kw)
        assert torch.equal(part.samples, whole.samples)
        assert torch.equal(part.log_probs, whole.log_probs)
        assert part.final_generator_state == whole.final_generator_state
    first = thmc.hmc_sample(gauss_t, init, 5, num_samples=30, **kw)
    more = thmc.resume_hmc(gauss_t, first.state(), 10, num_leapfrog=5)
    assert torch.equal(more.samples, whole.samples[30:])
    assert torch.equal(more.log_probs, whole.log_probs[30:])
    assert torch.equal(more.step_size, whole.step_size)
    assert more.final_generator_state == whole.final_generator_state


def test_save_load_round_trip(tmp_path):
    """save_hmc_state writes numpy arrays and the generator's bytes, and
    the loaded state resumes the same bits as the live one."""
    init = torch.zeros((2, 2), dtype=F64)
    res = thmc.hmc_sample(gauss_t, init, 3, num_samples=8, num_warmup=6,
                          num_leapfrog=4)
    path = str(tmp_path / "state.pickle")
    tckpt.save_hmc_state(res, path)
    state = tckpt.load_hmc_state(path)
    assert set(state) == {"theta", "generator_state", "step_size",
                          "inv_mass", "accept_rate"}
    assert isinstance(state["generator_state"], bytes)
    assert all(isinstance(state[k], np.ndarray)
               for k in ("theta", "step_size", "inv_mass", "accept_rate"))
    a = thmc.resume_hmc(gauss_t, res.state(), 6, num_leapfrog=4)
    b = thmc.resume_hmc(gauss_t, state, 6, num_leapfrog=4, device="cpu")
    assert torch.equal(a.samples, b.samples)


def test_reference_state_loads(tmp_path):
    """A state saved by the reference's save_hmc_state loads with theta,
    step size and inverse mass exactly, its key as the seed
    word0 * 2^32 + word1, and resumes on the port's generator."""
    res = jhmc.hmc_sample(gauss_j, jnp.zeros((3, 2)), jax.random.PRNGKey(4),
                          num_samples=6, num_warmup=10, num_leapfrog=4)
    path = str(tmp_path / "reference_state.pickle")
    jckpt.save_hmc_state(res, path)
    state = tckpt.load_hmc_state(path)
    for k in ("theta", "step_size", "inv_mass"):
        np.testing.assert_array_equal(state[k], np.asarray(res.state()[k]))
    words = np.asarray(res.final_key).astype(np.uint64)
    assert state["seed"] == int(words[0]) * 2 ** 32 + int(words[1])
    assert "key" not in state
    more = thmc.resume_hmc(gauss_t, state, 5, num_leapfrog=4, device="cpu")
    np.testing.assert_array_equal(more.step_size.numpy(),
                                  np.asarray(res.step_size))
    np.testing.assert_array_equal(more.inv_mass.numpy(),
                                  np.asarray(res.inv_mass))
    again = thmc.resume_hmc(gauss_t, state, 5, num_leapfrog=4, device="cpu")
    assert torch.equal(more.samples, again.samples)


def test_mesh_refused():
    """mesh= takes a parallel.mesh.Mesh, and refuses a chain count that its
    probe extent does not divide, before anything is built (a mesh of
    three probe ranks, made without a process group: the refusal comes
    before any communication)."""
    from gppe_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh((3, 1), rank=0, groups={}, device="cpu", backend="gloo")
    pts, z, X = grid_problem(4)
    for fn in (thmc.sample_posterior, thmc.sample_posterior_nu,
               thmc.sample_posterior_large,
               thmc.sample_posterior_rho_nu_large):
        with pytest.raises(ValueError, match="takes a gppe_tpu_torch"):
            fn(pts, z, X, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="8 chains do not divide over "
                           "the mesh's probe extent 3"):
            fn(pts, z, X, num_chains=8, mesh=mesh, device="cpu")


def test_generator_device_checked():
    with pytest.raises(ValueError, match="lives on"):
        thmc._generator(torch.Generator(), torch.device("cuda"))
    with pytest.raises(ValueError, match="grad_mode"):
        thmc._batched(gauss_t, "central", F64)


def in_box(samples, lo, hi):
    s = samples.numpy()
    return bool(np.isfinite(s).all() and np.all(s > np.asarray(lo))
                and np.all(s < np.asarray(hi)))


def test_sample_posterior_dense():
    """The dense (eta, rho) sampler, bounded and unbounded, and its resume
    branch: finite samples inside the box; the unbounded one with a
    uniform prior stays inside its support."""
    pts, z, X = grid_problem(8)
    box = ((-3.0, 4.0), (-2.0, 0.0))
    res = thmc.sample_posterior(pts, z, X, num_chains=4, num_samples=10,
                                num_warmup=10, num_leapfrog=4,
                                support_log10=box, device="cpu")
    assert res.samples.shape == (10, 4, 2)
    assert in_box(res.samples, [b[0] for b in box], [b[1] for b in box])
    more = thmc.sample_posterior(pts, z, X, num_samples=4, num_leapfrog=4,
                                 support_log10=box, resume_state=res.state(),
                                 device="cpu")
    assert in_box(more.samples, [b[0] for b in box], [b[1] for b in box])

    from gppe_tpu_torch.models import priors

    def prior(eta, rho):
        return (priors.uniform_log_prior(eta, (1e-3, 1e4))
                + priors.uniform_log_prior(rho, (0.01, 1.0)))
    res = thmc.sample_posterior(pts, z, X, num_chains=3, num_samples=5,
                                num_warmup=5, num_leapfrog=3,
                                log_prior=prior, device="cpu")
    assert in_box(res.samples, [-3.0, -2.0], [4.0, 0.0])


def test_sample_posterior_nu():
    """The (eta, rho, nu) sampler in forward mode through the fixed-trip
    Bessel K_nu: samples finite, inside the box."""
    pts, z, X = grid_problem(6)
    res = thmc.sample_posterior_nu(pts, z, X, num_chains=2, num_samples=2,
                                   num_warmup=2, num_leapfrog=2,
                                   device="cpu")
    assert res.samples.shape == (2, 2, 3)
    assert in_box(res.samples, [-3.0, -2.0, 1.0], [4.0, 0.0, 25.0])


def test_sample_profile_posterior_rho_nu():
    """The eta-profiled (rho, nu) sampler: finite, inside the box."""
    pts, z, X = grid_problem(6)
    res = thmc.sample_profile_posterior_rho_nu(
        pts, z, X, num_chains=2, num_samples=2, num_warmup=2,
        num_leapfrog=2, eta_grid=7, golden_iters=4, device="cpu")
    assert res.samples.shape == (2, 2, 2)
    assert in_box(res.samples, [-1.3, 1.0], [-0.3, 25.0])


SURFACE_KW = dict(dtype=F64, num_probes=8)


def test_sample_posterior_large_resume():
    """sample_posterior_large on a float64 KrylovPosteriorSurface (120
    random points, 4 nodes, k = 12): in the box; 14 steps and a resume of
    6 equal 20 unbroken, bit for bit."""
    pts = np.random.RandomState(0).rand(120, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    kw = dict(num_chains=4, num_warmup=10, num_leapfrog=6, device="cpu")
    whole, surface = thmc.sample_posterior_large(
        pts, z, X, num_samples=10, surface_kwargs=dict(
            num_nodes=4, lanczos_steps=12, **SURFACE_KW), **kw)
    assert in_box(whole.samples, [-3.0, -1.5], [3.0, -0.5])
    first, _ = thmc.sample_posterior_large(pts, z, X, num_samples=4,
                                           surface=surface, **kw)
    more, _ = thmc.sample_posterior_large(pts, z, X, num_samples=6,
                                          surface=surface,
                                          resume_state=first.state(), **kw)
    assert torch.equal(more.samples, whole.samples[4:])


def test_sample_posterior_rho_nu_large():
    """sample_posterior_rho_nu_large on the (rho, nu) surface of a 12 x 12
    grid (3 x 3 nodes, k = 8) with the reference's priors: finite, inside
    the box; a resume continues inside it."""
    pts, z, X = grid_problem(12)
    res, surface = thmc.sample_posterior_rho_nu_large(
        pts, z, X, num_chains=4, num_samples=10, num_warmup=10,
        num_leapfrog=5, log10_rho_bounds=(-1.2, -0.6),
        surface_kwargs=dict(num_rho_nodes=3, num_nu_nodes=3,
                            lanczos_steps=8, **SURFACE_KW), device="cpu")
    lo, hi = [0.5, -1.2, 1.0], [4.0, -0.6, 25.0]
    assert res.samples.shape == (10, 4, 3)
    assert in_box(res.samples, lo, hi)
    more, _ = thmc.sample_posterior_rho_nu_large(
        pts, z, X, num_samples=3, num_leapfrog=5, surface=surface,
        resume_state=res.state())
    assert in_box(more.samples, lo, hi)
    assert math.isfinite(float(more.accept_rate.mean()))
