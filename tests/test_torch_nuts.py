"""The ported NUTS sampler (models.nuts) vs the JAX reference, on the CPU
in float64.

The transition is a pure function of one block of draws a step, and the
reference's ``jax.random`` draws have a fixed layout by position: each step
splits a key per chain, each chain's transition splits off the momentum
key, and each doubling d a (direction, accept) pair and then 2^d leaf keys,
one after another. The tests rebuild that block from the reference's key
and feed it to the port, which must then reproduce the reference's
``nuts_sample``: on a correlated Gaussian at rtol 1e-10 across the warmup
boundary, on the bounded kernel posterior at rtol 1e-7, with equal tree
depths. Then the port's own contracts, bit for bit: chains independent of
each other, fully masked leaves that change nothing, resume from a saved
state and the save / load round trip; its moments; the samplers end to end
on small problems (n <= 144, at most 20 steps). The reference is compiled
twice in the file (``nuts_sample`` on each of the two targets).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import kernel_posterior as jkp  # noqa: E402
from gppe_tpu.models import nuts as jnuts  # noqa: E402
from gppe_tpu.utils import checkpoint as jckpt  # noqa: E402
from gppe_tpu_torch.models import diagnostics, hmc as thmc  # noqa: E402
from gppe_tpu_torch.models import kernel_posterior as tkp  # noqa: E402
from gppe_tpu_torch.models import nuts as tnuts  # noqa: E402
from gppe_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F64 = torch.float64

COV = np.array([[1.0, 0.6], [0.6, 2.0]])
PREC = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def gauss_j(x):
    d = x - MEAN
    return -0.5 * d @ (PREC @ d)


def gauss_t(x):
    """The correlated Gaussian, elementwise (no product whose rounding
    could depend on the batch): a chain's value and gradient are the same
    bits alone and in a batch."""
    d0, d1 = x[0] - MEAN[0], x[1] - MEAN[1]
    return -0.5 * (PREC[0, 0] * d0 * d0 + 2.0 * PREC[0, 1] * d0 * d1
                   + PREC[1, 1] * d1 * d1)


def grid_problem(side):
    pts = tdata.generate_points(side, dimension=2)
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2))


def reference_draws(key, steps, chains, dim, max_depth):
    """The reference's draws of ``steps`` steps as the port's blocks
    (normals, direction uniforms, accept uniforms, leaf uniforms), split
    from ``key`` as nuts_sample's step and _nuts_transition split it. The
    direction is the reference's bernoulli(k_dir), u < 1/2 of the same
    uniform, which the test checks."""
    out = []
    for _ in range(steps):
        key, k_tr = jax.random.split(key)
        normals = np.zeros((chains, dim))
        u_dir = np.zeros((chains, max_depth))
        u_acc = np.zeros((chains, max_depth))
        u_leaf = np.zeros((chains, 2 ** max_depth - 1))
        for c, kc in enumerate(jax.random.split(k_tr, chains)):
            kc, k_mo = jax.random.split(kc)
            normals[c] = jax.random.normal(k_mo, (dim,), jnp.float64)
            for d in range(max_depth):
                kc, k_dir, k_acc = jax.random.split(kc, 3)
                u_dir[c, d] = jax.random.uniform(k_dir, (), jnp.float64)
                assert bool(jax.random.bernoulli(k_dir)) == (u_dir[c, d]
                                                             < 0.5)
                u_acc[c, d] = jax.random.uniform(k_acc, (), jnp.float64)
                for i in range(2 ** d):
                    kc, k_u = jax.random.split(kc)
                    u_leaf[c, 2 ** d - 1 + i] = jax.random.uniform(
                        k_u, (), jnp.float64)
        out.append(tuple(torch.as_tensor(a)
                         for a in (normals, u_dir, u_acc, u_leaf)))
    return out


def run_on_draws(f_t, init, draws, num_warmup, num_samples, max_depth,
                 early_exit=True):
    gv = thmc._batched(f_t, "rev", F64)
    carry = tnuts._nuts_carry0(gv, torch.as_tensor(init), 0.1, None)
    return tnuts._sample_loop(gv, carry, num_warmup, num_samples, max_depth,
                              0.8, lambda it: draws[it], early_exit)


GAUSS_RUN = dict(num_warmup=20, num_samples=10, max_depth=5)
KEY = 11


@pytest.fixture(scope="module")
def gaussian_pair():
    """The reference's nuts_sample on the Gaussian (3 chains, 20 + 10
    steps, max_depth 5) and the port fed its draws."""
    init = np.random.RandomState(1).standard_normal((3, 2)) * 0.5
    key = jax.random.PRNGKey(KEY)
    ref = jnuts.nuts_sample(gauss_j, jnp.asarray(init), key, **GAUSS_RUN)
    draws = reference_draws(key, 30, 3, 2, GAUSS_RUN["max_depth"])
    got = run_on_draws(gauss_t, init, draws, **GAUSS_RUN)
    return ref, got, init, draws


def test_bit_helpers_match_reference():
    """_popcount and _trailing_ones (Python ints) against the reference's
    while_loop versions on 0..255, exactly."""
    ns = jnp.arange(256, dtype=jnp.int32)
    pop = np.asarray(jax.jit(jax.vmap(jnuts._popcount))(ns))
    trail = np.asarray(jax.jit(jax.vmap(jnuts._trailing_ones))(ns))
    assert [tnuts._popcount(n) for n in range(256)] == pop.tolist()
    assert [tnuts._trailing_ones(n) for n in range(256)] == trail.tolist()


def test_is_turning_matches_reference():
    """The batched U-turn criterion against the reference's _is_turning on
    2000 random cases in 2 and 3 dimensions: the same decisions, and its
    two inner products against the reference's jnp.dot of the same terms
    at rtol 1e-14."""
    rng = np.random.RandomState(3)
    for dim in (2, 3):
        rl, rr, rs = (rng.standard_normal((1000, dim)) for _ in range(3))
        im = rng.uniform(0.1, 3.0, (1000, dim))
        want = np.asarray(jax.vmap(jnuts._is_turning)(
            *(jnp.asarray(a) for a in (rl, rr, rs, im))))
        args = [torch.as_tensor(a) for a in (rl, rr, rs, im)]
        assert np.array_equal(tnuts._is_turning(*args).numpy(), want)
        assert 0 < want.sum() < 1000
        rho = rs - 0.5 * (rl + rr)
        for got, r in zip(tnuts._turn_dots(*args), (rl, rr)):
            ref = np.asarray(jax.vmap(jnp.dot)(jnp.asarray(im * r),
                                               jnp.asarray(rho)))
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14)


def assert_result_close(got, ref, rtol):
    for k in ("samples", "log_probs", "step_size", "inv_mass",
              "accept_rate"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=rtol,
                                   atol=1e-300, err_msg=k)
    # depths and divergences are counts: equal (the reference divides
    # its sum of depths by the sample count in its own rounding)
    S = got.samples.shape[0]
    np.testing.assert_array_equal(
        np.round(got.mean_tree_depth.numpy() * S),
        np.round(np.asarray(ref.mean_tree_depth) * S))
    np.testing.assert_array_equal(got.divergences.numpy(),
                                  np.asarray(ref.divergences))


def test_step_parity_gaussian(gaussian_pair):
    """gppe_tpu.models.nuts.nuts_sample on the correlated Gaussian, 3
    chains, 20 warmup steps (dual averaging, the Welford window from step
    10, the mass switch at step 19) and 10 samples at max_depth 5, against
    the port fed the same draws: samples, log probs, step size, inverse
    mass and accept rate at rtol 1e-10 (measured: 2.3e-12 at most), tree
    depths and divergences equal. The trees reach depth 5 (31 leaves)."""
    ref, got, _, _ = gaussian_pair
    assert_result_close(got, ref, 1e-10)
    assert max(got.leaves_per_step) == 31
    assert not np.allclose(got.inv_mass.numpy(), 1.0)


def test_step_parity_kernel_posterior():
    """The same on the reference's make_bounded_log_posterior of a 6 x 6
    grid (n = 36, nu = 1/2), 4 warmup steps and 4 samples at max_depth 4:
    rtol 1e-7, tree depths equal. The packages' gradients of this target
    differ by ~1e-11 (float64 rounding of both Cholesky pipelines,
    test_torch_hmc.py), which dual averaging magnifies."""
    pts, z, X = grid_problem(6)
    bounds = ((-3.0, 4.0), (-2.0, 0.0))
    lp_j, _ = jkp.make_bounded_log_posterior(pts, z, X, log10_bounds=bounds)
    lp_t, _ = tkp.make_bounded_log_posterior(pts, z, X, log10_bounds=bounds,
                                             device="cpu")
    init = np.random.RandomState(1).standard_normal((3, 2)) * 0.5
    key = jax.random.PRNGKey(KEY)
    run = dict(num_warmup=4, num_samples=4, max_depth=4)
    ref = jnuts.nuts_sample(lp_j, jnp.asarray(init), key, **run)
    got = run_on_draws(lp_t, init, reference_draws(key, 8, 3, 2, 4), **run)
    assert_result_close(got, ref, 1e-7)
    assert max(got.leaves_per_step) == 15


def test_chains_independent_and_masked_leaves_inert(gaussian_pair):
    """3 chains together equal each chain alone on its own rows of the
    draws, bit for bit (a chain that stops early in the batch changes no
    other); and a run with no host read, every leaf of every doubling up to
    max_depth run with the stopped chains masked, equals the run that
    skips them, bit for bit; the skipping run takes half the gradients
    or fewer (measured: 414 against 930)."""
    _, got, init, draws = gaussian_pair
    for c in range(3):
        mine = [tuple(a[c:c + 1] for a in block) for block in draws]
        alone = run_on_draws(gauss_t, init[c:c + 1], mine, **GAUSS_RUN)
        assert torch.equal(alone.samples[:, 0], got.samples[:, c])
        assert torch.equal(alone.log_probs[:, 0], got.log_probs[:, c])
        assert torch.equal(alone.step_size[0], got.step_size[c])
        assert sum(alone.leaves_per_step) <= sum(got.leaves_per_step)
    full = run_on_draws(gauss_t, init, draws, early_exit=False, **GAUSS_RUN)
    for k in ("samples", "log_probs", "step_size", "inv_mass",
              "accept_rate", "mean_tree_depth", "divergences"):
        assert torch.equal(getattr(full, k), getattr(got, k)), k
    assert set(full.leaves_per_step) == {31}
    assert set(full.host_reads_per_step) == {0}
    assert 2 * sum(got.leaves_per_step) <= sum(full.leaves_per_step)
    # at most one host read a leaf and one a doubling
    assert all(r <= n + GAUSS_RUN["max_depth"] for r, n in zip(
        got.host_reads_per_step, got.leaves_per_step))


def test_gaussian_moments():
    """The port's own generator (the reference's test_nuts_gaussian_moments
    at fewer steps): a correlated 2-D Gaussian at 16 chains, 300 warmup
    and 300 samples, max_depth 8: no divergence, accept above 0.4, mean
    depth at least 1, means within 0.1 and the covariance within 0.3,
    split R-hat under 1.05."""
    cov = np.array([[2.0, 1.2], [1.2, 1.5]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    mean = torch.tensor([0.5, -1.0], dtype=F64)

    def log_prob(x):
        d = x - mean
        return -0.5 * d @ (prec @ d)

    res = tnuts.nuts_sample(log_prob, torch.zeros((16, 2), dtype=F64), 3,
                            num_samples=300, num_warmup=300, max_depth=8)
    flat = res.samples.reshape(-1, 2).numpy()
    assert res.samples.shape == (300, 16, 2)
    assert float(res.divergences.sum()) == 0.0
    assert float(res.accept_rate.min()) > 0.4
    assert float(res.mean_tree_depth.mean()) >= 1.0
    np.testing.assert_allclose(flat.mean(0), mean.numpy(), atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.3)
    assert np.all(diagnostics.split_rhat(res.samples) < 1.05)


def test_nuts_matches_hmc_on_gp_posterior():
    """The reference's test_nuts_matches_hmc_on_gp_posterior with fewer
    steps and points: the port's NUTS and HMC posterior means over (log10
    eta, log10 rho) of a 6 x 6 grid (noise 0.3, degree-1 basis, uniform
    priors), 4 chains, 40 warmup and 40 samples (NUTS at max_depth 5,
    HMC at 10 leapfrog steps), within the reference's atol 0.5 (measured:
    0.17 apart at most); the divergences (hard prior boundaries) under 90%
    of the transitions."""
    from gppe_tpu_torch.models import priors
    pts = tdata.generate_points(6, dimension=2)
    z = tdata.generate_data(pts, 0.3)
    X = tdata.generate_basis_functions(pts, 1)

    def log_prior(eta, rho):
        return (priors.uniform_log_prior(eta, (1e-2, 1e3))
                + priors.uniform_log_prior(rho, (0.03, 0.45)))

    kw = dict(nu=0.5, num_chains=4, num_samples=40, num_warmup=40, key=2,
              log_prior=log_prior, device="cpu")
    res_h = thmc.sample_posterior(pts, z, X, num_leapfrog=10, **kw)
    res_n = tnuts.sample_posterior(pts, z, X, max_depth=5, **kw)
    mean_h = res_h.samples.reshape(-1, 2).mean(0).numpy()
    mean_n = res_n.samples.reshape(-1, 2).mean(0).numpy()
    np.testing.assert_allclose(mean_n, mean_h, atol=0.5)
    assert float(res_n.divergences.sum()) < 0.9 * 4 * 40


def test_resume_bit_for_bit():
    """resume_nuts from state() for 10 steps equals 10 more steps of the
    unbroken run, bit for bit (samples, log probs, step size, the
    generator's state)."""
    init = torch.zeros((3, 2), dtype=F64)
    kw = dict(num_warmup=15, max_depth=5)
    whole = tnuts.nuts_sample(gauss_t, init, 5, num_samples=25, **kw)
    first = tnuts.nuts_sample(gauss_t, init, 5, num_samples=15, **kw)
    assert torch.equal(first.samples, whole.samples[:15])
    more = tnuts.resume_nuts(gauss_t, first.state(), 10, max_depth=5)
    assert torch.equal(more.samples, whole.samples[15:])
    assert torch.equal(more.log_probs, whole.log_probs[15:])
    assert torch.equal(more.step_size, whole.step_size)
    assert more.final_generator_state == whole.final_generator_state


def test_save_load_round_trip(tmp_path):
    """save_hmc_state writes a NUTSResult's state as numpy arrays and the
    generator's bytes; the loaded state resumes the same bits as the live
    one."""
    res = tnuts.nuts_sample(gauss_t, torch.zeros((2, 2), dtype=F64), 3,
                            num_samples=6, num_warmup=6, max_depth=4)
    path = str(tmp_path / "state.pickle")
    tckpt.save_hmc_state(res, path)
    state = tckpt.load_hmc_state(path)
    assert set(state) == {"theta", "generator_state", "step_size",
                          "inv_mass", "accept_rate"}
    assert isinstance(state["generator_state"], bytes)
    a = tnuts.resume_nuts(gauss_t, res.state(), 5, max_depth=4)
    b = tnuts.resume_nuts(gauss_t, state, 5, max_depth=4, device="cpu")
    assert torch.equal(a.samples, b.samples)
    assert a.final_generator_state == b.final_generator_state


def test_reference_state_loads(gaussian_pair, tmp_path):
    """A state saved by the reference's save_hmc_state from its
    nuts_sample loads with theta, step size and inverse mass exactly, its
    key as the seed word0 * 2^32 + word1, and resumes on the port's
    generator."""
    ref = gaussian_pair[0]
    path = str(tmp_path / "reference_state.pickle")
    jckpt.save_hmc_state(ref, path)
    state = tckpt.load_hmc_state(path)
    for k in ("theta", "step_size", "inv_mass"):
        np.testing.assert_array_equal(state[k], np.asarray(ref.state()[k]))
    words = np.asarray(ref.final_key).astype(np.uint64)
    assert state["seed"] == int(words[0]) * 2 ** 32 + int(words[1])
    more = tnuts.resume_nuts(gauss_t, state, 4, max_depth=4, device="cpu")
    np.testing.assert_array_equal(more.step_size.numpy(),
                                  np.asarray(ref.step_size))
    again = tnuts.resume_nuts(gauss_t, state, 4, max_depth=4, device="cpu")
    assert torch.equal(more.samples, again.samples)


def test_mesh_refused():
    """mesh= takes a parallel.mesh.Mesh, and refuses a chain count that its
    probe extent does not divide, before anything is built (a mesh of
    three probe ranks, made without a process group: the refusal comes
    before any communication)."""
    from gppe_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh((3, 1), rank=0, groups={}, device="cpu", backend="gloo")
    pts, z, X = grid_problem(4)
    for fn in (tnuts.sample_posterior, tnuts.sample_posterior_large,
               tnuts.sample_posterior_rho_nu_large):
        with pytest.raises(ValueError, match="takes a gppe_tpu_torch"):
            fn(pts, z, X, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="8 chains do not divide over "
                           "the mesh's probe extent 3"):
            fn(pts, z, X, num_chains=8, mesh=mesh, device="cpu")


def in_box(samples, lo, hi):
    s = samples.numpy()
    return bool(np.isfinite(s).all() and np.all(s > np.asarray(lo))
                and np.all(s < np.asarray(hi)))


def test_sample_posterior_dense():
    """The dense (eta, rho) sampler on an 8 x 8 grid, bounded, then
    resumed; unbounded with a uniform prior, one chain's initial draw
    outside the prior's support falling back to the base point (1, -1):
    finite samples inside the box or the support."""
    from gppe_tpu_torch.models import priors
    pts, z, X = grid_problem(8)
    box = ((-3.0, 4.0), (-2.0, 0.0))
    res = tnuts.sample_posterior(pts, z, X, num_chains=3, num_samples=6,
                                 num_warmup=6, max_depth=4,
                                 support_log10=box, device="cpu")
    assert res.samples.shape == (6, 3, 2)
    assert in_box(res.samples, [b[0] for b in box], [b[1] for b in box])
    more = tnuts.sample_posterior(pts, z, X, num_samples=3, max_depth=4,
                                  support_log10=box,
                                  resume_state=res.state(), device="cpu")
    assert in_box(more.samples, [b[0] for b in box], [b[1] for b in box])

    def prior(eta, rho):
        return (priors.uniform_log_prior(eta, (1e-3, 1e4))
                + priors.uniform_log_prior(rho, (0.05, 0.2)))
    _, draws = thmc._init_draws(0, 3, 2, torch.device("cpu"))
    rho = 10.0 ** (-1.0 + draws[:, 1])
    assert not bool(((rho > 0.05) & (rho < 0.2)).all())
    res = tnuts.sample_posterior(pts, z, X, num_chains=3, num_samples=4,
                                 num_warmup=4, max_depth=4, log_prior=prior,
                                 device="cpu")
    assert in_box(res.samples, [-3.0, np.log10(0.05)], [4.0, np.log10(0.2)])


SURFACE_KW = dict(dtype=F64, num_probes=8)


def test_sample_posterior_large_resume():
    """sample_posterior_large on a float64 KrylovPosteriorSurface (120
    random points, 4 nodes, k = 12): in the box; 8 steps and a resume of 4
    equal 12 unbroken, bit for bit."""
    pts = np.random.RandomState(0).rand(120, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    kw = dict(num_chains=4, num_warmup=6, max_depth=5, device="cpu")
    whole, surface = tnuts.sample_posterior_large(
        pts, z, X, num_samples=6, surface_kwargs=dict(
            num_nodes=4, lanczos_steps=12, **SURFACE_KW), **kw)
    assert in_box(whole.samples, [-3.0, -1.5], [3.0, -0.5])
    first, _ = tnuts.sample_posterior_large(pts, z, X, num_samples=2,
                                            surface=surface, **kw)
    more, _ = tnuts.sample_posterior_large(pts, z, X, num_samples=4,
                                           surface=surface,
                                           resume_state=first.state(), **kw)
    assert torch.equal(more.samples, whole.samples[2:])


def test_sample_posterior_rho_nu_large():
    """sample_posterior_rho_nu_large on the (rho, nu) surface of a 12 x 12
    grid (3 x 3 nodes, k = 8) with the reference's priors: finite, inside
    the box, NUTS's diagnostics of the right shape."""
    pts, z, X = grid_problem(12)
    res, _ = tnuts.sample_posterior_rho_nu_large(
        pts, z, X, num_chains=4, num_samples=6, num_warmup=6, max_depth=5,
        log10_rho_bounds=(-1.2, -0.6),
        surface_kwargs=dict(num_rho_nodes=3, num_nu_nodes=3,
                            lanczos_steps=8, **SURFACE_KW), device="cpu")
    assert res.samples.shape == (6, 4, 3)
    assert in_box(res.samples, [0.5, -1.2, 1.0], [4.0, -0.6, 25.0])
    assert res.mean_tree_depth.shape == res.divergences.shape == (4,)
    assert len(res.leaves_per_step) == 12
