"""Hamiltonian Monte Carlo over kernel hyperparameters, chain-parallel.

Counterpart of ``gppe_tpu.models.hmc``: the Bayesian counterpart of the
reference's grid / MAP outer loop (reference:
examples/FindOptimalCovarianceParameters.py). The design in PyTorch:

* chains are one batch: every gradient is ``torch.func.vmap`` of
  ``torch.func.grad_and_value`` (``jacfwd`` under ``grad_mode="fwd"``)
  over the chain axis, so C chains advance as one set of batched kernels
  on the card, with no Python loop over chains;
* the step is a pure function of the carry, the global step index and
  its draws (standard normals (chains, dim), then uniforms (chains,)),
  which :func:`hmc_sample` draws from one explicit ``torch.Generator`` on
  the sampler's device, once per step, in that order;
* dual-averaging step-size adaptation (Nesterov; Hoffman and Gelman)
  during warmup, per chain, and a diagonal mass matrix from the Welford
  moments of the second half of warmup, switched in at its last step;
* the warmup schedule reads the Python step index only: no host
  synchronisation and no branch on a tensor's value inside a step;
* ``mesh=`` (a :class:`gppe_tpu_torch.parallel.mesh.Mesh`) shards the
  chains over its ``probe`` axis: each rank runs the contiguous share of
  its probe coordinate (replicated over ``block``), makes the draws of
  every chain and takes its own, and gathers the results, so that every
  rank returns what ``mesh=None`` returns.

State, draws and targets are float64.
"""

import math
from typing import NamedTuple

import torch

from ..parallel.mesh import PROBE_AXIS, Mesh
from ..utils.config import resolve_device

F64 = torch.float64
# dual averaging (Hoffman and Gelman 2014, section 3.2), the reference's
GAMMA, T0, KAPPA = 0.05, 10.0, 0.75


def _check_mesh(mesh, num_chains=None):
    """Refuse what cannot shard the chains: a ``mesh`` that is neither None
    nor a :class:`~gppe_tpu_torch.parallel.mesh.Mesh`, or a chain count
    its probe extent does not divide."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh= takes a gppe_tpu_torch.parallel.mesh.Mesh "
                         f"or None; got {type(mesh).__name__}")
    probe = mesh.shape[PROBE_AXIS]
    if num_chains is not None and num_chains % probe:
        raise ValueError(f"{num_chains} chains do not divide over the "
                         f"mesh's probe extent {probe}")


class _Chains:
    """The chains this rank runs: all of them without a mesh; with one,
    the contiguous share of its probe coordinate. ``take`` cuts a
    per-chain tensor (leading axis the chains) to that share, ``gather``
    puts the shares of every probe rank back together along ``dim``,
    ``any`` is a flag's "any chain" over all of them."""

    def __init__(self, mesh, num_chains):
        _check_mesh(mesh, num_chains)
        self.mesh, self.num_chains = mesh, num_chains
        self.lo, self.hi = 0, num_chains
        if mesh is not None:
            per = num_chains // mesh.shape[PROBE_AXIS]
            self.lo = mesh.coords[PROBE_AXIS] * per
            self.hi = self.lo + per

    def take(self, t):
        if (self.mesh is None or not torch.is_tensor(t) or t.dim() == 0
                or t.shape[0] != self.num_chains):
            return t
        return t[self.lo:self.hi]

    def gather(self, t, dim=0):
        if self.mesh is None:
            return t
        whole = self.mesh.all_gather(t.movedim(dim, 0).contiguous(),
                                     PROBE_AXIS)
        return whole.movedim(0, dim)

    def any(self, mask):
        if self.mesh is None:
            return bool(mask.any())
        flag = mask.any().to(torch.int32).reshape(1)
        return bool(self.mesh.all_reduce(flag, PROBE_AXIS, op="max")[0])


class HMCResult(NamedTuple):
    samples: torch.Tensor          # (num_samples, chains, dim)
    log_probs: torch.Tensor        # (num_samples, chains)
    accept_rate: torch.Tensor      # (chains,)
    step_size: torch.Tensor        # (chains,)
    inv_mass: torch.Tensor         # (chains, dim)
    final_theta: torch.Tensor      # (chains, dim), unconstrained
    final_generator_state: bytes   # torch.Generator.get_state() after it

    def state(self):
        """Chain state for checkpoint and resume (``utils.checkpoint`` and
        :func:`resume_hmc`). Adaptation is frozen after warmup, so a
        ``num_warmup=0`` restart from this state reproduces the chains the
        unbroken run goes on to draw, bit for bit."""
        return {"theta": self.final_theta,
                "generator_state": self.final_generator_state,
                "step_size": self.step_size,
                "inv_mass": self.inv_mass}


def _leapfrog(grad_fn, theta, momentum, step_size, inv_mass, num_steps):
    """Velocity Verlet with fused half-kicks: the adjacent half-kicks of
    the textbook step chained into full kicks, the same trajectory at
    num_steps + 1 gradients (the gradient is the whole cost of a kernel
    hyperparameter target). ``grad_fn(theta) -> (gradient, value)``
    (``torch.func.grad_and_value``'s pair); elementwise in theta, so one
    chain (dim,) or a batch (chains, dim) with ``step_size`` (chains, 1).
    Returns the end point, its momentum and the target's value there."""
    grad, _ = grad_fn(theta)
    mo = momentum + 0.5 * step_size * grad
    for _ in range(num_steps - 1):
        theta = theta + step_size * inv_mass * mo
        grad, _ = grad_fn(theta)
        mo = mo + step_size * grad
    theta = theta + step_size * inv_mass * mo
    grad, value = grad_fn(theta)
    mo = mo + 0.5 * step_size * grad
    return theta, mo, value


def _batched(log_prob_fn, grad_mode, dtype):
    """The vmapped gradient and value, (chains, dim) -> ((chains, dim),
    (chains,)), in ``dtype``."""
    if grad_mode == "rev":
        gv = torch.func.grad_and_value(log_prob_fn)
    elif grad_mode == "fwd":
        gv = torch.func.jacfwd(lambda th: (log_prob_fn(th),) * 2,
                               has_aux=True)
    else:
        raise ValueError(f"grad_mode must be 'rev' or 'fwd', got "
                         f"{grad_mode!r}")
    gv = torch.func.vmap(gv)

    def grads_and_values(theta):
        g, v = gv(theta)
        return g.to(dtype), v.to(dtype)

    return grads_and_values


def _adapt_carry0(init_theta, lp, init_step_size, init_inv_mass):
    """The carry every sampler shares: the chains' points and values, the
    dual-averaging and Welford state (the reference's, plus ``step_size``
    = exp(log_eps), which a resumed run takes as saved)."""
    chains, dim = init_theta.shape
    kw = dict(dtype=init_theta.dtype, device=init_theta.device)
    iss = torch.broadcast_to(torch.as_tensor(init_step_size, **kw),
                             (chains,))
    return {
        "theta": init_theta,
        "lp": lp,
        "mu": torch.log(10.0 * iss),
        # log_eps_bar starts at log(init_step_size): warmup's first dual-
        # averaging step overwrites it (eta_1 = 1), and without warmup it
        # is the fixed step size, the resume contract
        "log_eps": torch.log(iss),
        "log_eps_bar": torch.log(iss),
        "step_size": iss.clone(),
        "h_bar": torch.zeros(chains, **kw),
        "w_mean": torch.zeros((chains, dim), **kw),
        "w_m2": torch.zeros((chains, dim), **kw),
        "inv_mass": (torch.ones((chains, dim), **kw) if init_inv_mass is None
                     else torch.broadcast_to(
                         torch.as_tensor(init_inv_mass, **kw),
                         (chains, dim)).clone()),
    }


def _hmc_carry0(grads_and_values, init_theta, init_step_size,
                init_inv_mass):
    """Initial HMC carry: everything the chains need to continue. The
    initial lp comes from the same vmapped call as every later one, so a
    resumed chain holds the bits the unbroken one held."""
    carry = _adapt_carry0(init_theta, grads_and_values(init_theta)[1],
                          init_step_size, init_inv_mass)
    carry["n_accept"] = torch.zeros_like(carry["h_bar"])
    return carry


def _hmc_step(grads_and_values, c, it, normals, uniforms, num_warmup,
              num_leapfrog, target_accept):
    """One HMC transition of every chain at global step ``it`` (a Python
    int), a pure function of the carry ``c`` and the draws: ``normals``
    (chains, dim) standard normals, ``uniforms`` (chains,) in [0, 1).
    Returns the new carry. The reference's scan body (hmc.py:128-186)."""
    inv_mass = c["inv_mass"]
    theta, lp = c["theta"], c["lp"]
    # momentum ~ N(0, M), M = 1 / inv_mass (diagonal)
    mo = normals / torch.sqrt(inv_mass)
    theta_new, mo_new, lp_new = _leapfrog(
        grads_and_values, theta, mo, c["step_size"][:, None], inv_mass,
        num_leapfrog)
    lp_new = torch.where(torch.isfinite(lp_new), lp_new,
                         torch.full_like(lp_new, -math.inf))

    ke_old = 0.5 * torch.sum(mo * mo * inv_mass, dim=1)
    ke_new = 0.5 * torch.sum(mo_new * mo_new * inv_mass, dim=1)
    log_accept = (lp_new - ke_new) - (lp - ke_old)
    log_accept = torch.where(torch.isnan(log_accept),
                             torch.full_like(log_accept, -math.inf),
                             log_accept)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    accept = uniforms < accept_prob
    theta = torch.where(accept[:, None], theta_new, theta)
    lp = torch.where(accept, lp_new, lp)

    out = dict(c, theta=theta, lp=lp)
    if not _adapt(c, out, it, accept_prob, num_warmup, target_accept):
        out["n_accept"] = c["n_accept"] + accept.to(theta.dtype)
    return out


def _adapt(c, out, it, accept_stat, num_warmup, target_accept):
    """Warmup's adaptation after step ``it`` (a Python int), written into
    ``out``, the new carry that already holds the step's theta: dual
    averaging of the step size on ``accept_stat`` (chains,), then the
    Welford moments over warmup's second half, the adapted mass switched in
    at warmup's last step. Returns whether ``it`` was a warmup step. The
    reference's arithmetic (hmc.py:155-178, nuts.py:366-388)."""
    in_warmup = it < num_warmup
    if in_warmup:
        # dual averaging; the scalars in Python float64, as the reference
        # computes them
        t = it + 1.0
        h_bar = ((1.0 - 1.0 / (t + T0)) * c["h_bar"]
                 + (target_accept - accept_stat) / (t + T0))
        log_eps = c["mu"] - math.sqrt(t) / GAMMA * h_bar
        eta_t = t ** (-KAPPA)
        out.update(h_bar=h_bar, log_eps=log_eps,
                   log_eps_bar=eta_t * log_eps
                   + (1 - eta_t) * c["log_eps_bar"],
                   step_size=torch.exp(log_eps))
    elif it == num_warmup and num_warmup > 0:
        # the reference's first step after warmup still takes warmup's
        # last iterate; from the next on, the averaged one (a resumed run
        # takes its saved step size as it is)
        out.update(log_eps=c["log_eps_bar"],
                   step_size=torch.exp(c["log_eps_bar"]))

    # Welford moments over warmup's second half; the adapted mass
    # switched in at warmup's last step
    theta = out["theta"]
    half = num_warmup // 2
    cnt = float(max(it - half + 1, 1))
    if in_warmup and it >= half:
        delta = theta - c["w_mean"]
        w_mean = c["w_mean"] + delta / cnt
        out.update(w_mean=w_mean, w_m2=c["w_m2"] + delta * (theta - w_mean))
    if it == num_warmup - 1:
        var = out["w_m2"] / max(cnt - 1.0, 1.0)
        out["inv_mass"] = torch.where(var > 1e-10, var,
                                      torch.ones_like(var))
    return in_warmup


def _generator(generator, device):
    """``generator`` as a torch.Generator on ``device``: a Generator as
    given (it must live on ``device``), an int seeds a new one."""
    if isinstance(generator, torch.Generator):
        if torch.device(generator.device).type != device.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the chains on {device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def _draws(g, chains, dim, dtype, device):
    """One step's draws, in this order: normals (chains, dim), then
    uniforms (chains,)."""
    normals = torch.randn((chains, dim), generator=g, dtype=dtype,
                          device=device)
    uniforms = torch.rand((chains,), generator=g, dtype=dtype, device=device)
    return normals, uniforms


def hmc_sample(log_prob_fn, init_theta, generator=0, num_samples=1000,
               num_warmup=500, num_leapfrog=16, init_step_size=0.1,
               target_accept=0.8, init_inv_mass=None, grad_mode="rev",
               chunk_steps=None, mesh=None):
    """Run HMC. ``init_theta``: (chains, dim) float64 on the sampler's
    device; ``log_prob_fn`` maps (dim,) -> a scalar and is vmapped over the
    chains. ``generator``: a ``torch.Generator`` on that device (it
    advances), or an int seed for a new one. Returns :class:`HMCResult`.

    ``init_step_size``: a number or (chains,); ``init_inv_mass``: an
    optional (chains, dim) diagonal inverse mass. A saved
    ``HMCResult.state()`` continues exactly through :func:`resume_hmc`.

    ``grad_mode``: "rev" (``torch.func.grad``) or "fwd" (``jacfwd``):
    forward mode pays dim tangent passes and keeps no residuals of the
    target's loops (the traced-nu Bessel form: reverse mode keeps about
    200 iterations of (n, n) residuals per chain).

    ``chunk_steps``: the reference's option (it split the scan into
    device programs of at most this many steps). Here the host waits for
    the device every ``chunk_steps`` steps; the bits are the same for every
    value.

    ``mesh``: shard the chains over its probe axis (module docstring);
    ``init_theta`` and the per-chain options are whole, the result too."""
    theta = torch.as_tensor(init_theta)
    device, dtype = theta.device, theta.dtype
    chains, dim = theta.shape
    share = _Chains(mesh, chains)
    g = _generator(generator, device)
    grads_and_values = _batched(log_prob_fn, grad_mode, dtype)
    carry = _hmc_carry0(grads_and_values, share.take(theta),
                        share.take(init_step_size), share.take(init_inv_mass))
    thetas, lps = [], []
    for it in range(num_warmup + num_samples):
        normals, uniforms = _draws(g, chains, dim, dtype, device)
        carry = _hmc_step(grads_and_values, carry, it, share.take(normals),
                          share.take(uniforms), num_warmup, num_leapfrog,
                          target_accept)
        if it >= num_warmup:
            thetas.append(carry["theta"])
            lps.append(carry["lp"])
        if chunk_steps and (it + 1) % chunk_steps == 0 and \
                device.type == "cuda":
            torch.cuda.synchronize(device)
    samples = (torch.stack(thetas) if thetas else
               torch.empty((0, share.hi - share.lo, dim), dtype=dtype,
                           device=device))
    return HMCResult(
        samples=share.gather(samples, 1),
        log_probs=share.gather(torch.stack(lps) if lps else samples[..., 0],
                               1),
        accept_rate=share.gather(carry["n_accept"] / num_samples),
        step_size=share.gather(carry["step_size"]),
        inv_mass=share.gather(carry["inv_mass"]),
        final_theta=share.gather(carry["theta"]),
        final_generator_state=bytes(g.get_state().numpy()))


def _state_generator(state, device):
    """The generator of a saved state: its ``generator_state`` bytes (from
    a generator of the same device type), or a new one seeded with its
    ``seed`` (a reference state's key, see
    ``utils.checkpoint.load_hmc_state``)."""
    g = torch.Generator(device=device)
    if "generator_state" in state:
        raw = state["generator_state"]
        if not torch.is_tensor(raw):
            raw = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        g.set_state(raw)
    else:
        g.manual_seed(int(state["seed"]))
    return g


def resume_hmc(log_prob_fn, state, num_samples, num_leapfrog=16,
               grad_mode="rev", chunk_steps=None, *, device=None, mesh=None):
    """Continue chains from a saved ``HMCResult.state()`` (or a state from
    ``utils.checkpoint.load_hmc_state``): no warmup, adaptation frozen at
    the saved step size and inverse mass, the generator continued from
    its saved state. The samples are those the unbroken run goes on to
    draw, bit for bit. ``device``: where the chains run, by default the
    saved theta's device if it is a tensor, else the card.

    ``grad_mode`` must match the original run for targets that need it
    (the traced-nu Bessel posterior needs forward mode). ``mesh``: as
    :func:`hmc_sample`'s; the state is the whole one."""
    theta = state["theta"]
    if device is None:
        device = theta.device if torch.is_tensor(theta) else "cuda"
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(a, dtype=F64, device=device)

    return hmc_sample(log_prob_fn, dev(theta),
                      _state_generator(state, device),
                      num_samples=num_samples, num_warmup=0,
                      num_leapfrog=num_leapfrog,
                      init_step_size=dev(state["step_size"]),
                      init_inv_mass=dev(state["inv_mass"]),
                      grad_mode=grad_mode, chunk_steps=chunk_steps,
                      mesh=mesh)


def _init_draws(key, chains, dim, device):
    """A sampler's generator, seeded with its ``key``, and its initial
    0.5 * N(0, 1) points (chains, dim), drawn first."""
    g = torch.Generator(device=device).manual_seed(int(key))
    return g, 0.5 * torch.randn((chains, dim), generator=g, dtype=F64,
                                device=device)


def _with_theta(res, u_to_theta):
    return res._replace(samples=u_to_theta(res.samples))


def sample_posterior(points, z, X, nu=0.5, num_chains=8, num_samples=500,
                     num_warmup=300, num_leapfrog=16, key=0, init=None,
                     log_prior=None, mesh=None, support_log10=None,
                     resume_state=None, chunk_steps=None, *, device="cuda"):
    """Sample the (log10 eta, log10 rho) posterior of a GP dataset, the
    dense profile likelihood (a Cholesky factorization per gradient) as the
    target. Chains are a batch axis on ``device``.

    ``support_log10``: optional ((lo, hi), (lo, hi)) log10 box; sampling
    then runs in unconstrained sigmoid coordinates and the samples are
    mapped back. ``resume_state``: a saved ``HMCResult.state()``; the
    chains continue exactly (no warmup, adaptation frozen), the other
    arguments as in the original run. ``key`` seeds the generator that
    draws the initial points and then the run. ``mesh``: shard the chains
    over its probe axis (:func:`hmc_sample`)."""
    from .kernel_posterior import (make_bounded_log_posterior,
                                   make_log_posterior)
    _check_mesh(mesh, None if resume_state is not None else num_chains)
    device = resolve_device(device)
    u_to_theta = None
    if support_log10 is not None:
        log_post, u_to_theta = make_bounded_log_posterior(
            points, z, X, nu=nu, log10_bounds=support_log10,
            log_prior=log_prior, device=device)
    else:
        log_post = make_log_posterior(points, z, X, nu=nu,
                                      log_prior=log_prior, device=device)
    if resume_state is not None:
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog, chunk_steps=chunk_steps,
                         device=device, mesh=mesh)
    else:
        g, draws = _init_draws(key, num_chains, 2, device)
        if init is None:
            if support_log10 is not None:
                init = draws
            else:
                # log10 eta ~ 1, log10 rho ~ -1; chains drawn outside the
                # prior's support (lp = -inf) fall back to that point
                base = torch.tensor([1.0, -1.0], dtype=F64, device=device)
                init = base + draws
                ok = torch.isfinite(torch.func.vmap(log_post)(init))
                init = torch.where(ok[:, None], init, base)
        init = torch.as_tensor(init, dtype=F64, device=device)
        res = hmc_sample(log_post, init, g, num_samples=num_samples,
                         num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                         chunk_steps=chunk_steps, mesh=mesh)
    return res if u_to_theta is None else _with_theta(res, u_to_theta)


def _reference_prior(eta, rho, nu):
    """The golden pickle's priors (reference
    FindOptimalCovarianceParameters.py:119-146): inverse-square on rho
    and on nu / 25."""
    from .priors import inverse_square_log_prior
    return (inverse_square_log_prior(rho)
            + inverse_square_log_prior(nu, scale=25.0))


def sample_posterior_nu(points, z, X, num_chains=8, num_samples=500,
                        num_warmup=300, num_leapfrog=16, key=0,
                        log_prior="reference",
                        log10_eta_bounds=(-3.0, 4.0),
                        log10_rho_bounds=(-2.0, 0.0),
                        nu_bounds=(1.0, 25.0), mesh=None,
                        resume_state=None, chunk_steps=None, *,
                        device="cuda"):
    """Sample the full (log10 eta, log10 rho, nu) posterior, nu through the
    Bessel K_nu, the dense Cholesky target. ``log_prior="reference"``: the
    golden pickle's priors; None for flat in the box; or a callable
    ``log_prior(eta, rho, nu)`` in natural parameters. Gradients in
    forward mode (``jacfwd``: reverse mode keeps the Bessel loops'
    residuals, about 200 iterations of (n, n) per chain). ``mesh``: as
    :func:`sample_posterior`'s. Returns an HMCResult with samples (S, C, 3)
    in (log10 eta, log10 rho, nu)."""
    from .kernel_posterior import make_bounded_log_posterior_nu
    _check_mesh(mesh, None if resume_state is not None else num_chains)
    device = resolve_device(device)
    if log_prior == "reference":
        log_prior = _reference_prior
    log_post, u_to_theta = make_bounded_log_posterior_nu(
        points, z, X, log10_bounds=(log10_eta_bounds, log10_rho_bounds),
        nu_bounds=nu_bounds, log_prior=log_prior, device=device)
    if resume_state is not None:
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog, grad_mode="fwd",
                         chunk_steps=chunk_steps, device=device, mesh=mesh)
    else:
        g, init = _init_draws(key, num_chains, 3, device)
        res = hmc_sample(log_post, init, g, num_samples=num_samples,
                         num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                         grad_mode="fwd", chunk_steps=chunk_steps,
                         mesh=mesh)
    return _with_theta(res, u_to_theta)


def sample_profile_posterior_rho_nu(points, z, X, num_chains=8,
                                    num_samples=400, num_warmup=200,
                                    num_leapfrog=10, key=0,
                                    log_prior="reference",
                                    log10_eta_bounds=(-3.0, 4.0),
                                    log10_rho_bounds=(-1.3, -0.3),
                                    nu_bounds=(1.0, 25.0),
                                    chunk_steps=None, eta_grid=29,
                                    golden_iters=22, *, device="cuda"):
    """HMC over (log10 rho, nu) on the eta-profiled surface
    (``kernel_posterior.make_profiled_rho_nu_posterior``), the sampler
    counterpart of the reference's MAP sweep. ``log_prior="reference"``:
    inverse-square priors on rho and on nu / 25, or a callable
    ``log_prior(rho, nu)``. Forward-mode gradients. Returns an HMCResult
    with samples (S, C, 2) in (log10 rho, nu)."""
    from .kernel_posterior import make_profiled_rho_nu_posterior
    device = resolve_device(device)
    if log_prior == "reference":
        def log_prior(rho, nu):  # noqa: F811
            return _reference_prior(None, rho, nu)
    log_post, u_to_theta = make_profiled_rho_nu_posterior(
        points, z, X, log10_eta_bounds=log10_eta_bounds,
        log10_rho_bounds=log10_rho_bounds, nu_bounds=nu_bounds,
        log_prior=log_prior, eta_grid=eta_grid, golden_iters=golden_iters,
        device=device)
    g, init = _init_draws(key, num_chains, 2, device)
    res = hmc_sample(log_post, init, g, num_samples=num_samples,
                     num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                     grad_mode="fwd", chunk_steps=chunk_steps)
    return _with_theta(res, u_to_theta)


def _sample_surface(surface, log_post, u_to_theta, dim, num_chains,
                    num_samples, num_warmup, num_leapfrog, key,
                    resume_state, mesh):
    if resume_state is not None:
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog, device=surface.device,
                         mesh=mesh)
    else:
        g, init = _init_draws(key, num_chains, dim, surface.device)
        res = hmc_sample(log_post, init, g, num_samples=num_samples,
                         num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                         mesh=mesh)
    return _with_theta(res, u_to_theta), surface


def sample_posterior_rho_nu_large(points, z, X, num_chains=64,
                                  num_samples=500, num_warmup=300,
                                  num_leapfrog=16, key=0,
                                  log_prior="reference", mesh=None,
                                  log10_eta_bounds=(0.5, 4.0),
                                  log10_rho_bounds=(-1.2, -0.3),
                                  nu_bounds=(1.0, 25.0),
                                  surface=None, surface_kwargs=None,
                                  resume_state=None, verbose=False, *,
                                  device="cuda"):
    """HMC over the full (log10 eta, log10 rho, nu) posterior at large n,
    on the tensor-node FFT surface
    (:class:`gppe_tpu_torch.models.krylov_posterior
    .KrylovPosteriorSurfaceRhoNu`; regular-grid points): the O(n log n)
    work happens once at the surface's construction, and each gradient
    afterwards is Ritz-space math whose cost does not grow with n. The
    chains run on the surface's device (a new surface's: ``device``).
    ``log_prior`` as :func:`sample_posterior_nu`'s, ``mesh`` as
    :func:`sample_posterior`'s (each rank builds the surface). Returns
    ``(HMCResult, surface)`` with samples (S, C, 3) in (log10 eta,
    log10 rho, nu)."""
    from .krylov_posterior import KrylovPosteriorSurfaceRhoNu
    _check_mesh(mesh, None if resume_state is not None else num_chains)
    if log_prior == "reference":
        log_prior = _reference_prior
    if surface is None:
        surface = KrylovPosteriorSurfaceRhoNu(
            points, z, X, log10_rho_bounds=log10_rho_bounds,
            nu_bounds=nu_bounds, verbose=verbose, device=device,
            **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)
    return _sample_surface(surface, log_post, u_to_theta, 3, num_chains,
                           num_samples, num_warmup, num_leapfrog, key,
                           resume_state, mesh)


def sample_posterior_large(points, z, X, nu=0.5, num_chains=64,
                           num_samples=500, num_warmup=300, num_leapfrog=16,
                           key=0, log_prior=None, mesh=None,
                           log10_eta_bounds=(-3.0, 3.0),
                           log10_rho_bounds=(-1.5, -0.5),
                           surface=None, surface_kwargs=None,
                           resume_state=None, verbose=False, *,
                           device="cuda"):
    """HMC over (log10 eta, log10 rho) at large n, matrix-free: the target
    is the amortized Krylov surface
    (:class:`gppe_tpu_torch.models.krylov_posterior.KrylovPosteriorSurface`,
    its nodes on the multi-rho kernel at a closed-form nu). All O(n) work
    happens once at construction; each gradient afterwards is elementwise
    Ritz math. Sampling runs in unconstrained sigmoid coordinates over the
    (log10_eta_bounds x the surface's rho range) box. Returns
    ``(HMCResult, surface)``: keep the surface to resume (``resume_state``)
    or to draw more samples without paying the setup again. ``mesh``: as
    :func:`sample_posterior`'s (each rank builds the surface)."""
    from .krylov_posterior import KrylovPosteriorSurface
    _check_mesh(mesh, None if resume_state is not None else num_chains)
    if surface is None:
        surface = KrylovPosteriorSurface(
            points, z, X, nu=nu, log10_rho_bounds=log10_rho_bounds,
            verbose=verbose, device=device, **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)
    return _sample_surface(surface, log_post, u_to_theta, 2, num_chains,
                           num_samples, num_warmup, num_leapfrog, key,
                           resume_state, mesh)
