"""No-U-Turn sampler (NUTS) over kernel hyperparameters, chain-parallel.

Counterpart of ``gppe_tpu.models.nuts``: trajectory lengths adapt per step
by tree doubling until the trajectory makes a U-turn (Hoffman and Gelman
2014, with the multinomial state sampling and generalized U-turn criterion
of Betancourt 2017). The design in PyTorch:

* the chains are one batch: each leaf of the tree is one
  ``torch.func.vmap`` gradient over all chains (``hmc._batched``). Every
  chain still building sits at the same (doubling d, leaf i), since a chain
  that ran a subtree short has stopped, so the checkpoint indices of the
  sub-U-turn checks are Python ints. A chain's direction selects its
  moving endpoint through ``torch.where``; a stopped chain passes through
  every later leaf unchanged (its lane's gradient is computed and
  discarded);
* the step is a pure function of the carry, the global step index and one
  block of draws, drawn from one ``torch.Generator`` on the sampler's
  device once per step, in this order: momentum normals (chains, dim),
  direction uniforms (chains, max_depth) (forward where u < 1/2),
  subtree-accept uniforms (chains, max_depth), and leaf uniforms (chains,
  2^max_depth - 1), leaf i of doubling d at column 2^d - 1 + i. Uniforms
  no leaf uses are drawn and thrown away, so a chain's draws never depend
  on the other chains. The reference's ``jax.random`` draws have the same
  layout by position, which the tests rebuild from its key;
* the host reads only the loop conditions the reference's vmapped
  ``while_loop`` evaluates: "is any chain still building" once a leaf
  and once a doubling (but the first of each, where every chain that
  started it still builds). No arithmetic branches on a tensor's value,
  so the bits do not depend on whether a leaf whose chains have all
  stopped runs (``_sample_loop(early_exit=False)`` runs them all);
* adaptation is ``hmc._adapt``: dual averaging on the mean acceptance
  statistic of the tree, the Welford mass over warmup's second half;
* ``mesh=`` shards the chains over the mesh's ``probe`` axis as
  ``hmc.hmc_sample`` does; each loop condition is then the maximum of the
  probe ranks' flags (one all-reduce in place of the host read), so every
  rank builds the same leaves and makes the same draws.

State, draws and targets are float64.
"""

import math
from typing import NamedTuple

import torch

from ..utils.config import resolve_device
from . import hmc

_MAX_DELTA_ENERGY = 1000.0   # divergence threshold (Stan's default)


class NUTSResult(NamedTuple):
    samples: torch.Tensor          # (num_samples, chains, dim)
    log_probs: torch.Tensor        # (num_samples, chains)
    accept_rate: torch.Tensor      # (chains,) mean acceptance statistic
    step_size: torch.Tensor        # (chains,)
    inv_mass: torch.Tensor         # (chains, dim)
    mean_tree_depth: torch.Tensor  # (chains,) over the sampling phase
    divergences: torch.Tensor      # (chains,) count in the sampling phase
    final_theta: torch.Tensor      # (chains, dim), unconstrained
    final_generator_state: bytes   # torch.Generator.get_state() after it
    leaves_per_step: tuple = ()    # vmapped gradients of each step
    host_reads_per_step: tuple = ()  # loop conditions read on the host

    def state(self):
        """Chain state for checkpoint and resume, the contract of
        ``HMCResult.state``: a ``num_warmup=0`` restart from it
        (:func:`resume_nuts`) continues the chains bit for bit."""
        return {"theta": self.final_theta,
                "generator_state": self.final_generator_state,
                "step_size": self.step_size,
                "inv_mass": self.inv_mass}


def _popcount(n):
    """Number of set bits of a non-negative int."""
    return bin(n).count("1")


def _trailing_ones(n):
    """Number of trailing one bits of a non-negative int."""
    count = 0
    while n & 1:
        n >>= 1
        count += 1
    return count


def _turn_dots(r_left, r_right, r_sum, inv_mass):
    """The two inner products of the generalized U-turn criterion
    (Betancourt 2017, app. A.4.2), batched over the leading axes."""
    rho = r_sum - 0.5 * (r_left + r_right)
    return (torch.sum(inv_mass * r_left * rho, dim=-1),
            torch.sum(inv_mass * r_right * rho, dim=-1))


def _is_turning(r_left, r_right, r_sum, inv_mass):
    dot_l, dot_r = _turn_dots(r_left, r_right, r_sum, inv_mass)
    return (dot_l <= 0.0) | (dot_r <= 0.0)


def _leapfrog(grads_and_values, z, r, grad, eps, inv_mass):
    """One velocity-Verlet step of every chain; ``eps`` (chains, 1) signed
    by the direction. Returns (z, r, lp, grad)."""
    r_half = r + 0.5 * eps * grad
    z_new = z + eps * inv_mass * r_half
    grad_new, lp_new = grads_and_values(z_new)
    return z_new, r_half + 0.5 * eps * grad_new, lp_new, grad_new


def _where(mask, new, old):
    """``new`` where ``mask`` (chains,), else ``old``, key by key."""
    return {k: torch.where(mask.view(-1, *([1] * (old[k].dim() - 1))),
                           new[k], old[k]) for k in old}


class _Counter:
    """Leaves (vmapped gradients) and host reads of one step; ``share``
    (``hmc._Chains``) reduces a loop condition over the mesh's chains."""

    def __init__(self, early_exit, share):
        self.early_exit, self.share = early_exit, share
        self.leaves = self.reads = 0

    def any(self, mask):
        """Whether to go on: a host read of "any chain" of ``mask``, or
        True without ``early_exit``."""
        if not self.early_exit:
            return True
        self.reads += 1
        return self.share.any(mask)


def _subtree(grads_and_values, tree, fwd, active, d, eps, inv_mass,
             energy0, u_leaf, max_depth, counter):
    """Doubling ``d``: 2^d leaves from each chain's moving endpoint in its
    direction (``fwd`` (chains,) bool), the chains of ``active`` building.
    Returns the subtree's last leaf, proposal, weight, momentum sum, leaf
    count, accept sum and its turning and diverging flags. The reference's
    build_subtree (nuts.py:128-237)."""
    chains, dim = tree["z_left"].shape
    kw = dict(dtype=energy0.dtype, device=energy0.device)
    f1 = fwd[:, None]
    eps_d = torch.where(fwd, eps, -eps)[:, None]
    z = torch.where(f1, tree["z_right"], tree["z_left"])
    g = torch.where(f1, tree["g_right"], tree["g_left"])
    s = {"z": z, "r": torch.where(f1, tree["r_right"], tree["r_left"]),
         "g": g, "z_prop": z, "g_prop": g,
         "lp_prop": torch.full((chains,), -math.inf, **kw),
         "log_weight": torch.full((chains,), -math.inf, **kw),
         "r_sum": torch.zeros((chains, dim), **kw),
         "sum_accept": torch.zeros(chains, **kw),
         "num_leaves": torch.zeros(chains, **kw),
         "turning": torch.zeros(chains, dtype=torch.bool,
                                device=kw["device"]),
         "diverging": torch.zeros(chains, dtype=torch.bool,
                                  device=kw["device"])}
    # the momenta and momentum sums at the even leaves, for the checks of
    # the aligned subtrees that close at odd leaves; a chain that stopped
    # building never reads its rows again, so they are written unmasked
    r_ckpts = torch.zeros((chains, max_depth, dim), **kw)
    rsum_ckpts = torch.zeros((chains, max_depth, dim), **kw)
    building = active
    for i in range(2 ** d):
        if i > 0 and not counter.any(building):
            break
        counter.leaves += 1
        z, r, lp, grad = _leapfrog(grads_and_values, s["z"], s["r"], s["g"],
                                   eps_d, inv_mass)
        energy = -lp + 0.5 * torch.sum(r * r * inv_mass, dim=1)
        energy = torch.where(torch.isnan(energy),
                             torch.full_like(energy, math.inf), energy)
        delta = energy - energy0
        delta = torch.where(torch.isnan(delta),
                            torch.full_like(delta, math.inf), delta)  # inf-inf
        accept = torch.clamp(torch.exp(-delta), max=1.0)

        # multinomial progressive sampling within the subtree
        w_leaf = -energy
        log_weight = torch.logaddexp(s["log_weight"], w_leaf)
        take = torch.log(u_leaf[:, 2 ** d - 1 + i]) < w_leaf - log_weight
        t1 = take[:, None]
        r_sum = s["r_sum"] + r
        new = {"z": z, "r": r, "g": grad,
               "z_prop": torch.where(t1, z, s["z_prop"]),
               "g_prop": torch.where(t1, grad, s["g_prop"]),
               "lp_prop": torch.where(take, lp, s["lp_prop"]),
               "log_weight": log_weight, "r_sum": r_sum,
               "sum_accept": s["sum_accept"] + accept,
               "num_leaves": s["num_leaves"] + 1.0,
               "turning": s["turning"],
               "diverging": s["diverging"] | (delta > _MAX_DELTA_ENERGY)}

        idx_max = _popcount(i >> 1)
        if i % 2 == 0:
            r_ckpts[:, idx_max] = r
            rsum_ckpts[:, idx_max] = r_sum
        else:
            # every aligned subtree that closes at this odd leaf
            for k in range(idx_max - _trailing_ones(i) + 1, idx_max + 1):
                r_l = r_ckpts[:, k]
                new["turning"] = new["turning"] | _is_turning(
                    r_l, r, r_sum - rsum_ckpts[:, k] + r_l, inv_mass)
        s = _where(building, new, s)
        building = building & ~(s["turning"] | s["diverging"])
    return s


def _transition(grads_and_values, theta, lp, grad, eps, inv_mass, draws,
                max_depth, counter):
    """One NUTS update of every chain. Returns (theta, lp, grad,
    accept_stat, depth, diverged), each (chains, ...). The reference's
    _nuts_transition (nuts.py:115-300), vmapped."""
    normals, u_dir, u_acc, u_leaf = draws
    chains = theta.shape[0]
    r0 = normals / torch.sqrt(inv_mass)
    energy0 = -lp + 0.5 * torch.sum(r0 * r0 * inv_mass, dim=1)
    # a chain initialized outside the posterior support has lp0 = -inf;
    # keep the energies finite so NaNs cannot poison the adaptation
    energy0 = torch.where(torch.isfinite(energy0), energy0,
                          torch.full_like(energy0, math.inf))
    zeros = torch.zeros(chains, dtype=theta.dtype, device=theta.device)
    flags = torch.zeros(chains, dtype=torch.bool, device=theta.device)
    tree = {"z_left": theta, "r_left": r0, "g_left": grad,
            "z_right": theta, "r_right": r0, "g_right": grad,
            "z_prop": theta, "lp_prop": lp, "g_prop": grad,
            "log_weight": -energy0, "r_sum": r0, "depth": zeros,
            "turning": flags, "diverging": flags, "sum_accept": zeros,
            "num_leaves": zeros}
    for d in range(max_depth):
        active = ~(tree["turning"] | tree["diverging"])
        if d > 0 and not counter.any(active):
            break
        fwd = u_dir[:, d] < 0.5
        sub = _subtree(grads_and_values, tree, fwd, active, d, eps, inv_mass,
                       energy0, u_leaf, max_depth, counter)

        # biased progressive sampling: move the proposal to the new subtree
        sub_ok = ~(sub["turning"] | sub["diverging"])
        take = sub_ok & (torch.log(u_acc[:, d])
                         < sub["log_weight"] - tree["log_weight"])
        t1, f1 = take[:, None], fwd[:, None]
        new = {"z_prop": torch.where(t1, sub["z_prop"], tree["z_prop"]),
               "lp_prop": torch.where(take, sub["lp_prop"], tree["lp_prop"]),
               "g_prop": torch.where(t1, sub["g_prop"], tree["g_prop"])}
        # the moving endpoint becomes the subtree's last leaf
        for side, keep in (("left", ~f1), ("right", f1)):
            for v in ("z", "r", "g"):
                new[f"{v}_{side}"] = torch.where(keep, sub[v],
                                                 tree[f"{v}_{side}"])
        new["r_sum"] = tree["r_sum"] + sub["r_sum"]
        new["turning"] = sub["turning"] | (sub_ok & _is_turning(
            new["r_left"], new["r_right"], new["r_sum"], inv_mass))
        new.update(log_weight=torch.logaddexp(tree["log_weight"],
                                              sub["log_weight"]),
                   depth=tree["depth"] + 1.0, diverging=sub["diverging"],
                   sum_accept=tree["sum_accept"] + sub["sum_accept"],
                   num_leaves=tree["num_leaves"] + sub["num_leaves"])
        tree = _where(active, new, tree)
    accept_stat = tree["sum_accept"] / torch.clamp(tree["num_leaves"],
                                                   min=1.0)
    return (tree["z_prop"], tree["lp_prop"], tree["g_prop"], accept_stat,
            tree["depth"], tree["diverging"])


def _nuts_carry0(grads_and_values, init_theta, init_step_size,
                 init_inv_mass):
    """Initial carry: ``hmc._adapt_carry0``'s, plus the chains' gradients
    and the sampling phase's sums of accept statistic, depth and
    divergences. lp and gradient come from the same vmapped call as every
    later one, so a resumed chain holds the bits the unbroken one held."""
    grad, lp = grads_and_values(init_theta)
    carry = hmc._adapt_carry0(init_theta, lp, init_step_size, init_inv_mass)
    zeros = torch.zeros_like(lp)
    carry.update(grad=grad, sum_accept=zeros, sum_depth=zeros, n_div=zeros)
    return carry


def _nuts_step(grads_and_values, c, it, draws, num_warmup, max_depth,
               target_accept, counter):
    """One NUTS step of every chain at global step ``it`` (a Python int), a
    pure function of the carry ``c`` and one block of draws (see the
    module docstring). Returns the new carry. The reference's scan body
    (nuts.py:356-397)."""
    theta, lp, grad, accept_stat, depth, diverged = _transition(
        grads_and_values, c["theta"], c["lp"], c["grad"], c["step_size"],
        c["inv_mass"], draws, max_depth, counter)
    out = dict(c, theta=theta, lp=lp, grad=grad)
    if not hmc._adapt(c, out, it, accept_stat, num_warmup, target_accept):
        out.update(sum_accept=c["sum_accept"] + accept_stat,
                   sum_depth=c["sum_depth"] + depth,
                   n_div=c["n_div"] + diverged.to(theta.dtype))
    return out


def _draws(g, chains, dim, max_depth, dtype, device):
    """One step's block of draws, in the module docstring's order."""
    def rand(n):
        return torch.rand((chains, n), generator=g, dtype=dtype,
                          device=device)
    normals = torch.randn((chains, dim), generator=g, dtype=dtype,
                          device=device)
    return normals, rand(max_depth), rand(max_depth), rand(2 ** max_depth - 1)


def _sample_loop(grads_and_values, carry, num_warmup, num_samples,
                 max_depth, target_accept, next_draws, early_exit=True,
                 share=None):
    """Run ``num_warmup + num_samples`` steps from ``carry``, each on the
    block ``next_draws(it)``. Returns the NUTSResult without its generator
    state, gathered over ``share`` (``hmc._Chains``; default: the carry's
    chains alone). ``early_exit=False`` reads nothing on the host and runs
    every leaf of every doubling up to ``max_depth``, the stopped chains
    masked: the same bits at 2^max_depth - 1 gradients a step."""
    theta = carry["theta"]
    chains, dim = theta.shape
    share = share or hmc._Chains(None, chains)
    thetas, lps, leaves, reads = [], [], [], []
    for it in range(num_warmup + num_samples):
        counter = _Counter(early_exit, share)
        carry = _nuts_step(grads_and_values, carry, it, next_draws(it),
                           num_warmup, max_depth, target_accept, counter)
        leaves.append(counter.leaves)
        reads.append(counter.reads)
        if it >= num_warmup:
            thetas.append(carry["theta"])
            lps.append(carry["lp"])
    samples = (torch.stack(thetas) if thetas else
               torch.empty((0, chains, dim), dtype=theta.dtype,
                           device=theta.device))
    g = share.gather
    return NUTSResult(
        samples=g(samples, 1),
        log_probs=g(torch.stack(lps) if lps else samples[..., 0], 1),
        accept_rate=g(carry["sum_accept"] / num_samples),
        step_size=g(carry["step_size"]), inv_mass=g(carry["inv_mass"]),
        mean_tree_depth=g(carry["sum_depth"] / num_samples),
        divergences=g(carry["n_div"]), final_theta=g(carry["theta"]),
        final_generator_state=b"", leaves_per_step=tuple(leaves),
        host_reads_per_step=tuple(reads))


def nuts_sample(log_prob_fn, init_theta, generator=0, num_samples=1000,
                num_warmup=500, max_depth=10, init_step_size=0.1,
                target_accept=0.8, init_inv_mass=None, mesh=None):
    """Run NUTS. ``init_theta``: (chains, dim) float64 on the sampler's
    device; ``log_prob_fn`` maps (dim,) -> a scalar and is vmapped over the
    chains. ``generator``: a ``torch.Generator`` on that device (it
    advances), or an int seed for a new one. Returns :class:`NUTSResult`,
    with the leaves (vmapped gradients) and host reads of every step.

    ``init_step_size``: a number or (chains,); ``init_inv_mass``: an
    optional (chains, dim) diagonal inverse mass. A saved
    ``NUTSResult.state()`` continues exactly through :func:`resume_nuts`.
    ``mesh``: shard the chains over its probe axis (module docstring);
    ``init_theta``, the per-chain options and the result are whole."""
    theta = torch.as_tensor(init_theta)
    device, dtype = theta.device, theta.dtype
    chains, dim = theta.shape
    share = hmc._Chains(mesh, chains)
    g = hmc._generator(generator, device)
    grads_and_values = hmc._batched(log_prob_fn, "rev", dtype)
    carry = _nuts_carry0(grads_and_values, share.take(theta),
                         share.take(init_step_size),
                         share.take(init_inv_mass))
    res = _sample_loop(grads_and_values, carry, num_warmup, num_samples,
                       max_depth, target_accept,
                       lambda it: tuple(map(share.take, _draws(
                           g, chains, dim, max_depth, dtype, device))),
                       share=share)
    return res._replace(final_generator_state=bytes(g.get_state().numpy()))


def resume_nuts(log_prob_fn, state, num_samples, max_depth=10, *,
                device=None, mesh=None):
    """Continue chains from a saved ``NUTSResult.state()`` (or a state from
    ``utils.checkpoint.load_hmc_state``): no warmup, adaptation frozen at
    the saved step size and inverse mass, the generator continued from its
    saved state. The samples are those the unbroken run goes on to draw,
    bit for bit. ``device``: where the chains run, by default the saved
    theta's device if it is a tensor, else the card. ``mesh``: as
    :func:`nuts_sample`'s; the state is the whole one."""
    theta = state["theta"]
    if device is None:
        device = theta.device if torch.is_tensor(theta) else "cuda"
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(a, dtype=hmc.F64, device=device)

    return nuts_sample(log_prob_fn, dev(theta),
                       hmc._state_generator(state, device),
                       num_samples=num_samples, num_warmup=0,
                       max_depth=max_depth,
                       init_step_size=dev(state["step_size"]),
                       init_inv_mass=dev(state["inv_mass"]), mesh=mesh)


def sample_posterior(points, z, X, nu=0.5, num_chains=8, num_samples=500,
                     num_warmup=300, max_depth=8, key=0, init=None,
                     log_prior=None, mesh=None, support_log10=None,
                     resume_state=None, *, device="cuda"):
    """NUTS over the (log10 eta, log10 rho) posterior of a GP dataset, the
    dense profile likelihood (a Cholesky factorization per gradient) as the
    target: the adaptive-trajectory counterpart of
    :func:`hmc.sample_posterior`, with the same arguments but
    ``max_depth`` for ``num_leapfrog``. Chains drawn outside the prior's
    support fall back to the base point (log10 eta, log10 rho) = (1, -1)
    when no box is given. ``mesh``: shard the chains over its probe axis
    (:func:`nuts_sample`)."""
    from .kernel_posterior import (make_bounded_log_posterior,
                                   make_log_posterior)
    hmc._check_mesh(mesh, None if resume_state is not None else num_chains)
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
        res = resume_nuts(log_post, resume_state, num_samples,
                          max_depth=max_depth, device=device, mesh=mesh)
    else:
        g, draws = hmc._init_draws(key, num_chains, 2, device)
        if init is None:
            if support_log10 is not None:
                init = draws
            else:
                base = torch.tensor([1.0, -1.0], dtype=hmc.F64,
                                    device=device)
                init = base + draws
                ok = torch.isfinite(torch.func.vmap(log_post)(init))
                init = torch.where(ok[:, None], init, base)
        init = torch.as_tensor(init, dtype=hmc.F64, device=device)
        res = nuts_sample(log_post, init, g, num_samples=num_samples,
                          num_warmup=num_warmup, max_depth=max_depth,
                          mesh=mesh)
    return res if u_to_theta is None else hmc._with_theta(res, u_to_theta)


def _sample_surface(surface, log_post, u_to_theta, dim, num_chains,
                    num_samples, num_warmup, max_depth, key, resume_state,
                    mesh):
    if resume_state is not None:
        res = resume_nuts(log_post, resume_state, num_samples,
                          max_depth=max_depth, device=surface.device,
                          mesh=mesh)
    else:
        g, init = hmc._init_draws(key, num_chains, dim, surface.device)
        res = nuts_sample(log_post, init, g, num_samples=num_samples,
                          num_warmup=num_warmup, max_depth=max_depth,
                          mesh=mesh)
    return hmc._with_theta(res, u_to_theta), surface


def sample_posterior_large(points, z, X, nu=0.5, num_chains=64,
                           num_samples=500, num_warmup=300, max_depth=8,
                           key=0, log_prior=None, mesh=None,
                           log10_eta_bounds=(-3.0, 3.0),
                           log10_rho_bounds=(-1.5, -0.5),
                           surface=None, surface_kwargs=None,
                           resume_state=None, verbose=False, *,
                           device="cuda"):
    """NUTS over (log10 eta, log10 rho) at large n on the amortized Krylov
    surface (:class:`gppe_tpu_torch.models.krylov_posterior
    .KrylovPosteriorSurface`): all O(n) work happens once at construction,
    each tree leaf afterwards is elementwise Ritz math. The counterpart of
    :func:`hmc.sample_posterior_large`, in sigmoid coordinates over the
    (log10_eta_bounds x the surface's rho range) box. ``mesh``: as
    :func:`sample_posterior`'s (each rank builds the surface). Returns
    ``(NUTSResult, surface)``."""
    from .krylov_posterior import KrylovPosteriorSurface
    hmc._check_mesh(mesh, None if resume_state is not None else num_chains)
    if surface is None:
        surface = KrylovPosteriorSurface(
            points, z, X, nu=nu, log10_rho_bounds=log10_rho_bounds,
            verbose=verbose, device=device, **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)
    return _sample_surface(surface, log_post, u_to_theta, 2, num_chains,
                           num_samples, num_warmup, max_depth, key,
                           resume_state, mesh)


def sample_posterior_rho_nu_large(points, z, X, num_chains=64,
                                  num_samples=500, num_warmup=300,
                                  max_depth=8, key=0,
                                  log_prior="reference", mesh=None,
                                  log10_eta_bounds=(0.5, 4.0),
                                  log10_rho_bounds=(-1.2, -0.3),
                                  nu_bounds=(1.0, 25.0),
                                  surface=None, surface_kwargs=None,
                                  resume_state=None, verbose=False, *,
                                  device="cuda"):
    """NUTS over the full (log10 eta, log10 rho, nu) posterior at large n
    on the tensor-node FFT surface (:class:`gppe_tpu_torch.models
    .krylov_posterior.KrylovPosteriorSurfaceRhoNu`; regular-grid points),
    the counterpart of :func:`hmc.sample_posterior_rho_nu_large`;
    ``log_prior="reference"``: the golden pickle's priors; ``mesh`` as
    :func:`sample_posterior`'s. Returns ``(NUTSResult, surface)`` with
    samples (S, C, 3)."""
    from .krylov_posterior import KrylovPosteriorSurfaceRhoNu
    hmc._check_mesh(mesh, None if resume_state is not None else num_chains)
    if log_prior == "reference":
        log_prior = hmc._reference_prior
    if surface is None:
        surface = KrylovPosteriorSurfaceRhoNu(
            points, z, X, log10_rho_bounds=log10_rho_bounds,
            nu_bounds=nu_bounds, verbose=verbose, device=device,
            **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)
    return _sample_surface(surface, log_post, u_to_theta, 3, num_chains,
                           num_samples, num_warmup, max_depth, key,
                           resume_state, mesh)
