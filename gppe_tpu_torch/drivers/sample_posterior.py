"""Posterior sampling driver: HMC or NUTS chains over (log10 eta, log10
rho), the nu samplers at the golden configuration, and the (log10 eta,
log10 rho, nu) posterior at n ~ 10^5 on the FFT surface.

Counterpart of the reference's ``drivers/sample_posterior.py`` (BASELINE
config 5):

* :func:`main`: HMC or NUTS (``sampler``) over (log10 eta, log10 rho) on
  the dense profile likelihood (a Cholesky factorization per gradient),
  the uniform priors of the reference's driver, sampling in sigmoid
  coordinates over their box;
* :func:`main_nu`: at the golden configuration (n = 900, noise 0.2), the
  joint (eta, rho, nu) HMC, the eta-profiled (rho, nu) HMC, then the
  deterministic with-prior argmax refinement on the (rho, nu) search's
  objective (``find_optimal_covariance.build_objective``);
* :func:`main_profile_rho_nu`: the eta-profiled sampler over the golden
  grid's box with the distributional validation against the golden
  surface (:func:`golden_marginals`, :func:`_marginal_validation`) when
  given its pickle, and the same refinement;
* :func:`main_rho_nu_large`: the (eta, rho, nu) posterior at grid side
  317 (n = 100,489) on ``KrylovPosteriorSurfaceRhoNu``, with the
  reference's probe cross-validation against independent FFT engines and
  split R-hat and ESS of every coordinate.

    python -m gppe_tpu_torch.drivers.sample_posterior \
        [--sampler nuts | --nu | --profile-rho-nu | --rho-nu-large]

runs on the card (``device="cpu"`` for a rehearsal: float64 there, the
surface's Lanczos passes float32 on the card) and writes a file only when
given ``results_path``. Every time ends with a device synchronise.
Under an initialised process group of more than one rank (``torchrun``,
``parallel.mesh.spawn``), :func:`main` shards its chains over the ranks.
"""

import argparse
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import diagnostics, hmc, nuts, priors
from ..models.krylov_posterior import KrylovPosteriorSurfaceRhoNu
from ..models.large_scale import KrylovProfileLikelihood
from ..ops import operators
from ..parallel import mesh as mesh_mod
from ..utils import checkpoint
from ..utils import data as data_utils
from ..utils.config import resolve_device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(num_points=30, noise=0.2, num_chains=8, num_samples=500,
         num_warmup=400, use_mesh=True, sampler="hmc", results_path=None,
         verbose=True, *, device="cuda"):
    """HMC or NUTS (``sampler``) over (log10 eta, log10 rho) at n =
    num_points^2 grid points, nu = 1/2, uniform priors eta in (1e-3, 1e4),
    rho in (0.02, 0.6) (reference :17-82); NUTS adds its divergences and
    mean tree depth to the results. With ``results_path`` it writes the
    results and, beside them at ``results_path + ".state"``, the chains'
    state. With ``use_mesh`` inside an initialised process group of more
    than one rank, the chains shard over a mesh of all its ranks, the probe
    extent min(num_chains, ranks) (the reference's), each rank on its own
    ``device`` (``parallel.mesh.make_mesh``); with a single process they
    run as one batch on ``device``, as the reference does with one
    device."""
    if sampler not in ("hmc", "nuts"):
        raise ValueError(f"sampler must be 'hmc' or 'nuts', got {sampler!r}")
    mesh = None
    if (use_mesh and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        mesh = mesh_mod.make_mesh(
            probe=min(num_chains, dist.get_world_size()), device=device)
        device = mesh.device
    device = resolve_device(device)

    pts = data_utils.generate_points(num_points, dimension=2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)

    def log_prior(eta, rho):
        return (priors.uniform_log_prior(eta, (1e-3, 1e4))
                + priors.uniform_log_prior(rho, (0.02, 0.6)))

    support = ((np.log10(1e-3), np.log10(1e4)),
               (np.log10(0.02), np.log10(0.6)))
    _sync(device)
    t0 = time.perf_counter()
    sampler_mod = {"hmc": hmc, "nuts": nuts}[sampler]
    res = sampler_mod.sample_posterior(
        pts, z, X, nu=0.5, num_chains=num_chains, num_samples=num_samples,
        num_warmup=num_warmup, key=0, log_prior=log_prior, mesh=mesh,
        support_log10=support, device=device)
    _sync(device)
    wall = time.perf_counter() - t0

    samples = res.samples.cpu().numpy()             # (S, C, 2)
    flat = samples.reshape(-1, 2)
    total = num_chains * num_samples
    out = {
        "samples": samples,
        "accept_rate": res.accept_rate.cpu().numpy(),
        "step_size": res.step_size.cpu().numpy(),
        "posterior_mean_log10_eta": float(flat[:, 0].mean()),
        "posterior_mean_log10_rho": float(flat[:, 1].mean()),
        "posterior_std": flat.std(0),
        "samples_per_second": total / wall,
        "wall_seconds": wall,
    }
    if sampler == "nuts":
        out["divergences"] = res.divergences.cpu().numpy()
        out["mean_tree_depth"] = res.mean_tree_depth.cpu().numpy()
    if mesh is not None and mesh.rank:
        # every rank holds the whole result; rank 0 reports and writes it
        verbose, results_path = False, None
    if verbose:
        print(f"{total} samples in {wall:.1f}s "
              f"({out['samples_per_second']:.1f} samples/s); "
              f"accept {out['accept_rate'].mean():.2f}; "
              f"eta* ~ 10^{out['posterior_mean_log10_eta']:.2f}, "
              f"rho* ~ 10^{out['posterior_mean_log10_rho']:.2f}")
    if results_path is not None:
        checkpoint.save_results(out, results_path, verbose=verbose)
        checkpoint.save_hmc_state(res, results_path + ".state")
    return out


def _map_refinement(objective, r_seed, rho_lo, rho_hi=math.inf):
    """The deterministic with-prior argmax of the reference's nu drivers
    (:142-157, :300-315): an 11 x 13 (rho, nu) grid over r_seed +- 0.08
    (within [rho_lo, rho_hi]) x nu in [1, 25], then a 9 x 9 grid of
    +- 0.02 and +- 2 around its argmax. Each grid is one batched
    ``objective`` call of its rows, the same values as a call per point.
    Returns the refined (rho, nu, log_post)."""
    def log_post(rhos, nus):
        rows = np.array([[r, n] for r in rhos for n in nus])
        vals = -objective(torch.as_tensor(rows)).cpu().numpy()
        vals = vals.reshape(len(rhos), len(nus))
        return vals, np.unravel_index(np.argmax(vals), vals.shape)

    rhos = np.linspace(max(r_seed - 0.08, rho_lo), min(r_seed + 0.08, rho_hi),
                       11)
    nus = np.linspace(1.0, 25.0, 13)
    _, (i, j) = log_post(rhos, nus)
    rhos2 = np.linspace(max(rhos[i] - 0.02, rho_lo), rhos[i] + 0.02, 9)
    nus2 = np.linspace(max(nus[j] - 2.0, 1.0), min(nus[j] + 2.0, 25.0), 9)
    vals2, (i2, j2) = log_post(rhos2, nus2)
    return float(rhos2[i2]), float(nus2[j2]), float(vals2[i2, j2])


def main_nu(num_points=30, noise=0.2, num_chains=8, num_samples=400,
            num_warmup=300, num_leapfrog=10, chunk_steps=45,
            results_path=None, verbose=True, *, device="cuda"):
    """The nu posterior at the reference's flagship configuration (n = 900,
    noise 0.2: the data of the golden MAP sweep; reference :85-184), in
    three stages:

    1. the joint (log10 eta, log10 rho, nu) HMC with the golden priors
       (``hmc.sample_posterior_nu``; forward-mode gradients through the
       Bessel K_nu). The reference's finding: the high-eta noise-only
       plateau holds the joint mass (chains settle at log10 eta ~ 3.5);
    2. the eta-profiled (rho, nu) HMC (``hmc.sample_profile_posterior_rho_nu``
       at 15 eta grid points and 12 golden steps): rho concentrates at the
       golden value, the nu marginal is broad (the surface is flat to
       < 0.5 nat along the nu ridge);
    3. the deterministic with-prior argmax refinement, seeded at the
       profiled chains' rho median, on the (rho, nu) search's objective:
       the golden MAP (rho ~ 0.1767, nu ~ 3.034).

    Returns the reference's result dict; writes it only to
    ``results_path``."""
    from .find_optimal_covariance import build_objective
    device = resolve_device(device)
    pts = data_utils.generate_points(num_points, dimension=2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)

    _sync(device)
    t0 = time.perf_counter()
    joint = hmc.sample_posterior_nu(
        pts, z, X, num_chains=num_chains, num_samples=num_samples,
        num_warmup=num_warmup, num_leapfrog=num_leapfrog, key=0,
        log_prior="reference", log10_rho_bounds=(-1.3, -0.3),
        nu_bounds=(1.0, 25.0), chunk_steps=chunk_steps, device=device)
    _sync(device)
    t_joint = time.perf_counter() - t0

    t0 = time.perf_counter()
    prof = hmc.sample_profile_posterior_rho_nu(
        pts, z, X, num_chains=max(num_chains // 2, 2),
        num_samples=num_samples // 2, num_warmup=num_warmup // 2,
        num_leapfrog=max(num_leapfrog // 2, 4), key=0,
        chunk_steps=chunk_steps and max(chunk_steps // 2, 10),
        eta_grid=15, golden_iters=12, device=device)
    _sync(device)
    t_prof = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, objective = build_objective(pts, z, X, with_prior=True, device=device)
    p_flat = prof.samples.cpu().numpy().reshape(-1, 2)
    r_seed = float(10.0 ** np.median(p_flat[:, 0]))
    rho, nu, lp = _map_refinement(objective, r_seed, 0.1)
    _sync(device)
    t_ref = time.perf_counter() - t0

    j_samples = joint.samples.cpu().numpy()
    j_flat = j_samples.reshape(-1, 3)
    out = {
        "joint_samples": j_samples,
        "joint_accept": float(joint.accept_rate.mean()),
        "joint_mean": j_flat.mean(0), "joint_std": j_flat.std(0),
        "profile_samples": prof.samples.cpu().numpy(),
        "profile_accept": float(prof.accept_rate.mean()),
        "profile_rho_median": float(10.0 ** np.median(p_flat[:, 0])),
        "profile_nu_median": float(np.median(p_flat[:, 1])),
        "map_refined": {"rho": rho, "nu": nu, "log_post": lp},
        "golden_map": {"rho": 0.1767, "nu": 3.034},
        "wall_seconds": {"joint": t_joint, "profile": t_prof,
                         "refine": t_ref},
        "config": {"n": pts.shape[0], "noise": noise},
    }
    if verbose:
        print(f"joint: accept {out['joint_accept']:.2f} mean "
              f"{out['joint_mean']}")
        print(f"profile: accept {out['profile_accept']:.2f} rho-median "
              f"{out['profile_rho_median']:.4f} nu-median "
              f"{out['profile_nu_median']:.2f}")
        print(f"refined MAP: rho {rho:.4f} nu {nu:.3f} (golden 0.1767 / "
              f"3.034)")
    if results_path is not None:
        checkpoint.save_results(out, results_path, verbose=verbose)
    return out


def golden_marginals(golden_path):
    """The golden with-prior surface, exp-normalized, as marginal grids
    (reference :187-214). The reference's 61 x 60 (rho, nu) log-posterior
    grid (``OptimalCovariance_WithPrior.pickle``: DecorrelationScale, nu,
    Lp) is the eta-profiled sampler's target density on the same box:
    exponentiate, normalize and marginalize. Returns the rho and nu grids,
    their marginal pmfs, and ``quantile(grid, pmf, qs)``."""
    import pickle

    with open(golden_path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    rho_g = np.asarray(d["DecorrelationScale"], dtype=float)   # (61,)
    nu_g = np.asarray(d["nu"], dtype=float)                    # (60,)
    lp = np.asarray(d["Lp"], dtype=float)                      # (61, 60)
    w = np.exp(lp - lp.max())
    w /= w.sum()

    def quantile(grid, pmf, qs):
        cdf = np.cumsum(pmf)
        cdf /= cdf[-1]
        return np.interp(qs, cdf, grid)

    return {"rho_grid": rho_g, "nu_grid": nu_g, "p_rho": w.sum(axis=1),
            "p_nu": w.sum(axis=0), "quantile": quantile}


def _marginal_validation(rho_samples, nu_samples, gold,
                         qs=(0.25, 0.5, 0.75)):
    """Quantile and binned total-variation agreement of the sampled
    marginals with the exp-normalized golden surface (reference
    :217-243): the sampler is validated by its distribution; the MAP
    belongs to the deterministic refinement."""
    out = {"quantiles": {}}
    for name, s, grid, pmf in (
            ("rho", rho_samples, gold["rho_grid"], gold["p_rho"]),
            ("nu", nu_samples, gold["nu_grid"], gold["p_nu"])):
        gq = gold["quantile"](grid, pmf, qs)
        sq = np.quantile(s, qs)
        out["quantiles"][name] = {
            "golden": [float(v) for v in gq],
            "sampled": [float(v) for v in sq],
            "max_abs_diff": float(np.max(np.abs(gq - sq))),
        }
        # binned TV over 12 equal cells of the golden grid's range
        edges = np.linspace(grid[0], grid[-1], 13)
        cells = np.clip(np.searchsorted(edges, grid) - 1, 0, 11)
        p_g = np.zeros(12)
        np.add.at(p_g, cells, pmf)
        p_s, _ = np.histogram(s, bins=edges)
        p_s = p_s / max(p_s.sum(), 1)
        out[f"tv_{name}"] = float(0.5 * np.abs(p_g / p_g.sum() - p_s).sum())
    return out


# the golden grid's support (reference FindOptimalCovarianceParameters.py
# :664-666), as data/profile_posterior_rho_nu.pickle's config records it
GOLDEN_RHO_BOX, GOLDEN_NU_BOX = (0.1, 0.3), (1.0, 25.0)


def main_profile_rho_nu(num_points=30, noise=0.2, num_chains=4,
                        num_samples=250, num_warmup=150, num_leapfrog=6,
                        chunk_steps=25, golden_path=None, results_path=None,
                        verbose=True, *, device="cuda"):
    """The eta-profiled (rho, nu) sampler at the golden configuration
    (reference :246-355), over the golden grid's box, then the
    deterministic with-prior argmax refinement seeded at the sampled rho
    median, which carries the MAP claim (the nu ridge is flat to < 0.5 nat,
    so the raw nu marginal is broad).

    ``golden_path``: the reference's ``OptimalCovariance_WithPrior.pickle``.
    Given, its grid sets the box and the sampled marginals are validated
    against it (quantiles, binned TV), as the reference does. None (the
    default): that pickle is not in the repository, so the box is its
    grid's support as the committed ``data/profile_posterior_rho_nu.pickle``
    records it (rho in [0.1, 0.3], nu in [1, 25]) and
    ``marginal_validation`` is None. Nothing else is read."""
    from .find_optimal_covariance import build_objective
    device = resolve_device(device)
    pts = data_utils.generate_points(num_points, dimension=2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)

    gold = None if golden_path is None else golden_marginals(golden_path)
    if gold is None:
        (rho_lo, rho_hi), nu_box = GOLDEN_RHO_BOX, GOLDEN_NU_BOX
    else:
        rho_lo, rho_hi = gold["rho_grid"][0], gold["rho_grid"][-1]
        nu_box = (float(gold["nu_grid"][0]), float(gold["nu_grid"][-1]))

    _sync(device)
    t0 = time.perf_counter()
    prof = hmc.sample_profile_posterior_rho_nu(
        pts, z, X, num_chains=num_chains, num_samples=num_samples,
        num_warmup=num_warmup, num_leapfrog=num_leapfrog, key=0,
        log_prior="reference",
        log10_rho_bounds=(float(np.log10(rho_lo)), float(np.log10(rho_hi))),
        nu_bounds=nu_box, chunk_steps=chunk_steps, eta_grid=15,
        golden_iters=12, device=device)
    _sync(device)
    t_prof = time.perf_counter() - t0

    samples = prof.samples.cpu().numpy()             # (S, C, 2)
    flat = samples.reshape(-1, 2)
    rho_s = 10.0 ** flat[:, 0]
    nu_s = flat[:, 1]
    validation = (None if gold is None
                  else _marginal_validation(rho_s, nu_s, gold))
    diag = diagnostics.summarize(samples, names=["log10_rho", "nu"])

    t0 = time.perf_counter()
    _, objective = build_objective(pts, z, X, with_prior=True, device=device)
    rho, nu, lp = _map_refinement(objective, float(np.median(rho_s)), rho_lo,
                                  rho_hi)
    _sync(device)
    t_ref = time.perf_counter() - t0

    out = {
        "samples": samples,
        "accept_rate": prof.accept_rate.cpu().numpy(),
        "diagnostics": diag,
        "marginal_validation": validation,
        "rho_median": float(np.median(rho_s)),
        "nu_median": float(np.median(nu_s)),
        "map_refined": {"rho": rho, "nu": nu, "log_post": lp,
                        "method": "sampler-seeded deterministic "
                                  "with-prior argmax (f64 spectral)"},
        "golden_map": {"rho": 0.1767, "nu": 3.034, "log_post": 957.779},
        "wall_seconds": {"sample": t_prof, "refine": t_ref},
        "config": {"n": pts.shape[0], "noise": noise,
                   "chains": num_chains, "samples": num_samples,
                   "warmup": num_warmup, "leapfrog": num_leapfrog,
                   "target": "eta-profiled",
                   "priors": "reference inverse-square",
                   "rho_box": (float(rho_lo), float(rho_hi)),
                   "nu_box": nu_box},
    }
    if verbose:
        print(f"profiled sampler: accept "
              f"{out['accept_rate'].mean():.2f}, "
              f"{num_chains}x{num_samples} in {t_prof:.0f}s")
        for name in ("log10_rho", "nu"):
            d = diag[name]
            print(f"  {name}: mean {d['mean']:.3f} rhat {d['rhat']:.3f} "
                  f"ess {d['ess']:.0f}")
        for name in ("rho", "nu") if validation else ():
            q = validation["quantiles"][name]
            print(f"  {name} quantiles golden {q['golden']} vs sampled "
                  f"{q['sampled']} (max diff {q['max_abs_diff']:.3f}); "
                  f"TV {validation['tv_' + name]:.3f}")
        print(f"refined MAP: rho {rho:.4f} nu {nu:.3f} (golden 0.1767 / "
              f"3.034)")
    if results_path is not None:
        checkpoint.save_results(out, results_path, verbose=verbose)
    return out


def main_rho_nu_large(side=317, noise=0.2, num_chains=64,
                      num_samples=200, num_warmup=150,
                      num_rho_nodes=9, num_nu_nodes=9,
                      lanczos_steps=48, num_probes=16,
                      log10_rho_bounds=(-1.2, -0.3),
                      nu_bounds=(1.0, 25.0),
                      log10_eta_bounds=(0.5, 4.0),
                      probe_points=((1.6, -0.55, 2.0),
                                    (1.9, -0.75, 6.0),
                                    (1.3, -0.45, 14.0),
                                    (0.8, -0.35, 20.0),
                                    (2.5, -1.1, 1.2)),
                      node_dtype=None, results_path=None, verbose=True, *,
                      device="cuda"):
    """The full (eta, rho, nu) posterior at n = side^2 (reference
    :358-484): ``KrylovPosteriorSurfaceRhoNu`` amortizes the O(n log n)
    work into its construction, then HMC with the golden priors runs at a
    cost that does not grow with n. At ``probe_points`` (log10 eta,
    log10 rho, nu; off the nodes) the surface is checked against a fresh
    FFT engine factorized at that (rho, nu) with independent probes (key
    7). The sampler runs twice, cold and warm, as the reference times it.
    Returns the reference's result dict, with split R-hat and ESS of every
    coordinate."""
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    pts = data_utils.generate_points(side, dimension=2)
    n = pts.shape[0]
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)

    _sync(device)
    t0 = time.perf_counter()
    surface = KrylovPosteriorSurfaceRhoNu(
        pts, z, X, log10_rho_bounds=log10_rho_bounds, nu_bounds=nu_bounds,
        num_rho_nodes=num_rho_nodes, num_nu_nodes=num_nu_nodes,
        lanczos_steps=lanczos_steps, num_probes=num_probes, key=0,
        dtype=dtype, node_dtype=node_dtype, verbose=verbose, device=device)
    _sync(device)
    t_surface = time.perf_counter() - t0

    probes_out = []
    t0 = time.perf_counter()
    for le, lr, nu in probe_points:
        eng = KrylovProfileLikelihood(
            operators.GridMaternOperator(pts, 10.0 ** lr, nu=nu,
                                         device=device, dtype=dtype),
            X, z, lanczos_steps=lanczos_steps, num_probes=num_probes,
            key=7, device=device, dtype=dtype)
        eta = 10.0 ** le
        lp_ref = float(eng.log_likelihood(eng.find_optimal_sigma(eta), eta))
        lp_surf = float(surface.profile_loglik(le, lr, nu))
        probes_out.append({"log10_eta": le, "log10_rho": lr, "nu": nu,
                           "lp_surface": lp_surf, "lp_exact_engine": lp_ref,
                           "diff": lp_surf - lp_ref})
        if verbose:
            print(f"probe (10^{le}, 10^{lr}, nu={nu}): surface "
                  f"{lp_surf:.3f} vs exact-engine {lp_ref:.3f} "
                  f"(diff {lp_surf - lp_ref:+.3f})")
    t_probes = time.perf_counter() - t0

    def sample():
        _sync(device)
        t0 = time.perf_counter()
        res, _ = hmc.sample_posterior_rho_nu_large(
            pts, z, X, surface=surface, num_chains=num_chains,
            num_samples=num_samples, num_warmup=num_warmup,
            log10_eta_bounds=log10_eta_bounds, log_prior="reference", key=0)
        _sync(device)
        return res, time.perf_counter() - t0

    _, t_cold = sample()
    res, t_sample = sample()

    samples = res.samples.cpu().numpy()              # (S, C, 3)
    diag = diagnostics.summarize(
        samples, names=["log10_eta", "log10_rho", "nu"])
    out = {
        "samples": samples,
        "accept_rate": res.accept_rate.cpu().numpy(),
        "diagnostics": diag,
        "probe_validation": probes_out,
        "samples_per_second": num_chains * num_samples / t_sample,
        "wall_seconds": {"surface": t_surface, "probes": t_probes,
                         "sample_warm": t_sample, "sample_cold": t_cold},
        "config": {"n": n, "side": side, "noise": noise,
                   "num_chains": num_chains, "num_samples": num_samples,
                   "num_warmup": num_warmup,
                   "num_rho_nodes": num_rho_nodes,
                   "num_nu_nodes": num_nu_nodes,
                   "lanczos_steps": lanczos_steps,
                   "num_probes": num_probes,
                   "node_dtype": str(node_dtype or dtype),
                   "log10_rho_bounds": tuple(log10_rho_bounds),
                   "nu_bounds": tuple(nu_bounds),
                   "log10_eta_bounds": tuple(log10_eta_bounds)},
    }
    if verbose:
        print(f"n={n}: surface {t_surface:.1f}s, "
              f"{out['samples_per_second']:.1f} samples/s warm "
              f"({num_chains} chains x {num_samples});")
        for name in ("log10_eta", "log10_rho", "nu"):
            d = diag[name]
            print(f"  {name}: mean {d['mean']:.3f} sd {d['std']:.3f} "
                  f"rhat {d['rhat']:.3f} ess {d['ess']:.0f}")
    if results_path is not None:
        checkpoint.save_results(out, results_path, verbose=verbose)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=30)
    p.add_argument("--num-chains", type=int, default=8)
    p.add_argument("--num-samples", type=int, default=500)
    p.add_argument("--sampler", choices=("hmc", "nuts"), default="hmc")
    p.add_argument("--nu", action="store_true",
                   help="the full (eta, rho, nu) posterior at the golden "
                        "configuration, then the MAP refinement")
    p.add_argument("--rho-nu-large", action="store_true",
                   help="(eta, rho, nu) posterior at n ~ 100k on the "
                        "tensor-node FFT surface (grid data)")
    p.add_argument("--profile-rho-nu", action="store_true",
                   help="the eta-profiled (rho, nu) sampler at the golden "
                        "configuration, then the MAP refinement")
    p.add_argument("--golden-path", default=None,
                   help="with --profile-rho-nu: the reference's "
                        "OptimalCovariance_WithPrior.pickle, to validate "
                        "the sampled marginals against")
    p.add_argument("--f64-nodes", action="store_true",
                   help="with --rho-nu-large: float64 node factorizations "
                        "on the card (8 x 8 nodes, 12 probes, the eta box "
                        "from -0.5)")
    p.add_argument("--results-path", default=None)
    a = p.parse_args()
    if a.rho_nu_large:
        kw = {}
        if a.f64_nodes:
            kw = dict(node_dtype=torch.float64, num_rho_nodes=8,
                      num_nu_nodes=8, num_probes=12,
                      log10_eta_bounds=(-0.5, 4.0))
        main_rho_nu_large(num_chains=a.num_chains,
                          num_samples=a.num_samples,
                          results_path=a.results_path, **kw)
    elif a.profile_rho_nu:
        main_profile_rho_nu(a.num_points, num_chains=a.num_chains,
                            num_samples=a.num_samples,
                            golden_path=a.golden_path,
                            results_path=a.results_path)
    elif a.nu:
        main_nu(a.num_points, num_chains=a.num_chains,
                num_samples=a.num_samples, results_path=a.results_path)
    else:
        main(a.num_points, num_chains=a.num_chains,
             num_samples=a.num_samples, sampler=a.sampler,
             results_path=a.results_path)
