"""Posterior sampling driver: HMC chains over (log10 eta, log10 rho), and
over (log10 eta, log10 rho, nu) at n ~ 10^5 on the FFT surface.

Counterpart of the reference's ``drivers/sample_posterior.py`` (BASELINE
config 5):

* :func:`main`: HMC over (log10 eta, log10 rho) on the dense profile
  likelihood (a Cholesky factorization per gradient), the uniform priors
  of the reference's driver, sampling in sigmoid coordinates over their
  box;
* :func:`main_rho_nu_large`: the (eta, rho, nu) posterior at grid side
  317 (n = 100,489) on ``KrylovPosteriorSurfaceRhoNu``, with the
  reference's probe cross-validation against independent FFT engines and
  split R-hat and ESS of every coordinate.

    python -m gppe_tpu_torch.drivers.sample_posterior [--rho-nu-large]

runs on the card (``device="cpu"`` for a rehearsal: float64 there, the
surface's Lanczos passes float32 on the card) and writes a file only when
given ``results_path``. Every time ends with a device synchronise. Not
ported yet, and refused with the ROADMAP item that brings them: NUTS
(``sampler="nuts"``), :func:`main_nu` (``--nu``) and
:func:`main_profile_rho_nu` (``--profile-rho-nu``), A12b; sharding the
chains over devices, A14. The reference's ``golden_marginals`` reads the
reference's own data directory and has no counterpart.
"""

import argparse
import time

import numpy as np
import torch

from ..models import diagnostics, hmc, priors
from ..models.krylov_posterior import KrylovPosteriorSurfaceRhoNu
from ..models.large_scale import KrylovProfileLikelihood
from ..ops import operators
from ..utils import checkpoint
from ..utils import data as data_utils
from ..utils.config import resolve_device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refuse(what):
    raise NotImplementedError(
        f"sample_posterior.{what}: NUTS and the nu samplers' drivers come "
        f"with ROADMAP A12b")


def main(num_points=30, noise=0.2, num_chains=8, num_samples=500,
         num_warmup=400, use_mesh=True, sampler="hmc", results_path=None,
         verbose=True, *, device="cuda"):
    """HMC over (log10 eta, log10 rho) at n = num_points^2 grid points,
    nu = 1/2, uniform priors eta in (1e-3, 1e4), rho in (0.02, 0.6)
    (reference :17-82). With ``results_path`` it writes the results and,
    beside them at ``results_path + ".state"``, the chains' state. The
    chains run as one batch on ``device``; ``use_mesh`` shards nothing
    (ROADMAP A14) and is refused where it would, with more than one card."""
    if sampler == "nuts":
        _refuse("main(sampler='nuts')")
    if sampler != "hmc":
        raise ValueError(f"sampler must be 'hmc' or 'nuts', got {sampler!r}")
    device = resolve_device(device)
    if (use_mesh and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise ValueError("use_mesh: sharding chains over devices is not "
                         "ported yet (ROADMAP A14); pass use_mesh=False")

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
    res = hmc.sample_posterior(
        pts, z, X, nu=0.5, num_chains=num_chains, num_samples=num_samples,
        num_warmup=num_warmup, key=0, log_prior=log_prior,
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


def main_nu(*args, **kwargs):
    """The joint and eta-profiled nu samplers at the golden configuration
    (reference :85-184): not ported yet (ROADMAP A12b)."""
    _refuse("main_nu")


def main_profile_rho_nu(*args, **kwargs):
    """The eta-profiled (rho, nu) sampler with distributional validation
    (reference :246-355): not ported yet (ROADMAP A12b)."""
    _refuse("main_profile_rho_nu")


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
                        "configuration (ROADMAP A12b: refused)")
    p.add_argument("--rho-nu-large", action="store_true",
                   help="(eta, rho, nu) posterior at n ~ 100k on the "
                        "tensor-node FFT surface (grid data)")
    p.add_argument("--profile-rho-nu", action="store_true",
                   help="the eta-profiled (rho, nu) sampler (ROADMAP "
                        "A12b: refused)")
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
        main_profile_rho_nu()
    elif a.nu:
        main_nu()
    else:
        main(a.num_points, num_chains=a.num_chains,
             num_samples=a.num_samples, sampler=a.sampler,
             results_path=a.results_path)
