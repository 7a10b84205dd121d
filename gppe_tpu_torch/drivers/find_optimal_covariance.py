"""Optimal kernel-parameter search over (rho, nu): grid, MAP, global
optimizer.

Counterpart of the reference's ``drivers/find_optimal_covariance.py``
(itself a port of reference examples/FindOptimalCovarianceParameters.py:
278-754). ``main`` evaluates the profile likelihood lp(rho, nu) over a
(rho, nu) grid and maximizes it with differential evolution; ``main_large``
runs the (rho, nu) grid at n = 10^4 through the grid-batched Krylov engine,
matrix-free, so every product and trace runs the general-nu kernel
``csrc/matern_general.cu``.

Each lp(rho, nu) assembles K (on the card the general-nu kernel's assembly
entry, one launch for a chunk of points, float32 k widened to float64),
takes its float64 eigendecomposition on the card - the
reference ran that step on the host CPU on a TPU (``spectral_on_host``) -
and maximizes over eta on a 29-point log grid plus 25 golden-section
steps, in float64, for a whole chunk of (rho, nu) points at once. A
generation of differential evolution is one such chunk.

    python -m gppe_tpu_torch.drivers.find_optimal_covariance [--large]

``main_fft_grid`` runs the (rho, nu) MAP sweep at n = 2^20 grid points
through the exact FFT grid operator (``ops.operators.GridMaternOperator``:
cuFFT products, its general-nu offset tables on the general-nu kernel's
elementwise entry), one ``KrylovProfileLikelihood`` fit a point.

    python -m gppe_tpu_torch.drivers.find_optimal_covariance [--large | --fft-grid]

runs on the card (``device="cpu"`` for a rehearsal) and writes a file only
when given ``results_path``; ``main(plot=True)`` draws the (rho, nu)
surface's smoothed contour with the DE optimum
(:func:`gppe_tpu_torch.utils.plot.plot_contour_grid`).
"""

import argparse
import math
import time

import numpy as np
import torch

from ..models import direct_likelihood
from ..models.grid_krylov import GridKrylovProfileLikelihood
from ..models.large_scale import KrylovProfileLikelihood
from ..models.priors import inverse_square_log_prior, uniform_log_prior
from ..ops import assembly
from ..ops.global_opt import differential_evolution
from ..ops.operators import GridMaternOperator
from ..utils import checkpoint
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup

# the inner eta search of lp (reference :45-67): a log10 grid, then golden
# steps inside the grid cells either side of its best point
ETA_GRID = (-4.0, 3.0, 29)
GOLDEN_STEPS = 25
_GOLDEN = 0.5 * (math.sqrt(5.0) - 1.0)
# bytes of float64 K per chunk of (rho, nu) points in one batched eigh
CHUNK_BYTES = 1 << 30


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flat(a):
    return np.atleast_1d(np.asarray(a, dtype=np.float64))


def build_objective(pts, z, X, with_prior, *, device="cuda"):
    """``(lp, objective)`` of the (rho, nu) search on ``pts``, ``z``, ``X``.

    ``lp(rho, nu)``: the profile log-likelihood maximized over (sigma, eta)
    - analytically in sigma, by the eta grid and golden steps in eta -
    without the (n - m)/2 log(2 pi) constant (the reference's surface);
    ``rho`` and ``nu`` numbers (a float back) or equal-length arrays (an
    array back), evaluated as many points at a time as CHUNK_BYTES of
    float64 K hold. ``objective(params)``: the negative log posterior of a
    (P, 2) tensor of (rho, nu) rows, one batched lp; with ``with_prior``
    the reference's uniform supports and inverse-square priors (:119-146).
    ``objective.four_param`` the same of (P, 4) rows (rho, nu, sigma,
    sigma0) over ``objective.lp4``, the full direct log-likelihood (the
    reference's 4-parameter mode, :148-199).

    ``device``: where K is assembled (float32 on the card, float64 on the
    CPU); the eigendecomposition and everything after it are float64 on
    ``device``, but for lp4's host float64 likelihood."""
    setup()
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    pts_t = torch.as_tensor(np.asarray(pts), dtype=dtype, device=device)
    X64 = torch.as_tensor(np.asarray(X), dtype=torch.float64, device=device)
    z64 = torch.as_tensor(np.asarray(z), dtype=torch.float64, device=device)
    n, m = X64.shape
    chunk = max(1, CHUNK_BYTES // (8 * n * n))
    grid = torch.linspace(*ETA_GRID, dtype=torch.float64, device=device)

    def spectra(rhos, nus):
        """(lam (B, n), Xt (B, n, m), zt (B, n)) of the points' K, the
        chunk's general nus in one assembly launch, straight to float64."""
        K = assembly.correlations_of_points(pts_t, rhos, nus,
                                            out_dtype=torch.float64)
        lam, Q = torch.linalg.eigh(K)
        del K
        Qt = Q.transpose(1, 2)
        return (torch.clamp(lam, min=0.0), Qt @ X64,
                (Qt @ z64[:, None])[..., 0])

    def neg_prof(lam, Xt, zt, log10_eta):
        """-lp at (B, E) log10 etas, analytic in sigma."""
        eta = torch.pow(10.0, log10_eta)                     # (B, E)
        D = 1.0 / (lam[:, None, :] + eta[..., None])         # (B, E, n)
        Yt = D[..., None] * Xt[:, None]                      # (B, E, n, m)
        B = Xt[:, None].transpose(-1, -2) @ Yt               # (B, E, m, m)
        LB = torch.linalg.cholesky(0.5 * (B + B.transpose(-1, -2)))
        logdet_B = 2.0 * torch.sum(
            torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), dim=-1)
        rhs = (Yt.transpose(-1, -2) @ zt[:, None, :, None])  # (B, E, m, 1)
        c = torch.cholesky_solve(rhs, LB)
        zMz = (torch.sum(zt[:, None, :] ** 2 * D, dim=-1)
               - (rhs * c).sum(dim=(-2, -1)))
        sigma2 = zMz / (n - m)
        logdet_Kn = torch.sum(torch.log(lam[:, None, :] + eta[..., None]),
                              dim=-1)
        return -(-0.5 * (n - m) * torch.log(sigma2) - 0.5 * logdet_Kn
                 - 0.5 * logdet_B - 0.5 * (n - m))

    def lp_chunk(rhos, nus):
        lam, Xt, zt = spectra(rhos, nus)
        vals = neg_prof(lam, Xt, zt, grid[None, :].expand(len(rhos), -1))
        i0 = torch.argmin(vals, dim=1)
        lo = grid[torch.clamp(i0 - 1, min=0)]
        hi = grid[torch.clamp(i0 + 1, max=grid.numel() - 1)]
        for _ in range(GOLDEN_STEPS):
            x1 = hi - _GOLDEN * (hi - lo)
            x2 = lo + _GOLDEN * (hi - lo)
            f = neg_prof(lam, Xt, zt, torch.stack([x1, x2], dim=1))
            left = f[:, 0] < f[:, 1]
            lo = torch.where(left, lo, x1)
            hi = torch.where(left, x2, hi)
        return -neg_prof(lam, Xt, zt, (0.5 * (lo + hi))[:, None])[:, 0]

    def lp_tensor(rhos, nus):
        """lp of equal-length float sequences, float64 on ``device``; NaN
        where rho or nu is not positive (no Matern K)."""
        out = torch.full((len(rhos),), math.nan, dtype=torch.float64,
                         device=device)
        ok = [i for i in range(len(rhos)) if rhos[i] > 0 and nus[i] > 0]
        for s in range(0, len(ok), chunk):
            idx = ok[s:s + chunk]
            out[idx] = lp_chunk([rhos[i] for i in idx], [nus[i] for i in idx])
        return out

    def lp(rho, nu):
        """The profile log-likelihood at (rho, nu), numbers or arrays."""
        scalar = np.ndim(rho) == 0 and np.ndim(nu) == 0
        rhos, nus = np.broadcast_arrays(_flat(rho), _flat(nu))
        vals = lp_tensor(rhos.tolist(), nus.tolist()).cpu().numpy()
        return float(vals[0]) if scalar else vals

    def lp4(rho, nu, sigma, sigma0):
        """The full direct log-likelihood at explicit (sigma, sigma0)
        (reference :148-199): host float64, as the port's likelihoods."""
        lam, Xt, zt = (a[0].cpu() for a in spectra([float(rho)],
                                                   [float(nu)]))
        sd = direct_likelihood.SpectralData(lam=lam, Xt=Xt, zt=zt)
        return float(direct_likelihood.log_likelihood(sd, float(sigma),
                                                      float(sigma0)))

    def support(rho, nu):
        """The uniform priors' supports (reference :119-125)."""
        return (uniform_log_prior(rho, (1e-3, math.inf))
                + uniform_log_prior(nu, (1e-2, 25.0)))

    def objective(params):
        """Negative log posterior of (P, 2) rows (rho, nu)."""
        params = torch.as_tensor(params, dtype=torch.float64).reshape(-1, 2)
        rho, nu = params[:, 0].cpu(), params[:, 1].cpu()
        val = lp_tensor(rho.tolist(), nu.tolist()).cpu()
        if with_prior:
            # the golden OptimalCovariance_WithPrior.pickle: the
            # inverse-square priors (reference :128-130) on the supports
            val = (val + support(rho, nu) + inverse_square_log_prior(rho)
                   + inverse_square_log_prior(nu, scale=25.0))
        return -val.to(params.device)

    def objective4(params):
        """Negative log posterior of (P, 4) rows (rho, nu, sigma, sigma0):
        uniform supports only, as the reference's 4-parameter mode."""
        params = torch.as_tensor(params, dtype=torch.float64).reshape(-1, 4)
        rows = params.cpu()
        prior = (support(rows[:, 0], rows[:, 1])
                 + uniform_log_prior(rows[:, 2], (0.0, math.inf))
                 + uniform_log_prior(rows[:, 3], (0.0, math.inf)))
        val = torch.full_like(prior, -math.inf)
        for i in torch.nonzero(torch.isfinite(prior))[:, 0].tolist():
            val[i] = lp4(*rows[i].tolist())
        return -(val + prior).to(params.device)

    objective.four_param = objective4
    objective.lp4 = lp4
    objective.device = device
    return lp, objective


def main(num_points=30, noise=0.05, with_prior=False, grid_rho=25,
         grid_nu=24, results_path=None, use_saved=False, verbose=True,
         run_de=True, four_param=False, plot=False, *, device="cuda",
         popsize=24, max_generations=40):
    """The (rho, nu) surface on a ``grid_rho`` x ``grid_nu`` grid (the
    reference's 61 x 60 grid, :664-666, sized by arguments), its argmax,
    and (``run_de``) differential evolution over [0.1, 0.3] x [1, 25]
    (seed 31, ``popsize``, ``max_generations``, tol 1e-5); with
    ``four_param`` also the direct 4-parameter search (popsize 32, at most
    60 generations, as the reference's). Returns the
    reference's result dict; ``plot`` draws the surface's smoothed contour
    (reference :265-276) into optimal_covariance_{with,without}_prior.svg
    in the working directory."""
    device = resolve_device(device)

    def compute():
        pts = data_utils.generate_points(num_points, dimension=2)
        z = data_utils.generate_data(pts, noise)
        X = data_utils.generate_basis_functions(pts, polynomial_degree=2)
        lp, objective = build_objective(pts, z, X, with_prior,
                                        device=device)
        rhos = np.linspace(0.1, 0.3, grid_rho)
        nus = np.linspace(1.0, 25.0, grid_nu)
        R, N = np.meshgrid(rhos, nus, indexing="ij")
        Lp = lp(R.ravel(), N.ravel()).reshape(grid_rho, grid_nu)
        if with_prior:
            # the log posterior, like the golden (reference :119-146); the
            # grid lies inside the uniform supports
            Lp = (Lp - 2.0 * np.log1p(rhos)[:, None]
                  - 2.0 * np.log1p(nus / 25.0)[None, :])
        i, j = np.unravel_index(np.nanargmax(Lp), Lp.shape)
        out = {"rhos": rhos, "nus": nus, "Lp": Lp,
               "max_lp": float(Lp[i, j]), "optimal_rho": float(rhos[i]),
               "optimal_nu": float(nus[j])}
        if verbose:
            print(f"grid optimum: Lp={out['max_lp']:.3f} at "
                  f"rho={out['optimal_rho']:.4f} nu={out['optimal_nu']:.3f}")
        if run_de:
            res = differential_evolution(
                objective, torch.tensor([[0.1, 0.3], [1.0, 25.0]],
                                        dtype=torch.float64, device=device),
                generator=31, popsize=popsize,
                max_generations=max_generations, tol=1e-5)
            out["de_rho"] = float(res.x[0])
            out["de_nu"] = float(res.x[1])
            out["de_lp"] = -float(res.fun)
            out["de_generations"] = int(res.num_generations)
            if verbose:
                print(f"DE optimum: Lp={out['de_lp']:.3f} at "
                      f"rho={out['de_rho']:.4f} nu={out['de_nu']:.3f} "
                      f"({out['de_generations']} generations)")
        if four_param:
            res4 = differential_evolution(
                objective.four_param,
                torch.tensor([[0.05, 0.3], [1.0, 25.0], [1e-3, 2.0],
                              [1e-3, 2.0]], dtype=torch.float64,
                             device=device),
                generator=31, popsize=32, max_generations=60, tol=1e-5)
            for k, v in zip(("rho", "nu", "sigma", "sigma0"), res4.x):
                out[f"de4_{k}"] = float(v)
            out["de4_lp"] = -float(res4.fun)
            if verbose:
                print(f"4-param DE optimum: Lp={out['de4_lp']:.3f} at "
                      f"rho={out['de4_rho']:.4f} nu={out['de4_nu']:.3f} "
                      f"sigma={out['de4_sigma']:.4f} "
                      f"sigma0={out['de4_sigma0']:.4f}")
        return out

    out = checkpoint.run_or_resume(results_path, compute,
                                   use_saved=use_saved, verbose=verbose)
    if plot:
        # the smoothed, upsampled contour of the (rho, nu) surface
        # (reference FindOptimalCovarianceParameters.py:475-626), marking
        # the DE optimum where DE ran (it maximizes the same objective)
        from ..utils.plot import plot_contour_grid
        tag = "with" if with_prior else "without"
        plot_contour_grid(
            out["rhos"], out["nus"], out["Lp"], r"$\rho$", r"$\nu$",
            optimum=(out.get("de_rho", out["optimal_rho"]),
                     out.get("de_nu", out["optimal_nu"])),
            filename=f"optimal_covariance_{tag}_prior",
            title="log posterior" if with_prior else "log likelihood")
    return out


def large_problem(n=10_000, noise=0.1):
    """``(pts, z, X)`` of :func:`main_large`: n uniform random 2-D points
    (RandomState(31)), the reference's data and degree-2 basis."""
    pts = np.random.RandomState(31).rand(n, 2)
    return (pts, data_utils.generate_data(pts, noise),
            data_utils.generate_basis_functions(pts, 2))


def main_large(n=10_000, noise=0.1, grid_rho=8, grid_nu=8,
               lanczos_steps=40, num_probes=8, verbose=True,
               results_path=None, use_saved=False, *, device="cuda"):
    """The (rho, nu) grid at large n through the grid-batched Krylov engine
    (one Lanczos pass per chunk of kernels instead of a fresh O(n^3)
    factorization per point; reference :281-339): n uniform random 2-D
    points (RandomState(31), :func:`large_problem`), rhos in
    linspace(0.1, 0.3, grid_rho) x nus in linspace(1, 25, grid_nu). Above
    n = 8192 the engine is matrix-free: each Lanczos step's products of a
    chunk of points are one batched call of the general-nu kernel (a
    launch per band of its walk), each point's trace one launch. Reports
    the setup and fit seconds (the setup ended by a device synchronise),
    the amortized seconds per point and the argmax."""
    device = resolve_device(device)

    def compute():
        pts, z, X = large_problem(n, noise)
        rhos = np.linspace(0.1, 0.3, grid_rho)
        nus = np.linspace(1.0, 25.0, grid_nu)
        R, N = np.meshgrid(rhos, nus, indexing="ij")

        _sync(device)
        t0 = time.perf_counter()
        grid = GridKrylovProfileLikelihood(
            pts, X, z, R.ravel(), N.ravel(), lanczos_steps=lanczos_steps,
            num_probes=num_probes, verbose=verbose, device=device)
        _sync(device)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = grid.fit_all()
        fit_s = time.perf_counter() - t0

        Lp = np.array([r["lp"] for r in res]).reshape(grid_rho, grid_nu)
        i, j = np.unravel_index(np.nanargmax(Lp), Lp.shape)
        out = {"n": n, "rhos": rhos, "nus": nus, "Lp": Lp, "results": res,
               "optimal_rho": float(rhos[i]), "optimal_nu": float(nus[j]),
               "max_lp": float(Lp[i, j]), "setup_seconds": setup_s,
               "fit_seconds": fit_s,
               "seconds_per_point": (setup_s + fit_s) / (grid_rho * grid_nu),
               "matrix_free": grid.matrix_free, "chunk": grid.chunk}
        if verbose:
            print(f"large grid: {grid_rho}x{grid_nu} points at n={n} in "
                  f"{setup_s:.1f}s setup + {fit_s:.1f}s fits = "
                  f"{out['seconds_per_point']:.2f} s/point amortized")
            print(f"optimum: Lp={out['max_lp']:.3f} at "
                  f"rho={out['optimal_rho']:.4f} nu={out['optimal_nu']:.3f}")
        return out

    return checkpoint.run_or_resume(results_path, compute,
                                    use_saved=use_saved, verbose=verbose)


def main_fft_grid(side=1024, noise=0.2, rhos=None, nus=None,
                  lanczos_steps=48, num_probes=16, with_prior=True,
                  verbose=True, results_path=None, use_saved=False, *,
                  device="cuda"):
    """The (rho, nu) MAP sweep at n = side^2 through the exact FFT grid
    operator, general nu included (reference :342-415): the reference's
    grid points (``generate_points(side)``), rhos ``geomspace(0.003, 0.03,
    5)`` x nus (0.5, 1, 2, 4, 8) by default; each point one
    ``GridMaternOperator`` (its general-nu offset table on the general-nu
    kernel's elementwise entry, its products on cuFFT) and one
    ``KrylovProfileLikelihood`` fit, lp at the optimum plus, with
    ``with_prior``, the inverse-square priors on rho and nu / 25. Float32
    on the card, float64 on the CPU (as :func:`build_objective`). Each
    row's seconds end with a device synchronise. Returns the reference's
    result dict."""
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    rhos = np.geomspace(0.003, 0.03, 5) if rhos is None else rhos
    nus = np.asarray([0.5, 1.0, 2.0, 4.0, 8.0]) if nus is None else nus

    def compute():
        pts = data_utils.generate_points(side, dimension=2)
        n = pts.shape[0]
        z = data_utils.generate_data(pts, noise)
        X = data_utils.generate_basis_functions(pts, 2)
        rows = []
        _sync(device)
        t_all = time.perf_counter()
        for rho in rhos:
            for nu in nus:
                t0 = time.perf_counter()
                op = GridMaternOperator(pts, float(rho), nu=float(nu),
                                        device=device, dtype=dtype)
                eng = KrylovProfileLikelihood(
                    op, X, z, lanczos_steps=lanczos_steps,
                    num_probes=num_probes, device=device, dtype=dtype)
                r = eng.fit()
                lp = (eng.log_likelihood(r["sigma"], r["eta"])
                      if np.isfinite(r["eta"]) and r["sigma"] > 0
                      else -np.inf)
                if with_prior and np.isfinite(lp):
                    lp += float(inverse_square_log_prior(float(rho)))
                    lp += float(inverse_square_log_prior(float(nu),
                                                         scale=25.0))
                _sync(device)
                secs = time.perf_counter() - t0
                rows.append({"rho": float(rho), "nu": float(nu),
                             "lp": float(lp), "seconds": secs, **r})
                if verbose:
                    print(f"  rho={rho:.4g} nu={nu:.3g}: lp={lp:.2f} "
                          f"eta={r['eta']:.4g} ({secs:.1f}s)", flush=True)
        total = time.perf_counter() - t_all
        best = max(rows, key=lambda r: r["lp"])
        out = {"n": n, "rhos": np.asarray(rhos), "nus": np.asarray(nus),
               "rows": rows, "optimal_rho": best["rho"],
               "optimal_nu": best["nu"], "max_lp": best["lp"],
               "total_seconds": total,
               "seconds_per_point": total / len(rows),
               "with_prior": bool(with_prior)}
        if verbose:
            print(f"fft grid: {len(rows)} exact fits at n={n} in "
                  f"{total:.0f}s ({out['seconds_per_point']:.1f} s/point); "
                  f"MAP rho={best['rho']:.4g} nu={best['nu']:.3g} "
                  f"lp={best['lp']:.2f}")
        return out

    return checkpoint.run_or_resume(results_path, compute,
                                    use_saved=use_saved, verbose=verbose)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=30)
    p.add_argument("--noise", type=float, default=0.05)
    p.add_argument("--with-prior", action="store_true")
    p.add_argument("--use-saved", action="store_true")
    p.add_argument("--results-path", default=None)
    p.add_argument("--four-param", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--large", action="store_true")
    p.add_argument("--large-n", type=int, default=10_000)
    p.add_argument("--grid", type=int, default=8,
                   help="grid_rho = grid_nu for --large")
    p.add_argument("--fft-grid", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    if a.fft_grid:
        main_fft_grid(results_path=a.results_path, use_saved=a.use_saved,
                      device=a.device)
    elif a.large:
        main_large(n=a.large_n, grid_rho=a.grid, grid_nu=a.grid,
                   results_path=a.results_path, use_saved=a.use_saved,
                   device=a.device)
    else:
        main(a.num_points, a.noise, a.with_prior,
             results_path=a.results_path, use_saved=a.use_saved,
             four_param=a.four_param, plot=a.plot, device=a.device)
