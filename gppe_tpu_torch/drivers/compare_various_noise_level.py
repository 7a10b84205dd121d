"""Noise-level sweep (BASELINE config 4).

Counterpart of the reference's ``drivers/compare_various_noise_level.py``
(itself a port of reference examples/CompareVariousNoiseLevel.py:
132-196): for each of four basis families and each of 200 noise
magnitudes in logspace(-2, 1), estimate (sigma, sigma0, eta) by the
derivative method, and the noise by GCV. The reference's original farms
the levels to a process pool; here all levels of a family share one K:

* one K assembled on ``device`` (float32 on the card, float64 on the CPU)
  and one float64 eigendecomposition of it there (``MixedCorrelation``);
* the whole (n, L) batch of data vectors rotated in one product;
* the L root problems one vectorised Chandrupatla over d lp / d eta, a
  ``torch.func.vmap`` over (log eta, rotated data) on the float64 host
  data, bracketed on log10 eta in [-4, 3]; a lane without a sign change
  takes the boundary its sign points to (eta = inf where d lp / d eta > 0
  at the top, else 0), as the reference's rule;
* GCV one ``models.gcv.minimize_gcv`` a level.

    python -m gppe_tpu_torch.drivers.compare_various_noise_level

runs on the card (``device="cpu"`` for a rehearsal) and writes a file only
when given ``results_path``.
"""

import argparse

import numpy as np
import torch

from ..models import direct_likelihood as dl
from ..models import gcv as gcv_mod
from ..models import profile_likelihood as pl_mod
from ..models.mixed_correlation import MixedCorrelation
from ..ops import assembly, root_finding
from ..utils import checkpoint
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup

# the reference's four basis families (CompareVariousNoiseLevel.py:132-196)
FAMILIES = (("poly0", dict(polynomial_degree=0)),
            ("poly1", dict(polynomial_degree=1)),
            ("poly2", dict(polynomial_degree=2)),
            ("poly2trig", dict(polynomial_degree=2, trigonometric=True)))
LOG_ETA_BRACKET = (-4.0, 3.0)


def _batched(fn, lam, Xt):
    """fn(SpectralData(lam, Xt, zt), x) over lanes of (x, zt)."""
    return torch.func.vmap(
        lambda x, zt: fn(dl.SpectralData(lam=lam, Xt=Xt, zt=zt), x))


def sweep(pts, X, noise_levels, nu=0.5, scale=0.1, seed=31, *,
          device="cuda"):
    """Estimates at every noise level for one basis ``X``: a dict of
    float64 arrays ``noise_levels``, ``eta``, ``sigma``, ``sigma0``,
    ``gcv_sigma0``, one entry a level."""
    setup()
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    K = assembly.dense_correlation(pts, scale, nu, dtype=dtype, device=device)
    Km = MixedCorrelation(K, device=device)

    # the batch of data vectors: one signal, the reference's seeded noise
    # scaled by each level (generate_data's semantics)
    pts = np.asarray(pts)
    noise_levels = np.asarray(noise_levels, dtype=np.float64)
    signal = np.sin(pts * np.pi).sum(axis=1)
    eps = np.random.RandomState(seed).randn(pts.shape[0])
    Z = signal[None, :] + noise_levels[:, None] * eps[None, :]    # (L, n)

    data0 = dl.make_spectral_data(Km, X, Z[0])
    lam, Xt = data0.lam, data0.Xt
    Zt = Km.rotate(Z.T).to(device="cpu", dtype=torch.float64).T   # (L, n)
    L = Z.shape[0]

    der1 = _batched(pl_mod.log_likelihood_der1_eta, lam, Xt)

    def der1_batch(log_eta):
        return der1(log_eta, Zt)

    lo = torch.full((L,), LOG_ETA_BRACKET[0], dtype=torch.float64)
    hi = torch.full((L,), LOG_ETA_BRACKET[1], dtype=torch.float64)
    f_lo, f_hi = der1_batch(lo), der1_batch(hi)
    bracketed = (torch.sign(f_lo) != torch.sign(f_hi)).numpy()
    root, _ = root_finding.chandrupatla(der1_batch, lo, hi, f0=f_lo,
                                        f1=f_hi, eps_m=1e-6, eps_a=1e-6)
    eta = np.where(bracketed, np.power(10.0, root.numpy()),
                   np.where(f_hi.numpy() > 0, np.inf, 0.0))

    # sigma(eta) on every lane at once (the eta = inf lanes at a stand-in
    # eta, overwritten below), sigma0 of the eta = inf lanes
    finite = np.isfinite(eta)
    sigma = _batched(pl_mod.find_optimal_sigma, lam, Xt)(
        torch.as_tensor(np.where(finite, eta, 1.0)), Zt).numpy()
    sigma = np.where(finite, sigma, 0.0)
    sigma0 = np.where(finite, np.sqrt(np.where(finite, eta, 0.0)) * sigma,
                      0.0)
    for i in np.flatnonzero(~finite):
        sigma0[i] = float(pl_mod.find_optimal_sigma0(
            dl.SpectralData(lam=lam, Xt=Xt, zt=Zt[i])))

    # GCV noise estimates of the same problems (config 4)
    gcv_sigma0 = np.asarray([
        gcv_mod.minimize_gcv(dl.SpectralData(lam=lam, Xt=Xt,
                                             zt=Zt[i]))["sigma0"]
        for i in range(L)])
    return {"noise_levels": noise_levels, "eta": eta, "sigma": sigma,
            "sigma0": sigma0, "gcv_sigma0": gcv_sigma0}


def main(num_points=30, num_levels=200, results_path=None, use_saved=False,
         verbose=True, *, device="cuda"):
    """The sweep of :func:`sweep` on a num_points x num_points grid over
    logspace(-2, 1, num_levels) for each of :data:`FAMILIES`; a dict by
    family name."""
    device = resolve_device(device)

    def compute():
        pts = data_utils.generate_points(num_points, dimension=2)
        noise_levels = np.logspace(-2, 1, num_levels)
        out = {}
        for name, kwargs in FAMILIES:
            X = data_utils.generate_basis_functions(pts, **kwargs)
            out[name] = sweep(pts, X, noise_levels, device=device)
            if verbose:
                ratio = out[name]["sigma0"][-20:] / noise_levels[-20:]
                print(f"[{name}] sigma0/noise at high noise: "
                      f"{np.nanmean(ratio):.3f}")
        return out

    return checkpoint.run_or_resume(results_path, compute,
                                    use_saved=use_saved, verbose=verbose)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=30)
    p.add_argument("--num-levels", type=int, default=200)
    p.add_argument("--results-path", default=None)
    p.add_argument("--use-saved", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.num_points, a.num_levels, results_path=a.results_path,
         use_saved=a.use_saved, device=a.device)
