"""MCMC convergence diagnostics: split R-hat and effective sample size.

Counterpart of ``gppe_tpu.models.diagnostics``, numpy on the host as
there: the standard diagnostics (Gelman et al., BDA3 sections 11.4-11.5;
Geyer's initial positive sequence for ESS) that the posterior samplers'
results carry. The reference itself has no sampler. A sample array may be
numpy or a torch tensor on any device; diagnostics run once per result,
not per sample.
"""

import numpy as np


def _host(samples):
    """A (S, C, D) sample array as float64 numpy (a tensor is copied off
    its device)."""
    if hasattr(samples, "detach"):
        samples = samples.detach().cpu().numpy()
    return np.asarray(samples, dtype=np.float64)


def split_rhat(samples):
    """Split potential-scale-reduction factor per dimension.

    ``samples``: (num_samples, num_chains, dim) — each chain is split
    in half (2C half-chains of length S/2), guarding against chains
    that individually drift. Returns (dim,). Values near 1.0 indicate
    convergence; > 1.01 is the usual flag threshold.
    """
    s = _host(samples)
    S, C, D = s.shape
    half = S // 2
    if half < 2:
        return np.full(D, np.nan)
    halves = np.concatenate([s[:half], s[half:2 * half]], axis=1)
    n, m = half, 2 * C
    chain_mean = halves.mean(axis=0)                 # (m, D)
    chain_var = halves.var(axis=0, ddof=1)           # (m, D)
    B = n * chain_mean.var(axis=0, ddof=1)           # between
    W = chain_var.mean(axis=0)                       # within
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_plus / W)
    return out


def effective_sample_size(samples):
    """ESS per dimension via autocorrelation with Geyer's initial
    positive-sequence truncation, combined across chains.

    ``samples``: (num_samples, num_chains, dim). Returns (dim,).
    """
    s = _host(samples)
    S, C, D = s.shape
    if S < 4:
        return np.full(D, np.nan)
    out = np.empty(D)
    for d in range(D):
        x = s[:, :, d]
        x = x - x.mean(axis=0, keepdims=True)
        # per-chain autocovariance via FFT, averaged over chains
        nfft = 1 << (2 * S - 1).bit_length()
        f = np.fft.rfft(x, n=nfft, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:S].real
        acov = acov.mean(axis=1) / S                 # (S,)
        if acov[0] <= 0:
            out[d] = np.nan
            continue
        rho = acov / acov[0]
        # Geyer: sum of adjacent pairs must stay positive
        tau = 1.0
        for t in range(1, S - 1, 2):
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            tau += 2.0 * pair
        out[d] = S * C / max(tau, 1.0)
    return out


def summarize(samples, names=None):
    """One diagnostics dict for a (S, C, D) sample array: per-dimension
    mean/std/quantiles, split R-hat, ESS. JSON/pickle-friendly floats."""
    s = _host(samples)
    S, C, D = s.shape
    flat = s.reshape(-1, D)
    rhat = split_rhat(s)
    ess = effective_sample_size(s)
    names = names or [f"dim{d}" for d in range(D)]
    out = {"num_samples": int(S), "num_chains": int(C)}
    for d, name in enumerate(names):
        q = np.quantile(flat[:, d], [0.05, 0.25, 0.5, 0.75, 0.95])
        out[name] = {
            "mean": float(flat[:, d].mean()),
            "std": float(flat[:, d].std()),
            "q05": float(q[0]), "q25": float(q[1]),
            "median": float(q[2]), "q75": float(q[3]),
            "q95": float(q[4]),
            "rhat": float(rhat[d]), "ess": float(ess[d]),
        }
    return out
