"""Whether the checked job came out right: the program's products, its
factorization and its estimate against the float64 reference.

Readings (each held to its limit in ``limits/<workload>.json``):

* ``start_err``: the worst column of the sine of the angle between the
  first operand of its product calls, the first vector of its Krylov
  basis, and its own column of the job's start block [z, X, v_defl,
  probes]: that the bases the reference follows start where the job does.
* ``product_err``: the worst column, over every product call of the job,
  of ||W - K V|| / ||K V|| (all rows): the program's product W against the
  reference's K V on the same operand V.
* ``tridiag_err``: the worst solve column of ||T - Q^T K Q||_F / ||Q^T K
  Q||_F: the program's tridiagonal (its alphas and betas) against the
  projection of the reference's K on the orthonormalised basis.
* ``quad_err``: the worse of logdet(K + eta I) and trace((K + eta I)^-1)
  by the program's quadrature against the reference's, relative, at the
  reference's eta.
* ``estimate_err``: the worst of eta, sigma, sigma0, relative, against the
  reference's fit (over a grid of kernels, of every kernel's).
* ``lp_err`` (a grid of kernels): the worse, in nats, of the widest gap
  between the program's and the reference's profile log-likelihood at each
  kernel's optimum, and of what the program's choice of kernel loses by
  the reference's likelihood against the reference's own best: where two
  kernels tie within that gap, either is a right answer.
"""

import numpy as np
import torch

from .. import spec
from . import krylov

# the float64 operand block a reference product takes at once
_BLOCK_BYTES = 4e9


def _rel(a, b):
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    if not (np.isfinite(a) and np.isfinite(b)):
        return np.inf
    return abs(a - b) / max(abs(b), 1e-300)


def _bases(products):
    """Per kernel, the operands V and results W of the job's product calls
    as (k, p, n) float32: one kernel for an operator's (n, p) calls, B for
    a batched (B, n, p) call."""
    Vs = torch.stack([v for v, _ in products])
    Ws = torch.stack([w for _, w in products])
    if Vs.ndim == 3:                                    # (k, n, p)
        return [(Vs.transpose(1, 2), Ws.transpose(1, 2))]
    return [(Vs[:, b].transpose(1, 2), Ws[:, b].transpose(1, 2))
            for b in range(Vs.shape[1])]                # (k, B, n, p)


def _start_err(V0, A, job):
    """The worst column's sine of the angle between the basis's first
    vector ``V0`` (p, n) and the column of the start block it starts."""
    start = torch.cat([A, job.v_defl.to(torch.float64),
                       job.probes.to(torch.float64)], dim=1)      # (n, p)
    start = start / start.norm(dim=0)
    first = V0.T.to(torch.float64)
    first = first / first.norm(dim=0)
    cos = (first * start).sum(dim=0)
    return float((first - cos * start).norm(dim=0).max())


def _kernel(cell, job, rho, nu, V, W, engine, device):
    """The readings and the reference's estimate for one kernel."""
    k, p, n = V.shape
    m = job.X.shape[1]
    s = m + 1
    ref = spec.part("reference", cell.config["operator"])
    points = torch.as_tensor(job.points, dtype=torch.float64, device=device)
    A = torch.as_tensor(np.concatenate([job.z[:, None], job.X], axis=1),
                        dtype=torch.float64, device=device)
    start_err = _start_err(V[0], A, job)
    probes = job.probes.to(torch.float64)
    group = max(1, int(_BLOCK_BYTES // (n * k * 8)))
    T = np.empty((p, k, k))
    product_err = 0.0
    trace_k2 = None
    Q = {}
    for c0 in range(0, p, group):
        c1 = min(c0 + group, p)
        Vg = V[:, c0:c1].to(torch.float64)              # (k, g, n)
        vectors = Vg.permute(2, 1, 0).reshape(n, (c1 - c0) * k)
        if cell.config["operator"] == "matern":
            KV, tk2 = ref.apply(points, rho, nu, vectors)
        else:
            KV, tk2 = ref.apply(job.points, rho, nu, vectors, cell.config)
        trace_k2 = tk2 if trace_k2 is None else trace_k2
        KV = KV.reshape(n, c1 - c0, k)
        del vectors
        for i, c in enumerate(range(c0, c1)):
            Mc, KMc = Vg[:, i].T, KV[:, i]
            gap = (W[:, c].T.to(torch.float64) - KMc).norm(dim=0)
            product_err = max(product_err, float(
                (gap / KMc.norm(dim=0)).max()))
            Qc, _, Tc = krylov.project(Mc, KMc)
            T[c] = Tc.cpu().numpy()
            if c <= s:
                Q[c] = Qc
        del Vg, KV
    B = np.stack([(Q[j].T @ A).cpu().numpy() for j in range(s)])
    G = np.empty((s, s, k, k))
    for i in range(s):
        for j in range(s):
            G[i, j] = (Q[i].T @ Q[j]).cpu().numpy()
    P = (Q[s].T @ probes).cpu().numpy()
    nodes, weights = krylov.deflated_quadrature(
        T[s], T[s + 1:], P, np.full(p - s - 1, float(n)), n, trace_k2)
    A_host = np.concatenate([job.z[:, None], job.X], axis=1)
    reference = krylov.Engine(T[:s], B, G, krylov.Quadrature(nodes, weights),
                              n, m, A_host.T @ A_host)
    fit = cell.traffic["fit"]
    estimate = reference.fit(interval_eta=tuple(fit["interval_eta"]),
                             tol=float(fit["tol"]))
    tridiag_err = max(
        np.linalg.norm(krylov.tridiagonal(engine.alphas[j], engine.betas[j])
                       - T[j]) / np.linalg.norm(T[j]) for j in range(s))
    eta = estimate["eta"] if 0 < estimate["eta"] < np.inf else 1.0
    quad_err = max(
        _rel(engine.traces.logdet(eta), reference.traces.logdet(eta)),
        _rel(engine.traces.traceinv(eta), reference.traces.traceinv(eta)))
    return {"start_err": start_err, "product_err": product_err,
            "tridiag_err": float(tridiag_err), "quad_err": quad_err}, estimate


def _estimate_err(program, reference):
    return max(_rel(program[key], reference[key])
               for key in ("eta", "sigma", "sigma0"))


def readings(cell, checked, device):
    """Every reading of the checked job."""
    kernels = list(zip(checked.rhos, checked.nus))
    bases = _bases(checked.products)
    checked.products.clear()         # the stacked copies replace them
    if len(bases) != len(kernels) or len(checked.engines) != len(kernels):
        raise RuntimeError(f"the checked job has {len(bases)} product "
                           f"bases and {len(checked.engines)} engines for "
                           f"{len(kernels)} kernels")
    out, estimates = {}, []
    for (rho, nu), (V, W), engine in zip(kernels, bases, checked.engines):
        r, est = _kernel(cell, checked.job, rho, nu, V, W, engine, device)
        for key, value in r.items():
            out[key] = max(out.get(key, 0.0), value)
        estimates.append(est)
    program = checked.estimate
    if len(kernels) == 1:
        out["estimate_err"] = _estimate_err(program, estimates[0])
        return out
    points = program["points"]
    out["estimate_err"] = max(_estimate_err(p, e)
                              for p, e in zip(points, estimates))
    chosen = [p["rho"] for p in points].index(program["rho"])
    lp_ref = [e["lp"] for e in estimates]
    out["lp_err"] = max([_lp_gap(p["lp"], e["lp"])
                         for p, e in zip(points, estimates)]
                        + [_lp_gap(max(lp_ref), lp_ref[chosen])])
    return out


def _lp_gap(a, b):
    if a == b:
        return 0.0
    return abs(a - b) if np.isfinite(a) and np.isfinite(b) else np.inf


def judge(values, limits):
    """(correct, [(name, value, limit)]) : every limit met, NaN failing."""
    rows = [(name, float(values.get(name, np.nan)), float(limit))
            for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
