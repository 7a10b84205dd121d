"""Batched Lanczos and the deflated stochastic-quadrature trace engine.

Counterpart of the main-path half of :mod:`gppe_tpu.ops.stochastic`:

* :func:`lanczos` runs on the device: a batched Lanczos pass whose matvec
  is one multi-RHS ``matmat`` per step, with full reorthogonalization and
  float64 alpha/beta sums;
* :func:`gram_f64` / :func:`matmul_f64` are plain on-device float64
  products (the H100 has native f64, so the reference's TPU workaround of
  f32 block products summed in f64 is not needed);
* :func:`ritz_decompose`, :func:`deflated_quadrature` and
  :class:`QuadratureTraceEngine` are host float64 numpy, copied from the
  reference unchanged.
"""

import numpy as np
import torch


def lanczos(matvec, V0, num_steps, reorthogonalize=True):
    """Batched Lanczos tridiagonalization.

    ``matvec``: (n, p) -> (n, p); ``V0``: (n, p) starting block (columns
    are independent runs), on the device and in the dtype of the
    iteration. Returns (alphas (p, k), betas (p, k-1), V (k, p, n)) with
    V the orthonormal Lanczos bases — the reference's layout, so the two
    compare like with like. alphas and betas are float64.

    The vectors and the matvec stay in ``V0.dtype``; the tridiagonal
    coefficients alpha = q.w and beta = |w| are summed in float64:
    O(n) float32 reductions carry ~sqrt(n) eps relative noise that enters
    T systematically and biases the quadrature traces (the reference
    measured a der1 bias of 0.5 at n = 16384 with float32 sums). Full
    reorthogonalization against every previous basis vector keeps the
    float32 Ritz spectrum clean. ``V`` is written in place and step j
    reads only ``V[:j+1]``; nothing in the loop waits for the host.
    """
    n, p = V0.shape
    dtype = V0.dtype
    k = num_steps

    def dot_rows(a, b):
        """Per-row a.b (over n), summed in float64."""
        return torch.sum((a * b).to(torch.float64), dim=1)

    q = V0.T                                            # (p, n)
    q = q / torch.sqrt(dot_rows(q, q)).to(dtype)[:, None]
    V = torch.zeros((k, p, n), dtype=dtype, device=V0.device)
    V[0] = q
    alphas = torch.zeros((p, k), dtype=torch.float64, device=V0.device)
    betas = torch.zeros((p, k - 1), dtype=torch.float64, device=V0.device)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(p, dtype=dtype, device=V0.device)

    for j in range(k):
        # pin the vector dtype: an operator that promotes must not flip
        # the iteration's dtype
        w = matvec(q.T).to(dtype).T                     # (p, n)
        alpha = dot_rows(q, w)                          # (p,)
        w = w - alpha.to(dtype)[:, None] * q - beta_prev[:, None] * q_prev
        if reorthogonalize:
            Vj = V[:j + 1]
            coeffs = torch.einsum("ipn,pn->ip", Vj, w)
            w = w - torch.einsum("ipn,ip->pn", Vj, coeffs)
        beta = torch.sqrt(dot_rows(w, w))
        beta_safe = torch.where(beta > 0, beta, 1.0).to(dtype)
        q_next = w / beta_safe[:, None]
        if j + 1 < k:
            V[j + 1] = q_next
        alphas[:, j] = alpha
        if j < k - 1:
            betas[:, j] = beta
        q_prev, q, beta_prev = q, q_next, beta.to(dtype)
    return alphas, betas, V


def gram_f64(Vm):
    """Vm @ Vm.T in float64 on Vm's device.

    The per-eta math consumes Gram matrices of O(n) vectors; a float32
    product's accumulated rounding (~sqrt(n) eps) would enter the profile
    derivative as a systematic error."""
    Vm = Vm.to(torch.float64)
    return Vm @ Vm.T


def matmul_f64(A, B):
    """A (m, n) @ B (n, t) in float64 on the operands' device (same
    rationale as :func:`gram_f64`)."""
    return A.to(torch.float64) @ B.to(torch.float64)


def ritz_decompose(alphas, betas):
    """Ritz values and SLQ weights from batched tridiagonal coefficients.

    Returns (theta (p, k), tau (p, k)) with tau the squared first
    components of T's eigenvectors — the Gauss quadrature weights of the
    Lanczos rule. Computed in float64 on host (tiny k x k problems).
    """
    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    p, k = a.shape
    theta = np.empty((p, k))
    tau = np.empty((p, k))
    for i in range(p):
        T = np.diag(a[i]) + np.diag(b[i], 1) + np.diag(b[i], -1)
        w, U = np.linalg.eigh(T)
        theta[i] = w
        tau[i] = U[0, :] ** 2
    return theta, tau


def deflated_quadrature(al_defl, be_defl, al_probe, be_probe, P,
                        probe_norm2, n, trace_K2=None):
    """Collapse one-pass-deflated, CV-regressed SLQ into a fixed
    quadrature (nodes, weights): trace f(K + eta I) ~= sum_j w_j
    f(node_j + eta).

    Inputs come from ONE merged Lanczos pass over [.., v_defl, probes]:
    ``al_defl``/``be_defl`` the deflation chain's tridiagonal (k,)/(k-1,),
    ``al_probe``/``be_probe`` the probe tridiagonals (p, k)/(p, k-1),
    ``P`` (k, p) the probes' overlaps with the deflation chain's Lanczos
    basis, ``probe_norm2`` (p,) the squared probe norms.

    Math: converged Ritz pairs (mu_t, w_t) of the deflation chain are
    subtracted per probe — F_i - sum_t (v_i . w_t)^2 f(mu_t + eta) is
    unbiased for trace f - sum_t f(mu_t + eta) because
    E[(v^T w)^2] = |w|^2 for Rademacher probes even when w is NOT an
    exact eigenvector — then a control-variate regression against the
    exactly known moments trace(K^q) (q = 0: n, q = 1: n for
    unit-diagonal correlation K, q = 2: ||K||_F^2 if given) removes the
    spectral-bulk variance. Both corrections are linear in the per-probe
    quadratures, so they collapse into fixed weights (the reference's
    ``gppe_tpu.ops.stochastic.deflated_quadrature``, unchanged).
    """
    al_probe = np.asarray(al_probe, dtype=np.float64)
    be_probe = np.asarray(be_probe, dtype=np.float64)
    p, k = al_probe.shape
    probe_norm2 = np.asarray(probe_norm2, dtype=np.float64)

    theta, tau = ritz_decompose(al_probe, be_probe)
    theta = np.maximum(theta, 0.0)

    # deflation chain Ritz system
    a = np.asarray(al_defl, dtype=np.float64)
    b = np.asarray(be_defl, dtype=np.float64)
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    mu, Qd = np.linalg.eigh(T)
    mu = np.maximum(mu, 0.0)
    resid = (np.abs(b[-1]) * np.abs(Qd[-1, :])) if k > 1 else np.zeros(k)
    tol_r = 1e-3 * max(mu.max(), 1.0)
    order_hi = np.argsort(mu)[::-1]
    order_lo = np.argsort(mu)
    keep, seen = [], set()
    for pair in zip(order_hi, order_lo):
        for t in pair:
            if resid[t] < tol_r and t not in seen:
                seen.add(t)
                keep.append(t)
    keep = np.asarray(keep, dtype=int)
    q_b = keep.size
    mu_k = mu[keep]
    P = np.asarray(P, dtype=np.float64)
    vw = P.T @ Qd[:, keep] if q_b else np.zeros((p, 0))
    cit = vw ** 2                                          # (p, q_b)

    # CV regression on the deflated estimates -> fixed probe weights
    mq_raw = np.stack([
        probe_norm2 * tau.sum(axis=1),
        probe_norm2 * (tau * theta).sum(axis=1),
        probe_norm2 * (tau * theta ** 2).sum(axis=1),
    ], axis=1)                                             # (p, 3)
    mu_pows = np.stack([np.ones_like(mu_k), mu_k, mu_k ** 2], axis=1)
    mq = mq_raw - cit @ mu_pows
    n_mom = 3 if trace_K2 is not None else 2
    targets = np.array([float(n), float(n),
                        float(trace_K2) if trace_K2 is not None else 0.0])
    targets = targets[:n_mom] - mu_pows.sum(axis=0)[:n_mom]
    mq = mq[:, :n_mom]
    Xc = mq - mq.mean(axis=0, keepdims=True)
    Gm = Xc.T @ Xc
    Gm += 1e-12 * np.trace(Gm) / n_mom * np.eye(n_mom)
    Pm = np.linalg.solve(Gm, Xc.T)
    r = targets - mq.mean(axis=0)
    qw = Pm.T @ r
    omega = qw + (1.0 - qw.sum()) / p

    w_probe = omega[:, None] * probe_norm2[:, None] * tau   # (p, k)
    gamma = 1.0 - omega @ cit                               # (q_b,)
    nodes = np.concatenate([theta.ravel(), mu_k])
    weights = np.concatenate([w_probe.ravel(), gamma])
    return nodes, weights


class QuadratureTraceEngine:
    """Host-side trace engine over a fixed quadrature (nodes, weights):
    trace f(K + eta I) = sum_j w_j f(node_j + eta). The collapsed form of
    the deflated-CV SLQ estimator (see :func:`deflated_quadrature`) —
    the drop-in ``traces`` object of
    models.large_scale.KrylovProfileLikelihood."""

    def __init__(self, nodes, weights, n):
        self.nodes = np.asarray(nodes, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.n = int(n)

    def _quad(self, f, eta):
        return float(np.sum(self.weights * f(self.nodes + float(eta))))

    def logdet(self, eta):
        return self._quad(lambda t: np.log(np.maximum(t, 1e-300)), eta)

    def traceinv(self, eta, exponent=1):
        return self._quad(
            lambda t: np.maximum(t, 1e-300) ** (-float(exponent)), eta)

    def trace_pow(self, eta, exponent=1):
        return self._quad(lambda t: t ** exponent, eta)
