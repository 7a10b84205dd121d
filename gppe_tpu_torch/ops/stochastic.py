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
  reference unchanged;
* :class:`StochasticTraceEngine` (a deflation Lanczos chain and a probe
  Lanczos pass on the device, then host float64 quadrature) is the
  stochastic backend of ``models.mixed_correlation``, for both its 'slq'
  and its 'hutchinson' method, and so of the public API's operator
  route. Beside the main path's :class:`QuadratureTraceEngine` it is a
  second SLQ estimator: the reference keeps both, the one-pass engine for
  the Krylov fit, the two-pass one for MixedCorrelation;
* :func:`hutchinson_traceinv` (batched CG over the probes) and the
  engine's ``defer_lanczos`` / :meth:`~StochasticTraceEngine.
  from_tridiagonals` are the reference's public surface: no path of the
  port calls them.

Random draws come from an explicit ``torch.Generator`` or seed, or are
handed in (``probes=``, ``v_defl=``): :func:`random_block`.
"""

import numpy as np
import torch

from . import linalg


def rademacher(n, p, generator, device, dtype):
    """(n, p) Rademacher probes (entries +-1) drawn from ``generator``."""
    draw = torch.randint(0, 2, (n, p), generator=generator, device=device)
    return (2 * draw - 1).to(dtype)


def random_block(n, num_probes, key, device, dtype, generator=None,
                 probes=None, v_defl=None):
    """The engines' random block on ``device``: Rademacher ``probes``
    (n, num_probes) and a normal deflation start ``v_defl`` (n, 1). What
    the caller gives is taken as it is; the rest is drawn from
    ``generator`` (a ``torch.Generator`` on ``device``), else from a new
    one seeded with ``key``."""
    if generator is None and (probes is None or v_defl is None):
        generator = torch.Generator(device=device).manual_seed(key)
    if probes is None:
        probes = rademacher(n, num_probes, generator, device, dtype)
    if v_defl is None:
        v_defl = torch.randn((n, 1), generator=generator, device=device,
                             dtype=dtype)
    probes = torch.as_tensor(probes, dtype=dtype, device=device)
    v_defl = torch.as_tensor(v_defl, dtype=dtype, device=device).reshape(n, 1)
    if probes.shape != (n, num_probes):
        raise ValueError(f"probes must be ({n}, {num_probes}); "
                         f"got {tuple(probes.shape)}")
    return probes, v_defl


def _as_matvec(K):
    """The (n, p) -> (n, p) product of K: K itself if callable, its
    ``matmat``, or the dense product."""
    if callable(K):
        return K
    if hasattr(K, "matmat"):
        return K.matmat
    return K.__matmul__


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


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


class StochasticTraceEngine:
    """One Lanczos pass over K; every eta and every f() amortized.

    Counterpart of ``gppe_tpu.ops.stochastic.StochasticTraceEngine`` (the
    role of imate.AffineMatrixFunction with SLQ, reference
    mixed_correlation.py:44,138-143,204-209,263-268), with its two
    variance-reduction layers:

    * **top-q deflation from both spectral ends**: a Lanczos chain from
      ``v_defl`` gives converged Ritz pairs (lam_i, w_i); their
      f-contribution is summed exactly and the probes are projected into
      the complement;
    * **the mean-shift control variate**: per probe, the same Ritz pairs
      estimate v'^T f(Kn) v' together with v'^T K^q v' (q = 0, 1, 2),
      whose expectations M0 = n - q, M1 = n - sum lam_top (unit diagonal)
      and M2 = trace(K^2) - sum lam_top^2 are known exactly; a regression
      on them removes the spectral bulk's variance.

    Both Lanczos runs go on K's device in its dtype (float32 through a
    ``MaternOperator``'s kernel, float64 for a dense K); the quadrature is
    host float64 numpy, as in the reference.
    """

    def __init__(self, K, num_probes=16, lanczos_steps=64, key=0,
                 reorthogonalize=True, probes=None, dtype=None,
                 deflate=64, deflate_steps=None, defer_lanczos=False, *,
                 device=None, generator=None, v_defl=None):
        """``K``: a dense (n, n) tensor, an operator with ``matmat`` (and
        optionally ``trace_pow``), or a callable product on (n, p) blocks.
        ``device``/``dtype``: where and in what the Lanczos runs go;
        default K's own (a bare callable needs ``device``; its dtype
        defaults to float32). Random draws come from ``generator``, else
        from a new one seeded with ``key``; ``probes`` (n, num_probes) and
        ``v_defl`` (n, 1), when given, are taken as they are.
        ``defer_lanczos=True`` prepares the projected probes and the exact
        moments but skips the probe Lanczos pass: the caller runs it over
        ``self.probes`` and hands the coefficients to :meth:`finalize`."""
        self.matvec = _as_matvec(K)
        self.n = K.shape[0]
        self.num_probes = num_probes
        self.lanczos_steps = min(lanczos_steps, self.n)
        device = torch.device(device if device is not None
                              else getattr(K, "device", "cuda"))
        dtype = dtype or getattr(K, "dtype", torch.float32)
        probes, v_defl = random_block(self.n, num_probes, key, device, dtype,
                                      generator, probes, v_defl)

        # --- deflation basis ------------------------------------------------
        self.q = 0
        self.lam_top = np.zeros(0)
        W = None
        if deflate and deflate > 0 and self.n > 8:
            q_req = int(min(deflate, self.n // 2))
            kd = int(min(deflate_steps or (q_req + 24), self.n))
            al, be, Vd = lanczos(self.matvec, v_defl, kd,
                                 reorthogonalize=reorthogonalize)
            a = _host(al[0])
            b = _host(be[0])
            T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
            w, U = np.linalg.eigh(T)
            # convergence: residual |beta_last * U[k-1, i]| small
            beta_last = abs(b[-1]) if kd > 1 else 0.0
            resid = beta_last * np.abs(U[-1, :])
            # converged Ritz pairs from BOTH spectral ends: the top drives
            # logdet variance, the bottom drives traceinv variance at
            # small eta
            order_hi = np.argsort(w)[::-1]
            order_lo = np.argsort(w)
            tol_r = 1e-3 * max(w[order_hi[0]], 1)
            keep_hi = [i for i in order_hi if resid[i] < tol_r]
            keep_lo = [i for i in order_lo if resid[i] < tol_r]
            keep, seen = [], set()
            for pair in zip(keep_hi, keep_lo):
                for i in pair:
                    if i not in seen:
                        seen.add(i)
                        keep.append(i)
            keep = keep[:q_req]
            if keep:
                self.q = len(keep)
                self.lam_top = w[keep]
                Uk = torch.as_tensor(U[:, keep], dtype=dtype, device=device)
                # Ritz vectors W = sum_k V_d[k] U[k, :]  -> (n, q),
                # re-orthonormalized (they are approximate)
                W = torch.einsum("kn,kq->nq", Vd[:, 0], Uk)
                W, _ = torch.linalg.qr(W)
        self.W = W

        # exact remainder moments: trace(K) = n (unit diagonal) and
        # trace(K^2) = ||K||_F^2 (computed once, O(n^2))
        if hasattr(K, "trace_pow"):
            trace_K2 = float(K.trace_pow(2))
        elif callable(K):
            trace_K2 = None
        else:
            trace_K2 = float(torch.sum(K * K))
        self.M0 = float(self.n - self.q)
        self.M1 = float(self.n - self.lam_top.sum())
        self.M2 = (None if trace_K2 is None
                   else float(trace_K2 - (self.lam_top ** 2).sum()))

        # --- probes in the complement --------------------------------------
        if W is not None:
            probes = probes - W @ (W.T @ probes)
        self.probes = probes
        self.probe_norm2 = _host(torch.sum(probes * probes, dim=0)).astype(
            np.float64)
        self._reorthogonalize = reorthogonalize

        if defer_lanczos:
            self.theta = None
            self.tau = None
        else:
            alphas, betas, _V = lanczos(self.matvec, probes,
                                        self.lanczos_steps,
                                        reorthogonalize=reorthogonalize)
            self.finalize(alphas, betas)

    def finalize(self, alphas, betas):
        """Install probe tridiagonal coefficients ((p, k), (p, k-1)) from
        an externally run Lanczos pass over ``self.probes``."""
        theta, tau = ritz_decompose(_host(alphas), _host(betas))
        # clip tiny negative Ritz values from float32 roundoff: K is PSD
        self.theta = np.maximum(theta, 0.0)
        self.tau = tau

    @classmethod
    def from_tridiagonals(cls, alphas, betas, probe_norm2, n,
                          trace_K2=None):
        """Minimal quadrature engine from externally computed probe
        tridiagonals — no deflation pass, no operator reference (the
        grid-batched path's per-point engine). Assumes unit-diagonal K
        (trace(K) = n), as all correlation operators here have."""
        self = cls.__new__(cls)
        self.matvec = None
        self.n = int(n)
        self.num_probes = int(np.asarray(_host(alphas)).shape[0])
        self.lanczos_steps = int(np.asarray(_host(alphas)).shape[1])
        self.q = 0
        self.lam_top = np.zeros(0)
        self.W = None
        self.M0 = float(n)
        self.M1 = float(n)
        self.M2 = None if trace_K2 is None else float(trace_K2)
        self.probes = None
        self.probe_norm2 = np.asarray(_host(probe_norm2), dtype=np.float64)
        self._reorthogonalize = True
        self.finalize(alphas, betas)
        return self

    def _quad(self, f, eta):
        """trace f(K + eta I): exact deflated part + regression-adjusted
        stochastic remainder (the reference's estimator, unchanged)."""
        eta = float(eta)
        top = float(f(self.lam_top + eta).sum()) if self.q else 0.0

        F = self.probe_norm2 * (self.tau * f(self.theta + eta)).sum(axis=1)
        m0 = self.probe_norm2
        m1 = self.probe_norm2 * (self.tau * self.theta).sum(axis=1)
        covs = [(m0, self.M0), (m1, self.M1)]
        if self.M2 is not None:
            m2 = self.probe_norm2 * (self.tau * self.theta ** 2).sum(axis=1)
            covs.append((m2, self.M2))

        Fc = F - F.mean()
        Xc = np.stack([c - c.mean() for c, _ in covs], axis=1)
        # ridge-regularized least squares for the CV coefficients
        G = Xc.T @ Xc
        G += 1e-12 * np.trace(G) / max(G.shape[0], 1) * np.eye(G.shape[0])
        beta = np.linalg.solve(G, Xc.T @ Fc)
        adjusted = F.mean() + sum(
            b * (target - c.mean()) for b, (c, target) in zip(beta, covs))
        return top + float(adjusted)

    def logdet(self, eta):
        return self._quad(lambda t: np.log(np.maximum(t, 1e-300)), eta)

    def traceinv(self, eta, exponent=1):
        return self._quad(
            lambda t: np.maximum(t, 1e-300) ** (-float(exponent)), eta)

    def trace_pow(self, eta, exponent=1):
        return self._quad(lambda t: t ** exponent, eta)


def hutchinson_traceinv(K, eta, num_probes=32, key=0, tol=1e-6,
                        max_iter=1000, exponent=1, *, probes=None,
                        generator=None):
    """Hutchinson estimator of trace((K + eta I)^-p), p in {1, 2}: all
    probes solve together as one batched CG (the role of imate's
    'hutchinson' method, reference mixed_correlation.py:193-202).
    ``K``: a dense tensor or an operator with ``matmat``; the solves run
    on its device in its dtype. Probes: ``probes`` (n, num_probes) as
    given, else Rademacher draws from ``generator``, else from a new one
    seeded with ``key``."""
    if exponent not in (1, 2):
        raise ValueError("exponent must be 1 or 2")
    n = K.shape[0]
    device, dtype = K.device, K.dtype
    if probes is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(key)
        probes = rademacher(n, num_probes, generator, device, dtype)
    V = torch.as_tensor(probes, dtype=dtype, device=device)
    A = K.matmat if hasattr(K, "matmat") else K
    X = linalg.cg_solve(A, V, tol=tol, max_iter=max_iter, shift=float(eta))
    if exponent == 2:
        X = linalg.cg_solve(A, X, tol=tol, max_iter=max_iter,
                            shift=float(eta))
    return float(torch.mean(torch.sum(V * X, dim=0)))
