"""Large-N likelihood engine: one Krylov factorization, O(k^2) per eta.

Counterpart of ``gppe_tpu.models.large_scale``. The whole eta-dependence
of the profile likelihood is factored out of the large-n work:

1. ONE batched Lanczos pass on the device tridiagonalizes K against the
   block [z, X, v_defl, probes] (solves, deflation chain and trace
   probes): ``lanczos_steps`` fused Matern matmats
   (:class:`gppe_tpu_torch.ops.operators.MaternOperator`, K never stored).
2. The small projections U (basis . data), G (basis Grams) and P
   (deflation basis . probes) are float64 products on the device, shipped
   to the host once, with trace(K^2) from one Frobenius pass.
3. Every quantity at any eta — solves, B = X^T Kn^-1 X, zMz, ||Mz||^2,
   trace(Kn^-1) — is k-dimensional float64 host numpy; only ``__init__``
   touches the device. Everything after it is the reference's code,
   unchanged, including the ``fit`` root policy.
"""

import numpy as np
import torch

from ..ops import root_finding, stochastic
from ..utils.config import resolve_device, setup


def _tridiag_solve(alpha, beta, eta, rhs):
    """Solve (T + eta I) y = rhs for the tridiagonal T given by diagonals
    alpha (k,), off-diagonals beta (k-1,). Thomas algorithm in float64;
    ``rhs`` is a full (k,) vector."""
    k = alpha.shape[0]
    a = alpha + eta
    c_prime = np.empty(k - 1) if k > 1 else np.empty(0)
    d_prime = np.empty(k)
    denom = a[0]
    d_prime[0] = rhs[0] / denom
    for i in range(1, k):
        c_prime[i - 1] = beta[i - 1] / denom
        denom = a[i] - beta[i - 1] * c_prime[i - 1]
        d_prime[i] = (rhs[i] - beta[i - 1] * d_prime[i - 1]) / denom
    y = np.empty(k)
    y[-1] = d_prime[-1]
    for i in range(k - 2, -1, -1):
        y[i] = d_prime[i] - c_prime[i] * y[i + 1]
    return y


def _tridiag_solve_e1(alpha, beta, eta, rhs0):
    """(T + eta I)^-1 (rhs0 * e1) — the Lanczos solve coefficient vector."""
    k = alpha.shape[0]
    rhs = np.zeros(k)
    rhs[0] = rhs0
    return _tridiag_solve(alpha, beta, eta, rhs)


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
        probes = torch.randint(0, 2, (n, num_probes), generator=generator,
                               device=device)
        probes = (2 * probes - 1).to(dtype)
    if v_defl is None:
        v_defl = torch.randn((n, 1), generator=generator, device=device,
                             dtype=dtype)
    probes = torch.as_tensor(probes, dtype=dtype, device=device)
    v_defl = torch.as_tensor(v_defl, dtype=dtype, device=device).reshape(n, 1)
    if probes.shape != (n, num_probes):
        raise ValueError(f"probes must be ({n}, {num_probes}); "
                         f"got {tuple(probes.shape)}")
    return probes, v_defl


class KrylovProfileLikelihood:
    """Profile-likelihood MLE over eta on a matrix-free operator."""


    def __init__(self, operator, X, z, lanczos_steps=80, num_probes=16,
                 key=0, *, device="cuda", dtype=torch.float32,
                 generator=None, probes=None, v_defl=None):
        """``operator``: a matrix-free K with ``matmat`` (and optionally
        ``trace_pow``) on ``device``, or a dense (n, n) tensor.
        ``device``/``dtype``: where and in what the Lanczos pass runs.
        Random draws come from ``generator`` (a ``torch.Generator`` on
        ``device``), else from a new one seeded with ``key``.
        ``probes`` (n, num_probes) and ``v_defl`` (n,) or (n, 1): optional
        explicit random block (Rademacher probes, normal deflation start),
        drawn when absent — lets a caller reproduce another engine's draw
        exactly."""
        setup()
        device = resolve_device(device)
        op_device = resolve_device(getattr(operator, "device", device))
        if op_device != device:
            raise ValueError(f"operator is on {op_device}, engine on {device}")
        X = np.asarray(X, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        self.n, self.m = X.shape
        self.s = self.m + 1
        self.k = lanczos_steps

        # Augmented RHS block [z, X]
        A = np.concatenate([z[:, None], X], axis=1)
        self.rhs_norms = np.linalg.norm(A, axis=0)
        # raw data Gram [[z'z, z'X], [X'z, X'X]] (f64 host, O(n s^2)):
        # the exact eta->inf boundary needs the OLS residual, which no
        # Krylov solve at huge eta can supply trustworthily
        self.AtA = A.T @ A
        A_dev = torch.as_tensor(A, dtype=dtype, device=device)

        if hasattr(operator, "matmat"):
            matvec = operator.matmat
        else:
            K = torch.as_tensor(operator, dtype=dtype, device=device)
            matvec = K.__matmul__

        # ONE merged Lanczos pass over [z, X, v_defl, probes]: the solve
        # block, the deflation chain and the trace probes ride the same
        # batched matmats; the deflation happens after the fact through
        # the one-pass quadrature collapse (stochastic.deflated_quadrature)
        probes, v_defl = random_block(self.n, num_probes, key, device, dtype,
                                      generator, probes, v_defl)
        AB = torch.cat([A_dev, v_defl, probes], dim=1)
        alphas, betas, V = stochastic.lanczos(matvec, AB, lanczos_steps,
                                              reorthogonalize=True)
        alphas = alphas.cpu().numpy()
        betas = betas.cpu().numpy()
        self.alphas = alphas[:self.s]                      # (s, k)
        self.betas = betas[:self.s]                        # (s, k-1)

        # small projections, float64 on the device, then to the host:
        #   U[j, :, t] = V_j . a_t            (s, k, s)
        #   G[i, j, a, b] = V_i[a] . V_j[b]   (s, s, k, k)
        #   P[a, i] = V_defl[a] . probe_i     (k, p)
        # float32 O(n) reductions would inject a systematic ~sqrt(n) eps
        # error into the per-eta quantities (see stochastic.lanczos)
        Vs = V[:, :self.s]                                 # (k, s, n)
        U = stochastic.matmul_f64(
            Vs.reshape(self.k * self.s, self.n), A_dev).reshape(
            self.k, self.s, self.s).permute(1, 0, 2)       # (j, k, t)
        Vm = Vs.permute(1, 0, 2).reshape(self.s * self.k, self.n)
        G = stochastic.gram_f64(Vm)
        P = stochastic.matmul_f64(V[:, self.s], probes)    # (k, p)
        self.U = U.cpu().numpy()
        self.G = G.cpu().numpy().reshape(
            self.s, self.k, self.s, self.k).transpose(0, 2, 1, 3)
        P = P.cpu().numpy()
        del V, Vs, Vm  # free the (k, p, n) basis before the trace pass

        trace_K2 = (float(operator.trace_pow(2))
                    if hasattr(operator, "trace_pow") else None)
        nodes, weights = stochastic.deflated_quadrature(
            alphas[self.s], betas[self.s],
            alphas[self.s + 1:], betas[self.s + 1:], P,
            np.full(num_probes, float(self.n)), self.n,
            trace_K2=trace_K2)
        self.traces = stochastic.QuadratureTraceEngine(nodes, weights,
                                                       self.n)

    @classmethod
    def from_factorization(cls, alphas, betas, U, G, rhs_norms, traces,
                           n, m, AtA=None):
        """Build the per-eta host engine from an externally computed
        Krylov factorization (the reference's grid-batched path,
        gppe_tpu.models.grid_krylov: one batched Lanczos pass factorizes a
        whole (rho, nu) chunk; each grid point then gets its own
        O(k^2)-per-eta engine).

        ``alphas``/``betas``: (s, k)/(s, k-1) solve-block tridiagonals;
        ``U``: (s, k, s) basis-RHS projections; ``G``: (s, s, k, k) basis
        Grams; ``rhs_norms``: (s,); ``traces``: a trace engine with
        ``logdet``/``traceinv`` (e.g. QuadratureTraceEngine); ``AtA``:
        optional (s, s) raw data Gram of [z, X] — enables the exact
        eta->inf OLS boundary.
        """
        self = cls.__new__(cls)
        self.n = int(n)
        self.m = int(m)
        self.s = int(m) + 1
        self.k = int(np.asarray(alphas).shape[1])
        self.alphas = np.asarray(alphas, dtype=np.float64)
        self.betas = np.asarray(betas, dtype=np.float64)
        self.U = np.asarray(U, dtype=np.float64)
        self.G = np.asarray(G, dtype=np.float64)
        self.rhs_norms = np.asarray(rhs_norms, dtype=np.float64)
        self.traces = traces
        self.AtA = None if AtA is None else np.asarray(AtA,
                                                       dtype=np.float64)
        return self

    # -- per-eta small math ----------------------------------------------

    def _solve_coeffs(self, eta):
        """y_j = (T_j + eta)^-1 ||a_j|| e1 for every RHS j. (s, k)."""
        Y = np.empty((self.s, self.k))
        for j in range(self.s):
            Y[j] = _tridiag_solve_e1(self.alphas[j], self.betas[j], eta,
                                     self.rhs_norms[j])
        return Y

    def _eta_stats(self, eta):
        """All profile-likelihood ingredients at one eta (host f64)."""
        y = self._solve_coeffs(eta)
        s, m = self.s, self.m

        # C[t, j] = a_t . Kn^-1 a_j  (via basis j)
        C = np.einsum("jkt,jk->tj", self.U, y)
        # Gram of solution vectors: S2[i, j] = u_i . u_j
        S2 = np.einsum("ia,ijab,jb->ij", y, self.G, y)

        B = C[1:, 1:]
        B = 0.5 * (B + B.T)
        Ytz = C[0, 1:]
        zw = C[0, 0]

        Binv = np.linalg.inv(B)
        c = Binv @ Ytz
        zMz = zw - Ytz @ c
        ww = S2[0, 0]
        wY = S2[0, 1:]
        YtY = S2[1:, 1:]
        zM2z = ww - 2.0 * (wY @ c) + c @ (YtY @ c)

        trace_Kninv = self.traces.traceinv(eta)
        trace_BinvYtY = np.trace(Binv @ YtY)
        trace_M = trace_Kninv - trace_BinvYtY
        return {
            "B": B, "Binv": Binv, "zMz": zMz, "zM2z": zM2z,
            "trace_M": trace_M, "trace_Kninv": trace_Kninv,
        }

    def der1(self, log_eta):
        """d lp / d eta at the profiled sigma (identity of reference
        _profile_likelihood.py:91-132), from Krylov pieces."""
        eta = 10.0 ** float(log_eta)
        st = self._eta_stats(eta)
        sigma2 = st["zMz"] / (self.n - self.m)
        return -0.5 * (st["trace_M"] - st["zM2z"] / sigma2)

    def der2(self, eta):
        """d^2 lp / d eta^2 at the profiled sigma (identity of reference
        _profile_likelihood.py:138-192), from Krylov pieces.

        Every ingredient reduces to cross-moments a_i^T Kn^-p a_j of the
        augmented RHS block for p <= 3, expressible through the stored
        basis Grams G and the tridiagonal solves:
            y1_j = (T_j+eta)^-1 e1 ||a_j||,  y2_j = (T_j+eta)^-1 y1_j,
            a_i^T Kn^-2 a_j ~ y1_i^T G_ij y1_j,
            a_i^T Kn^-3 a_j ~ y1_i^T G_ij y2_j  (symmetrized),
        plus trace(Kn^-1), trace(Kn^-2) from the probe quadrature. Used
        for the eta->0 boundary sign analysis (reference :352-405)."""
        eta = float(eta)
        s, m, n = self.s, self.m, self.n
        y1 = self._solve_coeffs(eta)
        y2 = np.empty_like(y1)
        for j in range(s):
            y2[j] = _tridiag_solve(self.alphas[j], self.betas[j], eta,
                                   y1[j])

        # C[t, j] = a_t . Kn^-1 a_j;  S2 = Kn^-2 Grams;  S3 = Kn^-3 Grams
        C = np.einsum("jkt,jk->tj", self.U, y1)
        S2 = np.einsum("ia,ijab,jb->ij", y1, self.G, y1)
        S3 = np.einsum("ia,ijab,jb->ij", y1, self.G, y2)
        S3 = 0.5 * (S3 + S3.T)

        B = 0.5 * (C[1:, 1:] + C[1:, 1:].T)
        Binv = np.linalg.inv(B)
        c = Binv @ C[0, 1:]
        w = np.concatenate([[1.0], -c])          # Mz = sum_j w_j u_j

        zMz = w @ C[:, 0]                        # z^T M z (Kn-scale)
        A = Binv @ S2[1:, 1:]                    # B^-1 X^T Kn^-2 X
        trace_Kninv = self.traces.traceinv(eta)
        trace_Kn2inv = self.traces.traceinv(eta, exponent=2)
        trace_M = trace_Kninv - np.trace(A)
        trace_M2 = (trace_Kn2inv - 2.0 * np.trace(Binv @ S3[1:, 1:])
                    + np.trace(A @ A))

        # zM3z = Mz^T Kn^-1 Mz - (Y^T Mz)^T B^-1 (Y^T Mz)
        MzKninvMz = w @ (S3 @ w)
        YtMz = S2[1:, :] @ w
        zM3z = MzKninvMz - YtMz @ (Binv @ YtMz)

        sigma2 = zMz / (n - m)
        return float((0.5 / sigma2) * ((trace_M2 / (n - m)
                                        + (trace_M / (n - m)) ** 2) * zMz
                                       - 2.0 * zM3z))

    def find_optimal_sigma(self, eta):
        st = self._eta_stats(eta)
        return float(np.sqrt(st["zMz"] / (self.n - self.m)))

    def log_likelihood(self, sigma, eta):
        """Profile-form lp (reference _profile_likelihood.py:76-78) with
        SLQ logdet."""
        st = self._eta_stats(eta)
        logdet_Kn = self.traces.logdet(eta)
        sign, logdet_B = np.linalg.slogdet(st["B"])
        return (-0.5 * (self.n - self.m) * np.log(sigma ** 2)
                - 0.5 * logdet_Kn - 0.5 * logdet_B
                - 0.5 / sigma ** 2 * st["zMz"])

    def solve_residual(self, eta):
        """Lanczos-solve residual norms per RHS: |beta_k * y_k| — the
        classic CG/Lanczos residual estimate. Diagnostics for choosing
        lanczos_steps."""
        y = self._solve_coeffs(eta)
        last_beta = self.betas[:, -1] if self.k > 1 else np.zeros(self.s)
        return np.abs(last_beta * y[:, -1])

    # -- MLE driver -------------------------------------------------------

    def fit(self, interval_eta=(1e-4, 1e3), tol=1e-6, max_iterations=100,
            scan_grid=29, verbose=False):
        """Root of d lp/d eta (reference find_log_likelihood_der1_zeros,
        _profile_likelihood.py:244-415), including the boundary-optimum
        fallback from the sign of d^2 lp/d eta^2 at eta = 0 (:352-405)
        when no bracket exists — low-noise data at large N picks the
        correct boundary instead of defaulting to the der1 signs.

        Root policy: dense-scan the whole log grid FIRST, refine
        EVERY adjacent sign change, and return the root with the best
        profile log-likelihood. der1 -> 0^- asymptotically as eta ->
        inf, so at the interval's right end its tiny true value can sit
        below the f32 factorization's noise floor and read the wrong
        sign — a bracket search that starts from the endpoints then
        converges to a SPURIOUS tail crossing while the real optimum
        sits decades earlier (observed at general-nu n=4096: fake root
        eta ~ 21 at lp far below the true eta ~ 0.22). Every candidate
        costs O(k^2) host math, so ranking by lp is free."""
        import warnings

        lo = float(np.log10(interval_eta[0]))
        hi = float(np.log10(interval_eta[1]))

        grid = np.linspace(lo, hi, int(scan_grid))
        vals = np.array([self.der1(g) for g in grid])
        # NaN lanes must register as NO sign change on either neighbor:
        # np.sign(NaN) = NaN compares unequal to everything, which would
        # otherwise spawn spurious Chandrupatla refinements around every
        # non-finite der1 value
        sg = np.sign(vals)
        finite_pair = np.isfinite(vals[:-1]) & np.isfinite(vals[1:])
        sign_change = np.nonzero(finite_pair & (sg[:-1] != sg[1:]))[0]

        candidates = []
        total_iters = 0
        for i in sign_change:
            i = int(i)
            root, iters = root_finding.chandrupatla_scalar(
                self.der1, float(grid[i]), float(grid[i + 1]),
                float(vals[i]), float(vals[i + 1]),
                tol=tol, max_iter=max_iterations)
            total_iters += int(iters)
            eta = 10.0 ** root
            st = self._eta_stats(eta)
            if not np.isfinite(st["zMz"]) or st["zMz"] <= 0:
                continue                     # numerically garbage root
            sigma = float(np.sqrt(st["zMz"] / (self.n - self.m)))
            lp = self.log_likelihood(sigma, eta)
            if not np.isfinite(lp):
                # max() keeps a NaN first element (NaN comparisons are
                # False both ways) — never let one in
                continue
            candidates.append((lp, eta, sigma))
            if verbose:
                print(f"root candidate: eta={eta:.5g} sigma={sigma:.5g} "
                      f"lp={lp:.4f}")
        if candidates:
            lp, eta, sigma = max(candidates, key=lambda c: c[0])
            return {"sigma": sigma, "sigma0": float(np.sqrt(eta) * sigma),
                    "eta": float(eta), "success": True,
                    "iterations": total_iters}

        # no sign change anywhere: boundary optimum from the sign of the
        # second derivative at eta = 0 (reference :352-405)
        fvals = [float(vals[0]), float(vals[-1])]
        f_left, f_right = fvals
        d2_zero = self.der2(0.0)
        if f_left > 0 and f_right > 0:
            eta = 0.0 if d2_zero > 0 else np.inf
        elif f_left < 0 and f_right < 0:
            eta = 0.0 if d2_zero < 0 else np.inf
        else:
            warnings.warn(
                "profile-likelihood derivative changes sign but no bracket "
                "was found (mixed signs at the interval ends): degenerate "
                "case, falling back to the eta = 0 boundary; widen "
                "interval_eta or raise scan_grid", stacklevel=2)
            eta = 0.0
        if eta == 0.0:
            sigma = self.find_optimal_sigma(0.0)
            return {"sigma": sigma, "sigma0": 0.0, "eta": 0.0,
                    "success": True, "iterations": 0}
        # eta -> inf: sigma = 0, sigma0 = OLS residual std
        return {"sigma": 0.0, "sigma0": float(self._sigma0_ols()),
                "eta": np.inf, "success": True, "iterations": 0}

    def _sigma0_ols(self):
        """Exact eta->inf boundary: sigma0^2 = OLS residual variance.

        As eta -> inf, Kn^-1 -> I/eta and the profile identities collapse
        to ordinary least squares on the mean model
        (reference _profile_likelihood.py:281-295 find_optimal_sigma0):
        sigma0^2 = (z'z - z'X (X'X)^-1 X'z) / (n - m), computed from the
        raw data Gram stored at factorization time — the degenerate
        low-noise boundary is exactly where a Krylov solve at a huge
        surrogate eta is least trustworthy, so no solve is involved."""
        if self.AtA is not None:
            ztz = self.AtA[0, 0]
            Xtz = self.AtA[1:, 0]
            XtX = self.AtA[1:, 1:]
            resid2 = ztz - Xtz @ np.linalg.solve(XtX, Xtz)
            return np.sqrt(max(resid2, 0.0) / (self.n - self.m))
        # factorization-only fallback (no raw Gram stored): Kn^-1 ~ I/eta
        eta = 1e12
        st = self._eta_stats(eta)
        sigma02 = st["zMz"] * eta / (self.n - self.m)
        return np.sqrt(sigma02)
