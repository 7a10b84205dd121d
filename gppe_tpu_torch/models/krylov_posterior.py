"""Matrix-free differentiable log-posterior surfaces over (eta, rho) and
(eta, rho, nu) at large n.

Counterpart of ``gppe_tpu.models.krylov_posterior``. The large-n work is
paid once, at a set of kernel nodes; what samplers evaluate afterwards
costs nothing that grows with n:

1. **Nodes.** The profile log-likelihood lp(eta, rho) is analytic in
   log10(rho) (and in log(nu)): Chebyshev-Lobatto nodes over the sampling
   box carry the large-n work.
2. **One batched Lanczos factorization per node** against the shared
   block [z, X | v_defl | probes]: at a closed-form nu the multi-rho
   kernel ``csrc/matern_multirho_mma.cu`` for a chunk of rho nodes a step
   (through ``grid_krylov._factorize_chunk_matrixfree``), at a general nu
   the general-nu kernel's batched product and trace
   (``_factorize_chunk_general_matrixfree``); any operator through
   ``operator_factory``. On a regular grid the (rho, nu) surface
   factorizes a chunk of nodes through one batched FFT product a step
   (:func:`_factorize_fft_chunk`, cuFFT), its general-nu offset tables on
   the general-nu kernel's elementwise entry.
3. **Ritz-space target.** Each tridiagonal is eigendecomposed on the host
   in float64 (:meth:`KrylovPosteriorSurface._build_ritz`, the
   reference's numpy, its per-node eigh loop and einsums as batched
   products); solves, Grams, logdet and the deflated
   control-variate trace quadrature become elementwise functions of
   (lambda + eta), exact in eta.
4. **Barycentric interpolation** across the nodes gives lp at any point.

The evaluation (``profile_loglik``, ``logdet``, the posterior targets) is
float64 torch on the surface's device, differentiable with
``torch.autograd`` and under ``torch.func.grad`` and ``torch.func.vmap``,
so a sampler evaluates many chains in one call.

The probe vectors are shared across nodes, so the Monte-Carlo error is a
smooth deterministic perturbation of the surface, not per-evaluation
noise (the reference's argument).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_kernels, kernels, operators, stochastic
from ..utils.config import resolve_device, setup
from .grid_krylov import (_factorize_chunk_general_matrixfree,
                          _factorize_chunk_matrixfree, _factorize_common)

F64 = torch.float64
# the Lanczos basis of a chunk of nodes, (k, n, B_c * C): the reference's
# budget (its GPPE_SURFACE_CHUNK_BYTES default)
SURFACE_CHUNK_BYTES = 3 << 30


def _cholesky_solve_small(A, b):
    """Batched SPD solve A x = b and log det A by a Cholesky factorization
    column by column.

    ``A``: (..., m, m) SPD with m small (the mean model's basis Gram, m ~
    6); ``b``: (..., m). Returns (x, logdet). Each column of L is a few
    batched operations (its sums over the earlier columns one product and
    sum), the two triangular solves ``torch.linalg.solve_triangular``:
    differentiable, valid under ``torch.func`` transforms, and few
    launches, which the samplers' gradients pay for on the card.

    A relative pivot floor, 1e-12 of the largest diagonal entry: a
    Krylov-approximated Gram at a numerically sick node can lose
    definiteness to float32 truncation noise, and one NaN node would
    poison every evaluation through the global barycentric interpolation.
    Healthy pivots sit far above the floor; a sick node gets a finite,
    local error. ``torch.linalg.cholesky`` raises there instead, so it is
    no substitute."""
    m = A.shape[-1]
    diag_max = torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)),
                          dim=-1)
    floor = 1e-12 * torch.clamp(diag_max, min=1e-300)
    cols = []                                # columns of L, each (..., m)
    for j in range(m):
        v = A[..., j:, j]                    # rows j.. of column j
        if j:
            prev = torch.stack(cols, dim=-1)[..., j:, :]   # (..., m - j, j)
            v = v - torch.sum(prev * prev[..., :1, :], dim=-1)
        d = torch.sqrt(torch.maximum(v[..., 0], floor))
        cols.append(F.pad(torch.cat([d[..., None], v[..., 1:] / d[..., None]],
                                    dim=-1), (j, 0)))
    L = torch.stack(cols, dim=-1)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             dim=-1)
    return x, logdet


def _chebyshev_lobatto(lo, hi, num):
    """Nodes (descending in [-1, 1] order, mapped to [lo, hi]), the standard
    barycentric weights (+-1, halved at the ends) and the [-1, 1] nodes."""
    j = np.arange(num)
    x = np.cos(np.pi * j / (num - 1))
    w = np.ones(num)
    w[0] = w[-1] = 0.5
    w *= (-1.0) ** j
    nodes = 0.5 * (lo + hi) + 0.5 * (hi - lo) * x
    return nodes, w, x


def _barycentric_weights(bary_w, x, xj):
    """w_j / (x - x_j) with exact node hits regularized: |x - x_j| below
    1e-13 is clamped to +-1e-13 keeping its sign before the division (the
    barycentric ratio tends to the node's value as x - x_j -> 0, so the
    clamp moves the result by O(1e-13)), so value and gradient stay
    finite there."""
    diff = x - xj
    safe = torch.where(torch.abs(diff) < 1e-13,
                       torch.where(diff < 0, -1e-13, 1e-13), diff)
    return bary_w / safe


def _factorize_operator(op, AB, k, s):
    """Factorize any operator with ``matmat`` (or a dense tensor) against
    the block AB: the Lanczos coefficients and the float64 projections
    U, G, P of one node."""
    matvec = op.matmat if hasattr(op, "matmat") else (lambda W: op @ W)
    alphas, betas, V = stochastic.lanczos(matvec, AB, k,
                                          reorthogonalize=True)
    Vs = V[:, :s]                                          # (k, s, n)
    n = Vs.shape[-1]
    U = stochastic.matmul_f64(Vs.reshape(k * s, n), AB[:, :s]).reshape(
        k, s, s).permute(1, 0, 2)
    Vm = Vs.permute(1, 0, 2).reshape(s * k, n)
    G = stochastic.gram_f64(Vm).reshape(s, k, s, k).permute(0, 2, 1, 3)
    P = stochastic.matmul_f64(V[:, s], AB[:, s + 1:])
    return alphas, betas, U, G, P


def _host(a):
    return a.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(
        a) else np.asarray(a, dtype=np.float64)


class KrylovPosteriorSurface:
    """Amortized differentiable profile-likelihood surface lp(eta, rho).

    Build once (O(B k) products at ``num_nodes`` rho values); then
    ``profile_loglik(log10_eta, log10_rho)`` costs nothing that grows with
    n. :meth:`make_log_posterior` and :meth:`make_bounded_log_posterior`
    give the samplers' targets.
    """

    def __init__(self, points, z, X, nu=0.5, log10_rho_bounds=(-1.5, -0.5),
                 num_nodes=12, lanczos_steps=64, num_probes=24, key=0,
                 block_rows=1024, operator_factory=None, verbose=False, *,
                 device="cuda", dtype=torch.float32, generator=None,
                 probes=None, v_defl=None,
                 chunk_bytes=SURFACE_CHUNK_BYTES):
        """``operator_factory``: optional ``rho -> operator`` (a
        ``MaternOperator``, ``TaperedMaternOperator``, ``GridMaternOperator``
        or any operator with ``matmat`` and ``trace_pow`` on ``device``);
        each node then factorizes through that operator, one at a time.
        Without it the nodes are batched in chunks whose Lanczos basis
        stays under ``chunk_bytes`` (a general nu also counts the general-
        nu product's slot scratch, as the grid engine does): a closed-form
        nu on the multi-rho kernel, a general nu on the general-nu
        kernel's batched product and trace. ``block_rows``: row blocking
        of their plain versions on the CPU.
        ``device``/``dtype``: where and in what the Lanczos passes run
        (the evaluation is float64 on ``device``). The random block: the
        Rademacher ``probes`` (n, num_probes) and ``v_defl`` (n, 1) as
        given, the rest drawn from ``generator``, else from a new one
        seeded with ``key`` (:func:`stochastic.random_block`)."""
        pts, z, X = self._setup(points, z, X, log10_rho_bounds,
                                lanczos_steps, num_probes, device)
        self.nu = cuda_kernels.check_nu(nu)

        nodes, bw, x_nodes = _chebyshev_lobatto(self.log10_rho_bounds[0],
                                                self.log10_rho_bounds[1],
                                                int(num_nodes))
        self.log10_rho_nodes = nodes                       # (B,)
        self._bary_w = torch.as_tensor(bw, dtype=F64, device=self.device)
        self._x_nodes = torch.as_tensor(x_nodes, dtype=F64,
                                        device=self.device)
        B = nodes.shape[0]

        AB, rhs_norms = self._block(z, X, key, dtype, generator, probes,
                                    v_defl)
        C = AB.shape[1]
        arrays = self._factorization_arrays(B, C)         # al, be, U, G, P
        tK2_all = np.empty(B)
        if operator_factory is not None:
            for b, lrho in enumerate(nodes):
                rho = 10.0 ** lrho
                if verbose:
                    print(f"krylov-posterior: node {b + 1}/{B} "
                          f"rho={rho:.5g} (n={self.n}, k={self.k})")
                op = operator_factory(rho)
                fact = _factorize_operator(op, AB, self.k, self.s)
                for out, a in zip(arrays, fact):
                    out[b] = _host(a)
                tK2_all[b] = float(op.trace_pow(2))
        else:
            general = not kernels.is_closed_form(self.nu)
            node_chunk = self._node_chunk(
                C, dtype, chunk_bytes - (cuda_kernels.GENERAL_SLOT_BYTES
                                         if general else 0))
            pts_dev = torch.as_tensor(pts, dtype=dtype,
                                      device=self.device).contiguous()
            rows = int(min(block_rows, self.n))
            for start in range(0, B, node_chunk):
                stop = min(start + node_chunk, B)
                if verbose:
                    print(f"krylov-posterior: nodes {start}..{stop - 1}/{B}"
                          f" batched (n={self.n}, k={self.k}"
                          f"{', general nu' if general else ''})")
                rhos = (10.0 ** nodes[start:stop]).tolist()
                if general:
                    fact = _factorize_chunk_general_matrixfree(
                        pts_dev, rhos, [self.nu] * len(rhos), AB, self.k,
                        self.s, rows)
                else:
                    fact = _factorize_chunk_matrixfree(
                        pts_dev, torch.as_tensor(rhos, dtype=dtype,
                                                 device=self.device),
                        self.nu, AB, self.k, self.s, rows)
                for out, a in zip(arrays + (tK2_all,), fact):
                    out[start:stop] = _host(a)
        self._build_ritz(*arrays, tK2_all, rhs_norms,
                         np.full(self.p, float(self.n)))

    def _setup(self, points, z, X, log10_rho_bounds, lanczos_steps,
               num_probes, device):
        """What both surfaces set up alike: the device, the sizes (n, m,
        s = m + 1, k, p) and the rho bounds. Returns the points, z and X
        as float64 arrays."""
        setup()
        self.device = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        self.n, self.m = X.shape
        self.s = self.m + 1
        self.k = int(min(lanczos_steps, self.n))
        self.p = int(num_probes)
        self.log10_rho_bounds = (float(log10_rho_bounds[0]),
                                 float(log10_rho_bounds[1]))
        return (np.asarray(points, dtype=np.float64),
                np.asarray(z, dtype=np.float64), X)

    def _node_chunk(self, C, dtype, budget):
        """Nodes a chunk: as many as keep the chunk's Lanczos basis (k, n,
        nodes * C) in ``dtype`` under ``budget`` bytes, at least one."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        return max(1, budget // max(self.k * self.n * C * itemsize, 1))

    def _factorization_arrays(self, B, C):
        """Host float64 arrays for B nodes' alphas (B, C, k), betas
        (B, C, k-1), U (B, s, k, s), G (B, s, s, k, k) and P (B, k, p)."""
        k, s = self.k, self.s
        return (np.empty((B, C, k)), np.empty((B, C, k - 1)),
                np.empty((B, s, k, s)), np.empty((B, s, s, k, k)),
                np.empty((B, k, self.p)))

    def _block(self, z, X, key, dtype, generator, probes, v_defl):
        """The shared block [z, X | v_defl | probes] on the device in
        ``dtype``, and the norms of [z, X]'s columns."""
        A = np.concatenate([z[:, None], X], axis=1)
        probes, v_defl = stochastic.random_block(
            self.n, self.p, key, self.device, dtype, generator, probes,
            v_defl)
        AB = torch.cat([torch.as_tensor(A, dtype=dtype, device=self.device),
                        v_defl, probes], dim=1)
        return AB, np.linalg.norm(A, axis=0)

    # -- host: eigendecompose the tridiagonals, precompute constants ------

    def _build_ritz(self, al, be, U, G, P, tK2, rhs_norms, probe_norm2):
        """The reference's host float64 numpy: the Ritz decomposition of
        every node's tridiagonals (one batched eigh), the solve block in
        the eigenbasis (batched products where the reference has einsums:
        at 81 nodes its 5-index einsum alone takes seconds), the one-pass
        deflation and the control-variate regression collapsed into fixed
        quadrature weights."""
        B, C, k = al.shape
        s, p, n = self.s, self.p, self.n
        T = np.zeros((B, C, k, k))
        i = np.arange(k)
        T[..., i, i] = al
        T[..., i[:-1], i[1:]] = be
        T[..., i[1:], i[:-1]] = be
        lam, Q = np.linalg.eigh(T)                          # batched
        # K is PSD: clip float32-roundoff negatives
        lam = np.maximum(lam, 0.0)

        # solve block in the eigenbasis: c_j(eta) = e1w_j / (lam_j + eta)
        e1w = Q[:, :s, 0, :] * rhs_norms[None, :, None]     # (B, s, k)
        Qs = Q[:, :s]
        # Ut[b, j] = Q_j^T U_j; Gt[b, i, j] = Q_i^T G_ij Q_j (the
        # reference's einsums, as batched products)
        Ut = np.matmul(Qs.transpose(0, 1, 3, 2), U)
        Gt = np.matmul(np.matmul(Qs.transpose(0, 1, 3, 2)[:, :, None], G),
                       Qs[:, None])

        # probe quadrature nodes and weights (probe chains: columns s+1..C)
        theta = lam[:, s + 1:, :]                           # (B, p, k)
        tau = Q[:, s + 1:, 0, :] ** 2                       # (B, p, k)

        # one-pass deflation from the dedicated chain (column s): the
        # converged Ritz pairs (mu_t, w_t) of the deflation chain, each
        # probe's overlap c_it = (v_i . w_t)^2 from the stored basis
        # overlaps P; F_i - sum_t c_it f(mu_t + eta) is unbiased for
        # trace f - sum_t f(mu_t + eta)
        mu_all = lam[:, s, :]
        mus, cits = [], []
        qmax = 0
        for b in range(B):
            Td_Q = Q[b, s]
            resid = (np.abs(be[b, s, -1]) * np.abs(Td_Q[-1, :])
                     if k > 1 else np.zeros(k))
            tol_r = 1e-3 * max(mu_all[b].max(), 1.0)
            # both spectral ends: the top drives logdet variance, the
            # bottom traceinv at small eta
            order_hi = np.argsort(mu_all[b])[::-1]
            order_lo = np.argsort(mu_all[b])
            keep, seen = [], set()
            for pair in zip(order_hi, order_lo):
                for t in pair:
                    if resid[t] < tol_r and t not in seen:
                        seen.add(t)
                        keep.append(t)
            keep = np.asarray(keep, dtype=int)
            vw = P[b].T @ Td_Q[:, keep] if keep.size else np.zeros((p, 0))
            mus.append(mu_all[b][keep])
            cits.append(vw ** 2)                            # (p, q_b)
            qmax = max(qmax, keep.size)

        # control-variate regression on the deflated estimates, collapsed
        # to fixed linear weights omega over the probes
        M = np.stack([np.full(B, float(n)), np.full(B, float(n)), tK2],
                     axis=1)
        n_nodes = p * k + qmax
        qnodes = np.ones((B, n_nodes))
        qweights = np.zeros((B, n_nodes))
        for b in range(B):
            mu_b, cit = mus[b], cits[b]
            q_b = mu_b.shape[0]
            mq_raw = np.stack([
                probe_norm2 * tau[b].sum(axis=1),
                probe_norm2 * (tau[b] * theta[b]).sum(axis=1),
                probe_norm2 * (tau[b] * theta[b] ** 2).sum(axis=1),
            ], axis=1)                                      # (p, 3)
            mu_pows = np.stack([np.ones_like(mu_b), mu_b, mu_b ** 2],
                               axis=1)                      # (q_b, 3)
            mq = mq_raw - cit @ mu_pows
            Mb = M[b] - mu_pows.sum(axis=0)
            Xc = mq - mq.mean(axis=0, keepdims=True)
            Gm = Xc.T @ Xc
            Gm += 1e-12 * np.trace(Gm) / 3.0 * np.eye(3)
            Pm = np.linalg.solve(Gm, Xc.T)                  # (3, p)
            r = Mb - mq.mean(axis=0)
            qw = Pm.T @ r
            omega = qw + (1.0 - qw.sum()) / p
            # trace f ~= sum_i omega_i F_i
            #           + sum_t (1 - sum_i omega_i c_it) f(mu_t + eta)
            w_probe = omega[:, None] * probe_norm2[:, None] * tau[b]
            gamma = 1.0 - omega @ cit
            qnodes[b, :p * k] = theta[b].ravel()
            qweights[b, :p * k] = w_probe.ravel()
            qnodes[b, p * k:p * k + q_b] = mu_b
            qweights[b, p * k:p * k + q_b] = gamma

        def dev(a):
            return torch.as_tensor(a, dtype=F64, device=self.device)

        self._lam_s = dev(lam[:, :s])                       # (B, s, k)
        self._e1w = dev(e1w)
        self._Ut = dev(Ut)
        self._Gt = dev(Gt)
        self._qnodes = dev(qnodes)                          # (B, M)
        self._qweights = dev(qweights)

    # -- per-evaluation math (float64 torch, differentiable) --------------

    def _f64(self, x):
        """A number or tensor as a float64 tensor on the surface's device
        (a tensor keeps its autograd and ``torch.func`` state)."""
        if torch.is_tensor(x):
            return x.to(dtype=F64, device=self.device)
        return torch.tensor(float(x), dtype=F64, device=self.device)

    def _node_stats(self, eta):
        """Per-node ingredients at one eta, all (B, ...): zMz, the SLQ
        logdet of K + eta I and the logdet of the basis Gram B."""
        c1 = self._e1w / (self._lam_s + eta)                  # (B, s, k)
        # Cm[b, t, j] = sum_k Ut[b, j, k, t] c1[b, j, k] as a product and
        # sum, not an einsum: under vmap the einsum becomes a batched GEMM
        # (and its backward another) that sums in another order than the
        # lone evaluation's matrix-vector products
        Cm = torch.sum(self._Ut * c1[..., None], dim=2).transpose(1, 2)
        Bm = Cm[:, 1:, 1:]
        Bm = 0.5 * (Bm + Bm.transpose(1, 2))                  # (B, m, m)
        Ytz = Cm[:, 0, 1:]                                    # (B, m)
        zw = Cm[:, 0, 0]
        c, logdet_B = _cholesky_solve_small(Bm, Ytz)
        zMz = zw - torch.sum(Ytz * c, dim=-1)
        return zMz, self._node_logdet(eta), logdet_B

    def _node_logdet(self, eta):
        """SLQ logdet(K + eta I) per node: the fixed deflated-CV
        quadrature (see :meth:`_build_ritz`)."""
        return torch.sum(self._qweights * torch.log(
            torch.clamp(self._qnodes + eta, min=1e-300)), dim=1)

    def _node_lp(self, eta):
        """Profile lp per node (B,) at one eta, sigma profiled out (the
        reference's profile form, _profile_likelihood.py:76-85)."""
        n, m = self.n, self.m
        zMz, logdet_Kn, logdet_B = self._node_stats(eta)
        sigma2 = zMz / (n - m)
        return (-0.5 * (n - m) * torch.log(sigma2) - 0.5 * logdet_Kn
                - 0.5 * logdet_B - 0.5 * (n - m))

    def _interp(self, vals, log10_rho):
        """Second barycentric formula over the rho nodes (float64)."""
        lo, hi = self.log10_rho_bounds
        x = 2.0 * (self._f64(log10_rho) - 0.5 * (lo + hi)) / (hi - lo)
        w = _barycentric_weights(self._bary_w, x, self._x_nodes)
        return torch.sum(w * vals) / torch.sum(w)

    def profile_loglik(self, log10_eta, log10_rho):
        """lp at (log10 eta, log10 rho): a float64 0-d tensor on the
        device, differentiable, its cost independent of n."""
        eta = torch.pow(10.0, self._f64(log10_eta))
        return self._interp(self._node_lp(eta), log10_rho)

    def logdet(self, log10_eta, log10_rho):
        """Interpolated SLQ logdet(K + eta I) (diagnostics)."""
        eta = torch.pow(10.0, self._f64(log10_eta))
        return self._interp(self._node_logdet(eta), log10_rho)

    # -- posterior targets --------------------------------------------------

    def make_log_posterior(self, log_prior=None):
        """theta = [log10_eta, log10_rho] -> log posterior, with the
        change-of-variables Jacobian to log10 coordinates when a
        ``log_prior(eta, rho)`` (natural parameters) is given."""
        ln10 = math.log(10.0)

        def log_post(theta):
            l_eta, l_rho = theta[0], theta[1]
            val = self.profile_loglik(l_eta, l_rho)
            if log_prior is not None:
                val = val + log_prior(torch.pow(10.0, l_eta),
                                      torch.pow(10.0, l_rho))
                val = val + (l_eta + l_rho) * ln10
            return val

        return log_post

    def _bounded(self, log_post_theta, lo, hi):
        lo = torch.as_tensor(lo, dtype=F64, device=self.device)
        hi = torch.as_tensor(hi, dtype=F64, device=self.device)
        margin = 1e-6

        def u_to_theta(u):
            s = margin + (1.0 - 2.0 * margin) * torch.sigmoid(
                self._f64(u))
            return lo + (hi - lo) * s

        def log_post_u(u):
            u = self._f64(u)
            theta = u_to_theta(u)
            log_jac = torch.sum(torch.log(hi - lo)
                                + math.log1p(-2.0 * margin)
                                + F.logsigmoid(u) + F.logsigmoid(-u))
            return log_post_theta(theta) + log_jac

        return log_post_u, u_to_theta

    def make_bounded_log_posterior(self, log10_eta_bounds=(-3.0, 3.0),
                                   log_prior=None):
        """Unconstrained sigmoid-transformed target over the
        (log10 eta, log10 rho) box, the rho box being the nodes' range.
        Returns (log_post_u, u_to_theta)."""
        return self._bounded(
            self.make_log_posterior(log_prior=log_prior),
            [log10_eta_bounds[0], self.log10_rho_bounds[0]],
            [log10_eta_bounds[1], self.log10_rho_bounds[1]])


def _factorize_fft_chunk(chat_b, to_raster, from_raster, tk2_b, AB, k, s,
                         ms):
    """Batched Krylov factorization of a chunk of (rho, nu) nodes through
    exact FFT products: each Lanczos step multiplies the chunk's B spectra
    ``chat_b`` (B, 2 m_1, ..., m_d + 1) in one batched (B, r, 2 m_1, ...,
    2 m_d) transform pair (``operators._grid_matern_matmat_fft``), through
    the grid engine's shared factorization. ``tk2_b``: the nodes' exact
    trace(K^2), float64."""
    def bmv(W):                                            # (B, n, r)
        return operators._grid_matern_matmat_fft(W, chat_b, to_raster,
                                                 from_raster, ms)

    return _factorize_common(AB, chat_b.shape[0], k, s, bmv, lambda: tk2_b)


def _matern_tables(base_dist, rho_flat, nu_flat, dtype):
    """Per-node Matern offset tables (B, *ms), float64 on ``base_dist``'s
    device: ``base_dist`` the unit-scale offset distances (float64), each
    node's table k(base_dist / rho; nu) by the rule of
    :func:`operators.grid_kernel_table` for nodes of ``dtype``: for float32
    nodes one launch of the general-nu kernel's elementwise entry per
    distinct general nu, over the stacked tables of that nu's rhos; for
    float64 nodes the float64 ``kernels.matern``."""
    rho_flat = np.asarray(rho_flat, dtype=np.float64)
    nu_flat = np.asarray(nu_flat, dtype=np.float64)
    out = torch.empty((len(rho_flat),) + tuple(base_dist.shape), dtype=F64,
                      device=base_dist.device)
    for nu in np.unique(nu_flat):
        idx = np.nonzero(nu_flat == nu)[0]
        rhos = torch.as_tensor(rho_flat[idx], dtype=F64,
                               device=base_dist.device)
        dist = base_dist / rhos.reshape((-1,) + (1,) * base_dist.ndim)
        out[torch.as_tensor(idx, device=base_dist.device)] = \
            operators.grid_kernel_table(dist, float(nu), dtype)
    return out


class KrylovPosteriorSurfaceRhoNu(KrylovPosteriorSurface):
    """Amortized differentiable profile-likelihood surface over the full
    (eta, rho, nu) hyperparameter space at large n, on a regular grid.

    Counterpart of ``gppe_tpu.models.krylov_posterior
    .KrylovPosteriorSurfaceRhoNu``:

    1. **Tensor Chebyshev-Lobatto nodes** over (log10 rho, log nu): lp is
       analytic in both, and the nu axis lives in log(nu), where the
       kernel changes.
    2. **Exact FFT products at every node**: the data lie on a regular
       grid, so each node's Lanczos factorization runs through the
       circulant-embedding FFT operator, a chunk of nodes a batched
       transform per step. The offset tables k(d / rho; nu) are evaluated
       once per node on the device from the shared unit-scale table, the
       general nus of float32 nodes on the general-nu kernel's elementwise
       entry, one launch per distinct nu.
    3. **Ritz-space target and 2-D barycentric interpolation**: the
       parent's eta-exact quadrature; lp at any (eta, rho, nu) costs
       nothing that grows with n.

    Float32 nodes bias lp high in the smooth-kernel, small-eta regime (the
    reference measured +11-14 nats at eta ~ 3 and +27-37 at eta ~ 1-1.8
    against float64 oracles at n = 100,489, the eta >= 10 bulk within ~3
    nats), hence ``make_bounded_log_posterior``'s eta box from -0.5.
    ``node_dtype=torch.float64`` removes the float32 truncation and runs
    on the card (the reference ran it on the host CPU).
    """

    def __init__(self, points, z, X, log10_rho_bounds=(-1.0, -0.4),
                 nu_bounds=(1.0, 25.0), num_rho_nodes=9, num_nu_nodes=9,
                 lanczos_steps=48, num_probes=24, key=0, dtype=torch.float32,
                 node_dtype=None, verbose=False, *, device="cuda",
                 generator=None, probes=None, v_defl=None,
                 chunk_bytes=SURFACE_CHUNK_BYTES):
        """``lanczos_steps`` 48 by default: in float32 at n = 10^5 the
        reference measured k = 64 degrading the bulk (+14 nats at a
        validated probe against +-2 at k = 48) once the solve residuals
        reach the float32 floor.

        ``node_dtype``: dtype of the node factorizations and of the FFT
        products (default ``dtype``); ``torch.float64`` takes float64
        tables (:func:`_matern_tables`) and float64 Lanczos passes on the
        device. ``chunk_bytes``: the budget of a chunk's Lanczos basis.
        The rest as :class:`KrylovPosteriorSurface`."""
        pts, z, X = self._setup(points, z, X, log10_rho_bounds,
                                lanczos_steps, num_probes, device)
        node_dtype = node_dtype or dtype
        self.nu_bounds = (float(nu_bounds[0]), float(nu_bounds[1]))

        rho_nodes, bw_r, _ = _chebyshev_lobatto(
            self.log10_rho_bounds[0], self.log10_rho_bounds[1],
            int(num_rho_nodes))
        t_nodes, bw_n, _ = _chebyshev_lobatto(
            math.log(self.nu_bounds[0]), math.log(self.nu_bounds[1]),
            int(num_nu_nodes))
        self.log10_rho_nodes = rho_nodes                   # (Br,)
        self.log_nu_nodes = t_nodes                        # (Bn,)
        self._bary_w_rho = torch.as_tensor(bw_r, dtype=F64,
                                           device=self.device)
        self._bary_w_nu = torch.as_tensor(bw_n, dtype=F64,
                                          device=self.device)
        self._rho_nodes = torch.as_tensor(rho_nodes, dtype=F64,
                                          device=self.device)
        self._t_nodes = torch.as_tensor(t_nodes, dtype=F64,
                                        device=self.device)
        Br, Bn = rho_nodes.shape[0], t_nodes.shape[0]
        self.Br, self.Bn = Br, Bn
        B = Br * Bn
        # flattened node order: b = ir * Bn + inu (rho-major)
        rho_flat = np.repeat(10.0 ** rho_nodes, Bn)
        nu_flat = np.tile(np.exp(t_nodes), Br)

        # exact FFT tables per node on the shared grid, on the device
        ms, hs, to_raster, from_raster = operators.grid_geometry(pts)
        base = torch.as_tensor(operators.grid_distance_table(ms, hs, 1.0),
                               device=self.device)
        k_tabs = _matern_tables(base, rho_flat, nu_flat, node_dtype)
        tk2 = operators.grid_trace_pow2(k_tabs, ms)        # (B,)
        chat_b = operators.circulant_rfft(k_tabs.to(node_dtype), ms)
        del k_tabs, base
        to_r = torch.as_tensor(to_raster, device=self.device)
        from_r = torch.as_tensor(from_raster, device=self.device)

        AB, rhs_norms = self._block(z, X, key, node_dtype, generator,
                                    probes, v_defl)
        C = AB.shape[1]
        node_chunk = self._node_chunk(C, node_dtype, chunk_bytes)
        arrays = self._factorization_arrays(B, C)
        for start in range(0, B, node_chunk):
            stop = min(start + node_chunk, B)
            if verbose:
                print(f"rho-nu surface: nodes {start}..{stop - 1}/{B} "
                      f"(n={self.n}, k={self.k}, fft, {node_dtype})")
            fact = _factorize_fft_chunk(chat_b[start:stop], to_r, from_r,
                                        tk2[start:stop], AB, self.k, self.s,
                                        ms)
            for out, a in zip(arrays, fact):
                out[start:stop] = _host(a)
        self._build_ritz(*arrays, _host(tk2), rhs_norms,
                         np.full(self.p, float(self.n)))

    # -- 2-D tensor barycentric interpolation -----------------------------

    def _interp2(self, vals, log10_rho, nu):
        """Second barycentric formula along each axis of the flattened
        (Br * Bn,) node values: the nu axis (in log nu) per rho row, then
        the rho axis; exact node hits regularized as the parent's."""
        V = vals.reshape(self.Br, self.Bn)
        w_t = _barycentric_weights(self._bary_w_nu, torch.log(self._f64(nu)),
                                   self._t_nodes)
        # an elementwise product and sum, not V @ w_t: under vmap the
        # backward of a matrix-vector product becomes a batched GEMM that
        # sums in another order than a lone evaluation's
        rows = torch.sum(V * w_t, dim=1) / torch.sum(w_t)  # (Br,)
        w_x = _barycentric_weights(self._bary_w_rho, self._f64(log10_rho),
                                   self._rho_nodes)
        return torch.sum(w_x * rows) / torch.sum(w_x)

    def profile_loglik(self, log10_eta, log10_rho, nu):
        """lp at (log10 eta, log10 rho, nu): differentiable in all three,
        its cost independent of n."""
        eta = torch.pow(10.0, self._f64(log10_eta))
        return self._interp2(self._node_lp(eta), log10_rho, nu)

    def logdet(self, log10_eta, log10_rho, nu):
        """Interpolated SLQ logdet(K + eta I) (diagnostics)."""
        eta = torch.pow(10.0, self._f64(log10_eta))
        return self._interp2(self._node_logdet(eta), log10_rho, nu)

    # -- posterior targets --------------------------------------------------

    def make_log_posterior(self, log_prior=None):
        """theta = [log10_eta, log10_rho, nu] -> log posterior.
        ``log_prior(eta, rho, nu)`` in natural parameters; the log10
        Jacobian applies to eta and rho only (nu is sampled in natural
        units, as the reference sweeps it)."""
        ln10 = math.log(10.0)

        def log_post(theta):
            l_eta, l_rho, nu = theta[0], theta[1], theta[2]
            val = self.profile_loglik(l_eta, l_rho, nu)
            if log_prior is not None:
                val = val + log_prior(torch.pow(10.0, l_eta),
                                      torch.pow(10.0, l_rho), nu)
                val = val + (l_eta + l_rho) * ln10
            return val

        return log_post

    def make_bounded_log_posterior(self, log10_eta_bounds=(-0.5, 4.0),
                                   log_prior=None):
        """Unconstrained sigmoid-transformed target over the
        (log10 eta, log10 rho, nu) box, the rho and nu boxes the nodes'
        ranges; the eta box from -0.5 by default (the float32 small-eta
        bias, see the class docstring). Returns (log_post_u, u_to_theta)."""
        return self._bounded(
            self.make_log_posterior(log_prior=log_prior),
            [log10_eta_bounds[0], self.log10_rho_bounds[0],
             self.nu_bounds[0]],
            [log10_eta_bounds[1], self.log10_rho_bounds[1],
             self.nu_bounds[1]])
