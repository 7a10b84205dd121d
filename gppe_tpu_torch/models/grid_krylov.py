"""Grid-batched Krylov profile likelihood: many (rho, nu) fits, one pass.

Counterpart of ``gppe_tpu.models.grid_krylov``. The flagship workload is an
outer sweep over kernel parameters - a grid of INDEPENDENT likelihood
maximizations. ``models.large_scale.KrylovProfileLikelihood`` amortizes the
eta-dependence of ONE kernel; this module amortizes the *grid*:

1. A chunk of rho kernels becomes ONE batched Lanczos pass against the
   shared augmented block [z, X | v_defl | probes]. Small n materializes
   the (b, n, n) chunk once; large n runs MATRIX-FREE - the multi-rho
   kernel (:func:`gppe_tpu_torch.ops.cuda_kernels.matern_matmat_multirho`,
   hand-written CUDA on the card, its plain version on the CPU) evaluates
   K(rho_b) @ W_b for the whole rho batch from one set of points, so the
   grid path reaches the same n as the single-operator engine.
2. Each grid point gets a lightweight host engine
   (``KrylovProfileLikelihood.from_factorization``) whose per-eta math is
   O(k^2) float64: the root-find over eta costs microseconds per point.

A grid whose points share one closed-form ``nu_static`` takes the
multi-rho kernel (matrix-free) or one closed-form assembly per rho (dense).
Any other grid - ``nu_static=None`` with per-point ``nus``, as the
reference's (rho, nu) sweeps run it, or a general ``nu_static`` - takes
the general-nu kernel ``csrc/matern_general.cu``, where the reference's
general branch maps its row-blocked XLA matvec over the chunk's points:
the matrix-free chunk's product is one batched call per Lanczos step for
all its points (:func:`cuda_kernels.matern_general_matmat_batched`, a
launch per band of its walk), its traces one batched launch
(:func:`cuda_kernels.matern_general_trace_batched`), as the reference
maps its trace over the chunk. The dense chunk of any grid
assembles each K(rho, nu) once - its general nus in one launch of the
assembly entry (:func:`gppe_tpu_torch.ops.cuda_kernels.matern_general_assemble`)
- and multiplies with ``torch.matmul``. On the CPU they run their plain versions.
"""

import numpy as np
import torch

from ..ops import assembly, cuda_kernels, kernels, stochastic
from ..utils.config import resolve_device, setup
from .large_scale import KrylovProfileLikelihood


def _factorize_chunk(points, rhos, nus, AB, k, s):
    """Dense variant (small n): each K(rho, nu) of the chunk assembled
    ONCE (a closed form in plain PyTorch, the general nus in one launch of
    the general-nu kernel's assembly entry:
    ``assembly.correlations_of_points``), then the shared batched
    factorization with plain batched matmuls as the matvec."""
    Ks = assembly.correlations_of_points(points, rhos, nus)  # (B, n, n)
    return _factorize_common(AB, len(rhos), k, s,
                             lambda W: torch.matmul(Ks, W),
                             lambda: torch.sum(Ks * Ks, dim=(1, 2)))


def _factorize_chunk_general_matrixfree(points, rhos, nus, AB, k, s,
                                        block_rows):
    """Matrix-free variant over per-point (rho, nu): each Lanczos step
    runs the general-nu product kernel for all the chunk's points at once
    (a launch per band and 32 columns), and one trace launch for all of
    them follows; ``block_rows`` is the row blocking of their plain
    version on the CPU."""
    scales = torch.as_tensor(rhos, dtype=points.dtype, device=points.device)

    def bmv(W):                                             # (B, n, r)
        return cuda_kernels.matern_general_matmat_batched(
            points, scales, W.contiguous(), nus, block_rows=block_rows)

    def tk2():
        return cuda_kernels.matern_general_trace_batched(
            points, scales, nus, block_rows=block_rows)

    return _factorize_common(AB, len(rhos), k, s, bmv, tk2)


def _factorize_chunk_matrixfree(points, rhos, nu, AB, k, s, block_rows):
    """Matrix-free variant: no (b, n, n) tensor ever exists. The matvec
    and the trace(K_b^2) pass are the multi-rho kernel (one launch per
    Lanczos step for the whole rho batch, one trace-only launch);
    ``block_rows`` is the row blocking of its plain version on the CPU."""
    def bmv(W):                                             # (B, n, r)
        return cuda_kernels.matern_matmat_multirho(
            points, rhos, W.contiguous(), nu, block_rows=block_rows)

    def tk2():
        return cuda_kernels.matern_matmat_multirho(
            points, rhos, None, nu, return_frobenius=True,
            block_rows=block_rows)[1]

    return _factorize_common(AB, rhos.shape[0], k, s, bmv, tk2)


def _factorize_common(AB, B, k, s, bmv, tk2):
    """Shared chunk factorization: ONE batched Lanczos pass over all B
    kernels x all RHS columns, then the per-point small projections.

    The (B, n, r) problem is flattened to (n, B*r) so the batched Lanczos
    (ops.stochastic.lanczos - columns are independent runs) drives any
    batched matvec unchanged. Lanczos holds its block as (B*r, n), so
    ``bmv`` sees a strided (B, n, r) view of it; the matrix-free matvec
    copies it to a contiguous one, and its product is copied back (51 MB
    each way at n = 10^5, B*r = 128: a fraction of a millisecond beside a
    200 ms product).

    Returns (alphas (B, r, k), betas (B, r, k-1), U (B, s, k, s),
    G (B, s, s, k, k), P (B, k, p), trace_K2 (B,)) on AB's device, float64
    but for trace_K2 on the CPU path."""
    n, r = AB.shape

    def mv_flat(Q):                                         # (n, B*r)
        Wb = bmv(Q.reshape(n, B, r).permute(1, 0, 2))
        return Wb.permute(1, 0, 2).reshape(n, B * r)

    flat0 = AB[:, None, :].expand(n, B, r).reshape(n, B * r)
    alphas, betas, V = stochastic.lanczos(mv_flat, flat0, k,
                                          reorthogonalize=True)
    alphas = alphas.reshape(B, r, k)
    betas = betas.reshape(B, r, k - 1)
    Vb = V.reshape(k, B, r, n)
    # float64 projections (see stochastic.gram_f64/matmul_f64): float32
    # O(n) reductions would bias the per-eta math by ~sqrt(n)*eps
    Vs = Vb[:, :, :s].to(torch.float64)                     # (k, B, s, n)
    AB64 = AB.to(torch.float64)
    U = (Vs.reshape(k * B * s, n) @ AB64[:, :s]).reshape(
        k, B, s, s).permute(1, 2, 0, 3)                     # (B, j, k, t)
    # one kernel's Gram at a time: the (s*k, n) operand is a copy
    G = torch.stack([stochastic.gram_f64(
        Vs[:, b].permute(1, 0, 2).reshape(s * k, n)) for b in range(B)])
    G = G.reshape(B, s, k, s, k).permute(0, 1, 3, 2, 4)
    P = stochastic.matmul_f64(
        Vb[:, :, s].reshape(k * B, n), AB64[:, s + 1:]).reshape(
        k, B, -1).permute(1, 0, 2)                          # (B, k, p)
    del V, Vb, Vs  # free the basis before the trace pass
    return alphas, betas, U, G, P, tk2()


def engines_from_factorization(alphas, betas, U, G, P, trace_K2, rhs_norms,
                               n, m, AtA=None):
    """Per-point host engines from one chunk's factorization.

    The arguments are the arrays :func:`_factorize_common` returns (numpy
    or anything ``np.asarray`` takes; a ``gppe_tpu`` chunk's arrays work as
    well): ``alphas`` (B, r, k), ``betas`` (B, r, k-1) over the block
    columns [z, X | v_defl | probes], ``U`` (B, s, k, s), ``G``
    (B, s, s, k, k), ``P`` (B, k, p), ``trace_K2`` (B,). Returns a list of
    B ``KrylovProfileLikelihood`` engines, each with the deflated
    quadrature of its own kernel as its trace engine."""
    al, be, U, G, P, tK2 = (np.asarray(a, dtype=np.float64) for a in (
        alphas, betas, U, G, P, trace_K2))
    s = int(m) + 1
    probe_norm2 = np.full(P.shape[2], float(n))             # Rademacher
    engines = []
    for i in range(al.shape[0]):
        nodes, weights = stochastic.deflated_quadrature(
            al[i, s], be[i, s], al[i, s + 1:], be[i, s + 1:], P[i],
            probe_norm2, n, trace_K2=tK2[i])
        traces = stochastic.QuadratureTraceEngine(nodes, weights, n)
        engines.append(KrylovProfileLikelihood.from_factorization(
            al[i, :s], be[i, :s], U[i], G[i], rhs_norms, traces, n, m,
            AtA=AtA))
    return engines


class GridKrylovProfileLikelihood:
    """Batched profile-likelihood MLE over a set of (rho, nu) kernels."""

    def __init__(self, points, X, z, rhos, nus, nu_static=None,
                 lanczos_steps=50, num_probes=8, key=0, chunk=None,
                 max_chunk_bytes=2 << 30, matrix_free=None, block_rows=512,
                 verbose=False, *, device="cuda", dtype=torch.float32,
                 generator=None, probes=None, v_defl=None):
        """``rhos``/``nus``: flat arrays of equal length (one entry per
        grid point). ``nu_static``: the one nu every point shares (then
        ``nus`` is not read); a closed form (0.5, 1.5, 2.5, >= 100) takes
        the multi-rho kernel, None or a general nu the general-nu kernel
        (matrix-free: one batched product call per step for the chunk).
        ``chunk``: kernels per batch (default sized so that the chunk's
        Lanczos basis, and the general-nu product's slot scratch, stay
        under ``max_chunk_bytes``). ``matrix_free``: never materialize the
        (b, n, n) kernel chunk; default auto: dense below n=8192,
        matrix-free above. ``block_rows``: row blocking of the matrix-free
        matvec's plain version on the CPU.
        ``device``/``dtype``/``generator``/``probes``/``v_defl``: as in
        :class:`KrylovProfileLikelihood` - where and in what the Lanczos
        pass runs, and the random block, drawn from ``generator`` (else
        from a new one seeded with ``key``) unless given explicitly."""
        setup()
        if nu_static is not None:
            nu_static = cuda_kernels.check_nu(nu_static)
        general = nu_static is None or not kernels.is_closed_form(nu_static)
        device = resolve_device(device)
        points = np.asarray(points, dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        self.n, self.m = X.shape
        self.s = self.m + 1
        self.k = int(min(lanczos_steps, self.n))
        self.rhos = np.atleast_1d(np.asarray(rhos, dtype=float))
        self.nus = np.atleast_1d(np.asarray(nus, dtype=float))
        if self.rhos.shape != self.nus.shape:
            raise ValueError("rhos and nus must have equal length "
                             "(flat per-point arrays)")
        self.num_points = self.rhos.shape[0]
        point_nus = (self.nus if nu_static is None
                     else np.full(self.num_points, nu_static))
        for nu in point_nus:
            cuda_kernels.check_nu(nu)

        A = np.concatenate([z[:, None], X], axis=1)
        self.rhs_norms = np.linalg.norm(A, axis=0)
        AtA = A.T @ A       # exact eta->inf OLS boundary (shared by all
        # grid points: the data never changes, only the kernel)
        probes, v_defl = stochastic.random_block(
            self.n, num_probes, key, device, dtype, generator, probes, v_defl)
        # block layout: [z, X | deflation chain | probes]
        AB = torch.cat([torch.as_tensor(A, dtype=dtype, device=device),
                        v_defl, probes], dim=1)

        if matrix_free is None:
            matrix_free = self.n > 8192
        self.matrix_free = bool(matrix_free)

        itemsize = torch.empty((), dtype=dtype).element_size()
        if chunk is None:
            budget = max_chunk_bytes
            if self.matrix_free:
                # the live chunk memory is the Lanczos basis storage
                # (k, n, B * r), and the general-nu product's slot scratch
                # (at most GENERAL_SLOT_BYTES): size B so they stay under
                # the budget
                bytes_per_k = self.k * self.n * AB.shape[1] * itemsize
                if general:
                    budget -= cuda_kernels.GENERAL_SLOT_BYTES
            else:
                bytes_per_k = self.n * self.n * itemsize
            chunk = max(1, int(budget // max(bytes_per_k, 1)))
        self.chunk = int(min(chunk, self.num_points))

        pts_dev = torch.as_tensor(points, dtype=dtype,
                                  device=device).contiguous()
        self.engines = []
        for start in range(0, self.num_points, self.chunk):
            stop = min(start + self.chunk, self.num_points)
            if verbose:
                print(f"grid-krylov: factorizing points "
                      f"{start}..{stop - 1} ({stop - start} kernels, "
                      f"n={self.n}, k={self.k}, "
                      f"{'matrix-free' if self.matrix_free else 'dense'}"
                      f"{', general nu' if general else ''})")
            rhos_dev = torch.as_tensor(self.rhos[start:stop], dtype=dtype,
                                       device=device)
            rhos_chunk = self.rhos[start:stop].tolist()
            nus_chunk = point_nus[start:stop].tolist()
            if not self.matrix_free:
                fact = _factorize_chunk(pts_dev, rhos_dev, nus_chunk, AB,
                                        self.k, self.s)
            elif general:
                fact = _factorize_chunk_general_matrixfree(
                    pts_dev, rhos_chunk, nus_chunk, AB, self.k, self.s,
                    int(min(block_rows, self.n)))
            else:
                fact = _factorize_chunk_matrixfree(
                    pts_dev, rhos_dev, nu_static, AB, self.k, self.s,
                    int(min(block_rows, self.n)))
            self.engines += engines_from_factorization(
                *(a.cpu().numpy() for a in fact), self.rhs_norms, self.n,
                self.m, AtA=AtA)

    def fit_all(self, interval_eta=(1e-4, 1e3), tol=1e-6, verbose=False):
        """Profile-MLE every grid point; returns a list of result dicts
        (sigma, sigma0, eta, lp - the profile log-likelihood at the
        optimum, the surface value of the reference's grid sweep)."""
        out = []
        for i, eng in enumerate(self.engines):
            res = eng.fit(interval_eta=interval_eta, tol=tol)
            eta = res["eta"]
            if np.isfinite(eta) and res["sigma"] > 0:
                res["lp"] = eng.log_likelihood(res["sigma"], eta)
            else:
                res["lp"] = -np.inf
            res["rho"] = float(self.rhos[i])
            res["nu"] = float(self.nus[i])
            out.append(res)
            if verbose:
                print(f"  ({res['rho']:.4g}, {res['nu']:.4g}): "
                      f"eta={eta:.4g} lp={res['lp']:.4f}")
        return out
