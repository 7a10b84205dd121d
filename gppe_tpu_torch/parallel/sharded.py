"""Row-block-sharded products, Lanczos, profile step and the sharded
profile-likelihood engine, on ``torch.distributed``.

Counterpart of ``gppe_tpu.parallel.sharded``, function by function. The
execution model is the reference's:

* the points' rows, the data vectors (z, X) and the Krylov blocks are
  sharded over the mesh's ``block`` axis, the probe columns over its
  ``probe`` axis;
* a product multiplies the local row block of the never-stored Matern K
  by the Krylov block, either rotated around the block ring (the block
  stays sharded) or all-gathered; the local product is
  ``ops.cuda_kernels.matern_matmat`` with ``points_cols`` (B1's
  tensor-core kernel in its rectangular form, a general nu G1's
  rectangular product; CPU tensors take the plain version);
* the Lanczos reductions are sums over ``block``, each taken in float64;
* the probe quadratures are summed over ``probe``.

Every rank calls these functions with the same host arrays (numpy or
tensors) and slices its own share; the results are whole on every rank.
Where the reference compiles one SPMD program (``jax.shard_map``), each
rank here runs eager PyTorch between explicit collectives of its
:class:`~gppe_tpu_torch.parallel.mesh.Mesh`. The reference runs two
Lanczos passes (the solve block, then the probes); each rank here runs
one over both, as the port's single-device engine does: the columns of a
batched Lanczos pass are independent runs, so the results are the same.
"""

import numpy as np
import torch

from ..ops import cuda_kernels, stochastic
from ..utils.config import resolve_device, setup
from .mesh import BLOCK_AXIS, PROBE_AXIS, probe_sharded, row_sharded

F64 = torch.float64
# the smallest scaled distance from a far pad to any other point: k is an
# exact 0 past it in float32 and float64 at every nu the port takes
# (exp(-sqrt(2 nu) x) underflows for nu >= 0.005)
FAR_SCALED = 1e4
# the names of build_sharded_factorization's outputs, in order
FACTORIZATION = ("a_sd", "b_sd", "U", "G", "P", "a_p", "b_p", "fro2")


def _rect_matern_matmat(pts_rows, pts_cols, scale, V, nu):
    """Local row-block product: Matern(pts_rows, pts_cols) @ V, K never
    stored, on ``ops.cuda_kernels.matern_matmat``'s rectangular form
    (``pts_cols=None``: the rows themselves, the square form). The kernel
    route follows the tensors' device, as everywhere in the port: CUDA
    tensors launch B1's tensor-core kernel (a general nu G1's product),
    CPU tensors take the plain version."""
    return cuda_kernels.matern_matmat(pts_rows, scale, V.contiguous(), nu,
                                      points_cols=pts_cols)


def ring_matern_matmat(mesh, pts_local, pts_full, scale, V_local, nu):
    """Ring-pipelined product with the Krylov block kept sharded.

    Each of the ``n_blocks`` ring steps multiplies the local row block of
    K against the column block this rank holds, while that block travels
    to the next block rank and the previous rank's arrives
    (``Mesh.ring_start``, posted before the product so that the transfer
    overlaps it). The column points are not sent: they are replicated
    (``pts_full``), and the block held at step s came from block index
    (my - s) mod n_blocks, a local slice. At one block nothing is sent.
    pts_local (n_l, d), pts_full (n, d), V_local (n_l, r) -> (n_l, r)."""
    n_blocks = mesh.shape[BLOCK_AXIS]
    if n_blocks == 1:
        return _rect_matern_matmat(pts_local, None, scale, V_local, nu)
    n_l = V_local.shape[0]
    my = mesh.coords[BLOCK_AXIS]
    acc, V_rot = None, V_local.contiguous()
    for step in range(n_blocks):
        # the last block goes nowhere: no rank would read it
        pending = mesh.ring_start(V_rot) if step < n_blocks - 1 else None
        src = (my - step) % n_blocks
        blk = _rect_matern_matmat(pts_local, pts_full[src * n_l:
                                                      (src + 1) * n_l],
                                  scale, V_rot, nu)
        acc = blk if acc is None else acc + blk
        if pending is not None:
            V_rot = pending.wait()
    return acc


def allgather_matern_matmat(mesh, pts_local, pts_full, scale, V_local, nu):
    """The all-gather schedule: the whole (n, r) block gathered over
    ``block`` each step, then one local product against every column."""
    if mesh.shape[BLOCK_AXIS] == 1:
        return _rect_matern_matmat(pts_local, None, scale, V_local, nu)
    V_full = mesh.all_gather(V_local.contiguous(), BLOCK_AXIS)
    return _rect_matern_matmat(pts_local, pts_full, scale, V_full, nu)


_SCHEDULES = {"ring": ring_matern_matmat,
              "allgather": allgather_matern_matmat}


def _schedule(comm):
    if comm not in _SCHEDULES:
        raise ValueError(f"unknown comm schedule '{comm}'")
    return _SCHEDULES[comm]


def _local_lanczos(mesh, matmat, V0_local, num_steps, axis=BLOCK_AXIS):
    """Lanczos with the vectors row-sharded over ``axis``, full
    reorthogonalization; every reduction (the norms, alpha, beta and the
    reorthogonalization coefficients) summed locally in float64 and
    all-reduced in float64.

    V0_local (n_l, r) -> alphas (r, k), betas (r, k - 1) (float64),
    V (k, r, n_l) in V0's dtype (the port's single-device layout), and the
    starting norms (r,) float64."""
    n_l, r = V0_local.shape
    dtype = V0_local.dtype
    k = num_steps

    def gsum(x):
        return mesh.all_reduce(x, axis)

    def dot_rows(a, b):
        return gsum(torch.sum((a * b).to(F64), dim=1))

    q = V0_local.T                                      # (r, n_l)
    nrm = torch.sqrt(dot_rows(q, q))
    q = q / nrm.to(dtype)[:, None]
    V = torch.zeros((k, r, n_l), dtype=dtype, device=V0_local.device)
    V[0] = q
    alphas = torch.zeros((r, k), dtype=F64, device=V0_local.device)
    betas = torch.zeros((r, max(k - 1, 0)), dtype=F64,
                        device=V0_local.device)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(r, dtype=dtype, device=V0_local.device)
    for j in range(k):
        w = matmat(q.T).to(dtype).T                     # (r, n_l)
        alpha = dot_rows(q, w)
        w = w - alpha.to(dtype)[:, None] * q - beta_prev[:, None] * q_prev
        Vj = V[:j + 1]
        coeffs = gsum(torch.einsum("ipn,pn->ip", Vj.to(F64), w.to(F64)))
        w = w - torch.einsum("ipn,ip->pn", Vj, coeffs.to(dtype))
        beta = torch.sqrt(dot_rows(w, w))
        beta_safe = torch.where(beta > 0, beta, 1.0).to(dtype)
        q_next = w / beta_safe[:, None]
        if j + 1 < k:
            V[j + 1] = q_next
        alphas[:, j] = alpha
        if j < k - 1:
            betas[:, j] = beta
        q_prev, q, beta_prev = q, q_next, beta.to(dtype)
    return alphas, betas, V, nrm


def _tridiag_dense(alphas, betas):
    """(r, k), (r, k-1) -> batched dense (r, k, k) tridiagonal."""
    r, k = alphas.shape
    T = torch.zeros((r, k, k), dtype=alphas.dtype, device=alphas.device)
    ii = torch.arange(k, device=alphas.device)
    T[:, ii, ii] = alphas
    if k > 1:
        jj = ii[:-1]
        T[:, jj, jj + 1] = betas[:, :k - 1]
        T[:, jj + 1, jj] = betas[:, :k - 1]
    return T


def _local_operands(mesh, points, scale, dtype):
    """This rank's row block of the points, the whole points (replicated)
    and the per-dimension scale, on the mesh's device."""
    device = mesh.device
    pts_f = torch.as_tensor(points, dtype=dtype, device=device).contiguous()
    d = pts_f.shape[1]
    scale = torch.broadcast_to(torch.as_tensor(scale, dtype=dtype,
                                               device=device), (d,))
    return row_sharded(mesh, pts_f).contiguous(), pts_f, scale.contiguous()


def _local_block(mesh, columns, probes, dtype):
    """[columns | this rank's probes] of this rank's rows, (n_l, c + p_l):
    ``columns`` replicated over ``probe``, ``probes`` sharded over it."""
    device = mesh.device

    def rows(a):
        t = torch.as_tensor(a, dtype=dtype, device=device)
        return row_sharded(mesh, t.reshape(t.shape[0], -1))

    return torch.cat([rows(c) for c in columns]
                     + [probe_sharded(mesh, rows(probes))], dim=1)


def _projections(mesh, V, rhs_l, s, k):
    """U (s, k, s) and G (s, s, k, k) of the solve bases V[:, :s] against
    the local RHS rows, float64, summed over ``block``."""
    n_l = rhs_l.shape[0]
    Vs = V[:, :s]                                       # (k, s, n_l)
    U = mesh.all_reduce(stochastic.matmul_f64(
        Vs.reshape(k * s, n_l), rhs_l), BLOCK_AXIS)
    U = U.reshape(k, s, s).permute(1, 0, 2)             # (j, k, t)
    Vm = Vs.permute(1, 0, 2).reshape(s * k, n_l)
    G = mesh.all_reduce(stochastic.gram_f64(Vm), BLOCK_AXIS)
    G = G.reshape(s, k, s, k).permute(0, 2, 1, 3)
    return U, G


def _host(t):
    return t.detach().cpu().numpy().astype(np.float64)


def build_sharded_profile_step(mesh, nu=0.5, lanczos_steps=16,
                               comm="ring", dtype=torch.float32):
    """One full multi-device profile-likelihood step on ``mesh``.

    Returns ``step(points, scale, X, z, probes, etas)`` that every rank
    calls with the same host arrays (``probes`` (n, p), p a multiple of
    the probe extent) and that:

      1. runs the sharded Lanczos on the solve block [z, X] (replicated
         over ``probe``, row-sharded over ``block``) and on the rank's
         probe columns, in one pass;
      2. computes the Krylov solves and the probes' Ritz quadrature for a
         batch of etas, batched in float64 on the rank's device (Cholesky
         solves, as the reference);
      3. returns der1(eta), traceinv(eta), logdet(eta), float64 numpy on
         every rank, the probe means summed over ``probe``.

    ``comm``: ``'ring'`` (the block travels around the ring, per-rank
    memory O(n / block)) or ``'allgather'`` (the whole block gathered each
    step). ``dtype``: the Lanczos vectors' (float32 on the card)."""
    matmat_of = _schedule(comm)
    k = lanczos_steps

    def step(points, scale, X, z, probes, etas):
        setup()
        n, m = X.shape
        s = m + 1
        pts_l, pts_f, scale_ = _local_operands(mesh, points, scale, dtype)
        block_l = _local_block(mesh, [z, X], probes, dtype)
        rhs_l = block_l[:, :s]

        def matmat(V_l):
            return matmat_of(mesh, pts_l, pts_f, scale_, V_l, nu)

        a, b, V, nrm = _local_lanczos(mesh, matmat, block_l, k)
        a_s, b_s, nrm_s = a[:s], b[:s], nrm[:s]
        a_p, b_p = a[s:], b[s:]
        U, G = _projections(mesh, V, rhs_l, s, k)
        del V

        # the probes' Ritz quadrature
        theta, Uev = torch.linalg.eigh(_tridiag_dense(a_p, b_p))
        tau = Uev[:, 0, :] ** 2                         # (p_l, k)
        etas_ = torch.as_tensor(np.asarray(etas, dtype=np.float64),
                                device=mesh.device)
        E = etas_.shape[0]
        # solves y_j = (T_j + eta)^-1 ||a_j|| e1, T_j + eta I SPD
        eye_k = torch.eye(k, dtype=F64, device=mesh.device)
        L = torch.linalg.cholesky(_tridiag_dense(a_s, b_s)[None]
                                  + etas_[:, None, None, None] * eye_k)
        e1 = torch.zeros((E, s, k, 1), dtype=F64, device=mesh.device)
        e1[:, :, 0] = 1.0
        y = torch.cholesky_solve(e1, L)[..., 0] * nrm_s[None, :, None]
        C = torch.einsum("jkt,ejk->etj", U, y)          # (E, s, s)
        S2 = torch.einsum("eia,ijab,ejb->eij", y, G, y)
        B = C[:, 1:, 1:]
        B = 0.5 * (B + B.transpose(1, 2))
        Ytz = C[:, 0, 1:]
        zw = C[:, 0, 0]
        # B is a Krylov approximation, only symmetrized: a trace-relative
        # jitter keeps the Cholesky from failing at low lanczos_steps
        eye_m = torch.eye(m, dtype=F64, device=mesh.device)
        jit = 10.0 * torch.finfo(F64).eps
        tr = torch.diagonal(B, dim1=1, dim2=2).sum(-1)
        B = B + (jit * tr / m)[:, None, None] * eye_m
        Binv = torch.cholesky_solve(eye_m.expand(E, m, m),
                                    torch.linalg.cholesky(B))
        c = torch.einsum("eij,ej->ei", Binv, Ytz)
        zMz = zw - (Ytz * c).sum(-1)
        zM2z = (S2[:, 0, 0] - 2.0 * (S2[:, 0, 1:] * c).sum(-1)
                + torch.einsum("ei,eij,ej->e", c, S2[:, 1:, 1:], c))
        # Rademacher probes have ||v||^2 = n: each normalized quadrature
        # estimates trace / n; the means over every probe of the mesh
        q_inv = (tau[None] / (theta[None] + etas_[:, None, None])).sum(-1)
        q_log = (tau[None] * torch.log(theta[None]
                                       + etas_[:, None, None])).sum(-1)
        sums = mesh.all_reduce(torch.stack([
            q_inv.sum(-1), q_log.sum(-1),
            torch.full((E,), float(q_inv.shape[1]), dtype=F64,
                       device=mesh.device)]), PROBE_AXIS)
        traceinv = n * sums[0] / sums[2]
        logdet = n * sums[1] / sums[2]
        trace_M = traceinv - torch.diagonal(
            Binv @ S2[:, 1:, 1:], dim1=1, dim2=2).sum(-1)
        sigma2 = zMz / (n - m)
        der1 = -0.5 * (trace_M - zM2z / sigma2)
        return _host(der1), _host(traceinv), _host(logdet)

    return step


def build_sharded_factorization(mesh, nu=0.5, lanczos_steps=64,
                                comm="ring", dtype=torch.float32):
    """The one-time multi-device Krylov factorization.

    The analog of ``models.large_scale.KrylovProfileLikelihood``'s setup:
    one sharded Lanczos pass over the solve block [z, X], the deflation
    chain and the rank's probe columns, on the row-sharded products, then
    the small projections. Everything eta-dependent afterwards is host
    O(k^2) math (:class:`ShardedKrylovProfileLikelihood`).

    Returns ``fact(points, scale, X, z, v_defl, probes)``, which every rank
    calls with the same host arrays or tensors and which returns, whole on
    every rank as float64 numpy, (a_sd (s+1, k), b_sd (s+1, k-1), U (s, k,
    s), G (s, s, k, k), P (k, p), a_p (p, k), b_p (p, k-1), fro2): row s of
    the solve block is the deflation chain, ``fro2`` is trace(K^2) of the
    points as given (padded or not) summed over the local row blocks: one
    launch of B1's trace kernel (G1's at a general nu) on the rectangular
    walk of the local rows against every column (the square walk at one
    block). The projections are float64, summed in float64."""
    matmat_of = _schedule(comm)
    k = lanczos_steps

    def fact(points, scale, X, z, v_defl, probes):
        setup()
        s = X.shape[1] + 1
        pts_l, pts_f, scale_ = _local_operands(mesh, points, scale, dtype)
        block_l = _local_block(mesh, [z, X, v_defl], probes, dtype)
        rhs_l = block_l[:, :s]

        def matmat(V_l):
            return matmat_of(mesh, pts_l, pts_f, scale_, V_l, nu)

        a, b, V, _ = _local_lanczos(mesh, matmat, block_l, k)
        U, G = _projections(mesh, V, rhs_l, s, k)
        P = mesh.all_reduce(stochastic.matmul_f64(
            V[:, s], block_l[:, s + 1:]), BLOCK_AXIS)   # (k, p_l)
        del V
        cols = None if mesh.shape[BLOCK_AXIS] == 1 else pts_f
        fro2 = cuda_kernels.matern_matmat(pts_l, scale_, None, nu,
                                          points_cols=cols,
                                          frobenius=True)[1]
        fro2 = mesh.all_reduce(fro2.to(F64).reshape(1), BLOCK_AXIS)
        # the probe chains' pieces, whole on every rank
        a_p = mesh.all_gather(a[s + 1:].contiguous(), PROBE_AXIS)
        b_p = mesh.all_gather(b[s + 1:].contiguous(), PROBE_AXIS)
        P = mesh.all_gather(P.T.contiguous(), PROBE_AXIS).T
        return (_host(a[:s + 1]), _host(b[:s + 1]), _host(U), _host(G),
                _host(P), _host(a_p), _host(b_p), float(fro2[0]))

    return fact


def _far_pads(pts, n_pad, scale):
    """``pts`` (n, d) padded to ``n_pad`` rows with mutually far points
    along the first axis (the reference's 1e6 (2 + i)), checked to stay at
    least ``FAR_SCALED`` apart, and from every point, after division by
    the scale in float32, where the card computes their distances."""
    n, d = pts.shape
    if n_pad == n:
        return pts
    pad = np.zeros((n_pad - n, d))
    pad[:, 0] = 1e6 * (2.0 + np.arange(n_pad - n))
    scale0 = np.float32(np.broadcast_to(np.asarray(scale, float), (d,))[0])
    x_pad = pad[:, 0].astype(np.float32) / scale0
    x_far = np.abs(pts[:, 0]).astype(np.float32).max() / scale0
    gaps = np.diff(np.concatenate([[x_far], x_pad]))
    if not np.all(gaps >= FAR_SCALED):
        raise ValueError(
            f"the far pads lie {float(gaps.min()):.3g} scale units from the "
            f"points (at least {FAR_SCALED:g} needed): the points or the "
            f"scale are too large for padding n = {n} to {n_pad}")
    return np.concatenate([pts, pad])


class ShardedKrylovProfileLikelihood:
    """End-to-end profile-likelihood MLE over a device mesh.

    One sharded Krylov factorization on the mesh
    (:func:`build_sharded_factorization`: row-block-sharded products on
    the ring or all-gather schedule, probe chains on the ``probe`` axis),
    then the whole MLE (bracket search, Chandrupatla, der2-at-0 boundary
    analysis, the exact OLS eta -> inf boundary) on the host O(k^2)
    engine, ``models.large_scale.KrylovProfileLikelihood
    .from_factorization``, which every rank builds alike.

    ``n`` need not divide the block extent: the points are padded with
    mutually far points and the data with zero rows, so the padded K is
    block-diagonal with the identity on the pad block, zero-padded Krylov
    vectors stay zero there, and the factorization is the unpadded one;
    the padded rows' unit diagonal is subtracted from trace(K^2).

    Random draws: ``probes`` (n, num_probes) and ``v_defl`` (n,) or (n, 1)
    as given, the rest from ``generator`` (a ``torch.Generator`` on the
    mesh's device), else from a new one seeded with ``key``: the draws of
    the single-device engine with the same arguments, made whole on every
    rank. ``num_probes`` is rounded up to a multiple of the probe extent.
    ``dtype``: the Lanczos vectors' (default float32); ``device``: the
    mesh's (the default), stated to check it. ``factorization`` keeps
    :func:`build_sharded_factorization`'s outputs by name."""

    def __init__(self, mesh, points, X, z, scale, nu=0.5,
                 lanczos_steps=64, num_probes=16, comm="ring", key=0,
                 trace_k2=True, dtype=None, *, generator=None, probes=None,
                 v_defl=None, device=None):
        from ..models.large_scale import KrylovProfileLikelihood

        setup()
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        dtype = dtype or torch.float32
        pts = np.asarray(points, dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        n, d = pts.shape
        m = X.shape[1]
        self.n, self.m = n, m
        s = m + 1
        k = int(min(lanczos_steps, n))
        probe_ext = mesh.shape[PROBE_AXIS]
        block_ext = mesh.shape[BLOCK_AXIS]
        p = -(-int(num_probes) // probe_ext) * probe_ext

        n_pad = -(-n // block_ext) * block_ext
        pts_pad = _far_pads(pts, n_pad, scale)
        zp = np.zeros(n_pad)
        zp[:n] = z
        Xp = np.zeros((n_pad, m))
        Xp[:n] = X
        probes, v_defl = stochastic.random_block(
            n, p, key, mesh.device, dtype, generator, probes, v_defl)
        pad = torch.zeros((n_pad - n, p + 1), dtype=dtype, device=mesh.device)
        probes = torch.cat([probes, pad[:, :p]])
        v_defl = torch.cat([v_defl, pad[:, p:]])

        fact = build_sharded_factorization(mesh, nu=nu, lanczos_steps=k,
                                           comm=comm, dtype=dtype)
        out = fact(pts_pad, scale, Xp, zp, v_defl, probes)
        self.factorization = dict(zip(FACTORIZATION, out))
        a_sd, b_sd, U, G, P, a_p, b_p, fro2 = out

        A = np.concatenate([z[:, None], X], axis=1)
        # trace(K^2) from the sharded pass itself; each padded row gives
        # exactly its unit diagonal
        tK2 = fro2 - (n_pad - n) if trace_k2 else None
        nodes, weights = stochastic.deflated_quadrature(
            a_sd[s], b_sd[s], a_p, b_p, P, np.full(p, float(n)), n,
            trace_K2=tK2)
        traces = stochastic.QuadratureTraceEngine(nodes, weights, n)
        self._eng = KrylovProfileLikelihood.from_factorization(
            a_sd[:s], b_sd[:s], U, G, np.linalg.norm(A, axis=0), traces, n,
            m, AtA=A.T @ A)

    # host O(k^2) per-eta surface (delegates)
    def der1(self, log_eta):
        return self._eng.der1(log_eta)

    def der2(self, eta):
        return self._eng.der2(eta)

    def log_likelihood(self, sigma, eta):
        return self._eng.log_likelihood(sigma, eta)

    def fit(self, **kwargs):
        """Full MLE: bracket + Chandrupatla + boundary fallback, see
        ``KrylovProfileLikelihood.fit``."""
        return self._eng.fit(**kwargs)
