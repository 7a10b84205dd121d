"""Dense and iterative linear algebra of the exact dense path.

Counterpart of :mod:`gppe_tpu.ops.linalg`. Everything runs on the device
of its operands:

* :func:`eigh` is ``torch.linalg.eigh`` in float64 on the card. The
  reference sends the eigendecomposition to the host CPU (``host_eigh``)
  because a TPU has no fast float64 eigh; the H100 has native float64, so
  the detour goes;
* the Cholesky family is ``torch.linalg.cholesky`` and triangular solves
  (cuSOLVER / cuBLAS on the card), in the dtype of the matrix;
* :func:`cg_solve` and :func:`minres_solve` are batched Krylov solvers over
  the columns of B, each column with its own recurrence scalars and frozen
  once it converges; A is a matrix or a callable (a ``MaternOperator``'s
  ``matmat`` launches the fused kernel). They are plain Python loops that
  test convergence every iteration, where the reference compiles a
  ``while_loop``.
"""

import torch


def eigh(K):
    """Eigenvalues (ascending) and eigenvectors of the symmetric ``K``,
    computed and returned in float64 on K's device."""
    return torch.linalg.eigh(K.to(torch.float64))


def cholesky_factor(Kn):
    """Lower Cholesky factor of an SPD matrix."""
    return torch.linalg.cholesky(Kn)


def cholesky_solve(L, B):
    """Solve K x = B given the lower Cholesky factor L of K; B is (n,) or
    (n, k)."""
    if B.ndim == 1:
        return torch.cholesky_solve(B[:, None], L)[:, 0]
    return torch.cholesky_solve(B, L)


def cholesky_logdet(L):
    """log det K from its Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L)))


def cholesky_traceinv(L, exponent=1):
    """Exact trace(K^-p) from the Cholesky factor: p = 1 is ||L^-1||_F^2,
    p = 2 is ||K^-1||_F^2 (the role of imate's cholesky method, reference
    mixed_correlation.py:183-191)."""
    if exponent not in (1, 2):
        raise ValueError("exponent must be 1 or 2")
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    if exponent == 1:
        return torch.sum(Linv * Linv)
    Kinv = Linv.T @ Linv
    return torch.sum(Kinv * Kinv)


def _shifted_matvec(A, shift):
    if callable(A):
        return lambda V: A(V) + shift * V
    return lambda V: A @ V + shift * V


def cg_solve(A, B, tol=1e-6, max_iter=1000, M_diag=None, shift=0.0,
             return_iterations=False):
    """Batched conjugate gradient for SPD ``A + shift I``.

    ``A``: (n, n) tensor or a callable on (n, k) blocks; ``B``: (n,) or
    (n, k) right-hand sides solved together, each column with its own
    alpha and beta (the reference's batched CG, which replaces the
    per-column scipy CG of reference _linear_solver.py:49-60). A column
    stops moving once ||r|| <= tol ||b||: its alpha is zero from then on.
    ``M_diag``: optional Jacobi preconditioner (n,). With
    ``return_iterations`` also returns the iterations each column was
    updated in, an int64 tensor (k,).
    """
    vector = B.ndim == 1
    if vector:
        B = B[:, None]
    matvec = _shifted_matvec(A, shift)
    precond = ((lambda R: R / M_diag[:, None]) if M_diag is not None
               else (lambda R: R))

    X = torch.zeros_like(B)
    R = B                                  # B - A X at X = 0
    Z = precond(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    tol2 = tol * tol * torch.clamp(torch.sum(B * B, dim=0), min=1e-300)
    iterations = torch.zeros(B.shape[1], dtype=torch.int64, device=B.device)
    for _ in range(max_iter):
        active = torch.sum(R * R, dim=0) > tol2
        if not bool(active.any()):
            break
        AP = matvec(P)
        pAp = torch.sum(P * AP, dim=0)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0),
                            0.0)
        alpha = torch.where(active, alpha, 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = precond(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        P = Z + beta[None, :] * P
        rz = rz_new
        iterations += active
    X = X[:, 0] if vector else X
    return (X, iterations) if return_iterations else X


def minres_solve(A, B, tol=1e-6, max_iter=1000, shift=0.0):
    """Batched MINRES for symmetric, possibly indefinite ``A + shift I``
    (the reference's symmetric-indefinite fallback, _linear_solver.py:61-63;
    no path of the port calls it: every operator here is positive definite).
    Lanczos with the Givens QR on the fly (Paige-Saunders), every rotation
    scalar a (k,) lane; a column stops once its residual-norm recurrence
    falls to tol ||b||. Same calling convention as :func:`cg_solve`."""
    vector = B.ndim == 1
    if vector:
        B = B[:, None]
    matvec = _shifted_matvec(A, shift)
    r = B.shape[1]

    beta1 = torch.linalg.norm(B, dim=0)
    v = B / torch.where(beta1 > 0, beta1, 1.0)
    x = torch.zeros_like(B)
    v_prev = torch.zeros_like(B)
    w0 = torch.zeros_like(B)
    w_m1 = torch.zeros_like(B)
    ones = torch.ones(r, dtype=B.dtype, device=B.device)
    zeros = torch.zeros(r, dtype=B.dtype, device=B.device)
    beta, gamma0, gamma1, sigma0, sigma1 = zeros, ones, ones, zeros, zeros
    eta = beta1
    tol_abs = tol * torch.clamp(beta1, min=1e-300)

    for _ in range(max_iter):
        active = torch.abs(eta) > tol_abs
        if not bool(active.any()):
            break
        d = matvec(v)
        alpha = torch.sum(v * d, dim=0)
        d = d - alpha[None, :] * v - beta[None, :] * v_prev
        beta_next = torch.linalg.norm(d, dim=0)
        v_next = d / torch.where(beta_next > 0, beta_next, 1.0)

        a0 = gamma1 * alpha - gamma0 * sigma1 * beta
        a1 = torch.sqrt(a0 * a0 + beta_next * beta_next)
        a2 = sigma1 * alpha + gamma0 * gamma1 * beta
        a3 = sigma0 * beta
        a1_safe = torch.where(a1 > 0, a1, 1.0)
        gamma0, gamma1 = gamma1, a0 / a1_safe
        sigma0, sigma1 = sigma1, beta_next / a1_safe

        w_new = (v - a3[None, :] * w_m1 - a2[None, :] * w0) / a1_safe
        # converged columns keep their x and residual
        x = torch.where(active[None, :], x + (gamma1 * eta)[None, :] * w_new,
                        x)
        eta = torch.where(active, -sigma1 * eta, eta)
        v_prev, v, beta = v, v_next, beta_next
        w_m1, w0 = w0, w_new
    return x[:, 0] if vector else x
