"""Likelihood facade dispatching direct / profiled maximization.

Counterpart of :mod:`gppe_tpu.models.likelihood` (the reference's facade,
gaussian_proc/_likelihood/likelihood.py:23-102): it builds the
MixedCorrelation (default method 'eigenvalue', as the reference's
likelihood.py:41) and sends ``likelihood_method`` to the direct
(sigma, sigma0) trust-region MLE or to the profile-likelihood root find
over eta in [1e-4, 1e3] (likelihood.py:90).

Two routes, chosen by whether K has eigenvalues:

* the spectral route (a dense K, or a scipy-sparse K of at most
  ``dense_threshold`` points densified, method 'eigenvalue'): the float64
  eigendecomposition and the rotation on the card, the O(n m) per-eta
  math in float64 on the host;
* the operator route (a matrix-free operator, a larger scipy-sparse K as a
  :class:`~gppe_tpu_torch.ops.operators.SparseOperator`, or a dense K
  under 'cholesky', 'slq' or 'hutchinson'): the fit runs
  :class:`~gppe_tpu_torch.models.large_scale.KrylovProfileLikelihood`
  (one Lanczos pass over [z, X, deflation start, probes]); for both
  methods, since the direct and profiled criteria have the same maximizer.
  ``likelihood(z, hp)`` takes CG solves and the MixedCorrelation's
  logdet (SLQ through an operator, Cholesky for a dense K under
  'cholesky' and 'hutchinson').

``plot=True`` draws the result (:func:`gppe_tpu_torch.utils.plot
.plot_likelihood_result`): the direct lp surface or the profiled
derivative plot from the spectral data, on the operator route the Krylov
engine's derivative.
"""

import numpy as np
import torch

from . import direct_likelihood, profile_likelihood
from .mixed_correlation import MixedCorrelation


def _host_float64(a):
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


class Likelihood:

    def __init__(self, X, K, likelihood_method="direct",
                 imate_method="eigenvalue", interpolate=False,
                 interpolant_points=None, options=None, lanczos_steps=80,
                 num_probes=16, dense_threshold=4096, *, device="cuda"):
        """``device``: where a dense K is factorized, in float64 (see
        :class:`MixedCorrelation`); ``dense_threshold``: the largest
        scipy-sparse K that the exact methods densify."""
        if likelihood_method not in ("direct", "profiled"):
            raise ValueError(
                f"likelihood_method must be 'direct' or 'profiled', got "
                f"{likelihood_method!r}")
        self.X = _host_float64(X)
        self.K = K
        self.likelihood_method = likelihood_method
        self.K_mixed = MixedCorrelation(K, method=imate_method,
                                        interpolate=interpolate,
                                        interpolant_points=interpolant_points,
                                        options=options,
                                        dense_threshold=dense_threshold,
                                        device=device)
        self._lanczos_steps = lanczos_steps
        self._num_probes = num_probes

    @property
    def operator_mode(self):
        """True when K has no eigendecomposition (matrix-free, or a dense K
        under another method): inference runs through the Krylov engine."""
        return self.K_mixed.eigenvalues is None

    def _data(self, z):
        return direct_likelihood.make_spectral_data(self.K_mixed, self.X,
                                                    _host_float64(z))

    def _krylov_engine(self, z):
        from .large_scale import KrylovProfileLikelihood
        return KrylovProfileLikelihood(
            self.K_mixed.K, self.X, _host_float64(z),
            lanczos_steps=self._lanczos_steps, num_probes=self._num_probes,
            device=self.K_mixed.device, dtype=self.K_mixed.dtype)

    def likelihood(self, z, hyperparam):
        """lp at hyperparam = (sigma, sigma0) (reference
        likelihood.py:55-61)."""
        if self.operator_mode:
            return self._operator_log_likelihood(z, hyperparam[0],
                                                 hyperparam[1])
        return float(direct_likelihood.log_likelihood(
            self._data(z), hyperparam[0], hyperparam[1]))

    def _operator_log_likelihood(self, z, sigma, sigma0):
        """REML lp on the operator route: the solves by CG (or Cholesky
        for a dense K) on the device, logdet from the MixedCorrelation, the
        O(n m) rest in float64 on the host (the role of the reference's
        imate-backed lp on sparse K, _direct_likelihood.py:31-83)."""
        z = _host_float64(z)
        X = self.X
        n, m = X.shape
        sigma = float(sigma)
        sigma0 = float(sigma0)
        if sigma < 1e-8:
            # the degenerate branch (reference _direct_likelihood.py:50-55):
            # S = sigma0^2 I, ordinary least squares
            B0 = X.T @ X
            c = np.linalg.solve(B0, X.T @ z)
            zMz = float(z @ (z - X @ c)) / sigma0 ** 2
            logdet_S = n * np.log(sigma0 ** 2)
            _, logdet_B0 = np.linalg.slogdet(B0)
            logdet_XtSinvX = logdet_B0 - m * np.log(sigma0 ** 2)
        else:
            eta = (sigma0 / sigma) ** 2
            Y = _host_float64(self.K_mixed.solve(eta, X))   # Kn^-1 X
            w = _host_float64(self.K_mixed.solve(eta, z))   # Kn^-1 z
            B = X.T @ Y
            B = 0.5 * (B + B.T)
            c = np.linalg.solve(B, Y.T @ z)
            zMz = float(z @ w - (Y.T @ z) @ c) / sigma ** 2
            logdet_Kn = float(self.K_mixed.logdet(eta))
            logdet_S = n * np.log(sigma ** 2) + logdet_Kn
            _, logdet_B = np.linalg.slogdet(B)
            logdet_XtSinvX = logdet_B - m * np.log(sigma ** 2)
        lp = (-0.5 * (n - m) * np.log(2.0 * np.pi) - 0.5 * logdet_S
              - 0.5 * logdet_XtSinvX - 0.5 * zMz)
        return float(lp)

    def maximize_log_likelihood(self, z, plot=False, verbose=False):
        engine = None
        if self.operator_mode:
            engine = self._krylov_engine(z)
            results = engine.fit(verbose=verbose)
        elif self.likelihood_method == "direct":
            results = direct_likelihood.maximize_log_likelihood(
                self._data(z), verbose=verbose)
        else:
            results = profile_likelihood.find_log_likelihood_der1_zeros(
                self._data(z), [1e-4, 1e+3], verbose=verbose)
        if plot:
            from ..utils import plot as plot_utils
            plot_utils.plot_likelihood_result(self, z, results,
                                              engine=engine)
        return results
