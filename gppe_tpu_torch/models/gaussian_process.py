"""GaussianProcess user API.

Counterpart of :mod:`gppe_tpu.models.gaussian_process` (the reference's
facade, gaussian_proc/gaussian_process/gaussian_process.py:39-71):
``GaussianProcess(X, K, likelihood_method).train(z)`` estimates
(sigma, sigma0, eta) of the model z ~ N(X beta, sigma^2 K + sigma0^2 I).
K is a dense correlation matrix (a tensor or an array; factorized on
``device="cuda"`` unless the caller passes another device), a scipy-sparse
K (densified up to ``dense_threshold`` points, else a SparseOperator on
that device) or a matrix-free operator on that device.
"""

from .likelihood import Likelihood


class GaussianProcess:

    def __init__(self, X, K, likelihood_method="direct", **likelihood_kwargs):
        self.X = X
        self.K = K
        self.likelihood = Likelihood(X, K, likelihood_method,
                                     **likelihood_kwargs)

    def train(self, z, plot=False, verbose=False):
        """Maximize the likelihood; returns a dict with sigma, sigma0 and
        eta (reference gaussian_process.py:52-59)."""
        results = self.likelihood.maximize_log_likelihood(
            z, plot=plot, verbose=verbose)
        if verbose:
            print(f"sigma = {results['sigma']:.6g}, "
                  f"sigma0 = {results['sigma0']:.6g}, "
                  f"eta = {results['eta']:.6g}")
        return results
