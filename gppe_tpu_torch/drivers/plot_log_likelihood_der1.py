"""The derivative-of-likelihood plot.

Counterpart of the reference's ``drivers/plot_log_likelihood_der1.py``
(itself a port of reference examples/
plot_log_likelihood_first_derivative.py:33-93): one data set on a
num_points x num_points grid, eta estimated by the derivative method, then
d lp / d eta drawn with its bounds and asymptotes
(:func:`gppe_tpu_torch.utils.plot.plot_log_likelihood_der1_eta`). K is
assembled on ``device`` (float32 on the card, float64 on the CPU), its
float64 eigendecomposition taken there (``MixedCorrelation``), and the
root found on the float64 host data.

    python -m gppe_tpu_torch.drivers.plot_log_likelihood_der1

writes log_likelihood_first_derivative.svg into the working directory.
"""

import argparse
import importlib.util

import torch

from ..models import direct_likelihood, profile_likelihood
from ..models.mixed_correlation import MixedCorrelation
from ..ops import assembly
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup


def main(num_points=30, noise=0.2, scale=0.1, nu=0.5, verbose=True,
         plot=None, *, device="cuda"):
    """Returns ``find_log_likelihood_der1_zeros``'s result dict. ``plot``
    True draws (matplotlib required), False never draws, None draws when
    matplotlib is installed."""
    setup()
    device = resolve_device(device)
    pts = data_utils.generate_points(num_points, dimension=2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    K = assembly.dense_correlation(pts, scale, nu, dtype=dtype, device=device)
    data = direct_likelihood.make_spectral_data(
        MixedCorrelation(K, device=device), X, z)
    res = profile_likelihood.find_log_likelihood_der1_zeros(data,
                                                            [1e-4, 1e3])
    if verbose:
        print(f"eta={res['eta']:.4f} sigma={res['sigma']:.5f} "
              f"sigma0={res['sigma0']:.5f}")
    if plot is None:
        plot = importlib.util.find_spec("matplotlib") is not None
    if plot:
        from ..utils import plot as plot_utils
        plot_utils.plot_log_likelihood_der1_eta(
            data, K.to(torch.float64).cpu().numpy(), X, z,
            optimal_eta=res["eta"])
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=30)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.num_points, device=a.device)
