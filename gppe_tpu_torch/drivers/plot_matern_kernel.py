"""The Matern kernel family plot.

Counterpart of the reference's ``drivers/plot_matern_kernel.py`` (itself
a port of reference examples/plot_matern_kernel.py:27-149): k(r; nu) over
r / rho in [0, 4] for nu in {0.1, 0.5, 1, 3.2, 25, infinity (1000)},
showing the convergence to the Gaussian kernel as nu grows. The values
come from :func:`gppe_tpu_torch.ops.kernels.matern` in float64 on
``device``; the drawing from matplotlib, which ``test=True`` does not
need.

    python -m gppe_tpu_torch.drivers.plot_matern_kernel [--test]

writes matern_kernel.svg into the working directory unless ``--test``.
"""

import argparse

import numpy as np
import torch

from ..ops import kernels
from ..utils.config import resolve_device, setup

NUS = ((0.1, "-"), (0.5, "-"), (1.0, "-"), (3.2, "-"), (25.0, "--"),
       (1000.0, ":"))


def curves(device="cuda"):
    """(x, {nu: k(x; nu)}) over x = linspace(0, 4, 400), float64 numpy."""
    device = resolve_device(device)
    x = np.linspace(0, 4, 400)
    xt = torch.as_tensor(x, dtype=torch.float64, device=device)
    return x, {nu: kernels.matern(xt, nu).cpu().numpy() for nu, _ in NUS}


def main(test=False, filename="matern_kernel", *, device="cuda"):
    """Draw the family (unless ``test``) and return max |k_25 - k_gauss|
    over the curve, which the reference holds under 0.02 (:93-96)."""
    setup()
    x, ks = curves(device)
    if not test:
        from ..utils import display
        from ..utils import plot as plot_utils
        plt = plot_utils._get_plt()
        fig, ax = plt.subplots()
        for nu, style in NUS:
            label = r"$\nu=\infty$" if nu >= 100 else rf"$\nu={nu}$"
            ax.plot(x, ks[nu], style, label=label)
        ax.set_xlabel(r"$r/\rho$")
        ax.set_ylabel(r"$k(r)$")
        ax.set_title("Matern correlation family")
        ax.legend(frameon=False)
        if display.has_display():
            plt.show()
        else:
            plot_utils.save_plot(plt, filename)
        plt.close(fig)
    return float(np.abs(ks[25.0] - np.exp(-0.5 * x ** 2)).max())


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--test", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    err = main(test=a.test, device=a.device)
    print(f"max |k_25 - k_gauss| = {err:.4f}")
