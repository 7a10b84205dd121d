"""End-to-end MLE through the public API, timed.

Counterpart of the reference's ``drivers/maximize_likelihood_direct_method.py``
(itself a port of reference examples/maximize_likelihood_direct_method.py:
28-61): a num_points x num_points grid (n = 2500 by default), noise 0.2,
Matern nu = 0.5 at scale 0.1, a degree-2 polynomial basis; trains with the
direct and the profiled method and reports the wall clock split into
assembly (``generate_correlation``), precompute (the ``GaussianProcess``
constructor: the float64 eigendecomposition) and optimize (``train``: the
rotation and the host float64 fit), each ended by a device synchronise.

    python -m gppe_tpu_torch.drivers.maximize_likelihood_direct_method

runs on the card (``device="cpu"`` for a rehearsal) and prints one JSON
line; it writes a file only when ``main`` is given ``out_path``.
"""

import argparse
import json
import time

import torch

from ..models.gaussian_process import GaussianProcess
from ..ops.assembly import generate_correlation
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(num_points=50, noise=0.2, nu=0.5, scale=0.1, degree=2,
         device="cuda", verbose=True, out_path=None):
    """Returns {"direct": {...}, "profiled": {...}, "assembly_s": ...,
    "n": ..., "device": ...}; each method's record is ``train``'s result
    with ``precompute_s`` and ``optimize_s``."""
    setup()
    device = resolve_device(device)
    pts = data_utils.generate_points(num_points, dimension=2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, polynomial_degree=degree)

    _sync(device)
    t0 = time.perf_counter()
    K = generate_correlation(pts, scale, nu=nu, device=device)
    _sync(device)
    results = {"n": int(pts.shape[0]), "device": str(device),
               "assembly_s": time.perf_counter() - t0}

    for method in ("direct", "profiled"):
        t0 = time.perf_counter()
        gp = GaussianProcess(X, K, likelihood_method=method, device=device)
        _sync(device)
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = gp.train(z)
        _sync(device)
        t_opt = time.perf_counter() - t0
        res.update({"precompute_s": t_pre, "optimize_s": t_opt})
        results[method] = res
        if verbose:
            print(f"[{method}] sigma={res['sigma']:.6f} "
                  f"sigma0={res['sigma0']:.6f} eta={res['eta']:.4f} "
                  f"(pre {t_pre:.2f}s, opt {t_opt:.2f}s)")
    if verbose:
        print(json.dumps(results), flush=True)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(results, f)
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=50)
    p.add_argument("--noise", type=float, default=0.2)
    p.add_argument("--nu", type=float, default=0.5)
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.num_points, a.noise, a.nu, a.scale, device=a.device)
