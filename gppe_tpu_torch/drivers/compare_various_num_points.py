"""Scaling benchmark over n: the pre-computation and the
maximize-likelihood phases timed apart.

Counterpart of the reference's ``drivers/compare_various_num_points.py``
(itself a port of reference examples/CompareVariousNumberOfPoints.py:
241-280; goldens data/VariousNumberOfPoints-{dense,sparse}.pickle), for:

* the derivative (profile) method on the spectral path (the float64
  eigendecomposition on the card) [dense n];
* the direct MLE on the same spectral data [dense n];
* the derivative method on the matrix-free Krylov path [large n]: a
  ``MaternOperator``, a ``TaperedMaternOperator`` (``density``; the
  reference's tapered scaling race, :func:`main_sparse`) or, on grid
  points, the exact FFT ``GridMaternOperator`` (``fft=True``);

and the log-log scaling slopes (the reference's LogRegression :218-235).

    python -m gppe_tpu_torch.drivers.compare_various_num_points [--small | --sparse]

runs on the card (``device="cpu"`` for a rehearsal, float64 there, float32
on the card) and writes a file only when given ``results_path``. Every
time ends with a device synchronise. Not ported yet, and refused with the
ROADMAP item that brings it: ``plot=True`` and :func:`plot_results`
(A15).
"""

import argparse
import copy
import time

import numpy as np
import torch

from ..models import direct_likelihood, profile_likelihood
from ..models.large_scale import KrylovProfileLikelihood
from ..models.mixed_correlation import MixedCorrelation
from ..ops import assembly, operators, taper
from ..utils import checkpoint
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup

# the reference's CPU totals of its tapered race, by n
# (data/VariousNumberOfPoints-sparse.pickle)
SPARSE_REFERENCE_TOTALS = {65536: 28.0, 262144: 485.0, 1048576: 10032.0}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dtype(device):
    return torch.float32 if device.type == "cuda" else torch.float64


def _refuse_plot(what):
    raise NotImplementedError(
        f"compare_various_num_points.{what}: plotting comes with ROADMAP A15")


def log_regression(Ns, times):
    """Slope of log(time) against log(n) (reference :218-235)."""
    mask = np.asarray(times) > 0
    if mask.sum() < 2:
        return float("nan")
    p = np.polyfit(np.log(np.asarray(Ns)[mask]),
                   np.log(np.asarray(times)[mask]), 1)
    return float(p[0])


def run_dense(n_side, noise=0.2, scale=0.1, nu=0.5, *, device="cuda"):
    """The dense spectral path on an n_side x n_side grid: K assembled,
    then (timed as ``pre_s``) its eigendecomposition and the rotated data,
    then (``opt_s``) the derivative method's root and the direct MLE on
    the same spectral data. Returns (n, {"derivative": ..., "direct":
    ...})."""
    setup()
    device = resolve_device(device)
    pts = data_utils.generate_points(n_side, dimension=2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)
    K = assembly.dense_correlation(pts, scale, nu, dtype=_dtype(device),
                                   device=device)
    _sync(device)

    out = {}
    t0 = time.perf_counter()
    data = direct_likelihood.make_spectral_data(
        MixedCorrelation(K, device=device), X, z)
    _sync(device)
    pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = profile_likelihood.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])
    out["derivative"] = {"pre_s": pre, "opt_s": time.perf_counter() - t0,
                         **r}
    # the direct method on the same spectral data (pre time shared)
    t0 = time.perf_counter()
    r2 = direct_likelihood.maximize_log_likelihood(data)
    out["direct"] = {"pre_s": pre, "opt_s": time.perf_counter() - t0, **r2}
    return pts.shape[0], out


def run_krylov(n, noise=0.2, scale=0.1, nu=0.5, density=None, seed=7,
               grid=False, lanczos_steps=64, num_probes=16, fft=False, *,
               device="cuda"):
    """The Krylov path at n points: ``grid`` the reference's structured
    grid of side rint(sqrt(n)) (CompareVariousNumberOfPoints.py:259), else
    n uniform random points (RandomState(seed)); the operator the exact
    FFT ``GridMaternOperator`` with ``fft`` (grid points only), a
    ``TaperedMaternOperator`` with ``density``, else a ``MaternOperator``.
    ``pre_s`` times the ``KrylovProfileLikelihood`` constructor (the
    Lanczos pass), ``opt_s`` its fit."""
    setup()
    device = resolve_device(device)
    dtype = _dtype(device)
    if grid:
        side = int(round(np.sqrt(n)))
        pts = data_utils.generate_points(side, dimension=2)
        n = pts.shape[0]
    else:
        pts = np.random.RandomState(seed).rand(n, 2)
    z = data_utils.generate_data(pts, noise)
    X = data_utils.generate_basis_functions(pts, 2)

    if fft:
        op = operators.GridMaternOperator(pts, scale, nu=nu, device=device,
                                          dtype=dtype)
    elif density is not None:
        op = taper.TaperedMaternOperator(pts, scale, nu=nu, density=density,
                                         device=device, dtype=dtype)
    else:
        op = operators.MaternOperator(pts, scale, nu=nu, device=device,
                                      dtype=dtype)

    _sync(device)
    t0 = time.perf_counter()
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=lanczos_steps,
                                  num_probes=num_probes, device=device,
                                  dtype=dtype)
    _sync(device)
    pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = eng.fit()
    return {"pre_s": pre, "opt_s": time.perf_counter() - t0, **r}


def main_sparse(ns=(65536, 262144, 1048576), density=1e-3, scale=0.005,
                results_path=None, use_saved=False, verbose=True, runs=1,
                plot=False, *, device="cuda"):
    """The reference's tapered scaling race
    (CompareVariousNumberOfPoints.py:243-248: grid points, rho = 0.005,
    nu = 0.5, tapered K, derivative method), each n's total beside the
    reference's CPU total (28.0 s at 2^16, 485 s at 2^18, 10,032 s at
    2^20), and the slope; ``runs`` repetitions averaged."""
    if plot:
        _refuse_plot("main_sparse(plot=True)")

    def compute_once():
        out = {"sparse": []}
        for n in ns:
            res = run_krylov(n, scale=scale, density=density, grid=True,
                             device=device)
            res["n"] = n
            res["total_s"] = res["pre_s"] + res["opt_s"]
            res["reference_total_s"] = SPARSE_REFERENCE_TOTALS.get(n)
            out["sparse"].append(res)
            if verbose:
                ref = res["reference_total_s"]
                speedup = (f", {ref / res['total_s']:.0f}x vs reference "
                           f"{ref:.0f} s" if ref else "")
                print(f"sparse n={n}: pre {res['pre_s']:.2f}s "
                      f"opt {res['opt_s']:.2f}s eta={res['eta']:.3f}"
                      f"{speedup}")
        out["sparse_slope"] = log_regression(
            [r["n"] for r in out["sparse"]],
            [r["total_s"] for r in out["sparse"]])
        if verbose:
            print(f"sparse scaling slope: {out['sparse_slope']:.2f} "
                  f"(reference sparse path: ~1.7)")
        return out

    return checkpoint.run_or_resume(
        results_path, lambda: average_runs([compute_once()
                                            for _ in range(runs)]),
        use_saved=use_saved, verbose=verbose)


def average_runs(results_list):
    """Merge several runs of :func:`main` / :func:`main_sparse` by
    averaging the timing fields per n (the reference's multi-run
    averaging, CompareVariousNumberOfPoints.py:286-356). The other fields
    come from the first run; the slopes are refit from the averages."""
    if len(results_list) == 1:
        return copy.deepcopy(results_list[0])
    out = copy.deepcopy(results_list[0])

    def avg_series(key, sub=None):
        for i, row in enumerate(out.get(key) or []):
            tgt = row[sub] if sub else row
            for t in ("pre_s", "opt_s", "total_s"):
                if t in tgt:
                    tgt[t] = float(np.mean([
                        (res[key][i][sub] if sub else res[key][i])[t]
                        for res in results_list]))

    avg_series("krylov")
    avg_series("sparse")
    for sub in ("derivative", "direct"):
        avg_series("dense", sub)
    if "sparse" in out:
        out["sparse_slope"] = log_regression(
            [r["n"] for r in out["sparse"]],
            [r["total_s"] for r in out["sparse"]])
    if "dense" in out:
        out["derivative_slope"] = log_regression(
            [r["n"] for r in out["dense"]],
            [r["derivative"]["pre_s"] + r["derivative"]["opt_s"]
             for r in out["dense"]])
    out["num_runs"] = len(results_list)
    return out


def plot_results(*args, **kwargs):
    """The reference's log-log timing plot (:418-599): not ported yet."""
    _refuse_plot("plot_results")


def main(dense_sides=(23, 27, 32, 45, 54, 64),
         krylov_ns=(4096, 16384, 65536), results_path=None,
         use_saved=False, verbose=True, runs=1, plot=False, *,
         device="cuda"):
    """The dense sweep over the reference's n in {529 ... 4096} (grid
    sides 23, 27, 32, 45, 54, 64; CompareVariousNumberOfPoints.py:
    247-261) and the Krylov path at ``krylov_ns`` random points, with the
    dense derivative method's slope; ``runs`` repetitions averaged."""
    if plot:
        _refuse_plot("main(plot=True)")

    def compute_once():
        out = {"dense": [], "krylov": []}
        for side in dense_sides:
            n, res = run_dense(side, device=device)
            res["n"] = n
            out["dense"].append(res)
            if verbose:
                d = res["derivative"]
                print(f"dense n={n}: derivative pre {d['pre_s']:.2f}s "
                      f"opt {d['opt_s']:.2f}s eta={d['eta']:.3f}")
        for n in krylov_ns:
            res = run_krylov(n, device=device)
            res["n"] = n
            out["krylov"].append(res)
            if verbose:
                print(f"krylov n={n}: pre {res['pre_s']:.2f}s "
                      f"opt {res['opt_s']:.2f}s eta={res['eta']:.3f}")
        out["derivative_slope"] = log_regression(
            [r["n"] for r in out["dense"]],
            [r["derivative"]["pre_s"] + r["derivative"]["opt_s"]
             for r in out["dense"]])
        if verbose:
            print(f"derivative-method scaling slope: "
                  f"{out['derivative_slope']:.2f} "
                  f"(reference CPU path is ~3 for dense)")
        return out

    return checkpoint.run_or_resume(
        results_path, lambda: average_runs([compute_once()
                                            for _ in range(runs)]),
        use_saved=use_saved, verbose=verbose)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--use-saved", action="store_true")
    p.add_argument("--results-path", default=None)
    p.add_argument("--small", action="store_true",
                   help="reduced sizes for smoke runs")
    p.add_argument("--sparse", action="store_true",
                   help="the reference's tapered race (n = 2^16, 2^18, "
                        "2^20; rho = 0.005)")
    p.add_argument("--max-n", type=int, default=None,
                   help="cap the largest sparse n")
    p.add_argument("--runs", type=int, default=1,
                   help="repetitions to average (reference :286-356)")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    kw = dict(results_path=a.results_path, use_saved=a.use_saved,
              runs=a.runs, plot=a.plot, device=a.device)
    if a.sparse:
        ns = tuple(n for n in (65536, 262144, 1048576)
                   if a.max_n is None or n <= a.max_n)
        main_sparse(ns=ns, **kw)
    elif a.small:
        main(dense_sides=(16, 23, 32), krylov_ns=(4096,), **kw)
    else:
        main(**kw)
