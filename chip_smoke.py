#!/usr/bin/env python3
"""Smoke run of gppe_tpu_torch on one NVIDIA GPU.

Drives the port's main path - the matrix-free profile-likelihood MLE at
n = 100,000 random 2-D points, Matern nu = 0.5, rho = 0.1 - through its
public entry points (MaternOperator -> KrylovProfileLikelihood -> fit),
after building the CUDA kernel from the sources in this checkout and
checking it against its plain PyTorch version on the card.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: require CUDA; print the card, power limit, torch and CUDA
     versions and the float32 precision settings after setup();
  2. build: compile (or load) the kernel library, print the seconds;
  3. kernel vs plain float64 on the card: ragged n, several widths, all
     four nu branches, d in {1, 2, 3}, an anisotropic scale and a
     rectangular K; bounds of the reference's on-chip tier;
  4. the n = 1024 engine on cuda (float32 kernel path) vs cpu (float64
     plain path) from the same numpy data and random block;
  5. the main path at n = 100,000, with launch counts;
  6. kernel and plain time (and error) at the main path's shape.
Then one JSON line of kernel records, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gppe_tpu_torch.models.large_scale import KrylovProfileLikelihood
from gppe_tpu_torch.ops import _build, cuda_kernels, kernels
from gppe_tpu_torch.ops.operators import MaternOperator
from gppe_tpu_torch.utils import config
from gppe_tpu_torch.utils import data as data_utils

F32, F64 = torch.float32, torch.float64
N_MAIN, RHO, NU = 100_000, 0.1, 0.5
STEPS, PROBES = 64, 16

# reference on-chip bounds (tests_tpu/test_onchip.py)
FROB_TOL, MAXABS_TOL, TRACE_RTOL, SYM_TOL = 2e-5, 5e-4, 1e-5, 1e-6


def log(**kv):
    print(json.dumps(kv), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    config.setup()
    log(phase="device", nvidia_smi=nvidia_smi(),
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, precision=config.precision_state())
    return torch.device("cuda", 0)


def phase_build():
    fresh = not _build.library_path().is_file()
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    log(phase="build", seconds=seconds, built=fresh,
        library=str(_build.library_path().relative_to(
            _build.BUILD_DIR.parent)),
        nvcc=" ".join(_build.nvcc_command("nvcc", "<lib>")))


def compare(got, want):
    got = got.double()
    frob = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    return frob, float(torch.max(torch.abs(got - want)))


def symmetry(u, v, Ku, Kv):
    """u.Kv vs v.Ku, dots in float64 so only the kernel's rounding shows.
    K is exactly symmetric in the kernel, so the gap is float32 summation
    error. It is taken relative to |u| |Kv|, the scale that rounding is
    relative to: the reference's max(|u.Kv|, 1) depends on chance
    cancellation in the dot (it ranged 1e-7 .. 1.1e-6 over four draws at
    n = 1024 in a float32 emulation of this kernel's summation order), so
    it is logged but not held to the bound."""
    a = float((u.double() * Kv.double()).sum())
    b = float((v.double() * Ku.double()).sum())
    scale = float(torch.linalg.norm(u.double()) * torch.linalg.norm(
        Kv.double()))
    return {"symmetry_rel_err": abs(a - b) / scale,
            "symmetry_rel_err_vs_dot": abs(a - b) / max(abs(a), 1.0)}


def parity_case(dev, n, r, nu, d=2, scale=RHO, n_cols=None, seed=0):
    """One kernel launch (float32, with trace(K^2)) against the plain
    version in float64 on the card, dense K at these sizes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand((n, d), generator=g, device=dev)
    cols = (None if n_cols is None
            else torch.rand((n_cols, d), generator=g, device=dev))
    nc = n if n_cols is None else n_cols
    V = (torch.randn((nc, r), generator=g, device=dev) if r else None)
    got, fro = cuda_kernels.matern_matmat(pts, scale, V, nu,
                                          points_cols=cols, frobenius=True)
    torch.cuda.synchronize()
    want, fro_want = cuda_kernels.matern_matmat_plain(
        pts.double(), kernels.broadcast_scale(scale, d, dtype=F64,
                                              device=dev),
        None if V is None else V.double(), nu,
        points_cols=None if cols is None else cols.double(),
        frobenius=True, block_rows=4096)
    rec = {"n": n, "n_cols": nc, "r": r, "nu": nu, "d": d,
           "scale": scale, "trace_rel_err":
           abs(float(fro) - float(fro_want)) / float(fro_want)}
    ok = rec["trace_rel_err"] < TRACE_RTOL
    if r:
        assert got.shape == (n, r) and bool(torch.isfinite(got).all())
        rec["frob_rel_err"], rec["max_abs_err"] = compare(got, want)
        ok = (ok and rec["frob_rel_err"] < FROB_TOL
              and rec["max_abs_err"] < MAXABS_TOL)
    if n_cols is None and r == 1:
        u = torch.randn((n, 1), generator=g, device=dev)
        Ku = cuda_kernels.matern_matmat(pts, scale, u, nu)
        rec.update(symmetry(u, V, Ku, got))
        ok = ok and rec["symmetry_rel_err"] < SYM_TOL
    log(phase="parity", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain version: {rec}")


def phase_parity(dev):
    cases = [dict(n=n, r=r, nu=0.5) for n in (1024, 3001)
             for r in (0, 1, 7, 24, 33)]
    cases += [dict(n=3001, r=24, nu=nu) for nu in (1.5, 2.5, 150.0)]
    cases += [dict(n=3001, r=7, nu=nu, d=d, seed=d)
              for d in (1, 3) for nu in (0.5, 2.5)]
    cases += [dict(n=3001, r=24, nu=1.5, scale=[0.1, 0.25]),
              dict(n=3001, r=7, nu=0.5, scale=[0.08, 0.2], n_cols=1025,
                   seed=2)]
    for c in cases:
        parity_case(dev, **c)


def make_problem(n, seed):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    return pts, z, X


def phase_engine_1024(dev):
    pts, z, X = make_problem(1024, 0)
    rng = np.random.RandomState(1)
    probes = np.sign(rng.standard_normal((1024, 16)))
    v_defl = rng.standard_normal((1024, 1))
    fits = {}
    for name, device, dtype in (("cuda_f32", dev, F32), ("cpu_f64", "cpu",
                                                          F64)):
        op = MaternOperator(pts, RHO, nu=NU, device=device, dtype=dtype)
        eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=32,
                                      num_probes=16, device=device,
                                      dtype=dtype, probes=probes,
                                      v_defl=v_defl)
        fits[name] = eng.fit()
    a, b = fits["cuda_f32"], fits["cpu_f64"]
    eta_rel = abs(a["eta"] - b["eta"]) / abs(b["eta"])
    sigma0_rel = abs(a["sigma0"] - b["sigma0"]) / abs(b["sigma0"])
    ok = (a["success"] and b["success"] and eta_rel < 5e-2
          and sigma0_rel < 5e-3)
    log(phase="engine_1024", ok=ok, cuda_f32=a, cpu_f64=b,
        eta_rel_err=eta_rel, sigma0_rel_err=sigma0_rel)
    if not ok:
        raise AssertionError("n = 1024 engine: cuda and cpu fits disagree")


def phase_main_path(dev):
    """bench.py's sec_der1_n100k, on the port."""
    pts, z, X = make_problem(N_MAIN, 7)
    op = MaternOperator(pts, RHO, nu=NU, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_kernels.reset_launch_counts()
    setups, launches = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=STEPS,
                                      num_probes=PROBES, device=dev)
        torch.cuda.synchronize()
        setups.append(time.perf_counter() - t0)
        launches.append(cuda_kernels.launch_counts["matern_matmat"])

    eng.der1(1.0)
    n_evals = 100
    t0 = time.perf_counter()
    for i in range(n_evals):
        eng.der1(0.5 + 2.0 * (i / n_evals))
    host_evals_per_s = n_evals / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    total_launches = cuda_kernels.launch_counts["matern_matmat"]
    finite = all(np.isfinite(v) for v in (res["eta"], res["sigma0"],
                                          res["sigma"]))
    ok = (res["success"] and finite and 0.19 < res["sigma0"] < 0.21
          and launches == [STEPS + 1, 2 * (STEPS + 1)]
          and total_launches == 2 * (STEPS + 1))
    log(phase="main_path", ok=ok, n=N_MAIN, rho=RHO, nu=NU,
        lanczos_steps=STEPS, num_probes=PROBES,
        setup_first_seconds=setups[0], setup_second_seconds=setups[1],
        der1_evals_per_s_host_numpy=host_evals_per_s, fit_seconds=fit_s,
        eta_star=res["eta"], sigma0=res["sigma0"], sigma=res["sigma"],
        fit_iterations=res["iterations"],
        launches_after_each_setup=launches,
        launches_total=total_launches,
        peak_device_memory_bytes=torch.cuda.max_memory_allocated(dev))
    if not ok:
        raise AssertionError(f"main path failed: {res}, launches {launches}")
    return total_launches


def timed(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_kernel_time(dev):
    """Kernel vs plain at the main path's shape: n = 100,000 points, the
    engine's r = 24 block; and the r = 0 trace(K^2) launch."""
    pts, _, _ = make_problem(N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    V = torch.randn((N_MAIN, 24), generator=g, device=dev)
    scale = kernels.broadcast_scale(RHO, 2, dtype=F32, device=dev)

    # the kernel wrapper (what the engine calls) vs the plain version the
    # operator would run with its default 1024-row blocks, both float32
    kern = lambda: cuda_kernels.matern_matmat(P, scale, V, NU)  # noqa: E731
    plain = lambda: cuda_kernels.matern_matmat_plain(  # noqa: E731
        P, scale, V, NU, block_rows=1024)
    kern_fro = lambda: cuda_kernels.matern_matmat(  # noqa: E731
        P, scale, None, NU, frobenius=True)
    plain_fro = lambda: cuda_kernels.matern_matmat_plain(  # noqa: E731
        P, scale, None, NU, frobenius=True, block_rows=1024)

    got, fro = cuda_kernels.matern_matmat(P, scale, V, NU, frobenius=True)
    want, fro_want = cuda_kernels.matern_matmat_plain(
        P.double(), scale.double(), V.double(), NU, frobenius=True,
        block_rows=1024)
    frob, max_abs = compare(got, want)
    trace_rel = abs(float(fro) - float(fro_want)) / float(fro_want)
    ok = (frob < FROB_TOL and max_abs < MAXABS_TOL
          and trace_rel < TRACE_RTOL)

    reps = 7
    times = {"kernel": [], "plain": [], "kernel_fro": [], "plain_fro": []}
    for f in (kern, plain, kern_fro, plain_fro):
        f()                                           # warm-up
    for _ in range(reps):                             # in turns
        times["kernel"] += timed(kern, 1)
        times["plain"] += timed(plain, 1)
        times["kernel_fro"] += timed(kern_fro, 1)
        times["plain_fro"] += timed(plain_fro, 1)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(phase="kernel_time", ok=ok, n=N_MAIN, r=24, reps=reps,
        frob_rel_err=frob, max_abs_err=max_abs, trace_rel_err=trace_rel,
        kernel_ms_median=med["kernel"], plain_f32_ms_median=med["plain"],
        kernel_trace_ms_median=med["kernel_fro"],
        plain_f32_trace_ms_median=med["plain_fro"],
        kernel_ms_all=times["kernel"], plain_ms_all=times["plain"])
    if not ok:
        raise AssertionError("kernel disagrees with the plain version at "
                             "the main path's shape")
    return max_abs, med["kernel"], med["plain"]


def main():
    dev = phase_device()
    phase_build()
    phase_parity(dev)
    phase_engine_1024(dev)
    launches = phase_main_path(dev)
    max_abs, ms, plain_ms = phase_kernel_time(dev)
    print(nvidia_smi())
    print(json.dumps({"kernels": [{
        "name": "matern_matmat", "route": "cuda",
        "source": "gppe_tpu_torch/csrc/matern_matmat.cu",
        "replaces": "gppe_tpu/ops/pallas_kernels.py:103",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
