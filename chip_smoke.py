#!/usr/bin/env python3
"""Smoke run of gppe_tpu_torch on one NVIDIA GPU.

Drives the port's paths through their public entry points, after
building the CUDA kernels from the sources in this checkout and checking
each against its plain PyTorch version on the card:

  * the matrix-free profile-likelihood MLE at n = 100,000 random 2-D
    points, Matern nu = 0.5, rho = 0.1 (MaternOperator ->
    KrylovProfileLikelihood -> fit; the products on the tensor-core kernel
    matern_matmat_mma, 'highest' as 3xTF32, and trace(K^2) on
    matern_matmat);
  * the grid-batched MLE over 8 rhos at n = 100,000
    (GridKrylovProfileLikelihood -> fit_all; the products on the
    tensor-core kernel matern_matmat_multirho_mma, 'highest' as 3xTF32,
    and the traces on matern_matmat_multirho), also under 'bf16x3';
  * the tapered-sparse MLE at n = 2^20 grid points (TaperedMaternOperator
    -> KrylovProfileLikelihood -> fit; the products on the tensor-core
    kernel matern_matmat_blocksparse_mma, 'highest' as 3xTF32, and the
    trace on matern_matmat_blocksparse), also under 'bf16x3';
  * the precision-matrix path: the n = 100,000 MLE under each tile-dot
    mode (drivers.profile_kernel_matrix.run_one -> fit; every mode on the
    tensor-core kernel matern_matmat_mma), and the roofline sweep
    (drivers.roofline_matvec.main), the caller of the Gram form;
  * the exact dense path and the public API: generate_correlation and
    GaussianProcess(X, K, method).train(z) at the reference's dense
    configuration (n = 4096; float64 eigendecomposition and Cholesky on
    the card), then n = 8192; and GaussianProcess(X, MaternOperator)
    at n = 100,000, whose fit and likelihood run matern_matmat_mma at
    widths 1, 6, 16 and 32 and matern_matmat for trace(K^2);
  * general Matern nu on the general-nu kernel matern_general.cu: the
    dense API at nu = 1.2 and 3.7 (its elementwise entry), MaternOperator
    at n = 10,000 through KrylovProfileLikelihood (its product and trace
    entries), and the (rho, nu) search of
    drivers.find_optimal_covariance (main_large: n = 10,000 over an 8 x 8
    grid of general nus, one batched product call a Lanczos step; main
    at a reduced size);
  * the rest of the tapered slice: the scipy-sparse route
    (generate_correlation(sparse=True) on the native host builder ->
    GaussianProcess over a SparseOperator on cuSPARSE's SpMM) at
    n = 2^18, and the tapered path at a general nu at n = 2^20 on the
    tapered general-nu kernel matern_blocksparse_general.cu.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: require CUDA; print the card, power limit, torch and CUDA
     versions and the float32 precision settings after setup();
  2. build: compile (or load) the kernel library, print the seconds;
  3. matern_matmat vs plain float64 on the card: ragged n, several widths
     (6 and 32 those of the public API's CG and Hutchinson probes),
     all four nu branches, d in {1, 2, 3}, an anisotropic scale and a
     rectangular K; bounds of the reference's on-chip tier; the product's
     gap to its plain 3xTF32 version logged beside them;
  4. the n = 1024 engine on cuda (float32 kernel path) vs cpu (float64
     plain path) from the same numpy data and random block;
  5. the main path at n = 100,000, with launch counts;
  6. kernel and plain time (and error) at the main path's shape: the
     'highest' product and the trace(K^2) launch, whose bits must be the
     same run to run and in every dot mode;
  7. matern_matmat_multirho vs plain float64 on the card, with each
     product's gap to its plain 3xTF32 version logged; at B = 1 vs
     matern_matmat; at n = 100,000, B = 1, rho = 0.3, where the sums are
     longest;
  8. matern_matmat_blocksparse vs plain float64 on the card, at taper
     thresholds that no pair comes within 1e-5 (relative) of, with the gap
     to the plain 3xTF32 version logged;
  9. the n = 1024 grid engine on cuda vs fresh single-operator engines and
     vs the same grid engine on cpu float64;
 10. the grid path at n = 100,000, 8 rhos, with launch counts;
 11. the n = 16384 tapered engine on cuda vs cpu float64;
 12. the tapered path at n = 2^20, with launch counts;
 13. kernel and plain time (and error, the multi-rho one rho by rho) of
     the multi-rho and block-sparse kernels at their paths' shapes: the
     'highest' product and the trace launch (both traces the same bits
     run to run and in every dot mode; the block-sparse one beside its
     full walk of the same list);
 14. the tile-dot modes and the Gram form vs their own plain versions
     (float32, same rounding) and vs plain float64 'highest': the three
     tensor-core kernels and the Gram flag;
 15. the n = 1024 engine under 'bf16x3' on cuda vs cpu float64 'highest';
     the small grid and tapered engines, then the grid path (n = 100,000,
     8 rhos) and the tapered path (n = 2^20) at full size, under 'bf16x3'
     as the module default, with launch counts;
 16. the precision-matrix path at n = 100,000: the three modes, each
     engine fitted, with launch counts;
 17. the roofline sweep at n = 100,000, 12 rows;
 18. kernel and plain time (and error) of the mode and Gram kernels at
     their paths' shapes, the multi-rho one rho by rho, 'highest' held
     beside the bf16 modes;
 19. the dense public API at n = 4096 (a 64 x 64 grid, rho 0.1, nu 0.5,
     degree-2 basis, noise 0.2): generate_correlation (symmetric, unit
     diagonal, within 1e-6 of float64), GaussianProcess.train in 'direct'
     and 'profiled' (within 1e-3 of each other, sigma0 in (0.18, 0.22)),
     'profiled' under imate_method 'cholesky' (the Krylov route over the
     dense K) and with interpolate=True (eta within 5e-2), likelihood at
     the optimum on the spectral and the operator route; then both
     methods at n = 8192 (a 128 x 64 grid); seconds of assembly,
     eigendecomposition, rotation and fit (train twice: cold and again);
 20. GaussianProcess(X, MaternOperator, 'profiled') on phase 5's problem:
     the fit equal to phase 5's bit for bit, likelihood at it through CG
     (iterations per column) and SLQ, Hutchinson's traceinv at 32 probes,
     with the path's launch counts; then matern_matmat at the route's
     widths 1, 6, 16, 32 against plain float64, its plain version and
     its bound;
 21. the general-nu kernel (matern_general.cu) against plain float64:
     k over x in geomspace(1e-5, 40) at nu in {0.01, 0.3, 1.2, 3.7, 10,
     24.9} (finite, in [0, 1], within 3e-5), the product at r in {1, 7,
     16, 24} (the symmetric walk, the same bits twice; the rectangular
     walk at r = 24) and the trace at n = 1000 and 4096 (2-D) and 1000
     (3-D), within 1e-5 (the trace on the square and the rectangular walk,
     the same bits twice); one batched product launch over the six nus
     equal bit for bit to their single calls and to itself in bands of 7
     tile pairs, one batched trace launch over them equal bit for bit to
     their single calls; at the closed forms the
     general kernel's branch, and matern_matmat launching the
     closed-form kernels only;
 22. the dense API at general nu: generate_correlation on phase 19's grid
     at nu = 1.2 and 3.7 (the elementwise entry), GaussianProcess.train
     in 'direct' and 'profiled'; the elementwise entry timed;
 23. MaternOperator at n = 10,000, nu = 1.2, through
     KrylovProfileLikelihood.fit (the product and trace entries, no
     closed-form kernel) against the float64 eigh route on the same K;
     the product timed at n = 10^4 and 10^5 (r = 24), the trace at both;
     at 10^5 the product in bands of its walk, its first and last 300 rows
     against float64, the same bits in bands of a third the size, and the
     trace against a float64 sum over an interpolated float64 table of k;
 24. the (rho, nu) search: drivers.find_optimal_covariance.main_large at
     its defaults (n = 10,000, an 8 x 8 grid of general nus, matrix-free:
     one batched product call a Lanczos step for all 64 points, a launch
     per band of its walk: 40 x 13 launches; one trace launch for all 64
     points), its points (0.1, 1.0) and
     (0.3, 25.0) against the float64 eigh route on the same K (eta within
     5e-2, the lp gap logged); and main cut to a 30 x 30 grid of points, a
     6 x 6 (rho, nu) grid and DE with popsize 10 for at most 6
     generations, its lp at three grid points
     within 1e-5 of the CPU's float64 build_objective.
 25. the tapered general-nu kernel (matern_blocksparse_general.cu, G2)
     against plain float64: products at r in {1, 7, 24} and traces at
     n = 1000 and 4096 (2-D) and 1000 (3-D), nu in {0.3, 1.2, 3.7, 24.9},
     at thresholds clear of every pair, within 1e-5; the trace the same
     bits twice and with and without the taper skip; a closed-form nu
     through the same entry point launching the closed-form tapered
     kernels only;
 26. the scipy-sparse public route at n = 2^18 (a 512 x 512 grid, rho
     0.005, density 1e-3, nu 1/2): generate_correlation(sparse=True) on
     the native host builder, GaussianProcess(X, Kcsr, 'profiled').train(z)
     over a float64 SparseOperator (cuSPARSE's SpMM, the Krylov route)
     against TaperedMaternOperator's fit on the same points and random
     block (eta 5e-2, sigma0 5e-3); the SpMM timed at the route's width
     beside its byte bound (a library call, not a kernel of the port); the
     general-nu CSR builder at n = 2^16, nu = 1.2, on the card, its pattern
     against the native builder's at nu = 1/2 (entries kept by one only
     must lie within 1e-5 of the threshold);
 27. the tapered general-nu engine at n = 4096 (grid side 64, rho 0.01,
     density 0.004: the n = 2^20 path's taper radius in scaled units;
     tiles of 128, nu = 1.2, 8 steps, 8 probes) on cuda (G2, float32)
     against the CPU (the plain version, float64) from the same data and
     random block (eta 5e-2, sigma0 5e-3);
 28. the tapered path at n = 2^20 at nu = 1.2 (phase 12's configuration):
     exactly 64 launches of G2's product and one of its trace, the fit
     finite with sigma0 in (0.18, 0.22), where phase 27's float64 fit lies
     too; G2's product (r = 24) and trace timed over the full list against
     their bounds (every unordered pair its distance and a compare, only
     the pairs within the taper radius a k, from this run's trips), and
     against the plain version on the first 32 row tiles' list; the trace
     the same bits with and without the taper skip on both lists.
The general-nu bounds count each pair's work from the trips this run's
pairs take (a sample of 2^21 per shape) and the FP32 and MUFU operations
of each piece of the device function in this checkout's machine code
(chip_profile.py sass-mix).
Then the card's name and power limit, one JSON line of kernel records, and
as the last line {"ok": true, "device": {...}}. Exits non-zero without a
CUDA device. Each bound counts what the inputs need: the traces the pairs
of a symmetric K once (n (n + 1) / 2 dense; the tapered list's tile pairs
i < j and the diagonal tiles' triangles), and every k its sqrt and exp,
split at best between the SFU and the FP32 pipe (see bound()), beside its
bytes, CUDA-core and tensor-core operations.
"""

import json
import statistics
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import torch

import gppe_tpu_torch
from gppe_tpu_torch.drivers import (find_optimal_covariance,
                                    profile_kernel_matrix, roofline_matvec)
from gppe_tpu_torch.models import direct_likelihood
from gppe_tpu_torch.models.grid_krylov import GridKrylovProfileLikelihood
from gppe_tpu_torch.models.large_scale import KrylovProfileLikelihood
from gppe_tpu_torch import native
from gppe_tpu_torch.ops import _build, assembly, cuda_kernels, kernels, linalg
from gppe_tpu_torch.ops import stochastic, taper
from gppe_tpu_torch.ops.operators import MaternOperator, SparseOperator
from gppe_tpu_torch.ops.taper import TaperedMaternOperator
from gppe_tpu_torch.utils import config
from gppe_tpu_torch.utils import data as data_utils

F32, F64 = torch.float32, torch.float64
N_MAIN, RHO, NU = 100_000, 0.1, 0.5
STEPS, PROBES = 64, 16
# the grid path (the reference's sec_grid_krylov)
GRID_RHOS, GRID_STEPS, GRID_PROBES = np.linspace(0.05, 0.3, 8), 32, 8
# the tapered path (the reference's sparse race at its largest size)
TAPER_SIDE, TAPER_SCALE, TAPER_DENSITY = 1024, 0.005, 1e-3

# published peaks of one H100 SXM: device-memory rate, float32 rate
# outside the tensor cores and the dense bf16 and tf32 rates of the tensor
# cores; a kernel's bound is the largest of its bytes and of each class of
# its operations over that class's own peak
PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S = 3.35e12, 67e12
PEAK_BF16_OPS_PER_S, PEAK_TF32_OPS_PER_S = 989e12, 495e12
# the SFU: 16 MUFU operations (RSQ, SQRT, EX2) per clock and SM on sm_90
# (the throughput table of NVIDIA's CUDA C++ Programming Guide), times the
# SM count and the card's maximum SM clock, which phase_device reads; until
# then those of an H100 SXM (132 SMs, 1980 MHz)
MUFU_PER_CLOCK_AND_SM = 16
PEAK_MUFU_PER_S = MUFU_PER_CLOCK_AND_SM * 132 * 1980e6
# a sqrt or exp taken off the SFU onto the FP32 pipe: the FP32 operations
# of a polynomial exp2 (a Cody-Waite reduction, a degree-5 polynomial, the
# exponent added as an integer) in its sm_90a machine code, counted as the
# FP32 term counts them (FFMA 2, FADD and FMUL 1; integer work free), as
# `chip_profile.py sass-mix` prints it. A Newton sqrt costs more, so the
# count is a floor for both
EMULATED_MUFU_FP32_OPS = 13
# operations per pair beyond the distance: scale/sqrt/exp and the closed
# form's polynomial, by nu
NU_OPS = {0.5: 3, 1.5: 7, 2.5: 10}
NU_OPS_GAUSS = 3

# eta* of the main path with its products as float32 FMAs on the CUDA
# cores, where 'highest' ran before it moved to the tensor cores as 3xTF32
# (NVIDIA H100 80GB HBM3): logged beside this run's, the two should agree
# to 1e-4 (the gap 'bf16x3' leaves is 1.1e-4)
ETA_STAR_FP32_FMA = 88.6670

# reference on-chip bounds (tests_tpu/test_onchip.py)
FROB_TOL, MAXABS_TOL, TRACE_RTOL, SYM_TOL = 2e-5, 5e-4, 1e-5, 1e-6
# the dense traces at n = 100,000 (phases 6 and 13): 1.4-1.8e-8 from
# float64 in the runs on an H100, while one tile pair of 128 x 128 points
# dropped or counted twice moves them by ~3e-6 of the 306,153 pairs' sum;
# 1e-6 sits between, so a fault of the walk cannot pass. The tapered
# traces (phases 8, 13, 14) are held to it too: at n = 2^20 a diagonal one
# of the walk's 153,312 units of 128 x 128 points alone holds 128 entries
# k = 1, a share of the trace that phase 13 logs (3.0e-6 on an H100, where
# the tapered traces read at most 5.8e-8 from float64 at every n)
DENSE_TRACE_RTOL = 1e-6


def log(**kv):
    print(json.dumps(kv), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def phase_device():
    global PEAK_MUFU_PER_S
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    config.setup()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    PEAK_MUFU_PER_S = MUFU_PER_CLOCK_AND_SM * sms * clock
    log(phase="device", nvidia_smi=nvidia_smi(),
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, precision=config.precision_state(),
        sms=sms, max_sm_clock_hz=clock, peak_mufu_per_s=PEAK_MUFU_PER_S,
        emulated_mufu_fp32_ops=EMULATED_MUFU_FP32_OPS)
    return torch.device("cuda", 0)


def phase_build():
    fresh = not _build.library_path().is_file()
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    log(phase="build", seconds=seconds, built=fresh,
        library=str(_build.library_path().relative_to(
            _build.BUILD_DIR.parent)),
        sources=list(_build.SOURCES), nvcc_flags=list(_build.NVCC_FLAGS))


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
        rec["frob_vs_tf32x3_plain"] = tf32x3_gap(got, pts, cols, scale, V,
                                                 nu)
    if n_cols is None and r == 1:
        u = torch.randn((n, 1), generator=g, device=dev)
        Ku = cuda_kernels.matern_matmat(pts, scale, u, nu)
        rec.update(symmetry(u, V, Ku, got))
        ok = ok and rec["symmetry_rel_err"] < SYM_TOL
    log(phase="parity", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain version: {rec}")


def tf32x3_gap(got, rows, cols, scale, V, nu):
    """Frobenius gap of the kernel's 'highest' product ``got`` (of the
    first rows only, if it has fewer than ``rows``) to its plain 3xTF32
    version on the same float32 K (``cuda_kernels._tf32x3_dot_plain``):
    logged beside the bounds, which hold the kernel to float64."""
    m = got.shape[0]
    dist = kernels.pairwise_scaled_distance(
        rows[:m], rows if cols is None else cols,
        kernels.broadcast_scale(scale, rows.shape[1], dtype=F32,
                                device=rows.device))
    emu = cuda_kernels._tf32x3_dot_plain(kernels.matern(dist, nu), V)
    return compare(got, emu.double())[0]


def phase_parity(dev):
    # r = 6 and 32: the public API's CG over the basis X and Hutchinson's
    # probes (phase 20)
    cases = [dict(n=n, r=r, nu=0.5) for n in (1024, 3001)
             for r in (0, 1, 6, 7, 24, 32, 33)]
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
        launches.append({k: v for k, v in cuda_kernels.launch_counts.items()
                         if v})

    eng.der1(1.0)
    n_evals = 100
    t0 = time.perf_counter()
    for i in range(n_evals):
        eng.der1(0.5 + 2.0 * (i / n_evals))
    host_evals_per_s = n_evals / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    total_launches = {k: v for k, v in cuda_kernels.launch_counts.items()
                      if v}
    finite = all(np.isfinite(v) for v in (res["eta"], res["sigma0"],
                                          res["sigma"]))
    # a construction: STEPS products on the tensor-core kernel ('highest'
    # as 3xTF32) and one trace(K^2) launch of the FP32 kernel
    per_setup = {"matern_matmat_mma": STEPS, "matern_matmat": 1}
    ok = (res["success"] and finite and 0.19 < res["sigma0"] < 0.21
          and launches == [per_setup, {k: 2 * v for k, v in
                                       per_setup.items()}]
          and total_launches == launches[1])
    log(phase="main_path", ok=ok, n=N_MAIN, rho=RHO, nu=NU,
        lanczos_steps=STEPS, num_probes=PROBES,
        setup_first_seconds=setups[0], setup_second_seconds=setups[1],
        der1_evals_per_s_host_numpy=host_evals_per_s, fit_seconds=fit_s,
        eta_star=res["eta"], sigma0=res["sigma0"], sigma=res["sigma"],
        eta_star_rel_gap_to_fp32_fma=rel_gap(res["eta"], ETA_STAR_FP32_FMA),
        fit_iterations=res["iterations"],
        launches_after_each_setup=launches,
        launches_total=total_launches,
        peak_device_memory_bytes=torch.cuda.max_memory_allocated(dev))
    if not ok:
        raise AssertionError(f"main path failed: {res}, launches {launches}")
    return total_launches, res


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
    engine's r = 24 block under 'highest' (the tensor-core kernel, 3xTF32),
    and the r = 0 trace(K^2) launch (the FP32 kernel)."""
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
    # the trace again, and under each dot mode: the same bits
    trace_same_bits = all(
        float(cuda_kernels.matern_matmat(P, scale, None, NU, dot_mode=m,
                                         frobenius=True)[1]) == float(fro)
        for m in cuda_kernels.DOT_MODES)
    # u.Kv vs v.Ku at the full shape, one column each
    u, v = V[:, :1].contiguous(), V[:, 1:2].contiguous()
    sym = symmetry(u, v, cuda_kernels.matern_matmat(P, scale, u, NU),
                   cuda_kernels.matern_matmat(P, scale, v, NU))
    # the first 2048 rows against the plain 3xTF32 version (logged)
    tf32x3 = tf32x3_gap(got[:2048], P, None, RHO, V, NU)
    ok = (frob < FROB_TOL and max_abs < MAXABS_TOL
          and trace_rel < DENSE_TRACE_RTOL
          and sym["symmetry_rel_err"] < SYM_TOL and trace_same_bits)

    med, times = median_in_turns({"kernel": kern, "plain": plain,
                                  "kernel_fro": kern_fro,
                                  "plain_fro": plain_fro})
    r, d = 24, 2
    pairs = N_MAIN * N_MAIN
    # the product as 3xTF32: three tf32 products on the tensor cores, and
    # per pair on the CUDA cores the distance, k and the split of k (3),
    # on the SFU the sqrt and the exp of k
    bound_ms, bound_by, bound_term = bound(
        4 * (N_MAIN * d + 2 * N_MAIN * r),
        pairs * (3 * d + nu_ops(NU) + 3), tf32_ops=pairs * 2 * r * 3,
        mufu_ops=pairs * nu_mufu(NU))
    # what the same product would need as float32 FMAs on the CUDA cores
    bound_fp32_ms, _, _ = bound(4 * (N_MAIN * d + 2 * N_MAIN * r),
                                pairs * (3 * d + nu_ops(NU) + 2 * r),
                                mufu_ops=pairs * nu_mufu(NU))
    # the trace: K is symmetric, so n (n + 1) / 2 pairs, each the
    # distance, k and one FMA for k^2
    half = N_MAIN * (N_MAIN + 1) // 2
    trace_bound_ms, trace_bound_by, trace_bound_term = bound(
        4 * N_MAIN * d + 8, half * (3 * d + nu_ops(NU) + 2),
        mufu_ops=half * nu_mufu(NU))
    log(phase="kernel_time", ok=ok, n=N_MAIN, r=r, reps=7,
        frob_rel_err=frob, max_abs_err=max_abs, trace_rel_err=trace_rel,
        trace_rtol=DENSE_TRACE_RTOL,
        trace_same_bits_run_to_run_and_in_every_mode=trace_same_bits,
        **sym, frob_vs_tf32x3_plain_first_2048_rows=tf32x3,
        kernel_ms_median=med["kernel"], plain_f32_ms_median=med["plain"],
        kernel_trace_ms_median=med["kernel_fro"],
        plain_f32_trace_ms_median=med["plain_fro"],
        bound_ms=bound_ms, bound_by=bound_by, bound_term=bound_term,
        bound_ms_as_fp32_fma=bound_fp32_ms,
        bound_mufu_only_ms=mufu_only_ms(pairs * nu_mufu(NU)),
        trace_bound_ms=trace_bound_ms, trace_bound_term=trace_bound_term,
        trace_bound_mufu_only_ms=mufu_only_ms(half * nu_mufu(NU)),
        kernel_ms_all=times["kernel"], plain_ms_all=times["plain"],
        kernel_trace_ms_all=times["kernel_fro"])
    if not ok:
        raise AssertionError("kernel disagrees with the plain version at "
                             "the main path's shape")
    return ({"max_abs_err": max_abs, "ms": med["kernel"],
             "plain_ms": med["plain"], "bound_ms": bound_ms,
             "bound_by": bound_by},
            {"max_abs_err": abs(float(fro) - float(fro_want)),
             "ms": med["kernel_fro"], "plain_ms": med["plain_fro"],
             "bound_ms": trace_bound_ms, "bound_by": trace_bound_by})


def bound(nbytes, ops, tensor_ops=0, tf32_ops=0, mufu_ops=0):
    """The least time (ms) the card could take: bytes over its memory
    rate, tensor-core operations on bf16 operands over its dense bf16
    rate, or on tf32 operands over its dense tf32 rate, or the CUDA cores'
    time, whichever is largest. The CUDA cores' time is the float32
    operations over their rate, with the MUFU operations (the sqrt and exp
    of each k) split at best between the SFU and the FP32 pipe: a kernel
    may take any share f of them off the SFU as polynomials of
    c = EMULATED_MUFU_FP32_OPS operations, so the term is the least over f of
    max(mufu (1 - f) / SFU rate, (ops + c mufu f) / float32 rate). Returns
    (ms, 'bytes' or 'operations', the term that binds: 'bytes', 'fp32',
    'sfu+fp32' (the split), 'bf16' or 'tf32')."""
    sfu = mufu_only_ms(mufu_ops) / 1e3
    fp32 = ops / PEAK_F32_OPS_PER_S
    moved = EMULATED_MUFU_FP32_OPS * mufu_ops / PEAK_F32_OPS_PER_S
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S, "fp32": fp32,
             "bf16": tensor_ops / PEAK_BF16_OPS_PER_S,
             "tf32": tf32_ops / PEAK_TF32_OPS_PER_S}
    if sfu > fp32:
        # the two times meet at f = (sfu - fp32) / (sfu + moved)
        terms["sfu+fp32"] = sfu * (fp32 + moved) / (sfu + moved)
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations",
            term)


def mufu_only_ms(mufu_ops):
    """The MUFU operations over the SFU's rate (ms): the floor of a design
    that leaves every sqrt and exp on the SFU, as the kernels do; logged
    beside bound_ms, which lets a design move some to the FP32 pipe."""
    return mufu_ops / PEAK_MUFU_PER_S * 1e3


def nu_ops(nu):
    return NU_OPS.get(nu, NU_OPS_GAUSS)


def nu_mufu(nu):
    """MUFU operations of one k from the squared distance: the sqrt and
    the exp, or the exp alone in the Gaussian limit; the same for IEEE k
    (MUFU.RSQ, MUFU.EX2) and for the bf16 modes' approximate one."""
    return 2 if nu in NU_OPS else 1


def median_in_turns(fns, reps=7):
    """Median ms of each function, timed in turns after one warm-up; every
    other turn runs them in reverse order (a, b, b, a), so that no function
    always runs right after a call of another kernel, nor always right
    after a call of its own (two copies of one kernel timed in a fixed
    order have read 3-7% apart on an H100)."""
    for f in fns.values():
        f()
    times = {k: [] for k in fns}
    order = list(fns)
    for rep in range(reps):
        for k in order if rep % 2 == 0 else order[::-1]:
            times[k] += timed(fns[k], 1)
    return {k: statistics.median(v) for k, v in times.items()}, times


# -- kernel 2: multi-rho ------------------------------------------------------

def multirho_case(dev, n, B, r, nu, d=2, seed=0):
    """One multi-rho launch (float32, with the traces) against its plain
    version in float64 on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand((n, d), generator=g, device=dev)
    rhos = torch.linspace(0.05, 0.3, B, device=dev) if B > 1 else \
        torch.tensor([RHO], device=dev)
    V = None
    if r:
        V = torch.randn((B, n, r), generator=g, device=dev)
    got, tk2 = cuda_kernels.matern_matmat_multirho(pts, rhos, V, nu,
                                                   return_frobenius=True)
    torch.cuda.synchronize()
    # the plain version sees what the kernel sees: float32 1/rho_b
    rhos64 = 1.0 / (1.0 / rhos).double()
    want, tk2_want = cuda_kernels.matern_matmat_multirho_plain(
        pts.double(), rhos64, None if V is None else V.double(), nu,
        return_frobenius=True, block_rows=4096)
    rec = {"n": n, "B": B, "r": r, "nu": nu, "d": d,
           "trace_rel_err": float(torch.max(
               torch.abs(tk2 - tk2_want) / tk2_want))}
    ok = rec["trace_rel_err"] < TRACE_RTOL
    if r:
        assert got.shape == (B, n, r) and bool(torch.isfinite(got).all())
        rec["frob_rel_err"], rec["max_abs_err"] = compare(got, want)
        ok = (ok and rec["frob_rel_err"] < FROB_TOL
              and rec["max_abs_err"] < MAXABS_TOL)
        rec["frob_vs_tf32x3_plain"] = multirho_tf32x3_gap(got, pts, rhos, V,
                                                          nu)
    log(phase="parity_multirho", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"matern_matmat_multirho disagrees with the "
                             f"plain version: {rec}")


def multirho_tf32x3_gap(got, pts, rhos, V, nu, rows=None):
    """Frobenius gap of the multi-rho kernel's 'highest' product ``got``
    (B, n, r) to its plain 3xTF32 version on the same float32 K(rho_b),
    over the first ``rows`` rows (default all): logged beside the bounds,
    which hold the kernel to float64."""
    m = got.shape[1] if rows is None else rows
    inv = 1.0 / rhos
    r0 = kernels.pairwise_scaled_distance(pts[:m], pts, 1.0)
    emu = torch.stack([cuda_kernels._tf32x3_dot_plain(
        kernels.matern(r0 * inv[b], nu), V[b]) for b in range(len(rhos))])
    return compare(got[:, :m], emu.double())[0]


def multirho_largest_rho_case(dev):
    """n = 100,000, B = 1 at the grid path's largest rho, 0.3: K is nearly
    dense there, the row sums reach a few hundred and each is the sum of
    782 tile sums (a plain float32 running sum carried 5.0e-4 of max-abs
    error in the FP32 kernel)."""
    pts, _, _ = make_problem(N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    rhos = torch.tensor([float(GRID_RHOS[-1])], device=dev)
    g = torch.Generator(device=dev).manual_seed(14)
    V = torch.randn((1, N_MAIN, 16), generator=g, device=dev)
    got = cuda_kernels.matern_matmat_multirho(P, rhos, V, NU)
    want = cuda_kernels.matern_matmat_multirho_plain(
        P.double(), 1.0 / (1.0 / rhos).double(), V.double(), NU,
        block_rows=4096)
    frob, max_abs = compare(got, want)
    ok = (bool(torch.isfinite(got).all()) and frob < FROB_TOL
          and max_abs < MAXABS_TOL)
    log(phase="parity_multirho_largest_rho", ok=ok, n=N_MAIN, B=1,
        rho=float(rhos[0]), r=16, frob_rel_err=frob, max_abs_err=max_abs,
        largest_abs_sum=float(torch.max(torch.abs(want))),
        frob_vs_tf32x3_plain_first_2048_rows=multirho_tf32x3_gap(
            got, P, rhos, V, NU, rows=2048))
    if not ok:
        raise AssertionError("multirho at rho = 0.3, n = 100,000 is out of "
                             "its bounds")


def phase_parity_multirho(dev):
    cases = [dict(n=n, B=B, r=r, nu=0.5)
             for n in (1024, 3001) for B in (1, 3, 8) for r in (0, 1, 16, 24)]
    cases += [dict(n=3001, B=3, r=16, nu=nu) for nu in (1.5, 2.5, 150.0)]
    cases += [dict(n=3001, B=3, r=7, nu=nu, d=d, seed=d)
              for d in (1, 3) for nu in (0.5, 2.5)]
    for c in cases:
        multirho_case(dev, **c)

    # B = 1 against matern_matmat at the same rho, both 3xTF32: the two
    # kernels order their arithmetic differently (scaled points vs scaled
    # distance, a plain vs a compensated sum of tile sums), so they agree
    # within the parity bounds, not bit for bit
    g = torch.Generator(device=dev).manual_seed(5)
    pts = torch.rand((3001, 2), generator=g, device=dev)
    V = torch.randn((3001, 16), generator=g, device=dev)
    got, tk2 = cuda_kernels.matern_matmat_multirho(
        pts, torch.tensor([RHO], device=dev), V[None], NU,
        return_frobenius=True)
    want, fro = cuda_kernels.matern_matmat(pts, RHO, V, NU, frobenius=True)
    frob, max_abs = compare(got[0], want.double())
    trace_rel = abs(float(tk2[0]) - float(fro)) / float(fro)
    ok = frob < FROB_TOL and max_abs < MAXABS_TOL and trace_rel < TRACE_RTOL
    log(phase="parity_multirho_vs_matmat", ok=ok, frob_rel_err=frob,
        max_abs_err=max_abs, trace_rel_err=trace_rel)
    if not ok:
        raise AssertionError("multirho at B = 1 disagrees with matern_matmat")
    multirho_largest_rho_case(dev)


# -- kernel 3: block-sparse ---------------------------------------------------

def clear_threshold(op):
    """The operator's taper threshold, moved up until no entry of the
    active tiles lies within 1e-5 (relative) of it in float64: with none
    that close, float32 and float64 taper the same entries (see
    cuda_kernels.blocksparse_clear_threshold)."""
    return cuda_kernels.blocksparse_clear_threshold(
        op.points_sorted.double(), op.nu, op.threshold, op.pair_i,
        op._pair_j, op.tile, n=op.shape[0], rel=1e-5, row_ptr=op._row_ptr)


def blocksparse_products(op, tau, V, frobenius=True):
    """The kernel through its wrapper ('highest'; the trace over the
    operator's walk), and the plain version in float64 on the same sorted
    float32 points, at threshold ``tau``."""
    args = (op.nu, tau, op.pair_i, op._pair_j, op.tile)
    kw = dict(n=op.shape[0], frobenius=frobenius, row_ptr=op._row_ptr)
    got = cuda_kernels.matern_matmat_blocksparse(
        op.points_sorted, V, *args, trace_walk=op._trace_walk, **kw)
    torch.cuda.synchronize()
    want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), None if V is None else V.double(), *args,
        **kw)
    return got, want


def blocksparse_tf32x3_gap(op, tau, V, got):
    """Frobenius gap of the block-sparse kernel's 'highest' product ``got``
    to its plain 3xTF32 version on the same float32 tapered K: logged
    beside the bounds, which hold the kernel to float64."""
    emu = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted, V, op.nu, tau, op.pair_i, op._pair_j, op.tile,
        n=op.shape[0], row_ptr=op._row_ptr,
        _product=cuda_kernels._tf32x3_dot_plain)
    return compare(got, emu.double())[0]


def blocksparse_case(dev, n, r, nu, tile, grid=False, scale=0.05,
                     density=0.02, seed=0):
    if grid:
        side = int(round(np.sqrt(n)))
        pts = data_utils.generate_points(side, dimension=2)[:n]
    else:
        pts = np.random.RandomState(seed).rand(n, 2)
    op = TaperedMaternOperator(pts, scale, nu=nu, density=density, tile=tile,
                               device=dev)
    tau = clear_threshold(op)
    g = torch.Generator(device=dev).manual_seed(seed)
    V = torch.zeros((op.n_pad, r), device=dev) if r else None
    if r:
        V[:n] = torch.randn((n, r), generator=g, device=dev)
    (got, fro), (want, fro_want) = blocksparse_products(op, tau, V)
    rec = {"n": n, "r": r, "nu": nu, "tile": op.tile, "grid": grid,
           "pairs": len(op.pair_i), "tile_density": op.tile_density,
           "tau": tau, "tau_over_operator_threshold": tau / op.threshold,
           "trace_rel_err": abs(float(fro) - float(fro_want))
           / float(fro_want)}
    ok = rec["trace_rel_err"] < DENSE_TRACE_RTOL
    if r:
        assert got.shape == (op.n_pad, r)
        assert bool(torch.isfinite(got).all())
        assert not bool(got[n:].any())
        rec["frob_rel_err"], rec["max_abs_err"] = compare(got, want)
        ok = (ok and rec["frob_rel_err"] < FROB_TOL
              and rec["max_abs_err"] < MAXABS_TOL)
        rec["frob_vs_tf32x3_plain"] = blocksparse_tf32x3_gap(op, tau, V, got)
    if r == 1:
        u = torch.zeros_like(V)
        u[:n] = torch.randn((n, 1), generator=g, device=dev)
        Ku = blocksparse_products(op, tau, u, frobenius=False)[0]
        rec.update(symmetry(u, V, Ku, got))
        ok = ok and rec["symmetry_rel_err"] < SYM_TOL
    log(phase="parity_blocksparse", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"matern_matmat_blocksparse disagrees with the "
                             f"plain version: {rec}")


def phase_parity_blocksparse(dev):
    cases = [dict(n=n, r=r, nu=0.5, tile=tile, grid=grid, seed=n % 7)
             for n in (1024, 3001) for tile in (128, 512)
             for grid in (False, True) for r in (0, 1, 24)]
    cases += [dict(n=3001, r=r, nu=nu, tile=128, seed=3)
              for nu in (1.5, 2.5) for r in (7, 33)]
    for c in cases:
        blocksparse_case(dev, **c)


# -- the grid path ------------------------------------------------------------

def random_block(n, num_probes, seed):
    rng = np.random.RandomState(seed)
    return (np.sign(rng.standard_normal((n, num_probes))),
            rng.standard_normal((n, 1)))


def rel_gap(a, b):
    return abs(a - b) / abs(b)


def phase_grid_engine_1024(dev):
    """The reference's on-chip grid test: one matrix-free chunk of three
    rhos against fresh single-operator engines at each rho (eta rtol 0.1,
    sigma0 rtol 1e-2), and against the same grid engine on the CPU in
    float64 from the same random block (eta rtol 5e-2, sigma0 rtol 5e-3,
    the bounds of phase 4)."""
    n = 1024
    pts, z, X = make_problem(n, 0)
    rhos = np.asarray([0.08, 0.1, 0.15])
    probes, v_defl = random_block(n, 8, 1)
    kw = dict(nu_static=NU, lanczos_steps=32, num_probes=8,
              matrix_free=True, chunk=3, probes=probes, v_defl=v_defl)
    cuda_kernels.reset_launch_counts()
    got = GridKrylovProfileLikelihood(pts, X, z, rhos, np.full(3, NU),
                                      device=dev, **kw).fit_all()
    launches = {k: cuda_kernels.launch_counts[k] for k in (
        "matern_matmat_multirho_mma", "matern_matmat_multirho")}
    cpu = GridKrylovProfileLikelihood(pts, X, z, rhos, np.full(3, NU),
                                      device="cpu", dtype=F64,
                                      **kw).fit_all()
    ok = launches == {"matern_matmat_multirho_mma": 32,
                      "matern_matmat_multirho": 1}
    recs = []
    for g, c, rho in zip(got, cpu, rhos):
        op = MaternOperator(pts, float(rho), nu=NU, device=dev)
        ref = KrylovProfileLikelihood(op, X, z, lanczos_steps=32,
                                      num_probes=16, device=dev).fit()
        rec = {"rho": float(rho), "eta": g["eta"], "sigma0": g["sigma0"],
               "eta_vs_single": rel_gap(g["eta"], ref["eta"]),
               "sigma0_vs_single": rel_gap(g["sigma0"], ref["sigma0"]),
               "eta_vs_cpu_f64": rel_gap(g["eta"], c["eta"]),
               "sigma0_vs_cpu_f64": rel_gap(g["sigma0"], c["sigma0"])}
        ok = (ok and g["success"] and rec["eta_vs_single"] < 0.1
              and rec["sigma0_vs_single"] < 1e-2
              and rec["eta_vs_cpu_f64"] < 5e-2
              and rec["sigma0_vs_cpu_f64"] < 5e-3)
        recs.append(rec)
    log(phase="grid_engine_1024", ok=ok, multirho_launches=launches,
        points=recs)
    if not ok:
        raise AssertionError("n = 1024 grid engine disagrees")


def phase_grid_path(dev):
    """The reference's sec_grid_krylov, on the port: one matrix-free chunk
    of 8 rhos at n = 100,000, then fit_all."""
    pts, z, X = make_problem(N_MAIN, 7)
    B = len(GRID_RHOS)
    probes, v_defl = random_block(N_MAIN, GRID_PROBES, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    grid = GridKrylovProfileLikelihood(
        pts, X, z, GRID_RHOS, np.full(B, NU), nu_static=NU,
        lanczos_steps=GRID_STEPS, num_probes=GRID_PROBES, matrix_free=True,
        chunk=B, device=dev, probes=probes, v_defl=v_defl)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict(cuda_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    results = grid.fit_all()
    fit_s = time.perf_counter() - t0
    best = max(results, key=lambda r: r["lp"])

    # one grid point against a single-operator engine on matern_matmat at
    # the same rho and the same random block
    i = 2
    op = MaternOperator(pts, float(GRID_RHOS[i]), nu=NU, device=dev)
    ref = KrylovProfileLikelihood(op, X, z, lanczos_steps=GRID_STEPS,
                                  num_probes=GRID_PROBES, device=dev,
                                  probes=probes, v_defl=v_defl).fit()
    eta_gap = rel_gap(results[i]["eta"], ref["eta"])
    sigma0_gap = rel_gap(results[i]["sigma0"], ref["sigma0"])
    finite = all(r["success"] and all(np.isfinite(r[k]) for k in (
        "eta", "sigma", "sigma0", "lp")) for r in results)
    # a construction: GRID_STEPS products on the tensor-core kernel
    # ('highest' as 3xTF32), one trace launch of the FP32 kernel
    ok = (finite and launches == {
        **dict.fromkeys(launches, 0),
        "matern_matmat_multirho_mma": GRID_STEPS,
        "matern_matmat_multirho": 1}
        and eta_gap < 0.1 and sigma0_gap < 1e-2)
    log(phase="grid_path", ok=ok, n=N_MAIN, rhos=list(GRID_RHOS), nu=NU,
        lanczos_steps=GRID_STEPS, num_probes=GRID_PROBES, chunk=grid.chunk,
        setup_seconds=setup_s, setup_seconds_per_point=setup_s / B,
        fit_all_seconds_host_numpy=fit_s, best_rho=best["rho"],
        launches=launches,
        peak_device_memory_bytes=peak,
        fits=[{k: r[k] for k in ("rho", "eta", "sigma", "sigma0", "lp")}
              for r in results],
        single_operator_check={"rho": float(GRID_RHOS[i]),
                               "eta": ref["eta"], "sigma0": ref["sigma0"],
                               "eta_rel_gap": eta_gap,
                               "sigma0_rel_gap": sigma0_gap})
    if not ok:
        raise AssertionError(f"grid path failed: launches {launches}")
    return launches, results, setup_s


# -- the tapered path ---------------------------------------------------------

def tapered_problem(side):
    pts = data_utils.generate_points(side, dimension=2)
    return (pts, data_utils.generate_data(pts, 0.2),
            data_utils.generate_basis_functions(pts, 2))


def phase_tapered_engine_16384(dev):
    """The tapered engine on cuda (float32 kernel path) vs cpu (float64
    plain path) from the same data and random block: the sparse race's
    parameters (rho = 0.005, density 1e-3) on a grid of side 128."""
    side = 128
    n = side * side
    pts, z, X = tapered_problem(side)
    scale, density = TAPER_SCALE, TAPER_DENSITY
    probes, v_defl = random_block(n, PROBES, 3)
    fits = {}
    for name, device, dtype in (("cuda_f32", dev, F32),
                                ("cpu_f64", "cpu", F64)):
        op = TaperedMaternOperator(pts, scale, nu=NU, density=density,
                                   device=device, dtype=dtype)
        fits[name] = KrylovProfileLikelihood(
            op, X, z, lanczos_steps=STEPS, num_probes=PROBES, device=device,
            dtype=dtype, probes=probes, v_defl=v_defl).fit()
    a, b = fits["cuda_f32"], fits["cpu_f64"]
    eta_rel, sigma0_rel = rel_gap(a["eta"], b["eta"]), rel_gap(
        a["sigma0"], b["sigma0"])
    ok = (a["success"] and b["success"] and eta_rel < 5e-2
          and sigma0_rel < 5e-3)
    log(phase="tapered_engine_16384", ok=ok, scale=scale, density=density,
        pairs=len(op.pair_i), tile_density=op.tile_density, cuda_f32=a,
        cpu_f64=b, eta_rel_err=eta_rel, sigma0_rel_err=sigma0_rel)
    if not ok:
        raise AssertionError("n = 16384 tapered engine: cuda and cpu fits "
                             "disagree")


def phase_tapered_path(dev):
    """The reference's sparse race at its largest size, on the port: grid
    points, side 1024, rho = 0.005, nu = 0.5, density 1e-3."""
    pts, z, X = tapered_problem(TAPER_SIDE)
    n = pts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    op = TaperedMaternOperator(pts, TAPER_SCALE, nu=NU,
                               density=TAPER_DENSITY, device=dev)
    torch.cuda.synchronize()
    geometry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=STEPS,
                                  num_probes=PROBES, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict(cuda_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    finite = all(np.isfinite(res[k]) for k in ("eta", "sigma0", "sigma"))
    # the injected noise is 0.2; the n = 16384 cross-check (phase 11) lands
    # on sigma0 = 0.1932 on both devices, 3.4% below it (the short-range
    # tapered kernel takes some of the noise for signal), so the band is
    # 10% either side of 0.2
    ok = (res["success"] and finite and 0.18 < res["sigma0"] < 0.22
          and launches == {**dict.fromkeys(launches, 0),
                           "matern_matmat_blocksparse_mma": STEPS,
                           "matern_matmat_blocksparse": 1})
    log(phase="tapered_path", ok=ok, n=n, scale=TAPER_SCALE, nu=NU,
        density=TAPER_DENSITY, tile=op.tile, lanczos_steps=STEPS,
        num_probes=PROBES, active_tile_pairs=len(op.pair_i),
        tile_density=op.tile_density, radius=op.radius,
        threshold=op.threshold,
        sort_and_pair_geometry_seconds_host=geometry_s,
        setup_seconds=setup_s, fit_seconds_host_numpy=fit_s,
        eta_star=res["eta"], sigma0=res["sigma0"], sigma=res["sigma"],
        launches=launches, peak_device_memory_bytes=peak)
    if not ok:
        raise AssertionError(f"tapered path failed: {res}, {launches}")
    return launches, op, res, setup_s


# -- times of the multi-rho and block-sparse kernels at their paths' shapes --

def multirho_bounds(n, B, r, d, nu):
    """bound() of the multi-rho 'highest' product as 3xTF32, the same
    function's bound_ms as FP32 FMAs on the CUDA cores, and bound() of the
    trace launch. Per pair the distance and the sqrt (3d + 1); per pair
    and rho the scale, k and the split of k (1 + nu_ops + 3) on the CUDA
    cores and three tf32 products of 2r operations on the tensor cores; as
    FP32 FMAs the 2r on the CUDA cores; on the SFU one sqrt per pair and
    one exp per pair and rho. The trace: one FMA for k^2 per pair and rho,
    over the n (n + 1) / 2 pairs of the symmetric K."""
    pairs, half = n * n, n * (n + 1) // 2
    nbytes = 4 * (n * d + B + 2 * B * n * r)
    cores = pairs * (3 * d + 1 + B * (1 + nu_ops(nu) + 3))
    product = bound(nbytes, cores, tf32_ops=pairs * B * 2 * r * 3,
                    mufu_ops=pairs * (1 + B))
    as_fp32 = bound(nbytes, pairs * (3 * d + 1 + B * (nu_ops(nu) + 2 * r)),
                    mufu_ops=pairs * (1 + B))
    trace = bound(4 * (n * d + B) + 8 * B,
                  half * (3 * d + 1 + B * (nu_ops(nu) + 2)),
                  mufu_ops=half * (1 + B))
    return product, as_fp32[0], trace


def phase_multirho_time(dev):
    """n = 100,000, B = 8, r = 16 (the grid engine's block) under
    'highest' (the tensor-core kernel, 3xTF32), held to the bounds one rho
    at a time, and the r = 0 trace launch (the FP32 kernel)."""
    pts, _, _ = make_problem(N_MAIN, 7)
    B, r, d = len(GRID_RHOS), 16, 2
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    rhos = torch.as_tensor(GRID_RHOS, dtype=F32, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    V = torch.randn((B, N_MAIN, r), generator=g, device=dev)

    got, tk2 = cuda_kernels.matern_matmat_multirho(P, rhos, V, NU,
                                                   return_frobenius=True)
    want, tk2_want = cuda_kernels.matern_matmat_multirho_plain(
        P.double(), 1.0 / (1.0 / rhos).double(), V.double(), NU,
        return_frobenius=True)
    per_rho = [compare(got[b], want[b]) for b in range(B)]
    frob, max_abs = ([e[0] for e in per_rho], [e[1] for e in per_rho])
    trace_rel_per_rho = (torch.abs(tk2 - tk2_want) / tk2_want).tolist()
    trace_rel = max(trace_rel_per_rho)
    # the traces again, and under each dot mode: the same bits
    trace_same_bits = all(
        torch.equal(cuda_kernels.matern_matmat_multirho(
            P, rhos, None, NU, dot_mode=m, return_frobenius=True)[1], tk2)
        for m in cuda_kernels.DOT_MODES)
    ok = (max(frob) < FROB_TOL and max(max_abs) < MAXABS_TOL
          and trace_rel < DENSE_TRACE_RTOL and trace_same_bits)
    del want
    # the first 2048 rows against the plain 3xTF32 version (logged)
    tf32x3 = multirho_tf32x3_gap(got, P, rhos, V, NU, rows=2048)

    med, times = median_in_turns({
        "kernel": lambda: cuda_kernels.matern_matmat_multirho(P, rhos, V,
                                                              NU),
        "plain": lambda: cuda_kernels.matern_matmat_multirho_plain(
            P, rhos, V, NU),
        "kernel_trace": lambda: cuda_kernels.matern_matmat_multirho(
            P, rhos, None, NU, return_frobenius=True),
        "plain_trace": lambda: cuda_kernels.matern_matmat_multirho_plain(
            P, rhos, None, NU, return_frobenius=True)})
    ((bound_ms, bound_by, bound_term), bound_fp32_ms,
     (trace_bound_ms, trace_bound_by, trace_bound_term)) = \
        multirho_bounds(N_MAIN, B, r, d, NU)
    log(phase="multirho_time", ok=ok, n=N_MAIN, B=B, r=r, reps=7,
        rhos=list(GRID_RHOS), frob_rel_err=frob, max_abs_err=max_abs,
        trace_rel_err=trace_rel, trace_rel_err_per_rho=trace_rel_per_rho,
        trace_rtol=DENSE_TRACE_RTOL,
        trace_same_bits_run_to_run_and_in_every_mode=trace_same_bits,
        frob_vs_tf32x3_plain_first_2048_rows=tf32x3,
        kernel_ms_median=med["kernel"], plain_f32_ms_median=med["plain"],
        kernel_trace_ms_median=med["kernel_trace"],
        plain_f32_trace_ms_median=med["plain_trace"],
        bound_ms=bound_ms, bound_by=bound_by, bound_term=bound_term,
        bound_ms_as_fp32_fma=bound_fp32_ms,
        bound_mufu_only_ms=mufu_only_ms(N_MAIN * N_MAIN * (1 + B)),
        trace_bound_ms=trace_bound_ms, trace_bound_term=trace_bound_term,
        trace_bound_mufu_only_ms=mufu_only_ms(
            N_MAIN * (N_MAIN + 1) // 2 * (1 + B)),
        kernel_ms_all=times["kernel"],
        kernel_trace_ms_all=times["kernel_trace"])
    if not ok:
        raise AssertionError("multirho disagrees with the plain version at "
                             "the grid path's shape")
    return ({"max_abs_err": max(max_abs), "ms": med["kernel"],
             "plain_ms": med["plain"], "bound_ms": bound_ms,
             "bound_by": bound_by},
            {"max_abs_err": float(torch.max(torch.abs(tk2 - tk2_want))),
             "ms": med["kernel_trace"], "plain_ms": med["plain_trace"],
             "bound_ms": trace_bound_ms, "bound_by": trace_bound_by})


def tile_pairs(op, symmetric=False):
    """The point pairs the operator's pair list really holds: real rows of
    tile i times real columns of tile j, summed over the active tile
    pairs. ``symmetric``: those a sum over the symmetric K needs, each
    off-diagonal tile pair of the list once and the triangle i <= j of
    each diagonal tile; the list holds (j, i) with every (i, j), since the
    operator builds it from a symmetric tile gap (checked here)."""
    n = op.shape[0]
    real = np.minimum(op.tile, n - op.tile * np.arange(op.num_tiles))
    rows = real[op.pair_i].astype(np.int64)
    cols = real[op.pair_j].astype(np.int64)
    if not symmetric:
        return int(np.sum(rows * cols))
    T = np.int64(op.num_tiles)
    if not np.array_equal(np.sort(op.pair_i * T + op.pair_j),
                          np.sort(op.pair_j * T + op.pair_i)):
        raise AssertionError("the tapered pair list is not symmetric")
    upper, diag = op.pair_i < op.pair_j, op.pair_i == op.pair_j
    return int(np.sum(rows[upper] * cols[upper])
               + np.sum(rows[diag] * (rows[diag] + 1) // 2))


def blocksparse_bounds(op, r, d):
    """As :func:`multirho_bounds`, for the block-sparse kernel over the
    operator's pair list: per pair the distance, k, the compare-select and
    the split of k (3d + nu_ops + 1 + 3), the sqrt and the exp of k on the
    SFU and three tf32 products of 2r operations; as FP32 FMAs the 2r on
    the CUDA cores; the trace one FMA for k^2 per pair, over the pairs the
    symmetric K needs (tile_pairs(op, symmetric=True)), as the dense traces
    count. Its kernel walks a little more (walked_pairs: the diagonal
    tiles' sub-tile triangles, each diagonal unit of 128 x 128 points
    whole)."""
    pairs, half = tile_pairs(op), tile_pairs(op, symmetric=True)
    geometry = 4 * (op.num_tiles + 1 + len(op.pair_j))
    nbytes = 4 * (op.n_pad * d + 2 * op.n_pad * r) + geometry
    k_ops = 3 * d + nu_ops(op.nu) + 1
    mufu = pairs * nu_mufu(op.nu)
    product = bound(nbytes, pairs * (k_ops + 3),
                    tf32_ops=pairs * 2 * r * 3, mufu_ops=mufu)
    as_fp32 = bound(nbytes, pairs * (k_ops + 2 * r), mufu_ops=mufu)
    trace = bound(4 * op.n_pad * d + 8 + geometry, half * (k_ops + 2),
                  mufu_ops=half * nu_mufu(op.nu))
    return pairs, product, as_fp32[0], trace


def walked_pairs(op, walk):
    """The point pairs the trace kernel evaluates over ``walk``: the real
    rows times the real columns of each unit."""
    units = walk.units.cpu().numpy()
    rows, cols = (cuda_kernels.blocksparse_sub_tile_points(
        units[:, k], op.tile, op.shape[0]) for k in (0, 1))
    return int(np.sum(rows * cols))


def phase_blocksparse_time(dev, op):
    """The full-size pair list of the tapered path, r = 24, under
    'highest' (the tensor-core kernel, 3xTF32), and the trace launch (the
    FP32 kernel) over the operator's symmetric walk, beside the same
    kernel's full walk of the list; the error against the plain float64
    version is taken at a threshold clear of every pair (see
    clear_threshold). The trace must give the same bits run to run and in
    every dot mode."""
    n, r, d = op.shape[0], 24, 2
    g = torch.Generator(device=dev).manual_seed(13)
    V = torch.randn((op.n_pad, r), generator=g, device=dev)
    V[n:] = 0
    tau = clear_threshold(op)
    (got, fro), (want, fro_want) = blocksparse_products(op, tau, V)
    frob, max_abs = compare(got, want)
    trace_rel = abs(float(fro) - float(fro_want)) / float(fro_want)
    del want
    tf32x3 = blocksparse_tf32x3_gap(op, tau, V, got)

    args = (op.nu, op.threshold, op.pair_i, op._pair_j, op.tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    full_walk = cuda_kernels.blocksparse_trace_schedule(
        op.pair_i, op.pair_j, op.tile, n, symmetric=False)
    full_walk = full_walk._replace(
        units=torch.as_tensor(full_walk.units, device=dev))

    def kernel_trace(walk=op._trace_walk, dot_mode=None):
        return cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, None, *args, frobenius=True, trace_walk=walk,
            dot_mode=dot_mode, **kw)[1]

    # the trace again, and under each dot mode: the same bits
    trace = kernel_trace()
    trace_same_bits = all(float(kernel_trace(dot_mode=m)) == float(trace)
                          for m in cuda_kernels.DOT_MODES)
    trace_walks_gap = abs(float(kernel_trace(full_walk)) - float(trace)) \
        / float(trace)
    ok = (frob < FROB_TOL and max_abs < MAXABS_TOL
          and trace_rel < DENSE_TRACE_RTOL and trace_same_bits)
    med, times = median_in_turns({
        "kernel": lambda: cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, V, *args, **kw),
        "plain": lambda: cuda_kernels.matern_matmat_blocksparse_plain(
            op.points_sorted, V, *args, **kw),
        "kernel_trace": kernel_trace,
        "kernel_trace_full_walk": lambda: kernel_trace(full_walk),
        "plain_trace": lambda: cuda_kernels.matern_matmat_blocksparse_plain(
            op.points_sorted, None, *args, frobenius=True, **kw)})
    (pairs, (bound_ms, bound_by, bound_term), bound_fp32_ms,
     (trace_bound_ms, trace_bound_by, trace_bound_term)) = \
        blocksparse_bounds(op, r, d)
    log(phase="blocksparse_time", ok=ok, n=n, r=r, reps=7, pairs=pairs,
        tau=tau, tau_over_operator_threshold=tau / op.threshold,
        frob_rel_err=frob, max_abs_err=max_abs, trace_rel_err=trace_rel,
        trace_rtol=DENSE_TRACE_RTOL,
        trace_same_bits_run_to_run_and_in_every_mode=trace_same_bits,
        trace_rel_gap_to_full_walk=trace_walks_gap,
        one_diagonal_unit_share_of_trace_at_least=128 / float(fro_want),
        frob_vs_tf32x3_plain=tf32x3, kernel_ms_median=med["kernel"],
        plain_f32_ms_median=med["plain"],
        kernel_trace_ms_median=med["kernel_trace"],
        kernel_trace_full_walk_ms_median=med["kernel_trace_full_walk"],
        plain_f32_trace_ms_median=med["plain_trace"],
        bound_ms=bound_ms, bound_by=bound_by, bound_term=bound_term,
        bound_ms_as_fp32_fma=bound_fp32_ms,
        trace_units=len(op._trace_walk.units),
        trace_pairs_walked=walked_pairs(op, op._trace_walk),
        trace_pairs_walked_full=walked_pairs(op, full_walk),
        trace_pairs_needed=tile_pairs(op, symmetric=True),
        trace_bound_ms=trace_bound_ms, trace_bound_term=trace_bound_term,
        trace_bound_mufu_only_ms=mufu_only_ms(
            tile_pairs(op, symmetric=True) * nu_mufu(op.nu)),
        kernel_ms_all=times["kernel"],
        kernel_trace_ms_all=times["kernel_trace"],
        kernel_trace_full_walk_ms_all=times["kernel_trace_full_walk"])
    if not ok:
        raise AssertionError("blocksparse disagrees with the plain version "
                             "at the tapered path's shape")
    return ({"max_abs_err": max_abs, "ms": med["kernel"],
             "plain_ms": med["plain"], "bound_ms": bound_ms,
             "bound_by": bound_by},
            {"max_abs_err": abs(float(fro) - float(fro_want)),
             "ms": med["kernel_trace"], "plain_ms": med["plain_trace"],
             "bound_ms": trace_bound_ms, "bound_by": trace_bound_by})


# -- the tile-dot modes and the Gram form -------------------------------------

# Frobenius-relative bounds against plain float64 'highest': 'bf16x3' keeps
# the exact mode's bound; 'bf16' must SHOW its rounding (the reference
# records 2.2e-3) and stay under 5e-3; the Gram form's cancellation puts
# ~1e-3 of kernel error on near-coincident pairs (the reference's envelope,
# tests/test_kernels.py::test_gram_dist_mode_accuracy). Under 'gram' +
# 'bf16' the rounding (2e-3) is the larger of the two, so that pair is held
# to the bf16 band. u.Kv vs v.Ku: 1e-6 in 'highest', 1e-4 once V is rounded.
BF16_BAND = (1e-4, 5e-3)
GRAM_FROB_TOL, GRAM_MAXABS_TOL, SKEW_TOL = 1e-3, 2e-2, 1e-4
NEW_MODES = ("bf16x3", "bf16")


def mode_verdict(rec, dot_mode, dist_mode="diff"):
    """Hold one case's errors to its mode's bounds. ``rec`` has
    ``frob_rel_err``/``max_abs_err`` (kernel vs plain float64 'highest'),
    ``frob_vs_own_plain`` (kernel vs its plain version in float32 with the
    same rounding) and ``mode_signature`` (that plain version vs float64
    'highest': what the mode's rounding costs); under the Gram form and a
    bf16 mode also ``frob_vs_exact_twin`` (kernel vs the plain float32 Gram
    version at 'highest')."""
    frob, own = rec["frob_rel_err"], rec["frob_vs_own_plain"]
    if dot_mode == "bf16":
        ok = BF16_BAND[0] < frob < BF16_BAND[1]
    elif dist_mode == "gram":
        ok = frob < GRAM_FROB_TOL
    else:
        ok = frob < FROB_TOL
    if dist_mode == "gram":
        # (bf16's own rounding, 2^-9 of every product, is past the Gram
        # form's max-abs envelope, so that pair has the band alone)
        ok = ok and own < GRAM_FROB_TOL and (
            dot_mode == "bf16" or rec["max_abs_err"] < GRAM_MAXABS_TOL)
        if dot_mode != "highest":
            # the Gram form's cancellation (~1e-4) hides bf16x3's signature
            # (~5e-6) from float64, but the kernel and the plain versions
            # share that cancellation: the kernel must sit closer to its own
            # plain version than half its distance to the plain 'highest'
            # Gram version, where a 'highest' kernel in its place would sit
            ok = ok and own < 0.5 * rec["frob_vs_exact_twin"]
    elif dot_mode != "highest":
        # the kernel rounds as its plain version does: it is closer to it
        # than the rounding is large (a 'highest' kernel in its place would
        # sit a whole signature away)
        ok = ok and own < 0.5 * rec["mode_signature"]
    else:
        ok = ok and own < FROB_TOL and rec["max_abs_err"] < MAXABS_TOL
    if "symmetry_rel_err" in rec:
        ok = ok and rec["symmetry_rel_err"] < (
            SYM_TOL if dot_mode == "highest" and dist_mode == "diff"
            else SKEW_TOL)
    return bool(ok)


def mode_errors(got, own, want, exact_twin=None):
    """The errors :func:`mode_verdict` reads: the kernel ``got`` against
    plain float64 'highest' (``want``) and against its own plain float32
    version ``own``, ``own`` against ``want``, and, where given, ``got``
    against ``exact_twin``, the plain float32 version at the same distance
    form and 'highest'."""
    frob, max_abs = compare(got, want)
    rec = {"frob_rel_err": frob, "max_abs_err": max_abs,
           "frob_vs_own_plain": compare(got, own.double())[0],
           "mode_signature": compare(own, want)[0]}
    if exact_twin is not None:
        rec["frob_vs_exact_twin"] = compare(got, exact_twin.double())[0]
    return rec


def mode_case(dev, dot_mode, dist_mode, n, r, nu, d=2, scale=RHO,
              n_cols=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand((n, d), generator=g, device=dev)
    cols = (None if n_cols is None
            else torch.rand((n_cols, d), generator=g, device=dev))
    nc = n if n_cols is None else n_cols
    V = torch.randn((nc, r), generator=g, device=dev)
    kw = dict(points_cols=cols, dot_mode=dot_mode, dist_mode=dist_mode)
    before = dict(cuda_kernels.launch_counts)
    got = cuda_kernels.matern_matmat(pts, scale, V, nu, **kw)
    torch.cuda.synchronize()
    launched = launched_since(before)
    assert launched == {"matern_matmat_mma": 1}, launched
    assert got.shape == (n, r) and bool(torch.isfinite(got).all())
    own = cuda_kernels.matern_matmat_plain(
        pts, kernels.broadcast_scale(scale, d, dtype=F32, device=dev), V, nu,
        block_rows=4096, **kw)
    want = cuda_kernels.matern_matmat_plain(
        pts.double(), kernels.broadcast_scale(scale, d, dtype=F64,
                                              device=dev),
        V.double(), nu, points_cols=None if cols is None else cols.double(),
        block_rows=4096, dot_mode="highest")
    rec = {"dot_mode": dot_mode, "dist_mode": dist_mode, "n": n,
           "n_cols": nc, "r": r, "nu": nu, "d": d, "scale": scale}
    twin = None
    if dist_mode == "gram" and dot_mode != "highest":
        twin = cuda_kernels.matern_matmat_plain(
            pts, kernels.broadcast_scale(scale, d, dtype=F32, device=dev), V,
            nu, block_rows=4096, **{**kw, "dot_mode": "highest"})
    rec.update(mode_errors(got, own, want, twin))
    if n_cols is None and r == 1:
        u = torch.randn((n, 1), generator=g, device=dev)
        Ku = cuda_kernels.matern_matmat(pts, scale, u, nu, **kw)
        rec.update(symmetry(u, V, Ku, got))
    ok = mode_verdict(rec, dot_mode, dist_mode)
    log(phase="parity_modes", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"matern_matmat in mode {dot_mode}/{dist_mode} "
                             f"is out of its bounds: {rec}")


def launched_since(before):
    """The launch counters that moved since the snapshot ``before``."""
    return {k: v - before[k] for k, v in cuda_kernels.launch_counts.items()
            if v != before[k]}


def multirho_mode_case(dev, dot_mode, n, B, r, nu, d=2, seed=0):
    """One product and trace launch of the multi-rho pair of kernels under
    a bf16 mode. The rho batch is that of the grid path, stretched by
    sqrt(d / 2) so that the scaled distances stay of its order in any d."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand((n, d), generator=g, device=dev)
    rhos = torch.linspace(0.05, 0.3, B, device=dev) * float(np.sqrt(d / 2))
    V = torch.randn((B, n, r), generator=g, device=dev)
    before = dict(cuda_kernels.launch_counts)
    got, tk2 = cuda_kernels.matern_matmat_multirho(
        pts, rhos, V, nu, dot_mode=dot_mode, return_frobenius=True)
    torch.cuda.synchronize()
    launched = launched_since(before)
    assert launched == {"matern_matmat_multirho_mma": 1,
                        "matern_matmat_multirho": 1}, launched
    assert got.shape == (B, n, r) and bool(torch.isfinite(got).all())
    own = cuda_kernels.matern_matmat_multirho_plain(
        pts, rhos, V, nu, dot_mode=dot_mode, block_rows=4096)
    want, tk2_want = cuda_kernels.matern_matmat_multirho_plain(
        pts.double(), 1.0 / (1.0 / rhos).double(), V.double(), nu,
        return_frobenius=True, block_rows=4096, dot_mode="highest")
    rec = {"kernel": "matern_matmat_multirho_mma", "dot_mode": dot_mode,
           "n": n, "B": B, "r": r, "nu": nu, "d": d,
           "trace_rel_err": float(torch.max(
               torch.abs(tk2 - tk2_want) / tk2_want))}
    rec.update(mode_errors(got, own, want))
    # the traces sum the unrounded k^2 in every mode
    ok = mode_verdict(rec, dot_mode) and rec["trace_rel_err"] < TRACE_RTOL
    log(phase="parity_modes", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"matern_matmat_multirho in mode {dot_mode} is "
                             f"out of its bounds: {rec}")


def blocksparse_mode_case(dev, dot_mode, n, r, nu, tile, d=2, scale=0.05,
                          seed=0):
    rng = np.random.RandomState(seed)
    if d <= 3:
        pts = rng.rand(n, d)
    else:
        # a flat cloud of side 10 turned into d dimensions: in a cube of
        # that many dimensions the taper ball holds most of the points and
        # no threshold is clear of every pair
        q, _ = np.linalg.qr(rng.standard_normal((d, 2)))
        pts = (10.0 * rng.rand(n, 2)) @ q.T
    op = TaperedMaternOperator(pts, scale, nu=nu, density=0.02, tile=tile,
                               device=dev)
    tau = clear_threshold(op)
    g = torch.Generator(device=dev).manual_seed(seed)

    def padded(width):
        X = torch.zeros((op.n_pad, width), device=dev)
        X[:n] = torch.randn((n, width), generator=g, device=dev)
        return X

    V = padded(r)
    args = (op.nu, tau, op.pair_i, op._pair_j, op.tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    before = dict(cuda_kernels.launch_counts)
    got, fro = cuda_kernels.matern_matmat_blocksparse(
        op.points_sorted, V, *args, dot_mode=dot_mode, frobenius=True, **kw)
    torch.cuda.synchronize()
    launched = launched_since(before)
    assert launched == {"matern_matmat_blocksparse_mma": 1,
                        "matern_matmat_blocksparse": 1}, launched
    own = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted, V, *args, dot_mode=dot_mode, **kw)
    want, fro_want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), V.double(), *args, frobenius=True,
        dot_mode="highest", **kw)
    assert got.shape == (op.n_pad, r) and bool(torch.isfinite(got).all())
    assert not bool(got[n:].any())
    rec = {"kernel": "matern_matmat_blocksparse_mma", "dot_mode": dot_mode,
           "n": n, "r": r, "nu": nu, "d": d, "tile": op.tile,
           "pairs": len(op.pair_i), "tau": tau,
           "trace_rel_err": abs(float(fro) - float(fro_want))
           / float(fro_want)}
    rec.update(mode_errors(got, own, want))
    if r == 1:
        u = padded(1)
        Ku = cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, u, *args, dot_mode=dot_mode, **kw)
        rec.update(symmetry(u, V, Ku, got))
    ok = (mode_verdict(rec, dot_mode)
          and rec["trace_rel_err"] < DENSE_TRACE_RTOL)
    log(phase="parity_modes", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"matern_matmat_blocksparse in mode {dot_mode} "
                             f"is out of its bounds: {rec}")


def phase_parity_modes(dev):
    for dist_mode in cuda_kernels.DIST_MODES:
        for dot_mode in cuda_kernels.DOT_MODES:
            cases = [dict(n=3001, r=r, nu=0.5) for r in (1, 8, 23, 24, 40)]
            cases += [dict(n=1024, r=24, nu=0.5)]
            cases += [dict(n=3001, r=24, nu=nu) for nu in (1.5, 2.5, 150.0)]
            cases += [dict(n=3001, r=8, nu=nu, d=d, seed=d)
                      for d in (1, 3) for nu in (0.5, 2.5)]
            cases += [dict(n=3001, r=7, nu=0.5, scale=[0.08, 0.2],
                           n_cols=1025, seed=2)]
            for c in cases:
                mode_case(dev, dot_mode, dist_mode, **c)
    # the tensor-core kernels of the multi-rho and the block-sparse product:
    # every width class (1, 2, 3 n8 tiles, chunks), batches that fill, half
    # fill and overflow a block's rho group, ragged n, every nu, d up to 8
    for dot_mode in NEW_MODES:
        for c in ([dict(n=3001, B=3, r=r, nu=0.5)
                   for r in (1, 8, 16, 23, 24, 40)]
                  + [dict(n=1024, B=8, r=16, nu=1.5),
                     dict(n=3001, B=9, r=16, nu=2.5, seed=1),
                     dict(n=2050, B=1, r=24, nu=150.0, seed=2),
                     dict(n=3001, B=3, r=8, nu=0.5, d=1, seed=3),
                     dict(n=3001, B=3, r=7, nu=2.5, d=3, seed=4),
                     dict(n=2050, B=8, r=16, nu=1.5, d=8, seed=5)]):
            multirho_mode_case(dev, dot_mode, **c)
        for c in ([dict(n=3001, r=r, nu=0.5, tile=128, seed=3)
                   for r in (1, 8, 16, 23, 24, 40)]
                  + [dict(n=3001, r=16, nu=1.5, tile=512, seed=4),
                     dict(n=2050, r=24, nu=2.5, tile=512, seed=5),
                     dict(n=3001, r=7, nu=150.0, tile=128, seed=6),
                     dict(n=3001, r=8, nu=0.5, tile=128, d=1, scale=0.005,
                          seed=7),
                     dict(n=3001, r=24, nu=1.5, tile=128, d=3, scale=0.2,
                          seed=8),
                     dict(n=2050, r=8, nu=0.5, tile=512, d=8, scale=1.0,
                          seed=9)]):
            blocksparse_mode_case(dev, dot_mode, **c)


def phase_engines_bf16x3(dev):
    """Phase 4 with the card's engine under 'bf16x3' (the tensor-core
    kernel), against the cpu float64 'highest' engine from the same numpy
    data and random block; then the n = 1024 grid engine and the n = 16384
    tapered engine on the card with 'bf16x3' made the module default by
    assignment (neither takes a mode of its own), against their cpu float64
    'highest' twins. Bounds of phases 4, 9 and 11."""
    pts, z, X = make_problem(1024, 0)
    probes, v_defl = random_block(1024, 16, 1)
    cuda_kernels.reset_launch_counts()
    fits = {}
    for name, device, dtype, mode in (("cuda_f32_bf16x3", dev, F32, "bf16x3"),
                                      ("cpu_f64_highest", "cpu", F64,
                                       "highest")):
        op = MaternOperator(pts, RHO, nu=NU, device=device, dtype=dtype,
                            dot_mode=mode)
        fits[name] = KrylovProfileLikelihood(
            op, X, z, lanczos_steps=32, num_probes=16, device=device,
            dtype=dtype, probes=probes, v_defl=v_defl).fit()
    launches = dict(cuda_kernels.launch_counts)
    a, b = fits["cuda_f32_bf16x3"], fits["cpu_f64_highest"]
    eta_rel, sigma0_rel = rel_gap(a["eta"], b["eta"]), rel_gap(
        a["sigma0"], b["sigma0"])
    ok = (a["success"] and b["success"] and eta_rel < 5e-2
          and sigma0_rel < 5e-3 and launches["matern_matmat_mma"] == 32
          and launches["matern_matmat"] == 1)
    log(phase="engine_1024_bf16x3", ok=ok, launches=launches, **fits,
        eta_rel_err=eta_rel, sigma0_rel_err=sigma0_rel)
    if not ok:
        raise AssertionError("n = 1024 engine under bf16x3: cuda and cpu "
                             "fits disagree")

    rhos = np.asarray([0.08, 0.1, 0.15])
    gprobes, gv_defl = random_block(1024, 8, 1)
    gkw = dict(nu_static=NU, lanczos_steps=32, num_probes=8,
               matrix_free=True, chunk=3, probes=gprobes, v_defl=gv_defl)
    side = 128
    tpts, tz, tX = tapered_problem(side)
    tprobes, tv_defl = random_block(side * side, PROBES, 3)
    tkw = dict(lanczos_steps=STEPS, num_probes=PROBES, probes=tprobes,
               v_defl=tv_defl)

    def build(device, dtype):
        grid = GridKrylovProfileLikelihood(
            pts, X, z, rhos, np.full(3, NU), device=device, dtype=dtype,
            **gkw).fit_all()
        op = TaperedMaternOperator(tpts, TAPER_SCALE, nu=NU,
                                   density=TAPER_DENSITY, device=device,
                                   dtype=dtype)
        return grid, KrylovProfileLikelihood(op, tX, tz, device=device,
                                             dtype=dtype, **tkw).fit()

    cpu_grid, cpu_taper = build("cpu", F64)
    cuda_kernels.reset_launch_counts()
    previous = cuda_kernels.DEFAULT_DOT_MODE
    cuda_kernels.DEFAULT_DOT_MODE = "bf16x3"
    try:
        got_grid, got_taper = build(dev, F32)
    finally:
        cuda_kernels.DEFAULT_DOT_MODE = previous
    launches = dict(cuda_kernels.launch_counts)
    recs = [{"engine": "grid", "rho": float(rho),
             "eta_rel_err": rel_gap(g["eta"], c["eta"]),
             "sigma0_rel_err": rel_gap(g["sigma0"], c["sigma0"]),
             "success": bool(g["success"])}
            for g, c, rho in zip(got_grid, cpu_grid, rhos)]
    recs.append({"engine": "tapered",
                 "eta_rel_err": rel_gap(got_taper["eta"], cpu_taper["eta"]),
                 "sigma0_rel_err": rel_gap(got_taper["sigma0"],
                                           cpu_taper["sigma0"]),
                 "success": bool(got_taper["success"])})
    ok = (all(r["success"] and r["eta_rel_err"] < 5e-2
              and r["sigma0_rel_err"] < 5e-3 for r in recs)
          and launches["matern_matmat_multirho_mma"] == 32
          and launches["matern_matmat_multirho"] == 1
          and launches["matern_matmat_blocksparse_mma"] == STEPS
          and launches["matern_matmat_blocksparse"] == 1)
    log(phase="engines_default_bf16x3", ok=ok, launches=launches,
        engines=recs)
    if not ok:
        raise AssertionError("grid or tapered engine under the default "
                             "bf16x3 disagrees with cpu float64")


def phase_paths_bf16x3(dev, grid_exact, taper_op, taper_exact,
                       setup_seconds_highest):
    """The grid path (one chunk of 8 rhos at n = 100,000) and the tapered
    path (n = 2^20) at full size with 'bf16x3' made the module default by
    assignment: the launches of the two tensor-core kernels, counted at the
    shapes their times are taken at (each construction also launches its
    exact kernel once, for the trace). ``grid_exact`` and ``taper_exact``
    are the fits of the same paths under 'highest' (phases 10 and 12) and
    ``setup_seconds_highest`` their (grid, tapered) setup seconds; the
    tapered operator's geometry does not depend on the mode and is reused."""
    pts, z, X = make_problem(N_MAIN, 7)
    B = len(GRID_RHOS)
    probes, v_defl = random_block(N_MAIN, GRID_PROBES, 2)
    tpts, tz, tX = tapered_problem(TAPER_SIDE)
    previous = cuda_kernels.DEFAULT_DOT_MODE
    cuda_kernels.DEFAULT_DOT_MODE = "bf16x3"
    try:
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        grid = GridKrylovProfileLikelihood(
            pts, X, z, GRID_RHOS, np.full(B, NU), nu_static=NU,
            lanczos_steps=GRID_STEPS, num_probes=GRID_PROBES,
            matrix_free=True, chunk=B, device=dev, probes=probes,
            v_defl=v_defl)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        grid_launches = dict(cuda_kernels.launch_counts)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng = KrylovProfileLikelihood(taper_op, tX, tz, lanczos_steps=STEPS,
                                      num_probes=PROBES, device=dev)
        torch.cuda.synchronize()
        taper_s = time.perf_counter() - t0
        taper_launches = dict(cuda_kernels.launch_counts)
    finally:
        cuda_kernels.DEFAULT_DOT_MODE = previous
    results, res = grid.fit_all(), eng.fit()
    fits = [{"rho": r["rho"], "eta": r["eta"], "sigma0": r["sigma0"],
             "eta_rel_gap_to_highest": rel_gap(r["eta"], e["eta"]),
             "sigma0_rel_gap_to_highest": rel_gap(r["sigma0"], e["sigma0"]),
             "success": bool(r["success"])}
            for r, e in zip(results, grid_exact)]
    taper = {"eta_star": res["eta"], "sigma0": res["sigma0"],
             "eta_rel_gap_to_highest": rel_gap(res["eta"],
                                               taper_exact["eta"]),
             "sigma0_rel_gap_to_highest": rel_gap(res["sigma0"],
                                                  taper_exact["sigma0"]),
             "success": bool(res["success"])}
    # the default random block is drawn from the same seed under either
    # mode, so the fits differ by the mode's rounding alone
    ok = (all(f["success"] and f["eta_rel_gap_to_highest"] < 1e-2
              and f["sigma0_rel_gap_to_highest"] < 1e-3
              for f in fits + [taper])
          and 0.18 < res["sigma0"] < 0.22
          and grid_launches == {**dict.fromkeys(grid_launches, 0),
                                "matern_matmat_multirho_mma": GRID_STEPS,
                                "matern_matmat_multirho": 1}
          and taper_launches == {**dict.fromkeys(taper_launches, 0),
                                 "matern_matmat_blocksparse_mma": STEPS,
                                 "matern_matmat_blocksparse": 1})
    log(phase="paths_default_bf16x3", ok=ok, n_grid=N_MAIN, B=B,
        n_tapered=taper_op.shape[0], grid_setup_seconds=grid_s,
        tapered_setup_seconds=taper_s,
        grid_setup_seconds_highest=setup_seconds_highest[0],
        tapered_setup_seconds_highest=setup_seconds_highest[1],
        grid_launches=grid_launches,
        tapered_launches=taper_launches, grid_fits=fits, tapered_fit=taper)
    if not ok:
        raise AssertionError("the grid or the tapered path under the "
                             "default bf16x3 failed")
    return {"matern_matmat_multirho_mma":
            grid_launches["matern_matmat_multirho_mma"],
            "matern_matmat_blocksparse_mma":
            taper_launches["matern_matmat_blocksparse_mma"]}


def phase_precision_matrix(dev):
    """The precision-matrix path at n = 100,000: the engine constructed
    under each tile-dot mode (twice; chained matvec time; error against the
    plain exact path; der1(1)), then fitted. A construction is 64 matvec
    launches of the tensor-core kernel in the mode's format and one
    trace(K^2) launch, which always goes to the FP32 kernel (the trace sums
    the unrounded k^2)."""
    cuda_kernels.reset_launch_counts()
    records, mma_launches = {}, {}
    for mode in cuda_kernels.DOT_MODES:
        before = cuda_kernels.launch_counts["matern_matmat_mma"]
        rec, eng = profile_kernel_matrix.run_one(mode, n=N_MAIN, device=dev,
                                                 return_engine=True)
        mma_launches[mode] = (cuda_kernels.launch_counts["matern_matmat_mma"]
                              - before)
        t0 = time.perf_counter()
        res = eng.fit()
        rec["fit_seconds_host_numpy"] = time.perf_counter() - t0
        rec.update(eta_star=res["eta"], sigma0=res["sigma0"],
                   sigma=res["sigma"], fit_success=bool(res["success"]))
        records[mode] = rec
    launches = dict(cuda_kernels.launch_counts)
    ok = all(r["fit_success"] and all(np.isfinite(
        r[k]) for k in ("eta_star", "sigma0", "sigma"))
        for r in records.values())
    for rec in records.values():
        ok = ok and rec["launches_per_construction"] == {
            "matern_matmat_mma": STEPS, "matern_matmat": 1}
    for mode in ("highest", "bf16x3"):
        ok = ok and 0.19 < records[mode]["sigma0"] < 0.21
    gaps = {mode: rel_gap(records[mode]["eta_star"],
                          records["highest"]["eta_star"])
            for mode in NEW_MODES}
    # 'bf16' is only required to fit: its gap is recorded, not bounded
    ok = (ok and gaps["bf16x3"] < 1e-2
          and all(mma_launches[m] > 0 for m in cuda_kernels.DOT_MODES))
    log(phase="precision_matrix", ok=ok, n=N_MAIN, rho=RHO, nu=NU,
        lanczos_steps=STEPS, num_probes=PROBES,
        eta_star_rel_gap_to_highest=gaps, launches_total=launches,
        modes=list(records.values()))
    if not ok:
        raise AssertionError(f"precision-matrix path failed: {records}")
    return mma_launches


def phase_roofline(dev):
    """The roofline sweep at n = 100,000, 12 rows, reps cut to 3 warm and 5
    timed products per row."""
    cuda_kernels.reset_launch_counts()
    out = roofline_matvec.main(n=N_MAIN, device=dev, warm=3, reps=5,
                               verbose=False)
    launches = dict(cuda_kernels.launch_counts)
    rows = out["rows"]
    shares = [row[k] for row in rows for k in ("pct_f32_peak",
                                               "pct_bf16_peak",
                                               "pct_tf32_peak")]
    gram_launches = sum(
        row["launches"].get("matern_matmat_mma", 0) for row in rows
        if row["dist_mode"] == "gram" and row["dot_mode"] == "highest")
    # every row's products on the tensor-core kernel, none on the FP32 one
    ok = (len(rows) == 12 and all(0 <= s <= 100 for s in shares)
          and launches["matern_matmat_mma"] == 12 * 8
          and launches["matern_matmat"] == 0 and gram_launches == 3 * 8)
    log(phase="roofline", ok=ok, launches=launches, **out)
    if not ok:
        raise AssertionError(f"roofline sweep failed: {out}")
    return gram_launches


def phase_mode_time(dev, taper_op):
    """Kernel, plain and error at the paths' shapes: matern_matmat at
    n = 100,000, r = 24 under diff/bf16x3, diff/bf16 and gram/highest, with
    diff/highest timed in the same turns (all four on the tensor-core
    kernel); the tensor-core multirho kernel (B = 8, r = 16) and
    blocksparse kernel (the full-size pair list, r = 24) under all three
    modes, each beside its plain version."""
    pts, _, _ = make_problem(N_MAIN, 7)
    r, d = 24, 2
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    V = torch.randn((N_MAIN, r), generator=g, device=dev)
    scale = kernels.broadcast_scale(RHO, d, dtype=F32, device=dev)
    want = cuda_kernels.matern_matmat_plain(
        P.double(), scale.double(), V.double(), NU, block_rows=1024)
    pairs = N_MAIN * N_MAIN
    nbytes = 4 * (N_MAIN * d + 2 * N_MAIN * r)
    configs = {"bf16x3": ("bf16x3", "diff"), "bf16": ("bf16", "diff"),
               "gram": ("highest", "gram")}
    fns = {"kernel_highest": lambda: cuda_kernels.matern_matmat(
        P, scale, V, NU)}
    for name, (dot_mode, dist_mode) in configs.items():
        kw = dict(dot_mode=dot_mode, dist_mode=dist_mode)
        fns[f"kernel_{name}"] = lambda kw=kw: cuda_kernels.matern_matmat(
            P, scale, V, NU, **kw)
        fns[f"plain_{name}"] = lambda kw=kw: \
            cuda_kernels.matern_matmat_plain(P, scale, V, NU,
                                             block_rows=1024, **kw)
    med, times = median_in_turns(fns)
    out, ok = {}, True
    for name, (dot_mode, dist_mode) in configs.items():
        got = fns[f"kernel_{name}"]()
        own = fns[f"plain_{name}"]()
        rec = {"dot_mode": dot_mode, "dist_mode": dist_mode}
        rec.update(mode_errors(got, own, want))
        ok = mode_verdict(rec, dot_mode, dist_mode) and ok
        # per pair on the CUDA cores: the distance (3d, or the Gram form's
        # 2d + 3), scale/sqrt/exp, and the split or rounding of k (3 for
        # two tf32 values, 5 for two bf16 values, 2 for one); on the SFU
        # the sqrt and the exp of k, IEEE or approximate; on the tensor
        # cores 2r per product, three products but under 'bf16', tf32
        # operands under 'highest'
        core = (2 * d + 3 if dist_mode == "gram" else 3 * d) + nu_ops(NU)
        core += {"highest": 3, "bf16x3": 5, "bf16": 2}[dot_mode]
        tensor = pairs * 2 * r * (1 if dot_mode == "bf16" else 3)
        mufu = pairs * nu_mufu(NU)
        bound_ms, bound_by, bound_term = (
            bound(nbytes, pairs * core, tf32_ops=tensor, mufu_ops=mufu)
            if dot_mode == "highest" else
            bound(nbytes, pairs * core, tensor, mufu_ops=mufu))
        out[name] = {"max_abs_err": rec["max_abs_err"],
                     "ms": med[f"kernel_{name}"],
                     "plain_ms": med[f"plain_{name}"], "bound_ms": bound_ms,
                     "bound_by": bound_by}
        log(phase="mode_time", ok=ok, n=N_MAIN, r=r, reps=7, **rec,
            kernel_ms_median=med[f"kernel_{name}"],
            plain_f32_ms_median=med[f"plain_{name}"],
            kernel_highest_diff_ms_median=med["kernel_highest"],
            bound_ms=bound_ms, bound_by=bound_by, bound_term=bound_term,
            kernel_ms_all=times[f"kernel_{name}"])
    del want
    if not ok:
        raise AssertionError("a mode kernel is out of its bounds at the "
                             "main path's shape")

    # the tensor-core multirho kernel at the grid path's shape in every
    # mode, held to its bounds one rho at a time: K is nearly dense at the
    # largest rho, where the sums are longest. Under 'highest' its own plain
    # version is plain float32 (the 3xTF32 one is phase 13's gap)
    B, r2 = len(GRID_RHOS), 16
    rhos = torch.as_tensor(GRID_RHOS, dtype=F32, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    V2 = torch.randn((B, N_MAIN, r2), generator=g, device=dev)
    fns = {}
    for mode in cuda_kernels.DOT_MODES:
        fns[f"kernel_{mode}"] = lambda mode=mode: \
            cuda_kernels.matern_matmat_multirho(P, rhos, V2, NU,
                                                dot_mode=mode)
        fns[f"plain_{mode}"] = lambda mode=mode: \
            cuda_kernels.matern_matmat_multirho_plain(P, rhos, V2, NU,
                                                      dot_mode=mode)
    med, times = median_in_turns(fns)
    want = cuda_kernels.matern_matmat_multirho_plain(
        P.double(), 1.0 / (1.0 / rhos).double(), V2.double(), NU)
    for mode in cuda_kernels.DOT_MODES:
        got, own = fns[f"kernel_{mode}"](), fns[f"plain_{mode}"]()
        per_rho = [mode_errors(got[b], own[b], want[b]) for b in range(B)]
        ok = all(mode_verdict(e, mode) for e in per_rho)
        rec = {"kernel": "matern_matmat_multirho_mma", "dot_mode": mode,
               "rhos": list(GRID_RHOS),
               **{k: [e[k] for e in per_rho] for k in per_rho[0]}}
        del got, own
        if mode == "highest":
            (bound_ms, bound_by, bound_term), _, _ = multirho_bounds(
                N_MAIN, B, r2, d, NU)
        else:
            # the products are bf16 operands with float32 sums, charged to
            # the tensor cores' peak; the distance, the closed form and the
            # rounding of k per rho are CUDA-core operations; one sqrt per
            # pair and one exp per pair and rho on the SFU
            products, rounding = (3, 5) if mode == "bf16x3" else (1, 2)
            bound_ms, bound_by, bound_term = bound(
                4 * (N_MAIN * d + B + 2 * B * N_MAIN * r2),
                pairs * (3 * d + 1 + B * (nu_ops(NU) + rounding)),
                pairs * B * 2 * r2 * products, mufu_ops=pairs * (1 + B))
        out[f"multirho_{mode}"] = {
            "max_abs_err": max(rec["max_abs_err"]),
            "ms": med[f"kernel_{mode}"], "plain_ms": med[f"plain_{mode}"],
            "bound_ms": bound_ms, "bound_by": bound_by}
        log(phase="mode_time", ok=ok, n=N_MAIN, B=B, r=r2, reps=7, **rec,
            kernel_ms_median=med[f"kernel_{mode}"],
            plain_f32_ms_median=med[f"plain_{mode}"],
            bound_ms=bound_ms, bound_by=bound_by, bound_term=bound_term,
            kernel_ms_all=times[f"kernel_{mode}"])
        if not ok:
            raise AssertionError(f"multirho under {mode} is out of its "
                                 f"bounds at the grid path's shape")
    del want, V2

    # the tensor-core blocksparse kernel on the tapered path's pair list in
    # every mode; the errors at a threshold clear of every pair, the times
    # at the operator's own
    op = taper_op
    n, r3 = op.shape[0], 24
    g = torch.Generator(device=dev).manual_seed(13)
    V3 = torch.randn((op.n_pad, r3), generator=g, device=dev)
    V3[n:] = 0
    tau = clear_threshold(op)
    kw = dict(n=n, row_ptr=op._row_ptr)
    geometry = (op.pair_i, op._pair_j, op.tile)
    args = (op.nu, op.threshold, *geometry)
    fns = {}
    for mode in cuda_kernels.DOT_MODES:
        fns[f"kernel_{mode}"] = lambda mode=mode: \
            cuda_kernels.matern_matmat_blocksparse(
                op.points_sorted, V3, *args, dot_mode=mode, **kw)
        fns[f"plain_{mode}"] = lambda mode=mode: \
            cuda_kernels.matern_matmat_blocksparse_plain(
                op.points_sorted, V3, *args, dot_mode=mode, **kw)
    med, times = median_in_turns(fns)
    want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), V3.double(), op.nu, tau, *geometry, **kw)
    pairs3 = tile_pairs(op)
    for mode in cuda_kernels.DOT_MODES:
        got = cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, V3, op.nu, tau, *geometry, dot_mode=mode, **kw)
        again = cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, V3, op.nu, tau, *geometry, dot_mode=mode, **kw)
        own = cuda_kernels.matern_matmat_blocksparse_plain(
            op.points_sorted, V3, op.nu, tau, *geometry, dot_mode=mode, **kw)
        rec = {"kernel": "matern_matmat_blocksparse_mma", "dot_mode": mode,
               "tau": tau, "same_bits_run_to_run": torch.equal(got, again)}
        rec.update(mode_errors(got, own, want))
        del got, again, own
        ok = mode_verdict(rec, mode) and rec["same_bits_run_to_run"]
        if mode == "highest":
            _, (bound_ms, bound_by, bound_term), _, _ = blocksparse_bounds(
                op, r3, d)
        else:
            products, rounding = (3, 5) if mode == "bf16x3" else (1, 2)
            bound_ms, bound_by, bound_term = bound(
                4 * (op.n_pad * d + 2 * op.n_pad * r3 + op.num_tiles + 1
                     + len(op.pair_j)),
                pairs3 * (3 * d + nu_ops(op.nu) + 1 + rounding),
                pairs3 * 2 * r3 * products,
                mufu_ops=pairs3 * nu_mufu(op.nu))
        out[f"blocksparse_{mode}"] = {
            "max_abs_err": rec["max_abs_err"], "ms": med[f"kernel_{mode}"],
            "plain_ms": med[f"plain_{mode}"], "bound_ms": bound_ms,
            "bound_by": bound_by}
        log(phase="mode_time", ok=ok, n=n, r=r3, reps=7, pairs=pairs3,
            **rec, kernel_ms_median=med[f"kernel_{mode}"],
            plain_f32_ms_median=med[f"plain_{mode}"],
            bound_ms=bound_ms, bound_by=bound_by, bound_term=bound_term,
            kernel_ms_all=times[f"kernel_{mode}"])
        if not ok:
            raise AssertionError(f"blocksparse under {mode} is out of its "
                                 f"bounds at the tapered path's shape")
    return out


# -- the exact dense path and the public API (phases 19, 20) -----------------

# the reference's dense benchmark configuration (bench.py:224-249,
# SURVEY:371): a 64 x 64 grid, rho 0.1, nu 0.5, degree-2 basis, noise 0.2;
# and the largest size of its dense sweep, 2^13 points (SURVEY:228), as a
# 128 x 64 grid of the unit square
DENSE_SIDE, DENSE_LARGE = 64, (128, 64)
# phase 19's assembly against a plain float64 one: float32 points scaled by
# 1/rho lose ~1e-7 of their ~10 to rounding, which the difference of two
# near points keeps (6.9e-7 in a float32 assembly on the CPU)
ASSEMBLY_ATOL = 1e-6


def grid_points(nx, ny):
    """An nx x ny grid of the unit square, x fastest."""
    gx, gy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def dense_problem(pts):
    return (data_utils.generate_data(pts, 0.2),
            data_utils.generate_basis_functions(pts, 2))


def sync_seconds(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dense_fit(dev, K, X, z, method, **kw):
    """One GaussianProcess(X, K, method).train(z) on the card, timed: the
    constructor (the float64 eigendecomposition, for 'eigenvalue'), the
    rotation of X and z on its own, and train (which rotates again before
    its host float64 fit) twice: the first call of a process carries the
    one-time costs of torch.func and cuSOLVER, the second does not."""
    t0 = time.perf_counter()
    gp = gppe_tpu_torch.GaussianProcess(X, K, method, device=dev, **kw)
    construct_s = sync_seconds(t0)
    rotation_s = None
    if not gp.likelihood.operator_mode:
        t0 = time.perf_counter()
        direct_likelihood.make_spectral_data(gp.likelihood.K_mixed, X, z)
        rotation_s = sync_seconds(t0)
    train_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = gp.train(z)
        train_s.append(sync_seconds(t0))
    finite = all(np.isfinite(res[k]) for k in ("eta", "sigma", "sigma0"))
    rec = {"method": method, **kw, "eta": res["eta"], "sigma": res["sigma"],
           "sigma0": res["sigma0"], "success": bool(res["success"]),
           "finite": finite, "iterations": res["iterations"],
           "constructor_s": construct_s, "rotation_s": rotation_s,
           "train_s": train_s[0], "train_again_s": train_s[1]}
    return gp, rec


# the traceinv interpolant (8 knots, log-spaced over [1e-4, 1e3]) against
# the exact traceinv: at a knot it returns the exact value it was built on;
# between knots the log-log spline is within 1.3% at n = 1024 and 0.7% at
# n = 2304 on a grid of the unit square (float64 on the CPU)
INTERP_KNOT_RTOL, INTERP_RTOL = 1e-9, 5e-2


def interpolant_gaps(K_mixed, eta_fit):
    """Relative gaps of K_mixed.traceinv (the interpolant) to its exact
    traceinv at each knot, and at the geometric midpoints of the knots and
    the fit's eta."""
    knots = K_mixed._traceinv_interp.points
    between = list(np.sqrt(knots[1:] * knots[:-1])) + [eta_fit]

    def gap(eta):
        return rel_gap(float(K_mixed.traceinv(eta)),
                       float(K_mixed._traceinv_exact(eta)))
    return {"knots": {repr(float(e)): gap(e) for e in knots},
            "between": {repr(float(e)): gap(e) for e in between}}


def phase_dense_api(dev):
    """Phase 19: generate_correlation and GaussianProcess(X, K, m).train(z)
    at the reference's dense configuration, n = 4096, then n = 8192."""
    pts = data_utils.generate_points(DENSE_SIDE, dimension=2)
    z, X = dense_problem(pts)
    t0 = time.perf_counter()
    K = gppe_tpu_torch.generate_correlation(pts, RHO, nu=NU, device=dev)
    assembly_s = sync_seconds(t0)
    want = assembly.dense_correlation(pts, RHO, NU, dtype=F64, device=dev)
    assembly_err = float(torch.max(torch.abs(K.double() - want)))
    symmetric = float(torch.max(torch.abs(K - K.T)))
    unit_diag = bool(torch.all(torch.diagonal(K) == 1.0))
    del want
    ok = (K.dtype == F32 and K.device.type == "cuda" and unit_diag
          and symmetric == 0.0 and assembly_err < ASSEMBLY_ATOL)

    fits, gps = {}, {}
    for method in ("direct", "profiled"):
        gps[method], fits[method] = dense_fit(dev, K, X, z, method)
    d, p = fits["direct"], fits["profiled"]
    agree = {k: rel_gap(d[k], p[k]) for k in ("eta", "sigma", "sigma0")}
    ok = (ok and all(f["success"] and f["finite"]
                     and 0.18 < f["sigma0"] < 0.22 for f in fits.values())
          and agree["eta"] < 1e-3 and agree["sigma"] < 1e-3)

    # the Krylov route over the dense K, and interpolate=True. The
    # spectral fit reads no traceinv, so the interpolated route's eta
    # equals the eigenvalue route's by construction; the interpolant is
    # held against the exact traceinv instead: at its knots, between them
    # and at the fit's eta
    _, fits["cholesky"] = dense_fit(dev, K, X, z, "profiled",
                                    imate_method="cholesky")
    gp_interp, fits["interpolate"] = dense_fit(dev, K, X, z, "profiled",
                                               interpolate=True)
    route_gap = {k: rel_gap(fits[k]["eta"], p["eta"])
                 for k in ("cholesky", "interpolate")}
    ok = (ok and all(fits[k]["success"] and fits[k]["finite"]
                     for k in route_gap)
          and all(g < 5e-2 for g in route_gap.values()))
    interp = interpolant_gaps(gp_interp.likelihood.K_mixed, p["eta"])
    del gp_interp
    ok = (ok and all(g < INTERP_KNOT_RTOL for g in interp["knots"].values())
          and all(g < INTERP_RTOL for g in interp["between"].values()))

    # lp at the optimum: spectral, and on the operator route (CG + SLQ on
    # a MaternOperator of the same points)
    hp = (p["sigma"], p["sigma0"])
    lp_spectral = gps["profiled"].likelihood.likelihood(z, hp)
    op = MaternOperator(pts, RHO, nu=NU, device=dev)
    gp_op = gppe_tpu_torch.GaussianProcess(X, op, "profiled", device=dev)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lp_operator = gp_op.likelihood.likelihood(z, hp)
    lp_operator_s = sync_seconds(t0)
    lp_launches = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    ok = ok and np.isfinite(lp_operator) and np.isfinite(lp_spectral)
    del gps, gp_op, op

    # the largest size of the reference's dense sweep, both methods
    pts8 = grid_points(*DENSE_LARGE)
    z8, X8 = dense_problem(pts8)
    t0 = time.perf_counter()
    K8 = gppe_tpu_torch.generate_correlation(pts8, RHO, nu=NU, device=dev)
    assembly8_s = sync_seconds(t0)
    fit8 = {m: dense_fit(dev, K8, X8, z8, m)[1]
            for m in ("profiled", "direct")}
    del K8
    agree8 = rel_gap(fit8["direct"]["eta"], fit8["profiled"]["eta"])
    ok = (ok and all(f["success"] and f["finite"]
                     and 0.18 < f["sigma0"] < 0.22 for f in fit8.values())
          and agree8 < 1e-3)
    log(phase="dense_api", ok=ok, n=len(pts), rho=RHO, nu=NU,
        assembly_s=assembly_s, assembly_max_abs_err_vs_f64=assembly_err,
        assembly_atol=ASSEMBLY_ATOL, symmetry_max_abs=symmetric,
        unit_diagonal=unit_diag, fits=fits,
        direct_vs_profiled_rel_gap=agree,
        eta_rel_gap_to_eigenvalue_route=route_gap,
        interpolant_rel_gap_to_exact_traceinv=interp,
        interpolant_rtol={"knots": INTERP_KNOT_RTOL,
                          "between": INTERP_RTOL},
        lp_spectral=lp_spectral, lp_operator_route=lp_operator,
        lp_gap=lp_operator - lp_spectral, lp_operator_s=lp_operator_s,
        lp_operator_launches=lp_launches,
        n_large=len(pts8), grid_large=list(DENSE_LARGE),
        assembly_large_s=assembly8_s, fits_large=fit8,
        direct_vs_profiled_eta_rel_gap_large=agree8,
        peak_device_memory_bytes=torch.cuda.max_memory_allocated(dev))
    if not ok:
        raise AssertionError(f"dense public API failed: {fits}, {fit8}")


def matmat_bound(n, r, d, nu):
    """bound() of one 'highest' product K @ V (n x n, V n x r) as 3xTF32:
    three tf32 products on the tensor cores; per pair on the CUDA cores the
    distance, k and the split of k (3), on the SFU the sqrt and the exp of
    k."""
    pairs = n * n
    return bound(4 * (n * d + 2 * n * r), pairs * (3 * d + nu_ops(nu) + 3),
                 tf32_ops=pairs * 2 * r * 3, mufu_ops=pairs * nu_mufu(nu))


# the operator route's widths: CG over z and the deflation chain (1), CG
# over the basis X (6), SLQ's probes (16); and Hutchinson's probes (32),
# which phase 20 runs on its own: no path of the port calls it
ROUTE_WIDTHS = (1, 6, 16, 32)


def phase_public_operator_route(dev, main_fit):
    """Phase 20: GaussianProcess(X, MaternOperator, 'profiled').train(z) on
    phase 5's problem, then likelihood(z, hp) at that fit (CG and SLQ),
    each in its own count window: the launch counts are set to 0 just
    before the call and read just after it. Then, outside both windows,
    the route's pieces on their own (its CG solves with their iterations
    per column, a second build of its SLQ engine), Hutchinson's traceinv
    at width 32 (no path of the port calls it), and B1 at the widths
    against its plain version and its bound."""
    pts, z, X = make_problem(N_MAIN, 7)
    op = MaternOperator(pts, RHO, nu=NU, device=dev)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gp = gppe_tpu_torch.GaussianProcess(X, op, "profiled",
                                        lanczos_steps=STEPS,
                                        num_probes=PROBES, device=dev)
    res = gp.train(z)
    fit_s = sync_seconds(t0)
    fit_launches = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    same_bits = all(res[k] == main_fit[k] for k in ("eta", "sigma",
                                                    "sigma0"))

    # likelihood(z, hp) at the fit: Kn^-1 X (CG at width 6), Kn^-1 z (CG
    # at width 1) and the logdet from the SLQ engine the MixedCorrelation
    # builds on first use (deflation chain at width 1, probes at width 16,
    # trace(K^2) for M2)
    eta, hp = res["eta"], (res["sigma"], res["sigma0"])
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lp = gp.likelihood.likelihood(z, hp)
    lp_s = sync_seconds(t0)
    lp_launches = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    path_launches = {k: fit_launches.get(k, 0) + lp_launches.get(k, 0)
                     for k in set(fit_launches) | set(lp_launches)}

    # outside the windows: the same CG solves for their iterations per
    # column, and the SLQ engine built again for its seconds
    X_dev = torch.as_tensor(X, dtype=F32, device=dev)
    z_dev = torch.as_tensor(z, dtype=F32, device=dev)
    cg = {}
    for name, B in (("X", X_dev), ("z", z_dev[:, None])):
        t0 = time.perf_counter()
        _, its = linalg.cg_solve(op.matmat, B, shift=eta,
                                 return_iterations=True)
        cg[name] = {"seconds": sync_seconds(t0),
                    "iterations_per_column": its.tolist()}
    slq = gp.likelihood.K_mixed._get_stoch()
    gp.likelihood.K_mixed._stoch = None
    t0 = time.perf_counter()
    slq_again = gp.likelihood.K_mixed._get_stoch()
    slq_s = sync_seconds(t0)
    del slq_again

    # Hutchinson's traceinv at width 32 beside the SLQ engine's
    t0 = time.perf_counter()
    hutch = stochastic.hutchinson_traceinv(op, eta, num_probes=32)
    hutch_s = sync_seconds(t0)
    slq_traceinv = slq.traceinv(eta)
    max_its = max(max(c["iterations_per_column"]) for c in cg.values())
    ok = (same_bits and res["success"] and np.isfinite(lp)
          and np.isfinite(hutch) and max_its < 1000
          and all(w.get(k, 0) > 0 for w in (fit_launches, lp_launches)
                  for k in ("matern_matmat_mma", "matern_matmat"))
          and rel_gap(hutch, slq_traceinv) < 5e-2)
    log(phase="public_operator_route", ok=ok, n=N_MAIN, rho=RHO, nu=NU,
        lanczos_steps=STEPS, num_probes=PROBES, fit=res,
        fit_equals_main_path_bits=same_bits, fit_seconds=fit_s,
        fit_launches=fit_launches, lp=lp, lp_seconds=lp_s,
        lp_launches=lp_launches, path_launches=path_launches, cg=cg,
        slq_engine_seconds=slq_s, slq_deflated=slq.q,
        slq_lanczos_steps=slq.lanczos_steps, slq_probes=slq.num_probes,
        hutchinson_traceinv=hutch, hutchinson_seconds=hutch_s,
        slq_traceinv=slq_traceinv,
        hutchinson_rel_gap_to_slq=rel_gap(hutch, slq_traceinv))
    if not ok:
        raise AssertionError(f"public API operator route failed: {res}, "
                             f"main path {main_fit}, launches "
                             f"{fit_launches} / {lp_launches}")

    # B1 at the route's widths, at n = 100,000: kernel, plain and bound
    P = op.points
    g = torch.Generator(device=dev).manual_seed(14)
    widths = {}
    for r in ROUTE_WIDTHS:
        V = torch.randn((N_MAIN, r), generator=g, device=dev)
        got = cuda_kernels.matern_matmat(P, op.scale, V, NU)
        want = cuda_kernels.matern_matmat_plain(
            P.double(), op.scale.double(), V.double(), NU, block_rows=1024)
        frob, max_abs = compare(got, want)
        med, times = median_in_turns({
            "kernel": lambda V=V: cuda_kernels.matern_matmat(P, op.scale, V,
                                                             NU),
            "plain": lambda V=V: cuda_kernels.matern_matmat_plain(
                P, op.scale, V, NU, block_rows=1024)}, reps=5)
        bound_ms, bound_by, bound_term = matmat_bound(N_MAIN, r, 2, NU)
        widths[r] = {"frob_rel_err": frob, "max_abs_err": max_abs,
                     "kernel_ms_median": med["kernel"],
                     "plain_f32_ms_median": med["plain"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_term": bound_term,
                     "kernel_ms_all": times["kernel"]}
    ok = all(w["frob_rel_err"] < FROB_TOL and w["max_abs_err"] < MAXABS_TOL
             for w in widths.values())
    log(phase="route_widths_time", ok=ok, n=N_MAIN, reps=5, widths=widths)
    if not ok:
        raise AssertionError("matern_matmat_mma is out of its bounds at the "
                             "operator route's widths")
    return fit_launches, lp_launches, path_launches


# -- general nu: the general-nu kernel and its paths (phases 21-24) -----------

# phase 21's orders: near 0, below and above 1/2, between the closed forms,
# and up to the edge of the (rho, nu) search's support (25)
GENERAL_NUS = (0.01, 0.3, 1.2, 3.7, 10.0, 24.9)
# k against float64: the reference's own float32 error at nu ~ 25
# (gppe_tpu/ops/kernels.py:33-36); products (Frobenius) and traces
GENERAL_K_ATOL, GENERAL_FROB_TOL, GENERAL_TRACE_RTOL = (
    cuda_kernels.GENERAL_K_ATOL, 1e-5, 1e-5)
# phases 23 and 24: the operator route at n = 10^4 and the (rho, nu) search
GENERAL_N, GENERAL_NU, GENERAL_STEPS, GENERAL_PROBES = 10_000, 1.2, 64, 16
GENERAL_BIG_N = 100_000
# the pairs whose trips phase 21-24's bounds count, sampled per shape
TRIP_SAMPLE = 1 << 21
LN2, F32_EPS = 0.693147180559945, float(np.finfo(np.float32).eps)


def general_trips(z, nu):
    """The trips each lane of z (scaled sqrt(2 nu) x, float32, > 0) takes
    in the general-nu kernel: (below z = 2, the Temme terms or CF2 steps
    it runs), in float32 with the kernel's per-launch constants and its
    convergence test, as the loops of csrc/matern_bessel.cuh run them."""
    c = cuda_kernels._general_consts(nu)
    mu, a1, fact, gam1, gam2, p0, q0 = (float(v) for v in c["scalars"][1:8])
    dev = z.device
    tem = torch.as_tensor(c["temme"], device=dev)
    cf = torch.as_tensor(c["cf2"], device=dev)
    small = z < 2.0
    trips = torch.zeros(z.shape, dtype=torch.int32, device=dev)

    def run(state, step, count):
        live = torch.ones(state[0].shape, dtype=torch.bool, device=dev)
        taken = torch.zeros(state[0].shape, dtype=torch.int32, device=dev)
        for i in range(count):
            state, converged = step(i, state)
            taken += live.int()
            live &= ~converged
            if not bool(live.any()):
                break
        return taken

    zs = z[small]
    if zs.numel():
        d = LN2 - torch.log(zs)
        e = mu * d
        fact2 = torch.where(e == 0, torch.ones_like(e),
                            torch.sinh(e) / torch.where(e == 0,
                                                        torch.ones_like(e),
                                                        e))
        ee, eei = torch.exp(e), torch.exp(-e)
        ff = fact * (gam1 * (0.5 * (ee + eei)) + gam2 * fact2 * d)
        dd = (0.5 * zs) ** 2

        def temme(i, st):
            ff, p, q, cc, s, s1 = st
            fi = float(i + 1)
            ff = (fi * ff + p + q) * tem[0, i]
            cc = cc * dd * tem[3, i]
            p, q = p * tem[1, i], q * tem[2, i]
            dl, dl1 = cc * ff, cc * (p - fi * ff)
            s, s1 = s + dl, s1 + dl1
            return (ff, p, q, cc, s, s1), ((dl.abs() < s.abs() * F32_EPS)
                                           & (dl1.abs() < s1.abs() * F32_EPS))
        p = p0 * ee
        trips[small] = run((ff, p, q0 * eei, torch.ones_like(ff), ff, p),
                           temme, 30)
    zl = z[~small]
    if zl.numel():
        b = 2.0 * (1.0 + zl)
        d = 1.0 / b

        def cf2(i, st):
            b, d, h, delh, q1, q2, q, cc, s = st
            cc = cc * cf[2, i]
            qnew = (q1 - b * q2) * cf[1, i]
            q1, q2 = q2, qnew
            q = q + cc * qnew
            b = b + 2.0
            d = 1.0 / (b + cf[0, i] * d)
            delh = (b * d - 1.0) * delh
            h = h + delh
            dels = q * delh
            s = s + dels
            return ((b, d, h, delh, q1, q2, q, cc, s),
                    (dels.abs() < s.abs() * F32_EPS)
                    & (delh.abs() < h.abs() * F32_EPS))
        full = torch.full_like(zl, a1)
        trips[~small] = run((b, d, d, d, torch.zeros_like(zl),
                             torch.ones_like(zl), full, full,
                             1.0 + a1 * d), cf2, 59)
    return small, trips


_GENERAL_PIECES = None


def general_pieces():
    """FP32 and MUFU operations of each piece of the general-nu device
    function, counted from this checkout's machine code
    (chip_profile.general_piece_ops, `chip_profile.py sass-mix`)."""
    global _GENERAL_PIECES
    if _GENERAL_PIECES is None:
        import chip_profile
        _GENERAL_PIECES = chip_profile.general_piece_ops()
        log(phase="general_pieces", pieces=_GENERAL_PIECES)
    return _GENERAL_PIECES


def general_k_work(x, nu):
    """Mean FP32 and MUFU operations of one k over the scaled distances x
    (float32, a sample of the call's pairs): each nonzero x its entry, its
    branch's setup, trips and finish, the recurrence and the end; x = 0
    none (the kernel returns 1)."""
    pc = general_pieces()
    xs = x[x > 0]
    z = torch.clamp(float(np.float32(np.sqrt(2.0 * nu))) * xs, min=1e-30)
    small, trips = general_trips(z, nu)
    nl = int(np.floor(nu + 0.5))
    rec = ({"fp32": 1 + (nl - 2) * pc["rec_step"]["fp32"],
            "mufu": (nl - 2) * pc["rec_step"]["mufu"]} if nl >= 2
           else {"fp32": 0, "mufu": 0})
    frac_small = float(small.float().mean())
    out = {}
    for key in ("fp32", "mufu"):
        fixed = pc["entry"][key] + pc["rec_start"][key] + rec[key]
        t = trips[small].double().mean() if frac_small > 0 else 0.0
        c = trips[~small].double().mean() if frac_small < 1 else 0.0
        per = (fixed
               + frac_small * (pc["temme_setup"][key] + pc["temme_finish"][key]
                               + pc["end_small"][key]
                               + float(t) * pc["temme_step"][key])
               + (1 - frac_small) * (pc["cf2_setup"][key]
                                     + pc["cf2_finish"][key]
                                     + pc["end_large"][key]
                                     + float(c) * pc["cf2_step"][key]))
        out[key] = per * xs.numel() / max(x.numel(), 1)
    out["share_below_2"] = frac_small
    out["mean_temme_terms"] = (float(trips[small].float().mean())
                               if frac_small > 0 else None)
    out["mean_cf2_steps"] = (float(trips[~small].float().mean())
                             if frac_small < 1 else None)
    return out


def sample_pair_distances(P, rho, seed=0):
    """Scaled distances of TRIP_SAMPLE random pairs i != j of the points P
    (float32 on the card), as the kernels compute them."""
    n = P.shape[0]
    g = torch.Generator(device=P.device).manual_seed(seed)
    i = torch.randint(0, n, (TRIP_SAMPLE,), generator=g, device=P.device)
    j = torch.randint(0, n, (TRIP_SAMPLE,), generator=g, device=P.device)
    keep = i != j
    S = P / rho
    return torch.sqrt(((S[i[keep]] - S[j[keep]]) ** 2).sum(dim=1))


def general_bound(kind, n, d, r, nu, x_sample, elements=None):
    """bound() of one general-nu launch over this run's data: the
    elementwise entry over ``elements`` distances; the symmetric product
    K @ V (n x n, V n x r) and the trace over the n (n + 1) / 2 pairs of
    the symmetric walk (K is symmetric bit for bit), each pair its
    distance (3 d and a sqrt) and, off the diagonal, one k; then the
    product 2 r FMA operations on each of the n^2 ordered pairs (each k
    serves K[i, j] and K[j, i]), the trace one FMA on each walk pair. k's
    work is the mean over ``x_sample``, the call's own distances
    (general_k_work). Returns (ms, by, term, work)."""
    work = general_k_work(x_sample, nu)
    if kind == "elementwise":
        return (*bound(8 * elements, elements * work["fp32"],
                       mufu_ops=elements * work["mufu"]), work)
    off = n * (n - 1) // 2
    pairs = off + n
    ops = pairs * 3 * d + off * work["fp32"]
    if kind == "product":
        ops += n * n * 2 * r
        nbytes = 4 * (n * d + 2 * n * r)
    else:
        ops += 2 * pairs
        nbytes = 4 * n * d + 8
    return (*bound(nbytes, ops, mufu_ops=pairs + off * work["mufu"]), work)


# the float64 table of k that stands in for the plain float64 trace where
# that would take minutes (phase 23, n = 10^5): TABLE_NODES equal steps up
# to the largest scaled distance, linear between them; at n = 10^5, rho 0.1
# a step is 3.4e-6, so the table's error, h^2 / 8 |k''|, is ~1e-11, which
# each run measures on a sample of its distances against kernels.matern
TABLE_NODES = 1 << 22
TABLE_ATOL = 1e-9


def general_trace_f64(P, rho, nu, block_rows=1024):
    """trace(K^2) in float64 of the general-nu K over the points P (on the
    card) at scale rho, from a float64 table of k (TABLE_NODES steps,
    linear between them) on float64 distances: twice the sum over the
    pairs above the diagonal, row block by row block, plus n. Returns the
    trace and the table's largest error against kernels.matern on
    TRIP_SAMPLE of the points' pairs."""
    S = P.double() / rho
    n = S.shape[0]
    span = float(torch.linalg.norm(S.max(0).values - S.min(0).values))
    h = span * (1.0 + 1e-9) / TABLE_NODES
    table = kernels.matern(
        torch.arange(TABLE_NODES + 2, dtype=F64, device=P.device) * h, nu)

    def k_of(x):
        t = x / h
        i = torch.clamp(t.floor().long(), max=TABLE_NODES)
        return torch.lerp(table[i], table[i + 1], t - i)

    x = sample_pair_distances(P.double(), rho, seed=7)
    table_err = float((k_of(x) - kernels.matern(x, nu)).abs().max())
    total = 0.0
    for i0 in range(0, n, block_rows):
        rows = S[i0:i0 + block_rows]
        d2 = sum((rows[:, k, None] - S[None, i0:, k]) ** 2
                 for k in range(S.shape[1]))
        K = k_of(torch.sqrt(d2))
        total += 2.0 * float(torch.triu(K * K, diagonal=1).sum())
    return total + n, table_err


def launched(counts, *names):
    return {k: counts.get(k, 0) for k in names}


def with_slot_budget(nbytes, fn):
    """``fn()`` with the general-nu product's slot budget set to
    ``nbytes`` (``cuda_kernels.GENERAL_SLOT_BYTES``), so that its walk
    runs in other bands."""
    saved = cuda_kernels.GENERAL_SLOT_BYTES
    cuda_kernels.GENERAL_SLOT_BYTES = nbytes
    try:
        return fn()
    finally:
        cuda_kernels.GENERAL_SLOT_BYTES = saved


GENERAL_COUNTERS = ("matern_general_elementwise", "matern_general_product",
                    "matern_general_trace")
CLOSED_FORM_COUNTERS = ("matern_matmat", "matern_matmat_mma",
                        "matern_matmat_multirho",
                        "matern_matmat_multirho_mma")


def phase_general_parity(dev):
    """Phase 21: the three entries of the general-nu kernel against plain
    float64 on the card. (a) k over x in geomspace(1e-5, 40) and 0 at each
    nu of GENERAL_NUS: finite, in [0, 1], within GENERAL_K_ATOL; (b) and
    (c) at n = 1000 and 4096 random 2-D points and n = 1000 3-D points,
    r in {1, 7, 16, 24}: products (the symmetric walk; the rectangular
    one at r = 24) and traces (both walks) within GENERAL_FROB_TOL and
    GENERAL_TRACE_RTOL, the product and the trace the same bits twice; one
    batched product launch over the nus at six scales equal bit for bit to
    the six single calls, and to itself with its walk cut into bands of 7
    tile pairs; one batched trace launch over them equal bit for bit to
    the six single calls.
    Then the closed forms: the general kernel at
    nu = 1/2, 3/2, 5/2 and 150 against their plain forms, and matern_matmat
    there launching the closed-form kernels only."""
    x = torch.cat([torch.zeros(1, device=dev),
                   torch.logspace(-5, np.log10(40.0), 200_000,
                                  device=dev)]).float()
    elem = {}
    for nu in GENERAL_NUS:
        got = cuda_kernels.matern_general(x, nu)
        want = kernels.matern(x.double(), nu)
        # the reference's log form in float32 (the plain version), logged:
        # the two logs it sums cancel to log k
        plain = kernels.matern(x, nu)
        elem[nu] = {"max_abs_err": float((got.double() - want).abs().max()),
                    "plain_f32_max_abs_err": float(
                        (plain.double() - want).abs().max()),
                    "finite": bool(torch.isfinite(got).all()),
                    "in_0_1": bool(((got >= 0) & (got <= 1)).all()),
                    "at_zero": float(got[0])}
    ok = all(e["finite"] and e["in_0_1"] and e["at_zero"] == 1.0
             and e["max_abs_err"] < GENERAL_K_ATOL for e in elem.values())

    g = torch.Generator(device=dev).manual_seed(21)
    products, batches = [], []
    for n, d in ((1000, 2), (4096, 2), (1000, 3)):
        P = torch.rand((n, d), generator=g, device=dev)
        V = torch.randn((n, 24), generator=g, device=dev)
        C = torch.rand((n // 2 + 3, d), generator=g, device=dev)
        W = V[:C.shape[0]].contiguous()
        scale = kernels.broadcast_scale(RHO, d, dtype=F64, device=dev)
        for nu in GENERAL_NUS:
            want, fro_want = cuda_kernels.matern_matmat_plain(
                P.double(), scale, V.double(), nu, frobenius=True)
            fro = cuda_kernels.matern_general_matmat(
                P, RHO, None, nu, frobenius=True)[1]
            rec = {"n": n, "d": d, "nu": nu,
                   "trace_rel_err": rel_gap(float(fro), float(fro_want)),
                   "trace_same_bits_twice": float(fro) == float(
                       cuda_kernels.matern_general_matmat(
                           P, RHO, None, nu, frobenius=True)[1]),
                   "frob_rel_err": {}}
            for r in (1, 7, 16, 24):
                got = cuda_kernels.matern_general_matmat(
                    P, RHO, V[:, :r].contiguous(), nu)
                rec["frob_rel_err"][r] = compare(got, want[:, :r])[0]
            # the symmetric walk the same bits twice; the rectangular walk
            # (distinct column points, every tile pair) against float64
            rec["same_bits_twice"] = bool(torch.equal(
                got, cuda_kernels.matern_general_matmat(P, RHO, V, nu)))
            rect, rect_fro = cuda_kernels.matern_general_matmat(
                P, RHO, W, nu, points_cols=C, frobenius=True)
            rect_want, rect_fro_want = cuda_kernels.matern_matmat_plain(
                P.double(), scale, W.double(), nu, points_cols=C.double(),
                frobenius=True)
            rec["rectangular_frob_rel_err"] = compare(rect, rect_want)[0]
            rec["rectangular_trace_rel_err"] = rel_gap(float(rect_fro),
                                                       float(rect_fro_want))
            products.append(rec)
        # one batched launch over every nu, each at its own scale: each
        # point the bits of its single call
        rhos = [RHO * (1.0 + b / 4.0) for b in range(len(GENERAL_NUS))]
        Vb = torch.randn((len(GENERAL_NUS), n, 24), generator=g, device=dev)
        cuda_kernels.reset_launch_counts()
        batch = cuda_kernels.matern_general_matmat_batched(
            P, torch.tensor(rhos, device=dev), Vb, GENERAL_NUS)
        launches = cuda_kernels.launch_counts["matern_general_product"]
        walk = cuda_kernels.general_product_bands(n, n, 24,
                                                  len(GENERAL_NUS), True)
        cuda_kernels.reset_launch_counts()
        banded = with_slot_budget(
            4 * walk.slot_floats // walk.band_pairs * 7,
            lambda: cuda_kernels.matern_general_matmat_batched(
                P, torch.tensor(rhos, device=dev), Vb, GENERAL_NUS))
        banded_launches = cuda_kernels.launch_counts["matern_general_product"]
        cuda_kernels.reset_launch_counts()
        traces = cuda_kernels.matern_general_trace_batched(
            P, torch.tensor(rhos, device=dev), GENERAL_NUS)
        trace_launches = cuda_kernels.launch_counts["matern_general_trace"]
        batches.append({
            "n": n, "d": d, "rhos": rhos, "launches": launches,
            "trace_launches": trace_launches,
            "traces_equal_to_single_calls": all(
                float(traces[b]) == float(cuda_kernels.matern_general_matmat(
                    P, rhos[b], None, nu, frobenius=True)[1])
                for b, nu in enumerate(GENERAL_NUS)),
            "bands_of_7_launches": banded_launches,
            "bands_of_7_expected": -(-walk.pairs // 7),
            "bands_of_7_equal": bool(torch.equal(batch, banded)),
            "equal_to_single_calls": all(
                torch.equal(batch[b], cuda_kernels.matern_general_matmat(
                    P, rhos[b], Vb[b], nu))
                for b, nu in enumerate(GENERAL_NUS))})
    ok = ok and all(p["trace_rel_err"] < GENERAL_TRACE_RTOL
                    and p["rectangular_trace_rel_err"] < GENERAL_TRACE_RTOL
                    and max(p["frob_rel_err"].values()) < GENERAL_FROB_TOL
                    and p["rectangular_frob_rel_err"] < GENERAL_FROB_TOL
                    and p["same_bits_twice"] and p["trace_same_bits_twice"]
                    for p in products)
    ok = ok and all(b["launches"] == 1 and b["equal_to_single_calls"]
                    and b["trace_launches"] == 1
                    and b["traces_equal_to_single_calls"]
                    and b["bands_of_7_equal"]
                    and b["bands_of_7_launches"] == b["bands_of_7_expected"]
                    for b in batches)

    # the closed forms: the general kernel's own branch for them (the
    # grid's mixed nus reach it), and the closed-form kernels unchanged:
    # matern_matmat at those nus launches them, never the general kernel
    closed = {}
    P = torch.rand((2000, 2), generator=g, device=dev)
    V = torch.randn((2000, 7), generator=g, device=dev)
    for nu in (0.5, 1.5, 2.5, 150.0):
        k_err = float((cuda_kernels.matern_general(x, nu).double()
                       - kernels.matern(x.double(), nu)).abs().max())
        cuda_kernels.reset_launch_counts()
        got, fro = cuda_kernels.matern_matmat(P, RHO, V, nu, frobenius=True)
        counts = dict(cuda_kernels.launch_counts)
        want, fro_want = cuda_kernels.matern_matmat_plain(
            P.double(), kernels.broadcast_scale(RHO, 2, dtype=F64,
                                                device=dev),
            V.double(), nu, frobenius=True)
        closed[nu] = {"general_kernel_k_max_abs_err": k_err,
                      "matern_matmat_frob_rel_err": compare(got, want)[0],
                      "matern_matmat_trace_rel_err": rel_gap(
                          float(fro), float(fro_want)),
                      "launches": {k: v for k, v in counts.items() if v}}
        ok = (ok and k_err < 1e-6
              and closed[nu]["matern_matmat_frob_rel_err"] < FROB_TOL
              and closed[nu]["matern_matmat_trace_rel_err"] < TRACE_RTOL
              and counts["matern_matmat_mma"] == 1
              and counts["matern_matmat"] == 1
              and not any(counts[k] for k in GENERAL_COUNTERS))
    log(phase="general_parity", ok=ok, nus=list(GENERAL_NUS),
        k_atol=GENERAL_K_ATOL, frob_tol=GENERAL_FROB_TOL,
        trace_rtol=GENERAL_TRACE_RTOL, elementwise=elem, products=products,
        batches=batches, closed_forms=closed)
    if not ok:
        raise AssertionError("the general-nu kernel disagrees with float64")


def phase_general_dense_api(dev):
    """Phase 22: generate_correlation on the reference's 64 x 64 grid (rho
    0.1, noise 0.2, degree-2 basis, as phase 19) at nu = 1.2 and 3.7, then
    GaussianProcess(X, K).train(z) by both methods; the launch counts of
    the two calls in one window per nu. Then the elementwise entry timed
    at that shape (K of n = 4096: 16.8M distances) against its plain
    version and its bound."""
    pts = data_utils.generate_points(DENSE_SIDE, dimension=2)
    z, X = dense_problem(pts)
    P64 = torch.as_tensor(pts, dtype=F64, device=dev)
    fits, window = {}, {}
    ok = True
    for nu in (1.2, 3.7):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        K = gppe_tpu_torch.generate_correlation(pts, RHO, nu=nu, device=dev)
        assembly_s = sync_seconds(t0)
        rec = {}
        for method in ("direct", "profiled"):
            _, rec[method] = dense_fit(dev, K, X, z, method)
        window[nu] = {k: v for k, v in cuda_kernels.launch_counts.items()
                      if v}
        want = kernels.matern(
            kernels.pairwise_scaled_distance(P64, P64, RHO), nu)
        err = float((K.double() - want).abs().max())
        del want
        agree = rel_gap(rec["direct"]["eta"], rec["profiled"]["eta"])
        fits[nu] = {"assembly_s": assembly_s,
                    "assembly_max_abs_err_vs_f64": err,
                    "symmetry_max_abs": float((K - K.T).abs().max()),
                    "direct_vs_profiled_eta_rel_gap": agree, **rec}
        ok = (ok and K.dtype == F32 and err < GENERAL_K_ATOL
              and fits[nu]["symmetry_max_abs"] == 0.0
              and bool(torch.all(torch.diagonal(K) == 1.0))
              and all(f["success"] and f["finite"]
                      and 0.18 < f["sigma0"] < 0.22 for f in rec.values())
              and agree < 1e-3
              and window[nu].get("matern_general_elementwise", 0) > 0)
        del K

    # the elementwise entry at this shape: kernel, plain float32, bound
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    dist = kernels.pairwise_scaled_distance(P, P, RHO).contiguous()
    nu = 3.7
    got = cuda_kernels.matern_general(dist, nu)
    err = float((got.double() - kernels.matern(dist.double(), nu))
                .abs().max())
    med, times = median_in_turns({
        "kernel": lambda: cuda_kernels.matern_general(dist, nu),
        "plain": lambda: kernels.matern(dist, nu)}, reps=5)
    flat = dist.reshape(-1)
    sample = flat[torch.randint(0, flat.numel(), (TRIP_SAMPLE,),
                                device=dev)]
    bound_ms, bound_by, term, work = general_bound(
        "elementwise", None, None, None, nu, sample, elements=flat.numel())
    measured = {"max_abs_err": err, "ms": med["kernel"],
                "plain_ms": med["plain"], "bound_ms": bound_ms,
                "bound_by": bound_by}
    log(phase="general_dense_api", ok=ok, n=len(pts), rho=RHO, fits=fits,
        launches_per_nu=window, elementwise_nu=nu,
        elementwise_elements=flat.numel(), elementwise=measured,
        elementwise_bound_term=term, elementwise_work_per_k=work,
        kernel_ms_all=times["kernel"])
    if not ok:
        raise AssertionError(f"dense public API at general nu failed: "
                             f"{fits}")
    return window, measured


def phase_general_operator_route(dev):
    """Phase 23: MaternOperator at n = 10^4 random points, nu = 1.2,
    through KrylovProfileLikelihood.fit() (64 steps, 16 probes), in its
    own launch window, against the float64 eigh route on the same K
    assembled by the elementwise entry (GaussianProcess 'profiled'). Then
    the product timed at n = 10^4 and 10^5, r = 24, and the trace at
    both, each against its plain version (float32, row-blocked) where
    that runs in seconds, and its bound. At n = 10^5 the product's walk
    runs in bands (its slots for every tile pair would take 7.5 GB): its
    first and last 300 rows against float64, and the same bits in bands
    of a third the size; the trace against general_trace_f64 (the plain
    float64 trace would take minutes), whose table is held to float64 at
    n = 10^4 too."""
    pts, z, X = make_problem(GENERAL_N, 7)
    op = MaternOperator(pts, RHO, nu=GENERAL_NU, device=dev)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=GENERAL_STEPS,
                                  num_probes=GENERAL_PROBES, device=dev)
    setup_s = sync_seconds(t0)
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    window = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    del eng

    t0 = time.perf_counter()
    K = gppe_tpu_torch.generate_correlation(pts, RHO, nu=GENERAL_NU,
                                            device=dev)
    gp, exact = dense_fit(dev, K, X, z, "profiled")
    exact_s = time.perf_counter() - t0
    del gp, K
    gap = rel_gap(res["eta"], exact["eta"])
    ok = (res["success"] and exact["success"] and gap < 5e-2
          and window.get("matern_general_product", 0) > 0
          and window.get("matern_general_trace", 0) > 0
          and not any(window.get(k, 0) for k in CLOSED_FORM_COUNTERS))

    P = op.points
    g = torch.Generator(device=dev).manual_seed(23)
    times = {}
    V = torch.randn((GENERAL_N, 24), generator=g, device=dev)
    got = cuda_kernels.matern_general_matmat(P, op.scale, V, GENERAL_NU)
    want = cuda_kernels.matern_matmat_plain(P.double(), op.scale.double(),
                                            V.double(), GENERAL_NU)
    frob, max_abs = compare(got, want)
    del want
    med, all_ms = median_in_turns({
        "product": lambda: cuda_kernels.matern_general_matmat(
            P, op.scale, V, GENERAL_NU),
        "plain_product": lambda: cuda_kernels.matern_matmat_plain(
            P, op.scale, V, GENERAL_NU),
        "trace": lambda: cuda_kernels.matern_general_matmat(
            P, op.scale, None, GENERAL_NU, frobenius=True),
        "plain_trace": lambda: cuda_kernels.matern_matmat_plain(
            P, op.scale, None, GENERAL_NU, frobenius=True)}, reps=5)
    fro = cuda_kernels.matern_general_matmat(P, op.scale, None, GENERAL_NU,
                                             frobenius=True)[1]
    fro_want = cuda_kernels.matern_matmat_plain(
        P.double(), op.scale.double(), None, GENERAL_NU, frobenius=True)[1]
    trace_err = abs(float(fro) - float(fro_want))
    table_fro, table_err = general_trace_f64(P, float(RHO), GENERAL_NU)
    table_check = {"n1e4_table_vs_plain_f64_rel_gap": rel_gap(
        table_fro, float(fro_want)), "n1e4_table_max_abs_err": table_err}
    ok = (ok and frob < GENERAL_FROB_TOL
          and trace_err / float(fro_want) < GENERAL_TRACE_RTOL
          and table_err < TABLE_ATOL)
    sample = sample_pair_distances(P, float(RHO), seed=23)
    prod_bound = general_bound("product", GENERAL_N, 2, 24, GENERAL_NU,
                               sample)
    trace_bound = general_bound("trace", GENERAL_N, 2, 0, GENERAL_NU,
                                sample)
    # n = 10^5, r = 24: one launch each, median of 5 (the plain version
    # would take minutes: not measured)
    big = torch.rand((GENERAL_BIG_N, 2), generator=g, device=dev)
    Vb = torch.randn((GENERAL_BIG_N, 24), generator=g, device=dev)
    cuda_kernels.matern_general_matmat(big, RHO, Vb, GENERAL_NU)
    big_ms = timed(lambda: cuda_kernels.matern_general_matmat(
        big, RHO, Vb, GENERAL_NU), 5)
    big_bound = general_bound("product", GENERAL_BIG_N, 2, 24, GENERAL_NU,
                              sample_pair_distances(big, RHO, seed=24))
    big_out = cuda_kernels.matern_general_matmat(big, RHO, Vb, GENERAL_NU)
    big_walk = cuda_kernels.general_product_bands(GENERAL_BIG_N,
                                                  GENERAL_BIG_N, 24, 1, True)
    thirds = with_slot_budget(
        cuda_kernels.GENERAL_SLOT_BYTES // 3,
        lambda: cuda_kernels.matern_general_matmat(big, RHO, Vb, GENERAL_NU))
    rows = torch.cat([torch.arange(300, device=dev),
                      torch.arange(GENERAL_BIG_N - 300, GENERAL_BIG_N,
                                   device=dev)])
    big_frob = compare(big_out[rows], cuda_kernels.matern_matmat_plain(
        big[rows].double(), kernels.broadcast_scale(
            RHO, 2, dtype=F64, device=dev),
        Vb.double(), GENERAL_NU, points_cols=big.double()))[0]
    big_check = {"bands": big_walk.bands,
                 "slot_bytes": 4 * big_walk.slot_floats,
                 "rows_frob_rel_err": big_frob,
                 "same_bits_in_thirds": bool(torch.equal(big_out, thirds))}
    del thirds, big_out
    # the trace at n = 10^5: one launch, median of 5, against the table
    big_fro = cuda_kernels.matern_general_matmat(big, RHO, None, GENERAL_NU,
                                                 frobenius=True)[1]
    big_trace_ms = timed(lambda: cuda_kernels.matern_general_matmat(
        big, RHO, None, GENERAL_NU, frobenius=True), 5)
    big_trace_bound = general_bound("trace", GENERAL_BIG_N, 2, 0, GENERAL_NU,
                                    sample_pair_distances(big, RHO, seed=24))
    big_fro_want, big_table_err = general_trace_f64(big, RHO, GENERAL_NU)
    big_trace_rel = rel_gap(float(big_fro), big_fro_want)
    table_check.update(n1e5_table_max_abs_err=big_table_err,
                       n1e5_trace_rel_err=big_trace_rel,
                       n1e5_trace_same_bits_twice=float(big_fro) == float(
                           cuda_kernels.matern_general_matmat(
                               big, RHO, None, GENERAL_NU,
                               frobenius=True)[1]))
    ok = (ok and big_walk.bands > 1 and big_frob < GENERAL_FROB_TOL
          and big_check["same_bits_in_thirds"]
          and big_trace_rel < GENERAL_TRACE_RTOL
          and big_table_err < TABLE_ATOL
          and table_check["n1e5_trace_same_bits_twice"])
    times = {"product_n1e4_r24": {
                 "ms": med["product"], "plain_ms": med["plain_product"],
                 "bound_ms": prod_bound[0], "bound_term": prod_bound[2],
                 "frob_rel_err": frob, "max_abs_err": max_abs,
                 "ms_all": all_ms["product"]},
             "trace_n1e4": {
                 "ms": med["trace"], "plain_ms": med["plain_trace"],
                 "bound_ms": trace_bound[0], "bound_term": trace_bound[2],
                 "bound_share": trace_bound[0] / med["trace"],
                 "abs_err": trace_err, "ms_all": all_ms["trace"]},
             "trace_n1e5": {
                 "ms": statistics.median(big_trace_ms), "plain_ms": None,
                 "bound_ms": big_trace_bound[0],
                 "bound_term": big_trace_bound[2],
                 "bound_share": big_trace_bound[0]
                 / statistics.median(big_trace_ms),
                 "rel_err_vs_table_f64": big_trace_rel,
                 "ms_all": big_trace_ms},
             "product_n1e5_r24": {
                 "ms": statistics.median(big_ms), "plain_ms": None,
                 "bound_ms": big_bound[0], "bound_term": big_bound[2],
                 "ms_all": big_ms}}
    log(phase="general_operator_route", ok=ok, n=GENERAL_N, rho=RHO,
        nu=GENERAL_NU, lanczos_steps=GENERAL_STEPS,
        num_probes=GENERAL_PROBES, setup_seconds=setup_s, fit_seconds=fit_s,
        fit=res, launches=window, eigh_route=exact,
        eigh_route_seconds=exact_s, eta_rel_gap_to_eigh_route=gap,
        times=times, work_per_k=prod_bound[3],
        work_per_k_n1e5=big_bound[3], product_n1e5_check=big_check,
        trace_f64_table=table_check)
    if not ok:
        raise AssertionError(f"general-nu operator route failed: {res}, "
                             f"eigh route {exact}, launches {window}")
    return window, (
        {"max_abs_err": max_abs, "ms": med["product"],
         "plain_ms": med["plain_product"], "bound_ms": prod_bound[0],
         "bound_by": prod_bound[1]},
        {"max_abs_err": trace_err, "ms": med["trace"],
         "plain_ms": med["plain_trace"], "bound_ms": trace_bound[0],
         "bound_by": trace_bound[1],
         "bound_share": trace_bound[0] / med["trace"],
         "ms_n1e5": times["trace_n1e5"]["ms"],
         "bound_ms_n1e5": big_trace_bound[0],
         "rel_err_n1e5": big_trace_rel})


# phase 24's cuts: main_large at its own defaults; main at 30 x 30
# points, a 6 x 6 grid, DE with popsize 10 for at most 6 generations (the
# reference: a 61 x 60 grid, popsize 24, 40 generations)
LARGE_STEPS = 40   # main_large's Lanczos steps
MAIN_CUTS = {"num_points": 30, "grid_rho": 6, "grid_nu": 6, "popsize": 10,
             "max_generations": 6}
# main_large's grid points held to the float64 eigh route on the same K
# (its first and its last: the smallest rho and nu, and the MAP's corner),
# and main's grid points (row, column of its 6 x 6 grid) whose lp is held
# to the CPU's float64 build_objective: the card assembles K in float32
# (within 1e-6 of float64, phase 21), which moved lp by 1.4e-5 of its
# ~2170 in a float32 rounding of K on the CPU; 1e-5 relative is a hundred
# times that
LARGE_F64_POINTS = ((0, 0), (7, 7))
MAIN_F64_POINTS = ((0, 0), (2, 3), (5, 5))
MAIN_LP_RTOL = 1e-5


def phase_general_search(dev):
    """Phase 24: the (rho, nu) search, each call in its own launch window:
    the driver twin's main_large at its defaults (n = 10^4, 8 x 8 general
    nus, 40 steps, 8 probes: one batched product call a step for all 64
    points, a launch per band of its walk, one trace launch for all 64
    points), two
    of its grid points against the float64 eigh route on the same K (eta
    5e-2, the lp gap logged); then
    main at MAIN_CUTS (the elementwise entry for every lp), its lp at
    three grid points against the CPU's float64 build_objective."""
    cuda_kernels.reset_launch_counts()
    large = find_optimal_covariance.main_large(verbose=False, device=dev)
    large_window = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    # one chunk of the 64 points: one batched product call a step, a
    # launch per band (r = 16: z, 6 basis columns, the deflation vector
    # and 8 probes)
    large_bands = cuda_kernels.general_product_bands(
        large["n"], large["n"], 16, 64, True).bands
    # and the chunk's traces: one launch while its 64 points' partials fit
    # (cuda_kernels.general_trace_batches)
    large_trace_launches = -(-64 // cuda_kernels.general_trace_batches(
        large["n"], large["n"], 64, True)[2])
    ok = (bool(np.all(np.isfinite(large["Lp"])))
          and all(r["success"] for r in large["results"])
          and large["matrix_free"] and large["chunk"] == 64
          and large_window.get("matern_general_product", 0)
          == LARGE_STEPS * large_bands
          and large_trace_launches == 1
          and large_window.get("matern_general_trace", 0)
          == large_trace_launches
          and not any(large_window.get(k, 0) for k in CLOSED_FORM_COUNTERS))

    # two grid points against the float64 eigh route on the same K
    pts, z, X = find_optimal_covariance.large_problem()
    lp_f64 = find_optimal_covariance.build_objective(pts, z, X, False,
                                                     device=dev)[0]
    large_f64 = []
    for i, j in LARGE_F64_POINTS:
        rho, nu = float(large["rhos"][i]), float(large["nus"][j])
        krylov = large["results"][i * len(large["nus"]) + j]
        K = gppe_tpu_torch.generate_correlation(pts, rho, nu=nu, device=dev)
        _, exact = dense_fit(dev, K, X, z, "profiled")
        del K
        lp_exact = lp_f64(rho, nu)
        large_f64.append({
            "rho": rho, "nu": nu, "eta": krylov["eta"],
            "eigh_route_eta": exact["eta"],
            "eta_rel_gap": rel_gap(krylov["eta"], exact["eta"]),
            "lp": krylov["lp"], "eigh_lp": lp_exact,
            "lp_gap": krylov["lp"] - lp_exact})
    ok = ok and all(c["eta_rel_gap"] < 5e-2 for c in large_f64)

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    small = find_optimal_covariance.main(verbose=False, device=dev,
                                         **MAIN_CUTS)
    main_s = sync_seconds(t0)
    main_window = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    # main's lp against the CPU's float64 surface on its own points
    pts = data_utils.generate_points(MAIN_CUTS["num_points"], dimension=2)
    lp_cpu = find_optimal_covariance.build_objective(
        pts, data_utils.generate_data(pts, 0.05),
        data_utils.generate_basis_functions(pts, 2), False, device="cpu")[0]
    main_f64 = []
    for i, j in MAIN_F64_POINTS:
        rho, nu = float(small["rhos"][i]), float(small["nus"][j])
        want = lp_cpu(rho, nu)
        main_f64.append({"rho": rho, "nu": nu, "lp": float(small["Lp"][i, j]),
                         "cpu_f64_lp": want,
                         "lp_rel_gap": rel_gap(float(small["Lp"][i, j]),
                                               want)})
    ok = ok and all(c["lp_rel_gap"] < MAIN_LP_RTOL for c in main_f64)
    ok = (ok and bool(np.all(np.isfinite(small["Lp"])))
          and 0.1 <= small["de_rho"] <= 0.3
          and 1.0 <= small["de_nu"] <= 25.0 and np.isfinite(small["de_lp"])
          and main_window.get("matern_general_elementwise", 0) > 0
          and not any(main_window.get(k, 0) for k in CLOSED_FORM_COUNTERS))
    log(phase="general_search", ok=ok,
        main_large={"n": large["n"], "grid": [len(large["rhos"]),
                                              len(large["nus"])],
                    "lanczos_steps": LARGE_STEPS, "num_probes": 8,
                    "chunk": large["chunk"], "product_bands": large_bands,
                    "trace_launches": large_trace_launches,
                    "setup_seconds": large["setup_seconds"],
                    "fit_seconds": large["fit_seconds"],
                    "seconds_per_point": large["seconds_per_point"],
                    "map_rho": large["optimal_rho"],
                    "map_nu": large["optimal_nu"],
                    "max_lp": large["max_lp"],
                    "etas": [r["eta"] for r in large["results"]]},
        main_large_launches=large_window,
        main_large_vs_eigh_route=large_f64,
        main_cuts=MAIN_CUTS, main_seconds=main_s,
        main_lp_vs_cpu_f64=main_f64, main_lp_rtol=MAIN_LP_RTOL,
        main={k: small[k] for k in ("max_lp", "optimal_rho", "optimal_nu",
                                    "de_rho", "de_nu", "de_lp",
                                    "de_generations")},
        main_launches=main_window)
    if not ok:
        raise AssertionError(f"(rho, nu) search failed: main_large "
                             f"{large['Lp']}, main {small}")
    return large_window, main_window


# -- the rest of the tapered slice (phases 25-28) -----------------------------

G2_COUNTERS = ("matern_blocksparse_general_product",
               "matern_blocksparse_general_trace")
# phase 25's orders, and the scales that put the taper radius (density
# 0.02) 1.6 to 3 scales out, where a threshold clear of every pair by 1e-5
# exists (tests/test_torch_cuda.py)
G2_NUS = (0.3, 1.2, 3.7, 24.9)
G2_SCALES = {2: 0.05, 3: 0.05 * np.sqrt(1.5)}
TAPER_GENERAL_NU = 1.2
# phase 26: the scipy-sparse route at n = 2^18 (a 512 x 512 grid), and the
# general-nu CSR builder at n = 2^16
SPARSE_SIDE, GENERAL_CSR_SIDE = 512, 256
# phase 27: a grid of side 64 at rho 0.01 and density 0.004 has the taper
# radius of the n = 2^20 path in scaled units (3.6) and 16 neighbours a
# point, as phase 11's grid; there the CPU's plain general-nu tapered product
# takes ~6 s a step on the card's 8 host cores (tiles of 128 the fastest;
# 80 s for 12 steps), and the float64 fit has converged at 8 steps (its eta
# moved by 5e-9 from 12), so 8 steps and 8 probes keep the CPU side near a
# minute
SMALL_TAPER_SIDE, SMALL_TAPER_TILE = 64, 128
SMALL_TAPER_SCALE, SMALL_TAPER_DENSITY = 0.01, 0.004
SMALL_TAPER_STEPS, SMALL_TAPER_PROBES = 8, 8
# phase 28: the plain version runs ~1,500 PyTorch operations per row tile
# at a general nu (tens of seconds over the 2048 row tiles at n = 2^20),
# so it is
# timed, in turns with the kernel, on the pair list of the first
# PLAIN_ROW_TILES row tiles among themselves
PLAIN_ROW_TILES = 32


def without_skip(fn):
    """``fn()`` with the tapered general-nu kernels skipping no pair
    (cuda_kernels._blocksparse_skip2 at +inf)."""
    saved = cuda_kernels._blocksparse_skip2
    cuda_kernels._blocksparse_skip2 = lambda nu, tau: float("inf")
    try:
        return fn()
    finally:
        cuda_kernels._blocksparse_skip2 = saved


def g2_case(dev, n, d, tile, nu, seed):
    """G2 against plain float64 on one tapered problem: the product at
    r in {1, 7, 24} (one launch each) and the trace, at a threshold clear
    of every pair; the trace the same bits twice, and with and without the
    taper skip at that threshold and at the operator's."""
    pts = np.random.RandomState(seed).rand(n, d)
    op = TaperedMaternOperator(pts, G2_SCALES[d], nu=nu, density=0.02,
                               tile=tile, device=dev)
    tau = clear_threshold(op)
    args = (op.nu, tau, op.pair_i, op._pair_j, op.tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    g = torch.Generator(device=dev).manual_seed(seed)
    V = torch.zeros((op.n_pad, 24), device=dev)
    V[:n] = torch.randn((n, 24), generator=g, device=dev)
    want, fro_want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), V.double(), *args, frobenius=True, **kw)
    rec = {"n": n, "d": d, "tile": op.tile, "nu": nu,
           "pairs": len(op.pair_i), "tau_over_operator_threshold":
           tau / op.threshold, "frob_rel_err": {}, "launches": {}}
    ok = True
    for r in (1, 7, 24):
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, V[:, :r].contiguous(), *args, **kw)
        torch.cuda.synchronize()
        rec["launches"][r] = {k: v for k, v in
                              cuda_kernels.launch_counts.items() if v}
        rec["frob_rel_err"][r] = compare(got, want[:, :r])[0]
        ok = (ok and rec["launches"][r] == {G2_COUNTERS[0]: 1}
              and not bool(got[n:].any()) and bool(torch.isfinite(got).all())
              and rec["frob_rel_err"][r] < GENERAL_FROB_TOL)
    def trace(t=tau):
        return float(cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, None, op.nu, t, *args[2:], frobenius=True,
            trace_walk=op._trace_walk, **kw)[1])
    traces = [trace() for _ in range(2)]
    rec["trace_rel_err"] = rel_gap(traces[0], float(fro_want))
    rec["trace_same_bits_twice"] = traces[0] == traces[1]
    rec["trace_same_bits_without_skip"] = (
        traces[0] == without_skip(trace)
        and trace(op.threshold) == without_skip(lambda: trace(op.threshold)))
    ok = (ok and rec["trace_same_bits_twice"]
          and rec["trace_same_bits_without_skip"]
          and rec["trace_rel_err"] < GENERAL_TRACE_RTOL)
    return ok, rec


def phase_g2_parity(dev):
    """Phase 25: the tapered general-nu kernel (matern_blocksparse_general.cu)
    against plain float64 on the card, at n = 1000 and 4096 random 2-D
    points and n = 1000 3-D points, each nu of G2_NUS, at thresholds from
    blocksparse_clear_threshold: products (r 1, 7, 24) and traces within
    GENERAL_FROB_TOL and GENERAL_TRACE_RTOL, the trace the same bits twice
    and with and without the taper skip; then a closed-form nu through the
    same entry point launches B3 only."""
    cases, ok = [], True
    for n, d, tile in ((1000, 2, 128), (4096, 2, 512), (1000, 3, 128)):
        for nu in G2_NUS:
            case_ok, rec = g2_case(dev, n, d, tile, nu, seed=n + d)
            ok = ok and case_ok
            cases.append(rec)
    closed = {}
    for nu in (0.5, 1.5, 2.5, 150.0):
        op = TaperedMaternOperator(np.random.RandomState(25).rand(1000, 2),
                                   0.05, nu=nu, density=0.02, tile=128,
                                   device=dev)
        V = torch.zeros((op.n_pad, 7), device=dev)
        V[:1000] = 1.0
        cuda_kernels.reset_launch_counts()
        cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, V, op.nu, op.threshold, op.pair_i, op._pair_j,
            op.tile, n=1000, frobenius=True, row_ptr=op._row_ptr,
            trace_walk=op._trace_walk)
        torch.cuda.synchronize()
        closed[nu] = {k: v for k, v in cuda_kernels.launch_counts.items()
                      if v}
        ok = ok and closed[nu] == {"matern_matmat_blocksparse_mma": 1,
                                   "matern_matmat_blocksparse": 1}
    log(phase="g2_parity", ok=ok, frob_tol=GENERAL_FROB_TOL,
        trace_rtol=GENERAL_TRACE_RTOL, cases=cases,
        closed_form_launches=closed)
    if not ok:
        raise AssertionError("the tapered general-nu kernel disagrees with "
                             "float64")


def spmm_bound(nnz, n, r, value_bytes):
    """The byte bound (ms) of one CSR times dense product: each value and
    column index read once (int32 indices), the row pointers, V read once
    and the product written once, over the card's memory rate."""
    nbytes = nnz * (value_bytes + 4) + 4 * (n + 1) + 2 * value_bytes * n * r
    return nbytes / PEAK_BYTES_PER_S * 1e3, nbytes


def phase_sparse_route(dev):
    """Phase 26: the scipy-sparse public route at n = 2^18 (a 512 x 512
    grid, rho 0.005, density 1e-3, nu = 1/2, degree-2 basis, noise 0.2):
    generate_correlation(sparse=True) on the native builder, then
    GaussianProcess(X, Kcsr, 'profiled').train(z) (a float64 SparseOperator
    on the card, cuSPARSE's SpMM, KrylovProfileLikelihood.fit), against
    TaperedMaternOperator's fit on the same points and the same random
    block (eta 5e-2, sigma0 5e-3: phase 11's bounds). The SpMM timed at the
    route's width beside its byte bound, in float64 (the route's) and
    float32. Then the general-nu CSR builder at n = 2^16, nu = 1.2 (G1's
    elementwise entry on the card), its pattern against the native
    builder's at nu = 1/2: the same ball, so the two differ only by
    entries within 1e-5 (relative) of the threshold, counted."""
    pts, z, X = tapered_problem(SPARSE_SIDE)
    n = len(pts)
    t0 = time.perf_counter()
    Kcsr = gppe_tpu_torch.generate_correlation(
        pts, TAPER_SCALE, nu=NU, sparse=True, density=TAPER_DENSITY,
        device=dev)
    csr_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gp = gppe_tpu_torch.GaussianProcess(X, Kcsr, "profiled",
                                            lanczos_steps=STEPS,
                                            num_probes=PROBES, device=dev)
    construct_s = sync_seconds(t0)
    t0 = time.perf_counter()
    res = gp.train(z)
    train_s = sync_seconds(t0)
    window = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    op = gp.likelihood.K_mixed.K
    switched = (gp.likelihood.K_mixed.method == "slq"
                and any("switching to 'slq'" in str(w.message)
                        for w in caught))

    # the tapered operator on the same points and the route's random block
    # (the engine's own draw for key 0, in float64, rounded to float32)
    probes, v_defl = stochastic.random_block(n, PROBES, 0, dev, F64)
    top = TaperedMaternOperator(pts, TAPER_SCALE, nu=NU,
                                density=TAPER_DENSITY, device=dev)
    ref = KrylovProfileLikelihood(top, X, z, lanczos_steps=STEPS,
                                  num_probes=PROBES, device=dev,
                                  probes=probes, v_defl=v_defl).fit()
    del top
    eta_gap = rel_gap(res["eta"], ref["eta"])
    sigma0_gap = rel_gap(res["sigma0"], ref["sigma0"])
    ok = (res["success"] and ref["success"] and switched
          and isinstance(op, SparseOperator) and op.dtype == F64
          and all(np.isfinite(res[k]) for k in ("eta", "sigma", "sigma0"))
          and eta_gap < 5e-2 and sigma0_gap < 5e-3 and not window)

    # SpMM at the route's width: the Lanczos block [z, X, v_defl, probes]
    width = 1 + X.shape[1] + 1 + PROBES
    g = torch.Generator(device=dev).manual_seed(26)
    V64 = torch.randn((n, width), generator=g, device=dev, dtype=F64)
    op32 = SparseOperator(Kcsr, device=dev, dtype=F32)
    V32 = V64.float()
    spmm_err = compare(op32.matmat(V32), op.matmat(V64))[0]
    med, all_ms = median_in_turns({"float64": lambda: op.matmat(V64),
                                   "float32": lambda: op32.matmat(V32)})
    spmm = {}
    for key, bytes_ in (("float64", 8), ("float32", 4)):
        b_ms, nbytes = spmm_bound(op.nnz, n, width, bytes_)
        spmm[key] = {"ms": med[key], "bound_ms": b_ms, "bound_by": "bytes",
                     "bytes": nbytes, "bound_share": b_ms / med[key],
                     "ms_all": all_ms[key]}
    del op32, V32, V64

    # the general-nu CSR builder on the card at n = 2^16
    pts16 = data_utils.generate_points(GENERAL_CSR_SIDE, dimension=2)
    n16 = len(pts16)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    G = taper.generate_tapered_correlation(pts16, TAPER_SCALE,
                                           TAPER_GENERAL_NU, TAPER_DENSITY,
                                           device=dev)
    general_s = sync_seconds(t0)
    elementwise = cuda_kernels.launch_counts["matern_general_elementwise"]
    t0 = time.perf_counter()
    N = taper.generate_tapered_correlation(pts16, TAPER_SCALE, NU,
                                           TAPER_DENSITY, device=dev)
    native16_s = time.perf_counter() - t0
    # the per-dimension scale, as the builder takes it (the radius comes
    # from the scales' geometric mean)
    tau = taper.estimate_kernel_threshold(n16, 2, TAPER_DENSITY,
                                          [TAPER_SCALE] * 2, TAPER_GENERAL_NU)
    flipped = abs(G.sign() - N.sign()).tocoo()
    P = pts16 / TAPER_SCALE
    k64 = kernels.matern(torch.as_tensor(np.linalg.norm(
        P[flipped.row] - P[flipped.col], axis=1)), TAPER_GENERAL_NU).numpy()
    flipped_near_tau = int(np.sum(np.abs(k64 - tau) < 1e-5 * tau))
    general_near_tau = int(np.sum(np.abs(G.data - tau) < 1e-5 * tau))
    ok = (ok and elementwise > 0 and flipped_near_tau == flipped.nnz
          and bool(np.all(G.diagonal() == 1.0)))
    log(phase="sparse_route", ok=ok, n=n, scale=TAPER_SCALE, nu=NU,
        density=TAPER_DENSITY, lanczos_steps=STEPS, num_probes=PROBES,
        csr_builder="native", native_threads=native.num_threads(),
        csr_seconds_host=csr_s, nnz=int(Kcsr.nnz),
        csr_host_bytes=int(Kcsr.data.nbytes + Kcsr.indices.nbytes
                           + Kcsr.indptr.nbytes),
        constructor_seconds=construct_s, train_seconds=train_s,
        method=gp.likelihood.K_mixed.method, switched_to_slq=switched,
        operator_dtype=str(op.dtype), launches=window,
        peak_device_memory_bytes=peak,
        fit={k: res[k] for k in ("eta", "sigma", "sigma0", "success")},
        tapered_operator_fit={k: ref[k] for k in ("eta", "sigma", "sigma0",
                                                   "success")},
        eta_rel_gap=eta_gap, sigma0_rel_gap=sigma0_gap, spmm_width=width,
        spmm=spmm, spmm_float32_frob_vs_float64=spmm_err,
        general_csr={"n": n16, "nu": TAPER_GENERAL_NU, "seconds": general_s,
                     "elementwise_launches": elementwise, "nnz": int(G.nnz),
                     "tau": tau, "entries_near_tau":
                     general_near_tau},
        native_csr_nu_half={"n": n16, "seconds_host": native16_s,
                            "nnz": int(N.nnz)},
        pattern_entries_differing=int(flipped.nnz),
        differing_near_tau=flipped_near_tau)
    if not ok:
        raise AssertionError(f"the scipy-sparse route failed: {res}, "
                             f"tapered operator {ref}")
    return spmm


def phase_tapered_general_engine(dev):
    """Phase 27: TaperedMaternOperator at nu = 1.2 through
    KrylovProfileLikelihood on cuda (float32, G2) and on the CPU (float64,
    the plain version) from the same data and random block: a grid of side
    SMALL_TAPER_SIDE at SMALL_TAPER_SCALE and SMALL_TAPER_DENSITY; eta
    5e-2, sigma0 5e-3 (phase 11's bounds). Returns the CPU's float64 fit
    and the cuda side's launches."""
    pts, z, X = tapered_problem(SMALL_TAPER_SIDE)
    n = len(pts)
    probes, v_defl = random_block(n, SMALL_TAPER_PROBES, 27)
    fits, seconds, windows = {}, {}, {}
    for name, device, dtype in (("cuda_f32", dev, F32),
                                ("cpu_f64", "cpu", F64)):
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        op = TaperedMaternOperator(pts, SMALL_TAPER_SCALE,
                                   nu=TAPER_GENERAL_NU,
                                   density=SMALL_TAPER_DENSITY,
                                   tile=SMALL_TAPER_TILE, device=device,
                                   dtype=dtype)
        fits[name] = KrylovProfileLikelihood(
            op, X, z, lanczos_steps=SMALL_TAPER_STEPS,
            num_probes=SMALL_TAPER_PROBES, device=device, dtype=dtype,
            probes=probes, v_defl=v_defl).fit()
        seconds[name] = sync_seconds(t0)
        windows[name] = {k: v for k, v in cuda_kernels.launch_counts.items()
                         if v}
    a, b = fits["cuda_f32"], fits["cpu_f64"]
    eta_rel, sigma0_rel = rel_gap(a["eta"], b["eta"]), rel_gap(
        a["sigma0"], b["sigma0"])
    ok = (a["success"] and b["success"] and eta_rel < 5e-2
          and sigma0_rel < 5e-3 and not windows["cpu_f64"]
          and windows["cuda_f32"] == {G2_COUNTERS[0]: SMALL_TAPER_STEPS,
                                      G2_COUNTERS[1]: 1})
    log(phase="tapered_general_engine", ok=ok, n=n, nu=TAPER_GENERAL_NU,
        scale=SMALL_TAPER_SCALE, density=SMALL_TAPER_DENSITY,
        radius=op.radius, tile=SMALL_TAPER_TILE,
        lanczos_steps=SMALL_TAPER_STEPS, num_probes=SMALL_TAPER_PROBES,
        pairs=len(op.pair_i), cuda_f32=a, cpu_f64=b, seconds=seconds,
        cpu_threads=torch.get_num_threads(), launches=windows["cuda_f32"],
        eta_rel_err=eta_rel, sigma0_rel_err=sigma0_rel)
    if not ok:
        raise AssertionError("the tapered general-nu engine: cuda and cpu "
                             "fits disagree")
    return b, windows["cuda_f32"]


def tile_pair_distances(op, seed):
    """Scaled distances of TRIP_SAMPLE random point pairs of the
    operator's active tile pairs (each tile pair equally likely, then a
    real point of each of its tiles), as the kernels compute them: the
    pairs whose k the tapered kernels evaluate."""
    n, t = op.shape[0], op.tile
    g = torch.Generator(device=op.device).manual_seed(seed)
    p = torch.randint(0, len(op.pair_i), (TRIP_SAMPLE,), generator=g,
                      device=op.device)
    real = torch.as_tensor(np.minimum(t, n - t * np.arange(op.num_tiles)),
                           device=op.device)
    ti = torch.as_tensor(op.pair_i, device=op.device).long()[p]
    tj = op._pair_j.long()[p]
    u = torch.rand((2, TRIP_SAMPLE), generator=g, device=op.device)
    i = ti * t + (u[0] * real[ti]).long()
    j = tj * t + (u[1] * real[tj]).long()
    S = op.points_sorted
    return torch.sqrt(((S[i] - S[j]) ** 2).sum(dim=1))


def g2_bounds(op, r, d, x_sample):
    """bound() of the tapered general-nu product and trace over the
    operator's pair list: the least work for the same function. Every
    unordered pair of the active tiles pays its distance (3 d operations)
    and a compare with the taper radius; only the pairs within the radius
    (their share of ``x_sample``, this run's distances of the active tile
    pairs) pay a sqrt and, off the diagonal, one k (its work the mean over
    those pairs' trips); the product then 2 r FMA operations on each kept
    ordered pair, the trace one FMA on each kept unordered pair. Returns
    (product (ms, by, term), trace (ms, by, term), work, kept share)."""
    n = op.shape[0]
    pairs, half = tile_pairs(op), tile_pairs(op, symmetric=True)
    x = x_sample[x_sample > 0]
    inside = x[x <= op.radius]
    share = inside.numel() / max(x.numel(), 1)
    kept_off = (half - n) * share       # kept unordered pairs, i != j
    work = general_k_work(inside, op.nu)
    geometry = 4 * (op.num_tiles + 1 + len(op.pair_j))
    k_ops = half * (3 * d + 1) + kept_off * work["fp32"]
    mufu = kept_off * (1 + work["mufu"])
    product = bound(4 * (op.n_pad * d + 2 * op.n_pad * r) + geometry,
                    k_ops + (n + 2 * kept_off) * 2 * r, mufu_ops=mufu)
    trace = bound(4 * op.n_pad * d + 8 + geometry,
                  k_ops + 2 * (n + kept_off), mufu_ops=mufu)
    return product, trace, work, share


def sub_list(op, row_tiles):
    """The operator's pair list restricted to its first ``row_tiles``
    tiles among themselves: a tapered problem of its own over the same
    sorted points, with the attributes of the operator that tile_pairs,
    tile_pair_distances and g2_bounds read, and its row_ptr and walk."""
    t = op.tile
    keep = (op.pair_i < row_tiles) & (op.pair_j < row_tiles)
    pi, pj = op.pair_i[keep], op.pair_j[keep]
    n = row_tiles * t
    walk = cuda_kernels.blocksparse_trace_schedule_for(op.nu)(pi, pj, t, n)
    return types.SimpleNamespace(
        shape=(n, n), n_pad=n, tile=t, num_tiles=row_tiles, nu=op.nu,
        radius=op.radius,
        device=op.device, points_sorted=op.points_sorted[:n], pair_i=pi,
        pair_j=pj, _pair_j=torch.as_tensor(pj, device=op.device),
        row_ptr=torch.as_tensor(cuda_kernels.blocksparse_row_ptr(
            pi, row_tiles), device=op.device),
        walk=walk._replace(units=torch.as_tensor(walk.units,
                                                 device=op.device)))


def phase_tapered_general_path(dev, small_fit):
    """Phase 28: the tapered path at full size at nu = 1.2 (phase 12's
    configuration: n = 2^20 grid points, rho 0.005, density 1e-3, 64 steps,
    16 probes): exactly 64 launches of G2's product and one of its trace,
    no closed-form launch; the fit finite, sigma0 within 10% of the
    injected 0.2, a band phase 27's float64 fit must lie in too. Then G2's
    product at r = 24 and its trace timed over the full list against their
    bounds, and on the first PLAIN_ROW_TILES row tiles' list in turns with
    the plain version, against that list's bounds: the kernel records'
    numbers are the sub-list's, where the plain version runs. The trace
    the same bits with and without the taper skip on both lists."""
    pts, z, X = tapered_problem(TAPER_SIDE)
    n = pts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    op = TaperedMaternOperator(pts, TAPER_SCALE, nu=TAPER_GENERAL_NU,
                               density=TAPER_DENSITY, device=dev)
    geometry_s = sync_seconds(t0)
    t0 = time.perf_counter()
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=STEPS,
                                  num_probes=PROBES, device=dev)
    setup_s = sync_seconds(t0)
    launches = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    del eng
    band = (0.18, 0.22)
    ok = (res["success"]
          and all(np.isfinite(res[k]) for k in ("eta", "sigma0", "sigma"))
          and band[0] < res["sigma0"] < band[1]
          and band[0] < small_fit["sigma0"] < band[1]
          and launches == {G2_COUNTERS[0]: STEPS, G2_COUNTERS[1]: 1})

    # G2 over the full list: r = 24 and the trace, against their bounds
    r, d = 24, 2
    g = torch.Generator(device=dev).manual_seed(28)
    V = torch.randn((op.n_pad, r), generator=g, device=dev)
    V[n:] = 0
    args = (op.nu, op.threshold, op.pair_i, op._pair_j, op.tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    def full_trace():
        return cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, None, *args, frobenius=True,
            trace_walk=op._trace_walk, **kw)[1]
    full = {"product": timed(lambda: cuda_kernels.matern_matmat_blocksparse(
                op.points_sorted, V, *args, **kw), 5),
            "trace": timed(full_trace, 5)}
    skip_bits = {"full_list": float(full_trace())
                 == float(without_skip(full_trace))}
    product_bound, trace_bound, work, kept = g2_bounds(
        op, r, d, tile_pair_distances(op, seed=28))

    # kernel and plain in turns on the first row tiles' list, its bounds,
    # and the kernel's error against float64 there at a threshold clear of
    # every pair: the kernel records' shape
    sub = sub_list(op, PLAIN_ROW_TILES)
    pts_s, pi, pj, n_s = sub.points_sorted, sub.pair_i, sub._pair_j, sub.n_pad
    Vs = V[:n_s].contiguous()
    sargs = (op.nu, op.threshold, pi, pj, op.tile)
    skw = dict(n=n_s, row_ptr=sub.row_ptr)
    med, all_ms = median_in_turns({
        "product": lambda: cuda_kernels.matern_matmat_blocksparse(
            pts_s, Vs, *sargs, **skw),
        "plain_product": lambda: cuda_kernels.matern_matmat_blocksparse_plain(
            pts_s, Vs, *sargs, **skw),
        "trace": lambda: cuda_kernels.matern_matmat_blocksparse(
            pts_s, None, *sargs, frobenius=True, trace_walk=sub.walk, **skw),
        "plain_trace": lambda: cuda_kernels.matern_matmat_blocksparse_plain(
            pts_s, None, *sargs, frobenius=True, **skw)}, reps=3)
    sub_product_bound, sub_trace_bound, sub_work, sub_kept = g2_bounds(
        sub, r, d, tile_pair_distances(sub, seed=28))
    tau = cuda_kernels.blocksparse_clear_threshold(
        pts_s.double(), op.nu, op.threshold, pi, pj, op.tile, n=n_s,
        row_ptr=sub.row_ptr)
    cargs = (op.nu, tau, pi, pj, op.tile)
    got, fro = cuda_kernels.matern_matmat_blocksparse(
        pts_s, Vs, *cargs, frobenius=True, trace_walk=sub.walk, **skw)
    want, fro_want = cuda_kernels.matern_matmat_blocksparse_plain(
        pts_s.double(), Vs.double(), *cargs, frobenius=True, **skw)
    frob, max_abs = compare(got, want)
    trace_err = abs(float(fro) - float(fro_want))

    def sub_trace():
        return cuda_kernels.matern_matmat_blocksparse(
            pts_s, None, *sargs, frobenius=True, trace_walk=sub.walk,
            **skw)[1]
    skip_bits["sub_list"] = float(sub_trace()) == float(
        without_skip(sub_trace))
    ok = (ok and frob < GENERAL_FROB_TOL
          and trace_err / float(fro_want) < GENERAL_TRACE_RTOL
          and all(skip_bits.values()))
    sub_shape = (f"the pair list of row tiles 0-{PLAIN_ROW_TILES - 1} "
                 f"among themselves ({len(pi)} of {len(op.pair_i)} tile "
                 f"pairs, n = {n_s})")
    full_shape = (f"the full pair list ({len(op.pair_i)} tile pairs, "
                  f"n = {n}); the plain version not run there")
    times = {"full_list": {
                 "shape": full_shape,
                 "product_r24": {
                     "ms": statistics.median(full["product"]),
                     "plain_ms": None, "bound_ms": product_bound[0],
                     "bound_by": product_bound[1],
                     "bound_term": product_bound[2],
                     "ms_all": full["product"]},
                 "trace": {
                     "ms": statistics.median(full["trace"]),
                     "plain_ms": None, "bound_ms": trace_bound[0],
                     "bound_by": trace_bound[1],
                     "bound_term": trace_bound[2], "ms_all": full["trace"]}},
             "sub_list": {
                 "shape": sub_shape,
                 "product_r24": {
                     "ms": med["product"], "plain_ms": med["plain_product"],
                     "bound_ms": sub_product_bound[0],
                     "bound_by": sub_product_bound[1],
                     "bound_term": sub_product_bound[2],
                     "ms_all": all_ms["product"],
                     "plain_ms_all": all_ms["plain_product"]},
                 "trace": {
                     "ms": med["trace"], "plain_ms": med["plain_trace"],
                     "bound_ms": sub_trace_bound[0],
                     "bound_by": sub_trace_bound[1],
                     "bound_term": sub_trace_bound[2],
                     "ms_all": all_ms["trace"],
                     "plain_ms_all": all_ms["plain_trace"]}}}
    log(phase="tapered_general_path", ok=ok, n=n, scale=TAPER_SCALE,
        nu=TAPER_GENERAL_NU, density=TAPER_DENSITY, tile=op.tile,
        lanczos_steps=STEPS, num_probes=PROBES,
        active_tile_pairs=len(op.pair_i), threshold=op.threshold,
        sort_and_pair_geometry_seconds=geometry_s, setup_seconds=setup_s,
        fit_seconds_host_numpy=fit_s, eta_star=res["eta"],
        sigma0=res["sigma0"], sigma=res["sigma"], success=res["success"],
        sigma0_band=band, phase27_cpu_f64_sigma0=small_fit["sigma0"],
        launches=launches, peak_device_memory_bytes=peak,
        pairs_ordered=tile_pairs(op),
        pairs_unordered=tile_pairs(op, symmetric=True), times=times,
        work_per_k=work, sub_list_work_per_k=sub_work,
        kept_share_of_pairs=kept, sub_list_kept_share_of_pairs=sub_kept,
        skip_radius=cuda_kernels.blocksparse_skip_radius(op.nu,
                                                         op.threshold),
        taper_radius=op.radius,
        sub_list_pairs_ordered=tile_pairs(sub),
        sub_list_tau_over_threshold=tau / op.threshold,
        sub_list_frob_rel_err=frob, sub_list_max_abs_err=max_abs,
        sub_list_trace_abs_err=trace_err,
        trace_same_bits_without_skip=skip_bits,
        trace_units_full_list=len(op._trace_walk.units),
        trace_units_sub_list=len(sub.walk.units))
    if not ok:
        raise AssertionError(f"tapered general-nu path failed: {res}, "
                             f"{launches}")
    # the records' numbers all at the sub-list's shape, where the plain
    # version runs; the full list's times and bounds beside them
    full_t = times["full_list"]
    return launches, (
        {"max_abs_err": max_abs, "ms": med["product"],
         "plain_ms": med["plain_product"], "bound_ms": sub_product_bound[0],
         "bound_by": sub_product_bound[1], "shape": sub_shape,
         "ms_full_list": full_t["product_r24"]["ms"],
         "bound_ms_full_list": product_bound[0], "full_list_shape": full_shape},
        {"max_abs_err": trace_err, "ms": med["trace"],
         "plain_ms": med["plain_trace"], "bound_ms": sub_trace_bound[0],
         "bound_by": sub_trace_bound[1],
         "bound_share": sub_trace_bound[0] / med["trace"],
         "shape": sub_shape, "ms_full_list": full_t["trace"]["ms"],
         "bound_ms_full_list": trace_bound[0],
         "bound_share_full_list": trace_bound[0] / full_t["trace"]["ms"],
         "full_list_shape": full_shape})


def kernel_record(name, source, replaces, launches, measured,
                  launches_public_api=None, launches_per_path=None):
    """``launches``: the kernel's count on its path's run (phase 5, 10, 12,
    15, 16 or 17), or for the general-nu kernel the sum over the paths of
    ``launches_per_path`` (phases 22-24, each path's count from its own
    window); ``launches_public_api``, for B1: its count in phase 20's two
    windows, the public API's operator-route fit and its
    likelihood(z, hp)."""
    # library_ms: no single PyTorch call computes any of these products,
    # because K is never stored (40 GB at n = 10^5)
    rec = {"name": name, "route": "cuda",
           "source": f"gppe_tpu_torch/csrc/{source}",
           "replaces": replaces, "launches": launches, **measured,
           "library_ms": None}
    if launches_public_api is not None:
        rec["launches_public_api"] = launches_public_api
    if launches_per_path is not None:
        rec["launches_per_path"] = launches_per_path
    return rec


PALLAS = "gppe_tpu/ops/pallas_kernels.py"


def main():
    dev = phase_device()
    phase_build()
    phase_parity(dev)
    phase_engine_1024(dev)
    launches_1, main_fit = phase_main_path(dev)
    measured_1, measured_trace = phase_kernel_time(dev)
    phase_parity_multirho(dev)
    phase_parity_blocksparse(dev)
    phase_grid_engine_1024(dev)
    launches_2, grid_fits, grid_setup_s = phase_grid_path(dev)
    phase_tapered_engine_16384(dev)
    launches_3, op, taper_fit, taper_setup_s = phase_tapered_path(dev)
    measured_2, measured_2_trace = phase_multirho_time(dev)
    measured_3, measured_3_trace = phase_blocksparse_time(dev, op)
    phase_parity_modes(dev)
    phase_engines_bf16x3(dev)
    launches_default = phase_paths_bf16x3(dev, grid_fits, op, taper_fit,
                                          (grid_setup_s, taper_setup_s))
    launches_mma = phase_precision_matrix(dev)
    launches_gram = phase_roofline(dev)
    measured = phase_mode_time(dev, op)
    phase_dense_api(dev)
    launches_fit, launches_lp, launches_api = phase_public_operator_route(
        dev, main_fit)
    phase_general_parity(dev)
    launches_22, measured_elem = phase_general_dense_api(dev)
    launches_23, (measured_prod, measured_gtrace) = \
        phase_general_operator_route(dev)
    launches_large, launches_main = phase_general_search(dev)
    phase_g2_parity(dev)
    phase_sparse_route(dev)
    small_fit, launches_27 = phase_tapered_general_engine(dev)
    launches_28, (measured_g2, measured_g2_trace) = \
        phase_tapered_general_path(dev, small_fit)
    # each path's window, reset just before it; the entries each launches
    windows = {**{f"dense_api_nu{nu}": w for nu, w in launches_22.items()},
               "operator_route": launches_23, "main_large": launches_large,
               "main": launches_main}
    expected = {"matern_general_elementwise": ("dense_api_nu1.2",
                                               "dense_api_nu3.7", "main"),
                "matern_general_product": ("operator_route", "main_large"),
                "matern_general_trace": ("operator_route", "main_large")}
    per_path = {k: {path: w.get(k, 0) for path, w in windows.items()}
                for k in GENERAL_COUNTERS}
    missing = [(k, path) for k, paths in expected.items() for path in paths
               if per_path[k][path] == 0]
    if missing:
        raise AssertionError(f"a general-nu kernel was never launched on a "
                             f"path that runs it: {missing}, {per_path}")

    def g2_record(entry, replaces, measured):
        counter = f"matern_blocksparse_general_{entry}"
        return kernel_record(
            f"matern_blocksparse_general[{entry}]",
            "matern_blocksparse_general.cu", replaces, launches_28[counter],
            measured, launches_per_path={
                "tapered_general_engine_4096": launches_27[counter],
                "tapered_general_path_2e20": launches_28[counter]})

    def general_record(entry, replaces, measured):
        counts = per_path[f"matern_general_{entry}"]
        rec = kernel_record(f"matern_general[{entry}]", "matern_general.cu",
                            replaces, sum(counts.values()), measured,
                            launches_per_path=counts)
        if entry == "product":
            # each counted launch is the tile kernel and its band's sum
            # kernel (matern_general_product_sum_kernel); ms covers both
            rec["sum_launches"] = rec["launches"]
        return rec
    if not all((launches_1["matern_matmat_mma"], launches_1["matern_matmat"],
                *(w.get(k, 0) for w in (launches_fit, launches_lp)
                  for k in ("matern_matmat_mma", "matern_matmat")),
                launches_2["matern_matmat_multirho_mma"],
                launches_2["matern_matmat_multirho"],
                launches_3["matern_matmat_blocksparse_mma"],
                launches_3["matern_matmat_blocksparse"],
                launches_mma["bf16x3"], launches_mma["bf16"], launches_gram,
                launches_default["matern_matmat_multirho_mma"],
                launches_default["matern_matmat_blocksparse_mma"])):
        raise AssertionError("a kernel of a path was never launched on it")
    print(nvidia_smi())
    print(json.dumps({"kernels": [
        # the main path: every product on the tensor-core kernel ('highest'
        # as 3xTF32), trace(K^2) on the FP32 kernel
        kernel_record("matern_matmat_mma[highest]", "matern_matmat_mma.cu",
                      f"{PALLAS}:103", launches_1["matern_matmat_mma"],
                      measured_1, launches_api["matern_matmat_mma"]),
        kernel_record("matern_matmat", "matern_matmat.cu",
                      "gppe_tpu/ops/operators.py:42",
                      launches_1["matern_matmat"], measured_trace,
                      launches_api["matern_matmat"]),
        # the grid and the tapered path, the same split: products on the
        # tensor-core kernels, traces on the FP32 ones
        kernel_record("matern_matmat_multirho_mma[highest]",
                      "matern_multirho_mma.cu", f"{PALLAS}:356",
                      launches_2["matern_matmat_multirho_mma"], measured_2),
        kernel_record("matern_matmat_multirho", "matern_multirho.cu",
                      f"{PALLAS}:356", launches_2["matern_matmat_multirho"],
                      measured_2_trace),
        kernel_record("matern_matmat_blocksparse_mma[highest]",
                      "matern_blocksparse_mma.cu", f"{PALLAS}:487",
                      launches_3["matern_matmat_blocksparse_mma"],
                      measured_3),
        kernel_record("matern_matmat_blocksparse", "matern_blocksparse.cu",
                      "gppe_tpu/ops/taper.py:303",
                      launches_3["matern_matmat_blocksparse"],
                      measured_3_trace),
        # the tile-dot modes (pallas_kernels._tile_dot, :64) and the Gram
        # form (_matmat_kernel_gram, :128), each on the path that runs it
        kernel_record("matern_matmat_mma[bf16x3]", "matern_matmat_mma.cu",
                      f"{PALLAS}:64", launches_mma["bf16x3"],
                      measured["bf16x3"]),
        kernel_record("matern_matmat_mma[bf16]", "matern_matmat_mma.cu",
                      f"{PALLAS}:64", launches_mma["bf16"], measured["bf16"]),
        kernel_record("matern_matmat_mma[gram]", "matern_matmat_mma.cu",
                      f"{PALLAS}:128", launches_gram, measured["gram"]),
        kernel_record("matern_matmat_multirho_mma[bf16x3]",
                      "matern_multirho_mma.cu", f"{PALLAS}:64",
                      launches_default["matern_matmat_multirho_mma"],
                      measured["multirho_bf16x3"]),
        kernel_record("matern_matmat_blocksparse_mma[bf16x3]",
                      "matern_blocksparse_mma.cu", f"{PALLAS}:64",
                      launches_default["matern_matmat_blocksparse_mma"],
                      measured["blocksparse_bf16x3"]),
        # general nu: no Pallas kernel; XLA-fused on the TPU at these sites
        general_record("elementwise", "gppe_tpu/ops/assembly.py:22",
                       measured_elem),
        general_record("product", "gppe_tpu/ops/operators.py:22; "
                       "gppe_tpu/models/grid_krylov.py:128-141",
                       measured_prod),
        general_record("trace", "gppe_tpu/ops/operators.py:42; "
                       "gppe_tpu/models/grid_krylov.py:128-141",
                       measured_gtrace),
        # the tapered path at a general nu: no Pallas kernel; the XLA scans
        # of TaperedMaternOperator on the TPU
        g2_record("product", "gppe_tpu/ops/taper.py:273", measured_g2),
        g2_record("trace", "gppe_tpu/ops/taper.py:303",
                  measured_g2_trace)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
