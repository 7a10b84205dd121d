#!/usr/bin/env python3
"""Where the time goes in gppe_tpu_torch's setups, on one NVIDIA GPU.

    python3 chip_profile.py ptxas           # registers and spills per kernel
    python3 chip_profile.py main grid taper # torch.profiler, one setup each
    python3 chip_profile.py --dot-mode bf16x3 grid taper
    python3 chip_profile.py modes           # kernel ms under each dot mode
    python3 chip_profile.py eta             # eta* under other products
    python3 chip_profile.py variants DIR... # matern_matmat per kernel variant

``ptxas`` compiles the kernel sources once more with ``-Xptxas -v`` and
prints, per template instance, the registers, spills and shared memory the
compiler reports.

``main``, ``grid`` and ``taper`` each build one engine of chip_smoke.py's
full-size paths twice - a warm-up, then one construction under
``torch.profiler`` - and print one JSON line: the host window, the device
time by kernel name, and the device's idle share of the window (one minus
the union of the kernel intervals over the window). ``--dot-mode`` makes
that tile-dot mode the module default for the profiled setups.

``modes`` times the three products through their public wrappers at the
paths' shapes (matern_matmat n = 100,000, r = 24; matern_matmat_multirho
B = 8, r = 16; matern_matmat_blocksparse n = 2^20, r = 24) under every
tile-dot mode, 'highest' included, and each wrapper's trace-only call, in
turns, median of 7. It uses nothing but the wrappers, so the same file run
from a checkout of another commit times that commit's kernels: two commits
in one call on one card is the comparison that counts.

``eta`` fits the main path's engine (chip_smoke.py phase 5) with its
products computed other ways, the trace(K^2) launch kept: the kernel in
each dot mode, the plain float32 version, the float64 product rounded once
to float32, and the 'highest' kernel's product times (1 + eps N(0, 1)) for
a few eps and seeds, or times 1 -+ 1e-6. It measures how far eta* moves
under changes of the products at float32 level, random or coherent.

``variants`` takes directories that each hold a copy of the package
(``DIR/gppe_tpu_torch``) with one change to its kernel sources, builds
their libraries in parallel, and times matern_matmat at n = 100,000,
r = 24 under every tile-dot mode with each library in turns, in this one
process, with each library's error against plain float64: how the design
choices of ``matern_matmat_mma.cu`` were made.

Exits non-zero without a CUDA device.
"""

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

F32 = torch.float32

import chip_smoke as cs
from gppe_tpu_torch.models.grid_krylov import GridKrylovProfileLikelihood
from gppe_tpu_torch.models.large_scale import KrylovProfileLikelihood
from gppe_tpu_torch.ops import _build, cuda_kernels, kernels
from gppe_tpu_torch.ops.operators import MaternOperator
from gppe_tpu_torch.ops.taper import TaperedMaternOperator


def ptxas_report():
    nvcc = _build.find_nvcc()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        compiles, _ = _build.nvcc_commands(nvcc, Path(tmp) / "lib.so",
                                           ("-Xptxas", "-v"))
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        texts = [p.communicate()[0] for p in procs]
    for text in texts:
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                # _Z..<name>I<template arguments>EEv... -> name<a, b, ...>
                mm = re.search(r"\d+([a-z_]+_kernel)I((?:L[ib]\d+E)+)E",
                               m.group(1))
                entry = ({"kernel": m.group(1), "args": []} if mm is None
                         else {"kernel": mm.group(1), "args": [
                             int(a) for a in re.findall(r"L[ib](\d+)E",
                                                        mm.group(2))]})
                rows.append(entry)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and entry is not None:
                entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                entry["registers"] = int(m.group(1))
                s = re.search(r"(\d+) bytes smem", line)
                entry["smem_bytes"] = int(s.group(1)) if s else 0
    print(json.dumps({"phase": "ptxas", "instances": len(rows),
                      "spilling": [r for r in rows if r.get("spill_bytes")],
                      "max_registers": max(r["registers"] for r in rows)}))
    for r in rows:
        print(json.dumps(r))


def profile_setup(name, build):
    """``build()`` constructs the engine; profile its second run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    build()                                             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build()
    torch.cuda.synchronize()
    plain_window_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        key = re.sub(r"<.*", "", e.name)[:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + ms)
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy_us, end = 0.0, None
    for a, b in spans:                                  # union of intervals
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "phase": f"profile_{name}", "nvidia_smi": cs.nvidia_smi(),
        "dot_mode": cuda_kernels.DEFAULT_DOT_MODE,
        "window_ms_profiled": window_ms,
        "window_ms_unprofiled": plain_window_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_of_profiled_window": 1.0 - busy_ms / window_ms,
        "kernels": [{"name": k, "calls": n, "ms": t} for k, (n, t) in top],
        "other_kernels_ms": sum(t for _, t in by_name.values())
        - sum(t for _, (_, t) in top)}), flush=True)


def mode_times(dev):
    """Median ms of each product at its path's shape under each dot mode."""
    pts, _, _ = cs.make_problem(cs.N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    V = torch.randn((cs.N_MAIN, 24), generator=g, device=dev)
    B = len(cs.GRID_RHOS)
    rhos = torch.as_tensor(cs.GRID_RHOS, dtype=torch.float32, device=dev)
    VB = torch.randn((B, cs.N_MAIN, 16), generator=g, device=dev)
    tpts, _, _ = cs.tapered_problem(cs.TAPER_SIDE)
    op = TaperedMaternOperator(tpts, cs.TAPER_SCALE, nu=cs.NU,
                               density=cs.TAPER_DENSITY, device=dev)
    VT = torch.randn((op.n_pad, 24), generator=g, device=dev)
    VT[op.shape[0]:] = 0
    fns = {}
    for mode in cuda_kernels.DOT_MODES:
        fns[f"matern_matmat[{mode}]"] = lambda mode=mode: \
            cuda_kernels.matern_matmat(P, cs.RHO, V, cs.NU, dot_mode=mode)
        fns[f"matern_matmat_multirho[{mode}]"] = lambda mode=mode: \
            cuda_kernels.matern_matmat_multirho(P, rhos, VB, cs.NU,
                                                dot_mode=mode)
        fns[f"matern_matmat_blocksparse[{mode}]"] = lambda mode=mode: \
            cuda_kernels.matern_matmat_blocksparse(
                op.points_sorted, VT, op.nu, op.threshold, op.pair_i,
                op._pair_j, op.tile, n=op.shape[0], row_ptr=op._row_ptr,
                dot_mode=mode)
    # the trace-only calls: the exact kernels in every mode
    fns["matern_matmat[trace]"] = lambda: cuda_kernels.matern_matmat(
        P, cs.RHO, None, cs.NU, frobenius=True)
    fns["matern_matmat_multirho[trace]"] = lambda: \
        cuda_kernels.matern_matmat_multirho(P, rhos, None, cs.NU,
                                            return_frobenius=True)
    fns["matern_matmat_blocksparse[trace]"] = lambda: \
        cuda_kernels.matern_matmat_blocksparse(
            op.points_sorted, None, op.nu, op.threshold, op.pair_i,
            op._pair_j, op.tile, n=op.shape[0], row_ptr=op._row_ptr,
            frobenius=True)
    med, times = cs.median_in_turns(fns)
    print(json.dumps({"phase": "mode_times", "nvidia_smi": cs.nvidia_smi(),
                      "n": cs.N_MAIN, "n_tapered": op.shape[0], "reps": 7,
                      "ms_median": med, "ms_all": times}), flush=True)


def eta_sensitivity(dev):
    """eta* of the main path under other products (see the docstring)."""
    pts, z, X = cs.make_problem(cs.N_MAIN, 7)
    op = MaternOperator(pts, cs.RHO, nu=cs.NU, device=dev)
    kernel = cuda_kernels.matern_matmat

    def fit(product=None, mode="highest"):
        def wrapper(points, scale, V, nu, **kw):
            if V is None or product is None:        # the trace, or a mode
                return kernel(points, scale, V, nu, **kw)
            return product(points, scale, V, nu, **kw)

        cuda_kernels.matern_matmat = wrapper
        previous = cuda_kernels.DEFAULT_DOT_MODE
        cuda_kernels.DEFAULT_DOT_MODE = mode
        try:
            return KrylovProfileLikelihood(
                op, X, z, lanczos_steps=cs.STEPS, num_probes=cs.PROBES,
                device=dev).fit()["eta"]
        finally:
            cuda_kernels.matern_matmat = kernel
            cuda_kernels.DEFAULT_DOT_MODE = previous

    def plain(dtype):
        def product(points, scale, V, nu, **kw):
            s = kernels.broadcast_scale(scale, points.shape[1], dtype=dtype,
                                        device=points.device)
            return cuda_kernels.matern_matmat_plain(
                points.to(dtype), s, V.to(dtype), nu).float()
        return product

    def scaled(factor):
        def product(points, scale, V, nu, **kw):
            return kernel(points, scale, V, nu, **kw) * factor
        return product

    def noisy(eps, seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def product(points, scale, V, nu, **kw):
            out = kernel(points, scale, V, nu, **kw)
            return out * (1.0 + eps * torch.randn(out.shape, generator=g,
                                                  device=dev))
        return product

    ref = fit(plain(torch.float64))
    etas = {"float64_product": ref, "plain_float32": fit(plain(F32))}
    for mode in cuda_kernels.DOT_MODES:
        etas[f"kernel[{mode}]"] = fit(mode=mode)
    for eps in (3e-7, 1e-6, 3e-6):
        for seed in range(3):
            etas[f"kernel[highest]*(1+{eps:g}N)#{seed}"] = fit(
                noisy(eps, seed))
    for factor in (1.0 - 1e-6, 1.0 + 1e-6):
        etas[f"kernel[highest]*{factor:.6f}"] = fit(scaled(factor))
    print(json.dumps({"phase": "eta_sensitivity",
                      "nvidia_smi": cs.nvidia_smi(), "n": cs.N_MAIN,
                      "eta_star": etas, "rel_gap_to_float64_product": {
                          k: abs(v - ref) / ref for k, v in etas.items()}}),
          flush=True)


def variant_times(dev, dirs):
    """Median ms and errors of matern_matmat under each dot mode with the
    kernel library of each package copy in ``dirs``."""
    load = ("from gppe_tpu_torch.ops import _build; _build.load(); "
            "print(_build.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", load], cwd=d,
                              stdout=subprocess.PIPE, text=True)
             for d in dirs]
    libs = {d: _build.load(Path(p.communicate()[0].split()[-1]))
            for d, p in zip(dirs, procs)}
    pts, _, _ = cs.make_problem(cs.N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    V = torch.randn((cs.N_MAIN, 24), generator=g, device=dev)
    scale = torch.tensor([cs.RHO, cs.RHO], device=dev)
    want = cuda_kernels.matern_matmat_plain(P.double(), scale.double(),
                                            V.double(), cs.NU)

    def product(d, mode):
        _build._lib = libs[d]       # the wrappers launch this library's
        return cuda_kernels.matern_matmat(P, scale, V, cs.NU, dot_mode=mode)

    fns = {f"{d}[{m}]": (lambda d=d, m=m: product(d, m))
           for d in dirs for m in cuda_kernels.DOT_MODES}
    errors = {k: cs.compare(f(), want) for k, f in fns.items()}
    med, times = cs.median_in_turns(fns)
    _build._lib = None
    print(json.dumps({"phase": "variant_times", "nvidia_smi": cs.nvidia_smi(),
                      "n": cs.N_MAIN, "r": 24, "reps": 7, "ms_median": med,
                      "frob_and_max_abs_vs_f64": errors, "ms_all": times}),
          flush=True)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: needs an NVIDIA GPU")
    dev = cs.phase_device()
    if "--dot-mode" in argv:
        cuda_kernels.DEFAULT_DOT_MODE = cuda_kernels.resolve_dot_mode(
            argv[argv.index("--dot-mode") + 1])
    if "ptxas" in argv:
        ptxas_report()
    if "modes" in argv:
        mode_times(dev)
    if "eta" in argv:
        eta_sensitivity(dev)
    if "variants" in argv:
        variant_times(dev, argv[argv.index("variants") + 1:])
    if "main" in argv:
        pts, z, X = cs.make_problem(cs.N_MAIN, 7)
        op = MaternOperator(pts, cs.RHO, nu=cs.NU, device=dev)
        profile_setup("main", lambda: KrylovProfileLikelihood(
            op, X, z, lanczos_steps=cs.STEPS, num_probes=cs.PROBES,
            device=dev))
    if "grid" in argv:
        pts, z, X = cs.make_problem(cs.N_MAIN, 7)
        B = len(cs.GRID_RHOS)
        profile_setup("grid", lambda: GridKrylovProfileLikelihood(
            pts, X, z, cs.GRID_RHOS, np.full(B, cs.NU), nu_static=cs.NU,
            lanczos_steps=cs.GRID_STEPS, num_probes=cs.GRID_PROBES,
            matrix_free=True, chunk=B, device=dev))
    if "taper" in argv:
        pts, z, X = cs.tapered_problem(cs.TAPER_SIDE)
        op = TaperedMaternOperator(pts, cs.TAPER_SCALE, nu=cs.NU,
                                   density=cs.TAPER_DENSITY, device=dev)
        profile_setup("taper", lambda: KrylovProfileLikelihood(
            op, X, z, lanczos_steps=cs.STEPS, num_probes=cs.PROBES,
            device=dev))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
