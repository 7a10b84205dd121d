#!/usr/bin/env python3
"""Where the time goes in gppe_tpu_torch's setups, on one NVIDIA GPU.

    python3 chip_profile.py ptxas           # registers and spills per kernel
    python3 chip_profile.py main grid taper # torch.profiler, one setup each
    python3 chip_profile.py search          # the (rho, nu) search's setup
    python3 chip_profile.py --dot-mode bf16x3 grid taper
    python3 chip_profile.py modes           # kernel ms under each dot mode
    python3 chip_profile.py --parent DIR modes eta  # beside another commit
    python3 chip_profile.py --parent DIR traces     # the three traces
    python3 chip_profile.py --parent DIR --float64 eta  # and float64 products
    python3 chip_profile.py --parent DIR sass       # kernels compiled alike
    python3 chip_profile.py sass-mix        # the dense traces' machine code
    python3 chip_profile.py eta             # eta* of every path
    python3 chip_profile.py eta-main        # main eta* under other products
    python3 chip_profile.py --kernel K variants DIR...  # per kernel variant
    python3 chip_profile.py --parent DIR general-levers  # G1, G2 by lever
    python3 chip_profile.py --parent DIR general-traces  # their traces

``ptxas`` compiles the kernel sources once more with ``-Xptxas -v`` and
prints, per template instance, the registers, spills and shared memory the
compiler reports.

``main``, ``grid``, ``taper`` and ``search`` (the grid engine of
``find_optimal_covariance.main_large``: n = 10^4, 8 x 8 general nus) each
build one engine of chip_smoke.py's full-size paths twice - a warm-up,
then one construction under ``torch.profiler`` - and print one JSON line:
the host window, the device time by kernel name, and the device's idle
share of the window (one minus the union of the kernel intervals over the
window). ``--dot-mode`` makes that tile-dot mode the module default for
the profiled setups.

``--parent DIR`` loads a second copy of the package, ``DIR/gppe_tpu_torch``
(the parent commit, unpacked under the git-ignored ``build/``), beside this
one, under another name, with its own kernel library (built into
``DIR/build`` in parallel with this one's). ``modes`` and ``eta`` then run
each measurement through both packages' public entry points, in turns in
this one process: two commits on one card in one call is the comparison
that counts.

``modes`` times the three products through their public wrappers at the
paths' shapes (matern_matmat n = 100,000, r = 24; matern_matmat_multirho
B = 8, r = 16; matern_matmat_blocksparse n = 2^20, r = 24) under every
tile-dot mode, 'highest' included, and each wrapper's trace-only call, in
turns, median of 8; with ``--parent`` each call of the change next to the
same call of the parent, and the largest absolute difference of each
output from the parent's.

``traces`` times the three trace(K^2) kernels through their public entry
points at the paths' shapes (matern_matmat's at n = 100,000;
matern_matmat_multirho's at n = 100,000 over the grid path's 8 rhos; the
tapered one through each package's own TaperedMaternOperator.trace_pow(2)
at n = 2^20), median of 8, with ``--parent`` each call next to the same
call of the parent's, in turns, and prints each package's results and the
largest relative difference of the change's from the parent's; then this
package's traces with the partials capped at fewer blocks.

``eta`` fits the main path (chip_smoke.py phase 5), the grid path (phase
10: each grid point) and the tapered path (phase 12) under the module
default mode and prints every eta*, sigma0 and the setup seconds; with
``--parent`` the same fits through the parent's package beside them, from
the same data and random blocks; with ``--float64`` also the grid path
with its products computed in float64 (the plain version, rounded once to
float32; the traces from the kernel), the yardstick both are held to.

``sass`` (with ``--parent``) compiles every kernel source of this package
and of the parent's copy to machine code (``nvcc -cubin``, ``cuobjdump
-sass``) and prints, per source, how many of this package's kernel
functions have a twin in the parent's, instruction for instruction (branch
targets and kernel-parameter offsets aside), and the names of those that
have none: which instances a change left as they were, whatever their
names now.

``sass-mix`` compiles the two dense trace sources to machine code and
prints, for their instances at nu = 1/2, d = 2, the instructions, the MUFU
operations and the opcode counts: the static mix that the issue rate
works through. It prints, for each piece of the general-nu device function
(``csrc/matern_bessel.cuh``: the entry, each branch's setup, step and
finish, the recurrence's start and step, the end), its FP32 and MUFU
operations (``general_piece_ops``), from which chip_smoke.py's bound of
the general-nu kernel adds up each pair's work over the trips it takes.
It then compiles a polynomial exp2 on the FP32 pipe (a Cody-Waite
reduction and a degree-5 Chebyshev interpolant of 2^f on [-1/2, 1/2], its
error over [-126, 0] printed from a float32 emulation on the host) and
prints its FP32 operations per call as chip_smoke.py's bound counts them:
EMULATED_MUFU_FP32_OPS, the price of taking one MUFU operation off the
SFU.

``eta-main`` fits the main path's engine with its products computed other
ways, the trace(K^2) launch kept: the kernel in each dot mode, the plain
float32 version, the float64 product rounded once to float32, and the
'highest' kernel's product times (1 + eps N(0, 1)) for a few eps and
seeds, or times 1 -+ 1e-6. It measures how far eta* moves under changes of
the products at float32 level, random or coherent.

``variants`` takes directories that each hold a copy of the package
(``DIR/gppe_tpu_torch``) with one change to its kernel sources, builds
their libraries in parallel, and times one wrapper (``--kernel``, before
``variants``: matmat, the default, at n = 100,000, r = 24; multirho at
B = 8, r = 16; or blocksparse at n = 2^20, r = 24) under every tile-dot
mode, or one trace (matmat_trace at n = 100,000; multirho_trace over the
grid path's 8 rhos; blocksparse_trace over the tapered path's walk at
n = 2^20), with each library in turns, in this one
process, with each library's error against plain float64 (multirho: the
largest over the rhos): how the design choices of the kernels were made.

``general-levers`` times the general-nu products lever by lever, in
turns, median of 8 (H100 name and power limit printed beside): G1's
product at n = 10^4, rho 0.1, nu = 1.2, r = 24 and 16 as the parent had it
(with ``--parent``), on the binned k tiles alone (the rectangular walk:
every tile pair, columns given as distinct points), and with the symmetric
walk; ``main_large``'s step (its points and 64 (rho, nu) points, r = 16)
as 64 single calls of the parent and of this package, and as one batched
call (its walk in 13 bands), beside the batched call's bound: the sum over
the 64 points of chip_smoke.general_bound, each point from its own sample
of distances and so its own trips; G1
at nu = 1/2 through the same kernel (k a closed form: the walk, binning
and products alone, the binning's overhead per pair); G2's product over the
full list at n = 2^20, r = 24, nu = 1.2 of the parent, of this package
without the skip (every pair of an active tile pair binned and evaluated)
and with it; each of those of this package's products with the bin counts
of GENERAL_BIN_VARIANTS; and G1's product at r = 16 with its parts taken
away one by one (GENERAL_PART_VARIANTS: the products, the evaluation, the
scatter, the classify pass's match and atomics), which times each part.
Each variant is a copy of this package whose kernel sources carry its
text substitutions, built by the copy's own ``_build`` as ``variants``
builds its copies. Then one batched call under ``torch.profiler``: the
tile kernel's and the band sums' device times, and the bands' scratch.
Last the general-nu traces (``general-traces`` runs them alone), each
through the parent's package too with ``--parent``, in turns, median of 8,
beside its bound and with its value's relative gap to the parent's: G1's
trace at n = 10^4, rho 0.1, nu = 1.2 (the operator route's); the 64
traces of ``main_large``'s chunk as 64 single calls (the parent's, this
package's) and as one batched launch, beside the sum of their bounds; G2's
trace over the full list at n = 2^20, nu = 1.2 (the parent's on its own
walk of 128 x 128 units), this package's with and without the skip; G1's
and G2's traces with the evaluation of k taken away
(GENERAL_TRACE_PART_VARIANTS: the rest of a trace's time; those results
are wrong); then the batched launch under ``torch.profiler``.

Exits non-zero without a CUDA device.
"""

import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

F32 = torch.float32

import chip_smoke as cs

# turns per comparison: even, so that with the order reversed every other
# turn (chip_smoke.median_in_turns) each package and library runs first in
# half of them
REPS = 8
from gppe_tpu_torch.drivers import find_optimal_covariance
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


def sass_functions(path):
    """{function name: its instructions} of a ``cuobjdump -sass`` listing,
    with branch targets and kernel-parameter offsets masked."""
    out, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                name = m.group(1)
                out[name] = []
                continue
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
            if m and name is not None:
                ins = re.sub(r"((?:BRA|BSSY|CALL)\S*\s+(?:\S+\s+)?)0x[0-9a-f]+",
                             r"\1T", m.group(1))
                out[name].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]",
                                        "c[0x0][P]", ins))
    return out


def sass_twins(root):
    """Per kernel source: this package's kernel functions with and without
    an instruction-for-instruction twin in the copy at ``root``."""
    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    trees = {"change": _build.CSRC_DIR,
             "parent": Path(root).resolve() / "gppe_tpu_torch" / "csrc"}
    with tempfile.TemporaryDirectory() as tmp:
        # a source new in this tree has no parent to compile: all of its
        # kernel functions are without a twin
        jobs = {(tree, src): Path(tmp) / f"{tree}_{Path(src).stem}.cubin"
                for tree in trees for src in _build.SOURCES
                if (trees[tree] / src).is_file()}
        procs = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(out),
             str(trees[tree] / src)]) for (tree, src), out in jobs.items()]
        if any(p.wait() for p in procs):
            raise RuntimeError("a kernel source did not compile")
        for out in jobs.values():
            with open(out.with_suffix(".sass"), "w") as f:
                subprocess.run([cuobjdump, "-sass", str(out)], stdout=f,
                               check=True)
        for src in _build.SOURCES:
            change, parent = (sass_functions(
                jobs[(tree, src)].with_suffix(".sass"))
                if (tree, src) in jobs else {}
                for tree in ("change", "parent"))
            bodies = {tuple(b) for b in parent.values()}
            alone = [k for k, b in change.items() if tuple(b) not in bodies]
            print(json.dumps({"phase": "sass", "source": src,
                              "functions": len(change),
                              "parent_functions": len(parent),
                              "with_twin": len(change) - len(alone),
                              "without_twin": alone}), flush=True)


def sass_mix():
    """The machine code of the dense trace kernels' instances at nu = 1/2,
    d = 2 (the paths'): instructions and MUFU operations, and the opcode
    counts. A static count of the code, unrolled loop and all, so its
    instructions per MUFU estimate the issue cost of one k."""
    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("matern_matmat.cu", "matern_multirho.cu"):
            cubin = Path(tmp) / f"{Path(src).stem}.cubin"
            subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o",
                            str(cubin), str(_build.CSRC_DIR / src)],
                           check=True)
            with open(cubin.with_suffix(".sass"), "w") as f:
                subprocess.run([cuobjdump, "-sass", str(cubin)], stdout=f,
                               check=True)
            for name, body in sass_functions(
                    cubin.with_suffix(".sass")).items():
                if "ILi0ELi2E" not in name:
                    continue
                ops = Counter(ins.split()[1] if ins.startswith("@")
                              else ins.split()[0] for ins in body)
                mufu = sum(v for k, v in ops.items()
                           if k.startswith("MUFU"))
                print(json.dumps({
                    "phase": "sass_mix", "source": src, "function": name,
                    "instructions": len(body), "mufu": mufu,
                    "instructions_per_mufu": len(body) / max(mufu, 1),
                    "opcodes": dict(ops.most_common(24))}), flush=True)
        emulated_exp2_ops(nvcc, cuobjdump, tmp)
    for piece, ops in general_piece_ops().items():
        print(json.dumps({"phase": "sass_mix", "source": "matern_bessel.cuh",
                          "piece": piece, **ops}), flush=True)


# One kernel per piece of csrc/matern_bessel.cuh's matern_general, each
# running the piece once on loaded values: general_piece_ops counts their
# machine code. end_large is bessel_end's path below z = 80 with no 2^e2
# factor, which every pair with a correlation above ~1e-30 takes.
GENERAL_PROBES = r"""
#include "matern_bessel.cuh"
using namespace gppe;
#define IN(k) in[threadIdx.x + 32 * (k)]
#define OUT(k, v) out[threadIdx.x + 32 * (k)] = (v)
#define PROBE(name) extern "C" __global__ void name( \
    const float* in, float* out, const MaternGeneralConsts c)
PROBE(entry) {
  const float z = fmaxf(c.sqrt2nu * IN(0), 1e-30f);
  const float lz = logf(z);
  OUT(0, z); OUT(1, lz); OUT(2, expf(c.mu * lz));
}
PROBE(temme_setup) {
  const TemmeState t = bessel_temme_setup(IN(0), IN(1), c);
  OUT(0, t.ff); OUT(1, t.p); OUT(2, t.q); OUT(3, t.cc); OUT(4, t.s);
  OUT(5, t.s1); OUT(6, t.dd);
}
PROBE(temme_step) {
  TemmeState t{IN(0), IN(1), IN(2), IN(3), IN(4), IN(5), IN(6)};
  const bool done = bessel_temme_step(threadIdx.x & 15, t, c);
  OUT(0, t.ff); OUT(1, t.p); OUT(2, t.q); OUT(3, t.cc); OUT(4, t.s);
  OUT(5, t.s1); OUT(6, done ? 1.0f : 0.0f);
}
PROBE(temme_finish) {
  const TemmeState t{IN(0), IN(1), IN(2), IN(3), IN(4), IN(5), IN(6)};
  float a, b;
  bessel_temme_finish(t, IN(7), a, b);
  OUT(0, a); OUT(1, b);
}
PROBE(cf2_setup) {
  const Cf2State t = bessel_cf2_setup(IN(0), c);
  OUT(0, t.b); OUT(1, t.d); OUT(2, t.h); OUT(3, t.delh); OUT(4, t.q1);
  OUT(5, t.q2); OUT(6, t.q); OUT(7, t.cc); OUT(8, t.s);
}
PROBE(cf2_step) {
  Cf2State t{IN(0), IN(1), IN(2), IN(3), IN(4), IN(5), IN(6), IN(7), IN(8)};
  const bool done = bessel_cf2_step(threadIdx.x & 15, t, c);
  OUT(0, t.b); OUT(1, t.d); OUT(2, t.h); OUT(3, t.delh); OUT(4, t.q1);
  OUT(5, t.q2); OUT(6, t.q); OUT(7, t.cc); OUT(8, t.s);
  OUT(9, done ? 1.0f : 0.0f);
}
PROBE(cf2_finish) {
  const Cf2State t{IN(0), IN(1), IN(2), IN(3), IN(4), IN(5), IN(6), IN(7),
                   IN(8)};
  float a, b;
  bessel_cf2_finish(t, IN(9), c, a, b);
  OUT(0, a); OUT(1, b);
}
PROBE(rec_start) {
  float f, fp;
  bessel_rec_start(IN(0), IN(1), IN(2), IN(3), c, f, fp);
  OUT(0, f); OUT(1, fp);
}
PROBE(rec_step) {
  float f = IN(0), fp = IN(1);
  int e2 = 0;
  bessel_rec_step(2 + (threadIdx.x & 15), IN(2), c, f, fp, e2);
  OUT(0, f); OUT(1, fp); OUT(2, static_cast<float>(e2));
}
PROBE(end_small) { OUT(0, bessel_end(IN(0), IN(1), 0, true)); }
PROBE(end_large) { OUT(0, fminf(IN(0) * expf(-IN(1)), 1.0f)); }
"""


def general_piece_ops():
    """{piece: {"fp32": operations, "mufu": MUFU operations,
    "instructions": n}} of each piece of the general-nu device function
    (csrc/matern_bessel.cuh), from the machine code of GENERAL_PROBES as
    this checkout's flags compile it: FFMA counted 2, FADD and FMUL 1,
    integer, comparison and min/max work not at all (the count of
    chip_smoke.bound()), over the piece's main path - the instructions
    before the first EXIT, so the out-of-line slow paths of the IEEE
    division and sqrt are left out, while both sides of a piece's inline
    branches are in. A probe's own loads and stores are not FP32 work."""
    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "general_probes.cu"
        src.write_text(GENERAL_PROBES)
        cubin = src.with_suffix(".cubin")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC_DIR), "-cubin", "-o", str(cubin),
                        str(src)], check=True)
        with open(cubin.with_suffix(".sass"), "w") as f:
            subprocess.run([cuobjdump, "-sass", str(cubin)], stdout=f,
                           check=True)
        bodies = sass_functions(cubin.with_suffix(".sass"))
    out = {}
    for name, body in bodies.items():
        main_path = []
        for ins in body:
            main_path.append(ins)
            if ins.split()[0] == "EXIT":
                break
        ops = Counter((ins.split()[1] if ins.startswith("@")
                       else ins.split()[0]).split(".")[0]
                      for ins in main_path)
        out[name] = {"fp32": 2 * ops["FFMA"] + ops["FADD"] + ops["FMUL"],
                     "mufu": ops["MUFU"], "instructions": len(main_path)}
    return out


EXP2_DEGREE = 5
EXP2_SOURCE = r"""
__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: round x to j in t's bits
  const float f = x - (t - 12582912.f);  // in [-1/2, 1/2]
  float p = %s;
%s
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
extern "C" __global__ void exp2_poly_kernel(const float* x, float* y,
                                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = exp2_poly(x[i]);
}
"""


def exp2_coefficients():
    """float32 power-series coefficients of the degree-5 Chebyshev
    interpolant of 2^f on [-1/2, 1/2], lowest first."""
    from numpy.polynomial import chebyshev, polynomial
    cheb = chebyshev.Chebyshev.interpolate(np.exp2, EXP2_DEGREE,
                                           domain=[-0.5, 0.5])
    return cheb.convert(kind=polynomial.Polynomial, domain=[-0.5, 0.5],
                        window=[-0.5, 0.5]).coef.astype(np.float32)


def exp2_poly_error(coef):
    """Largest relative error of the polynomial exp2 over [-126, 0] in
    float32 on the host (separate multiply and add: no better than the
    card's FFMA)."""
    x = np.linspace(-126, 0, 2_000_001, dtype=np.float32)
    magic = np.float32(12582912.0)
    t = x + magic
    f = x - (t - magic)
    p = np.full_like(f, coef[-1])
    for c in coef[-2::-1]:
        p = p * f + c
    y = (p.view(np.int32) + (t.view(np.int32) << 23)).view(np.float32)
    ref = np.exp2(x.astype(np.float64))
    return float(np.max(np.abs(y - ref) / ref))


def emulated_exp2_ops(nvcc, cuobjdump, tmp):
    """FP32 operations of one polynomial exp2 in its machine code: FFMA
    as 2, FADD and FMUL as 1 (chip_smoke.bound()'s count); the integer
    and min/max work is left out, so the count is a floor."""
    coef = exp2_coefficients()
    horner = "\n".join(f"  p = fmaf(p, f, {float(c)!r}f);"
                        for c in coef[-2::-1])
    src = Path(tmp) / "exp2_poly.cu"
    src.write_text(EXP2_SOURCE % (f"{float(coef[-1])!r}f", horner))
    cubin = src.with_suffix(".cubin")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(cubin),
                    str(src)], check=True)
    with open(cubin.with_suffix(".sass"), "w") as f:
        subprocess.run([cuobjdump, "-sass", str(cubin)], stdout=f,
                       check=True)
    (body,) = sass_functions(cubin.with_suffix(".sass")).values()
    ops = Counter((ins.split()[1] if ins.startswith("@")
                   else ins.split()[0]).split(".")[0] for ins in body)
    fp32_ops = 2 * ops["FFMA"] + ops["FADD"] + ops["FMUL"]
    print(json.dumps({
        "phase": "sass_mix", "function": "exp2_poly",
        "degree": EXP2_DEGREE, "coefficients": [float(c) for c in coef],
        "max_rel_err_host_float32": exp2_poly_error(coef),
        "emulated_mufu_fp32_ops": fp32_ops,
        "mufu": sum(v for k, v in ops.items() if k == "MUFU"),
        "chip_smoke_value": cs.EMULATED_MUFU_FP32_OPS,
        "opcodes": dict(ops.most_common())}), flush=True)
    return fp32_ops


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


def load_package(root):
    """``root/gppe_tpu_torch`` imported beside this package as
    ``gppe_tpu_torch_<n>``, with a kernel library of its own (its
    ``_build`` builds into ``root/build``)."""
    name = f"gppe_tpu_torch_{len(PACKAGES)}"
    pkg = Path(root).resolve() / "gppe_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    PACKAGES[name] = root
    return name


PACKAGES = {}


def build_libraries(roots):
    """Build the kernel libraries of this package and of the package
    copies under ``roots``, all at once: one process per copy."""
    load = "from gppe_tpu_torch.ops import _build; _build.load()"
    procs = [subprocess.Popen([sys.executable, "-c", load], cwd=root)
             for root in roots]
    _build.load()
    for proc in procs:
        if proc.wait() != 0:
            raise RuntimeError("a package copy's kernels did not build")


def packages(argv):
    """{label: (cuda_kernels, package name)} of this package ('change')
    and, with ``--parent DIR``, the parent's copy ('parent')."""
    out = {"change": (cuda_kernels, "gppe_tpu_torch")}
    if "--parent" in argv:
        root = argv[argv.index("--parent") + 1]
        build_libraries([root])
        name = load_package(root)
        out["parent"] = (importlib.import_module(f"{name}.ops.cuda_kernels"),
                         name)
    return out


def tapered_operators(dev, pkgs, pts):
    """{label: the tapered path's operator built by that package}: each
    package's trace_pow(2) then runs its own trace walk."""
    out = {}
    for label, (_, name) in pkgs.items():
        taper = importlib.import_module(f"{name}.ops.taper")
        out[label] = taper.TaperedMaternOperator(
            pts, cs.TAPER_SCALE, nu=cs.NU, density=cs.TAPER_DENSITY,
            device=dev)
    return out


def mode_times(dev, pkgs):
    """Median ms of each product at its path's shape under each dot mode,
    and of each trace-only call, for each package in ``pkgs``, in turns;
    each output's largest absolute difference from the parent's."""
    pts, _, _ = cs.make_problem(cs.N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    V = torch.randn((cs.N_MAIN, 24), generator=g, device=dev)
    B = len(cs.GRID_RHOS)
    rhos = torch.as_tensor(cs.GRID_RHOS, dtype=torch.float32, device=dev)
    VB = torch.randn((B, cs.N_MAIN, 16), generator=g, device=dev)
    tpts, _, _ = cs.tapered_problem(cs.TAPER_SIDE)
    ops = tapered_operators(dev, pkgs, tpts)
    op = ops["change"]
    VT = torch.randn((op.n_pad, 24), generator=g, device=dev)
    VT[op.shape[0]:] = 0
    geometry = (op.points_sorted, op.nu, op.threshold, op.pair_i,
                op._pair_j, op.tile)
    kw = dict(n=op.shape[0], row_ptr=op._row_ptr)
    per_package = {}
    for label, (ck, _) in pkgs.items():
        fns = per_package[label] = {}
        for mode in ck.DOT_MODES:
            fns[f"{label}:matern_matmat[{mode}]"] = \
                lambda ck=ck, mode=mode: ck.matern_matmat(
                    P, cs.RHO, V, cs.NU, dot_mode=mode)
            fns[f"{label}:matern_matmat_multirho[{mode}]"] = \
                lambda ck=ck, mode=mode: ck.matern_matmat_multirho(
                    P, rhos, VB, cs.NU, dot_mode=mode)
            fns[f"{label}:matern_matmat_blocksparse[{mode}]"] = \
                lambda ck=ck, mode=mode: ck.matern_matmat_blocksparse(
                    geometry[0], VT, *geometry[1:], dot_mode=mode, **kw)
        # the trace-only calls: the FP32 kernels in every mode
        fns[f"{label}:matern_matmat[trace]"] = lambda ck=ck: \
            ck.matern_matmat(P, cs.RHO, None, cs.NU, frobenius=True)[1]
        fns[f"{label}:matern_matmat_multirho[trace]"] = lambda ck=ck: \
            ck.matern_matmat_multirho(P, rhos, None, cs.NU,
                                      return_frobenius=True)[1]
        fns[f"{label}:matern_matmat_blocksparse[trace]"] = \
            lambda top=ops[label]: top.trace_pow(2)
    # each kernel's turns side by side, the packages in turns within them
    fns = {k: f for group in zip(*(d.items() for d in per_package.values()))
           for k, f in group}
    diff = {}
    if "parent" in pkgs:
        for key, f in fns.items():
            if key.startswith("change:"):
                other = fns["parent:" + key.split(":", 1)[1]]
                diff[key.split(":", 1)[1]] = float(torch.max(torch.abs(
                    f().double() - other().double())))
    med, times = cs.median_in_turns(fns, REPS)
    print(json.dumps({"phase": "mode_times", "nvidia_smi": cs.nvidia_smi(),
                      "n": cs.N_MAIN, "n_tapered": op.shape[0], "reps": REPS,
                      "packages": {k: v[1] for k, v in pkgs.items()},
                      "ms_median": med,
                      "max_abs_diff_change_vs_parent": diff,
                      "ms_all": times}), flush=True)


def trace_times(dev, pkgs):
    """Median ms and results of the three trace kernels at the paths'
    shapes for each package in ``pkgs``, in turns; the change's largest
    relative difference from the parent's."""
    pts, _, _ = cs.make_problem(cs.N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    rhos = torch.as_tensor(cs.GRID_RHOS, dtype=F32, device=dev)
    tpts, _, _ = cs.tapered_problem(cs.TAPER_SIDE)
    ops = tapered_operators(dev, pkgs, tpts)
    fns = {}
    for label, (ck, _) in pkgs.items():
        fns[f"{label}:matern_matmat[trace]"] = lambda ck=ck: \
            ck.matern_matmat(P, cs.RHO, None, cs.NU, frobenius=True)[1]
        fns[f"{label}:matern_matmat_multirho[trace]"] = lambda ck=ck: \
            ck.matern_matmat_multirho(P, rhos, None, cs.NU,
                                      return_frobenius=True)[1]
        fns[f"{label}:matern_matmat_blocksparse[trace]"] = \
            lambda top=ops[label]: top.trace_pow(2)
    # each kernel's calls side by side, the packages in turns within them
    fns = dict(sorted(fns.items(), key=lambda kv: kv[0].split(":")[1]))
    values = {k: f().double().reshape(-1) for k, f in fns.items()}
    rel = {}
    if "parent" in pkgs:
        for key, got in values.items():
            if key.startswith("change:"):
                want = values["parent:" + key.split(":", 1)[1]]
                rel[key.split(":", 1)[1]] = float(torch.max(
                    torch.abs(got - want) / torch.abs(want)))
    med, times = cs.median_in_turns(fns, REPS)
    print(json.dumps({"phase": "trace_times", "nvidia_smi": cs.nvidia_smi(),
                      "n": cs.N_MAIN, "rhos": list(cs.GRID_RHOS), "reps": REPS,
                      "packages": {k: v[1] for k, v in pkgs.items()},
                      "ms_median": med,
                      "traces": {k: v.tolist() for k, v in values.items()},
                      "max_rel_diff_change_vs_parent": rel,
                      "ms_all": times}), flush=True)
    # this package's traces with fewer, longer blocks: a cap on the blocks
    # of a walk gives each block per_block consecutive tile pairs (units;
    # at n = 100,000 per_block is 1, 3, 10, 38 for the dense walks and 1,
    # 2, 5, 19 for the tapered one)
    ck = pkgs["change"][0]
    default, sweep = ck._TRACE_MAX_BLOCKS, {}
    try:
        for cap in (default, 1 << 17, 1 << 15, 1 << 13):
            ck._TRACE_MAX_BLOCKS = cap
            sweep[f"max_blocks={cap}"] = cs.median_in_turns({
                k.split(":", 1)[1]: f for k, f in fns.items()
                if k.startswith("change:")}, REPS)[0]
    finally:
        ck._TRACE_MAX_BLOCKS = default
    print(json.dumps({"phase": "trace_block_sweep",
                      "nvidia_smi": cs.nvidia_smi(), "ms_median": sweep}),
          flush=True)


def grid_float64(dev, pts, X, z, probes, v_defl):
    """The grid path's fit with its products in float64, rounded once to
    float32 (the traces from the kernel)."""
    kernel = cuda_kernels.matern_matmat_multirho

    def products(points, rhos, V, nu, **kw):
        if V is None:
            return kernel(points, rhos, V, nu, **kw)
        inv = (1.0 / rhos).double()         # the kernel's float32 1/rho
        return cuda_kernels.matern_matmat_multirho_plain(
            points.double(), 1.0 / inv, V.double(), nu).float()

    cuda_kernels.matern_matmat_multirho = products
    try:
        B = len(cs.GRID_RHOS)
        grid = GridKrylovProfileLikelihood(
            pts, X, z, cs.GRID_RHOS, np.full(B, cs.NU), nu_static=cs.NU,
            lanczos_steps=cs.GRID_STEPS, num_probes=cs.GRID_PROBES,
            matrix_free=True, chunk=B, device=dev, probes=probes,
            v_defl=v_defl)
        return {"points": [{k: r[k] for k in ("rho", "eta", "sigma0", "lp",
                                              "success")}
                           for r in grid.fit_all()]}
    finally:
        cuda_kernels.matern_matmat_multirho = kernel


def path_etas(dev, pkgs, float64=False):
    """eta*, sigma0 and setup seconds of the main, grid and tapered paths
    under each package in ``pkgs``, from the same data and random blocks;
    the packages take turns on each path. ``float64``: also the grid path
    with float64 products (:func:`grid_float64`)."""
    pts, z, X = cs.make_problem(cs.N_MAIN, 7)
    B = len(cs.GRID_RHOS)
    probes, v_defl = cs.random_block(cs.N_MAIN, cs.GRID_PROBES, 2)
    tpts, tz, tX = cs.tapered_problem(cs.TAPER_SIDE)
    out = {}
    for label, (_, name) in pkgs.items():
        models = importlib.import_module(f"{name}.models.large_scale")
        grid_mod = importlib.import_module(f"{name}.models.grid_krylov")
        ops = importlib.import_module(f"{name}.ops.operators")
        taper = importlib.import_module(f"{name}.ops.taper")
        rec = {}
        op = ops.MaternOperator(pts, cs.RHO, nu=cs.NU, device=dev)
        t0 = time.perf_counter()
        eng = models.KrylovProfileLikelihood(
            op, X, z, lanczos_steps=cs.STEPS, num_probes=cs.PROBES,
            device=dev)
        torch.cuda.synchronize()
        res = eng.fit()
        rec["main"] = {"setup_seconds": time.perf_counter() - t0,
                       "eta_star": res["eta"], "sigma0": res["sigma0"],
                       "success": bool(res["success"])}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = grid_mod.GridKrylovProfileLikelihood(
            pts, X, z, cs.GRID_RHOS, np.full(B, cs.NU), nu_static=cs.NU,
            lanczos_steps=cs.GRID_STEPS, num_probes=cs.GRID_PROBES,
            matrix_free=True, chunk=B, device=dev, probes=probes,
            v_defl=v_defl)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rec["grid"] = {"setup_seconds": setup_s, "points": [
            {k: r[k] for k in ("rho", "eta", "sigma0", "lp", "success")}
            for r in grid.fit_all()]}
        top = taper.TaperedMaternOperator(tpts, cs.TAPER_SCALE, nu=cs.NU,
                                          density=cs.TAPER_DENSITY,
                                          device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = models.KrylovProfileLikelihood(
            top, tX, tz, lanczos_steps=cs.STEPS, num_probes=cs.PROBES,
            device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res = eng.fit()
        rec["tapered"] = {"setup_seconds": setup_s, "eta_star": res["eta"],
                          "sigma0": res["sigma0"],
                          "success": bool(res["success"])}
        out[label] = rec
        del grid, eng, top, op
    if float64:
        out["float64_products"] = {"grid": grid_float64(dev, pts, X, z,
                                                        probes, v_defl)}
    # eta* gaps: each fit of the grid path against the parent's and the
    # float64 products', and the change against the parent on every path
    gaps = {}
    for ref in ("parent", "float64_products"):
        if ref in out:
            gaps[f"grid_vs_{ref}"] = {
                k: [cs.rel_gap(p["eta"], q["eta"]) for p, q in zip(
                    out[k]["grid"]["points"], out[ref]["grid"]["points"])]
                for k in out if k != ref}
    if "parent" in out:
        a, b = out["change"], out["parent"]
        gaps["main_change_vs_parent"] = cs.rel_gap(a["main"]["eta_star"],
                                                   b["main"]["eta_star"])
        gaps["tapered_change_vs_parent"] = cs.rel_gap(
            a["tapered"]["eta_star"], b["tapered"]["eta_star"])
    print(json.dumps({"phase": "path_etas", "nvidia_smi": cs.nvidia_smi(),
                      "dot_mode": cuda_kernels.DEFAULT_DOT_MODE,
                      "packages": {k: v[1] for k, v in pkgs.items()},
                      "fits": out, "eta_rel_gaps": gaps}),
          flush=True)


def copy_libraries(dirs):
    """{dir: the kernel library of the package copy ``dir/gppe_tpu_torch``,
    built by that copy's own ``_build`` (one process per copy, all at
    once) and bound by this package's ``_build.load``}."""
    load = ("from gppe_tpu_torch.ops import _build; _build.load(); "
            "print(_build.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", load], cwd=d,
                              stdout=subprocess.PIPE, text=True)
             for d in dirs]
    paths = [p.communicate()[0].split() for p in procs]
    if any(p.returncode or not path for p, path in zip(procs, paths)):
        raise RuntimeError("a package copy's kernels did not build")
    return {d: _build.load(Path(path[-1])) for d, path in zip(dirs, paths)}


def variant_times(dev, dirs, kernel):
    """Median ms and errors of one wrapper (``kernel``: 'matmat',
    'multirho' or 'blocksparse') at its path's shape under each dot mode,
    or of one trace ('matmat_trace', 'multirho_trace',
    'blocksparse_trace'), with the kernel library of each package copy in
    ``dirs``."""
    libs = copy_libraries(dirs)
    pts, _, _ = cs.make_problem(cs.N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    if kernel == "matmat":
        V = torch.randn((cs.N_MAIN, 24), generator=g, device=dev)
        scale = torch.tensor([cs.RHO, cs.RHO], device=dev)
        want = [cuda_kernels.matern_matmat_plain(
            P.double(), scale.double(), V.double(), cs.NU)]
        run = lambda mode: [cuda_kernels.matern_matmat(  # noqa: E731
            P, scale, V, cs.NU, dot_mode=mode)]
    elif kernel == "matmat_trace":
        want = [cuda_kernels.matern_matmat_plain(
            P.double(), cs.RHO, None, cs.NU, frobenius=True)[1].reshape(1)]
        run = lambda mode: [cuda_kernels.matern_matmat(  # noqa: E731
            P, cs.RHO, None, cs.NU, frobenius=True)[1].reshape(1)]
    elif kernel == "multirho_trace":
        rhos = torch.as_tensor(cs.GRID_RHOS, dtype=torch.float32, device=dev)
        want = [cuda_kernels.matern_matmat_multirho_plain(
            P.double(), 1.0 / (1.0 / rhos).double(), None, cs.NU,
            return_frobenius=True)[1]]
        run = lambda mode: [cuda_kernels.matern_matmat_multirho(  # noqa
            P, rhos, None, cs.NU, return_frobenius=True)[1]]
    elif kernel == "multirho":
        rhos = torch.as_tensor(cs.GRID_RHOS, dtype=torch.float32, device=dev)
        V = torch.randn((len(rhos), cs.N_MAIN, 16), generator=g, device=dev)
        want = list(cuda_kernels.matern_matmat_multirho_plain(
            P.double(), 1.0 / (1.0 / rhos).double(), V.double(), cs.NU))
        run = lambda mode: list(cuda_kernels.matern_matmat_multirho(  # noqa
            P, rhos, V, cs.NU, dot_mode=mode))
    else:
        tpts, _, _ = cs.tapered_problem(cs.TAPER_SIDE)
        op = TaperedMaternOperator(tpts, cs.TAPER_SCALE, nu=cs.NU,
                                   density=cs.TAPER_DENSITY, device=dev)
        tau = cs.clear_threshold(op)
        args = (op.nu, tau, op.pair_i, op._pair_j, op.tile)
        kw = dict(n=op.shape[0], row_ptr=op._row_ptr)
        if kernel == "blocksparse_trace":
            want = [cuda_kernels.matern_matmat_blocksparse_plain(
                op.points_sorted.double(), None, *args, frobenius=True,
                **kw)[1].reshape(1)]
            run = lambda mode: [cuda_kernels.matern_matmat_blocksparse(  # noqa
                op.points_sorted, None, *args, frobenius=True,
                trace_walk=op._trace_walk, **kw)[1].reshape(1)]
        else:
            V = torch.randn((op.n_pad, 24), generator=g, device=dev)
            V[op.shape[0]:] = 0
            want = [cuda_kernels.matern_matmat_blocksparse_plain(
                op.points_sorted.double(), V.double(), *args, **kw)]
            run = lambda mode: [cuda_kernels.matern_matmat_blocksparse(  # noqa
                op.points_sorted, V, *args, dot_mode=mode, **kw)]

    def product(d, mode):
        _build._lib = libs[d]       # the wrappers launch this library's
        return run(mode)

    # a trace never rounds: one mode
    modes = (("highest",) if kernel.endswith("_trace")
             else cuda_kernels.DOT_MODES)
    fns = {f"{d}[{m}]": (lambda d=d, m=m: product(d, m))
           for d in dirs for m in modes}
    errors = {}
    for k, f in fns.items():
        per = [cs.compare(got, w) for got, w in zip(f(), want)]
        errors[k] = [max(e[0] for e in per), max(e[1] for e in per)]
    med, times = cs.median_in_turns(fns, REPS)
    _build._lib = None
    print(json.dumps({"phase": "variant_times", "kernel": kernel,
                      "nvidia_smi": cs.nvidia_smi(), "n": cs.N_MAIN,
                      "reps": REPS, "ms_median": med,
                      "frob_and_max_abs_vs_f64": errors, "ms_all": times}),
          flush=True)


# Libraries of the general-nu sources with one change each, by text
# substitution, (file, old, new): the bin counts (kTemmeBins, kCf2Bins) of
# csrc/matern_general_tile.cuh beside the source's own 4 + 6 (one bin a
# branch, fewer, more); and G1's product with its parts taken away one by
# one, which times the parts (those libraries' results are wrong)
_PRODUCTS = [("matern_general.cu",
              "    tile_times_v<RC>(s.k, s.v[0], acc);\n", ""),
             ("matern_general.cu",
              "    if (mirror) tile_t_times_v<RC>(s.k, s.v[1], mirror_acc);\n",
              "")]
_EVALUATION = [("matern_general.cu",
                "    tile_evaluate<false>(s, t, c, 0.0f);\n", "")]
_SCATTER = [("matern_general_tile.cuh",
             "  __syncthreads();\n  for (int m = 0; m < kTilePairs / kTileThreads; ++m) {\n"
             "    const int e = m * kTileThreads + threadIdx.x;\n    float* kp",
             "  __syncthreads();\n  for (int m = 0; m < 0; ++m) {\n"
             "    const int e = m * kTileThreads + threadIdx.x;\n    float* kp")]
_MATCH = [("matern_general_tile.cuh",
           "    const unsigned peers = __match_any_sync(0xffffffffu, bin);\n"
           "    if (bin != kNoBin && lane == __ffs(peers) - 1) {\n"
           "      atomicAdd(&t.cursor[bin], __popc(peers));\n    }\n", "")]
GENERAL_BIN_VARIANTS = {
    f"bins{temme}+{cf2}": [
        ("matern_general_tile.cuh", "constexpr int kTemmeBins = 4;",
         f"constexpr int kTemmeBins = {temme};"),
        ("matern_general_tile.cuh", "constexpr int kCf2Bins = 6;",
         f"constexpr int kCf2Bins = {cf2};")]
    for temme, cf2 in ((1, 1), (2, 3), (8, 12))}
GENERAL_PART_VARIANTS = {
    "without_products": _PRODUCTS,
    "without_products_evaluation": _PRODUCTS + _EVALUATION,
    "without_products_evaluation_scatter": _PRODUCTS + _EVALUATION + _SCATTER,
    "without_products_evaluation_scatter_match":
        _PRODUCTS + _EVALUATION + _SCATTER + _MATCH}


# the traces (tile_trace) with k's evaluation taken away, which times it
GENERAL_TRACE_PART_VARIANTS = {
    "traces_without_evaluation": [(
        "matern_general_tile.cuh",
        "  tile_evaluate<TAPER>(s, t, c, tau);\n  return tile_sum_k2(s);",
        "  return tile_sum_k2(s);")]}


def source_variants(tmp, variants):
    """{name: the kernel library of a copy of this package under
    ``tmp/name`` whose kernel sources carry that variant's substitutions},
    built all at once (copy_libraries)."""
    pkg = Path(cuda_kernels.__file__).resolve().parents[1]
    roots = {}
    for name, subs in variants.items():
        root = Path(tmp) / name
        shutil.copytree(pkg, root / pkg.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        csrc = root / pkg.name / "csrc"
        for fname, old, new in subs:
            text = (csrc / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in "
                                   f"{fname}")
            (csrc / fname).write_text(text.replace(old, new))
        roots[name] = str(root)
    libs = copy_libraries(list(roots.values()))
    return {name: libs[root] for name, root in roots.items()}


def with_library(lib, fn):
    """``fn`` run with the wrappers launching ``lib``'s kernels."""
    def run():
        saved = _build._lib
        _build._lib = lib
        try:
            return fn()
        finally:
            _build._lib = saved
    return run


def general_levers(dev, pkgs):
    """G1's and G2's products lever by lever, in turns (see the module
    docstring), with the bin-count variants beside them."""
    from torch.profiler import ProfilerActivity, profile

    parent = pkgs.get("parent", (None,))[0]
    g = torch.Generator(device=dev).manual_seed(12)
    P = torch.as_tensor(find_optimal_covariance.large_problem(cs.GENERAL_N)[0],
                        dtype=F32, device=dev)
    V = {r: torch.randn((cs.GENERAL_N, r), generator=g, device=dev)
         for r in (16, 24)}
    R, N = np.meshgrid(np.linspace(0.1, 0.3, 8), np.linspace(1, 25, 8),
                       indexing="ij")
    rhos, nus = R.ravel().tolist(), N.ravel().tolist()
    scales = torch.tensor(rhos, device=dev)
    W = torch.randn((64, cs.GENERAL_N, 16), generator=g, device=dev)
    nu = cs.GENERAL_NU
    out = {"nvidia_smi": cs.nvidia_smi(), "n": cs.GENERAL_N, "nu": nu,
           "rho": cs.RHO, "reps": REPS}
    with tempfile.TemporaryDirectory() as tmp:
        libs = source_variants(
            tmp, {**GENERAL_BIN_VARIANTS, **GENERAL_PART_VARIANTS})
        variants = {k: libs[k] for k in GENERAL_BIN_VARIANTS}
        g1 = {}
        for r in (24, 16):
            if parent is not None:
                g1[f"parent_r{r}"] = (lambda r=r: parent.matern_general_matmat(
                    P, cs.RHO, V[r], nu))
            g1[f"binned_rectangular_r{r}"] = (
                lambda r=r: cuda_kernels.matern_general_matmat(
                    P, cs.RHO, V[r], nu, points_cols=P))
            g1[f"binned_symmetric_r{r}"] = (
                lambda r=r: cuda_kernels.matern_general_matmat(
                    P, cs.RHO, V[r], nu))
            for key, lib in variants.items():
                g1[f"{key}_symmetric_r{r}"] = with_library(
                    lib, lambda r=r: cuda_kernels.matern_general_matmat(
                        P, cs.RHO, V[r], nu))
        g1["closed_form_nu0.5_symmetric_r16"] = (
            lambda: cuda_kernels.matern_general_matmat(P, cs.RHO, V[16], 0.5))
        for key in GENERAL_PART_VARIANTS:
            g1[f"{key}_symmetric_r16"] = with_library(
                libs[key], lambda: cuda_kernels.matern_general_matmat(
                    P, cs.RHO, V[16], nu))
        out["g1_ms"], out["g1_ms_all"] = cs.median_in_turns(g1, REPS)
        step = {"singles_r16": lambda: [cuda_kernels.matern_general_matmat(
                    P, rhos[b], W[b], nus[b]) for b in range(64)],
                "batched_r16":
                    lambda: cuda_kernels.matern_general_matmat_batched(
                        P, scales, W, nus)}
        if parent is not None:
            step["parent_singles_r16"] = lambda: [parent.matern_general_matmat(
                P, rhos[b], W[b], nus[b]) for b in range(64)]
        for key, lib in variants.items():
            step[f"{key}_batched_r16"] = with_library(lib,
                                                      step["batched_r16"])
        out["step_64_points_ms"], out["step_ms_all"] = cs.median_in_turns(
            step, REPS // 2)
        # the batched call's bound: each point's own, summed
        bounds = [cs.general_bound("product", cs.GENERAL_N, 2, 16, nus[b],
                                   cs.sample_pair_distances(P, rhos[b],
                                                            seed=b))
                  for b in range(64)]
        out["batched_r16_bound_ms"] = sum(b[0] for b in bounds)
        out["batched_r16_bound_ms_per_point"] = [b[0] for b in bounds]
        out["batched_r16_k_work_per_point"] = [b[3] for b in bounds]
        pts, _, _ = cs.tapered_problem(cs.TAPER_SIDE)
        op = TaperedMaternOperator(pts, cs.TAPER_SCALE, nu=cs.TAPER_GENERAL_NU,
                                   density=cs.TAPER_DENSITY, device=dev)
        Vt = torch.randn((op.n_pad, 24), generator=g, device=dev)
        Vt[op.shape[0]:] = 0
        args = (op.nu, op.threshold, op.pair_i, op._pair_j, op.tile)
        kw = dict(n=op.shape[0], row_ptr=op._row_ptr)
        skip2 = cuda_kernels._blocksparse_skip2

        def g2(skip=True):
            if not skip:
                cuda_kernels._blocksparse_skip2 = lambda nu, tau: float("inf")
            try:
                return cuda_kernels.matern_matmat_blocksparse(
                    op.points_sorted, Vt, *args, **kw)
            finally:
                cuda_kernels._blocksparse_skip2 = skip2
        g2_fns = {"binned_no_skip": lambda: g2(False), "binned_skip": g2}
        if parent is not None:
            g2_fns["parent"] = lambda: parent.matern_matmat_blocksparse(
                op.points_sorted, Vt, *args, **kw)
        for key, lib in variants.items():
            g2_fns[f"{key}_skip"] = with_library(lib, g2)
        out["g2_full_list_r24_ms"], out["g2_ms_all"] = cs.median_in_turns(
            g2_fns, REPS // 2)
        out["g2_skip_radius"] = cuda_kernels.blocksparse_skip_radius(
            op.nu, op.threshold)
        out["g2_taper_radius"] = op.radius
        out["g2_skip_equals_no_skip"] = bool(torch.equal(g2(), g2(False)))
    # one batched launch under the profiler: the tile kernel and the sum
    step["batched_r16"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step["batched_r16"]()
        torch.cuda.synchronize()
    out["batched_r16_device_ms"] = {
        re.sub(r"<.*", "", e.key)[:60]: e.device_time_total / 1e3
        for e in prof.key_averages() if e.device_time_total > 0}
    walk = cuda_kernels.general_product_bands(cs.GENERAL_N, cs.GENERAL_N, 16,
                                              64, True)
    out["batched_r16_bands"] = walk._asdict()
    out["batched_r16_slot_bytes"] = 4 * walk.slot_floats
    out["general_product_pairs_per_point"] = (
        cs.GENERAL_N * (cs.GENERAL_N + 1) // 2)
    print(json.dumps({"phase": "general_levers", **out}), flush=True)
    general_traces(dev, pkgs)


def general_traces(dev, pkgs):
    """The general-nu traces in turns against the parent's (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile

    parent = pkgs.get("parent", (None,))[0]
    P = torch.as_tensor(find_optimal_covariance.large_problem(cs.GENERAL_N)[0],
                        dtype=F32, device=dev)
    R, N = np.meshgrid(np.linspace(0.1, 0.3, 8), np.linspace(1, 25, 8),
                       indexing="ij")
    rhos, nus = R.ravel().tolist(), N.ravel().tolist()
    scales = torch.tensor(rhos, device=dev)
    nu = cs.GENERAL_NU
    out = {"nvidia_smi": cs.nvidia_smi(), "n": cs.GENERAL_N, "nu": nu,
           "rho": cs.RHO, "reps": REPS}
    values = {}

    def keep(key, fn):
        def run():
            values[key] = fn()
            return values[key]
        return run

    def single(ck):
        return lambda: ck.matern_general_matmat(P, cs.RHO, None, nu,
                                                frobenius=True)[1]

    def singles(ck):
        return lambda: torch.stack([ck.matern_general_matmat(
            P, rhos[b], None, nus[b], frobenius=True)[1] for b in range(64)])
    g1 = {"trace": keep("trace", single(cuda_kernels)),
          "singles_64": keep("singles_64", singles(cuda_kernels)),
          "batched_64": keep("batched_64", lambda: (
              cuda_kernels.matern_general_trace_batched(P, scales, nus)))}
    if parent is not None:
        g1["parent_trace"] = keep("parent_trace", single(parent))
        g1["parent_singles_64"] = keep("parent_singles_64", singles(parent))
    tmp = tempfile.TemporaryDirectory()
    parts = source_variants(tmp.name, GENERAL_TRACE_PART_VARIANTS)
    for key, lib in parts.items():
        g1[f"{key}_trace"] = with_library(lib, single(cuda_kernels))
    out["g1_ms"], out["g1_ms_all"] = cs.median_in_turns(g1, REPS)
    sample = cs.sample_pair_distances(P, cs.RHO, seed=23)
    out["g1_trace_bound_ms"] = cs.general_bound(
        "trace", cs.GENERAL_N, 2, 0, nu, sample)[0]
    out["g1_batched_64_bound_ms"] = sum(
        cs.general_bound("trace", cs.GENERAL_N, 2, 0, nus[b],
                         cs.sample_pair_distances(P, rhos[b], seed=b))[0]
        for b in range(64))
    out["g1_batched_equals_singles"] = bool(torch.equal(
        values["batched_64"], values["singles_64"]))

    pts, _, _ = cs.tapered_problem(cs.TAPER_SIDE)
    op = TaperedMaternOperator(pts, cs.TAPER_SCALE, nu=cs.TAPER_GENERAL_NU,
                               density=cs.TAPER_DENSITY, device=dev)
    args = (op.nu, op.threshold, op.pair_i, op._pair_j, op.tile)
    kw = dict(n=op.shape[0], row_ptr=op._row_ptr)

    def g2(ck, walk):
        return lambda: ck.matern_matmat_blocksparse(
            op.points_sorted, None, *args, frobenius=True, trace_walk=walk,
            **kw)[1]
    g2_fns = {"skip": keep("g2_skip", g2(cuda_kernels, op._trace_walk)),
              "no_skip": keep("g2_no_skip", lambda: cs.without_skip(
                  g2(cuda_kernels, op._trace_walk)))}
    if parent is not None:
        walk = parent.blocksparse_trace_schedule(op.pair_i, op.pair_j,
                                                 op.tile, op.shape[0])
        walk = walk._replace(units=torch.as_tensor(walk.units, device=dev))
        g2_fns["parent"] = keep("g2_parent", g2(parent, walk))
    for key, lib in parts.items():
        g2_fns[f"{key}_skip"] = with_library(
            lib, g2(cuda_kernels, op._trace_walk))
    out["g2_full_list_ms"], out["g2_ms_all"] = cs.median_in_turns(g2_fns,
                                                                  REPS)
    tmp.cleanup()
    out["g2_trace_bound_ms"] = cs.g2_bounds(
        op, 24, 2, cs.tile_pair_distances(op, seed=28))[1][0]
    out["g2_units"] = len(op._trace_walk.units)
    out["g2_skip_equals_no_skip"] = float(values["g2_skip"]) == float(
        values["g2_no_skip"])
    out["values"] = {k: v.tolist() for k, v in values.items()}
    if parent is not None:
        out["rel_gap_to_parent"] = {
            "g1_trace": cs.rel_gap(float(values["trace"]),
                                   float(values["parent_trace"])),
            "g1_64": float(((values["batched_64"]
                             - values["parent_singles_64"]).abs()
                            / values["parent_singles_64"]).max()),
            "g2_trace": cs.rel_gap(float(values["g2_skip"]),
                                   float(values["g2_parent"]))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g1["batched_64"]()
        torch.cuda.synchronize()
    out["batched_64_device_ms"] = {
        re.sub(r"<.*", "", e.key)[:60]: e.device_time_total / 1e3
        for e in prof.key_averages() if e.device_time_total > 0}
    print(json.dumps({"phase": "general_traces", **out}), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: needs an NVIDIA GPU")
    dev = cs.phase_device()
    if "--dot-mode" in argv:
        cuda_kernels.DEFAULT_DOT_MODE = cuda_kernels.resolve_dot_mode(
            argv[argv.index("--dot-mode") + 1])
    if "ptxas" in argv:
        ptxas_report()
    pkgs = (packages(argv) if {"modes", "eta", "traces"} & set(argv)
            else None)
    if "modes" in argv:
        mode_times(dev, pkgs)
    if "traces" in argv:
        trace_times(dev, pkgs)
    if "eta" in argv:
        path_etas(dev, pkgs, float64="--float64" in argv)
    if "sass" in argv:
        sass_twins(argv[argv.index("--parent") + 1])
    if "sass-mix" in argv:
        sass_mix()
    if "general-levers" in argv:
        general_levers(dev, packages(argv))
    elif "general-traces" in argv:
        general_traces(dev, packages(argv))
    if "eta-main" in argv:
        eta_sensitivity(dev)
    if "variants" in argv:
        kernel = (argv[argv.index("--kernel") + 1] if "--kernel" in argv
                  else "matmat")
        variant_times(dev, argv[argv.index("variants") + 1:], kernel)
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
    if "search" in argv:
        # find_optimal_covariance.main_large's engine at its defaults
        pts, z, X = find_optimal_covariance.large_problem(cs.GENERAL_N)
        R, N = np.meshgrid(np.linspace(0.1, 0.3, 8), np.linspace(1, 25, 8),
                           indexing="ij")
        profile_setup("search", lambda: GridKrylovProfileLikelihood(
            pts, X, z, R.ravel(), N.ravel(), lanczos_steps=40,
            num_probes=8, device=dev))
    if "taper" in argv:
        pts, z, X = cs.tapered_problem(cs.TAPER_SIDE)
        op = TaperedMaternOperator(pts, cs.TAPER_SCALE, nu=cs.NU,
                                   density=cs.TAPER_DENSITY, device=dev)
        profile_setup("taper", lambda: KrylovProfileLikelihood(
            op, X, z, lanczos_steps=cs.STEPS, num_probes=cs.PROBES,
            device=dev))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
