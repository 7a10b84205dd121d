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
    dense API at nu = 1.2 and 3.7 (its assembly entry), MaternOperator
    at n = 10,000 through KrylovProfileLikelihood (its product and trace
    entries), and the (rho, nu) search of
    drivers.find_optimal_covariance (main_large: n = 10,000 over an 8 x 8
    grid of general nus, one batched product call a Lanczos step; main
    at a reduced size, one assembly launch per chunk of its lp calls);
  * the rest of the tapered slice: the scipy-sparse route
    (generate_correlation(sparse=True) on the native host builder ->
    GaussianProcess over a SparseOperator on cuSPARSE's SpMM) at
    n = 2^18, and the tapered path at a general nu at n = 2^20 on the
    tapered general-nu kernel matern_blocksparse_general.cu;
  * the posterior slice: models.hmc's and models.nuts's samplers on the
    dense n = 900 target and on the two posterior surfaces at n ~ 10^5,
    64 chains each, and the drivers.sample_posterior twin at the golden
    configuration (NUTS, the traced-nu samplers, the MAP refinement on the
    general-nu kernel's assembly entry);
  * the structured-grid slice: the exact FFT grid operator
    GridMaternOperator (cuFFT products; its general-nu offset table on
    the general-nu kernel's elementwise entry) through
    compare_various_num_points.run_krylov(fft=True) at n = 2^20 and
    find_optimal_covariance.main_fft_grid (the 5 x 5 (rho, nu) MAP sweep
    at n = 2^20); the (eta, rho, nu) posterior surface
    KrylovPosteriorSurfaceRhoNu at n = 100,489 (batched FFT Lanczos over
    81 nodes, one elementwise launch per nu) and the (eta, rho) surface
    KrylovPosteriorSurface at n = 100,000 (the multi-rho kernel);
  * the multi-device slice (gppe_tpu_torch.parallel): the sharded
    profile-likelihood MLE (ShardedKrylovProfileLikelihood: B1's product
    on its rectangular form over the block ring or the all-gather, B1's
    trace on the rectangular walk, G1's at a general nu) at phase 5's
    size on one NCCL rank and on two gloo ranks sharing the card, the
    sharded profile step over the probe axis at four ranks, the samplers'
    mesh= on two ranks, and the scaling twin at 1, 2 and 4 ranks. Ranks
    are processes (parallel.mesh.spawn); every multi-rank figure is
    correctness-grade, since the ranks share one card;
  * the drivers and utilities: drivers.profile_grid_chunk (the grid
    chunk's setup split into its Lanczos variants on the multi-rho
    kernel), drivers.compare_various_noise_level (200 noise levels x 4
    basis families on one K each), drivers.plot_log_likelihood_der1 and
    plot_matern_kernel, every plot=True path where matplotlib is
    installed, and utils.timing (phase_timer, device_trace).

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
     24.9} (finite, in [0, 1], within 3e-5), the assembly of the six nus
     in one launch at each shape below (each K within 3e-5, symmetric bit
     for bit, a diagonal of ones, equal to its single call; float64 the
     float32 widened; blocks of rows the square's rows), the product at r in {1, 7,
     16, 24} (the symmetric walk, the same bits twice; the rectangular
     walk at r = 24) and the trace at n = 1000 and 4096 (2-D) and 1000
     (3-D), within 1e-5 (the trace on the square and the rectangular walk,
     the same bits twice); one batched product launch over the six nus
     equal bit for bit to their single calls and to itself in bands of 7
     tile pairs, each of those bands' sums through the sum kernel equal
     bit for bit to its plain version on the band's captured slots, one
     batched trace launch over them equal bit for bit to
     their single calls; at the closed forms the
     general kernel's branch, and matern_matmat launching the
     closed-form kernels only;
 22. the dense API at general nu: generate_correlation on phase 19's grid
     at nu = 1.2 and 3.7 (one assembly launch each), GaussianProcess.train
     in 'direct' and 'profiled'; the assembly timed in turns against the
     parent's route (the distance passes and the elementwise entry);
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
     5e-2, the lp gap logged); the band sums of one of its steps replayed
     through the kernel and the plain version (the product's bits) and
     timed; and main cut to a 30 x 30 grid of points, a
     6 x 6 (rho, nu) grid and DE with popsize 10 for at most 6
     generations (at most one assembly launch per chunk of lp calls, no
     elementwise launch), its lp at three grid points
     within 1e-5 of the CPU's float64 build_objective.
 25. the tapered general-nu kernel (matern_blocksparse_general.cu, G2)
     against plain float64: products at r in {1, 7, 24} and traces at
     n = 1000 (2-D and 3-D), nu in {0.3, 1.2, 3.7, 24.9}, and n = 4096
     (2-D) at nu 1.2 and 24.9,
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
     general-nu CSR builder at n = 2^16, nu = 1.2, on the card (one
     assembly launch per block of rows), its pattern
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
 29. GridMaternOperator at n = 1024 (a 32 x 32 grid, rho 0.1, nu = 2.2;
     tests_tpu/test_onchip.py:159-199): its float32 table one elementwise
     launch within 3e-5 of the float64 table, matmat of 5 columns within
     2e-5 (Frobenius) of float64 dense K @ V, the Krylov fit within the
     float64 spectral answer's rtol 0.1 (eta) and 1e-2 (sigma0);
 30. the 2^20 FFT fits (grid side 1024, rho 0.005, nu in {1/2, 2.2}, 48
     steps, 12 probes; bench.py:383-405) through
     compare_various_num_points.run_krylov(fft=True): construction, setup
     and fit seconds, eta in (1, 1e3), sigma0 > 0; the FFT product at
     r = 24 against float64 and timed beside its bound (cuFFT, a library
     call);
 31. find_optimal_covariance.main_fft_grid at its defaults (n = 2^20,
     5 x 5 (rho, nu), 48 steps, 16 probes, the priors on): seconds per
     point, the MAP of the committed data/optimal_covariance_fft_n2e20
     .pickle (each row's gaps to it logged), three rows against float64
     engines on the same random block (eta 5e-2, sigma0 5e-3);
 32. KrylovPosteriorSurfaceRhoNu at n = 100,489 (9 x 9 nodes, k = 48, 16
     probes; drivers/sample_posterior.py's main_rho_nu_large): one
     elementwise launch per nu; its probe cross-validation against fresh
     GridMaternOperator engines (the bulk probes within 0.5 nats, all
     within 10, the reference's diffs logged); a 3 x 3 surface of float64
     nodes on the card (no kernel launch) on the same random block against
     the float32 one at its nodes: within 6 nats at log10 eta 1, 3 at 2
     and 3;
 33. KrylovPosteriorSurface at n = 100,000 (nu 1/2, 12 nodes, k = 64, 24
     probes; the multi-rho kernel): setup seconds, launches, the surface
     and its gradient under torch.func.vmap over 256 points; two routes
     with the same random block within 0.5 nats at three points: the
     multi-rho kernel against MaternOperator's at n = 100,000, the
     general-nu kernel's batched calls against its single ones at
     n = 10^4, nu = 1.2;
 34. the HMC posterior slice's dense anchor at n = 900 (bench.py:261-323:
     a 30 x 30 grid, noise 0.2, nu = 1/2, the box ((-3, 4), (-1.5,
     -0.5)), 8 chains, 50 warmup + 50 samples, cut): models.hmc
     .sample_posterior (a float64 Cholesky per gradient, no hand kernel),
     then sample_posterior_large on a KrylovPosteriorSurface of the same
     data (the multi-rho kernel) over the same box and budget; the two
     means of log10 eta within the dense samples' sd;
 35. sample_posterior_large on phase 33's surface (n = 100,000, 64
     chains, 16 leapfrog steps, the box ((-3, 3), (-1.5, -0.5));
     bench.py:557-606; 100 warmup, samples cut to 100): samples finite
     and in the box, mean accept above
     0.5, split R-hat under 1.1; resume_hmc from a state for 10 steps equal
     bit for bit to 10 more steps of the run it continues, also through
     save_hmc_state / load_hmc_state; ms a vmapped gradient at 64 chains;
 36. sample_posterior_rho_nu_large on phase 32's surface (n = 100,489, 64
     chains, 16 leapfrog steps, log10 eta in (0.5, 4), the reference's
     priors; main_rho_nu_large's configuration) against the committed
     data/posterior_rho_nu_n100k.pickle's moments (mean log10 eta within
     0.05, mean log10 rho within 0.1, the nu median inside its
     interquartile range, mean accept above 0.6), split R-hat logged.
     Phases 34-36 run warmup and samples cut from the reference's to keep
     them near 180 s together; each lists its cuts as "reduced".
 37. models.nuts.sample_posterior on phase 34's dense target (n = 900, 8
     chains, max_depth 8, from cold; no hand kernel): samples finite and
     in the box, the mean of log10 eta within phase 34's dense HMC sd and
     3 MCSE of its mean; the mean tree depth, leaves and host reads a step
     logged;
 38. nuts.sample_posterior_large on phase 33's surface (64 chains),
     continuing phase 35's adapted chains: in the box, mean accept
     statistic above 0.5, both means within 3 MCSE of phase 35's, split
     R-hat logged; resume_nuts equal bit for bit to the run's last steps,
     in memory and through save_hmc_state / load_hmc_state; ms a step and
     a leaf;
 39. nuts.sample_posterior_rho_nu_large on phase 32's surface (64
     chains), continuing phase 36's adapted chains, against phase 36's
     bounds on the committed pickle's moments;
 40. the sample_posterior twin at n = 900, noise 0.2: main(sampler=
     "nuts"), main_nu (the joint and eta-profiled traced-nu HMC, then the
     MAP refinement) and main_profile_rho_nu, each in its own launch
     window: samples in their boxes, each refined MAP within 0.005 of rho
     0.1767, 0.5 of nu 3.034 and 0.1 nat of 957.779, each rho median
     within 0.08 of 0.1767; ms a vmapped jacfwd gradient of both traced-nu
     targets.
     Phases 37-40 cut warmup and samples (listed as "reduced"): a NUTS
     step on the surfaces builds 127-255 leaves of one vmapped gradient
     each, and a traced-nu gradient takes 0.4-1.1 s.
 41. ShardedKrylovProfileLikelihood on one rank, NCCL, at phase 5's
     configuration and draws (key 0): eta and sigma0 within 5e-4 of phase
     5's fit; 64 products on matern_matmat_mma and the square trace on
     matern_matmat in its window; the card's compute mode logged (the
     multi-rank phases need "Default": ranks share the card);
 42. the same at two gloo ranks on the card, mesh (1, 2), the ring and
     the all-gather schedule: each fit's eta within 5e-4 of phase 5's; the
     two factorizations' tridiagonals, U and trace(K^2) within 1e-5, G
     and P (single late basis vectors) within 1e-3; the bytes each rank
     moved through the host, a Lanczos step and in all, and its seconds;
 43. four gloo ranks, mesh (2, 2), ring: build_sharded_profile_step's
     der1, traceinv and logdet at etas 0.3, 3, 30 within 1e-3 of one rank's
     (der1 relative to traceinv, the size of its terms), every rank the
     same; then nu = 1.2 at n = 10^4 on two ranks (phase 23's
     configuration), eta within 5e-4 of phase 23's, G1's product and trace
     launched and no closed-form kernel;
 44. the samplers' mesh= on two ranks (chains over probe) on phase 34's
     dense target, 8 chains: HMC 10 + 10 (cut from 50 + 50) and NUTS 2 + 2
     at max_depth 5: every rank the same gathered samples, HMC's means
     within 3 MCSE of one process's run of the same draws;
     then the scaling twin's main at 1, 2 and 4 ranks (n = 2^14; graded
     correctness; 2 ranks' traceinv within 1e-3 of 1 rank's), and B1's
     trace on the rectangular walk of a world-2 ring block (50,000 x
     100,000) against float64, timed beside its bound.
     Phases 42-44 run in one launch of four gloo ranks, each mesh made of
     its first ranks.
 45. drivers.profile_grid_chunk.main at its defaults (n = 100,000, 8
     rhos, k = 40, C = 16): the Lanczos with and without
     reorthogonalisation and the full chunk, timed after a two-step warm
     chunk; exactly 2 + 3 x 40 launches of B2's product kernel and 2 of
     its trace kernel; every derived cost finite and not negative, the
     full chunk at least the base Lanczos;
 46. drivers.compare_various_noise_level.main at its defaults (a 30 x 30
     grid, 200 levels, 4 families): the mean sigma0 / noise and
     gcv_sigma0 / noise of each family's 20 highest levels in (0.7, 1.3)
     and (0.6, 1.4) (the reference's test claim);
 47. plot_log_likelihood_der1.main on a 30 x 30 grid, its eta within
     1e-3 of GaussianProcess's profiled fit on the same data;
     plot_matern_kernel.main(test=True) under 0.02; the derivative plot's
     numbers finite; where matplotlib is installed (logged), each
     plot=True path once into a temporary directory, its file written;
 48. utils.timing: phase_timer around phase 45's full chunk within 5% of
     CUDA events recorded in the same window; device_trace around one B2
     launch writes a Chrome trace whose key_averages() name B2's kernel.
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

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch
import torch.distributed as dist

import gppe_tpu_torch
from gppe_tpu_torch.drivers import (compare_various_noise_level,
                                    compare_various_num_points,
                                    find_optimal_covariance,
                                    plot_log_likelihood_der1,
                                    plot_matern_kernel, profile_grid_chunk,
                                    profile_kernel_matrix, roofline_matvec,
                                    scaling_efficiency)
from gppe_tpu_torch.models import (diagnostics, direct_likelihood, hmc,
                                   profile_likelihood)
from gppe_tpu_torch.models.grid_krylov import GridKrylovProfileLikelihood
from gppe_tpu_torch.models.krylov_posterior import (
    SURFACE_CHUNK_BYTES, KrylovPosteriorSurface, KrylovPosteriorSurfaceRhoNu)
from gppe_tpu_torch.models.large_scale import KrylovProfileLikelihood
from gppe_tpu_torch.models.mixed_correlation import MixedCorrelation
from gppe_tpu_torch.models.priors import inverse_square_log_prior
from gppe_tpu_torch import native
from gppe_tpu_torch.ops import _build, assembly, cuda_kernels, kernels, linalg
from gppe_tpu_torch.ops import stochastic, taper
from gppe_tpu_torch.ops.operators import (GridMaternOperator, MaternOperator,
                                          SparseOperator)
from gppe_tpu_torch.ops.taper import TaperedMaternOperator
from gppe_tpu_torch.parallel import mesh as par_mesh
from gppe_tpu_torch.parallel import sharded
from gppe_tpu_torch.utils import checkpoint, config
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


_T0 = time.perf_counter()


def log(**kv):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**kv, "elapsed_s": time.perf_counter() - _T0}),
          flush=True)


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


# a function whose first timed turn takes longer than this (a plain
# PyTorch version: 0.5-3.3 s a call on an H100) is timed in SLOW_REPS turns
# only; the kernels, each under 200 ms, keep all of them
SLOW_MS, SLOW_REPS = 200.0, 3


def median_in_turns(fns, reps=7):
    """Median ms of each function, timed in turns after one warm-up; every
    other turn runs them in reverse order (a, b, b, a), so that no function
    always runs right after a call of another kernel, nor always right
    after a call of its own (two copies of one kernel timed in a fixed
    order have read 3-7% apart on an H100). A function slower than SLOW_MS
    in the first turn drops out after SLOW_REPS turns."""
    for f in fns.values():
        f()
    times = {k: [] for k in fns}
    order = list(fns)
    for rep in range(reps):
        for k in order if rep % 2 == 0 else order[::-1]:
            if rep < SLOW_REPS or times[k][0] <= SLOW_MS:
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


def general_bound(kind, n, d, r, nu, x_sample, elements=None, word=4):
    """bound() of one general-nu launch over this run's data: the
    elementwise entry over ``elements`` distances; the assembly of the
    square K (n x n, ``word`` bytes an entry) on its symmetric walk, each
    walk pair its distance and, off the diagonal, one k, the n d points
    read and the n^2 entries written; the symmetric product
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
    if kind == "assembly":
        nbytes = 4 * n * d + word * n * n
    elif kind == "product":
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


GENERAL_COUNTERS = ("matern_general_elementwise", "matern_general_assembly",
                    "matern_general_product", "matern_general_product_sum",
                    "matern_general_trace")


def captured_band_sums(fn):
    """``fn()`` and, for every band sum of the general-nu product that it
    launches, its inputs as they stood: (slots, out before the sum, the
    sum's other arguments), cloned."""
    captured = []
    sum_cuda = cuda_kernels._general_product_sum_cuda

    def spy(slots, out, *args):
        captured.append((slots.clone(), out.clone(), args))
        return sum_cuda(slots, out, *args)
    cuda_kernels._general_product_sum_cuda = spy
    try:
        return fn(), captured
    finally:
        cuda_kernels._general_product_sum_cuda = sum_cuda


def band_sums_match_plain(captured):
    """Each captured band sum through the kernel and through its plain
    version on the same inputs: True where every band's outputs are the
    same bits (compared as integers: the rows a band does not write hold
    what the scratch held, NaN patterns too)."""
    same = True
    for slots, before, args in captured:
        got, want = before.clone(), before.clone()
        cuda_kernels.general_product_sum(slots, got, *args)
        cuda_kernels.general_product_sum_plain(slots, want, *args)
        same = same and bool(torch.equal(got.view(torch.int32),
                                         want.view(torch.int32)))
    return same


def band_sum_bytes(captured):
    """The bytes the captured band sums must move: each slot entry of a
    row tile's rows read once, each row tile's out read where its band
    continues a sum and written once."""
    total = 0
    for _, before, (nc, symmetric, g0, band, _) in captured:
        B, nr, r = before.shape
        for x, s_lo, pairs, _ in cuda_kernels.general_product_sum_slots(
                nr, nc, symmetric, g0, g0 + band):
            rows = min(cuda_kernels._TRACE_TILE, nr - x
                       * cuda_kernels._TRACE_TILE)
            total += 4 * B * rows * r * (len(pairs) + 1 + (s_lo > 0))
    return total


def scaled_f32(P, scale):
    """The points divided by the scale in float32, as the general-nu
    kernels divide them, then float64: the float64 references' inputs."""
    return (P / torch.as_tensor(scale, dtype=F32, device=P.device)).double()
CLOSED_FORM_COUNTERS = ("matern_matmat", "matern_matmat_mma",
                        "matern_matmat_multirho",
                        "matern_matmat_multirho_mma")


def assembly_parity(dev, P, rhos):
    """The assembly entry over GENERAL_NUS at the scales ``rhos`` on the
    points P: one launch for the batch; each K against float64 on the
    kernel's own float32 scaled points and against the plain float32
    version (logged), symmetric bit for bit, a diagonal of ones, equal to
    its single call; float64 output the float32 widened; blocks of rows
    the square's rows, bit for bit."""
    n, d = P.shape
    scales = torch.tensor(rhos, device=dev)
    cuda_kernels.reset_launch_counts()
    K = cuda_kernels.matern_general_assemble(P, scales, GENERAL_NUS)
    launches = cuda_kernels.launch_counts["matern_general_assembly"]
    rec = {"n": n, "d": d, "launches": launches,
           "float64_is_widened": bool(torch.equal(
               cuda_kernels.matern_general_assemble(
                   P, scales, GENERAL_NUS, out_dtype=F64), K.double())),
           "rows_equal_square": all(
               torch.equal(cuda_kernels.matern_general_assemble(
                   P, scales, GENERAL_NUS, rows=rows), K[:, rows[0]:rows[1]])
               for rows in ((0, 129), (n // 3, n), (n - 1, n))),
           "per_nu": {}}
    for b, nu in enumerate(GENERAL_NUS):
        S = scaled_f32(P, rhos[b])
        want = kernels.matern(kernels.pairwise_scaled_distance(S, S, 1.0), nu)
        plain = kernels.matern(kernels.pairwise_scaled_distance(
            P, P, rhos[b]), nu)
        rec["per_nu"][nu] = {
            "max_abs_err_vs_f64": float((K[b].double() - want).abs().max()),
            "plain_f32_max_abs_err_vs_f64": float(
                (plain.double() - want).abs().max()),
            "symmetric_bits": bool(torch.equal(K[b], K[b].T)),
            "diagonal_one": bool(torch.all(torch.diagonal(K[b]) == 1.0)),
            "equal_to_single_call": bool(torch.equal(
                cuda_kernels.matern_general_assemble(
                    P, scales[b:b + 1], (nu,))[0], K[b]))}
        del want, plain
    return rec


def phase_general_parity(dev):
    """Phase 21: the entries of the general-nu kernel against plain
    float64 on the card. (a) k over x in geomspace(1e-5, 40) and 0 at each
    nu of GENERAL_NUS: finite, in [0, 1], within GENERAL_K_ATOL; at each
    shape below the assembly of the six nus (assembly_parity); (b) and
    (c) at n = 1000 and 4096 random 2-D points and n = 1000 3-D points,
    r in {1, 7, 16, 24}: products (the symmetric walk; the rectangular
    one at r = 24) and traces (both walks) within GENERAL_FROB_TOL and
    GENERAL_TRACE_RTOL, the product and the trace the same bits twice; one
    batched product launch over the nus at six scales equal bit for bit to
    the six single calls, and to itself with its walk cut into bands of 7
    tile pairs, each band's sum kernel equal bit for bit to the plain
    version on its captured inputs; one batched trace launch over them
    equal bit for bit to the six single calls.
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
    products, batches, assemblies = [], [], []
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
        assemblies.append(assembly_parity(dev, P, rhos))
        Vb = torch.randn((len(GENERAL_NUS), n, 24), generator=g, device=dev)
        cuda_kernels.reset_launch_counts()
        batch = cuda_kernels.matern_general_matmat_batched(
            P, torch.tensor(rhos, device=dev), Vb, GENERAL_NUS)
        launches = cuda_kernels.launch_counts["matern_general_product"]
        walk = cuda_kernels.general_product_bands(n, n, 24,
                                                  len(GENERAL_NUS), True)
        cuda_kernels.reset_launch_counts()
        banded, band_inputs = captured_band_sums(lambda: with_slot_budget(
            4 * walk.slot_floats // walk.band_pairs * 7,
            lambda: cuda_kernels.matern_general_matmat_batched(
                P, torch.tensor(rhos, device=dev), Vb, GENERAL_NUS)))
        banded_launches = cuda_kernels.launch_counts["matern_general_product"]
        sum_launches = cuda_kernels.launch_counts[
            "matern_general_product_sum"]
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
            "bands_of_7_sum_launches": sum_launches,
            "bands_of_7_expected": -(-walk.pairs // 7),
            "bands_of_7_equal": bool(torch.equal(batch, banded)),
            # each band's sum through the kernel and its plain version on
            # the band's captured slots and rows
            "band_sums_equal_plain": band_sums_match_plain(band_inputs),
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
                    and b["bands_of_7_sum_launches"]
                    == b["bands_of_7_expected"]
                    and b["band_sums_equal_plain"]
                    for b in batches)
    ok = ok and all(
        a["launches"] == 1 and a["float64_is_widened"]
        and a["rows_equal_square"]
        and all(e["max_abs_err_vs_f64"] < GENERAL_K_ATOL
                and e["symmetric_bits"] and e["diagonal_one"]
                and e["equal_to_single_call"] for e in a["per_nu"].values())
        for a in assemblies)

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
        batches=batches, assemblies=assemblies, closed_forms=closed)
    if not ok:
        raise AssertionError("the general-nu kernel disagrees with float64")


def phase_general_dense_api(dev):
    """Phase 22: generate_correlation on the reference's 64 x 64 grid (rho
    0.1, noise 0.2, degree-2 basis, as phase 19) at nu = 1.2 and 3.7, then
    GaussianProcess(X, K).train(z) by both methods; the launch counts of
    the two calls in one window per nu (one assembly launch, no
    elementwise one). Then, at that shape (K of n = 4096), the assembly
    entry timed in turns against the parent's route (the distance passes,
    then the elementwise entry over 16.8M distances), the elementwise
    entry alone and both plain versions, each beside its bound."""
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
              and window[nu].get("matern_general_assembly", 0) == 1
              and window[nu].get("matern_general_elementwise", 0) == 0)
        del K

    # the assembly at this shape against the parent's route (the distance
    # passes, then the elementwise entry), in turns, beside the elementwise
    # entry alone on the distances, the plain float32 version and their
    # bounds
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    dist = kernels.pairwise_scaled_distance(P, P, RHO).contiguous()
    nu = 3.7
    scale = torch.tensor([RHO], device=dev)
    S = scaled_f32(P, RHO)
    want = kernels.matern(kernels.pairwise_scaled_distance(S, S, 1.0), nu)
    K = cuda_kernels.matern_general_assemble(P, scale, (nu,))[0]
    asm_err = float((K.double() - want).abs().max())
    route_err = float((cuda_kernels.matern_general(dist, nu).double()
                       - want).abs().max())
    elem_err = float((cuda_kernels.matern_general(dist, nu).double()
                      - kernels.matern(dist.double(), nu)).abs().max())
    del want, K
    med, times = median_in_turns({
        "assembly": lambda: cuda_kernels.matern_general_assemble(
            P, scale, (nu,)),
        "parent_route": lambda: cuda_kernels.matern_general(
            kernels.pairwise_scaled_distance(P, P, RHO).contiguous(), nu),
        "elementwise": lambda: cuda_kernels.matern_general(dist, nu),
        "plain": lambda: kernels.matern(
            kernels.pairwise_scaled_distance(P, P, RHO), nu),
        "plain_elementwise": lambda: kernels.matern(dist, nu)}, reps=5)
    n = len(pts)
    pair_sample = sample_pair_distances(P, RHO, seed=22)
    asm_bound = general_bound("assembly", n, 2, None, nu, pair_sample)
    flat = dist.reshape(-1)
    sample = flat[torch.randint(0, flat.numel(), (TRIP_SAMPLE,),
                                device=dev)]
    bound_ms, bound_by, term, work = general_bound(
        "elementwise", None, None, None, nu, sample, elements=flat.numel())
    measured = {"max_abs_err": elem_err, "ms": med["elementwise"],
                "plain_ms": med["plain_elementwise"], "bound_ms": bound_ms,
                "bound_by": bound_by}
    measured_asm = {"max_abs_err": asm_err, "ms": med["assembly"],
                    "plain_ms": med["plain"], "bound_ms": asm_bound[0],
                    "bound_by": asm_bound[1],
                    "bound_share": asm_bound[0] / med["assembly"],
                    "parent_route_ms": med["parent_route"],
                    "parent_route_max_abs_err": route_err,
                    "shape": f"K of n = {n} (2-D grid), rho {RHO}, nu {nu}"}
    log(phase="general_dense_api", ok=ok, n=n, rho=RHO, fits=fits,
        launches_per_nu=window, nu_timed=nu, assembly=measured_asm,
        assembly_bound_term=asm_bound[2], assembly_work_per_k=asm_bound[3],
        elementwise_elements=flat.numel(), elementwise=measured,
        elementwise_bound_term=term, elementwise_work_per_k=work,
        ms_all=times)
    if not ok:
        raise AssertionError(f"dense public API at general nu failed: "
                             f"{fits}")
    return window, measured, measured_asm


def phase_general_operator_route(dev):
    """Phase 23: MaternOperator at n = 10^4 random points, nu = 1.2,
    through KrylovProfileLikelihood.fit() (64 steps, 16 probes), in its
    own launch window, against the float64 eigh route on the same K
    assembled by the assembly entry (GaussianProcess 'profiled'). Then
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
    return window, res, (
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
    5e-2, the lp gap logged); the band sums of one of its steps
    (step_band_sums); then main at MAIN_CUTS (one assembly launch at most
    per chunk of lp calls, none of the elementwise entry), its lp at
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

    measured_sum = step_band_sums(dev)

    # main's lp chunks: each a call of assembly.correlations_of_points
    chunk_calls = []
    chunk_assembly = assembly.correlations_of_points

    def counted(*args, **kw):
        chunk_calls.append(len(args[2]))
        return chunk_assembly(*args, **kw)
    assembly.correlations_of_points = counted
    try:
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        small = find_optimal_covariance.main(verbose=False, device=dev,
                                             **MAIN_CUTS)
        main_s = sync_seconds(t0)
    finally:
        assembly.correlations_of_points = chunk_assembly
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
          and 0 < main_window.get("matern_general_assembly", 0)
          <= len(chunk_calls)
          and main_window.get("matern_general_elementwise", 0) == 0
          and measured_sum["same_bits_as_the_product"]
          and measured_sum["max_abs_err"] == 0.0
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
        main_large_step_band_sums=measured_sum,
        main_cuts=MAIN_CUTS, main_seconds=main_s,
        main_lp_chunks=len(chunk_calls), main_lp_chunk_points=chunk_calls,
        main_lp_vs_cpu_f64=main_f64, main_lp_rtol=MAIN_LP_RTOL,
        main={k: small[k] for k in ("max_lp", "optimal_rho", "optimal_nu",
                                    "de_rho", "de_nu", "de_lp",
                                    "de_generations")},
        main_launches=main_window)
    if not ok:
        raise AssertionError(f"(rho, nu) search failed: main_large "
                             f"{large['Lp']}, main {small}")
    return large_window, main_window, measured_sum


def step_band_sums(dev):
    """The band sums of one of main_large's Lanczos steps (n = 10^4, its
    64 (rho, nu) points, r = 16: 13 bands), captured from a batched
    product call: replayed from the first band's rows through the kernel
    they give the product's output bits, as through the plain version;
    the 13 sums timed in turns against the plain ones, beside their byte
    bound. The record's numbers are per launch (a step's over 13)."""
    P = torch.as_tensor(find_optimal_covariance.large_problem(GENERAL_N)[0],
                        dtype=F32, device=dev)
    R, N = np.meshgrid(np.linspace(0.1, 0.3, 8), np.linspace(1, 25, 8),
                       indexing="ij")
    scales = torch.tensor(R.ravel().tolist(), device=dev)
    nus = N.ravel().tolist()
    W = torch.randn((64, GENERAL_N, 16),
                    generator=torch.Generator(device=dev).manual_seed(24),
                    device=dev)
    out, bands = captured_band_sums(
        lambda: cuda_kernels.matern_general_matmat_batched(P, scales, W,
                                                           nus))
    first = bands[0][1]

    def replay(fn):
        o = first.clone()
        for slots, _, args in bands:
            fn(slots, o, *args)
        return o
    kernel = replay(cuda_kernels.general_product_sum)
    plain = replay(cuda_kernels.general_product_sum_plain)
    scratch = first.clone()
    med, times = median_in_turns({
        "kernel": lambda: [cuda_kernels.general_product_sum(
            slots, scratch, *args) for slots, _, args in bands],
        "plain": lambda: [cuda_kernels.general_product_sum_plain(
            slots, scratch, *args) for slots, _, args in bands]}, reps=5)
    nbytes = band_sum_bytes(bands)
    step_bound = nbytes / PEAK_BYTES_PER_S * 1e3
    k = len(bands)
    rec = {"max_abs_err": float((kernel - plain).abs().max()),
           "ms": med["kernel"] / k, "plain_ms": med["plain"] / k,
           "bound_ms": step_bound / k, "bound_by": "bytes",
           "bound_share": step_bound / med["kernel"],
           "same_bits_as_the_product": bool(torch.equal(kernel, out)),
           "bands": k, "step_ms": med["kernel"], "step_plain_ms": med["plain"],
           "step_bound_ms": step_bound, "step_bytes": nbytes,
           "slot_bytes_per_band": 4 * bands[0][0].numel(),
           "step_ms_all": times["kernel"],
           "shape": f"main_large's step: n = {GENERAL_N}, 64 points, r = 16, "
                    f"{k} bands"}
    del bands, out, kernel, plain, scratch, first
    return rec


# -- the rest of the tapered slice (phases 25-28) -----------------------------

G2_COUNTERS = ("matern_blocksparse_general_product",
               "matern_blocksparse_general_trace")
# phase 25's orders, and the scales that put the taper radius (density
# 0.02) 1.6 to 3 scales out, where a threshold clear of every pair by 1e-5
# exists (tests/test_torch_cuda.py)
G2_NUS = (0.3, 1.2, 3.7, 24.9)
# n = 4096 at the tapered path's nu and the longest recurrence only (its
# float64 plain version is the phase's cost; every nu at n = 1000)
G2_NUS_4096 = (1.2, 24.9)
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
    against plain float64 on the card, at n = 1000 random 2-D and 3-D
    points at each nu of G2_NUS and n = 4096 2-D at G2_NUS_4096, at
    thresholds from
    blocksparse_clear_threshold: products (r 1, 7, 24) and traces within
    GENERAL_FROB_TOL and GENERAL_TRACE_RTOL, the trace the same bits twice
    and with and without the taper skip; then a closed-form nu through the
    same entry point launches B3 only."""
    cases, ok = [], True
    for n, d, tile, nus in ((1000, 2, 128, G2_NUS),
                            (4096, 2, 512, G2_NUS_4096),
                            (1000, 3, 128, G2_NUS)):
        for nu in nus:
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
    assembly entry on the card, one launch per block of rows, in a launch
    window of its own), its pattern against the native
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
    csr_window = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
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
    # the blocked rule's blocks of rows, each one assembly launch
    blocks = -(-n16 // taper._tapered_block_rows(
        n16, 2, TAPER_GENERAL_NU, torch.device(dev), F32))
    ok = (ok and csr_window == {"matern_general_assembly": blocks}
          and flipped_near_tau == flipped.nnz
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
                     "launches": csr_window, "row_blocks": blocks,
                     "nnz": int(G.nnz),
                     "tau": tau, "entries_near_tau":
                     general_near_tau},
        native_csr_nu_half={"n": n16, "seconds_host": native16_s,
                            "nnz": int(N.nnz)},
        pattern_entries_differing=int(flipped.nnz),
        differing_near_tau=flipped_near_tau)
    if not ok:
        raise AssertionError(f"the scipy-sparse route failed: {res}, "
                             f"tapered operator {ref}")
    return spmm, csr_window


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


# -- the structured-grid slice (phases 29-33) --------------------------------

# phase 29: the reference's on-chip FFT operator case
# (tests_tpu/test_onchip.py:159-199): a 32 x 32 grid, rho 0.1, nu = 2.2;
# the product against float64 dense K @ V (Frobenius), the fit against the
# float64 spectral answer (eta rtol 0.1, sigma0 1e-2)
FFT_PARITY_SIDE, FFT_PARITY_RHO, FFT_PARITY_NU = 32, 0.1, 2.2
FFT_FROB_TOL = 2e-5
# phase 30: bench.py:383-405's 2^20 fits (grid side 1024, rho 0.005, 48
# steps, 12 probes) at nu 1/2 and 2.2; the FFT product timed at r = 24
FFT_SIDE, FFT_RHO, FFT_NUS = 1024, 0.005, (0.5, 2.2)
FFT_STEPS, FFT_PROBES, FFT_WIDTH = 48, 12, 24
# phase 31: main_fft_grid at its defaults. The committed result of the
# reference's run (a TPU run in float32: a numeric reference, not a speed
# target) fixes the MAP (rho, nu) to find, and its rows are logged beside
# this run's, not bounded: their eta lies 12-72% from this package's at
# the three rows below, which neither the reference's own code in float64
# at the same depth (tests/test_torch_grid_long_lanczos.py, on a 64 x 64
# grid) nor four random blocks at 2^20 (chip_profile.py fft-keys: eta
# within 0.71%) reproduce. Three rows (grid indices (i, j): the smallest
# rho and nu, the middle, the MAP's) are held to float64 engines on the
# card on the same random block with the cuda-vs-reference engine bounds
# of PERF.md's section 2
FFT_GRID_PICKLE = "data/optimal_covariance_fft_n2e20.pickle"
FFT_GRID_F64_ROWS = ((0, 0), (2, 2), (4, 4))
FFT_GRID_ETA_RTOL, FFT_GRID_SIGMA0_RTOL = 5e-2, 5e-3
# phase 32: drivers/sample_posterior.py's main_rho_nu_large configuration
# and its probe points (log10 eta, log10 rho, nu), off the surface's nodes;
# the first two sit in the posterior's bulk
RHO_NU_PICKLE = "data/posterior_rho_nu_n100k.pickle"
RHO_NU_SIDE = 317
RHO_NU_CONFIG = dict(log10_rho_bounds=(-1.2, -0.3), nu_bounds=(1.0, 25.0),
                     num_rho_nodes=9, num_nu_nodes=9, lanczos_steps=48,
                     num_probes=16)
RHO_NU_PROBES = ((1.6, -0.55, 2.0), (1.9, -0.75, 6.0), (1.3, -0.45, 14.0),
                 (0.8, -0.35, 20.0), (2.5, -1.1, 1.2))
RHO_NU_BULK_NATS, RHO_NU_ALL_NATS = 0.5, 10.0
# the float32 surface against float64 nodes on the same random block, the
# largest gap over the 3 x 3 nodes at each log10 eta: 3 nats at log10 eta
# 2 and 3, the reference's own claim (gppe_tpu/models/krylov_posterior.py:
# 538-546, "the eta >= 10 bulk agrees within ~3 nats"); 6 nats at log10
# eta 1, where the float32 Lanczos passes alone put 4.94 nats on an H100
# with float64 tables, 5.02 with the general-nu kernel's (chip_profile.py
# fft-tables), as the reference's own float32 surface misses its float64
# nodes by as much on smaller grids (tests/test_torch_grid_long_lanczos.py)
RHO_NU_F64_NATS = {1.0: 6.0, 2.0: 3.0, 3.0: 3.0}
# phase 33: KrylovPosteriorSurface at the reference's defaults on phase 5's
# points; two routes with the same probes within the reference's envelope
# (tests/test_krylov_posterior.py:156-185)
SURFACE_NODES, SURFACE_STEPS, SURFACE_PROBES = 12, 64, 24
SURFACE_ROUTE_NATS = 0.5
SURFACE_ROUTE_POINTS = ((0.0, -1.2), (1.0, -0.9), (2.0, -0.6))
SURFACE_GENERAL_N, SURFACE_GENERAL_NU = 10_000, 1.2


class plain_general_calls:
    """Counts the calls of the plain general-nu form
    (``kernels._matern_general``, the float64 Bessel k) inside the block:
    a float32 table on the card must take the general-nu kernel instead."""

    def __enter__(self):
        self.count = 0
        self._plain = kernels._matern_general

        def counted(*args, **kw):
            self.count += 1
            return self._plain(*args, **kw)
        kernels._matern_general = counted
        return self

    def __exit__(self, *exc):
        kernels._matern_general = self._plain


def window():
    return {k: v for k, v in cuda_kernels.launch_counts.items() if v}


def phase_grid_fft_parity(dev):
    """Phase 29: GridMaternOperator at n = 1024 (a 32 x 32 grid, rho 0.1,
    nu = 2.2): the float32 operator's table one launch of the general-nu
    kernel's elementwise entry (no plain Bessel k), within 3e-5 of the
    float64 operator's table (the float64 kernels.matern, by the dtype
    rule); matmat of 5 columns within 2e-5 (Frobenius) of float64 dense
    K @ V; KrylovProfileLikelihood over it (48 steps, 16 probes) against
    the float64 spectral answer on the same K (eta rtol 0.1, sigma0
    1e-2)."""
    pts = data_utils.generate_points(FFT_PARITY_SIDE, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    cuda_kernels.reset_launch_counts()
    with plain_general_calls() as plain:
        op = GridMaternOperator(pts, FFT_PARITY_RHO, nu=FFT_PARITY_NU,
                                device=dev)
        torch.cuda.synchronize()
    launches = window()
    op64 = GridMaternOperator(pts, FFT_PARITY_RHO, nu=FFT_PARITY_NU,
                              device=dev, dtype=F64)
    table_gap = float(torch.max(torch.abs(op._k_tab - op64._k_tab)))
    V = torch.as_tensor(np.random.RandomState(4).standard_normal(
        (len(pts), 5)), device=dev)
    K64 = op64.dense()
    frob, max_abs = compare(op.matmat(V.float()), K64 @ V)
    fit = KrylovProfileLikelihood(op, X, z, lanczos_steps=48, num_probes=16,
                                  device=dev).fit()
    data = direct_likelihood.make_spectral_data(
        MixedCorrelation(K64, device=dev), X, z)
    want = profile_likelihood.find_log_likelihood_der1_zeros(data,
                                                             [1e-4, 1e3])
    torch.cuda.synchronize()
    eta_gap = rel_gap(fit["eta"], want["eta"])
    sigma0_gap = rel_gap(fit["sigma0"], want["sigma0"])
    ok = (launches == {"matern_general_elementwise": 1} and plain.count == 0
          and table_gap < cuda_kernels.GENERAL_K_ATOL and frob < FFT_FROB_TOL
          and fit["success"] and eta_gap < 0.1 and sigma0_gap < 1e-2)
    rec = {"n": len(pts), "rho": FFT_PARITY_RHO, "nu": FFT_PARITY_NU,
           "table_max_abs_gap_f32_vs_f64": table_gap,
           "table_bound": cuda_kernels.GENERAL_K_ATOL}
    log(phase="grid_fft_parity", ok=ok, **rec, launches=launches,
        plain_general_calls=plain.count, frob_rel_err=frob,
        max_abs_err=max_abs, frob_tol=FFT_FROB_TOL,
        fit={k: fit[k] for k in ("eta", "sigma", "sigma0", "success")},
        spectral_f64={k: want[k] for k in ("eta", "sigma", "sigma0")},
        eta_rel_gap=eta_gap, sigma0_rel_gap=sigma0_gap)
    if not ok:
        raise AssertionError(f"FFT grid operator parity failed: {rec}")
    return {**rec, "launches": launches}


def fft_product_bound(ms, r):
    """The bound of one FFT product of r columns on a grid of sizes ms:
    bytes V, the output and the spectrum once each (float32, complex64);
    FP32 operations the two real transforms of the padded grid, each
    2.5 N log2 N per column (N = prod 2 m_j)."""
    N = int(np.prod([2 * m for m in ms]))
    spectrum = N // (2 * ms[-1]) * (ms[-1] + 1) * 8
    nbytes = 2 * 4 * int(np.prod(ms)) * r + spectrum
    ops = 2 * 2.5 * N * math.log2(N) * r
    return bound(nbytes, ops), nbytes, ops


def phase_grid_fft_fits(dev):
    """Phase 30: the 2^20 fits (bench.py:383-405) through
    compare_various_num_points.run_krylov(fft=True): grid side 1024, rho
    0.005, nu in {1/2, 2.2}, 48 steps, 12 probes; construction, setup and
    fit seconds (each ended by a synchronise; the construction is the
    data's and the operator's: the host grid geometry, the table, its
    spectrum), eta in (1, 1e3), sigma0 >
    0; each in its own launch window (nu = 2.2: one elementwise launch for
    the table). Then the FFT product at r = 24 against the float64 FFT
    product of the float64 table (Frobenius 2e-5) and timed (median of 7)
    beside its bound (fft_product_bound): cuFFT, a library call."""
    fits, windows = {}, {}
    for nu in FFT_NUS:
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with plain_general_calls() as plain:
            r = compare_various_num_points.run_krylov(
                FFT_SIDE ** 2, noise=0.2, scale=FFT_RHO, nu=nu, grid=True,
                fft=True, lanczos_steps=FFT_STEPS, num_probes=FFT_PROBES,
                device=dev)
        total = sync_seconds(t0)
        windows[nu] = window()
        fits[nu] = {"eta": r["eta"], "sigma": r["sigma"],
                    "sigma0": r["sigma0"], "success": r["success"],
                    "data_and_operator_seconds":
                    total - r["pre_s"] - r["opt_s"],
                    "setup_seconds": r["pre_s"], "fit_seconds": r["opt_s"],
                    "total_seconds": total, "plain_general_calls":
                    plain.count, "peak_device_memory_bytes":
                    torch.cuda.max_memory_allocated(dev)}
    pts = data_utils.generate_points(FFT_SIDE, dimension=2)
    op = GridMaternOperator(pts, FFT_RHO, nu=2.2, device=dev)
    op64 = GridMaternOperator(pts, FFT_RHO, nu=2.2, device=dev, dtype=F64)
    g = torch.Generator(device=dev).manual_seed(30)
    V = torch.randn((len(pts), FFT_WIDTH), generator=g, device=dev)
    frob = compare(op.matmat(V), op64.matmat(V.double()))[0]
    del op64
    med, all_ms = median_in_turns({"fft": lambda: op.matmat(V)})
    (b_ms, b_by, b_term), nbytes, ops = fft_product_bound(op.ms, FFT_WIDTH)
    product = {"n": len(pts), "r": FFT_WIDTH, "ms": med["fft"],
               "ms_all": all_ms["fft"], "bound_ms": b_ms, "bound_by": b_by,
               "bound_term": b_term, "bytes": nbytes, "fp32_ops": ops,
               "bound_share": b_ms / med["fft"],
               "frob_vs_float64": frob}
    del op, V
    torch.cuda.synchronize()
    ok = (all(f["success"] and 1.0 < f["eta"] < 1e3 and f["sigma0"] > 0
              and f["plain_general_calls"] == 0 for f in fits.values())
          and windows[0.5] == {}
          and windows[2.2] == {"matern_general_elementwise": 1}
          and frob < FFT_FROB_TOL)
    log(phase="grid_fft_fits", ok=ok, n=FFT_SIDE ** 2, rho=FFT_RHO,
        lanczos_steps=FFT_STEPS, num_probes=FFT_PROBES,
        fits={str(k): v for k, v in fits.items()},
        launches={str(k): v for k, v in windows.items()},
        fft_product=product)
    if not ok:
        raise AssertionError(f"the 2^20 FFT fits failed: {fits}, {windows}")
    return windows[2.2], product


def phase_fft_grid_search(dev):
    """Phase 31: find_optimal_covariance.main_fft_grid at its defaults
    (n = 2^20, rhos geomspace(0.003, 0.03, 5) x nus (0.5, 1, 2, 4, 8), 48
    steps, 16 probes, the priors on), in a launch window of its own (one
    elementwise launch per general-nu point's table, no other kernel, no
    plain Bessel k); seconds per point; the same MAP (rho, nu) as the
    committed reference result, each of its rows' gaps logged; three rows
    (FFT_GRID_F64_ROWS) against float64 engines (a float64 operator and
    Lanczos pass) on main_fft_grid's random block: eta within 5e-2, sigma0
    within 5e-3, the lp gap logged."""
    import pickle

    with open(FFT_GRID_PICKLE, "rb") as f:
        ref = pickle.load(f)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    with plain_general_calls() as plain:
        res = find_optimal_covariance.main_fft_grid(verbose=False,
                                                    device=dev)
    torch.cuda.synchronize()
    launches = window()
    general = sum(not kernels.is_closed_form(r["nu"]) for r in res["rows"])
    rows = []
    for got, want in zip(res["rows"], ref["rows"]):
        rows.append({"rho": got["rho"], "nu": got["nu"], "eta": got["eta"],
                     "sigma0": got["sigma0"], "lp": got["lp"],
                     "seconds": got["seconds"],
                     "reference_eta": want["eta"],
                     "reference_sigma0": want["sigma0"],
                     "eta_rel_gap_to_reference": rel_gap(got["eta"],
                                                         want["eta"]),
                     "sigma0_rel_gap_to_reference": rel_gap(
                         got["sigma0"], want["sigma0"]),
                     "lp_gap_to_reference": got["lp"] - want["lp"],
                     "same_point": (got["rho"], got["nu"]) == (
                         want["rho"], want["nu"])})

    # float64 engines on main_fft_grid's random block (its engines' own draw)
    pts, z, X = grid_problem(math.isqrt(res["n"]))
    probes, v_defl = stochastic.random_block(len(pts), 16, 0, dev, F32)
    oracle = []
    for i, j in FFT_GRID_F64_ROWS:
        row = rows[i * len(res["nus"]) + j]
        rho, nu = row["rho"], row["nu"]
        eng = KrylovProfileLikelihood(
            GridMaternOperator(pts, rho, nu=nu, device=dev, dtype=F64), X,
            z, lanczos_steps=48, num_probes=16, device=dev, dtype=F64,
            probes=probes.double(), v_defl=v_defl.double())
        fit = eng.fit()
        lp = (eng.log_likelihood(fit["sigma"], fit["eta"])
              + float(inverse_square_log_prior(rho))
              + float(inverse_square_log_prior(nu, scale=25.0))
              if np.isfinite(fit["eta"]) and fit["sigma"] > 0 else -np.inf)
        del eng
        oracle.append({"rho": rho, "nu": nu, "eta": row["eta"],
                       "f64_eta": fit["eta"], "sigma0": row["sigma0"],
                       "f64_sigma0": fit["sigma0"],
                       "eta_rel_gap": rel_gap(row["eta"], fit["eta"]),
                       "sigma0_rel_gap": rel_gap(row["sigma0"],
                                                 fit["sigma0"]),
                       "lp_gap": row["lp"] - lp,
                       "reference_eta_rel_gap_to_f64": rel_gap(
                           row["reference_eta"], fit["eta"])})
    torch.cuda.synchronize()
    lps = sorted((r["lp"] for r in res["rows"]), reverse=True)
    ok = (len(rows) == len(ref["rows"]) == 25
          and all(r["same_point"] for r in rows)
          and all(np.isfinite(r["lp"]) for r in rows)
          and (res["optimal_rho"], res["optimal_nu"]) == (
              ref["optimal_rho"], ref["optimal_nu"])
          and all(o["eta_rel_gap"] < FFT_GRID_ETA_RTOL
                  and o["sigma0_rel_gap"] < FFT_GRID_SIGMA0_RTOL
                  for o in oracle)
          and launches == {"matern_general_elementwise": general}
          and plain.count == 0)
    log(phase="fft_grid_search", ok=ok, n=res["n"], grid=[5, 5],
        lanczos_steps=48, num_probes=16, with_prior=res["with_prior"],
        total_seconds=res["total_seconds"],
        seconds_per_point=res["seconds_per_point"],
        map_rho=res["optimal_rho"], map_nu=res["optimal_nu"],
        max_lp=res["max_lp"], map_margin_nats=lps[0] - lps[1],
        reference_map=[ref["optimal_rho"], ref["optimal_nu"]],
        reference_max_lp=ref["max_lp"], launches=launches,
        plain_general_calls=plain.count, rows_vs_float64=oracle,
        max_eta_rel_gap_to_reference=max(r["eta_rel_gap_to_reference"]
                                         for r in rows),
        max_sigma0_rel_gap_to_reference=max(
            r["sigma0_rel_gap_to_reference"] for r in rows), rows=rows)
    if not ok:
        raise AssertionError(f"main_fft_grid failed: {oracle}, {rows}")
    return launches


def grid_problem(side):
    pts = data_utils.generate_points(side, dimension=2)
    return (pts, data_utils.generate_data(pts, 0.2),
            data_utils.generate_basis_functions(pts, 2))


def phase_rho_nu_surface(dev):
    """Phase 32: KrylovPosteriorSurfaceRhoNu at grid side 317 (n =
    100,489) with main_rho_nu_large's configuration (9 x 9 nodes, log10 rho
    in (-1.2, -0.3), nu in (1, 25), k = 48, 16 probes), float32 nodes: one
    elementwise launch per distinct nu (9) for the tables. Its probe
    cross-validation (drivers/sample_posterior.py:358-440): at each probe
    point a fresh GridMaternOperator engine with independent probes (key
    7), each diff logged beside the reference's; the two bulk probes within
    0.5 nats, every probe within 10. Then a 3 x 3-node surface with
    float64 nodes on the card (no kernel launch: float64 tables) on the
    same random block, compared
    at its 9 nodes (also nodes of the 9 x 9 set) at log10 eta in {1, 2, 3}
    within RHO_NU_F64_NATS (6, 3, 3 nats)."""
    import pickle

    with open(RHO_NU_PICKLE, "rb") as f:
        ref_probes = pickle.load(f)["probe_validation"]
    pts, z, X = grid_problem(RHO_NU_SIDE)
    # one random block for both surfaces (the float32 one takes it
    # rounded), so that their gap is the float32 nodes' alone
    block = dict(zip(("probes", "v_defl"), stochastic.random_block(
        len(pts), RHO_NU_CONFIG["num_probes"], 0, dev, F64)))
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with plain_general_calls() as plain:
        surface = KrylovPosteriorSurfaceRhoNu(pts, z, X, device=dev,
                                              **block, **RHO_NU_CONFIG)
    surface_s = sync_seconds(t0)
    surface_window = window()
    surface_peak = torch.cuda.max_memory_allocated(dev)

    cuda_kernels.reset_launch_counts()
    probes = []
    t0 = time.perf_counter()
    for (le, lr, nu), ref in zip(RHO_NU_PROBES, ref_probes):
        eng = KrylovProfileLikelihood(
            GridMaternOperator(pts, 10.0 ** lr, nu=nu, device=dev), X, z,
            lanczos_steps=RHO_NU_CONFIG["lanczos_steps"],
            num_probes=RHO_NU_CONFIG["num_probes"], key=7, device=dev)
        eta = 10.0 ** le
        lp_ref = float(eng.log_likelihood(eng.find_optimal_sigma(eta), eta))
        lp_surf = float(surface.profile_loglik(le, lr, nu))
        probes.append({"log10_eta": le, "log10_rho": lr, "nu": nu,
                       "lp_surface": lp_surf, "lp_exact_engine": lp_ref,
                       "diff": lp_surf - lp_ref,
                       "reference_diff": ref["diff"]})
    probes_s = sync_seconds(t0)
    probes_window = window()

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_general_calls() as plain64:
        f64 = KrylovPosteriorSurfaceRhoNu(
            pts, z, X, device=dev, node_dtype=F64, **block,
            **{**RHO_NU_CONFIG, "num_rho_nodes": 3, "num_nu_nodes": 3})
    f64_s = sync_seconds(t0)
    f64_window = window()
    node_gaps = []
    # the 3-point Chebyshev-Lobatto nodes are nodes of the 9-point set
    shared_nodes = (set(f64.log10_rho_nodes) <= set(surface.log10_rho_nodes)
                    and set(f64.log_nu_nodes) <= set(surface.log_nu_nodes))
    for lr in f64.log10_rho_nodes:
        for t in f64.log_nu_nodes:
            for le in RHO_NU_F64_NATS:
                a = float(surface.profile_loglik(le, lr, math.exp(t)))
                b = float(f64.profile_loglik(le, lr, math.exp(t)))
                node_gaps.append({"log10_eta": le, "log10_rho": float(lr),
                                  "nu": math.exp(t), "lp_f32": a,
                                  "lp_f64_nodes": b, "gap": a - b})
    torch.cuda.synchronize()
    ok = (surface_window == {"matern_general_elementwise": 9}
          and plain.count == 0 and f64_window == {} and plain64.count > 0
          and shared_nodes
          and probes_window == {"matern_general_elementwise": 5}
          and all(abs(p["diff"]) < RHO_NU_BULK_NATS for p in probes[:2])
          and all(abs(p["diff"]) < RHO_NU_ALL_NATS for p in probes)
          and all(np.isfinite(g["gap"]) for g in node_gaps)
          and all(abs(g["gap"]) < RHO_NU_F64_NATS[g["log10_eta"]]
                  for g in node_gaps))
    log(phase="rho_nu_surface", ok=ok, n=len(pts), **{
        k: v for k, v in RHO_NU_CONFIG.items()}, surface_seconds=surface_s,
        surface_launches=surface_window, plain_general_calls=plain.count,
        peak_device_memory_bytes=surface_peak, probes_seconds=probes_s,
        probes_launches=probes_window, probes=probes,
        f64_nodes={"nodes": [3, 3], "seconds": f64_s,
                   "launches": f64_window,
                   "plain_general_calls": plain64.count},
        f32_vs_f64_node_gaps=node_gaps,
        f64_bound_nats_by_log10_eta=RHO_NU_F64_NATS,
        max_abs_gap_by_log10_eta={le: max(abs(g["gap"]) for g in node_gaps
                                          if g["log10_eta"] == le)
                                  for le in RHO_NU_F64_NATS})
    if not ok:
        raise AssertionError(f"the (rho, nu) surface failed: {probes}")
    return surface_window, probes_window, surface


def surface_gaps(a, b, points):
    return [{"log10_eta": le, "log10_rho": lr,
             "lp": float(a.profile_loglik(le, lr)),
             "lp_other_route": float(b.profile_loglik(le, lr)),
             "gap": float(a.profile_loglik(le, lr))
             - float(b.profile_loglik(le, lr))} for le, lr in points]


def phase_posterior_surface(dev):
    """Phase 33: KrylovPosteriorSurface on phase 5's n = 100,000 random
    points (RandomState(7)), nu = 1/2, the reference's defaults (12 nodes
    over log10 rho in (-1.5, -0.5), k = 64, 24 probes): the multi-rho
    kernel, chunks of nodes under the 3 GiB basis budget; setup seconds,
    launches, and the surface and its gradient under torch.func.vmap over
    256 points (ms). Then route agreement with 4 nodes and one random
    block: at n = 100,000, nu = 1/2, the default route (B2) against
    operator_factory=MaternOperator (B1); at n = 10^4, nu = 1.2, the
    general-nu kernel's batched product and trace against its single
    calls through MaternOperator; within 0.5 nats at three (eta, rho)."""
    pts, z, X = make_problem(N_MAIN, 7)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    surface = KrylovPosteriorSurface(pts, z, X, nu=NU,
                                     num_nodes=SURFACE_NODES,
                                     lanczos_steps=SURFACE_STEPS,
                                     num_probes=SURFACE_PROBES, device=dev)
    setup_s = sync_seconds(t0)
    default_window = window()
    C = X.shape[1] + 2 + SURFACE_PROBES
    chunk = surface._node_chunk(C, torch.float32, SURFACE_CHUNK_BYTES)
    chunks = -(-SURFACE_NODES // chunk)
    g = torch.Generator(device=dev).manual_seed(33)
    thetas = torch.stack([torch.rand(256, generator=g, device=dev,
                                     dtype=F64) * 3.0 - 1.0,
                          torch.rand(256, generator=g, device=dev,
                                     dtype=F64) - 1.5], dim=1)

    def lp(t):
        return surface.profile_loglik(t[0], t[1])

    evaluate = torch.func.vmap(lp)
    gradient = torch.func.vmap(torch.func.grad(lp))
    vals, grads = evaluate(thetas), gradient(thetas)
    eval_ms = statistics.median(timed(lambda: evaluate(thetas), 5))
    grad_ms = statistics.median(timed(lambda: gradient(thetas), 5))
    ok = (default_window == {"matern_matmat_multirho_mma":
                             chunks * SURFACE_STEPS,
                             "matern_matmat_multirho": chunks}
          and bool(torch.isfinite(vals).all())
          and bool(torch.isfinite(grads).all()))

    routes = {}
    for name, n, nu in (("b2_vs_b1", N_MAIN, NU),
                        ("g1_batched_vs_single", SURFACE_GENERAL_N,
                         SURFACE_GENERAL_NU)):
        P, zz, XX = make_problem(n, 7)
        probes, v_defl = stochastic.random_block(n, SURFACE_PROBES, 0, dev,
                                                 F32)
        kw = dict(nu=nu, num_nodes=4, lanczos_steps=SURFACE_STEPS,
                  num_probes=SURFACE_PROBES, probes=probes, v_defl=v_defl,
                  device=dev)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        default = KrylovPosteriorSurface(P, zz, XX, **kw)
        default_s = sync_seconds(t0)
        w_default = window()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        factory = KrylovPosteriorSurface(
            P, zz, XX, operator_factory=lambda rho: MaternOperator(
                P, rho, nu=nu, device=dev), **kw)
        factory_s = sync_seconds(t0)
        w_factory = window()
        gaps = surface_gaps(default, factory, SURFACE_ROUTE_POINTS)
        routes[name] = {"n": n, "nu": nu, "default_seconds": default_s,
                        "factory_seconds": factory_s,
                        "default_launches": w_default,
                        "factory_launches": w_factory, "points": gaps}
        ok = ok and all(abs(c["gap"]) < SURFACE_ROUTE_NATS for c in gaps)
    ok = (ok and routes["b2_vs_b1"]["default_launches"].get(
              "matern_matmat_multirho_mma", 0) > 0
          and routes["b2_vs_b1"]["factory_launches"].get(
              "matern_matmat_mma", 0) == 4 * SURFACE_STEPS
          and routes["g1_batched_vs_single"]["default_launches"].get(
              "matern_general_trace", 0) >= 1
          and routes["g1_batched_vs_single"]["factory_launches"].get(
              "matern_general_trace", 0) == 4)
    log(phase="posterior_surface", ok=ok, n=N_MAIN, nu=NU,
        num_nodes=SURFACE_NODES, lanczos_steps=SURFACE_STEPS,
        num_probes=SURFACE_PROBES, node_chunk=chunk, chunks=chunks,
        setup_seconds=setup_s, launches=default_window,
        vmap_points=256, vmap_eval_ms=eval_ms, vmap_grad_ms=grad_ms,
        routes=routes, route_bound_nats=SURFACE_ROUTE_NATS)
    if not ok:
        raise AssertionError(f"the posterior surface failed: {routes}")
    return (default_window, routes["g1_batched_vs_single"]["default_launches"],
            surface)


# phases 34-36: the HMC posterior slice. Chains and n are the reference's
# (bench.py:261-323, :557-606; drivers/sample_posterior.py:358-371).
# Phase 34 keeps the reference's 50 + 50 (at 20 + 20 its dense chains had
# not met: split R-hat 1.32, which swelled the sd its check is bounded
# by), phase 35 its 100 warmup steps (at 40 + 80 its chains had not met:
# split R-hat 3.9); samples are otherwise cut from the reference's
# (100 + 200, 150 + 200) so that phases 34-36 stay near 180 s on the
# card: a step is 17 vmapped gradients of eager torch, launch-bound
# (chip_profile.py hmc), 0.27-0.57 s on an H100
HMC_CHAINS, HMC_LEAPFROG = 64, 16
ANCHOR_SIDE, ANCHOR_CHAINS = 30, 8
ANCHOR_WARMUP, ANCHOR_SAMPLES = 50, 50            # the reference's
ANCHOR_RUN = (ANCHOR_WARMUP, ANCHOR_SAMPLES)       # this run's (uncut)
ANCHOR_BOX = ((-3.0, 4.0), (-1.5, -0.5))
# the means' gap also within this many Monte Carlo standard errors of the
# difference, sqrt(sd_d^2 / ESS_d + sd_s^2 / ESS_s): at 50 + 50 the gap
# read 0.059 against 3 MCSE = 0.375 and the dense sd 0.828 (H100 80GB
# HBM3, 700 W)
ANCHOR_MCSE = 3.0
LARGE_WARMUP, LARGE_SAMPLES = 100, 200            # the reference's
LARGE_RUN = (100, 100)                            # this run's (cut)
LARGE_BOX = ((-3.0, 3.0), (-1.5, -0.5))
LARGE_RHAT, LARGE_ACCEPT = 1.1, 0.5
RESUME_STEPS = 10
RHO_NU_WARMUP, RHO_NU_SAMPLES = 150, 200          # the reference's
RHO_NU_RUN = (40, 40)                             # this run's (cut)
RHO_NU_ETA_BOX = (0.5, 4.0)
# the committed artifact's moments are a numeric reference (a float32
# surface on a TPU; ROADMAP's watch list: the float32 surface's bias at
# small eta): bounds on moments, not on bits
RHO_NU_ETA_TOL, RHO_NU_RHO_TOL, RHO_NU_ACCEPT = 0.05, 0.1, 0.6


def reduced(run, reference):
    """The phase's cuts of (warmup, samples) from the reference's."""
    return [f"{name} {ref} -> {got}" for name, got, ref in zip(
        ("warmup", "samples"), run, reference) if got != ref]


def in_box(samples, box):
    lo = torch.tensor([b[0] for b in box], dtype=F64, device=samples.device)
    hi = torch.tensor([b[1] for b in box], dtype=F64, device=samples.device)
    return bool(torch.isfinite(samples).all()
                and ((samples > lo) & (samples < hi)).all())


def sample_summary(res, names, seconds):
    """Samples/s, accept rate, step size and the diagnostics (mean, sd,
    quantiles, split R-hat, ESS) of an HMCResult."""
    S, C = res.samples.shape[:2]
    return {"seconds": seconds, "samples_per_second": S * C / seconds,
            "accept_rate_mean": float(res.accept_rate.mean()),
            "step_size_mean": float(res.step_size.mean()),
            "diagnostics": diagnostics.summarize(res.samples, names)}


def vmapped_grad_ms(log_post, state):
    """ms of one vmapped gradient and value of ``log_post`` at the chains'
    final (unconstrained) points: median of 5, synchronised."""
    gv = torch.func.vmap(torch.func.grad_and_value(log_post))
    theta = state["theta"]
    gv(theta)
    return statistics.median(timed(lambda: gv(theta), 5))


def phase_hmc_dense_anchor(dev):
    """Phase 34: bench.py:261-323's anchor. sample_posterior on the dense
    profile likelihood of a 30 x 30 grid (n = 900, noise 0.2, nu = 1/2;
    float64 Cholesky per gradient, plain torch, no hand kernel: its window
    must stay empty), 8 chains, the reference's 50 + 50 steps, in the box
    ((-3, 4), (-1.5, -0.5)); then a KrylovPosteriorSurface of the same
    data (12 nodes over log10 rho in (-1.5, -0.5), k = 64, 24 probes: the
    multi-rho kernel, its launches counted) sampled over the same box and
    budget. Pass: every sample finite and in the box, and |mean log10 eta
    (dense) - mean (surface)| <= the dense samples' sd (the reference's
    moment cross-check) and <= ANCHOR_MCSE Monte Carlo standard errors of
    the difference (each route's sd over the root of its ESS). Logs
    samples/s of both routes and both routes' split R-hat."""
    pts, z, X = grid_problem(ANCHOR_SIDE)
    warmup, samples = ANCHOR_RUN
    budget = dict(num_chains=ANCHOR_CHAINS, num_warmup=warmup,
                  num_samples=samples, key=0)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    dense = hmc.sample_posterior(pts, z, X, nu=NU, support_log10=ANCHOR_BOX,
                                 chunk_steps=25, device=dev, **budget)
    dense_s = sync_seconds(t0)
    dense_window = window()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    surface = KrylovPosteriorSurface(pts, z, X, nu=NU,
                                     log10_rho_bounds=ANCHOR_BOX[1],
                                     device=dev)
    surface_build_s = sync_seconds(t0)
    surface_window = window()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    approx, _ = hmc.sample_posterior_large(
        pts, z, X, nu=NU, surface=surface,
        log10_eta_bounds=ANCHOR_BOX[0], **budget)
    surface_s = sync_seconds(t0)
    sampling_window = window()
    names = ["log10_eta", "log10_rho"]
    d = sample_summary(dense, names, dense_s)
    a = sample_summary(approx, names, surface_s)
    de, ae = d["diagnostics"]["log10_eta"], a["diagnostics"]["log10_eta"]
    gap = abs(de["mean"] - ae["mean"])
    sd = de["std"]
    mcse = math.sqrt(de["std"] ** 2 / de["ess"] + ae["std"] ** 2 / ae["ess"])
    ok = (in_box(dense.samples, ANCHOR_BOX)
          and in_box(approx.samples, ANCHOR_BOX)
          and gap <= sd and gap <= ANCHOR_MCSE * mcse
          and dense_window == {} and sampling_window == {}
          and surface_window.get("matern_matmat_multirho_mma", 0) > 0
          and surface_window.get("matern_matmat_multirho", 0) > 0)
    log(phase="hmc_dense_anchor", ok=ok, n=len(pts), nu=NU,
        box=ANCHOR_BOX, chains=ANCHOR_CHAINS, warmup=warmup,
        samples=samples,
        reduced=reduced(ANCHOR_RUN, (ANCHOR_WARMUP, ANCHOR_SAMPLES)),
        dense=d, dense_launches=dense_window,
        surface=a, surface_build_seconds=surface_build_s,
        surface_launches=surface_window,
        surface_sampling_launches=sampling_window,
        log10_eta_mean_gap=gap, bound_dense_sd=sd,
        bound_mcse=ANCHOR_MCSE * mcse,
        split_rhat_log10_eta={"dense": de["rhat"], "surface": ae["rhat"]})
    if not ok:
        raise AssertionError(f"the dense HMC anchor failed: gap {gap}, sd "
                             f"{sd}, {ANCHOR_MCSE} MCSE {ANCHOR_MCSE * mcse}")
    return surface_window, d["diagnostics"]


def phase_hmc_posterior_large(dev, surface):
    """Phase 35: bench.py:557-606. sample_posterior_large on phase 33's
    surface (n = 100,000 random points, RandomState(7), nu = 1/2, 12
    nodes): 64 chains, 16 leapfrog steps, the box ((-3, 3), (-1.5, -0.5)),
    warmup and samples cut from 100 + 200 (``reduced``). The sampling runs
    no hand kernel (its window must stay empty; the surface's B2 launches
    are phase 33's). Pass: every sample finite and in the box, mean accept
    rate above 0.5, split R-hat under 1.1 on both coordinates. Resume:
    from the run's state, resume_hmc for 20 steps is the unbroken run;
    resume_hmc for 10 steps must equal its first 10 steps, and from that
    state, in memory and through save_hmc_state / load_hmc_state, 10 more
    its last 10, bit for bit (samples, log probs, the generator's state).
    Logs samples/s and ms a vmapped gradient at 64 chains."""
    warmup, samples = LARGE_RUN
    P, z, X = make_problem(N_MAIN, 7)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, _ = hmc.sample_posterior_large(
        P, z, X, num_chains=HMC_CHAINS, num_warmup=warmup,
        num_samples=samples, num_leapfrog=HMC_LEAPFROG, key=0,
        surface=surface, log10_eta_bounds=LARGE_BOX[0])
    seconds = sync_seconds(t0)
    sampling_window = window()
    summary = sample_summary(res, ["log10_eta", "log10_rho"], seconds)
    rhat = diagnostics.split_rhat(res.samples)

    log_post, _ = surface.make_bounded_log_posterior(
        log10_eta_bounds=LARGE_BOX[0])
    grad_ms = vmapped_grad_ms(log_post, res.state())

    def resume(state, steps):
        return hmc.resume_hmc(log_post, state, steps,
                              num_leapfrog=HMC_LEAPFROG, device=dev)
    t0 = time.perf_counter()
    unbroken = resume(res.state(), 2 * RESUME_STEPS)
    first = resume(res.state(), RESUME_STEPS)
    again = resume(first.state(), RESUME_STEPS)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = f"{tmp}/hmc_state.pickle"
        checkpoint.save_hmc_state(first, path)
        loaded = resume(checkpoint.load_hmc_state(path), RESUME_STEPS)
    resume_s = sync_seconds(t0)
    tail = unbroken.samples[RESUME_STEPS:]
    resume_ok = (torch.equal(first.samples, unbroken.samples[:RESUME_STEPS])
                 and torch.equal(again.samples, tail)
                 and torch.equal(loaded.samples, tail)
                 and torch.equal(loaded.log_probs,
                                 unbroken.log_probs[RESUME_STEPS:])
                 and again.final_generator_state
                 == unbroken.final_generator_state
                 and loaded.final_generator_state
                 == unbroken.final_generator_state)
    ok = (in_box(res.samples, LARGE_BOX)
          and summary["accept_rate_mean"] > LARGE_ACCEPT
          and bool(np.all(rhat < LARGE_RHAT)) and sampling_window == {}
          and resume_ok)
    log(phase="hmc_posterior_large", ok=ok, n=N_MAIN, nu=NU,
        chains=HMC_CHAINS, leapfrog=HMC_LEAPFROG, warmup=warmup,
        samples=samples, box=LARGE_BOX,
        reduced=reduced(LARGE_RUN, (LARGE_WARMUP, LARGE_SAMPLES)),
        **summary, split_rhat=rhat.tolist(), bound_rhat=LARGE_RHAT,
        bound_accept=LARGE_ACCEPT, vmapped_grad_ms_64_chains=grad_ms,
        ms_per_step=seconds / (warmup + samples) * 1e3,
        sampling_launches=sampling_window,
        resume={"ok": resume_ok, "steps": RESUME_STEPS,
                "seconds": resume_s})
    if not ok:
        raise AssertionError(f"the large-n HMC phase failed: rhat {rhat}, "
                             f"resume {resume_ok}")
    return sampling_window, summary["diagnostics"], res.state()


def phase_hmc_rho_nu_large(dev, surface):
    """Phase 36: drivers/sample_posterior.py:358-371's main_rho_nu_large
    configuration on phase 32's float32-node surface (a 317 x 317 grid,
    n = 100,489, 9 x 9 nodes): sample_posterior_rho_nu_large, 64 chains,
    16 leapfrog steps, log10 eta in (0.5, 4), the reference's priors,
    warmup and samples cut from 150 + 200 (``reduced``). The sampling runs
    no hand kernel (the surface's elementwise launches are phase 32's).
    Against the committed data/posterior_rho_nu_n100k.pickle (a numeric
    reference only; its wall times are no target): mean log10 eta within
    0.05 of its 0.522, mean log10 rho within 0.1 of its -0.409, the nu
    median inside its interquartile range (7.89, 21.01), mean accept rate
    above 0.6; every coordinate's split R-hat logged. The float32
    surface's bias at small eta (ROADMAP's watch list) is why these bound
    moments, not bits."""
    import pickle

    warmup, samples = RHO_NU_RUN
    with open(RHO_NU_PICKLE, "rb") as f:
        ref = pickle.load(f)["diagnostics"]
    pts, z, X = grid_problem(RHO_NU_SIDE)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, _ = hmc.sample_posterior_rho_nu_large(
        pts, z, X, num_chains=HMC_CHAINS, num_warmup=warmup,
        num_samples=samples, num_leapfrog=HMC_LEAPFROG, key=0,
        surface=surface, log10_eta_bounds=RHO_NU_ETA_BOX)
    seconds = sync_seconds(t0)
    sampling_window = window()
    names = ["log10_eta", "log10_rho", "nu"]
    summary = sample_summary(res, names, seconds)
    got = summary["diagnostics"]
    log_post, _ = surface.make_bounded_log_posterior(
        log10_eta_bounds=RHO_NU_ETA_BOX, log_prior=hmc._reference_prior)
    grad_ms = vmapped_grad_ms(log_post, res.state())
    box = (RHO_NU_ETA_BOX, surface.log10_rho_bounds, surface.nu_bounds)
    checks = {
        "log10_eta_mean": abs(got["log10_eta"]["mean"]
                              - ref["log10_eta"]["mean"]) <= RHO_NU_ETA_TOL,
        "log10_rho_mean": abs(got["log10_rho"]["mean"]
                              - ref["log10_rho"]["mean"]) <= RHO_NU_RHO_TOL,
        "nu_median": ref["nu"]["q25"] < got["nu"]["median"] < ref["nu"][
            "q75"],
        "accept": summary["accept_rate_mean"] > RHO_NU_ACCEPT,
        "in_box": in_box(res.samples, box),
        "no_kernel_launch": sampling_window == {}}
    ok = all(checks.values())
    log(phase="hmc_rho_nu_large", ok=ok, n=len(pts), chains=HMC_CHAINS,
        leapfrog=HMC_LEAPFROG, warmup=warmup, samples=samples,
        log10_eta_box=RHO_NU_ETA_BOX,
        reduced=reduced(RHO_NU_RUN, (RHO_NU_WARMUP, RHO_NU_SAMPLES)),
        **summary, checks=checks,
        artifact={k: {q: ref[k][q] for q in ("mean", "std", "q25", "median",
                                             "q75", "rhat")}
                  for k in names},
        bounds={"log10_eta_mean": RHO_NU_ETA_TOL,
                "log10_rho_mean": RHO_NU_RHO_TOL,
                "nu_median": "inside the artifact's (q25, q75)",
                "accept": RHO_NU_ACCEPT},
        vmapped_grad_ms_64_chains=grad_ms,
        ms_per_step=seconds / (warmup + samples) * 1e3,
        sampling_launches=sampling_window)
    if not ok:
        raise AssertionError(f"the (rho, nu) HMC phase failed: {checks}")
    return sampling_window, res.state()


# phases 37-40: NUTS and the rest of the sample_posterior twin. Chains, n
# and max_depth are the reference's; warmup and samples are cut from the
# reference's (listed as "reduced"). A NUTS leaf is one vmapped gradient
# (12-28 ms at 64 chains on the surfaces, 27-35 ms at 8 chains dense on an
# H100 80GB HBM3 at 700 W, by the machine's host; launch-bound like HMC's),
# and the slowest chain sets a step's leaves: after the reference's warmup,
# whose step size is adapted before the mass matrix is switched in, the
# 64-chain steps on phase 33's surface build 127-255 leaves, 2-3.5 s a step.
# So phase 37 runs NUTS's own warmup from cold on the dense target, and
# phases 38 and 39 continue phases 35's and 36's adapted HMC chains (their
# state is NUTS's resume contract: theta, generator, step size, inverse
# mass) without warmup
NUTS_DEPTH = 8
NUTS_REF = (300, 500)                 # the NUTS samplers' defaults
NUTS_DENSE_RUN = (10, 10)             # this run's (cut)
NUTS_LARGE_RUN = (0, 5)               # this run's (cut; from phase 35)
NUTS_RHO_NU_RUN = (0, 6)              # this run's (cut; from phase 36)
# the resume check's steps: the last of phase 38's samples (cut from 5)
NUTS_RESUME_STEPS = 2
# phase 40: the twin at the golden configuration (n = 900, noise 0.2, the
# entry points' default chains). main's defaults are 400 + 500, main_nu's
# 300 + 400 (its profiled stage takes half of each, rounded down),
# main_profile_rho_nu's 150 + 250. A traced-nu gradient (jacfwd through the
# fixed-trip Bessel loops) takes ~0.4 s (joint, 8 chains) and ~1.1 s
# (eta-profiled, 4 chains), so the nu samplers run the fewest steps their
# results need: main_nu's profiled stage 0 + 1
TWIN_MAIN_REF, TWIN_MAIN_RUN = (400, 500), (3, 3)
TWIN_NU_REF, TWIN_NU_RUN = (300, 400), (1, 2)
TWIN_PROFILE_REF, TWIN_PROFILE_RUN = (150, 250), (0, 1)
# the golden with-prior MAP (examples/FindOptimalCovarianceParameters.py
# :664-666, OptimalCovariance_WithPrior.pickle) and the refinement's
# bounds around it: its second grid's spacing is 0.005 in rho and 0.5 in
# nu, and the committed data/profile_posterior_rho_nu.pickle reached
# (0.17664, 3.0) at log_post 957.7785; the coarse grid is centred on the
# sampled rho median, which must lie within its half-width 0.08
GOLDEN_MAP = {"rho": 0.1767, "nu": 3.034, "log_post": 957.779}
MAP_TOLS = {"rho": 0.005, "nu": 0.5, "log_post": 0.1}
RHO_MEDIAN_TOL = 0.08


def mean_gap_check(got, ref):
    """|mean(got) - mean(ref)| of one coordinate's diagnostics beside the
    ref's sd and ANCHOR_MCSE Monte Carlo standard errors of the
    difference."""
    gap = abs(got["mean"] - ref["mean"])
    mcse = math.sqrt(got["std"] ** 2 / got["ess"]
                     + ref["std"] ** 2 / ref["ess"])
    return gap, ref["std"], ANCHOR_MCSE * mcse


def nuts_summary(res, names, seconds):
    """sample_summary plus NUTS's own: mean tree depth, divergences, the
    leaves (vmapped gradients) and host reads a step, ms a step and a
    leaf."""
    steps = len(res.leaves_per_step)
    leaves = sum(res.leaves_per_step)
    return {**sample_summary(res, names, seconds),
            "mean_tree_depth": float(res.mean_tree_depth.mean()),
            "divergences": float(res.divergences.sum()),
            "leaves_per_step": leaves / steps,
            "leaves_per_step_max": max(res.leaves_per_step),
            "host_reads_per_step": sum(res.host_reads_per_step) / steps,
            "ms_per_step": seconds / steps * 1e3,
            "ms_per_leaf": seconds / leaves * 1e3}


def phase_nuts_dense(dev, hmc_dense):
    """Phase 37: nuts.sample_posterior on phase 34's dense target (a 30 x
    30 grid, n = 900, noise 0.2, nu = 1/2; a float64 Cholesky per
    gradient, no hand kernel: its window must stay empty), the box ((-3,
    4), (-1.5, -0.5)), 8 chains, max_depth 8 (the reference's default),
    warmup and samples cut from 300 + 500 (``reduced``). Pass: every
    sample finite and in the box; |mean log10 eta (NUTS) - phase 34's
    dense HMC mean| within the HMC samples' sd and within ANCHOR_MCSE (3)
    Monte Carlo standard errors of the difference. Logs the mean tree
    depth, leaves and host reads a step, divergences, samples/s."""
    from gppe_tpu_torch.models import nuts

    pts, z, X = grid_problem(ANCHOR_SIDE)
    warmup, samples = NUTS_DENSE_RUN
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = nuts.sample_posterior(pts, z, X, nu=NU, num_chains=ANCHOR_CHAINS,
                                num_warmup=warmup, num_samples=samples,
                                max_depth=NUTS_DEPTH, key=0,
                                support_log10=ANCHOR_BOX, device=dev)
    seconds = sync_seconds(t0)
    sampling_window = window()
    summary = nuts_summary(res, ["log10_eta", "log10_rho"], seconds)
    gap, sd, mcse = mean_gap_check(summary["diagnostics"]["log10_eta"],
                                   hmc_dense["log10_eta"])
    ok = (in_box(res.samples, ANCHOR_BOX) and gap <= sd and gap <= mcse
          and sampling_window == {})
    log(phase="nuts_dense", ok=ok, n=len(pts), nu=NU, box=ANCHOR_BOX,
        chains=ANCHOR_CHAINS, max_depth=NUTS_DEPTH, warmup=warmup,
        samples=samples, reduced=reduced(NUTS_DENSE_RUN, NUTS_REF),
        **summary, log10_eta_mean_gap=gap, bound_hmc_sd=sd,
        bound_mcse=mcse, hmc_log10_eta_mean=hmc_dense["log10_eta"]["mean"],
        sampling_launches=sampling_window)
    if not ok:
        raise AssertionError(f"the dense NUTS phase failed: gap {gap}, sd "
                             f"{sd}, MCSE bound {mcse}")
    return sampling_window


def phase_nuts_posterior_large(dev, surface, hmc_large, hmc_state):
    """Phase 38: nuts.sample_posterior_large on phase 33's surface (n =
    100,000, nu = 1/2, 12 nodes): 64 chains, max_depth 8, the box ((-3,
    3), (-1.5, -0.5)), continuing phase 35's adapted chains through
    ``resume_state`` (no warmup; samples cut from 500, ``reduced``); the
    sampling runs no hand kernel. Pass: every sample finite and in the
    box, mean accept statistic above 0.5, both means within ANCHOR_MCSE (3)
    Monte Carlo standard errors of the difference from phase 35's HMC
    means. Split R-hat is logged beside LARGE_RHAT, not bounded: over this
    run's few samples it read 1.43 / 1.43 (5-6 samples from phase 35's
    state) and 1.08 / 1.13 (20 samples after 30 cold warmup steps), and a
    run long enough to bring it under 1.1 costs minutes. Resume: from the
    state after the run's first S - NUTS_RESUME_STEPS samples,
    resume_nuts (through the sampler's ``resume_state``), in memory and
    through save_hmc_state / load_hmc_state, gives the run's last
    NUTS_RESUME_STEPS samples bit for bit (samples, log probs, the
    generator's state). Logs ms a step and a leaf."""
    from gppe_tpu_torch.models import nuts

    _, samples = NUTS_LARGE_RUN
    k = NUTS_RESUME_STEPS
    P, z, X = make_problem(N_MAIN, 7)

    def sample(state, steps):
        return nuts.sample_posterior_large(
            P, z, X, num_chains=HMC_CHAINS, num_samples=steps,
            max_depth=NUTS_DEPTH, surface=surface,
            log10_eta_bounds=LARGE_BOX[0], resume_state=state)[0]
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sample(hmc_state, samples)
    seconds = sync_seconds(t0)
    sampling_window = window()
    names = ["log10_eta", "log10_rho"]
    summary = nuts_summary(res, names, seconds)
    rhat = diagnostics.split_rhat(res.samples)
    gaps = {c: mean_gap_check(summary["diagnostics"][c], hmc_large[c])
            for c in names}

    t0 = time.perf_counter()
    first = sample(hmc_state, samples - k)
    again = sample(first.state(), k)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = f"{tmp}/nuts_state.pickle"
        checkpoint.save_hmc_state(first, path)
        loaded = sample(checkpoint.load_hmc_state(path), k)
    resume_s = sync_seconds(t0)
    tail = res.samples[samples - k:]
    resume_ok = (torch.equal(first.samples, res.samples[:samples - k])
                 and torch.equal(again.samples, tail)
                 and torch.equal(loaded.samples, tail)
                 and torch.equal(loaded.log_probs,
                                 res.log_probs[samples - k:])
                 and again.final_generator_state == res.final_generator_state
                 and loaded.final_generator_state
                 == res.final_generator_state)
    ok = (in_box(res.samples, LARGE_BOX)
          and summary["accept_rate_mean"] > LARGE_ACCEPT
          and all(gap <= mcse for gap, _, mcse in gaps.values())
          and sampling_window == {} and resume_ok)
    log(phase="nuts_posterior_large", ok=ok, n=N_MAIN, nu=NU,
        chains=HMC_CHAINS, max_depth=NUTS_DEPTH, warmup=0, samples=samples,
        box=LARGE_BOX, start="phase 35's adapted HMC state",
        reduced=reduced(NUTS_LARGE_RUN, NUTS_REF) + [
            f"resume steps 5 -> {k}"], **summary,
        split_rhat=rhat.tolist(), split_rhat_bounded=False,
        phase_35_rhat_bound=LARGE_RHAT, bound_accept=LARGE_ACCEPT,
        hmc_mean_gaps={c: {"gap": g, "hmc_sd": sd, "bound_mcse": m}
                       for c, (g, sd, m) in gaps.items()},
        sampling_launches=sampling_window,
        resume={"ok": resume_ok, "steps": k, "seconds": resume_s})
    if not ok:
        raise AssertionError(f"the large-n NUTS phase failed: rhat {rhat}, "
                             f"gaps {gaps}, resume {resume_ok}")
    return sampling_window


def phase_nuts_rho_nu_large(dev, surface, hmc_state):
    """Phase 39: nuts.sample_posterior_rho_nu_large on phase 32's
    float32-node surface (n = 100,489, 9 x 9 nodes): 64 chains, max_depth
    8, log10 eta in (0.5, 4), the reference's priors, continuing phase
    36's adapted chains through ``resume_state`` (no warmup; samples cut
    from 500, ``reduced``); the sampling runs no hand kernel.
    Phase 36's bounds against the committed
    data/posterior_rho_nu_n100k.pickle: mean log10 eta within 0.05 of its
    0.522, mean log10 rho within 0.1 of its -0.409, the nu median inside
    its interquartile range (7.89, 21.01), mean accept statistic above
    0.6; every coordinate's split R-hat logged."""
    import pickle

    from gppe_tpu_torch.models import nuts

    warmup, samples = NUTS_RHO_NU_RUN
    with open(RHO_NU_PICKLE, "rb") as f:
        ref = pickle.load(f)["diagnostics"]
    pts, z, X = grid_problem(RHO_NU_SIDE)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, _ = nuts.sample_posterior_rho_nu_large(
        pts, z, X, num_chains=HMC_CHAINS, num_samples=samples,
        max_depth=NUTS_DEPTH, surface=surface,
        log10_eta_bounds=RHO_NU_ETA_BOX, resume_state=hmc_state)
    seconds = sync_seconds(t0)
    sampling_window = window()
    names = ["log10_eta", "log10_rho", "nu"]
    summary = nuts_summary(res, names, seconds)
    got = summary["diagnostics"]
    box = (RHO_NU_ETA_BOX, surface.log10_rho_bounds, surface.nu_bounds)
    checks = {
        "log10_eta_mean": abs(got["log10_eta"]["mean"]
                              - ref["log10_eta"]["mean"]) <= RHO_NU_ETA_TOL,
        "log10_rho_mean": abs(got["log10_rho"]["mean"]
                              - ref["log10_rho"]["mean"]) <= RHO_NU_RHO_TOL,
        "nu_median": ref["nu"]["q25"] < got["nu"]["median"] < ref["nu"][
            "q75"],
        "accept": summary["accept_rate_mean"] > RHO_NU_ACCEPT,
        "in_box": in_box(res.samples, box),
        "no_kernel_launch": sampling_window == {}}
    ok = all(checks.values())
    log(phase="nuts_rho_nu_large", ok=ok, n=len(pts), chains=HMC_CHAINS,
        max_depth=NUTS_DEPTH, warmup=warmup, samples=samples,
        log10_eta_box=RHO_NU_ETA_BOX, start="phase 36's adapted HMC state",
        reduced=reduced(NUTS_RHO_NU_RUN, NUTS_REF), **summary,
        checks=checks,
        split_rhat={k: got[k]["rhat"] for k in names},
        artifact={k: {q: ref[k][q] for q in ("mean", "q25", "median", "q75")}
                  for k in names},
        sampling_launches=sampling_window)
    if not ok:
        raise AssertionError(f"the (rho, nu) NUTS phase failed: {checks}")
    return sampling_window


def traced_nu_grad_ms(dev, pts, z, X):
    """ms of one vmapped forward-mode gradient (jacfwd) of main_nu's two
    traced-nu targets at their chains (8 joint, 4 profiled) at the
    samplers' initial points: median of 2, synchronised (the phase's
    samplers have run both targets' operations before)."""
    from gppe_tpu_torch.models import kernel_posterior

    joint, _ = kernel_posterior.make_bounded_log_posterior_nu(
        pts, z, X, log10_bounds=((-3.0, 4.0), (-1.3, -0.3)),
        nu_bounds=(1.0, 25.0), log_prior=hmc._reference_prior, device=dev)
    profiled, _ = kernel_posterior.make_profiled_rho_nu_posterior(
        pts, z, X, log10_eta_bounds=(-3.0, 4.0),
        log10_rho_bounds=(-1.3, -0.3), nu_bounds=(1.0, 25.0),
        log_prior=lambda rho, nu: hmc._reference_prior(None, rho, nu),
        eta_grid=15, golden_iters=12, device=dev)
    out = {}
    for name, target, chains, dim in (("joint", joint, 8, 3),
                                      ("profiled", profiled, 4, 2)):
        gv = hmc._batched(target, "fwd", F64)
        theta = hmc._init_draws(0, chains, dim, dev)[1]
        out[name] = statistics.median(timed(lambda: gv(theta), 2))
    return out


def phase_sample_posterior_twin(dev):
    """Phase 40: the sample_posterior twin at the golden configuration
    (n = 900, noise 0.2, the entry points' default chains), each entry
    point in its own launch window: main(sampler="nuts", use_mesh=False)
    (8 chains, max_depth 8; no hand kernel; the one cold NUTS warmup besides
    phase 37's), main_nu (8 joint chains, 10 leapfrog steps; 4 profiled
    chains at 15 eta grid points and 12 golden steps; then the refinement,
    on the general-nu kernel's assembly entry)
    and main_profile_rho_nu (4 chains, 6 leapfrog steps, the golden grid's
    box; no golden pickle), warmup and samples cut (``reduced``). Pass:
    every sample finite and inside its box; NUTS's divergences and mean
    tree depth present; each refined MAP within 0.005 of rho 0.1767 and
    0.5 of nu 3.034 and its log_post within 0.1 nat of 957.779; each
    sampled rho median, the refinement's seed, within 0.08 of 0.1767. Logs
    the seconds of each stage and the ms a vmapped gradient of both
    traced-nu targets."""
    from gppe_tpu_torch.drivers import sample_posterior as twin

    windows, seconds = {}, {}

    def run(name, fn, **kw):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(verbose=False, device=dev, **kw)
        seconds[name] = sync_seconds(t0)
        windows[name] = window()
        return out

    main_out = run("main_nuts", twin.main, num_points=ANCHOR_SIDE,
                   num_warmup=TWIN_MAIN_RUN[0], num_samples=TWIN_MAIN_RUN[1],
                   use_mesh=False, sampler="nuts")
    nu_out = run("main_nu", twin.main_nu, num_points=ANCHOR_SIDE,
                 num_warmup=TWIN_NU_RUN[0], num_samples=TWIN_NU_RUN[1])
    prof_out = run("main_profile_rho_nu", twin.main_profile_rho_nu,
                   num_points=ANCHOR_SIDE, num_warmup=TWIN_PROFILE_RUN[0],
                   num_samples=TWIN_PROFILE_RUN[1])
    pts, z, X = grid_problem(ANCHOR_SIDE)
    grad_ms = traced_nu_grad_ms(dev, pts, z, X)

    def inside(a, box):
        a = np.asarray(a)
        lo, hi = np.array([b[0] for b in box]), np.array([b[1] for b in box])
        return bool(np.isfinite(a).all() and np.all(a > lo)
                    and np.all(a < hi))

    def map_ok(m):
        return all(abs(m[k] - GOLDEN_MAP[k]) <= MAP_TOLS[k]
                   for k in MAP_TOLS)
    nu_box, rho_box_nu = (1.0, 25.0), (-1.3, -0.3)
    checks = {
        "main_nuts_in_box": inside(main_out["samples"],
                                   ((-3.0, 4.0), (math.log10(0.02),
                                                  math.log10(0.6)))),
        "main_nuts_diagnostics": all(
            np.isfinite(main_out[k]).all() and main_out[k].shape
            == main_out["samples"].shape[1:2]
            for k in ("divergences", "mean_tree_depth")),
        "main_nu_joint_in_box": inside(nu_out["joint_samples"],
                                       ((-3.0, 4.0), rho_box_nu, nu_box)),
        "main_nu_profile_in_box": inside(nu_out["profile_samples"],
                                         (rho_box_nu, nu_box)),
        "main_nu_map": map_ok(nu_out["map_refined"]),
        "main_nu_rho_median": abs(nu_out["profile_rho_median"]
                                  - GOLDEN_MAP["rho"]) <= RHO_MEDIAN_TOL,
        "profile_in_box": inside(prof_out["samples"],
                                 ((-1.0, math.log10(0.3)), nu_box)),
        "profile_map": map_ok(prof_out["map_refined"]),
        "profile_rho_median": abs(prof_out["rho_median"]
                                  - GOLDEN_MAP["rho"]) <= RHO_MEDIAN_TOL,
        "samplers_launch_nothing": windows["main_nuts"] == {}}
    ok = all(checks.values())
    log(phase="sample_posterior_twin", ok=ok, n=len(pts), checks=checks,
        reduced={
            "main_nuts": reduced(TWIN_MAIN_RUN, TWIN_MAIN_REF),
            "main_nu": reduced(TWIN_NU_RUN, TWIN_NU_REF),
            "main_profile_rho_nu": reduced(TWIN_PROFILE_RUN,
                                           TWIN_PROFILE_REF)},
        seconds=seconds,
        stage_seconds={"main_nu": nu_out["wall_seconds"],
                       "main_profile_rho_nu": prof_out["wall_seconds"]},
        traced_nu_grad_ms=grad_ms,
        main_nuts={k: (main_out[k].tolist() if hasattr(main_out[k], "tolist")
                       else main_out[k])
                   for k in ("accept_rate", "divergences", "mean_tree_depth",
                             "posterior_mean_log10_eta",
                             "posterior_mean_log10_rho",
                             "samples_per_second")},
        main_nu={"joint_accept": nu_out["joint_accept"],
                 "joint_mean": nu_out["joint_mean"].tolist(),
                 "profile_accept": nu_out["profile_accept"],
                 "profile_rho_median": nu_out["profile_rho_median"],
                 "profile_nu_median": nu_out["profile_nu_median"],
                 "map_refined": nu_out["map_refined"]},
        main_profile_rho_nu={
            "accept_rate": prof_out["accept_rate"].tolist(),
            "rho_median": prof_out["rho_median"],
            "nu_median": prof_out["nu_median"],
            "map_refined": prof_out["map_refined"],
            "split_rhat": {k: prof_out["diagnostics"][k]["rhat"]
                           for k in ("log10_rho", "nu")}},
        golden_map=GOLDEN_MAP, bounds=MAP_TOLS,
        bound_rho_median=RHO_MEDIAN_TOL, launches=windows)
    if not ok:
        raise AssertionError(f"the sample_posterior twin failed: {checks}")
    return windows


# phases 41-44 and the scaling twin: the multi-device slice
# (gppe_tpu_torch.parallel). The machine has one card, so every rank of a
# mesh shares it: world 1 runs NCCL, larger worlds gloo, whose mesh moves
# each collective's operands through pinned host buffers (its declared
# transport; Mesh.staged_bytes). Every number here is correctness-grade:
# no scaling claim is possible on one card. The ranks are processes that
# parallel.mesh.spawn starts (each imports this script and loads the
# library phase 2 built), and each counts its own launches.
SHARDED_ETA_RTOL = 5e-4     # against phase 5's (23's) single-device eta
# ring against all-gather factorization: the tridiagonals, U and trace(K^2)
# to SCHEDULE_RTOL; G and P, Grams and probe overlaps of single basis
# vectors, to BASIS_RTOL: the two schedules sum each product in another
# float32 order, and the recurrences grow that in the late vectors while
# the coefficients stay put (4.5e-5 and 4.1e-4 against the coefficients'
# 8.1e-6 on an H100 80GB HBM3 at 700 W)
SCHEDULE_RTOL, BASIS_RTOL = 1e-5, 1e-3
SCHEDULE_STABLE = ("a_sd", "b_sd", "U", "a_p", "b_p", "fro2")
STEP_RTOL = 1e-3            # 43's step at world 4 against world 1
STEP_ETAS = (0.3, 3.0, 30.0)
STEP_STEPS = 16             # the reference's profile step default
SAMPLER_RUN = (10, 10)      # 44's HMC (warmup, samples); phase 34: 50 + 50
SAMPLER_NUTS_RUN, SAMPLER_NUTS_DEPTH = (2, 2), 5
SCALING_N = 1 << 14
MESH_DEVICE = "cuda"        # every rank's device: the one card
B1_COUNTERS = ("matern_matmat_mma", "matern_matmat")


def compute_mode():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sharded_fit(mesh, comm, n, nu, steps=STEPS, probes=PROBES):
    """ShardedKrylovProfileLikelihood on make_problem(n, 7), rho RHO, with
    key 0's draws (phase 5's and 23's: both engines draw them from a
    generator seeded 0 on the card), fitted: this rank's fit, launches,
    setup seconds, host-staged bytes and copies, and the factorization."""
    pts, z, X = make_problem(n, 7)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    staged = mesh.staged_bytes, mesh.staged_copies
    t0 = time.perf_counter()
    eng = sharded.ShardedKrylovProfileLikelihood(
        mesh, pts, X, z, RHO, nu=nu, lanczos_steps=steps, num_probes=probes,
        comm=comm)
    setup_s = sync_seconds(t0)
    launches = window()
    return {"fit": eng.fit(), "launches": launches, "setup_seconds": setup_s,
            "staged_bytes": mesh.staged_bytes - staged[0],
            "staged_copies": mesh.staged_copies - staged[1],
            "factorization": eng.factorization}


def world1_rank():
    """Phase 41's rank: world 1, NCCL."""
    mesh = par_mesh.make_mesh(device=MESH_DEVICE)
    return {"backend": mesh.backend, "device": str(mesh.device),
            **sharded_fit(mesh, "ring", N_MAIN, NU)}


def step_inputs():
    pts, z, X = make_problem(N_MAIN, 7)
    probes = np.sign(np.random.RandomState(43).standard_normal(
        (N_MAIN, PROBES)))
    return pts, [RHO, RHO], X, z, probes, np.asarray(STEP_ETAS)


def run_step(mesh):
    step = sharded.build_sharded_profile_step(mesh, nu=NU,
                                              lanczos_steps=STEP_STEPS)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(*step_inputs())
    return {"out": [o.tolist() for o in out],
            "seconds": time.perf_counter() - t0, "launches": window()}


def sampler_runs(mesh):
    """Phase 44's samplers on phase 34's dense target (HMC, then a short
    NUTS run): ``mesh`` None (one process) or a mesh."""
    from gppe_tpu_torch.models import nuts

    pts, z, X = grid_problem(ANCHOR_SIDE)
    dev = torch.device(MESH_DEVICE) if mesh is None else mesh.device
    out = {}
    for name, run in (
            ("hmc", lambda: hmc.sample_posterior(
                pts, z, X, nu=NU, num_chains=ANCHOR_CHAINS,
                num_warmup=SAMPLER_RUN[0], num_samples=SAMPLER_RUN[1], key=0,
                support_log10=ANCHOR_BOX, mesh=mesh, device=dev)),
            ("nuts", lambda: nuts.sample_posterior(
                pts, z, X, nu=NU, num_chains=ANCHOR_CHAINS,
                num_warmup=SAMPLER_NUTS_RUN[0],
                num_samples=SAMPLER_NUTS_RUN[1],
                max_depth=SAMPLER_NUTS_DEPTH, key=0,
                support_log10=ANCHOR_BOX, mesh=mesh, device=dev))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        seconds = sync_seconds(t0)
        out[name] = {"samples": res.samples.cpu().numpy(),
                     "seconds": seconds}
    return out


def multi_rank():
    """Phases 42-44 on one launch of four gloo ranks sharing the card: each
    mesh is made of the launch's first ranks, the others wait."""
    out = {}
    m2 = par_mesh.make_mesh(2, device=MESH_DEVICE)                  # (1, 2)
    if m2 is not None:
        for comm in ("ring", "allgather"):
            out[f"fit_{comm}"] = sharded_fit(m2, comm, N_MAIN, NU)
    dist.barrier()
    m1 = par_mesh.make_mesh(1, device=MESH_DEVICE)
    m22 = par_mesh.make_mesh(4, probe=2, device=MESH_DEVICE)
    if m1 is not None:
        out["step_world1"] = run_step(m1)
    dist.barrier()
    out["step_world4"] = run_step(m22)
    if m2 is not None:
        out["general"] = sharded_fit(m2, "ring", GENERAL_N, GENERAL_NU,
                                     GENERAL_STEPS, GENERAL_PROBES)
    dist.barrier()
    m2p = par_mesh.make_mesh(2, probe=2, device=MESH_DEVICE)        # (2, 1)
    if m2p is not None:
        out["samplers"] = sampler_runs(m2p)
    return out


def summed(windows):
    """The launches of a path's ranks, summed counter by counter."""
    total = {}
    for w in windows:
        for k, v in w.items():
            total[k] = total.get(k, 0) + v
    return total


def fit_gaps(fit, want):
    return {k: rel_gap(fit[k], want[k]) for k in ("eta", "sigma0")}


def factorization_gaps(a, b):
    """Each output's largest gap relative to its largest magnitude."""
    return {k: float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k])))
                     / max(float(np.max(np.abs(np.asarray(b[k])))), 1e-300))
            for k in b}


def phase_sharded_world1(main_fit):
    """Phase 41: ShardedKrylovProfileLikelihood on one NCCL rank at phase
    5's configuration (n = 100,000, nu 1/2, rho 0.1, 64 steps, 16 probes,
    phase 5's draws): eta and sigma0 within SHARDED_ETA_RTOL of phase 5's
    fit; its window's launches (64 products on matern_matmat_mma, the
    square trace on matern_matmat: one block, no rectangle)."""
    mode = compute_mode()
    t0 = time.perf_counter()
    r = par_mesh.spawn(world1_rank, 1, "nccl")[0]
    wall = time.perf_counter() - t0
    gaps = fit_gaps(r["fit"], main_fit)
    ok = (r["fit"]["success"] and r["backend"] == "nccl"
          and max(gaps.values()) < SHARDED_ETA_RTOL
          and r["launches"].get("matern_matmat_mma", 0) == STEPS
          and r["launches"].get("matern_matmat", 0) == 1)
    log(phase="sharded_world1_nccl", ok=ok, compute_mode=mode, n=N_MAIN,
        backend=r["backend"], device=r["device"], fit=r["fit"],
        phase5_fit=main_fit, rel_gaps=gaps, bound=SHARDED_ETA_RTOL,
        setup_seconds=r["setup_seconds"], launch_wall_seconds=wall,
        launches=r["launches"])
    if not ok:
        raise AssertionError(f"phase 41: the world-1 sharded fit {r['fit']} "
                             f"against phase 5's {main_fit}: {gaps}")
    return mode, r["launches"]


def phase_sharded_multi(main_fit, general_fit):
    """Phases 42-44 from one launch of four gloo ranks on the card."""
    t0 = time.perf_counter()
    ranks = par_mesh.spawn(multi_rank, 4, "gloo")
    wall = time.perf_counter() - t0
    windows = {}

    # 42: world 2, mesh (1, 2), ring and all-gather at phase 5's size
    pair = [r for r in ranks if "fit_ring" in r]
    fits = {comm: [r[f"fit_{comm}"] for r in pair]
            for comm in ("ring", "allgather")}
    gaps = {comm: [fit_gaps(f["fit"], main_fit) for f in fs]
            for comm, fs in fits.items()}
    schedules = factorization_gaps(fits["ring"][0]["factorization"],
                                   fits["allgather"][0]["factorization"])
    for comm, fs in fits.items():
        windows[f"sharded_world2_{comm}"] = summed(f["launches"] for f in fs)
    ok = (len(pair) == 2
          and all(f["fit"]["success"] for fs in fits.values() for f in fs)
          and max(v for gs in gaps.values() for g in gs
                  for v in g.values()) < SHARDED_ETA_RTOL
          and all(v < (SCHEDULE_RTOL if k in SCHEDULE_STABLE else BASIS_RTOL)
                  for k, v in schedules.items())
          and all(windows[f"sharded_world2_{c}"].get(k, 0) > 0
                  for c in fits for k in B1_COUNTERS))
    log(phase="sharded_world2_gloo", ok=ok, n=N_MAIN, mesh=[1, 2],
        fits={c: [f["fit"] for f in fs] for c, fs in fits.items()},
        rel_gaps_to_phase5=gaps, bound=SHARDED_ETA_RTOL,
        schedule_gaps=schedules,
        schedule_bounds={k: SCHEDULE_RTOL if k in SCHEDULE_STABLE
                         else BASIS_RTOL for k in schedules},
        setup_seconds={c: [f["setup_seconds"] for f in fs]
                       for c, fs in fits.items()},
        staged_bytes={c: [f["staged_bytes"] for f in fs]
                      for c, fs in fits.items()},
        staged_copies={c: [f["staged_copies"] for f in fs]
                       for c, fs in fits.items()},
        staged_bytes_a_step={c: [f["staged_bytes"] / STEPS for f in fs]
                             for c, fs in fits.items()},
        transport="pinned host copies (gloo)", grade="correctness",
        launches=windows, launch_wall_seconds=wall)
    if not ok:
        raise AssertionError(f"phase 42 failed: {gaps}, {schedules}")

    # 43: the profile step at world 4 (2, 2) against world 1; G1 at world 2
    one = next(r["step_world1"] for r in ranks if "step_world1" in r)
    four = [r["step_world4"] for r in ranks]
    step_gaps = []
    for got in (f["out"] for f in four):
        d1, ti, ld = (np.asarray(a) for a in got)
        w1, wt, wl = (np.asarray(a) for a in one["out"])
        step_gaps.append({
            # der1 is a difference of terms the size of traceinv
            "der1": float(np.max(np.abs(d1 - w1) / np.abs(wt))),
            "traceinv": float(np.max(np.abs(ti - wt) / np.abs(wt))),
            "logdet": float(np.max(np.abs(ld - wl) / np.abs(wl)))})
    windows["sharded_world4_step"] = summed(f["launches"] for f in four)
    general = [r["general"] for r in ranks if "general" in r]
    g_gaps = [fit_gaps(g["fit"], general_fit) for g in general]
    windows["sharded_world2_nu1.2"] = summed(g["launches"] for g in general)
    ranks_equal = all(f["out"] == four[0]["out"] for f in four)
    # the step computes no trace(K^2): B1's product only
    ok = (all(max(g.values()) < STEP_RTOL for g in step_gaps) and ranks_equal
          and windows["sharded_world4_step"].get("matern_matmat_mma", 0) > 0
          and len(general) == 2 and all(g["fit"]["success"] for g in general)
          and max(v for g in g_gaps for v in g.values()) < SHARDED_ETA_RTOL
          and windows["sharded_world2_nu1.2"].get(
              "matern_general_product", 0) > 0
          and windows["sharded_world2_nu1.2"].get(
              "matern_general_trace", 0) > 0
          and not any(windows["sharded_world2_nu1.2"].get(k, 0)
                      for k in CLOSED_FORM_COUNTERS))
    log(phase="sharded_world4_probe_axis", ok=ok, n=N_MAIN, mesh=[2, 2],
        lanczos_steps=STEP_STEPS, etas=STEP_ETAS, world1=one["out"],
        world4=four[0]["out"], rel_gaps=step_gaps, bound=STEP_RTOL,
        every_rank_the_same_result=ranks_equal,
        step_seconds={"world1": one["seconds"],
                      "world4": [f["seconds"] for f in four]},
        general={"n": GENERAL_N, "nu": GENERAL_NU, "mesh": [1, 2],
                 "fits": [g["fit"] for g in general],
                 "phase23_fit": general_fit, "rel_gaps": g_gaps,
                 "bound": SHARDED_ETA_RTOL,
                 "setup_seconds": [g["setup_seconds"] for g in general]},
        launches={k: windows[k] for k in ("sharded_world4_step",
                                          "sharded_world2_nu1.2")})
    if not ok:
        raise AssertionError(f"phase 43 failed: {step_gaps}, {g_gaps}")

    # 44: the samplers' mesh= on 2 ranks against one process
    runs = [r["samplers"] for r in ranks if "samplers" in r]
    single = sampler_runs(None)
    names = ["log10_eta", "log10_rho"]
    same = all(np.array_equal(r[s]["samples"], runs[0][s]["samples"])
               for r in runs for s in ("hmc", "nuts"))
    sharded_d = diagnostics.summarize(torch.as_tensor(
        runs[0]["hmc"]["samples"]), names)
    single_d = diagnostics.summarize(torch.as_tensor(
        single["hmc"]["samples"]), names)
    checks = {k: mean_gap_check(sharded_d[k], single_d[k]) for k in names}
    ok = (len(runs) == 2 and same
          and all(in_box(torch.as_tensor(r[s]["samples"]), ANCHOR_BOX)
                  for r in runs for s in ("hmc", "nuts"))
          and all(gap <= mcse for gap, _, mcse in checks.values()))
    log(phase="sharded_samplers", ok=ok, n=ANCHOR_SIDE ** 2, mesh=[2, 1],
        chains=ANCHOR_CHAINS, hmc_run=SAMPLER_RUN,
        reduced=reduced(SAMPLER_RUN, ANCHOR_RUN),
        nuts_run=SAMPLER_NUTS_RUN, nuts_max_depth=SAMPLER_NUTS_DEPTH,
        every_rank_the_same_result=same,
        mean_gaps={k: {"gap": g, "bound_3_mcse": m}
                   for k, (g, _, m) in checks.items()},
        sharded_bits_equal_single=all(
            np.array_equal(runs[0][s]["samples"], single[s]["samples"])
            for s in ("hmc", "nuts")),
        seconds={"mesh": {s: [r[s]["seconds"] for r in runs]
                          for s in ("hmc", "nuts")},
                 "single": {s: single[s]["seconds"] for s in ("hmc", "nuts")}})
    if not ok:
        raise AssertionError(f"phase 44 failed: same {same}, {checks}")
    return windows


def phase_scaling_twin():
    """The scaling twin's main at 1, 2 and 4 ranks on the card (n = 2^14):
    graded correctness (the ranks share one card); the step's traceinv at
    2 ranks within STEP_RTOL of 1 rank's (the same 8 probes; the 4-rank
    mesh, probe extent 2, draws 16, as the reference's twin does)."""
    t0 = time.perf_counter()
    out = scaling_efficiency.main(n=SCALING_N, device=MESH_DEVICE)
    wall = time.perf_counter() - t0
    base = np.asarray(out[1]["traceinv"])
    gaps = {nd: float(np.max(np.abs(np.asarray(out[nd]["traceinv"]) - base)
                             / np.abs(base)))
            for nd in scaling_efficiency.DEVICE_COUNTS}
    ok = out["grade"] == "correctness" and gaps[2] < STEP_RTOL
    log(phase="scaling_twin", ok=ok, n=SCALING_N, grade=out["grade"],
        backend=out["backend"],
        per_world={nd: {k: out[nd][k] for k in ("seconds", "efficiency")}
                   for nd in scaling_efficiency.DEVICE_COUNTS},
        traceinv_gaps_to_world1=gaps, wall_seconds=wall)
    if not ok:
        raise AssertionError(f"the scaling twin failed: {out}")


def rect_trace_time(dev):
    """B1's trace on the rectangular walk at phase 42's shape (a world-2
    ring block: 50,000 rows against 100,000 columns), against its plain
    float64 version, timed beside its bound (every pair: no symmetry)."""
    pts, _, _ = make_problem(N_MAIN, 7)
    P = torch.as_tensor(pts, dtype=F32, device=dev)
    rows = P[:N_MAIN // 2]
    scale = kernels.broadcast_scale(RHO, 2, dtype=F32, device=dev)
    kern = lambda: cuda_kernels.matern_matmat(  # noqa: E731
        rows, scale, None, NU, points_cols=P, frobenius=True)[1]
    got = float(kern())
    want = float(cuda_kernels.matern_matmat_plain(
        rows.double(), scale.double(), None, NU, points_cols=P.double(),
        frobenius=True, block_rows=1024)[1])
    med, times = median_in_turns({"kernel": kern})
    pairs = rows.shape[0] * N_MAIN
    bound_ms, bound_by, term = bound(
        4 * (rows.shape[0] + N_MAIN) * 2 + 8, pairs * (3 * 2 + nu_ops(NU) + 2),
        mufu_ops=pairs * nu_mufu(NU))
    rel = abs(got - want) / want
    ok = rel < DENSE_TRACE_RTOL
    rec = {"shape": [rows.shape[0], N_MAIN], "ms": med["kernel"],
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_term": term,
           "rel_err_vs_f64": rel, "max_abs_err": abs(got - want)}
    log(phase="rect_trace_time", ok=ok, **rec, ms_all=times["kernel"])
    if not ok:
        raise AssertionError(f"the rectangular trace disagrees: {rel}")
    return rec


# -- the last slice: drivers and utilities (phases 45-48) --------------------

NOISE_RATIO_BOUNDS = {"sigma0": (0.7, 1.3), "gcv_sigma0": (0.6, 1.4)}
NOISE_TOP_LEVELS = 20       # the highest levels the claim averages over
DER1_SIDE = 30              # plot_log_likelihood_der1's default grid
DER1_ETA_RTOL = 1e-3        # its eta against GaussianProcess's profiled fit
MATERN_GAUSS_BOUND = 0.02   # the reference's max |k_25 - k_gauss| (:93-96)
TIMER_EVENT_RTOL = 0.05     # phase_timer against CUDA events
B2_KERNEL = "multirho_mma_kernel"


def phase_grid_chunk_profile(dev):
    """Phase 45: drivers.profile_grid_chunk.main at its defaults (n =
    100,000, B = 8 rhos, k = 40, C = 16): the Lanczos with and without
    reorthogonalisation and the full chunk, each timed once after a
    two-step warm chunk; every product one launch of B2's tensor-core
    kernel, every chunk one trace launch; each derived cost finite and
    not negative, the full chunk at least the base Lanczos."""
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = profile_grid_chunk.main(verbose=False, device=dev)
    wall = sync_seconds(t0)
    launches = window()
    k = out["k"]
    want = {"matern_matmat_multirho_mma": 2 + 3 * k,
            "matern_matmat_multirho": 2}
    derived_ok = all(np.isfinite(v) and v >= 0
                     for v in out["derived"].values())
    ok = (derived_ok and launches == want and out["full_factorize_chunk"]
          >= out["lanczos_ps_True_reorth_True"])
    log(phase="grid_chunk_profile", ok=ok,
        **{key: v for key, v in out.items() if key != "launches"},
        launches=launches, launches_expected=want, wall_seconds=wall)
    if not ok:
        raise AssertionError(f"the grid-chunk profile failed: {out}, "
                             f"launches {launches}")
    return launches


def phase_noise_level(dev):
    """Phase 46: drivers.compare_various_noise_level.main at its defaults
    (a 30 x 30 grid, 200 levels in logspace(-2, 1), the four basis
    families; BASELINE config 4): one float32 K and one float64 eigh on
    the card a family, the 200 data vectors rotated in one product, one
    vectorised Chandrupatla, GCV a level. The reference's test claim on
    the 20 highest levels of each family: mean sigma0 / noise in (0.7,
    1.3), mean gcv_sigma0 / noise in (0.6, 1.4). No hand kernel (nu = 1/2:
    a closed form in plain PyTorch)."""
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = compare_various_noise_level.main(verbose=False, device=dev)
    wall = sync_seconds(t0)
    launches = window()
    ratios, counts = {}, {}
    for fam, r in res.items():
        top = slice(-NOISE_TOP_LEVELS, None)
        ratios[fam] = {key: float(np.nanmean(r[key][top]
                                             / r["noise_levels"][top]))
                       for key in NOISE_RATIO_BOUNDS}
        counts[fam] = {"root": int(np.sum(np.isfinite(r["eta"])
                                          & (r["eta"] > 0))),
                       "eta_inf": int(np.sum(np.isinf(r["eta"]))),
                       "eta_zero": int(np.sum(r["eta"] == 0))}
    finite = all(np.all(np.isfinite(r[key])) for r in res.values()
                 for key in ("sigma", "sigma0", "gcv_sigma0"))
    ok = (finite and set(res) == {name for name, _ in
                                  compare_various_noise_level.FAMILIES}
          and all(lo < ratios[fam][key] < hi for fam in ratios
                  for key, (lo, hi) in NOISE_RATIO_BOUNDS.items()))
    log(phase="noise_level", ok=ok, num_points=30, num_levels=200,
        families=list(res), ratios_top20=ratios, bounds=NOISE_RATIO_BOUNDS,
        lanes=counts, launches=launches, wall_seconds=wall,
        seconds_per_family=wall / len(res))
    if not ok:
        raise AssertionError(f"the noise-level sweep failed: {ratios}")
    return launches


def a15_plots(dev):
    """Each plot=True path once, at small sizes, into the working
    directory: the files written."""
    pts = data_utils.generate_points(DER1_SIDE, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    K = assembly.generate_correlation(pts, 0.1, nu=0.5, plot=True, device=dev)
    for method in ("direct", "profiled"):
        gppe_tpu_torch.GaussianProcess(X, K, method, device=dev).train(
            z, plot=True)
        os.replace("log_likelihood.svg" if method == "direct" else
                   "log_likelihood_first_derivative.svg",
                   f"train_{method}.svg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the switch to 'slq'
        gppe_tpu_torch.GaussianProcess(
            X, MaternOperator(pts, 0.1, nu=0.5, device=dev), "profiled",
            device=dev, lanczos_steps=32, num_probes=8).train(z, plot=True)
    os.replace("log_likelihood_first_derivative.svg", "train_operator.svg")
    find_optimal_covariance.main(num_points=10, grid_rho=5, grid_nu=4,
                                 run_de=False, plot=True, verbose=False,
                                 device=dev)
    compare_various_num_points.plot_results(
        {"dense": [{"n": n, "derivative": {"pre_s": 0.01 * n / 529,
                                           "opt_s": 0.01},
                    "direct": {"opt_s": 0.02}} for n in (529, 1024)]},
        reference_rows=compare_various_num_points.DENSE_REFERENCE_TOTALS)
    plot_matern_kernel.main(device=dev)
    plot_log_likelihood_der1.main(DER1_SIDE, verbose=False, plot=True,
                                  device=dev)
    return sorted(os.listdir("."))


def phase_plots(dev):
    """Phase 47: plot_log_likelihood_der1.main on a 30 x 30 grid (K on the
    card, float64 eigh there), its eta within 1e-3 of GaussianProcess's
    profiled fit on the same data; plot_matern_kernel.main(test=True)
    under 0.02; the derivative plot's numbers (no matplotlib needed); and,
    where matplotlib is installed, each plot=True path once into a
    temporary directory."""
    from gppe_tpu_torch.utils import plot as plot_utils

    t0 = time.perf_counter()
    got = plot_log_likelihood_der1.main(DER1_SIDE, verbose=False, plot=False,
                                        device=dev)
    pts = data_utils.generate_points(DER1_SIDE, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    K = assembly.generate_correlation(pts, 0.1, nu=0.5, device=dev)
    want = gppe_tpu_torch.GaussianProcess(X, K, "profiled",
                                          device=dev).train(z)
    eta_gap = rel_gap(got["eta"], want["eta"])
    matern_gap = plot_matern_kernel.main(test=True, device=dev)
    data = direct_likelihood.make_spectral_data(
        MixedCorrelation(K, device=dev), X, z)
    curves = plot_utils.der1_eta_curves(data, K, X, z, got["eta"])
    curves_ok = all(np.all(np.isfinite(v)) for key, v in curves.items()
                    if not key.startswith("roots"))
    installed = importlib.util.find_spec("matplotlib") is not None
    files = None
    if installed:
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory(prefix="gppe_plots_") as tmp:
            os.chdir(tmp)
            try:
                files = a15_plots(dev)
            finally:
                os.chdir(cwd)
    want_files = sorted([
        "matrix.svg", "train_direct.svg", "train_profiled.svg",
        "train_operator.svg", "optimal_covariance_without_prior.svg",
        "various_number_of_points.svg", "matern_kernel.svg",
        "log_likelihood_first_derivative.svg"])
    ok = (eta_gap < DER1_ETA_RTOL and matern_gap < MATERN_GAUSS_BOUND
          and curves_ok and (not installed or files == want_files))
    log(phase="plots", ok=ok, matplotlib_installed=installed,
        der1_fit={k: got[k] for k in ("eta", "sigma", "sigma0")},
        gaussian_process_fit={k: want[k] for k in ("eta", "sigma",
                                                    "sigma0")},
        eta_rel_gap=eta_gap, eta_rtol=DER1_ETA_RTOL,
        matern_k25_gauss_gap=matern_gap, matern_bound=MATERN_GAUSS_BOUND,
        der1_curves_finite=curves_ok, files=files,
        seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"the plot phase failed: eta gap {eta_gap}, "
                             f"matern gap {matern_gap}, files {files}")


def phase_timing(dev):
    """Phase 48: utils.timing on the card. phase_timer around phase 45's
    full chunk (n = 100,000, B = 8, k = 40) against CUDA events recorded
    inside the same window, within 5%; device_trace around one B2 launch
    at phase 45's shape writes a Chrome trace whose key_averages() names
    the kernel with device time."""
    from gppe_tpu_torch.models.grid_krylov import _factorize_chunk_matrixfree
    from gppe_tpu_torch.utils import timing

    pts, AB, rhos, s = profile_grid_chunk.problem(N_MAIN, 8, 8)
    P = torch.as_tensor(pts, dtype=F32, device=dev).contiguous()
    R = torch.as_tensor(rhos, dtype=F32, device=dev)
    A = torch.as_tensor(AB, dtype=F32, device=dev)
    k = 40
    results = {}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cuda_kernels.reset_launch_counts()
    with timing.phase_timer("full_factorize_chunk", results, device=dev):
        start.record()
        factors = _factorize_chunk_matrixfree(P, R, 0.5, A, k, s, 512)
        stop.record()
    [f.cpu() for f in factors]
    events_s = start.elapsed_time(stop) / 1e3
    timer_s = results["full_factorize_chunk"]
    launches = window()
    gap = abs(timer_s - events_s) / events_s
    V = torch.randn((8, N_MAIN, 16), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    with tempfile.TemporaryDirectory(prefix="gppe_trace_") as tmp:
        with timing.device_trace(tmp, device=dev) as prof:
            cuda_kernels.matern_matmat_multirho(P, R, V, 0.5)
        trace_bytes = os.path.getsize(prof.trace_path)
    kernels_seen = {e.key: e.device_time_total / 1e3
                    for e in prof.key_averages() if e.device_time_total > 0}
    named = {key: ms for key, ms in kernels_seen.items() if B2_KERNEL in key}
    ok = (gap < TIMER_EVENT_RTOL and bool(named) and trace_bytes > 0
          and launches == {"matern_matmat_multirho_mma": k,
                           "matern_matmat_multirho": 1})
    log(phase="timing", ok=ok, phase_timer_seconds=timer_s,
        cuda_event_seconds=events_s, rel_gap=gap, rtol=TIMER_EVENT_RTOL,
        launches=launches, trace_bytes=trace_bytes,
        trace_device_ms=named, trace_kernels=sorted(kernels_seen))
    if not ok:
        raise AssertionError(f"the timing phase failed: gap {gap}, "
                             f"kernels {sorted(kernels_seen)}")


def kernel_record(name, source, replaces, launches, measured,
                  launches_public_api=None, launches_per_path=None):
    """``launches``: the kernel's count on its path's run (phase 5, 10, 12,
    15, 16 or 17), or for the general-nu kernel the sum over the paths of
    ``launches_per_path`` (phases 22-24, each path's count from its own
    window); ``launches_public_api``, for B1: its count in phase 20's two
    windows, the public API's operator-route fit and its
    likelihood(z, hp); for B1 ``launches_per_path`` holds the sharded
    paths of phases 41-43, each the sum over its ranks."""
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
    launches_22, measured_elem, measured_asm = phase_general_dense_api(dev)
    launches_23, general_fit, (measured_prod, measured_gtrace) = \
        phase_general_operator_route(dev)
    launches_large, launches_main, measured_sum = phase_general_search(dev)
    phase_g2_parity(dev)
    launches_csr = phase_sparse_route(dev)[1]
    small_fit, launches_27 = phase_tapered_general_engine(dev)
    launches_28, (measured_g2, measured_g2_trace) = \
        phase_tapered_general_path(dev, small_fit)
    fft_parity = phase_grid_fft_parity(dev)
    launches_fft_fit, fft_product = phase_grid_fft_fits(dev)
    launches_fft_grid = phase_fft_grid_search(dev)
    launches_rho_nu, launches_probes, rho_nu_surface = \
        phase_rho_nu_surface(dev)
    launches_surface, launches_surface_general, large_surface = \
        phase_posterior_surface(dev)
    launches_anchor, hmc_dense = phase_hmc_dense_anchor(dev)
    launches_hmc_large, hmc_large, hmc_large_state = \
        phase_hmc_posterior_large(dev, large_surface)
    launches_hmc_rho_nu, hmc_rho_nu_state = phase_hmc_rho_nu_large(
        dev, rho_nu_surface)
    phase_nuts_dense(dev, hmc_dense)
    launches_nuts_large = phase_nuts_posterior_large(
        dev, large_surface, hmc_large, hmc_large_state)
    launches_nuts_rho_nu = phase_nuts_rho_nu_large(dev, rho_nu_surface,
                                                   hmc_rho_nu_state)
    del large_surface, rho_nu_surface
    launches_twin = phase_sample_posterior_twin(dev)
    mode, launches_41 = phase_sharded_world1(main_fit)
    sharded_windows = {"sharded_world1_nccl": launches_41}
    if mode == "Default":
        sharded_windows.update(phase_sharded_multi(main_fit, general_fit))
        phase_scaling_twin()
    else:
        # ranks cannot share an exclusive card: the CPU tests carry the
        # multi-rank parity
        log(phase="sharded_multi_rank", ok=True, skipped=True,
            compute_mode=mode)
    rect_trace = rect_trace_time(dev)
    t_last = time.perf_counter()
    launches_chunk = phase_grid_chunk_profile(dev)
    phase_noise_level(dev)
    phase_plots(dev)
    phase_timing(dev)
    log(phase="last_slice", ok=True, phases=[45, 46, 47, 48],
        seconds=time.perf_counter() - t_last)
    # each path's window, reset just before it; the entries each launches
    windows = {**{f"dense_api_nu{nu}": w for nu, w in launches_22.items()},
               "operator_route": launches_23, "main_large": launches_large,
               "main": launches_main, "general_csr_2e16": launches_csr,
               "grid_fft_operator_1024": fft_parity["launches"],
               "fft_fit_2e20_nu2.2": launches_fft_fit,
               "main_fft_grid": launches_fft_grid,
               "rho_nu_surface": launches_rho_nu,
               "rho_nu_probe_engines": launches_probes,
               "posterior_surface_nu1.2": launches_surface_general,
               # phases 36's and 39's sampling on phase 32's surface: no
               # launch
               "hmc_rho_nu_large_sampling": launches_hmc_rho_nu,
               "nuts_rho_nu_large_sampling": launches_nuts_rho_nu,
               # phase 40's entry points: the refinements of main_nu and
               # main_profile_rho_nu on the assembly entry
               **{f"twin_{k}": w for k, w in launches_twin.items()},
               # phase 43's general-nu fit at world 2 (the ranks' sum), when
               # the multi-rank phases ran
               **{k: w for k, w in sharded_windows.items()
                  if k == "sharded_world2_nu1.2"}}
    dense = ("dense_api_nu1.2", "dense_api_nu3.7", "main",
             "general_csr_2e16", "twin_main_nu", "twin_main_profile_rho_nu")
    # the offset tables of the FFT grid paths: the elementwise entry's
    # paths, and its only ones
    tables = ("grid_fft_operator_1024", "fft_fit_2e20_nu2.2",
              "main_fft_grid", "rho_nu_surface", "rho_nu_probe_engines")
    products = ("operator_route", "main_large", "posterior_surface_nu1.2",
                *(k for k in windows if k == "sharded_world2_nu1.2"))
    expected = {"matern_general_assembly": dense,
                "matern_general_elementwise": tables,
                "matern_general_product": products,
                "matern_general_product_sum": products,
                "matern_general_trace": products}
    per_path = {k: {path: w.get(k, 0) for path, w in windows.items()}
                for k in GENERAL_COUNTERS}
    missing = [(k, path) for k, paths in expected.items() for path in paths
               if per_path[k][path] == 0]
    if missing or any(n for path, n in per_path[
            "matern_general_elementwise"].items() if path not in tables):
        raise AssertionError(f"a general-nu kernel was never launched on a "
                             f"path that runs it, or the elementwise entry "
                             f"on another path: {missing}, {per_path}")

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
            # ms covers the tile kernel and its band's sums (the
            # product_sum record times the sums alone)
            rec["ms_includes"] = "matern_general[product_sum]"
        return rec
    def multirho_paths(counter):
        # the grid path (phase 10), the posterior surface (phase 33), the
        # HMC anchor's n = 900 surface (phase 34), and phases 35's and
        # 38's sampling on phase 33's surface (no launch)
        return {"grid_path": launches_2[counter],
                "posterior_surface_1e5": launches_surface[counter],
                "hmc_dense_anchor_surface_n900": launches_anchor[counter],
                "hmc_posterior_large_sampling":
                    launches_hmc_large.get(counter, 0),
                "nuts_posterior_large_sampling":
                    launches_nuts_large.get(counter, 0),
                # phase 45: drivers.profile_grid_chunk's window
                "profile_grid_chunk": launches_chunk[counter]}
    if not all((launches_1["matern_matmat_mma"], launches_1["matern_matmat"],
                *(w.get(k, 0) for w in (launches_fit, launches_lp)
                  for k in ("matern_matmat_mma", "matern_matmat")),
                launches_2["matern_matmat_multirho_mma"],
                launches_2["matern_matmat_multirho"],
                launches_3["matern_matmat_blocksparse_mma"],
                launches_3["matern_matmat_blocksparse"],
                launches_mma["bf16x3"], launches_mma["bf16"], launches_gram,
                launches_default["matern_matmat_multirho_mma"],
                launches_default["matern_matmat_blocksparse_mma"],
                launches_chunk["matern_matmat_multirho_mma"],
                launches_chunk["matern_matmat_multirho"])):
        raise AssertionError("a kernel of a path was never launched on it")
    # B1 on the sharded paths (phases 41-43; every rank's launches summed):
    # the product on its rectangular form, the trace on the rectangular
    # walk but at world 1
    b1_sharded = {c: {path: w.get(c, 0) for path, w in sharded_windows.items()
                      if path != "sharded_world2_nu1.2"}
                  for c in B1_COUNTERS}
    if not all(n for c, paths in b1_sharded.items() for path, n in
               paths.items() if (c, path) != ("matern_matmat",
                                              "sharded_world4_step")):
        raise AssertionError(f"B1 was not launched on a sharded path: "
                             f"{b1_sharded}")
    print(nvidia_smi())
    print(json.dumps({"kernels": [
        # the main path: every product on the tensor-core kernel ('highest'
        # as 3xTF32), trace(K^2) on the FP32 kernel
        kernel_record("matern_matmat_mma[highest]", "matern_matmat_mma.cu",
                      f"{PALLAS}:103", launches_1["matern_matmat_mma"],
                      measured_1, launches_api["matern_matmat_mma"],
                      launches_per_path=b1_sharded["matern_matmat_mma"]),
        {**kernel_record("matern_matmat", "matern_matmat.cu",
                         "gppe_tpu/ops/operators.py:42",
                         launches_1["matern_matmat"], measured_trace,
                         launches_api["matern_matmat"],
                         launches_per_path=b1_sharded["matern_matmat"]),
         # the rectangular walk of a world-2 ring block (50,000 x 100,000)
         "rect_walk": rect_trace},
        # the grid and the tapered path, the same split: products on the
        # tensor-core kernels, traces on the FP32 ones
        kernel_record("matern_matmat_multirho_mma[highest]",
                      "matern_multirho_mma.cu", f"{PALLAS}:356",
                      launches_2["matern_matmat_multirho_mma"], measured_2,
                      launches_per_path=multirho_paths(
                          "matern_matmat_multirho_mma")),
        kernel_record("matern_matmat_multirho", "matern_multirho.cu",
                      f"{PALLAS}:356", launches_2["matern_matmat_multirho"],
                      measured_2_trace,
                      launches_per_path=multirho_paths(
                          "matern_matmat_multirho")),
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
        general_record("assembly", "gppe_tpu/ops/assembly.py:22",
                       measured_asm),
        # the elementwise entry: the general-nu offset tables of the FFT
        # grid paths, host-CPU XLA in the reference (operators.py:411-418,
        # krylov_posterior.py:768-788)
        general_record("elementwise", "gppe_tpu/ops/operators.py:411-418; "
                       "gppe_tpu/models/krylov_posterior.py:768-788",
                       measured_elem),
        general_record("product", "gppe_tpu/ops/operators.py:22; "
                       "gppe_tpu/models/grid_krylov.py:128-141",
                       measured_prod),
        general_record("product_sum", "gppe_tpu/ops/operators.py:22; "
                       "gppe_tpu/models/grid_krylov.py:128-141",
                       measured_sum),
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
