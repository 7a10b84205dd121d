"""gppe_tpu_torch — the PyTorch / CUDA port of ``gppe_tpu``.

A second package beside the JAX reference, written for one NVIDIA H100
(``sm_90a``). It mirrors ``gppe_tpu``'s layout and names, so each
counterpart sits at the same path, and it covers the JAX package: ten
paths, of which the first four run hand-written CUDA kernels behind the
wrappers of ``ops.cuda_kernels`` (each product on a tensor-core kernel,
in every tile-dot mode) and the fifth reaches them through a matrix-free
K:

* the matrix-free profile-likelihood MLE:
  utils.data -> ops.operators.MaternOperator (kernel ``matern_matmat``)
  -> ops.stochastic.lanczos ->
  models.large_scale.KrylovProfileLikelihood.fit;
* the grid-batched MLE over many correlation scales:
  models.grid_krylov.GridKrylovProfileLikelihood (kernel
  ``matern_matmat_multirho``) -> fit_all;
* the tapered-sparse MLE: ops.taper.TaperedMaternOperator (kernel
  ``matern_matmat_blocksparse``) -> KrylovProfileLikelihood.fit;
* the precision-matrix and roofline measurements:
  drivers.profile_kernel_matrix (the first path under each tile-dot mode)
  and drivers.roofline_matvec (widths x distance forms x dot modes);
* the exact dense path and the public API:
  ops.assembly.generate_correlation -> models.gaussian_process
  .GaussianProcess(X, K, method).train(z) -> models.likelihood, over
  models.mixed_correlation (a float64 eigendecomposition or Cholesky on
  the card; CG, MINRES and the stochastic engines of ops.linalg and
  ops.stochastic) and the host float64 direct and profiled likelihoods;
  a matrix-free K takes the operator route (KrylovProfileLikelihood for
  the fit, CG and SLQ through ``matern_matmat`` for ``likelihood``).
  drivers.maximize_likelihood_direct_method times it;
* general Matern nu (the Bessel K_nu of ops.special) on every dense path:
  generate_correlation, MaternOperator and the grid engine over per-point
  (rho, nu), on the general-nu kernel ``matern_general`` (the fused
  assembly from the points, K @ V, trace(K^2)); drivers.find_optimal_covariance runs the
  (rho, nu) search over it (ops.global_opt.differential_evolution,
  models.priors);
* structured grids and the posterior surfaces: ops.operators
  .GridMaternOperator (the exact operator of a regular grid, its products
  ``torch.fft`` transforms, its general-nu offset table on
  ``matern_general``'s elementwise entry) through KrylovProfileLikelihood,
  drivers.find_optimal_covariance.main_fft_grid and
  drivers.compare_various_num_points; models.krylov_posterior
  .KrylovPosteriorSurface (lp(eta, rho) from nodes factorized on
  ``matern_matmat_multirho`` or ``matern_general``) and
  KrylovPosteriorSurfaceRhoNu (lp(eta, rho, nu) from batched FFT Lanczos
  passes), differentiable float64 targets for the samplers;
* the HMC posterior slice: models.hmc (chains as one torch.func.vmap
  batch, dual averaging and a diagonal mass matrix, exact resume from a
  saved state, utils.checkpoint.save_hmc_state) over the dense targets of
  models.kernel_posterior (a float64 Cholesky per gradient, nu through
  the fixed-trip Bessel K_nu) and over both posterior surfaces;
  models.diagnostics (split R-hat, ESS); drivers.sample_posterior;
* multi-device, on torch.distributed: parallel.mesh (the (probe, block)
  mesh of a process group's ranks, the one-host launcher ``spawn``) and
  parallel.sharded (the ring and all-gather products on the rectangular
  forms of ``matern_matmat`` and ``matern_general``, the sharded Lanczos,
  profile step and ShardedKrylovProfileLikelihood); the samplers' ``mesh=``
  shards their chains; drivers.scaling_efficiency;
* the drivers and utilities: utils.plot (every ``plot=True``; matplotlib
  imported only to draw, each figure's numbers from a plain function),
  utils.display, utils.timing (``phase_timer`` on a synchronised clock,
  ``device_trace`` on torch.profiler), drivers.profile_grid_chunk (the
  grid chunk's setup split into its Lanczos variants on
  ``matern_matmat_multirho``), drivers.compare_various_noise_level (200
  noise levels x 4 bases, one K, float64 eigh and vectorised root find a
  basis), drivers.plot_log_likelihood_der1 and drivers.plot_matern_kernel.

Policy (see :mod:`gppe_tpu_torch.utils.config`):

* the device is explicit: public constructors take ``device=`` and default
  to ``"cuda"``; nothing falls back to the CPU when no GPU is present;
* the dtype is explicit (``dtype=``): float32 for the kernels, the
  Lanczos vectors and the assembly on the card; float64 for a dense K's
  eigendecomposition, rotation, Cholesky and solves on the card (the H100
  has native float64); float64 for everything in the CPU tests. The
  O(n m) per-eta likelihood scalars are float64 on the host, by design;
* random draws take an explicit ``torch.Generator`` or seed;
* importing the package changes no global torch state; every entry point
  calls :func:`gppe_tpu_torch.utils.config.setup`.

The package imports neither ``jax`` nor ``gppe_tpu``.
"""

from .models.gaussian_process import GaussianProcess
from .models.grid_krylov import GridKrylovProfileLikelihood
from .models.krylov_posterior import (KrylovPosteriorSurface,
                                      KrylovPosteriorSurfaceRhoNu)
from .models.large_scale import KrylovProfileLikelihood
from .ops import special
from .ops.assembly import generate_correlation
from .ops.global_opt import differential_evolution
from .ops.operators import GridMaternOperator, MaternOperator
from .ops.taper import TaperedMaternOperator

__version__ = "0.1.0"

__all__ = ["GaussianProcess", "GridKrylovProfileLikelihood",
           "GridMaternOperator", "KrylovPosteriorSurface",
           "KrylovPosteriorSurfaceRhoNu", "KrylovProfileLikelihood",
           "MaternOperator",
           "TaperedMaternOperator", "differential_evolution",
           "generate_correlation", "special", "__version__"]
