"""gppe_tpu_torch — the PyTorch / CUDA port of ``gppe_tpu``.

A second package beside the JAX reference, written for one NVIDIA H100
(``sm_90a``). It mirrors ``gppe_tpu``'s layout and names, so each
counterpart sits at the same path. Ported so far are four paths, each
on hand-written CUDA kernels behind the wrappers of ``ops.cuda_kernels``
(each product on a tensor-core kernel, in every tile-dot mode):

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
  and drivers.roofline_matvec (widths x distance forms x dot modes).

Policy (see :mod:`gppe_tpu_torch.utils.config`):

* the device is explicit: public constructors take ``device=`` and default
  to ``"cuda"``; nothing falls back to the CPU when no GPU is present;
* the dtype is explicit (``dtype=``, float32 on the card, float64 in the
  CPU tests);
* random draws take an explicit ``torch.Generator`` or seed;
* importing the package changes no global torch state; every entry point
  calls :func:`gppe_tpu_torch.utils.config.setup`.

The package imports neither ``jax`` nor ``gppe_tpu``.
"""

from .models.grid_krylov import GridKrylovProfileLikelihood
from .models.large_scale import KrylovProfileLikelihood
from .ops.operators import MaternOperator
from .ops.taper import TaperedMaternOperator

__version__ = "0.1.0"

__all__ = ["GridKrylovProfileLikelihood", "KrylovProfileLikelihood",
           "MaternOperator", "TaperedMaternOperator", "__version__"]
