"""gppe_tpu_torch — the PyTorch / CUDA port of ``gppe_tpu``.

A second package beside the JAX reference, written for one NVIDIA H100
(``sm_90a``). It mirrors ``gppe_tpu``'s layout and names, so each
counterpart sits at the same path. The slice ported so far is the
matrix-free profile-likelihood MLE:

    utils.data -> ops.operators.MaternOperator (CUDA kernel
    ops.cuda_kernels.matern_matmat) -> ops.stochastic.lanczos ->
    models.large_scale.KrylovProfileLikelihood.fit

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

__version__ = "0.1.0"

__all__ = ["__version__"]
