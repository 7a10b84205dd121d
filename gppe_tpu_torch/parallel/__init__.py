"""Multi-device execution on ``torch.distributed``: the counterpart of
``gppe_tpu.parallel``. :mod:`.mesh` holds the (probe, block) mesh of
ranks, the process-group setup and the one-host launcher; :mod:`.sharded`
the row-block-sharded products, Lanczos, profile step and the sharded
profile-likelihood engine."""

from . import mesh, sharded  # noqa: F401
