"""``TaperedMaternOperator``: the hard-tapered Matern correlation at the
configuration's density, its geometry built on the host from the points."""

from gppe_tpu_torch.ops.taper import TaperedMaternOperator


def build(ctx, points):
    return TaperedMaternOperator(points, ctx.rho, nu=ctx.nu,
                                 density=float(ctx.config["density"]),
                                 device=ctx.device)
