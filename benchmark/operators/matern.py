"""``MaternOperator``: the dense Matern correlation, matrix-free."""

from gppe_tpu_torch.ops.operators import MaternOperator


def build(ctx, points):
    return MaternOperator(points, ctx.rho, nu=ctx.nu, device=ctx.device)
