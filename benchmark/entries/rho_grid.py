"""The kernel-scale search on one chunk: ``GridKrylovProfileLikelihood``
over the traffic's rhos at the configuration's nu (one batched Lanczos pass
on the multi-rho product), then ``fit_all()``; the estimate is the point of
highest profile log-likelihood.

The grid engine builds no operator object: its product is the module
function ``cuda_kernels.matern_matmat_multirho``, which this entry routes
through the harness's product boundary while the engine is built (the
trace-only call, with no operand, passes straight through).
"""

import contextlib

import numpy as np

from gppe_tpu_torch.models import grid_krylov
from gppe_tpu_torch.ops import cuda_kernels


@contextlib.contextmanager
def _product_boundary(ctx):
    program = cuda_kernels.matern_matmat_multirho
    product = program if ctx.control is None else ctx.control.control_multirho

    def bounded(points, rhos, W, nu, **kwargs):
        if W is None:
            return product(points, rhos, W, nu, **kwargs)
        return ctx.product(
            lambda W_: product(points, rhos, W_, nu, **kwargs), W)

    cuda_kernels.matern_matmat_multirho = bounded
    try:
        yield
    finally:
        cuda_kernels.matern_matmat_multirho = program


def run(ctx, job):
    cuda_kernels.DEFAULT_DOT_MODE = ctx.dot_mode
    traffic = ctx.traffic
    rhos = np.asarray(traffic["rhos"], dtype=float)
    with ctx.span("engine_build"), _product_boundary(ctx):
        engine = grid_krylov.GridKrylovProfileLikelihood(
            job.points, job.X, job.z, rhos, np.full(rhos.size, ctx.nu),
            nu_static=ctx.nu, matrix_free=True,
            lanczos_steps=int(traffic["lanczos_steps"]),
            num_probes=int(traffic["num_probes"]), device=ctx.device,
            probes=job.probes, v_defl=job.v_defl)
    fit = traffic["fit"]
    with ctx.span("engine_fit"):
        points = engine.fit_all(interval_eta=tuple(fit["interval_eta"]),
                                tol=float(fit["tol"]))
    best = max(range(len(points)), key=lambda i: points[i]["lp"])
    estimate = dict(points[best], points=points)
    return {"estimate": estimate, "engines": engine.engines,
            "rhos": list(rhos), "nus": [ctx.nu] * rhos.size}
