"""The estimate of one kernel: the configuration's operator from the
points, ``KrylovProfileLikelihood`` over it, then ``fit()``.

The engine gets the operator through the harness's product boundary, so
each product call is one ``bench.product`` range in a traced run and the
checked job keeps each product's operand and result.
"""

from gppe_tpu_torch.models.large_scale import KrylovProfileLikelihood
from gppe_tpu_torch.ops import cuda_kernels

from .. import spec
from ..harness import ProductBoundary


def run(ctx, job):
    cuda_kernels.DEFAULT_DOT_MODE = ctx.dot_mode
    traffic = ctx.traffic
    with ctx.span("operator_build"):
        if ctx.control is None:
            operator = spec.part("operators",
                                 ctx.config["operator"]).build(ctx, job.points)
        else:
            operator = ctx.control.ControlOperator(
                job.points, ctx.rho, ctx.nu, ctx.config, ctx.device)
    with ctx.span("engine_build"):
        engine = KrylovProfileLikelihood(
            ProductBoundary(ctx, operator), job.X, job.z,
            lanczos_steps=int(traffic["lanczos_steps"]),
            num_probes=int(traffic["num_probes"]), device=ctx.device,
            probes=job.probes, v_defl=job.v_defl)
    del operator
    fit = traffic["fit"]
    with ctx.span("engine_fit"):
        estimate = engine.fit(interval_eta=tuple(fit["interval_eta"]),
                              tol=float(fit["tol"]))
    return {"estimate": estimate, "engines": [engine],
            "rhos": [ctx.rho], "nus": [ctx.nu]}
