"""The operator product's share of its roofline, in percent: the least
time the H100 could take for the window's product calls (``work/`` of the
configuration's operator, summed over the calls by shape) against the
device time the trace puts under the harness's ``bench.product`` ranges."""

from .. import spec


def read(run):
    device_s = run.summary.product_device_s
    if device_s <= 0:
        return None
    work = spec.part("work", run.cell.config["operator"])
    ctx = run.ctx
    least = 0.0
    for record in run.records:
        for (batch, width), calls in record.calls.items():
            seconds, _ = work.least_seconds(run.cell, batch, width, ctx.rho,
                                            ctx.nu)
            least += calls * seconds
    return 100.0 * least / device_s
