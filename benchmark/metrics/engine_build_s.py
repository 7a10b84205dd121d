"""Seconds a job spends building the engine (``KrylovProfileLikelihood``
or ``GridKrylovProfileLikelihood.__init__``: the Lanczos pass, the float64
projections, the trace pass and the quadrature), the mean over the window's
jobs of the benchmark's synchronised span around the call."""

from ..trace import mean_span


def read(run):
    return mean_span(run.records, "engine_build")
