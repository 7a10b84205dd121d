"""Seconds a job spends in the host per-eta math (``fit`` or
``fit_all``), the mean over the window's jobs of the benchmark's span
around the call."""

from ..trace import mean_span


def read(run):
    return mean_span(run.records, "engine_fit")
