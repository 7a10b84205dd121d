"""Seconds a job spends building the operator from the points (host
geometry and the copies to the device), the mean over the window's jobs of
the benchmark's synchronised span around the constructor; nothing where
the entry builds no operator."""

from ..trace import mean_span


def read(run):
    return mean_span(run.records, "operator_build")
