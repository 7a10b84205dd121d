"""Share of the traced jobs' time in which no operation ran on the card,
in percent: the union of the device intervals against the jobs' length."""

from ..trace import device_idle_share


def read(run):
    share = device_idle_share(run.summary)
    return None if share is None else 100.0 * share
