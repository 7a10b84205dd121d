"""The per-layer metrics, one reader each (``metrics/<metric>.py``):
``read(run)`` takes the traced run (``run.cell``, ``run.records`` of the
window's jobs, ``run.summary`` of its trace) and returns the metric's value,
or None where it finds nothing to read, and the harness then leaves the
metric out."""
