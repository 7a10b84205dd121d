"""The operators a configuration names (``"operator"``), one module each:
``build(ctx, points)`` returns the program's matrix-free operator of the
job's points at the cell's kernel parameters."""
