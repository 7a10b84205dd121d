"""The entries a traffic mix drives (``"entry"``), one module each:
``run(ctx, job)`` runs one estimation job through the program and returns
its estimate and the program's engines."""
