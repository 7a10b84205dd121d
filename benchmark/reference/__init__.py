"""The plain reference, in float64: plain PyTorch and NumPy (and SciPy's
Bessel function), importing nothing of the program and taking nothing the
program made.

``<operator>.py`` applies the configuration's correlation K, worked out
from the points themselves, to a block of vectors; ``krylov.py`` is the
estimate worked out from K's products and the job's inputs; ``check.py``
compares the program's products, factorization and estimate with them.
"""
