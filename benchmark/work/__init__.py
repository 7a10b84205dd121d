"""The least work of an operator's product, one module per operator
(``work/<operator>.py``): ``least_seconds(cell, batch, width, rho, nu)``
is the least time one H100 could take for one product call of ``batch``
kernels on ``width`` columns, and the term that binds it.

The count is of the mathematics, whatever kernel or library runs it: k
once for each unordered pair of points (K is symmetric, its diagonal is 1),
one multiply-add a column for each ordered pair (each pair adds to both of
its rows), each operand read once and each result written once. A
multiply-add at float32 grade takes at least three TF32 tensor-core
multiply-adds (the 3xTF32 split that the configured precision allows; one
TF32 or a bf16x3 product is of a lower precision, a cell's control, not
its work); k takes at least two MUFU operations (a square root for the
distance and one exponential, the least any Matern form needs), at the
best split of MUFU work between
the special-function units and the FP32 pipes. The work of the two units
overlaps, so the bound is the largest of the three terms, never their sum.
"""

from .. import peaks

# float32-grade multiply-add: three TF32 multiply-adds of two flops each
F32_GRADE_FLOPS_PER_MAC = 3 * 2
MUFU_PER_PAIR = 2


def bound(pairs_ordered, pairs_unordered, batch, width, bytes_moved):
    """(seconds, term) of the least time for these counts."""
    terms = {
        "tf32_mac": batch * pairs_ordered * width * F32_GRADE_FLOPS_PER_MAC
        / peaks.TF32_FLOPS,
        "mufu": batch * pairs_unordered * MUFU_PER_PAIR
        / peaks.MUFU_BEST_SPLIT,
        "hbm": bytes_moved / peaks.HBM_BYTES,
    }
    term = max(terms, key=terms.get)
    return terms[term], term
