"""The hard-tapered Matern product on the configured grid: only the pairs
the taper keeps, counted from the grid by the reference's own stencil (the
offsets whose float64 k is at least the threshold), not from the
operator's tile list."""

from ..reference.tapered import GridTaper
from . import bound


def least_seconds(cell, batch, width, rho, nu):
    config = cell.config
    taper = GridTaper(int(config["points"]["side"]), rho, nu,
                      float(config["density"]))
    n = taper.n
    ordered = taper.kept_ordered_pairs              # the diagonal included
    bytes_moved = 4 * (2 * n + 2 * batch * n * width)
    return bound(ordered, (ordered - n) // 2, batch, width, bytes_moved)
