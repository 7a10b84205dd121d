"""The dense Matern product: every pair of the n points."""

from . import bound


def least_seconds(cell, batch, width, rho, nu):
    spec = cell.config["points"]
    n, d = int(spec["n"]), int(spec["dimension"])
    # points read once; each kernel's operand read and result written once
    bytes_moved = 4 * (n * d + 2 * batch * n * width)
    return bound(n * n, n * (n - 1) // 2, batch, width, bytes_moved)
