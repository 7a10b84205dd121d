"""The least-work counts worked out by hand at tiny shapes."""

import pytest

from benchmark import peaks, work
from benchmark.reference.tapered import GridTaper
from benchmark.work import matern, tapered

from .cells import tiny_cell


def test_dense_count_by_hand():
    cell = tiny_cell("matern_n100k.fit")
    cell.config["points"]["n"] = 10
    # 100 ordered pairs x 24 columns x 3 TF32 multiply-adds x 2 flops;
    # 45 unordered pairs x 2 MUFU; 4 bytes x (20 coordinates + 2 x 240)
    seconds, term = matern.least_seconds(cell, 1, 24, 0.1, 0.5)
    tf32 = 100 * 24 * 6 / 495e12
    mufu = 45 * 2 / (4.18e12 + 67e12 / 13)
    hbm = 4 * (20 + 480) / 3.35e12
    assert seconds == pytest.approx(max(tf32, mufu, hbm), rel=1e-15)
    assert term == "hbm"
    # a batch of 8 kernels counts each kernel's pairs and operands
    seconds8, _ = matern.least_seconds(cell, 8, 16, 0.1, 0.5)
    assert seconds8 == pytest.approx(max(
        8 * 100 * 16 * 6 / 495e12, 8 * 45 * 2 / peaks.MUFU_BEST_SPLIT,
        4 * (20 + 2 * 8 * 10 * 16) / 3.35e12), rel=1e-15)


def test_full_size_dense_binds_on_the_tensor_cores():
    """n = 10^5, 24 columns: 1e10 ordered pairs, 2.909 ms of TF32 work."""
    cell = tiny_cell("matern_n100k.fit")
    cell.config["points"]["n"] = 100000
    seconds, term = matern.least_seconds(cell, 1, 24, 0.1, 0.5)
    assert term == "tf32_mac"
    assert seconds == pytest.approx(1e10 * 24 * 6 / 495e12, rel=1e-12)


def test_tapered_count_by_hand():
    """A 3 x 3 grid whose taper keeps the 4 nearest neighbours: 9 diagonal
    pairs and 24 ordered neighbour pairs (12 edges of the grid)."""
    side, rho, nu = 3, 0.5, 0.5
    # the density whose radius lies between one and sqrt(2) spacings
    density = 3.14159 * 1.2 ** 2 / 9
    taper = GridTaper(side, rho, nu, density)
    assert taper.kept_ordered_pairs == 9 + 24
    cell = tiny_cell("tapered_n2e20.fit")
    cell.config["points"]["side"] = side
    cell.config["density"] = density
    seconds, term = tapered.least_seconds(cell, 1, 4, rho, nu)
    expected = work.bound(33, 12, 1, 4, 4 * (18 + 2 * 9 * 4))
    assert (seconds, term) == expected
    assert term == "hbm"
