"""The walk of the dense trace(K^2) kernels (csrc/matern_trace.cuh), on the
CPU: its Python mirror in ops/cuda_kernels.py, and the traces a float64
evaluation of that walk gives against the plain versions and the JAX
reference (gppe_tpu run on the CPU in x64; the Pallas multi-rho kernel in
interpret mode, as tests/test_torch_grid_krylov.py runs it).

The kernels visit tile pairs of 128 x 128 points: for a square K only
those with tj >= ti, each off the diagonal counted twice, which is exact
because K is symmetric bit for bit; for a rectangular K all of them. The
card tests (tests/test_torch_cuda.py) hold the kernels themselves to the
plain float64 versions. Inputs come from numpy seeds.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import pallas_kernels  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()

F64 = torch.float64
TILE = cuda_kernels._TRACE_TILE
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gppe_tpu_torch", "csrc")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The walk runs many small tensor ops; with the test workers sharing
    the cores, a pool of threads per op costs far more than it gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trace_constants_match_the_sources():
    """The mirror's tile and rhos per thread are the kernels' own."""
    with open(os.path.join(CSRC, "matern_trace.cuh")) as f:
        assert f"constexpr int kTraceTile = {TILE};" in f.read()
    with open(os.path.join(CSRC, "matern_multirho.cu")) as f:
        assert re.search(rf"constexpr int kBT = {cuda_kernels._TRACE_RHOS};",
                         f.read())


def _assert_triangle_once(T):
    p = np.arange(T * (T + 1) // 2, dtype=np.int32)
    ti, tj, w = cuda_kernels.trace_tile_pair(p, T, T, True)
    assert ti.min() >= 0 and tj.max() < T and np.all(ti <= tj)
    assert np.array_equal(w, 1 + (ti != tj))
    # p.size pairs land on p.size distinct (ti, tj): every pair once
    seen = np.zeros(T * T, bool)
    seen[ti * T + tj] = True
    assert np.count_nonzero(seen) == p.size


@pytest.mark.parametrize("first", [1, 251, 501, 751])
def test_symmetric_walk_covers_the_triangle_once(first):
    """Every T from 1 to 1000 (in four cases of 250): each tile pair
    tj >= ti exactly once, weight 2 off the diagonal, 1 on it; the
    weighted pairs then count every ordered pair once."""
    for T in range(first, first + 250):
        _assert_triangle_once(T)


@pytest.mark.parametrize("tiles_r, tiles_c", [(1, 1), (3, 7), (782, 9)])
def test_rectangular_walk_covers_every_pair(tiles_r, tiles_c):
    p = np.arange(tiles_r * tiles_c, dtype=np.int64)
    ti, tj, w = cuda_kernels.trace_tile_pair(p, tiles_r, tiles_c, False)
    assert np.array_equal(ti * tiles_c + tj, p) and np.all(w == 1)
    assert ti.max() == tiles_r - 1 and tj.max() == tiles_c - 1


@pytest.mark.parametrize("nr, nc, symmetric", [
    (1, 1, True), (129, 129, True), (100_000, 100_000, True),
    (100_000, 4097, False), (2 ** 20, 2 ** 20, True), (3_000_000, 3_000_000,
                                                       True)])
def test_schedule_blocks_cover_the_pairs(nr, nc, symmetric):
    """Consecutive runs of per_block pairs cover the walk once, the last
    block perhaps short, in at most _TRACE_MAX_BLOCKS blocks (the partials
    buffer); the paths' n = 100,000 takes one pair per block."""
    tiles_r, tiles_c, pairs, per_block, blocks = cuda_kernels.trace_schedule(
        nr, nc, symmetric)
    assert (tiles_r, tiles_c) == (-(-nr // TILE), -(-nc // TILE))
    assert pairs == (tiles_r * (tiles_r + 1) // 2 if symmetric
                     else tiles_r * tiles_c)
    assert (blocks - 1) * per_block < pairs <= blocks * per_block
    assert blocks <= cuda_kernels._TRACE_MAX_BLOCKS
    if nr == 100_000:
        assert per_block == 1


def _walk_trace(k_tile, n, nr=None, nc=None, symmetric=True):
    """sum k^2 over the walk in float64: ``k_tile(rows, cols)`` gives the
    K tile of two slices (a (..., rows, cols) tensor), weighted as the
    kernels weigh it."""
    nr = n if nr is None else nr
    nc = n if nc is None else nc
    tiles_r, tiles_c, pairs, _, _ = cuda_kernels.trace_schedule(
        nr, nc, symmetric)
    total = 0.0
    for p in range(pairs):
        ti, tj, w = (int(v) for v in cuda_kernels.trace_tile_pair(
            p, tiles_r, tiles_c, symmetric))
        K = k_tile(slice(ti * TILE, min((ti + 1) * TILE, nr)),
                   slice(tj * TILE, min((tj + 1) * TILE, nc)))
        total = total + w * torch.sum(K * K, dim=(-2, -1))
    return total


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_walk_equals_plain_and_reference_trace(nu, d):
    """The symmetric walk in float64 against the full plain trace at n in
    {1, 127, 128, 129, 1000}, and against the reference's
    _matern_frobenius2_blocked (through MaternOperator.trace_pow(2)) at
    n = 1000 for d = 2 and at n = 129 for nu = 1/2, d = 1 and 3: every nu,
    d and a ragged multi-tile n, one XLA compile each (the plain trace is
    held to the reference in tests/test_torch_kernels.py). Only the
    summation order differs, so rtol 1e-12. The rectangular walk of a
    1000 x 129 K against the plain rectangular sum, the same."""
    rng = np.random.RandomState(20 + d)
    scale = 0.1 * np.sqrt(d / 2)
    S = kernels.broadcast_scale(scale, d, dtype=F64)
    for n in (1, 127, 128, 129, 1000):
        pts = rng.rand(n, d)
        P = torch.as_tensor(pts)
        walk = _walk_trace(lambda i, j: kernels.matern(
            kernels.pairwise_scaled_distance(P[i], P[j], S), nu), n)
        _, plain = cuda_kernels.matern_matmat(P, scale, None, nu,
                                              frobenius=True)
        np.testing.assert_allclose(float(walk), float(plain), rtol=1e-12)
        if (n, d) == (1000, 2) or (n == 129 and d != 2 and nu == 0.5):
            ref = jops.MaternOperator(pts, scale, nu=nu).trace_pow(2)
            np.testing.assert_allclose(float(walk), float(ref), rtol=1e-12)
    C = torch.as_tensor(rng.rand(129, d))
    walk = _walk_trace(lambda i, j: kernels.matern(
        kernels.pairwise_scaled_distance(P[i], C[j], S), nu), None,
        nr=1000, nc=129, symmetric=False)
    _, plain = cuda_kernels.matern_matmat(P, scale, None, nu, points_cols=C,
                                          frobenius=True)
    np.testing.assert_allclose(float(walk), float(plain), rtol=1e-12)


def _multirho_walk(pts, rhos, nu):
    """The multi-rho traces over the symmetric walk, in float64 and in the
    kernel's order: the raw distance, then times 1/rho_b, for each grid.y
    group of _TRACE_RHOS rhos (the last perhaps fewer)."""
    P, inv = torch.as_tensor(pts), 1.0 / torch.as_tensor(rhos)
    walk = torch.zeros(len(rhos), dtype=F64)
    for b0 in range(0, len(rhos), cuda_kernels._TRACE_RHOS):
        g = slice(b0, b0 + cuda_kernels._TRACE_RHOS)
        walk[g] = _walk_trace(lambda i, j: kernels.matern(
            kernels.pairwise_scaled_distance(P[i], P[j], 1.0)[None]
            * inv[g, None, None], nu), len(pts))
    return walk


@pytest.mark.parametrize("B, nu, d", [(1, 0.5, 2), (7, 2.5, 2),
                                      (8, 0.5, 3), (9, 1.5, 1),
                                      (17, 150.0, 3)])
def test_multirho_walk_equals_plain_traces(B, nu, d):
    """Per rho, against the plain float64 version at n = 300 over one to
    three rho groups, a full and a short last group among them: every rho
    of the batch in one group. rtol 1e-12."""
    rng = np.random.RandomState(B)
    pts = rng.rand(300, d)
    rhos = np.linspace(0.05, 0.3, B)
    _, plain = cuda_kernels.matern_matmat_multirho(
        torch.as_tensor(pts), torch.as_tensor(rhos), None, nu,
        return_frobenius=True)
    np.testing.assert_allclose(_multirho_walk(pts, rhos, nu).numpy(),
                               plain.numpy(), rtol=1e-12)


def test_multirho_walk_equals_pallas_traces():
    """Per rho, against the Pallas kernel in interpret mode (float32 sums)
    at a ragged n = 129 over two tiles, to rtol 1e-5, the bound of the
    reference test for its traces (tests/test_torch_grid_krylov.py)."""
    rng = np.random.RandomState(3)
    pts = rng.rand(129, 2)
    rhos = np.asarray([0.07, 0.3])
    V = np.zeros((2, 129, 1), np.float32)
    _, ref = pallas_kernels.matern_matmat_multirho(
        pts, rhos, V, 0.5, tile=128, interpret=True, return_frobenius=True)
    np.testing.assert_allclose(_multirho_walk(pts, rhos, 0.5).numpy(),
                               np.asarray(ref), rtol=1e-5)
