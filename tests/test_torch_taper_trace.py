"""The walk of the tapered trace(K^2) kernel (csrc/matern_blocksparse.cu),
on the CPU: its schedule in ops/cuda_kernels.py, and the trace a float64
evaluation of that walk gives against the plain version and the JAX
reference (gppe_tpu's TaperedMaternOperator.trace_pow(2), its XLA scan,
run on the CPU in x64).

The kernel visits units of 128 x 128 points: pairs of sub-tiles of the
list's tiles. Where the list holds (j, i) with every (i, j), as the
operator's does, only the units of tile pairs ti <= tj, and on a diagonal
tile pair only the sub-tiles sj >= si, each unit whose rows are not its
columns counted twice; that is exact because the tapered K is symmetric
bit for bit. A list without its mirror walks every unit at weight 1. The
card tests (tests/test_torch_cuda.py) hold the kernel itself to the plain
float64 version. Inputs come from numpy seeds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.ops.taper import TaperedMaternOperator  # noqa: E402
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402
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


# correlation scales that put the taper radius (density 0.02) 1.6 to 3
# scales out in d = 1, 2, 3
SCALES = {1: 0.005, 2: 0.05, 3: 0.05 * np.sqrt(1.5)}


def _operator(n, tile, d=2, nu=0.5, seed=0):
    pts = np.random.RandomState(seed).rand(n, d)
    return pts, TaperedMaternOperator(pts, SCALES[d], nu=nu, density=0.02,
                                      tile=tile, device="cpu", dtype=F64)


def _sub_tiles(op):
    """The first point of every sub-tile, in order, and the sub-tiles of
    each tile as a range of indices into that list."""
    n = op.shape[0]
    starts, ranges = [], []
    for t in range(op.num_tiles):
        first = len(starts)
        starts += range(t * op.tile, min((t + 1) * op.tile, n), TILE)
        ranges.append(range(first, len(starts)))
    return np.asarray(starts), ranges


def _ordered_sub_pairs(op, pair_i, pair_j):
    """How often each ordered pair of sub-tiles lies in the pair list."""
    starts, ranges = _sub_tiles(op)
    want = np.zeros((len(starts), len(starts)), np.int64)
    for i, j in zip(pair_i, pair_j):
        for a in ranges[i]:
            for b in ranges[j]:
                want[a, b] += 1
    return starts, want


def _walked_sub_pairs(walk, starts):
    """How often the walk counts each ordered pair of sub-tiles: a unit of
    weight 2 counts its mirror too."""
    a = np.searchsorted(starts, walk.units[:, 0])
    b = np.searchsorted(starts, walk.units[:, 1])
    assert np.array_equal(starts[a], walk.units[:, 0])
    assert np.array_equal(starts[b], walk.units[:, 1])
    got = np.zeros((len(starts), len(starts)), np.int64)
    np.add.at(got, (a, b), 1)
    np.add.at(got, (b[walk.weights == 2], a[walk.weights == 2]), 1)
    return got


def test_trace_walk_constants_match_the_sources():
    """The schedules' units, weights and sub-tile ends are the kernels'
    own: the closed-form tapered trace's (units of kTraceTile points,
    weight 2 off the sub-diagonal) and the general-nu one's (kTileRows
    rows by kTraceTile columns, only the pairs above the diagonal, at
    weight 2, on the symmetric walk), which share ``sub_tile_points``
    through ``matern_trace.cuh``."""
    with open(os.path.join(CSRC, "matern_trace.cuh")) as f:
        header = f.read()
    assert f"constexpr int kTraceTile = {TILE};" in header
    # a sub-tile ends at the end of its tile or at n, at most kSize on
    assert "template <int kSize = kTraceTile>" in header
    assert "const int tile_end = (p0 / tile + 1) * tile;" in header
    assert "return min(kSize, min(tile_end, n) - p0);" in header
    with open(os.path.join(CSRC, "matern_general_tile.cuh")) as f:
        tile = f.read()
    assert (f"constexpr int kTileRows = {cuda_kernels._TILE_ROWS};"
            in tile)
    # with UPPER, pair (i, j) counts where j - i > diag
    assert "(!UPPER || j - i > diag)" in tile
    sources = {}
    for name in ("matern_blocksparse.cu", "matern_blocksparse_general.cu"):
        with open(os.path.join(CSRC, name)) as f:
            sources[name] = src = f.read()
        assert '#include "matern_trace.cuh"' in src
        # the units come as int2 (first row, first column)
        assert "const int2* __restrict__ units" in src
        assert "(p0 / tile + 1) * tile" not in src  # no second copy
    src = sources["matern_blocksparse.cu"]
    # weight 2 exactly where the walk is symmetric and rows != columns
    assert "(symmetric && unit.x != unit.y ? 2.0 : 1.0)" in src
    assert "const int rn = sub_tile_points(unit.x, tile, n);" in src
    src = sources["matern_blocksparse_general.cu"]
    # every counted pair at weight 2 on the symmetric walk; diag = first
    # row less first column, so that only column > row counts
    assert "const double weight = symmetric ? 2.0 : 1.0;" in src
    assert "symmetric ? unit.x - unit.y : -kTileRows" in src
    assert ("const int nrows = sub_tile_points<kTileRows>(unit.x, tile, n);"
            in src)
    assert "const int ncols = sub_tile_points(unit.y, tile, n);" in src


@pytest.mark.parametrize("n, tile", [(1000, 128), (1500, 200), (4000, 512),
                                     (1030, 512), (100, 512)])
def test_symmetric_walk_covers_each_unordered_pair_once(n, tile):
    """On the operator's mirrored list at ragged n, tile 128, 200 (sub-tiles
    of 128 and 72), 512 (a last tile of 6 points at n = 1030) and 100 (a
    tile under 128 points, n < 128): only units with rows before columns,
    the tile pairs ti <= tj and the sub-tile triangle of diagonal tiles,
    weight 2 off the sub-diagonal and 1 on it, so that every ordered pair
    of sub-tiles of the list is counted once; the weighted point pairs are
    the list's."""
    _, op = _operator(n, tile, seed=n)
    walk = cuda_kernels.blocksparse_trace_schedule(op.pair_i, op.pair_j,
                                                   op.tile, n)
    assert walk.symmetric and walk.units.dtype == np.int32
    assert np.array_equal(walk.units, op._trace_walk.units.numpy())
    rows, cols = walk.units[:, 0], walk.units[:, 1]
    assert np.all(rows <= cols)
    assert np.array_equal(walk.weights, 1 + (rows != cols))
    starts, want = _ordered_sub_pairs(op, op.pair_i, op.pair_j)
    assert want.max() == 1
    assert np.array_equal(_walked_sub_pairs(walk, starts), want)
    rn = cuda_kernels.blocksparse_sub_tile_points(rows, op.tile, n)
    cn = cuda_kernels.blocksparse_sub_tile_points(cols, op.tile, n)
    assert rn.min() >= 1 and cn.min() >= 1 and rn.max() <= TILE
    real = np.minimum(op.tile, n - op.tile * np.arange(op.num_tiles))
    assert np.sum(walk.weights * rn * cn) == np.sum(
        real[op.pair_i].astype(np.int64) * real[op.pair_j])
    # under the full walk's point pairs: about half where tiles are many
    assert np.sum(rn * cn) < np.sum(walk.weights * rn * cn) or n < TILE


def test_walk_of_a_list_without_its_mirror():
    """A list that drops some of its mirror pairs walks every sub-tile pair
    of the list at weight 1 (the same kernel, ``symmetric`` false), though
    the symmetric walk is asked for; a mirrored list asked for the full
    walk gives that walk too."""
    n = 1500
    _, op = _operator(n, 200, seed=4)
    keep = ~((op.pair_i > op.pair_j) & ((op.pair_i + op.pair_j) % 2 == 1))
    pair_i, pair_j = op.pair_i[keep], op.pair_j[keep]
    assert keep.sum() < len(keep)
    for pi, pj, symmetric in ((pair_i, pair_j, True),
                              (op.pair_i, op.pair_j, False)):
        walk = cuda_kernels.blocksparse_trace_schedule(pi, pj, op.tile, n,
                                                       symmetric=symmetric)
        assert not walk.symmetric and np.all(walk.weights == 1)
        starts, want = _ordered_sub_pairs(op, pi, pj)
        assert np.array_equal(_walked_sub_pairs(walk, starts), want)


def test_walk_at_the_tapered_paths_size():
    """The tapered path's operator (n = 2^20 grid points, tile 512,
    rho 0.005, density 1e-3; the sort and pair geometry alone, ~1 s):
    18,652 tile pairs, of them 8,302 with i < j and 2,048 diagonal, walked
    as 8,302 * 16 + 2,048 * 10 = 153,312 units in as many blocks of one,
    2.51e9 point pairs against the full list's 4.89e9."""
    pts = data_utils.generate_points(1024, dimension=2)
    op = TaperedMaternOperator(pts, 0.005, nu=0.5, density=1e-3,
                               device="cpu")
    walk = op._trace_walk
    assert len(op.pair_i) == 18_652 and op.tile == 512
    assert np.sum(op.pair_i < op.pair_j) == 8_302
    assert np.sum(op.pair_i == op.pair_j) == 2_048
    assert len(walk.units) == 153_312 and walk.symmetric
    assert cuda_kernels.trace_blocks(len(walk.units)) == (1, 153_312)
    units = walk.units.numpy()
    assert np.all(cuda_kernels.blocksparse_sub_tile_points(
        units, op.tile, op.shape[0]) == TILE)
    assert len(units) * TILE * TILE == 2_511_863_808
    assert np.sum(walk.weights) * TILE * TILE == 4_889_509_888
    # a diagonal tile's 4 + 6 units count 4 + 12 = 16, as many as each
    # ordered tile pair off the diagonal
    assert np.sum(walk.weights) == 16 * len(op.pair_i)


def _walk_trace(op, walk, tau):
    """sum k^2 over the walk in float64, weighted as the kernel weighs it,
    tapered at ``tau``."""
    n = op.shape[0]
    P = op.points_sorted
    rn = cuda_kernels.blocksparse_sub_tile_points(walk.units[:, 0], op.tile, n)
    cn = cuda_kernels.blocksparse_sub_tile_points(walk.units[:, 1], op.tile, n)
    total = 0.0
    for (i0, j0), w, a, b in zip(walk.units.tolist(), walk.weights, rn, cn):
        K = kernels.matern(kernels.pairwise_scaled_distance(
            P[i0:i0 + a], P[j0:j0 + b], 1.0), op.nu)
        K = torch.where(K >= tau, K, torch.zeros_like(K))
        total += int(w) * float(torch.sum(K * K))
    return total


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_walk_equals_plain_and_reference_trace(nu, d):
    """The symmetric walk of the operator's list (n = 700, tile 200: units
    of 128 and 72 points and a last tile of 100) in float64 against the
    plain full-list sum, the walk without the mirror, and the reference's
    trace_pow(2) (its XLA scan over every pair of the same list, pad
    rows subtracted). All at a threshold clear of every pair by 1e-5
    relative, so that the two packages' float64 k (1e-14 apart) taper the
    same entries. Only the summation order differs: rtol 1e-12."""
    n, tile = 700, 200
    pts, op = _operator(n, tile, d=d, nu=nu, seed=10 * d + int(nu))
    geometry = (op.pair_i, op._pair_j, op.tile)
    tau = cuda_kernels.blocksparse_clear_threshold(
        op.points_sorted, op.nu, op.threshold, *geometry, n=n)
    walk = cuda_kernels.blocksparse_trace_schedule(op.pair_i, op.pair_j,
                                                   op.tile, n)
    got = _walk_trace(op, walk, tau)
    _, plain = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted, None, op.nu, tau, *geometry, n=n, frobenius=True)
    np.testing.assert_allclose(got, float(plain), rtol=1e-12)
    full = cuda_kernels.blocksparse_trace_schedule(op.pair_i, op.pair_j,
                                                   op.tile, n,
                                                   symmetric=False)
    np.testing.assert_allclose(got, _walk_trace(op, full, tau), rtol=1e-12)
    jop = jtaper.TaperedMaternOperator(pts, SCALES[d], nu=nu, density=0.02,
                                       tile=tile, use_pallas=False)
    np.testing.assert_array_equal(jop.pair_i, op.pair_i)
    jop.threshold = tau
    np.testing.assert_allclose(got, float(jop.trace_pow(2)), rtol=1e-12)
