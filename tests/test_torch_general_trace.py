"""The general-nu traces on the CPU in float64: trace(K^2) of G1
(csrc/matern_general.cu's trace entry, batched over the (scale, nu) points
of a grid chunk) and of G2 (csrc/matern_blocksparse_general.cu's, over the
tapered pair list with the taper skip).

Both kernels fill the branch-binned k tile of csrc/matern_general_tile.cuh
(64 rows by 128 columns) and, where K is square and symmetric, count only
the pairs above its diagonal, each twice, the diagonal's n ones added by
the caller. Here: their plain versions against the JAX reference (gppe_tpu
under x64, tests/conftest.py); their walks, mirrored in numpy, covering
every ordered pair of K (of the pair list) exactly once; and their card
paths driven on CPU tensors against stand-ins that compute each launch
from the pointers they are handed, as the kernels do. Inputs come from
numpy seeds.
"""

import ctypes
import os
import re
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch.models import grid_krylov as tgk  # noqa: E402
from gppe_tpu_torch.ops import _build, cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.ops.taper import TaperedMaternOperator  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

F32, F64 = torch.float32, torch.float64
ROWS, TILE = cuda_kernels._TILE_ROWS, cuda_kernels._TRACE_TILE
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gppe_tpu_torch", "csrc")

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _count_pairs(counts, I, J, symmetric):
    """Add one unit's counted pairs: on a symmetric walk the pairs with
    column past row, each an ordered pair and its mirror (weight 2)."""
    if symmetric:
        keep = J > I
        np.add.at(counts, (I[keep], J[keep]), 1)
        np.add.at(counts, (J[keep], I[keep]), 1)
    else:
        np.add.at(counts, (I, J), 1)


# -- G1 ----------------------------------------------------------------------

@pytest.mark.parametrize("nu", [0.7, 1.2, 3.7])
def test_plain_trace_batched_matches_reference(nu):
    """matern_general_trace_batched's plain version, a batch of two scales
    (one per dimension for the second), against the reference's XLA pass
    of MaternOperator.trace_pow(2), _matern_frobenius2_blocked, in x64:
    rtol 1e-10; each point equals matern_general_matmat's trace."""
    n = 256
    pts = np.random.RandomState(int(10 * nu)).rand(n, 2)
    scales = np.array([[0.1, 0.1], [0.25, 0.15]])
    P = _t(pts)
    got = cuda_kernels.matern_general_trace_batched(P, _t(scales), (nu, nu))
    assert got.shape == (2,) and got.dtype == F64
    for b in range(2):
        want = float(jops._matern_frobenius2_blocked(
            jnp.asarray(pts), jnp.asarray(scales[b]), nu, n))
        np.testing.assert_allclose(float(got[b]), want, rtol=1e-10)
        assert float(got[b]) == float(cuda_kernels.matern_general_matmat(
            P, _t(scales[b]), None, nu, frobenius=True)[1])


def _g1_walk_counts(nr, nc, symmetric):
    """How often the general-nu trace kernel counts each ordered pair of
    an nr x nc K: its blocks' tile pairs (trace_tile_pair), each as k
    tiles of 64 rows, pair (i, j) of a tile counted where j - i > diag,
    diag = the tile's first row less its first column on the square K
    (else every pair), and the sum kernel's n diagonal ones."""
    tiles_r, tiles_c, pairs, _, _ = cuda_kernels.trace_schedule(nr, nc,
                                                                symmetric)
    counts = np.zeros((nr, nc), np.int64)
    for p in range(pairs):
        ti, tj, _ = cuda_kernels.trace_tile_pair(p, tiles_r, tiles_c,
                                                 symmetric)
        i0, j0 = TILE * ti, TILE * tj
        for r0 in range(i0, min(i0 + TILE, nr), ROWS):
            I, J = np.meshgrid(np.arange(r0, min(r0 + ROWS, nr)),
                               np.arange(j0, min(j0 + TILE, nc)),
                               indexing="ij")
            _count_pairs(counts, I, J, symmetric)
    if symmetric:
        counts[np.arange(nr), np.arange(nr)] += 1
    return counts


@pytest.mark.parametrize("nr, nc", [(1, 1), (64, 64), (127, 127),
                                    (128, 128), (129, 129), (300, 300),
                                    (700, 700), (300, 170), (129, 700)])
def test_g1_walk_counts_every_pair_once(nr, nc):
    """The square K's walk (the triangle tj >= ti, only the pairs above
    the diagonal, twice, and the n ones) and the rectangular one (every
    tile pair, every pair once) each count every ordered pair of K once,
    at ragged sizes and across the 64-row halves of a tile pair."""
    for symmetric in ((True, False) if nr == nc else (False,)):
        assert np.all(_g1_walk_counts(nr, nc, symmetric) == 1), symmetric


def test_g1_source_mask_and_weights():
    """The kernel's mask and weights, as the walk above mirrors them."""
    with open(os.path.join(CSRC, "matern_general.cu")) as f:
        src = f.read()
    assert "symmetric ? i0 + r0 - j0 : -kTileRows" in src
    assert "symmetric ? 2.0 * total : total" in src
    assert "symmetric ? static_cast<double>(nr) : 0.0" in src
    with open(os.path.join(CSRC, "matern_general_tile.cuh")) as f:
        tile = f.read()
    assert f"constexpr int kTileRows = {ROWS};" in tile
    assert f"constexpr int kTileCols = {TILE};" in tile


class _TraceLibrary:
    """Stands in for the library's general-nu trace entry: for each point
    of the launch its nu from its constants and its scale, the kernel's
    float32 division of the points by it, then float64 k on those; on the
    square K twice the pairs above the diagonal plus n, else every pair.
    Fills the launch's whole partials scratch and records the calls."""

    def __init__(self, nus):
        self.nus = tuple(nus)
        self.calls = []

    def gppe_matern_general_consts_bytes(self):
        return cuda_kernels._CONSTS_DTYPE.itemsize

    def gppe_matern_general_trace(self, rows, cols, scales, consts, partials,
                                  out, nr, nc, d, symmetric, per_block,
                                  blocks, batch, stream):
        def floats(ptr, count):
            return np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)),
                shape=(count,))

        def doubles(ptr, count):
            return np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double)),
                shape=(count,))

        assert (per_block, blocks) == cuda_kernels.trace_schedule(
            nr, nc, bool(symmetric))[3:]
        size = cuda_kernels._CONSTS_DTYPE.itemsize
        table = np.ctypeslib.as_array(
            ctypes.cast(consts, ctypes.POINTER(ctypes.c_uint8)),
            shape=(batch * size,))
        x = floats(rows, nr * d).reshape(nr, d)
        y = floats(cols, nc * d).reshape(nc, d)
        sc = floats(scales, batch * d).reshape(batch, d)
        doubles(partials, batch * blocks)[:] = np.nan
        traces = doubles(out, batch)
        for b in range(batch):
            nu, = [nu for nu in self.nus
                   if cuda_kernels._general_consts(nu).tobytes()
                   == table[size * b:size * (b + 1)].tobytes()]
            K = kernels.matern(kernels.pairwise_scaled_distance(
                _t(x / sc[b]), _t(y / sc[b]), 1.0), nu).numpy()
            traces[b] = (2.0 * np.sum(np.triu(K, 1) ** 2) + nr if symmetric
                         else np.sum(K * K))
        self.calls.append((int(symmetric), blocks, batch))
        return 0


def _fake_card(monkeypatch, lib):
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    cuda_kernels.reset_launch_counts()
    return lib


@pytest.mark.parametrize("cap_points", [None, 2])
def test_trace_card_path_batched(monkeypatch, cap_points):
    """The batched trace's card path: one launch for a batch of five
    (scale, nu) points (a closed form among them), or, with the partials
    capped at two points' worth, launches of 2, 2 and 1 points, each with
    its points' constants and scales; the same results either way, and
    each point's trace within 1e-6 of the plain float64 version."""
    nus = (0.7, 1.5, 3.7, 12.3, 1.2)
    rhos = np.array([0.1, 0.2, 0.07, 0.15, 0.3])
    n = 300
    pts = _t(np.random.RandomState(5).rand(n, 2), F32)
    blocks = cuda_kernels.trace_schedule(n, n, True)[4]
    if cap_points is not None:
        monkeypatch.setattr(cuda_kernels, "_GENERAL_TRACE_PARTIALS",
                            cap_points * blocks)
    lib = _fake_card(monkeypatch, _TraceLibrary(nus))
    got = cuda_kernels._general_trace_cuda(
        pts, pts, _t(np.repeat(rhos[:, None], 2, axis=1), F32), nus, True)
    widths = [5] if cap_points is None else [2, 2, 1]
    assert lib.calls == [(1, blocks, w) for w in widths]
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_general_trace": len(widths)}
    want = cuda_kernels.matern_general_trace_batched(pts.double(), _t(rhos),
                                                     nus)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_grid_chunk_one_trace_launch(monkeypatch):
    """The matrix-free grid chunk over general nus: its traces are one
    launch for the chunk's four points (each with its own scale and nu),
    not one a point, and equal the plain float64 traces within 1e-6."""
    n, steps, probes = 128, 6, 4
    rng = np.random.RandomState(0)
    pts = rng.rand(n, 2)
    z = tdata.generate_data(pts, 0.1)
    X = tdata.generate_basis_functions(pts, 1)
    rhos, nus = np.array([0.08, 0.12, 0.1, 0.15]), (0.7, 1.5, 3.7, 12.3)
    lib = _fake_card(monkeypatch, _TraceLibrary(nus))
    seen = []

    def traces(points, scales, nus_, block_rows=1024):
        d = points.shape[1]
        out = cuda_kernels._general_trace_cuda(
            points, points, scales[:, None].expand(len(nus_), d).contiguous(),
            tuple(nus_), True)
        seen.append(out)
        return out

    monkeypatch.setattr(cuda_kernels, "matern_general_trace_batched", traces)
    tgk.GridKrylovProfileLikelihood(
        pts, X, z, rhos, np.array(nus), lanczos_steps=steps,
        num_probes=probes, matrix_free=True, device="cpu", dtype=F32,
        probes=np.sign(rng.standard_normal((n, probes))),
        v_defl=rng.standard_normal((n, 1)))
    assert lib.calls == [(1, cuda_kernels.trace_schedule(n, n, True)[4], 4)]
    assert cuda_kernels.launch_counts["matern_general_trace"] == 1
    assert cuda_kernels.launch_counts["matern_general_product"] == 0
    monkeypatch.undo()
    want = cuda_kernels.matern_general_trace_batched(
        _t(pts), _t(rhos), nus)
    np.testing.assert_allclose(seen[0].numpy(), want.numpy(), rtol=1e-6)


# -- G2 ----------------------------------------------------------------------

# correlation scales that put the taper radius (density 0.02) 1.6 to 3
# scales out (tests/test_torch_taper_trace.py)
SCALES = {1: 0.005, 2: 0.05, 3: 0.05 * np.sqrt(1.5)}


def _operator(n, tile, d=2, nu=1.2, seed=0, dtype=F64):
    pts = np.random.RandomState(seed).rand(n, d)
    return pts, TaperedMaternOperator(pts, SCALES[d], nu=nu, density=0.02,
                                      tile=tile, device="cpu", dtype=dtype)


def _list_counts(op):
    """How often each ordered pair of real points lies in the pair list."""
    n, t = op.shape[0], op.tile
    want = np.zeros((n, n), np.int64)
    for i, j in zip(op.pair_i, op.pair_j):
        want[t * i:min(t * (i + 1), n), t * j:min(t * (j + 1), n)] += 1
    return want


def _g2_units(op, walk):
    n = op.shape[0]
    rows = cuda_kernels.blocksparse_sub_tile_points(walk.units[:, 0], op.tile,
                                                    n, ROWS)
    cols = cuda_kernels.blocksparse_sub_tile_points(walk.units[:, 1], op.tile,
                                                    n)
    return zip(walk.units.tolist(), walk.weights, rows, cols)


def _g2_walk_counts(op, walk):
    """How often the tapered general-nu trace kernel counts each ordered
    pair of points over ``walk``: each unit's pairs as _count_pairs takes
    them at its weight, and on the symmetric walk the n diagonal ones."""
    n = op.shape[0]
    counts = np.zeros((n, n), np.int64)
    for (i0, j0), w, a, b in _g2_units(op, walk):
        assert w == (2 if walk.symmetric else 1)
        I, J = np.meshgrid(np.arange(i0, i0 + a), np.arange(j0, j0 + b),
                           indexing="ij")
        assert not walk.symmetric or np.any(J > I)  # no empty unit
        _count_pairs(counts, I, J, walk.symmetric)
    if walk.symmetric:
        counts[np.arange(n), np.arange(n)] += 1
    return counts


@pytest.mark.parametrize("n, tile", [(1000, 128), (700, 200), (1030, 512),
                                     (100, 512), (1500, 200)])
def test_g2_walk_counts_every_pair_of_the_list_once(n, tile):
    """On the operator's mirrored list at ragged n, tile 128, 200 (units
    of 64 / 8 rows and 128 / 72 columns), 512 (a last tile of 6 points at
    n = 1030) and 100 (n under 128): the symmetric walk (tile pairs
    ti <= tj, of a diagonal tile pair only the units holding a pair above
    the diagonal, weight 2) and the walk without the mirror (every unit,
    weight 1) each count every ordered pair of the list once, and no other.
    The operator's own walk is the symmetric one, on its device."""
    _, op = _operator(n, tile, seed=n)
    walk = cuda_kernels.blocksparse_general_trace_schedule(
        op.pair_i, op.pair_j, op.tile, n)
    assert walk.symmetric and walk.unit_rows == ROWS
    assert walk.units.dtype == np.int32
    assert np.array_equal(walk.units, op._trace_walk.units.numpy())
    assert op._trace_walk.unit_rows == ROWS
    rows, cols = walk.units[:, 0] // op.tile, walk.units[:, 1] // op.tile
    assert np.all(rows <= cols)
    want = _list_counts(op)
    assert want.max() == 1
    assert np.array_equal(_g2_walk_counts(op, walk), want)
    full = cuda_kernels.blocksparse_general_trace_schedule(
        op.pair_i, op.pair_j, op.tile, n, symmetric=False)
    assert not full.symmetric
    assert np.array_equal(_g2_walk_counts(op, full), want)
    # without its mirror a list is walked whole, whatever is asked
    upper = op.pair_i <= op.pair_j
    half = cuda_kernels.blocksparse_general_trace_schedule(
        op.pair_i[upper], op.pair_j[upper], op.tile, n)
    assert half.symmetric == bool(np.all(upper))


def _walk_trace(op, walk, tau):
    """sum k^2 over the walk in float64, tapered at ``tau``, counted as
    the kernel counts it, plus the diagonal's n ones on the symmetric
    walk."""
    P = op.points_sorted
    total = 0.0
    for (i0, j0), w, a, b in _g2_units(op, walk):
        K = kernels.matern(kernels.pairwise_scaled_distance(
            P[i0:i0 + a], P[j0:j0 + b], 1.0), op.nu)
        K = torch.where(K >= tau, K, torch.zeros_like(K))
        if walk.symmetric:
            K = torch.triu(K, diagonal=i0 - j0 + 1)    # column past row
        total += int(w) * float(torch.sum(K * K))
    return total + (op.shape[0] if walk.symmetric else 0)


@pytest.mark.parametrize("nu, d", [(0.7, 2), (3.7, 3)])
def test_g2_walk_trace_equals_plain_and_reference(nu, d):
    """The general walk of the operator's list (n = 500, tile 200) in
    float64 against the plain full-list sum (rtol 1e-12: only the order
    differs), and the plain tapered trace, the operator's trace_pow(2),
    against the reference's trace_pow(2) (its XLA scan over every pair of
    the same list) at rtol 1e-8; all at a threshold clear of every pair by 1e-5 relative, so that
    the two packages' float64 k taper the same entries."""
    n, tile = 500, 200
    pts, op = _operator(n, tile, d=d, nu=nu, seed=10 * d + int(nu))
    geometry = (op.pair_i, op._pair_j, op.tile)
    tau = cuda_kernels.blocksparse_clear_threshold(
        op.points_sorted, op.nu, op.threshold, *geometry, n=n)
    _, plain = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted, None, op.nu, tau, *geometry, n=n, frobenius=True)
    np.testing.assert_allclose(_walk_trace(op, op._trace_walk, tau),
                               float(plain), rtol=1e-12)
    op.threshold = tau
    assert float(op.trace_pow(2)) == float(plain)
    jop = jtaper.TaperedMaternOperator(pts, SCALES[d], nu=nu, density=0.02,
                                       tile=tile, use_pallas=False)
    np.testing.assert_array_equal(jop.pair_i, op.pair_i)
    jop.threshold = tau
    np.testing.assert_allclose(float(plain), float(jop.trace_pow(2)),
                               rtol=1e-8)


class _TaperTraceLibrary:
    """Stands in for the library's tapered general-nu trace entry: each
    block's units as the kernel walks them, float64 k on the kernel's
    float32 points, 0 past skip2 or below tau, only the pairs above the
    diagonal on the symmetric walk, each twice."""

    def __init__(self, nu):
        self.nu = nu
        self.calls = []

    def gppe_matern_general_consts_bytes(self):
        return cuda_kernels._CONSTS_DTYPE.itemsize

    def gppe_matern_blocksparse_general_trace(
            self, pts, units, partials, n, d, tile, num_units, symmetric,
            tau, skip2, per_block, blocks, consts, stream):
        size = cuda_kernels._CONSTS_DTYPE.itemsize
        assert ctypes.string_at(consts, size) == (
            cuda_kernels._general_consts(self.nu).tobytes())
        assert (per_block, blocks) == cuda_kernels.trace_blocks(num_units)
        n_pad = -(-n // tile) * tile
        P = np.ctypeslib.as_array(
            ctypes.cast(pts, ctypes.POINTER(ctypes.c_float)),
            shape=(n_pad * d,)).reshape(n_pad, d)
        U = np.ctypeslib.as_array(
            ctypes.cast(units, ctypes.POINTER(ctypes.c_int32)),
            shape=(num_units * 2,)).reshape(num_units, 2)
        out = np.ctypeslib.as_array(
            ctypes.cast(partials, ctypes.POINTER(ctypes.c_double)),
            shape=(blocks,))
        rows = cuda_kernels.blocksparse_sub_tile_points(U[:, 0], tile, n,
                                                        ROWS)
        cols = cuda_kernels.blocksparse_sub_tile_points(U[:, 1], tile, n)
        out[:] = 0.0
        for u, ((i0, j0), a, b) in enumerate(zip(U.tolist(), rows, cols)):
            x, y = _t(P[i0:i0 + a]), _t(P[j0:j0 + b])
            d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
            K = kernels.matern(torch.sqrt(d2), self.nu)
            K = torch.where((K >= tau) & (d2 <= skip2), K,
                            torch.zeros_like(K))
            if symmetric:
                K = torch.triu(K, diagonal=i0 - j0 + 1)
            out[u // per_block] += (1 + symmetric) * float(torch.sum(K * K))
        self.calls.append((num_units, int(symmetric), skip2))
        return 0


def test_g2_trace_card_path(monkeypatch):
    """The tapered general-nu trace's card path: one launch over the
    operator's walk (or, handed none, the walk built here, the same),
    the skip radius's square handed to the kernel, the diagonal's n ones
    added; within 1e-6 of the plain float64 trace at a clear threshold. A
    closed-form walk handed to a general nu raises."""
    n, tile, nu = 500, 200, 1.2
    _, op = _operator(n, tile, nu=nu, seed=3, dtype=F32)
    tau = cuda_kernels.blocksparse_clear_threshold(
        op.points_sorted.double(), nu, op.threshold, op.pair_i, op._pair_j,
        tile, n=n)
    args = (nu, tau, op.pair_i, op._pair_j, tile)
    kw = dict(n=n, row_ptr=op._row_ptr)
    lib = _fake_card(monkeypatch, _TaperTraceLibrary(nu))
    got = cuda_kernels._matern_matmat_blocksparse_cuda(
        op.points_sorted, None, *args, n, True, op._row_ptr, "highest",
        op._trace_walk)[1]
    again = cuda_kernels._matern_matmat_blocksparse_cuda(
        op.points_sorted, None, *args, n, True, op._row_ptr, "highest")[1]
    skip2 = cuda_kernels._blocksparse_skip2(nu, tau)
    assert np.isfinite(skip2)
    assert lib.calls == [(len(op._trace_walk.units), 1, skip2)] * 2
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_blocksparse_general_trace": 2}
    assert got.dtype == F64 and float(got) == float(again)
    _, want = cuda_kernels.matern_matmat_blocksparse_plain(
        op.points_sorted.double(), None, *args, frobenius=True, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    closed = cuda_kernels.blocksparse_trace_schedule(op.pair_i, op.pair_j,
                                                     tile, n)
    with pytest.raises(ValueError, match="units of 128 rows"):
        cuda_kernels._matern_matmat_blocksparse_cuda(
            op.points_sorted, None, *args, n, True, op._row_ptr, "highest",
            closed._replace(units=torch.as_tensor(closed.units)))


# -- the C interface -----------------------------------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


def test_entry_signatures_match_the_sources(monkeypatch):
    """Every extern "C" entry of the kernel sources has the argument types
    that _build.load declares for it (a pointer passed where the entry
    takes an int would reach the card truncated): parsed from the
    sources, against the declarations of a stand-in library."""
    class Library:
        def __getattr__(self, name):
            entry = SimpleNamespace(argtypes=None, restype=None)
            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(ctypes, "CDLL", lambda path: Library())
    lib = _build.load(path="stand-in")
    entries = {}
    for source in _build.SOURCES:
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        for name, args in re.findall(
                r'extern "C" [\w ]+?\*? ?(gppe_\w+)\(([^)]*)\)', text):
            entries[name] = [
                _C_TYPES[re.sub(r"\s*\w+$", "", arg.strip())]
                for arg in args.split(",") if arg.strip()]
    assert {"gppe_matern_general_trace",
            "gppe_matern_blocksparse_general_trace",
            "gppe_matern_general_assemble", "gppe_matern_general_product",
            "gppe_matern_general_product_sum"} <= set(entries)
    for name, types in entries.items():
        assert getattr(lib, name).argtypes == types, name
