"""The general-nu dense assembly and the product's band sums on the CPU.

csrc/matern_general.cu's assembly entry writes, for a batch of (scale, nu)
points over one set of points, each K (or a block of its rows) from the
points: on the square K each k of the pairs above the diagonal once, to
K[i, j] and K[j, i], K[i, i] = 1. Its plain version,
``cuda_kernels.matern_general_assemble`` on CPU tensors, is held here to
the reference's ``gppe_tpu.ops.assembly.dense_correlation`` (JAX under
x64, tests/conftest.py) at rtol 1e-12, and to itself: a batch equals its
single calls bit for bit, a block of rows the square's rows (to 1e-14: a
lane's place in the vectorised Bessel loops picks SIMD or scalar
transcendentals), float64 output the float32 output widened bit for bit.
The card path of the wrapper and of its callers (the dense API,
MaternOperator.dense, the grid engine's dense chunk, the (rho, nu)
search's spectra, the tapered blocked rule) is driven on CPU tensors
against a stand-in library that computes each launch from the pointers it
is handed: one launch per K or per chunk, its arguments, the output dtype
and the counter. The product's band sum (``general_product_sum_plain``,
the plain version of its second kernel) is held bit for bit to the sum
written out in the walk's order. Inputs come from numpy seeds.
"""

import ctypes
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gppe_tpu.ops import assembly as jasm  # noqa: E402
from gppe_tpu_torch.drivers import find_optimal_covariance as tdrv  # noqa
from gppe_tpu_torch.models import grid_krylov as tgk  # noqa: E402
from gppe_tpu_torch.ops import _build, cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.ops import assembly as tasm  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

F32, F64 = torch.float32, torch.float64
T = cuda_kernels._TRACE_TILE
SIZE = cuda_kernels._CONSTS_DTYPE.itemsize

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _points(n, d, seed):
    return np.random.RandomState(seed).rand(n, d)


# -- the plain assembly against the reference ---------------------------------

@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("nu", [0.7, 1.2, 3.7, 12.3])
def test_plain_assembly_matches_reference(nu, d):
    """The plain assembly of the square K at a ragged n against the
    reference's dense_correlation in x64: rtol 1e-12; symmetric, unit
    diagonal."""
    pts = _points(257, d, seed=10 * d + int(nu))
    scale = 0.15 if d != 2 else np.array([0.1, 0.25])
    want = np.asarray(jasm.dense_correlation(pts, scale, nu,
                                             dtype=jnp.float64))
    scales = kernels.broadcast_scale(scale, d, dtype=F64)[None]
    got = cuda_kernels.matern_general_assemble(_t(pts), scales, (nu,),
                                               out_dtype=F64)
    assert got.shape == (1, 257, 257) and got.dtype == F64
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(torch.diagonal(got[0]).numpy(), 1.0)


def test_plain_batch_equals_single_calls():
    """A batch of four (scale, nu) points (per-dimension scales, a closed
    form among them) equals its four single calls bit for bit."""
    P = _t(_points(150, 2, seed=3))
    scales = _t([[0.1, 0.1], [0.2, 0.07], [0.15, 0.15], [0.05, 0.3]])
    nus = (0.7, 1.5, 3.7, 12.3)
    batch = cuda_kernels.matern_general_assemble(P, scales, nus,
                                                 out_dtype=F64)
    assert batch.shape == (4, 150, 150)
    for b, nu in enumerate(nus):
        one = cuda_kernels.matern_general_assemble(P, scales[b:b + 1], (nu,),
                                                   out_dtype=F64)
        assert torch.equal(batch[b], one[0])


@pytest.mark.parametrize("rows", [(0, 64), (64, 200), (199, 200), (0, 200)])
def test_plain_rows_equal_the_square_rows(rows):
    """A block of rows r0 <= i < r1 against every point equals those rows
    of the square K (rtol 1e-14)."""
    P = _t(_points(200, 2, seed=4))
    square = cuda_kernels.matern_general_assemble(P, [0.12], (3.7,))
    block = cuda_kernels.matern_general_assemble(P, [0.12], (3.7,),
                                                 rows=rows)
    assert block.shape == (1, rows[1] - rows[0], 200)
    np.testing.assert_allclose(block[0].numpy(),
                               square[0, rows[0]:rows[1]].numpy(),
                               rtol=1e-14, atol=1e-16)


def test_plain_float64_output_is_the_float32_widened():
    """On float32 points the float64 output is the float32 K widened, bit
    for bit (what the card writes, and what .to(torch.float64) gave)."""
    P = _t(_points(180, 2, seed=5), F32)
    k32 = cuda_kernels.matern_general_assemble(P, [0.1, 0.2], (1.2, 3.7))
    k64 = cuda_kernels.matern_general_assemble(P, [0.1, 0.2], (1.2, 3.7),
                                               out_dtype=F64)
    assert k32.dtype == F32 and k64.dtype == F64
    assert torch.equal(k64, k32.double())
    with pytest.raises(ValueError, match="out_dtype"):
        cuda_kernels.matern_general_assemble(P, [0.1], (1.2,),
                                             out_dtype=torch.float16)
    with pytest.raises(ValueError, match="rows"):
        cuda_kernels.matern_general_assemble(P, [0.1], (1.2,),
                                             rows=(10, 500))


def test_points_level_routes_and_mixed_batch():
    """assembly.correlations_of_points: the general nus of a batch in one
    call of the assembly entry, a closed form on the plain distances, each
    K equal to correlation_of_points of its (scale, nu) point."""
    P = _t(_points(120, 2, seed=6))
    calls = []
    entry = cuda_kernels.matern_general_assemble

    def spy(points, scales, nus, **kw):
        calls.append(list(nus))
        return entry(points, scales, nus, **kw)
    rhos, nus = [0.1, 0.2, 0.15], [1.2, 1.5, 3.7]
    try:
        cuda_kernels.matern_general_assemble = spy
        Ks = tasm.correlations_of_points(P, rhos, nus)
    finally:
        cuda_kernels.matern_general_assemble = entry
    assert calls == [[1.2, 3.7]]
    for b in range(3):
        assert torch.equal(Ks[b], tasm.correlation_of_points(P, rhos[b],
                                                             nus[b]))


# -- the band sum -------------------------------------------------------------

def _walk(tiles_r, tiles_c, symmetric):
    return [(ti, tj) for ti in range(tiles_r)
            for tj in range(ti if symmetric else 0, tiles_c)]


def _in_order_sum(grid, o, nr, nc, symmetric, g0, band_pairs):
    """The band's sum written out, pair by pair of the walk by its
    definition: each row tile's slots of the band, from 0 where the band
    holds its first slot, added to its rows in order of s (numpy float32,
    in place)."""
    tiles_r, tiles_c = -(-nr // T), -(-nc // T)
    index = {pair: g for g, pair in
             enumerate(_walk(tiles_r, tiles_c, symmetric))}
    for x in range(tiles_r):
        rows = slice(T * x, min(T * (x + 1), nr))
        m = rows.stop - rows.start
        ss = [s for s in range(tiles_r if symmetric else tiles_c)
              if g0 <= index[(min(s, x), max(s, x)) if symmetric
                             else (x, s)] < g0 + band_pairs]
        if not ss:
            continue
        total = (np.zeros((o.shape[0], m, o.shape[2]), np.float32)
                 if ss[0] == 0 else o[:, rows].copy())
        for s in ss:
            g = index[(min(s, x), max(s, x)) if symmetric else (x, s)]
            total += grid[:, g - g0, int(symmetric and s < x), :m]
        o[:, rows] = total


@pytest.mark.parametrize("nr, nc, symmetric", [
    (129, 129, True), (700, 700, True), (1000, 1000, True),
    (300, 129, False), (128, 1000, False)])
@pytest.mark.parametrize("band_pairs", [1, 4, 10])
def test_product_sum_plain_is_the_in_order_sum(nr, nc, symmetric,
                                               band_pairs):
    """general_product_sum_plain over every band of the walk, each band
    adding to what the bands before it wrote, equals the sum written out
    bit for bit (random float32 slots, three points, r = 5, into a
    32-column slice of a wider out)."""
    rng = np.random.RandomState(nr + band_pairs)
    B, r = 3, 5
    sides = 2 if symmetric else 1
    pairs = len(_walk(-(-nr // T), -(-nc // T), symmetric))
    band_pairs = min(band_pairs, pairs)
    out = torch.full((B, nr, r + 2), np.nan, dtype=F32)
    want = np.full((B, nr, r), np.nan, dtype=np.float32)
    for g0 in range(0, pairs, band_pairs):
        band = min(band_pairs, pairs - g0)
        slots = rng.standard_normal(
            B * band_pairs * sides * T * r).astype(np.float32)
        got = cuda_kernels.general_product_sum_plain(
            torch.from_numpy(slots), out[:, :, 1:1 + r], nc, symmetric, g0,
            band, band_pairs)
        assert got.data_ptr() == out[:, :, 1:].data_ptr()
        _in_order_sum(slots.reshape(B, band_pairs, sides, T, r), want, nr,
                      nc, symmetric, g0, band)
    assert not np.isnan(want).any()
    np.testing.assert_array_equal(out[:, :, 1:1 + r].numpy(), want)
    assert torch.isnan(out[:, :, 0]).all() and torch.isnan(out[:, :, -1]).all()


# -- the card path, on a stand-in library -------------------------------------

def _floats(ptr, count, ctype=ctypes.c_float):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)),
                                 shape=(count,))


class _AssemblyLibrary:
    """Stands in for the library's assembly and band-sum entries: the
    assembly takes each point's nu from its constants (among ``nus``) and
    writes its K (its rows) in float64 from the kernel's own float32 scaled
    points, rounded to float32 and written in the output's dtype; the band
    sum runs the plain version on the memory it is handed. Records the
    calls and the scales."""

    def __init__(self, nus):
        self.nus = tuple(nus)
        self.calls = []
        self.scales = []

    def gppe_matern_general_consts_bytes(self):
        return SIZE

    def gppe_matern_general_assemble(self, points, scales, consts, out, n, d,
                                     row0, nr, batch, symmetric, out_f64,
                                     stream):
        assert bool(symmetric) == (row0 == 0 and nr == n)
        x = _floats(points, n * d).reshape(n, d)
        sc = _floats(scales, batch * d).reshape(batch, d).copy()
        self.scales.append(sc)
        table = ctypes.string_at(consts, batch * SIZE)
        K = _floats(out, batch * nr * n,
                    ctypes.c_double if out_f64 else ctypes.c_float).reshape(
                        batch, nr, n)
        for b in range(batch):
            nu, = {nu for nu in self.nus
                   if cuda_kernels._general_consts(nu).tobytes()
                   == table[SIZE * b:SIZE * (b + 1)]}
            xs = _t(x / sc[b])               # the kernel's float32 division
            K[b] = kernels.matern(kernels.pairwise_scaled_distance(
                xs[row0:row0 + nr], xs, 1.0), nu).numpy().astype(np.float32)
        self.calls.append(("assemble", n, d, row0, nr, batch, int(symmetric),
                           "float64" if out_f64 else "float32"))
        return 0

    def gppe_matern_general_product_sum(self, slots, out, nr, nc, r, ldo,
                                        out_stride, batch, symmetric, g0,
                                        band_pairs, slot_pairs, stream):
        sides = 2 if symmetric else 1
        grid = torch.from_numpy(_floats(slots,
                                        batch * slot_pairs * sides * T * r))
        o = torch.from_numpy(np.lib.stride_tricks.as_strided(
            _floats(out, (batch - 1) * out_stride + (nr - 1) * ldo + r),
            (batch, nr, r), (4 * out_stride, 4 * ldo, 4), writeable=True))
        cuda_kernels.general_product_sum_plain(grid, o, nc, bool(symmetric),
                                               g0, band_pairs, slot_pairs)
        self.calls.append(("product_sum", nr, nc, r, ldo, out_stride, batch,
                           int(symmetric), g0, band_pairs, slot_pairs))
        return 0


def _fake_card(monkeypatch, nus):
    lib = _AssemblyLibrary(nus)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    cuda_kernels.reset_launch_counts()
    return lib


def _route_to_card(monkeypatch):
    """matern_general_assemble's card path for the callers' CPU tensors
    (float32, as the card takes them), its plain checks first."""
    def card(points, scales, nus, rows=None, out_dtype=F32):
        nus, scales = cuda_kernels._general_batch(points.float(), scales,
                                                  nus)
        n = points.shape[0]
        r0, r1 = (0, n) if rows is None else rows
        return cuda_kernels._matern_general_assemble_cuda(
            points.float().contiguous(), scales, nus, r0, r1, out_dtype)
    monkeypatch.setattr(cuda_kernels, "matern_general_assemble", card)


def _launches():
    return {k: v for k, v in cuda_kernels.launch_counts.items() if v}


@pytest.mark.parametrize("rows, out_dtype", [(None, F32), (None, F64),
                                             ((40, 170), F32)])
@pytest.mark.parametrize("max_batch", [65535, 2])
def test_card_path_assembly(monkeypatch, rows, out_dtype, max_batch):
    """The assembly's card path: one launch per _GENERAL_MAX_BATCH points
    (a cap of two cuts a batch of five into three), each on its points'
    scales and constants and its part of the output (offsets in the
    output's words), the square K on the symmetric walk, a block of rows
    on the rectangular one; counted under matern_general_assembly; equal
    to the plain float64 assembly within 1e-6."""
    nus = (0.7, 1.2, 3.7, 12.3, 24.9)
    rhos = [0.1, 0.2, 0.15, 0.05, 0.3]
    P = _t(_points(200, 2, seed=7), F32)
    monkeypatch.setattr(cuda_kernels, "_GENERAL_MAX_BATCH", max_batch)
    lib = _fake_card(monkeypatch, nus)
    r0, r1 = (0, 200) if rows is None else rows
    got = cuda_kernels._matern_general_assemble_cuda(
        P, _t(rhos, F32)[:, None].expand(5, 2), nus, r0, r1, out_dtype)
    assert got.shape == (5, r1 - r0, 200) and got.dtype == out_dtype
    name = "float64" if out_dtype == F64 else "float32"
    sizes = [min(max_batch, 5 - b0) for b0 in range(0, 5, max_batch)]
    assert lib.calls == [("assemble", 200, 2, r0, r1 - r0, k,
                          int(rows is None), name) for k in sizes]
    np.testing.assert_array_equal(np.concatenate(lib.scales),
                                  np.repeat(np.float32(rhos)[:, None], 2, 1))
    assert _launches() == {"matern_general_assembly": len(sizes)}
    want = cuda_kernels.matern_general_assemble(
        P.double(), _t(rhos), nus, rows=(r0, r1), out_dtype=F64)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               atol=1e-6)


def test_card_path_product_sum(monkeypatch):
    """The band sum's card path: the slots and the 32-column slice of a
    wider out (its row stride and point stride handed over), counted under
    matern_general_product_sum; the plain version's bits."""
    lib = _fake_card(monkeypatch, (1.2,))
    rng = np.random.RandomState(8)
    B, nr, r, band_pairs = 2, 300, 7, 4
    slots = _t(rng.standard_normal(B * band_pairs * 2 * T * r), F32)
    out = _t(rng.standard_normal((B, nr, 40)), F32)
    want = out.clone()
    cuda_kernels.general_product_sum_plain(slots, want[:, :, 32:39], nr, True,
                                           2, 3, band_pairs)
    cuda_kernels._general_product_sum_cuda(slots, out[:, :, 32:39], nr, True,
                                           2, 3, band_pairs)
    assert lib.calls == [("product_sum", nr, nr, r, 40, nr * 40, B, 1, 2, 3,
                          band_pairs)]
    assert _launches() == {"matern_general_product_sum": 1}
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="contiguous rows"):
        cuda_kernels._general_product_sum_cuda(
            slots, out.transpose(1, 2)[:, :7], nr, True, 2, 3, band_pairs)


def test_dense_api_and_operator_one_launch_per_k(monkeypatch):
    """dense_correlation and MaternOperator.dense at a general nu: one
    assembly launch each, on the symmetric walk; a closed form launches
    nothing."""
    pts = _points(300, 2, seed=9)
    lib = _fake_card(monkeypatch, (3.7,))
    _route_to_card(monkeypatch)
    K = tasm.dense_correlation(pts, 0.1, 3.7, dtype=F32, device="cpu")
    op = tops.MaternOperator(pts, 0.1, nu=3.7, device="cpu", dtype=F32)
    Kop = op.dense()
    assert [c[:7] for c in lib.calls] == [("assemble", 300, 2, 0, 300, 1,
                                           1)] * 2
    assert _launches() == {"matern_general_assembly": 2}
    assert K.shape == (300, 300) and K.dtype == F32 and torch.equal(K, Kop)
    tasm.dense_correlation(pts, 0.1, 1.5, dtype=F32, device="cpu")
    assert _launches() == {"matern_general_assembly": 2}


def test_grid_dense_chunk_one_launch_per_chunk(monkeypatch):
    """The grid engine's dense chunk: one assembly launch per chunk for
    its general nus (a closed form among them on the plain route), the
    chunk's scales handed over in order."""
    n = 128
    rng = np.random.RandomState(4)
    pts = rng.rand(n, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    rhos = np.array([0.08, 0.12, 0.1, 0.15])
    nus = np.array([0.7, 1.5, 3.7, 12.3])
    lib = _fake_card(monkeypatch, nus)
    _route_to_card(monkeypatch)
    tgk.GridKrylovProfileLikelihood(
        pts, X, z, rhos, nus, lanczos_steps=6, num_probes=4,
        matrix_free=False, chunk=2, device="cpu", dtype=F32,
        probes=np.sign(rng.standard_normal((n, 4))),
        v_defl=rng.standard_normal((n, 1)))
    assert [c[5] for c in lib.calls] == [1, 2]
    assert _launches() == {"matern_general_assembly": 2}
    np.testing.assert_array_equal(lib.scales[0], np.float32([[0.08, 0.08]]))
    np.testing.assert_array_equal(lib.scales[1],
                                  np.float32([[0.1, 0.1], [0.15, 0.15]]))


def test_spectra_one_launch_per_chunk_in_float64(monkeypatch):
    """The (rho, nu) search's lp: one assembly launch per chunk of its
    points (CHUNK_BYTES holding three float64 K), written as float64."""
    pts = tdata.generate_points(8, dimension=2)
    z = tdata.generate_data(pts, 0.05)
    X = tdata.generate_basis_functions(pts, 2)
    n = len(pts)
    monkeypatch.setattr(tdrv, "CHUNK_BYTES", 3 * 8 * n * n)
    rhos = [0.1, 0.15, 0.2, 0.25, 0.3, 0.12, 0.18]
    nus = [1.2, 3.7, 0.7, 12.3, 24.9, 2.2, 6.0]
    lib = _fake_card(monkeypatch, nus)
    _route_to_card(monkeypatch)
    lp = tdrv.build_objective(pts, z, X, False, device="cpu")[0]
    got = lp(np.array(rhos), np.array(nus))
    assert np.all(np.isfinite(got))
    assert [c[5:] for c in lib.calls] == [(3, 1, "float64"),
                                          (3, 1, "float64"),
                                          (1, 1, "float64")]
    assert _launches() == {"matern_general_assembly": 3}
    monkeypatch.undo()
    want = tdrv.build_objective(pts, z, X, False, device="cpu")[0](
        np.array(rhos), np.array(nus))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tapered_blocked_rule_on_the_assembly_entry(monkeypatch):
    """The tapered blocked rule at a general nu: one rectangular assembly
    launch per block of rows on the pre-scaled points at scale 1; its
    CSR's kept values within GENERAL_K_ATOL of the plain float64 rule's
    (the float32 points lie up to 20 scales out), the entries kept by one
    only within 1e-5 of the threshold."""
    pts = _points(300, 2, seed=11) / 0.05
    tau = 0.2
    lib = _fake_card(monkeypatch, (1.2,))
    _route_to_card(monkeypatch)
    got = ttaper._blocked_csr(pts, 1.2, tau, 128, torch.device("cpu"), F32)
    assert [c[3:7] for c in lib.calls] == [(0, 128, 1, 0), (128, 128, 1, 0),
                                           (256, 44, 1, 0)]
    np.testing.assert_array_equal(np.concatenate(lib.scales), 1.0)
    assert _launches() == {"matern_general_assembly": 3}
    monkeypatch.undo()
    want = ttaper._blocked_csr(pts, 1.2, tau, 128, torch.device("cpu"), F64)
    import scipy.sparse
    G = scipy.sparse.csr_matrix(got, shape=(300, 300))
    H = scipy.sparse.csr_matrix(want, shape=(300, 300))
    both = G.multiply(H.sign())
    assert abs(both - H.multiply(G.sign())).max() < (
        cuda_kernels.GENERAL_K_ATOL)
    flipped = abs(G.sign() - H.sign()).tocoo()
    d = np.linalg.norm(pts[flipped.row] - pts[flipped.col], axis=1)
    k64 = kernels.matern(_t(d), 1.2).numpy()
    assert np.all(np.abs(k64 - tau) < 1e-5)
