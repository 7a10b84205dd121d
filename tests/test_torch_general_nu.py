"""General Matern nu in gppe_tpu_torch vs gppe_tpu, on the CPU in float64.

Inputs come from numpy seeds and go through both packages (JAX under x64,
tests/conftest.py). On the CPU every general-nu entry of the port runs the
plain version of ``csrc/matern_general.cu``: ``kernels.matern`` over the
ported Bessel K_nu. Tolerances: the kernel, ``generate_correlation``,
``MaternOperator.matmat`` and ``trace_pow(2)`` rtol 1e-11 (the same
algorithm, summed in another order); the grid engine over general nus,
dense and matrix-free, per-point eta, sigma and sigma0 rtol 1e-6 (the
bound of tests/test_torch_grid_krylov.py: two Lanczos passes in float64).

The card path of the wrappers (launch plan, pointer offsets, the batch's
constants and scales, the product's slot grid and its sum in order) is
driven on CPU tensors against a stand-in library that computes each
launch in float64 from the pointers it is handed; the tapered product's
skip radius is held to the plain float32 k.
"""

import ctypes
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.special

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gppe_tpu  # noqa: E402
from gppe_tpu.models import grid_krylov as jgk  # noqa: E402
from gppe_tpu.ops import assembly as jasm  # noqa: E402
from gppe_tpu.ops import kernels as jk  # noqa: E402
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import special as jspecial  # noqa: E402
from gppe_tpu_torch.models import grid_krylov as tgk  # noqa: E402
from gppe_tpu_torch.ops import _build, cuda_kernels, special  # noqa: E402
from gppe_tpu_torch.ops import assembly as tasm  # noqa: E402
from gppe_tpu_torch.ops import kernels as tk  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

F32, F64 = torch.float32, torch.float64
CPU = dict(device="cpu", dtype=F64)
# chip_smoke.py phase 21's orders, and orders next to the closed forms
NUS = [0.01, 0.3, 1.2, 3.7, 10.0, 24.9]


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# -- the kernel k(x; nu) ------------------------------------------------------

X = np.concatenate([[0.0], np.geomspace(1e-5, 40.0, 300)])


@pytest.mark.parametrize("nu", NUS + [0.5, 2.5, 150.0])
def test_matern_static_nu(nu):
    want = np.asarray(jk.matern(jnp.asarray(X), nu))
    got = tk.matern(_t(X), nu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-300)
    assert got[0] == 1.0 and np.all((got >= 0) & (got <= 1))
    # the elementwise wrapper takes the same plain version on the CPU
    np.testing.assert_array_equal(cuda_kernels.matern_general(_t(X), nu),
                                  got)


@pytest.mark.parametrize("nu", [0.3, 0.5, 1.5, 2.5, 3.7, 100.0, 150.0])
def test_matern_tensor_nu_selects_like_reference(nu):
    """A tensor nu evaluates every branch and selects elementwise (closed
    forms at exactly 0.5, 1.5, 2.5, the Gaussian from 100, the Bessel form
    otherwise), the reference's traced nu."""
    want = np.asarray(jk.matern(jnp.asarray(X), jnp.asarray(nu)))
    got = tk.matern(_t(X), torch.tensor(nu, dtype=F64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-300)
    np.testing.assert_allclose(got, tk.matern(_t(X), nu).numpy(),
                               rtol=1e-13, atol=1e-300)


def _matern_scipy(nu, x):
    z = np.sqrt(2.0 * nu) * x
    return np.exp((1.0 - nu) * np.log(2.0) - scipy.special.gammaln(nu)
                  + nu * np.log(z) + np.log(scipy.special.kv(nu, z)))


def test_matern_nu_derivative_forward_mode():
    """d k / d nu by torch.func.jvp through the log-space form, against
    the reference's jax.jvp, at a general and a large nu; and at
    sqrt(2 nu) x = 2 exactly, the branch point, against central
    differences of scipy. There the reference's jnp.maximum(x, 2) splits
    its tie gradient and halves dz (4.6e-2 against 5.2e-4 at nu = 12.5,
    x = 0.4); the port takes each lane through its own branch."""
    x = np.array([0.05, 0.41, 1.0, 3.0])
    ref = jax.jit(lambda n: jax.jvp(lambda m: jk.matern(jnp.asarray(x), m),
                                    (n,), (jnp.ones_like(n),))[1])
    for nu in (1.2, 12.5):
        want = ref(jnp.asarray(nu))
        _, got = torch.func.jvp(lambda n: tk.matern(_t(x), n),
                                (torch.tensor(nu, dtype=F64),),
                                (torch.tensor(1.0, dtype=F64),))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    _, got = torch.func.jvp(lambda n: tk.matern(_t([0.4]), n),
                            (torch.tensor(12.5, dtype=F64),),
                            (torch.tensor(1.0, dtype=F64),))
    h = 1e-6
    fd = (_matern_scipy(12.5 + h, 0.4) - _matern_scipy(12.5 - h, 0.4)) / (
        2 * h)
    assert float(got[0]) == pytest.approx(fd, rel=1e-5)


def test_is_closed_form():
    assert all(tk.is_closed_form(v) for v in (0.5, 1.5, 2.5, 100.0, 1e3))
    assert not any(tk.is_closed_form(v) for v in (0.49, 1.0, 2.0, 99.9))


# -- assembly -----------------------------------------------------------------

@pytest.fixture(scope="module")
def points():
    return np.random.RandomState(0).rand(200, 2)


@pytest.mark.parametrize("nu, scale", [(0.3, 0.1),
                                       (3.7, np.array([0.08, 0.2]))],
                         ids=["isotropic", "anisotropic"])
def test_generate_correlation_general_nu(points, nu, scale):
    want = np.asarray(gppe_tpu.generate_correlation(points, scale, nu=nu))
    got = tasm.generate_correlation(points, scale, nu=nu, **CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-15)
    np.testing.assert_array_equal(torch.diagonal(got).numpy(), 1.0)
    blocked = tasm.dense_correlation_blocked(points, scale, nu,
                                             block_size=64, **CPU)
    # not bit for bit: a lane's place in the vectorised loops (which the
    # converged lanes leave) picks SIMD or scalar transcendentals
    np.testing.assert_allclose(blocked.numpy(), got.numpy(), rtol=1e-14,
                               atol=1e-16)
    np.testing.assert_allclose(
        blocked.numpy(),
        np.asarray(jasm.dense_correlation_blocked(points, scale, nu,
                                                  block_size=64)),
        rtol=1e-11, atol=1e-15)


# -- the operator -------------------------------------------------------------

@pytest.mark.parametrize("nu", [1.2, 10.0])
def test_operator_matmat_and_trace(points, nu):
    """MaternOperator at general nu on its plain row-blocked path against
    the reference's XLA path (use_pallas=False), product and trace(K^2)."""
    V = np.random.RandomState(1).standard_normal((len(points), 5))
    jop = jops.MaternOperator(points, 0.1, nu=nu, block_rows=64,
                              dtype=jnp.float64, use_pallas=False)
    top = tops.MaternOperator(points, 0.1, nu=nu, block_rows=64, **CPU)
    np.testing.assert_allclose(top.matmat(_t(V)).numpy(),
                               np.asarray(jop.matmat(V)), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(float(top.trace_pow(2)),
                               float(jop.trace_pow(2)), rtol=1e-11)
    np.testing.assert_allclose(top.matvec(_t(V[:, 0])).numpy(),
                               np.asarray(jop.matvec(V[:, 0])), rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("nu", [0.5, 1.2, 10.0])
def test_operator_dense(points, nu, monkeypatch):
    """MaternOperator.dense() against the reference's, rtol 1e-11; a
    general nu goes through the general-nu entry point (the elementwise
    kernel on the card), a closed form does not."""
    jop = jops.MaternOperator(points, 0.1, nu=nu, dtype=jnp.float64,
                              use_pallas=False)
    top = tops.MaternOperator(points, 0.1, nu=nu, **CPU)
    calls = []
    entry = cuda_kernels.matern_general
    monkeypatch.setattr(cuda_kernels, "matern_general",
                        lambda x, nu: calls.append(nu) or entry(x, nu))
    np.testing.assert_allclose(top.dense().numpy(), np.asarray(jop.dense()),
                               rtol=1e-11, atol=1e-15)
    assert calls == ([] if tk.is_closed_form(nu) else [nu])


def test_general_matmat_rectangular_and_modes(points):
    """The general product of distinct row and column points against a
    dense float64 K; matern_matmat hands a general nu to it whatever its
    dot mode (the general product is exact)."""
    rng = np.random.RandomState(2)
    cols = rng.rand(70, 2)
    V = _t(rng.standard_normal((70, 3)))
    dist = tk.pairwise_scaled_distance(_t(points), _t(cols), 0.15)
    want = tk.matern(dist, 3.7) @ V
    got, fro = cuda_kernels.matern_general_matmat(
        _t(points), 0.15, V, 3.7, points_cols=_t(cols), frobenius=True,
        block_rows=50)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(fro), float(
        torch.sum(tk.matern(dist, 3.7) ** 2)), rtol=1e-12)
    for mode in cuda_kernels.DOT_MODES:
        np.testing.assert_array_equal(cuda_kernels.matern_matmat(
            _t(points), 0.15, V, 3.7, points_cols=_t(cols), dot_mode=mode,
            block_rows=50).numpy(), got.numpy())


@pytest.mark.parametrize("bad", [0.0, -1.0, "half", None])
def test_non_positive_nu_raises(points, bad):
    with pytest.raises(ValueError, match="positive"):
        cuda_kernels.matern_general(_t(X), bad)
    with pytest.raises(ValueError, match="positive"):
        tops.MaternOperator(points, 0.1, nu=bad, **CPU)


def test_closed_form_only_kernels_refuse_general_nu(points):
    """The multi-rho kernel takes the closed forms, as the reference's
    does; the tapered kernel and operator take a general nu (their plain
    version here; tests/test_torch_taper_general.py holds them against the
    reference)."""
    P = _t(points)
    with pytest.raises(NotImplementedError, match="general nu"):
        cuda_kernels.matern_matmat_multirho(P, [0.1, 0.2], None, 1.2,
                                            return_frobenius=True)
    _, fro = cuda_kernels.matern_matmat_blocksparse(
        P, None, 1.2, 0.1, [0], [0], 200, frobenius=True)
    Kd = tk.matern(tk.pairwise_scaled_distance(P, P, 1.0), 1.2)
    np.testing.assert_allclose(
        float(fro), float(torch.sum(torch.where(Kd >= 0.1, Kd, 0.0) ** 2)),
        rtol=1e-12)
    from gppe_tpu_torch.ops import taper as ttaper
    assert ttaper.TaperedMaternOperator(points, 0.1, nu=1.2, density=0.1,
                                        **CPU).nu == 1.2


# -- the per-launch constants and the card path's routing ---------------------

@pytest.mark.parametrize("nu", NUS + [0.5, 1.5, 2.5, 150.0])
def test_general_consts(nu):
    """The kernel's per-launch struct: 1752 bytes (csrc/matern_bessel.cuh);
    a closed form's mode code; for a general nu, mu and round(nu), and
    Temme's gam1 and gam2 equal to the reference's _chepolish to float32
    rounding."""
    c = cuda_kernels._general_consts(nu)
    assert c.nbytes == 1752
    if tk.is_closed_form(nu):
        assert int(c["mode"]) == {0.5: 0, 1.5: 1, 2.5: 2}.get(nu, 3)
        return
    nl = int(np.floor(nu + 0.5))
    mu = nu - nl
    assert int(c["mode"]) == 4 and int(c["nl"]) == nl
    sqrt2nu, c_mu, a1, fact, gam1, gam2 = c["scalars"][:6]
    assert sqrt2nu == np.float32(np.sqrt(2 * nu)) and c_mu == np.float32(mu)
    assert a1 == np.float32(0.25 - mu * mu)
    want1, want2 = jspecial._chepolish(jnp.asarray(mu))
    np.testing.assert_allclose([gam1, gam2], [float(want1), float(want2)],
                               rtol=2e-7)
    np.testing.assert_allclose(
        fact, 1.0 if mu == 0 else np.pi * mu / np.sin(np.pi * mu),
        rtol=2e-7)


# the walk's slots: (nr, nc, symmetric) at one, two and many tiles, ragged
SLOT_CASES = [(1, 1, True), (128, 128, True), (129, 129, True),
              (1000, 1000, True), (300, 129, False), (128, 1000, False)]


def _walk(tiles_r, tiles_c, symmetric):
    """The product's walk by its definition: row tile by row tile, tj >= ti
    where symmetric."""
    return [(ti, tj) for ti in range(tiles_r)
            for tj in range(ti if symmetric else 0, tiles_c)]


@pytest.mark.parametrize("nr, nc, symmetric", SLOT_CASES)
@pytest.mark.parametrize("cap_pairs", [1, 3, None])
def test_product_slots(monkeypatch, nr, nc, symmetric, cap_pairs):
    """The product's bands (general_product_bands) at a slot budget of one
    pair, three and the default: the scratch within the budget; the bands
    cover the walk once in order; each band writes a row tile's slots s
    (the row side of pair (x, s), on the symmetric walk for s < x the
    mirror of pair (s, x)) as one run of s, the runs in order of s from
    band to band, so that every slot is summed once and in the order of
    its column tile."""
    r, B = 7, 3
    sides = 2 if symmetric else 1
    per_pair = 4 * B * sides * 128 * r
    if cap_pairs is not None:
        monkeypatch.setattr(cuda_kernels, "GENERAL_SLOT_BYTES",
                            cap_pairs * per_pair + 5)
    walk = cuda_kernels.general_product_bands(nr, nc, r, B, symmetric)
    tiles_r, tiles_c = -(-nr // 128), -(-nc // 128)
    pairs = _walk(tiles_r, tiles_c, symmetric)
    assert walk.pairs == len(pairs) and walk.sides == sides
    assert walk.band_pairs == min(cap_pairs or len(pairs), len(pairs))
    assert walk.bands == -(-len(pairs) // walk.band_pairs)
    assert walk.slot_floats == B * walk.band_pairs * sides * 128 * r
    assert 4 * walk.slot_floats <= cuda_kernels.GENERAL_SLOT_BYTES
    seen = {x: [] for x in range(tiles_r)}
    for g0 in range(0, walk.pairs, walk.band_pairs):
        band = {x: [] for x in range(tiles_r)}
        for ti, tj in pairs[g0:g0 + walk.band_pairs]:
            band[ti].append(tj)
            if symmetric and ti != tj:
                band[tj].append(ti)
        for x, ss in band.items():
            ss.sort()
            assert not ss or ss == list(range(ss[0], ss[0] + len(ss)))
            seen[x] += ss
    per_row = tiles_r if symmetric else tiles_c
    assert all(ss == list(range(per_row)) for ss in seen.values())


@pytest.mark.parametrize("nu", NUS)
def test_skip_radius(nu):
    """The tapered product's skip radius at chip_smoke.py phase 27's taper
    (n = 64^2, rho 0.01, density 0.004): within 2% beyond the taper radius,
    its float32 square (the kernel's skip2) at least its square; and on
    2^16 random float32 pairs near the radius, no pair whose plain float32
    k is at least the float32 tau lies past it."""
    n = 64 * 64
    radius = ttaper.estimate_kernel_radius(n, 2, 0.004, 0.01)
    tau = ttaper.estimate_kernel_threshold(n, 2, 0.004, 0.01, nu)
    skip = cuda_kernels.blocksparse_skip_radius(nu, tau)
    assert radius < skip < 1.02 * radius
    skip2 = np.float32(cuda_kernels._blocksparse_skip2(nu, tau))
    assert float(skip2) >= skip * skip
    rng = np.random.RandomState(int(100 * nu))
    a = (rng.rand(1 << 16, 2) * 100.0).astype(np.float32)
    angle = rng.rand(1 << 16) * 2.0 * np.pi
    length = radius * rng.uniform(0.95, 1.05, 1 << 16)
    b = (a + length[:, None] * np.stack([np.cos(angle), np.sin(angle)], 1)
         ).astype(np.float32)
    diff = a - b
    d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
    k = tk.matern(torch.as_tensor(np.sqrt(d2)), nu).numpy()
    assert k.dtype == np.float32
    kept = k >= np.float32(tau)
    assert kept.any() and (d2 > skip2).any()
    assert not np.any(kept & (d2 > skip2))


def _floats(ptr, count):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=(count,))


def _strided(ptr, rows, cols, ld):
    """(rows, cols) float32 view of rows of stride ld at ptr."""
    return np.lib.stride_tricks.as_strided(
        _floats(ptr, (rows - 1) * ld + cols), (rows, cols), (4 * ld, 4),
        writeable=True)


class _GeneralLibrary:
    """Stands in for the kernel library's general-nu entries: computes
    each launch from the pointers it is handed, in float64 on the kernel's
    own float32 inputs, and records the calls. The product fills the
    band's slots pair by pair of the walk as the kernel's blocks do (each
    slot once, NaN where none wrote) and adds each row tile's slots of the
    band to its rows in order of s, in float32, from 0 where the band holds
    the tile's first slot, as the kernel's second pass does; it checks
    each point's constants against _general_consts and keeps the scales
    it was handed. The trace takes each point's nu from its constants,
    fills the launch's whole partials scratch, and sums, as the kernels
    do, on a square K only the pairs above the diagonal, twice, and its
    n ones."""

    def __init__(self, nus):
        self.nus = tuple(nus)
        self.nu = self.nus[0]
        self.calls = []
        self.scales = []

    def gppe_matern_general_consts_bytes(self):
        return 1752

    def gppe_matern_general_product(self, rows, cols, scales, consts, V,
                                    out, slots, nr, nc, d, r, ldv, ldo,
                                    v_stride, out_stride, batch, symmetric,
                                    g0, band_pairs, slot_pairs, stream):
        assert batch == len(self.nus) and 1 <= band_pairs <= slot_pairs
        symmetric = bool(symmetric)
        x = _floats(rows, nr * d).reshape(nr, d)
        y = _floats(cols, nc * d).reshape(nc, d)
        sc = _floats(scales, batch * d).reshape(batch, d).copy()
        self.scales.append(sc)
        table = np.ctypeslib.as_array(
            ctypes.cast(consts, ctypes.POINTER(ctypes.c_uint8)),
            shape=(batch * 1752,))
        for b, nu in enumerate(self.nus):
            assert table[1752 * b:1752 * (b + 1)].tobytes() == (
                cuda_kernels._general_consts(nu).tobytes())
        T = 128
        tiles_r, tiles_c = -(-nr // T), -(-nc // T)
        sides = 2 if symmetric else 1
        walk = _walk(tiles_r, tiles_c, symmetric)
        index = {pair: g for g, pair in enumerate(walk)}
        assert g0 + band_pairs <= len(walk)
        grid = _floats(slots, batch * slot_pairs * sides * T * r).reshape(
            batch, slot_pairs, sides, T, r)
        grid[:] = np.nan
        for b, nu in enumerate(self.nus):
            xs = _t(x / sc[b])              # the kernel's float32 division
            ys = _t(y / sc[b])
            K = tk.matern(tk.pairwise_scaled_distance(xs, ys, 1.0),
                          nu).numpy()
            v = _strided(V + 4 * b * v_stride, nc, r, ldv).astype(np.float64)
            for p in range(band_pairs):
                ti, tj = walk[g0 + p]
                Kt = K[T * ti:T * (ti + 1), T * tj:T * (tj + 1)]
                grid[b, p, 0, :Kt.shape[0]] = Kt @ v[T * tj:T * (tj + 1)]
                if symmetric and ti != tj:
                    grid[b, p, 1, :Kt.shape[1]] = (
                        Kt.T @ v[T * ti:T * (ti + 1)])
            o = _strided(out + 4 * b * out_stride, nr, r, ldo)
            for t in range(tiles_r):
                rows_t = slice(T * t, min(T * (t + 1), nr))
                m = rows_t.stop - rows_t.start
                ss = [s_ for s_ in range(tiles_r if symmetric else tiles_c)
                      if g0 <= index[(min(s_, t), max(s_, t)) if symmetric
                                     else (t, s_)] < g0 + band_pairs]
                if not ss:
                    continue
                total = (np.zeros((m, r), np.float32) if ss[0] == 0
                         else o[rows_t].copy())
                for s_ in ss:
                    g = index[(min(s_, t), max(s_, t)) if symmetric
                              else (t, s_)]
                    side = int(symmetric and s_ < t)
                    slot = grid[b, g - g0, side, :m]
                    assert not np.isnan(slot).any()
                    total += slot
                o[rows_t] = total
        self.calls.append(("product", r, batch, int(symmetric)))
        return 0

    def gppe_matern_general_trace(self, rows, cols, scales, consts, partials,
                                  out, nr, nc, d, symmetric, per_block,
                                  blocks, batch, stream):
        assert (per_block, blocks) == cuda_kernels.trace_schedule(
            nr, nc, bool(symmetric))[3:]
        assert not symmetric or (rows == cols and nr == nc)
        x = _floats(rows, nr * d).reshape(nr, d)
        y = _floats(cols, nc * d).reshape(nc, d)
        sc = _floats(scales, batch * d).reshape(batch, d).copy()
        self.scales.append(sc)
        table = np.ctypeslib.as_array(
            ctypes.cast(consts, ctypes.POINTER(ctypes.c_uint8)),
            shape=(batch * 1752,))
        np.ctypeslib.as_array(
            ctypes.cast(partials, ctypes.POINTER(ctypes.c_double)),
            shape=(batch * blocks,))[:] = 0.0
        traces = np.ctypeslib.as_array(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_double)),
            shape=(batch,))
        for b in range(batch):
            nu, = [nu for nu in self.nus
                   if cuda_kernels._general_consts(nu).tobytes()
                   == table[1752 * b:1752 * (b + 1)].tobytes()]
            K = tk.matern(tk.pairwise_scaled_distance(
                _t(x / sc[b]), _t(y / sc[b]), 1.0), nu).numpy()
            traces[b] = (2.0 * np.sum(np.triu(K, 1) ** 2) + nr if symmetric
                         else np.sum(K * K))
        self.calls.append(("trace", int(symmetric), blocks, batch))
        return 0

    def gppe_matern_general_elementwise(self, x, out, n, consts, stream):
        src = _floats(x, n).astype(np.float64)
        _floats(out, n)[:] = tk.matern(_t(src), self.nu).numpy()
        self.calls.append(("elementwise", n))
        return 0


def _fake_card(monkeypatch, nus):
    lib = _GeneralLibrary(nus)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    cuda_kernels.reset_launch_counts()
    return lib


@pytest.fixture
def general_library(monkeypatch):
    return _fake_card(monkeypatch, (3.7,))


@pytest.mark.parametrize("r", [0, 1, 7, 33, 70])
@pytest.mark.parametrize("frobenius", [False, True])
@pytest.mark.parametrize("n", [100, 300])
def test_card_path_launches_and_sums(general_library, n, r, frobenius):
    """The card path of matern_general_matmat: one product launch per 32
    columns of V, each on its columns (V and out offset, strides r), a
    batch of one on the symmetric walk with the scale handed to the kernel;
    one trace launch on the symmetric walk, a batch of one; each launch
    counted once. The result equals the plain version."""
    rng = np.random.RandomState(n + r)
    pts = _t(rng.rand(n, 2), F32)
    V = _t(rng.standard_normal((n, r)), F32) if r else None
    if not r and not frobenius:
        return
    got = cuda_kernels._matern_general_matmat_cuda(
        pts, _t([0.1, 0.1], F32), V, 3.7, None, frobenius)
    widths = [min(32, r - c) for c in range(0, r, 32)]
    want_calls = [("product", w, 1, 1) for w in widths]
    if frobenius:
        want_calls.append(("trace", 1,
                           cuda_kernels.trace_schedule(n, n, True)[4], 1))
    assert general_library.calls == want_calls
    for sc in general_library.scales:
        np.testing.assert_array_equal(sc, np.float32([[0.1, 0.1]]))
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_general_product": len(widths),
        "matern_general_trace": int(frobenius)}
    want = cuda_kernels.matern_matmat_plain(
        pts.double(), _t([0.1, 0.1]), None if V is None else V.double(),
        3.7, frobenius=frobenius)
    if frobenius:
        got, fro = got
        want, fro_want = want
        assert fro.dtype == F64
        np.testing.assert_allclose(float(fro), float(fro_want), rtol=1e-6)
    if r:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


# (B, n, r): one point, a chunk of three over ragged tiles, a chunk over two
# launches of columns
BATCH_CASES = [(1, 200, 5), (3, 300, 14), (4, 129, 40)]


@pytest.mark.parametrize("B, n, r", BATCH_CASES)
@pytest.mark.parametrize("cap_pairs", [None, 2])
def test_card_path_batched(monkeypatch, B, n, r, cap_pairs):
    """matern_general_matmat_batched's card path: one product launch per
    band and 32 columns for the whole batch (one band under the default
    budget; a budget of two pairs of the batch cuts the walk into bands),
    the constants one struct per point in order (checked by the stand-in),
    the scales per point and dimension, every slot written and summed in
    order; the result equals the plain per-point loop, and each point
    equals its single call (other bands) and the batch under the default
    budget bit for bit."""
    nus = (3.7, 0.3, 12.3, 1.5)[:B]
    rhos = (0.1, 0.2, 0.07, 0.15)[:B]
    rng = np.random.RandomState(B + n)
    pts = _t(rng.rand(n, 2), F32)
    V = _t(rng.standard_normal((B, n, r)), F32)
    scales = _t(rhos, F32)[:, None].expand(B, 2).contiguous()
    _fake_card(monkeypatch, nus)
    whole = cuda_kernels._general_product_cuda(pts, pts, scales, V, nus,
                                               True)
    if cap_pairs is not None:
        monkeypatch.setattr(cuda_kernels, "GENERAL_SLOT_BYTES",
                            cap_pairs * 4 * B * 2 * 128 * min(r, 32))
    lib = _fake_card(monkeypatch, nus)
    got = cuda_kernels._general_product_cuda(pts, pts, scales, V, nus, True)
    widths = [min(32, r - c) for c in range(0, r, 32)]
    bands = [cuda_kernels.general_product_bands(n, n, min(r, 32), B,
                                                True).bands] * len(widths)
    assert bands[0] == (1 if cap_pairs is None
                        else -(-(-(-n // 128) * (-(-n // 128) + 1) // 2)
                               // cap_pairs))
    assert lib.calls == [("product", w, B, 1)
                         for w, k in zip(widths, bands) for _ in range(k)]
    assert cuda_kernels.launch_counts["matern_general_product"] == sum(bands)
    for sc in lib.scales:
        np.testing.assert_array_equal(sc, np.repeat(
            np.float32(rhos)[:, None], 2, axis=1))
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    want = cuda_kernels.matern_general_matmat_batched(
        pts.double(), _t(rhos), V.double(), nus)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for b in range(B):
        single = _fake_card(monkeypatch, nus[b:b + 1])
        one = cuda_kernels._matern_general_matmat_cuda(
            pts, _t([rhos[b]] * 2, F32), V[b], nus[b], None, False)
        assert {c[:3] for c in single.calls} == {
            ("product", w, 1) for w in widths}
        np.testing.assert_array_equal(one.numpy(), got[b].numpy())


@pytest.mark.parametrize("general", [False, True])
def test_grid_chunk_budget(monkeypatch, problem, random_block, general):
    """The matrix-free grid chunk's default size: the Lanczos basis of its
    points and, over general nus, the product's slot scratch
    (GENERAL_SLOT_BYTES) within max_chunk_bytes."""
    pts, z, X = problem
    probes, v_defl = random_block
    monkeypatch.setattr(cuda_kernels, "GENERAL_SLOT_BYTES", 1 << 20)
    r = 1 + X.shape[1] + 1 + PROBES
    basis = STEPS * N * r * 8          # float64 on the CPU
    budget = 3 * basis + (1 << 20) + 7
    grid = tgk.GridKrylovProfileLikelihood(
        pts, X, z, RHOS, GRID_NUS if general else np.full(4, 1.5),
        nu_static=None if general else 1.5, lanczos_steps=STEPS,
        num_probes=PROBES, matrix_free=True, max_chunk_bytes=budget,
        probes=probes, v_defl=v_defl, **CPU)
    assert grid.chunk == (3 if general else 4)


def test_grid_chunk_one_product_launch_per_step(monkeypatch, problem,
                                                random_block):
    """The matrix-free grid chunk over general nus: each Lanczos step one
    batched product launch for all its points (the block is 14 columns
    wide), then one trace launch for all of them (each point's nu and
    scale in it); the fits agree with the plain
    float64 chunk's (eta 5e-2, sigma0 5e-3: the card-vs-cpu bounds; two
    of the four points fit eta = inf in both)."""
    pts, z, X = problem
    lib = _fake_card(monkeypatch, tuple(GRID_NUS))

    def card(points, scales, V, nus, block_rows=1024):
        assert tuple(nus) == lib.nus
        d = points.shape[1]
        return cuda_kernels._general_product_cuda(
            points, points, scales[:, None].expand(len(nus), d).contiguous(),
            V, tuple(nus), True)

    def traces(points, scales, nus, block_rows=1024):
        assert tuple(nus) == lib.nus
        d = points.shape[1]
        return cuda_kernels._general_trace_cuda(
            points, points, scales[:, None].expand(len(nus), d).contiguous(),
            tuple(nus), True)

    probes, v_defl = random_block
    kw = dict(lanczos_steps=STEPS, num_probes=PROBES, matrix_free=True,
              probes=probes, v_defl=v_defl)
    monkeypatch.setattr(cuda_kernels, "matern_general_matmat_batched", card)
    monkeypatch.setattr(cuda_kernels, "matern_general_trace_batched",
                        traces)
    got = tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS, GRID_NUS,
                                          device="cpu", dtype=F32, **kw)
    assert [c for c in lib.calls if c[0] == "product"] == [
        ("product", 14, len(RHOS), 1)] * STEPS
    assert cuda_kernels.launch_counts["matern_general_product"] == STEPS
    assert [c for c in lib.calls if c[0] == "trace"] == [
        ("trace", 1, cuda_kernels.trace_schedule(N, N, True)[4], len(RHOS))]
    assert cuda_kernels.launch_counts["matern_general_trace"] == 1
    np.testing.assert_array_equal(lib.scales[-1], np.repeat(
        np.float32(RHOS)[:, None], 2, axis=1))
    monkeypatch.undo()
    want = tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS, GRID_NUS, **kw,
                                           **CPU)
    for a, b in zip(got.fit_all(), want.fit_all()):
        assert a["success"] and b["success"]
        np.testing.assert_allclose(a["eta"], b["eta"], rtol=5e-2)
        np.testing.assert_allclose(a["sigma0"], b["sigma0"], rtol=5e-3)


def test_card_path_elementwise(general_library):
    x = _t(np.linspace(0.0, 4.0, 1001), F32)
    got = cuda_kernels._matern_general_cuda(x, 3.7)
    np.testing.assert_allclose(got.numpy(), tk.matern(x.double(), 3.7),
                               rtol=1e-6)
    assert general_library.calls == [("elementwise", 1001)]
    assert cuda_kernels.launch_counts == {
        **dict.fromkeys(cuda_kernels.launch_counts, 0),
        "matern_general_elementwise": 1}
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels._matern_general_cuda(x.double(), 3.7)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels._matern_general_cuda(x.reshape(7, 143).T, 3.7)


# -- the grid engine over general nus -----------------------------------------

N, STEPS, PROBES = 128, 10, 6
RHOS = np.array([0.08, 0.12, 0.1, 0.15])
GRID_NUS = np.array([0.7, 1.5, 3.7, 12.3])   # one closed form among them


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(4)
    pts = rng.rand(N, 2)
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2))


@pytest.fixture(scope="module")
def random_block():
    """The JAX grid engine's own draw for key=0."""
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.rademacher(k_probe, (N, PROBES),
                                           dtype=jnp.float64)),
            np.array(jax.random.normal(k_defl, (N, 1), dtype=jnp.float64)))


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "matrix_free"])
def grids(request, problem, random_block):
    pts, z, X = problem
    probes, v_defl = random_block
    kw = dict(lanczos_steps=STEPS, num_probes=PROBES,
              matrix_free=request.param, block_rows=128)
    jg = jgk.GridKrylovProfileLikelihood(pts, X, z, RHOS, GRID_NUS, key=0,
                                         **kw)
    cuda_kernels.reset_launch_counts()
    tg = tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS, GRID_NUS,
                                         probes=probes, v_defl=v_defl,
                                         **kw, **CPU)
    assert not any(cuda_kernels.launch_counts.values())
    return jg, tg


def test_grid_general_nu_fits_match(grids):
    """Per-point eta, sigma, sigma0 and lp of a grid over general nus
    (nu_static=None), dense and matrix-free, against the reference's
    general branch: rtol 1e-6."""
    jg, tg = grids
    assert tg.matrix_free == jg.matrix_free and tg.chunk == jg.chunk
    for jr, tr in zip(jg.fit_all(), tg.fit_all()):
        assert tr["success"] and jr["success"]
        assert (tr["rho"], tr["nu"]) == (jr["rho"], jr["nu"])
        for name in ("eta", "sigma", "sigma0", "lp"):
            np.testing.assert_allclose(tr[name], jr[name], rtol=1e-6,
                                       err_msg=name)


def test_grid_general_factorization_matches(grids):
    jg, tg = grids
    for je, te in zip(jg.engines, tg.engines):
        for name in ("alphas", "betas", "U", "G"):
            np.testing.assert_allclose(getattr(te, name), getattr(je, name),
                                       rtol=1e-6, atol=1e-9, err_msg=name)


def test_grid_general_nu_static(problem, random_block):
    """A general nu_static is every point's nu (nus not read), as the
    reference's static nu; it equals nu_static=None with that nu."""
    pts, z, X = problem
    probes, v_defl = random_block
    kw = dict(lanczos_steps=8, num_probes=PROBES, matrix_free=False,
              probes=probes, v_defl=v_defl, **CPU)
    a = tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS[:2], np.ones(2),
                                        nu_static=3.7, **kw).fit_all()
    b = tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS[:2],
                                        np.full(2, 3.7), **kw).fit_all()
    for ra, rb in zip(a, b):
        assert ra["eta"] == rb["eta"] and ra["sigma"] == rb["sigma"]
