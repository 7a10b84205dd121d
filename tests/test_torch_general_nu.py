"""General Matern nu in gppe_tpu_torch vs gppe_tpu, on the CPU in float64.

Inputs come from numpy seeds and go through both packages (JAX under x64,
tests/conftest.py). On the CPU every general-nu entry of the port runs the
plain version of ``csrc/matern_general.cu``: ``kernels.matern`` over the
ported Bessel K_nu. Tolerances: the kernel, ``generate_correlation``,
``MaternOperator.matmat`` and ``trace_pow(2)`` rtol 1e-11 (the same
algorithm, summed in another order); the grid engine over general nus,
dense and matrix-free, per-point eta, sigma and sigma0 rtol 1e-6 (the
bound of tests/test_torch_grid_krylov.py: two Lanczos passes in float64).

The card path of the wrappers (launch plan, column slices, pointer
offsets, the sum of the slices' partial products) is driven on CPU tensors
against a stand-in library that computes each launch's share in float64
from the pointers it is handed.
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
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()

F32, F64 = torch.float32, torch.float64
CPU = dict(device="cpu", dtype=F64)
# chip_smoke.py phase 21's orders, and orders next to the closed forms
NUS = [0.01, 0.3, 1.2, 3.7, 10.0, 24.9]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the tier-1 run puts six test
    workers on the host's cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    does; the tapered kernel and operator name ROADMAP A9."""
    P = _t(points)
    with pytest.raises(NotImplementedError, match="general nu"):
        cuda_kernels.matern_matmat_multirho(P, [0.1, 0.2], None, 1.2,
                                            return_frobenius=True)
    with pytest.raises(NotImplementedError, match="A9"):
        cuda_kernels.matern_matmat_blocksparse(P, None, 1.2, 0.1, [0], [0],
                                               200, frobenius=True)
    with pytest.raises(NotImplementedError, match="A9"):
        tops_taper = pytest.importorskip("gppe_tpu_torch.ops.taper")
        tops_taper.TaperedMaternOperator(points, 0.1, nu=1.2, **CPU)


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


def test_product_slices():
    """grid.y of the product kernel: enough column slices to reach about 8
    blocks of 32 rows per SM, each slice at least 64 columns."""
    assert cuda_kernels.general_product_slices(100_000, 100_000) == 1
    assert cuda_kernels.general_product_slices(10_000, 10_000) == 4
    assert cuda_kernels.general_product_slices(1000, 1000) == 15
    assert cuda_kernels.general_product_slices(40, 40) == 1
    for nr in (1, 33, 999, 4096, 12_345):
        s = cuda_kernels.general_product_slices(nr, nr)
        assert 1 <= s <= max(1, nr // 64)


def _floats(ptr, count):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=(count,))


class _GeneralLibrary:
    """Stands in for the kernel library's general-nu entries: computes
    each launch's share of the product (its column slices, its columns of
    V) and the trace partials in float64 from the pointers it is handed,
    and records the calls."""

    def __init__(self, nu):
        self.nu = nu
        self.calls = []

    def gppe_matern_general_consts_bytes(self):
        return 1752

    def gppe_matern_general_product(self, rows, cols, V, out, nr, nc, d, r,
                                    ldv, ldo, slices, consts, stream):
        x = _floats(rows, nr * d).reshape(nr, d).astype(np.float64)
        y = _floats(cols, nc * d).reshape(nc, d).astype(np.float64)
        v = np.lib.stride_tricks.as_strided(
            _floats(V, (nc - 1) * ldv + r), (nc, r), (4 * ldv, 4))
        K = tk.matern(tk.pairwise_scaled_distance(_t(x), _t(y), 1.0),
                      self.nu).numpy()
        per = -(-nc // slices)
        for s in range(slices):
            o = np.lib.stride_tricks.as_strided(
                _floats(out + 4 * s * nr * ldo, (nr - 1) * ldo + r),
                (nr, r), (4 * ldo, 4), writeable=True)
            o[:] = K[:, s * per:(s + 1) * per] @ v[s * per:(s + 1) * per]
        self.calls.append(("product", r, slices))
        return 0

    def gppe_matern_general_trace(self, rows, cols, partials, nr, nc, d,
                                  symmetric, per_block, blocks, consts,
                                  stream):
        assert (per_block, blocks) == cuda_kernels.trace_schedule(
            nr, nc, bool(symmetric))[3:]
        x = _floats(rows, nr * d).reshape(nr, d).astype(np.float64)
        y = _floats(cols, nc * d).reshape(nc, d).astype(np.float64)
        K = tk.matern(tk.pairwise_scaled_distance(_t(x), _t(y), 1.0),
                      self.nu).numpy()
        out = np.ctypeslib.as_array(
            ctypes.cast(partials, ctypes.POINTER(ctypes.c_double)),
            shape=(blocks,))
        out[:] = 0.0
        out[0] = np.sum(K * K)
        self.calls.append(("trace", int(symmetric), blocks))
        return 0

    def gppe_matern_general_elementwise(self, x, out, n, consts, stream):
        src = _floats(x, n).astype(np.float64)
        _floats(out, n)[:] = tk.matern(_t(src), self.nu).numpy()
        self.calls.append(("elementwise", n))
        return 0


@pytest.fixture
def general_library(monkeypatch):
    lib = _GeneralLibrary(3.7)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(
                            multi_processor_count=4))
    cuda_kernels.reset_launch_counts()
    return lib


@pytest.mark.parametrize("r", [0, 1, 7, 33, 70])
@pytest.mark.parametrize("frobenius", [False, True])
@pytest.mark.parametrize("n", [100, 300])
def test_card_path_launches_and_sums(general_library, n, r, frobenius):
    """The card path of matern_general_matmat: one product launch per 32
    columns of V, each on its columns (V and out offset, strides r), over
    the column slices the schedule asks for, summed; one trace launch on
    the symmetric walk; each launch counted once. The result equals the
    plain version."""
    rng = np.random.RandomState(n + r)
    pts = _t(rng.rand(n, 2), F32)
    V = _t(rng.standard_normal((n, r)), F32) if r else None
    if not r and not frobenius:
        return
    got = cuda_kernels._matern_general_matmat_cuda(
        pts, _t([0.1, 0.1], F32), V, 3.7, None, frobenius)
    slices = cuda_kernels.general_product_slices(n, n, 4)
    widths = [min(32, r - c) for c in range(0, r, 32)]
    want_calls = [("product", w, slices) for w in widths]
    if frobenius:
        want_calls.append(("trace", 1,
                           cuda_kernels.trace_schedule(n, n, True)[4]))
    assert general_library.calls == want_calls
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
