"""The exact tile-dot mode 'highest' as 3xTF32, emulated on the CPU.

On the card, the 'highest' product of all three product kernels
(``matern_matmat``, ``matern_matmat_multirho``,
``matern_matmat_blocksparse``) is three tf32 products on the tensor cores
(``csrc/*_mma.cu``): K and V each split into hi = tf32(x) and
lo = tf32(x - hi), rounded as ``cvt.rna.tf32.f32`` rounds, and
hi.hi + lo.hi + hi.lo summed in float32 (lo.lo dropped).
``cuda_kernels._tf32_round`` and ``_tf32x3_dot_plain`` are the plain
versions of that rounding and that product; the plain multi-rho and
block-sparse versions take the latter through their module-private
``_product``. These tests hold them to an independent integer-bit
reference and show, before any run on the card, that the scheme is
'highest'-grade: within the exact mode's bounds (Frobenius 2e-5, max-abs
5e-4; tests_tpu/test_onchip.py) of the float64 product and of the
reference's Pallas kernels at 'highest' in interpret mode, and as
symmetric as the exact mode (u.Kv vs v.Ku to 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu.ops import pallas_kernels as jpk  # noqa: E402
from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels, kernels  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()

F32 = torch.float32
FROB_TOL, MAXABS_TOL, SYM_TOL = 2e-5, 5e-4, 1e-6
N, R, SCALE = 1024, 24, 0.1


def tf32_bits_reference(a):
    """cvt.rna.tf32.f32 on float32 bit patterns, in integers: keep the
    sign, truncate the magnitude to 10 stored mantissa bits and add one
    tf32 unit where the dropped 13 bits are at least half of one (ties
    away from zero); inf and NaN unchanged."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = bits & np.uint32(0x7FFFFFFF)
    kept = mag & np.uint32(0xFFFFE000)
    up = (mag & np.uint32(0x1FFF)) >= np.uint32(0x1000)
    rounded = sign | (kept + np.where(up, np.uint32(0x2000), np.uint32(0)))
    special = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    return np.where(special, bits, rounded).astype(np.uint32)


def test_tf32_round_is_bit_exact():
    rng = np.random.RandomState(0)
    random = rng.randint(0, 2 ** 32, size=20000, dtype=np.uint64)
    high = rng.randint(0, 2 ** 19, size=2000, dtype=np.uint64) << 13
    patterns = np.concatenate([
        random,
        high | 0x1000,                       # exact ties, both signs
        high | 0x0FFF, high | 0x1001,        # just below and above a tie
        rng.randint(1, 2 ** 23, size=500, dtype=np.uint64),  # subnormals
        rng.randint(1, 2 ** 23, size=500, dtype=np.uint64) | 0x80000000,
        [0x007FF000, 0x007FFFFF,             # subnormals rounding to normal
         0x7F7FFFFF, 0xFF7FFFFF,             # the largest finite: to inf
         0x7F7FE000, 0x7F7FEFFF,             # stays the largest tf32
         0x7F800000, 0xFF800000,             # +-inf
         0x7FC00000, 0xFFC00001, 0x7F800001,  # NaNs, one with low payload
         0x00000000, 0x80000000, 0x3F800000]]).astype(np.uint32)
    a = patterns.view(np.float32)
    got = cuda_kernels._tf32_round(torch.from_numpy(a.copy())).numpy()
    want = tf32_bits_reference(a)
    np.testing.assert_array_equal(got.view(np.uint32), want)
    finite = np.isfinite(got)
    assert not np.any(got.view(np.uint32)[finite] & 0x1FFF)
    # rounding error at most half a tf32 unit: 2^-11 relative (normals)
    normal = finite & (np.abs(a) >= np.float32(2.0 ** -126))
    assert np.all(np.abs(got[normal].astype(np.float64) - a[normal])
                  <= 2.0 ** -11 * np.abs(a[normal].astype(np.float64)))


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.rand(N, 2).astype(np.float32)
    V = rng.standard_normal((N, R)).astype(np.float32)
    return pts, V


def _k32(pts, nu):
    """K in float32 from the plain pieces, as the kernel takes it."""
    P = torch.from_numpy(pts)
    return kernels.matern(kernels.pairwise_scaled_distance(
        P, P, torch.tensor([SCALE, SCALE], dtype=F32)), nu)


def _errors(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            np.max(np.abs(got - want)))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
def test_tf32x3_product_is_highest_grade(nu):
    pts, V = _problem()
    got = cuda_kernels._tf32x3_dot_plain(_k32(pts, nu), torch.from_numpy(V))
    assert got.dtype == F32
    p64 = pts.astype(np.float64)
    exact = cuda_kernels.matern_matmat(
        torch.from_numpy(p64), SCALE, torch.from_numpy(V.astype(np.float64)),
        nu).numpy()
    frob, max_abs = _errors(got.numpy(), exact)
    assert frob < FROB_TOL and max_abs < MAXABS_TOL
    # it differs from plain float32 K @ V: three tf32 products, not one
    # float32 one, yet lands at the same grade
    plain = (_k32(pts, nu) @ torch.from_numpy(V)).numpy()
    assert not np.array_equal(got.numpy(), plain)
    assert frob < 4 * _errors(plain, exact)[0] + 1e-7
    jax_highest = np.asarray(jpk.matern_matmat(
        pts, SCALE, V, nu, tile_m=256, tile_n=256, dot_mode="highest",
        interpret=True))
    frob, max_abs = _errors(got.numpy(), jax_highest)
    assert frob < FROB_TOL and max_abs < MAXABS_TOL


def test_tf32x3_symmetry():
    """K is symmetric and the split of V is the same for u and v, so
    u.Kv - v.Ku is float32 summation and split error: under 1e-6 of
    |u| |Kv|, the exact mode's bound."""
    pts, V = _problem(seed=1)
    K = _k32(pts, 0.5)
    assert torch.equal(K, K.T)
    u, v = torch.from_numpy(V[:, :1]), torch.from_numpy(V[:, 1:2])
    Kv = cuda_kernels._tf32x3_dot_plain(K, v).double()
    Ku = cuda_kernels._tf32x3_dot_plain(K, u).double()
    skew = abs(float((u.double() * Kv).sum() - (v.double() * Ku).sum()))
    assert skew / float(torch.linalg.norm(u.double())
                        * torch.linalg.norm(Kv)) < SYM_TOL


@pytest.mark.parametrize("rho", [0.05, 0.3])
def test_tf32x3_multirho_is_highest_grade(rho):
    """The multi-rho K at the smallest and the largest rho of the grid
    path (at 0.3 K is nearly dense and the sums longest): the plain
    version with the 3xTF32 product, in float32, against the float64 plain
    version on the same float32 1/rho and against the reference's Pallas
    kernel at 'highest' in interpret mode, each within the exact mode's
    bounds; and it is not plain float32 K @ V."""
    rng = np.random.RandomState(2)
    pts = rng.rand(N, 2).astype(np.float32)
    rhos = np.asarray([rho], np.float32)
    V = rng.standard_normal((1, N, 16)).astype(np.float32)
    P, R = torch.from_numpy(pts), torch.from_numpy(rhos)
    got = cuda_kernels.matern_matmat_multirho_plain(
        P, R, torch.from_numpy(V), 0.5,
        _product=cuda_kernels._tf32x3_dot_plain)
    assert got.dtype == F32
    exact = cuda_kernels.matern_matmat_multirho_plain(
        P.double(), 1.0 / (1.0 / R).double(),
        torch.from_numpy(V).double(), 0.5)
    frob, max_abs = _errors(got.numpy(), exact.numpy())
    assert frob < FROB_TOL and max_abs < MAXABS_TOL
    plain = cuda_kernels.matern_matmat_multirho_plain(
        P, R, torch.from_numpy(V), 0.5)
    assert not torch.equal(got, plain)
    jax_highest = np.asarray(jpk.matern_matmat_multirho(
        pts, rhos, V, 0.5, tile=256, dot_mode="highest", interpret=True))
    frob, max_abs = _errors(got.numpy(), jax_highest)
    assert frob < FROB_TOL and max_abs < MAXABS_TOL


def test_tf32x3_blocksparse_is_highest_grade():
    """The tapered K (the geometry of tests/test_torch_taper.py, n = 600,
    tile 128), at a threshold no pair comes within 1e-5 of, so that
    float32 and float64 taper the same entries: the plain version with the
    3xTF32 product against the float64 plain version on the same sorted
    float32 points and against the reference's Pallas kernel at 'highest'
    in interpret mode, within the exact mode's bounds; pad rows stay
    zero."""
    rng = np.random.RandomState(11)
    n = 600
    jop = jtaper.TaperedMaternOperator(rng.rand(n, 2), 0.05, nu=0.5,
                                       density=0.02, tile=128,
                                       use_pallas=False)
    pts = torch.as_tensor(np.array(jop.points_sorted), dtype=F32)
    geometry = (jop.pair_i, jop.pair_j, jop.tile)
    tau = cuda_kernels.blocksparse_clear_threshold(
        pts.double(), 0.5, jop.threshold, *geometry, n=n)
    V = np.zeros((jop.n_pad, R), np.float32)
    V[:n] = rng.standard_normal((n, R))
    Vt = torch.from_numpy(V)
    got = cuda_kernels.matern_matmat_blocksparse_plain(
        pts, Vt, 0.5, tau, *geometry, n=n,
        _product=cuda_kernels._tf32x3_dot_plain)
    assert got.dtype == F32 and not got[n:].any()
    exact = cuda_kernels.matern_matmat_blocksparse_plain(
        pts.double(), Vt.double(), 0.5, tau, *geometry, n=n)
    frob, max_abs = _errors(got.numpy(), exact.numpy())
    assert frob < FROB_TOL and max_abs < MAXABS_TOL
    plain = cuda_kernels.matern_matmat_blocksparse_plain(
        pts, Vt, 0.5, tau, *geometry, n=n)
    assert not torch.equal(got, plain)
    jax_highest = np.asarray(jpk.matern_matmat_blocksparse(
        jop.points_sorted, V, 0.5, tau, *geometry, dot_mode="highest",
        interpret=True))
    frob, max_abs = _errors(got.numpy()[:n], jax_highest[:n])
    assert frob < FROB_TOL and max_abs < MAXABS_TOL
