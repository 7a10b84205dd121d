"""The ported tapered (block-sparse) operator and product vs the JAX
reference, on the CPU in float64.

Inputs come from numpy seeds and go through both packages. The Pallas
block-sparse kernel runs in interpret mode, as tests/test_taper.py runs
it; the JAX operator runs with ``use_pallas=False`` (its XLA scan).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.special  # noqa: E402

from gppe_tpu.models import large_scale as jls  # noqa: E402
from gppe_tpu.ops import pallas_kernels  # noqa: E402
from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch.models import large_scale as tls  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


F64 = torch.float64


def torch_op(pts, scale, **kw):
    return ttaper.TaperedMaternOperator(pts, scale, device="cpu", dtype=F64,
                                        **kw)


def dense_tapered(pts, scale, nu, tau):
    """The tapered dense truth of tests/test_taper.py, in numpy float64."""
    d = np.sqrt((((pts[:, None, :] - pts[None, :, :]) / scale) ** 2).sum(-1))
    if nu == 0.5:
        K = np.exp(-d)
    elif nu == 1.5:
        K = (1 + np.sqrt(3) * d) * np.exp(-np.sqrt(3) * d)
    else:
        K = (1 + np.sqrt(5) * d + 5 * d * d / 3) * np.exp(-np.sqrt(5) * d)
    return np.where(K >= tau, K, 0.0)


# -- the threshold geometry, to 1e-12 -----------------------------------------

@pytest.mark.parametrize("d", range(1, 8))
def test_gamma_function(d):
    assert ttaper.gamma_function(d) == jtaper.gamma_function(d)
    np.testing.assert_allclose(ttaper.gamma_function(d),
                               scipy.special.gamma(d / 2 + 1), rtol=1e-12)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_ball_radius_volume(d):
    np.testing.assert_allclose(
        ttaper.ball_radius(ttaper.ball_volume(0.7, d), d), 0.7, rtol=1e-12)
    assert ttaper.ball_volume(0.7, d) == jtaper.ball_volume(0.7, d)
    assert ttaper.ball_radius(0.3, d) == jtaper.ball_radius(0.3, d)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("scale", [0.05, [0.04, 0.09]])
def test_threshold_geometry(nu, scale):
    args = (900, 2, 0.02, np.asarray(scale))
    assert (ttaper.estimate_kernel_radius(*args)
            == jtaper.estimate_kernel_radius(*args))
    np.testing.assert_allclose(
        ttaper.estimate_kernel_threshold(*args, nu),
        jtaper.estimate_kernel_threshold(*args, nu), rtol=1e-12)
    assert (ttaper.estimate_max_nnz(900, scale, 2, 0.02)
            == jtaper.estimate_max_nnz(900, scale, 2, 0.02))


def test_adjacency_guard():
    with pytest.raises(ValueError, match="Adjacency"):
        ttaper.estimate_kernel_threshold(100, 2, 1e-6, np.array([0.1, 0.1]),
                                         0.5)


def test_spatial_sort_matches():
    pts = np.random.RandomState(1).rand(500, 3) * 7.0
    np.testing.assert_array_equal(ttaper.spatial_sort(pts, 0.9),
                                  jtaper.spatial_sort(pts, 0.9))


# -- (b) the block-sparse product ---------------------------------------------

def test_blocksparse_plain_vs_pallas_interpret():
    """The case of tests/test_taper.py::test_blocksparse_pallas_interpret_
    matches: the Pallas kernel itself (interpret mode, float32) on the JAX
    operator's geometry against the port's plain version in float64 on the
    same sorted, padded arrays. rtol = atol = 1e-4, that test's bound.
    A pair whose k lies within float32 rounding of the threshold could
    fall on either side of the taper; this seed has none within 1e-5
    relative, and the test says so."""
    rng = np.random.RandomState(11)
    n = 600
    pts = rng.rand(n, 2)
    jop = jtaper.TaperedMaternOperator(pts, 0.05, nu=0.5, density=0.02,
                                       tile=128, use_pallas=False)
    V = np.asarray(rng.standard_normal((n, 3)), np.float32)
    Vs = np.concatenate(
        [V[jop.perm], np.zeros((jop.n_pad - n, 3), np.float32)], axis=0)
    want = np.asarray(pallas_kernels.matern_matmat_blocksparse(
        jop.points_sorted, Vs, jop.nu, jop.threshold, jop.pair_i,
        jop.pair_j, jop.tile, interpret=True))
    pts_sorted = torch.as_tensor(np.array(jop.points_sorted), dtype=F64)
    assert cuda_kernels.blocksparse_count_near_threshold(
        pts_sorted, 0.5, jop.threshold, jop.pair_i, jop.pair_j, jop.tile,
        n=n, rel=1e-5) == 0
    got = cuda_kernels.matern_matmat_blocksparse(
        pts_sorted, torch.as_tensor(Vs, dtype=F64), 0.5, jop.threshold,
        jop.pair_i, jop.pair_j, jop.tile, n=n)
    assert got.shape == (jop.n_pad, 3)
    np.testing.assert_allclose(got.numpy()[:n], want[:n], rtol=1e-4,
                               atol=1e-4)
    assert not got.numpy()[n:].any()        # pad rows are zero


def test_blocksparse_clear_threshold_moves_off_a_pair():
    """A threshold set exactly on one pair's kernel value has that pair
    (twice, by symmetry) within 1e-5 of it; the cleared threshold has
    none, is larger, and is less than 1e-3 away."""
    op = torch_op(np.random.RandomState(2).rand(300, 2), 0.05, nu=0.5,
                  density=0.05, tile=64)
    pts = op.points_sorted
    args = (op.pair_i, op.pair_j, op.tile)
    tau = float(torch.exp(-torch.linalg.norm(pts[3] - pts[7])))
    assert tau > op.threshold       # the pair lies inside the taper ball
    assert cuda_kernels.blocksparse_count_near_threshold(
        pts, 0.5, tau, *args, n=300) >= 2
    clear = cuda_kernels.blocksparse_clear_threshold(pts, 0.5, tau, *args,
                                                     n=300)
    assert tau < clear < tau * (1 + 1e-3)
    assert cuda_kernels.blocksparse_count_near_threshold(
        pts, 0.5, clear, *args, n=300) == 0


def test_blocksparse_row_ptr_checks():
    np.testing.assert_array_equal(
        cuda_kernels.blocksparse_row_ptr([0, 0, 1, 2, 2, 2], 3),
        [0, 2, 3, 6])
    with pytest.raises(ValueError, match="sorted"):
        cuda_kernels.blocksparse_row_ptr([0, 2, 1], 3)
    with pytest.raises(ValueError, match="at least one"):
        cuda_kernels.blocksparse_row_ptr([0, 2], 3)


def test_blocksparse_rejects():
    pts = torch.rand(64, 2, dtype=F64)
    V = torch.rand(64, 2, dtype=F64)
    pi = pj = np.arange(2, dtype=np.int32)
    with pytest.raises(ValueError, match="dot_mode must be one of"):
        cuda_kernels.matern_matmat_blocksparse(pts, V, 0.5, 0.1, pi, pj, 32,
                                               dot_mode="bf8")
    with pytest.raises(ValueError, match="multiple of tile"):
        cuda_kernels.matern_matmat_blocksparse(pts, V, 0.5, 0.1, pi, pj, 48)
    with pytest.raises(ValueError, match="real points"):
        cuda_kernels.matern_matmat_blocksparse(pts, V, 0.5, 0.1, pi, pj, 32,
                                               n=20)
    with pytest.raises(ValueError, match="V must be"):
        cuda_kernels.matern_matmat_blocksparse(pts, V[:32], 0.5, 0.1, pi,
                                               pj, 32)
    with pytest.raises(ValueError, match="pair_j"):
        cuda_kernels.matern_matmat_blocksparse(pts, V, 0.5, 0.1, pi, pj + 1,
                                               32)


# -- (c) the operator ---------------------------------------------------------

CASES = {
    "ragged_iso": dict(n=500, scale=0.05, nu=0.5, density=0.05, tile=64),
    "ragged_aniso": dict(n=413, scale=[0.04, 0.08], nu=1.5, density=0.04,
                         tile=128),
    "one_tile": dict(n=100, scale=0.1, nu=2.5, density=0.1, tile=512),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def operators(request):
    c = dict(CASES[request.param])
    pts = np.random.RandomState(len(request.param)).rand(c.pop("n"), 2)
    scale = c.pop("scale")
    return (pts, scale, jtaper.TaperedMaternOperator(
        pts, scale, use_pallas=False, **c), torch_op(pts, scale, **c))


def test_operator_geometry_matches(operators):
    """The host geometry is a copy of the reference's: equal, not close
    (the threshold goes through torch's exp instead of XLA's: 1e-14)."""
    _, _, jop, top = operators
    for name in ("perm", "inv_perm", "pair_i", "pair_j"):
        np.testing.assert_array_equal(getattr(top, name), getattr(jop, name))
    assert top.pair_i.dtype == top.pair_j.dtype == np.int32
    assert top.radius == jop.radius and top.tile == jop.tile
    assert top.tile_density == jop.tile_density
    assert top.n_pad == jop.n_pad and top.shape == jop.shape
    np.testing.assert_allclose(top.threshold, jop.threshold, rtol=1e-14)


def test_operator_products_match_dense_truth(operators):
    """matmat to atol 1e-8 and trace_pow(2) to rtol 1e-8 against the
    tapered dense truth, and against the JAX operator to the same."""
    pts, scale, jop, top = operators
    n = pts.shape[0]
    Kd = dense_tapered(pts, np.asarray(scale), top.nu, top.threshold)
    rng = np.random.RandomState(5)
    V = rng.standard_normal((n, 3))
    got = top.matmat(V).numpy()
    np.testing.assert_allclose(got, Kd @ V, atol=1e-8)
    np.testing.assert_allclose(got, np.asarray(jop.matmat(jnp.asarray(V))),
                               atol=1e-8)
    v = rng.standard_normal(n)
    assert top.matvec(v).shape == (n,)
    np.testing.assert_allclose(top.matvec(v).numpy(), Kd @ v, atol=1e-8)
    np.testing.assert_allclose(float(top.trace_pow(2)), np.sum(Kd * Kd),
                               rtol=1e-8)
    np.testing.assert_allclose(float(top.trace_pow(2)),
                               float(jop.trace_pow(2)), rtol=1e-8)
    assert float(top.trace_pow(0)) == float(top.trace_pow(1)) == n
    with pytest.raises(ValueError, match="exponent"):
        top.trace_pow(3)


def test_operator_skips_tiles():
    pts = np.random.RandomState(1).rand(2000, 2)
    op = torch_op(pts, 0.02, nu=0.5, density=0.01, tile=128)
    assert op.tile_density < 0.7  # pruning actually happens


def test_operator_general_nu_raises():
    """A general nu is ported (tests/test_torch_taper_general.py holds it
    against the reference); what still raises is a nu that is no Matern
    order."""
    pts = np.random.RandomState(0).rand(50, 2)
    assert torch_op(pts, 0.1, nu=1.0, density=0.1).nu == 1.0
    for bad in (0.0, -1.0, "one"):
        with pytest.raises(ValueError, match="positive"):
            torch_op(pts, 0.1, nu=bad, density=0.1)


# -- (f) the tapered operator through the profile-likelihood engine -----------

def test_tapered_engine_matches_jax():
    """TaperedMaternOperator -> KrylovProfileLikelihood -> fit at n = 1024
    against the JAX pair from the same random block (the JAX engine's own
    draw for key=0): factorization, der1 and the fit to rtol 1e-6."""
    import jax

    n, steps, num_probes = 1024, 32, 16
    # random points: on a regular grid the constant column of X spans a
    # small symmetric Krylov space that runs out before 32 steps, and the
    # tail of its chain is then roundoff in both packages
    pts = np.random.RandomState(0).rand(n, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    kw = dict(nu=0.5, density=0.05, tile=128)
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(0))
    probes = np.array(jax.random.rademacher(k_probe, (n, num_probes),
                                            dtype=jnp.float64))
    v_defl = np.array(jax.random.normal(k_defl, (n, 1), dtype=jnp.float64))
    jeng = jls.KrylovProfileLikelihood(
        jtaper.TaperedMaternOperator(pts, 0.05, use_pallas=False, **kw),
        X, z, lanczos_steps=steps, num_probes=num_probes, key=0)
    teng = tls.KrylovProfileLikelihood(
        torch_op(pts, 0.05, **kw), X, z, lanczos_steps=steps,
        num_probes=num_probes, device="cpu", dtype=F64, probes=probes,
        v_defl=v_defl)
    for name in ("alphas", "betas", "U", "G"):
        np.testing.assert_allclose(getattr(teng, name), getattr(jeng, name),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    for log_eta in (-2.0, 0.0, 1.5):
        np.testing.assert_allclose(teng.der1(log_eta), jeng.der1(log_eta),
                                   rtol=1e-6)
    got, want = teng.fit(), jeng.fit()
    assert got["success"] and want["success"]
    for name in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
