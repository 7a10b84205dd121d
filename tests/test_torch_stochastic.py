"""gppe_tpu_torch stochastic layer (Lanczos, f64 projections, deflated
quadrature, root finding) vs the JAX reference, on the CPU in float64.

The same numpy inputs go through both packages; JAX runs on the CPU under
x64 (tests/conftest.py), the port on ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import root_finding as jroot  # noqa: E402
from gppe_tpu.ops import stochastic as jst  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import root_finding as troot  # noqa: E402
from gppe_tpu_torch.ops import stochastic as tst  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


F64 = torch.float64


def _points(n, seed=0):
    return np.random.RandomState(seed).rand(n, 2)


def _dense_K(pts, rho=0.1):
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / rho
    return np.exp(-d)


def _compare_lanczos(t_out, j_out):
    ta, tb, tV = (x.numpy() for x in t_out)
    ja, jb, jV = (np.asarray(x) for x in j_out)
    assert ta.shape == ja.shape and tb.shape == jb.shape
    assert tV.shape == jV.shape
    np.testing.assert_allclose(ta, ja, rtol=1e-8)
    np.testing.assert_allclose(tb, jb, rtol=1e-8)
    np.testing.assert_allclose(tV, jV, rtol=0, atol=1e-7)


@pytest.mark.parametrize("reorthogonalize", [True, False])
def test_lanczos_dense(reorthogonalize):
    pts = _points(200, seed=1)
    K = _dense_K(pts)
    V0 = np.random.RandomState(2).standard_normal((200, 3))
    Kj = jnp.asarray(K)
    j_out = jst.lanczos(lambda V: jnp.matmul(Kj, V, precision="highest"),
                        jnp.asarray(V0), 20, reorthogonalize=reorthogonalize)
    Kt = torch.as_tensor(K)
    t_out = tst.lanczos(lambda V: Kt @ V, torch.as_tensor(V0), 20,
                        reorthogonalize=reorthogonalize)
    _compare_lanczos(t_out, j_out)


@pytest.mark.parametrize("nu", [0.5, 1.5])
def test_lanczos_matern_operator(nu):
    pts = _points(300, seed=3)
    V0 = np.random.RandomState(4).standard_normal((300, 4))
    jop = jops.MaternOperator(pts, 0.1, nu=nu, block_rows=128)
    top = tops.MaternOperator(pts, 0.1, nu=nu, block_rows=128,
                              device="cpu", dtype=F64)
    j_out = jst.lanczos(jop.matmat, jnp.asarray(V0), 16)
    t_out = tst.lanczos(top.matmat, torch.as_tensor(V0), 16)
    _compare_lanczos(t_out, j_out)


def test_lanczos_sums_in_float64_for_float32_vectors():
    pts = _points(128, seed=5)
    top = tops.MaternOperator(pts, 0.1, device="cpu", dtype=torch.float32)
    V0 = torch.as_tensor(np.random.RandomState(6).standard_normal((128, 2)),
                         dtype=torch.float32)
    a, b, V = tst.lanczos(top.matmat, V0, 8)
    assert a.dtype == F64 and b.dtype == F64 and V.dtype == torch.float32
    # the basis is orthonormal to float32 precision
    G = torch.einsum("kn,ln->kl", V[:, 0].double(), V[:, 0].double())
    np.testing.assert_allclose(G.numpy(), np.eye(8), atol=1e-5)


@pytest.mark.parametrize("n", [500, 9000])
def test_gram_f64(n):
    """n = 9000 exceeds the reference's 8192 block, so its blocked sum is
    compared too."""
    Vm = np.random.RandomState(n).standard_normal((6, n))
    want = np.asarray(jst.gram_f64(jnp.asarray(Vm)))
    got = tst.gram_f64(torch.as_tensor(Vm)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("n", [500, 9000])
def test_matmul_f64(n):
    rng = np.random.RandomState(n + 1)
    A = rng.standard_normal((5, n))
    B = rng.standard_normal((n, 3))
    want = np.asarray(jst.matmul_f64(jnp.asarray(A), jnp.asarray(B)))
    got = tst.matmul_f64(torch.as_tensor(A),
                         torch.as_tensor(B, dtype=torch.float32)).numpy()
    got64 = tst.matmul_f64(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got64, want, rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def merged_pass():
    """One reference Lanczos pass over [v_defl, probes] on a Matern K —
    the inputs deflated_quadrature consumes."""
    n, p, k = 300, 8, 24
    pts = _points(n, seed=7)
    rng = np.random.RandomState(8)
    probes = np.sign(rng.standard_normal((n, p)))
    v_defl = rng.standard_normal((n, 1))
    jop = jops.MaternOperator(pts, 0.1, nu=0.5, block_rows=128)
    al, be, V = jst.lanczos(jop.matmat, jnp.asarray(
        np.concatenate([v_defl, probes], axis=1)), k)
    P = np.asarray(V[:, 0]) @ probes
    return (np.asarray(al), np.asarray(be), P, probes, n,
            float(jop.trace_pow(2)))


@pytest.mark.parametrize("with_trace_K2", [True, False])
def test_deflated_quadrature(merged_pass, with_trace_K2):
    al, be, P, probes, n, tk2 = merged_pass
    args = (al[0], be[0], al[1:], be[1:], P, (probes ** 2).sum(0), n)
    tk2 = tk2 if with_trace_K2 else None
    jn, jw = jst.deflated_quadrature(*args, trace_K2=tk2)
    tn, tw = tst.deflated_quadrature(*args, trace_K2=tk2)
    np.testing.assert_allclose(tn, jn, rtol=1e-12)
    np.testing.assert_allclose(tw, jw, rtol=1e-12)
    jq = jst.QuadratureTraceEngine(jn, jw, n)
    tq = tst.QuadratureTraceEngine(tn, tw, n)
    for eta in (1e-2, 0.3, 10.0):
        np.testing.assert_allclose(tq.logdet(eta), jq.logdet(eta),
                                   rtol=1e-12)
        np.testing.assert_allclose(tq.traceinv(eta, 2),
                                   jq.traceinv(eta, 2), rtol=1e-12)
        np.testing.assert_allclose(tq.trace_pow(eta, 2),
                                   jq.trace_pow(eta, 2), rtol=1e-12)


def test_ritz_decompose(merged_pass):
    al, be = merged_pass[:2]
    for got, want in zip(tst.ritz_decompose(al, be),
                         jst.ritz_decompose(al, be)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("bracket", [(-1.0, 2.0), (0.5, 3.0)])
def test_chandrupatla_scalar(bracket):
    def f(x):
        return np.tanh(x - 1.2345) + 0.1 * (x - 1.2345)

    x0, x1 = bracket
    want = jroot.chandrupatla_scalar(f, x0, x1, f(x0), f(x1), tol=1e-10)
    got = troot.chandrupatla_scalar(f, x0, x1, f(x0), f(x1), tol=1e-10)
    assert got == want
    np.testing.assert_allclose(got[0], 1.2345, atol=1e-8)
