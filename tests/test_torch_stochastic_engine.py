"""gppe_tpu_torch's StochasticTraceEngine and hutchinson_traceinv vs
gppe_tpu's, on the CPU in float64 (the JAX package under x64,
tests/conftest.py).

Both engines see the same random block: the test draws the reference's
own deflation start and probes (``jax.random.split(PRNGKey(key))``, then
``normal`` and ``rademacher`` in float64, as gppe_tpu/ops/stochastic.py
does) and hands them to the port as ``v_defl=`` / ``probes=``. K is a
Matern nu = 1/2 correlation of 300 seeded random points, dense or as a
matrix-free operator. Tolerances: the deflation chain's Ritz values, the
exact moments and the projected probes rtol 1e-8; the estimates at each
eta rtol 1e-5 (traceinv2: 1e-3), and within 10% of the exact float64
values: the estimator's own error with 12 probes, largest for traceinv2 at
eta = 1e-2 (8% in both packages). The probe
Lanczos pass is not compared step by step: its start lies in the
complement of the deflated Ritz vectors, and after ~13 steps it amplifies
the roundoff left in those directions, so two runs from probes 5e-15
apart (in either package) part at the 1e-1 level in later Ritz values
while their quadrature estimates agree to ~3e-7.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import stochastic as jst  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import stochastic as tst  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

N, PROBES, STEPS = 300, 12, 30
ETAS = [1e-2, 0.3, 10.0]
# traceinv2 weighs the smallest Ritz values most, which the probe pass's
# amplified roundoff moves (1.3e-4 apart at eta = 1e-2)
PACKAGE_RTOL = {"logdet": 1e-5, "traceinv": 1e-5, "traceinv2": 1e-3,
                "trace3": 1e-5}
F64 = torch.float64


@pytest.fixture(scope="module")
def points():
    return np.random.RandomState(5).rand(N, 2)


@pytest.fixture(scope="module")
def K(points):
    d = np.sqrt(((points[:, None] - points[None]) ** 2).sum(-1)) / 0.1
    return np.exp(-d)


def reference_block(key, n, p):
    """The reference engine's draws for ``key`` (stochastic.py:254-277)."""
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
    v0 = np.array(jax.random.normal(k_defl, (n, 1), dtype=jnp.float64))
    probes = np.array(jax.random.rademacher(k_probe, (n, p),
                                            dtype=jnp.float64))
    return probes, v0


def exact(K, eta):
    w = np.linalg.eigvalsh(K) + eta
    return {"logdet": np.log(w).sum(), "traceinv": (1 / w).sum(),
            "traceinv2": (w ** -2).sum(), "trace3": (w ** 3).sum()}


def estimates(eng, eta):
    return {"logdet": eng.logdet(eta), "traceinv": eng.traceinv(eta),
            "traceinv2": eng.traceinv(eta, exponent=2),
            "trace3": eng.trace_pow(eta, exponent=3)}


@pytest.fixture(scope="module", params=["dense", "operator"])
def engines(request, points, K):
    probes, v0 = reference_block(3, N, PROBES)
    kw = dict(num_probes=PROBES, lanczos_steps=STEPS, deflate=16)
    if request.param == "dense":
        jeng = jst.StochasticTraceEngine(jnp.asarray(K), key=3, **kw)
        teng = tst.StochasticTraceEngine(torch.as_tensor(K), probes=probes,
                                         v_defl=v0, **kw)
    else:
        jeng = jst.StochasticTraceEngine(
            jops.MaternOperator(points, 0.1, nu=0.5), key=3, **kw)
        teng = tst.StochasticTraceEngine(
            tops.MaternOperator(points, 0.1, nu=0.5, device="cpu",
                                dtype=F64), probes=probes, v_defl=v0, **kw)
    return jeng, teng


def test_engine_state_matches(engines):
    jeng, teng = engines
    assert teng.q == jeng.q > 0
    np.testing.assert_allclose(teng.lam_top, jeng.lam_top, rtol=1e-8)
    for name in ("M0", "M1", "M2"):
        np.testing.assert_allclose(getattr(teng, name), getattr(jeng, name),
                                   rtol=1e-8, err_msg=name)
    np.testing.assert_allclose(teng.probe_norm2, jeng.probe_norm2,
                               rtol=1e-8)
    np.testing.assert_allclose(teng.probes.numpy(), np.asarray(jeng.probes),
                               rtol=1e-8, atol=1e-12)
    assert teng.theta.shape == jeng.theta.shape == (PROBES, STEPS)
    # the probes were projected out of the deflation basis
    proj = teng.W.T @ teng.probes
    assert float(torch.abs(proj).max()) < 1e-10


@pytest.mark.parametrize("eta", ETAS)
def test_engine_estimates_match(engines, K, eta):
    jeng, teng = engines
    got, want, truth = estimates(teng, eta), estimates(jeng, eta), exact(
        K, eta)
    for name in got:
        np.testing.assert_allclose(got[name], want[name],
                                   rtol=PACKAGE_RTOL[name], err_msg=name)
        np.testing.assert_allclose(got[name], truth[name], rtol=0.1,
                                   err_msg=name)


def test_engine_without_deflation_and_own_draws(K):
    """deflate=0 keeps the probes as drawn; a seeded generator replaces the
    carried block and still estimates logdet within 2%."""
    probes, v0 = reference_block(4, N, PROBES)
    jeng = jst.StochasticTraceEngine(jnp.asarray(K), num_probes=PROBES,
                                     lanczos_steps=STEPS, key=4, deflate=0)
    teng = tst.StochasticTraceEngine(torch.as_tensor(K), num_probes=PROBES,
                                     lanczos_steps=STEPS, probes=probes,
                                     v_defl=v0, deflate=0)
    assert teng.q == 0 and teng.W is None
    np.testing.assert_array_equal(teng.probes.numpy(), probes)
    np.testing.assert_allclose(teng.logdet(0.3), jeng.logdet(0.3), rtol=1e-10)
    gen = torch.Generator().manual_seed(11)
    own = tst.StochasticTraceEngine(torch.as_tensor(K), num_probes=PROBES,
                                    lanczos_steps=STEPS, generator=gen)
    np.testing.assert_allclose(own.logdet(0.3), exact(K, 0.3)["logdet"],
                               rtol=2e-2)


def test_deferred_lanczos_and_from_tridiagonals(K):
    """defer_lanczos + finalize over an external pass equals the engine's
    own pass; from_tridiagonals equals the reference's on the same
    coefficients."""
    probes, v0 = reference_block(3, N, PROBES)
    Kt = torch.as_tensor(K)
    kw = dict(num_probes=PROBES, lanczos_steps=STEPS, deflate=16,
              probes=probes, v_defl=v0)
    eng = tst.StochasticTraceEngine(Kt, **kw)
    deferred = tst.StochasticTraceEngine(Kt, defer_lanczos=True, **kw)
    assert deferred.theta is None
    al, be, _ = tst.lanczos(Kt.__matmul__, deferred.probes, STEPS)
    deferred.finalize(al, be)
    assert deferred.logdet(0.3) == eng.logdet(0.3)

    al_np, be_np = al.numpy(), be.numpy()
    norm2 = deferred.probe_norm2
    tk2 = float((K * K).sum())
    got = tst.StochasticTraceEngine.from_tridiagonals(al, be, norm2, N,
                                                      trace_K2=tk2)
    want = jst.StochasticTraceEngine.from_tridiagonals(al_np, be_np, norm2,
                                                       N, trace_K2=tk2)
    for eta in ETAS:
        np.testing.assert_allclose(got.traceinv(eta), want.traceinv(eta),
                                   rtol=1e-12)
        np.testing.assert_allclose(got.logdet(eta), want.logdet(eta),
                                   rtol=1e-12)


@pytest.mark.parametrize("exponent", [1, 2])
@pytest.mark.parametrize("form", ["dense", "operator"])
def test_hutchinson_traceinv(points, K, exponent, form):
    """The reference's probes (rademacher of PRNGKey(key), no split) go
    to the port; both CG the same systems to tol 1e-10."""
    p = 32
    probes = np.array(jax.random.rademacher(jax.random.PRNGKey(7), (N, p),
                                            dtype=jnp.float64))
    if form == "dense":
        jK, tK = jnp.asarray(K), torch.as_tensor(K)
    else:
        jK = jops.MaternOperator(points, 0.1, nu=0.5)
        tK = tops.MaternOperator(points, 0.1, nu=0.5, device="cpu",
                                 dtype=F64)
    want = jst.hutchinson_traceinv(jK, 0.3, num_probes=p, key=7, tol=1e-10,
                                   exponent=exponent)
    got = tst.hutchinson_traceinv(tK, 0.3, num_probes=p, tol=1e-10,
                                  exponent=exponent, probes=probes)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    truth = exact(K, 0.3)["traceinv" if exponent == 1 else "traceinv2"]
    np.testing.assert_allclose(got, truth, rtol=0.1)
    with pytest.raises(ValueError):
        tst.hutchinson_traceinv(tK, 0.3, exponent=3, probes=probes)
