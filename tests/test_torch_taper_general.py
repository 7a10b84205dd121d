"""TaperedMaternOperator at a general nu vs the JAX reference, on the CPU in
float64.

Inputs come from numpy seeds and go through both packages (JAX under x64,
tests/conftest.py). The reference runs a general nu on its XLA scans
(``use_pallas`` is set for the closed forms only); the port runs the plain
version of ``csrc/matern_blocksparse_general.cu`` here
(``cuda_kernels.matern_matmat_blocksparse_plain`` over the ported Bessel
K_nu). Tolerances: the geometry equal (the threshold to rtol 1e-12, the
Bessel K_nu of two implementations), ``matmat`` to atol 1e-10 and
``trace_pow(2)`` to rtol 1e-10 against the reference and against the
tapered dense truth; the Krylov engine's factorization, der1 and fit to
rtol 1e-6 on random points (tests/test_torch_taper.py's bound).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import large_scale as jls  # noqa: E402
from gppe_tpu.ops import kernels as jk  # noqa: E402
from gppe_tpu.ops import taper as jtaper  # noqa: E402
from gppe_tpu_torch.models import large_scale as tls  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

F64 = torch.float64


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def torch_op(pts, scale, **kw):
    return ttaper.TaperedMaternOperator(pts, scale, device="cpu", dtype=F64,
                                        **kw)


@pytest.fixture(scope="module", params=[1.2, 3.7], ids=["nu1.2", "nu3.7"])
def operators(request):
    """n = 512 random points, rho 0.05, density 0.05, tiles of 64 (8 tiles,
    some pairs pruned); each reference result computed once."""
    nu = request.param
    pts = np.random.RandomState(int(10 * nu)).rand(512, 2)
    kw = dict(nu=nu, density=0.05, tile=64)
    jop = jtaper.TaperedMaternOperator(pts, 0.05, use_pallas=False, **kw)
    top = torch_op(pts, 0.05, **kw)
    V = np.random.RandomState(5).standard_normal((512, 3))
    want = {"matmat": np.asarray(jop.matmat(jnp.asarray(V))),
            "trace2": float(jop.trace_pow(2))}
    return pts, V, jop, top, want


def test_geometry_matches(operators):
    _, _, jop, top, _ = operators
    for name in ("perm", "inv_perm", "pair_i", "pair_j"):
        np.testing.assert_array_equal(getattr(top, name), getattr(jop, name))
    assert top.nu == jop.nu and top.tile == jop.tile
    assert top.radius == jop.radius and top.tile_density == jop.tile_density
    assert top.tile_density < 1.0                      # pruning happens
    np.testing.assert_allclose(top.threshold, jop.threshold, rtol=1e-12)
    assert top.nnz_estimate() == jop.nnz_estimate()


def test_products_match(operators):
    """matmat and trace_pow(2) against the reference's scans and the
    tapered dense truth; on the CPU no kernel launches."""
    pts, V, _, top, want = operators
    cuda_kernels.reset_launch_counts()
    got = top.matmat(V).numpy()
    trace2 = float(top.trace_pow(2))
    assert not any(cuda_kernels.launch_counts.values())
    np.testing.assert_allclose(got, want["matmat"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(trace2, want["trace2"], rtol=1e-10)
    # the tapered dense truth: the reference's kernel, its threshold
    d = np.sqrt((((pts[:, None] - pts[None]) / 0.05) ** 2).sum(-1))
    K = np.asarray(jk.matern(jnp.asarray(d), top.nu))
    Kt = np.where(K >= top.threshold, K, 0.0)
    np.testing.assert_allclose(got, Kt @ V, rtol=0, atol=1e-10)
    np.testing.assert_allclose(trace2, np.sum(Kt * Kt), rtol=1e-10)
    assert top.matvec(V[:, 0]).shape == (512,)
    assert float(top.trace_pow(0)) == float(top.trace_pow(1)) == 512


def test_tapered_general_engine_matches_jax():
    """TaperedMaternOperator at nu = 1.2 -> KrylovProfileLikelihood -> fit
    at n = 256 against the JAX pair from the same random block (the JAX
    engine's own draw for key=0)."""
    n, steps, num_probes = 256, 12, 8
    pts = np.random.RandomState(0).rand(n, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    kw = dict(nu=1.2, density=0.1, tile=64)
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
