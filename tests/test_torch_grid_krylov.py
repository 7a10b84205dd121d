"""The ported multi-rho product and grid-batched Krylov engine vs the JAX
reference, on the CPU in float64.

Inputs come from numpy seeds and go through both packages. The JAX grid
engine draws its random block from ``jax.random``; the tests repeat that
draw and hand it to the port as ``probes=`` / ``v_defl=``, so both
factorize the same block. The Pallas multi-rho kernel runs in interpret
mode, as tests/test_kernels.py runs it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gppe_tpu.models import grid_krylov as jgk  # noqa: E402
from gppe_tpu.ops import pallas_kernels  # noqa: E402
from gppe_tpu_torch.models import grid_krylov as tgk  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()

F64 = torch.float64
N, STEPS, PROBES = 400, 24, 8
RHOS = np.array([0.08, 0.1, 0.15])
NU = 0.5


def dense_k(pts, rho, nu):
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / rho
    if nu == 0.5:
        return np.exp(-d)
    if nu == 1.5:
        return (1 + np.sqrt(3) * d) * np.exp(-np.sqrt(3) * d)
    if nu == 2.5:
        return (1 + np.sqrt(5) * d + 5 * d * d / 3) * np.exp(-np.sqrt(5) * d)
    return np.exp(-0.5 * d * d)


# -- (a) the multi-rho product ------------------------------------------------

def test_multirho_plain_vs_pallas_interpret():
    """Ragged n = 300 (not a multiple of the Pallas tile 128), the case of
    tests/test_kernels.py::test_multirho_frobenius_output. The Pallas
    kernel computes in float32, so the product is held to rtol = atol =
    1e-4 and the traces to rtol 1e-5, the reference test's own bounds."""
    rng = np.random.RandomState(3)
    n = 300
    pts = rng.rand(n, 2)
    rhos = np.asarray([0.07, 0.15])
    V = rng.standard_normal((2, n, 3)).astype(np.float32)
    want, want_tk2 = pallas_kernels.matern_matmat_multirho(
        pts, rhos, V, 0.5, tile=128, interpret=True, return_frobenius=True)
    got, got_tk2 = cuda_kernels.matern_matmat_multirho(
        torch.as_tensor(pts), torch.as_tensor(rhos),
        torch.as_tensor(V, dtype=F64), 0.5, return_frobenius=True,
        block_rows=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_tk2.numpy(), np.asarray(want_tk2),
                               rtol=1e-5)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 150.0])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_multirho_plain_vs_dense_numpy(nu, d):
    """Float64 against dense numpy float64: only summation order differs,
    so rtol = atol = 1e-10 on the product, rtol 1e-10 on the traces."""
    rng = np.random.RandomState(10 + d)
    n = 301
    pts = rng.rand(n, d)
    rhos = np.asarray([0.07, 0.15, 0.4])
    V = rng.standard_normal((3, n, 5))
    got, tk2 = cuda_kernels.matern_matmat_multirho(
        torch.as_tensor(pts), rhos, torch.as_tensor(V), nu,
        return_frobenius=True, block_rows=97)
    for b, rho in enumerate(rhos):
        K = dense_k(pts, rho, nu)
        np.testing.assert_allclose(got[b].numpy(), K @ V[b], rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(float(tk2[b]), np.sum(K * K), rtol=1e-10)


def test_multirho_strided_input_and_trace_only():
    """On the CPU a strided V (the view the grid engine's Lanczos block
    gives) multiplies like a contiguous one; V=None gives the traces
    alone. Same arithmetic, so exact equality."""
    rng = np.random.RandomState(4)
    pts = torch.as_tensor(rng.rand(130, 2))
    rhos = torch.as_tensor([0.1, 0.2])
    V = torch.as_tensor(rng.standard_normal((2, 130, 4)))
    Vt = V.transpose(1, 2).contiguous().transpose(1, 2)
    assert not Vt.is_contiguous()
    a, tk2 = cuda_kernels.matern_matmat_multirho(pts, rhos, V, 1.5,
                                                 return_frobenius=True)
    b = cuda_kernels.matern_matmat_multirho(pts, rhos, Vt, 1.5)
    none, tk2_only = cuda_kernels.matern_matmat_multirho(
        pts, rhos, None, 1.5, return_frobenius=True)
    assert a.shape == b.shape == (2, 130, 4) and none is None
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(tk2.numpy(), tk2_only.numpy())


def test_multirho_rejects():
    pts = torch.rand(20, 2, dtype=F64)
    V = torch.rand(2, 20, 3, dtype=F64)
    rhos = [0.1, 0.2]
    with pytest.raises(ValueError, match="dot_mode must be one of"):
        cuda_kernels.matern_matmat_multirho(pts, rhos, V, 0.5,
                                            dot_mode="bf16x2")
    with pytest.raises(NotImplementedError, match="general nu"):
        cuda_kernels.matern_matmat_multirho(pts, rhos, V, 1.0)
    with pytest.raises(ValueError, match="V must be"):
        cuda_kernels.matern_matmat_multirho(pts, rhos, V[:1], 0.5)
    with pytest.raises(ValueError, match="return_frobenius"):
        cuda_kernels.matern_matmat_multirho(pts, rhos, None, 0.5)


# -- (d), (e) the grid engine -------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    pts = rng.rand(N, 2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    return pts, z, X


@pytest.fixture(scope="module")
def random_block():
    """The JAX grid engine's own draw for key=0 (grid_krylov.py:218-221)."""
    k_probe, k_defl = jax.random.split(jax.random.PRNGKey(0))
    probes = np.array(jax.random.rademacher(k_probe, (N, PROBES),
                                            dtype=jnp.float64))
    v_defl = np.array(jax.random.normal(k_defl, (N, 1), dtype=jnp.float64))
    return probes, v_defl


def jax_grid(problem, matrix_free, **kw):
    pts, z, X = problem
    return jgk.GridKrylovProfileLikelihood(
        pts, X, z, RHOS, np.full(3, NU), nu_static=NU, lanczos_steps=STEPS,
        num_probes=PROBES, key=0, matrix_free=matrix_free, block_rows=128,
        **kw)


def torch_grid(problem, random_block, matrix_free, **kw):
    pts, z, X = problem
    probes, v_defl = random_block
    return tgk.GridKrylovProfileLikelihood(
        pts, X, z, RHOS, np.full(3, NU), nu_static=NU, lanczos_steps=STEPS,
        num_probes=PROBES, matrix_free=matrix_free, block_rows=128,
        device="cpu", dtype=F64, probes=probes, v_defl=v_defl, **kw)


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "matrix_free"])
def grids(request, problem, random_block):
    return (jax_grid(problem, request.param),
            torch_grid(problem, random_block, request.param))


def test_grid_factorization_matches(grids):
    """Per-point Krylov factorization against the JAX engine's, rtol 1e-6
    (both float64; the orders of summation differ)."""
    jg, tg = grids
    assert len(tg.engines) == len(jg.engines) == 3
    assert tg.chunk == jg.chunk and tg.matrix_free == jg.matrix_free
    for je, te in zip(jg.engines, tg.engines):
        for name in ("alphas", "betas", "U", "G", "rhs_norms", "AtA"):
            np.testing.assert_allclose(getattr(te, name), getattr(je, name),
                                       rtol=1e-6, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(te.traces.nodes, je.traces.nodes,
                                   rtol=1e-6, atol=1e-10)


def test_grid_fit_all_matches(grids):
    """eta, sigma, sigma0 and lp of every grid point, rtol 1e-6."""
    jg, tg = grids
    for jr, tr in zip(jg.fit_all(), tg.fit_all()):
        assert tr["success"] and jr["success"]
        assert tr["rho"] == jr["rho"] and tr["nu"] == jr["nu"]
        for name in ("eta", "sigma", "sigma0", "lp"):
            np.testing.assert_allclose(tr[name], jr[name], rtol=1e-6,
                                       err_msg=name)


def test_grid_chunking_consistent(problem, random_block):
    """chunk=2 gives the same answers as one chunk; not bitwise, because
    the flattened batched products sum in a B-dependent order: eta to
    rel 1e-3, the bound of tests/test_grid_krylov.py."""
    one = torch_grid(problem, random_block, True).fit_all()
    two = torch_grid(problem, random_block, True, chunk=2)
    assert two.chunk == 2 and len(two.engines) == 3
    for a, b in zip(one, two.fit_all()):
        assert a["eta"] == pytest.approx(b["eta"], rel=1e-3)


def test_grid_own_random_block_and_auto_chunk(problem):
    """Without a carried-over block the engine draws its own from a seeded
    generator; the default chunk is sized from ``max_chunk_bytes``."""
    pts, z, X = problem
    r_tot = X.shape[1] + 2 + PROBES
    g = tgk.GridKrylovProfileLikelihood(
        pts, X, z, RHOS, np.full(3, NU), nu_static=NU, lanczos_steps=STEPS,
        num_probes=PROBES, matrix_free=True, device="cpu", dtype=F64,
        generator=torch.Generator().manual_seed(5),
        max_chunk_bytes=2 * STEPS * N * r_tot * 8)
    assert g.chunk == 2
    for r in g.fit_all():
        assert r["success"] and 0.15 < r["sigma0"] < 0.25


def test_grid_general_nu_raises(problem):
    """A general nu is ported (tests/test_torch_general_nu.py holds it
    against the reference); what still raises is a nu that is not positive
    and nus that do not pair up with the rhos."""
    pts, z, X = problem
    with pytest.raises(ValueError, match="positive"):
        tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS,
                                        np.array([1.0, 0.0, 2.0]),
                                        device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="positive"):
        tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS, np.full(3, 1.0),
                                        nu_static=-1.0, device="cpu",
                                        dtype=F64)
    with pytest.raises(ValueError, match="equal length"):
        tgk.GridKrylovProfileLikelihood(pts, X, z, RHOS, np.full(2, NU),
                                        nu_static=NU, device="cpu",
                                        dtype=F64)


def test_engines_from_jax_factorization(problem, random_block):
    """The JAX package's own chunk factorization, as numpy arrays, through
    the port's ``engines_from_factorization`` gives the JAX engine's fits:
    the same arrays through the same host math, so rtol 1e-10."""
    pts, z, X = problem
    probes, v_defl = random_block
    jg = jax_grid(problem, False)
    A = np.concatenate([z[:, None], X], axis=1)
    AB = jnp.concatenate([jnp.asarray(A), jnp.asarray(v_defl),
                          jnp.asarray(probes)], axis=1)
    fact = jgk._factorize_chunk(jnp.asarray(pts), jnp.asarray(RHOS),
                                jnp.full(3, NU), AB, STEPS, X.shape[1] + 1,
                                NU)
    engines = tgk.engines_from_factorization(
        *(np.asarray(a) for a in fact), jg.rhs_norms, N, X.shape[1],
        AtA=A.T @ A)
    assert len(engines) == 3
    for eng, jeng in zip(engines, jg.engines):
        got, want = eng.fit(), jeng.fit()
        for name in ("eta", "sigma", "sigma0"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-10)
        np.testing.assert_allclose(eng.der1(0.3), jeng.der1(0.3), rtol=1e-10)
