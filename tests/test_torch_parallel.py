"""The ported multi-device slice (gppe_tpu_torch.parallel) vs the JAX
reference, on the CPU in float64.

The port's ranks are processes: one launch of four gloo ranks
(``parallel.mesh.spawn``, a ``file://`` store, one torch thread each)
runs every sharded computation of the file on meshes of its first 1, 2
or 4 ranks, and returns what each rank computed; the scaling twin's test
is the file's second launch. The reference runs in this process on the
virtual 8-device CPU mesh of tests/conftest.py: its factorization program
once (through ``ShardedKrylovProfileLikelihood`` on two problems, the
program's inputs and outputs captured), its profile step once, and its
ring product. Both sides get the same numpy data and the reference's own
``jax.random`` probes and deflation start.

Bounds: the products rtol 1e-10 (float64 sums in another order); the
factorization and the profile step rtol 1e-8, each array's entries within
1e-10 of its largest magnitude absolutely (the Gram blocks of orthonormal
bases hold exact zeros that float64 rounding leaves at 1e-16); the fits
rtol 1e-6 against the reference and the single-device engine on the same
draws; the samplers' mesh= bit for bit against mesh=None. The rank-side
functions import no JAX (each rank imports this module).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu_torch.drivers import sample_posterior as tsp  # noqa: E402
from gppe_tpu_torch.drivers import scaling_efficiency  # noqa: E402
from gppe_tpu_torch.models import hmc as thmc  # noqa: E402
from gppe_tpu_torch.models import nuts as tnuts  # noqa: E402
from gppe_tpu_torch.models.large_scale import (  # noqa: E402
    KrylovProfileLikelihood)
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops.operators import MaternOperator  # noqa: E402
from gppe_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gppe_tpu_torch.parallel import sharded as tsharded  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

F64 = torch.float64
STEPS, PROBES = 40, 16
ETAS = [0.3, 3.0, 30.0]
FACT_NAMES = tsharded.FACTORIZATION
# the sampler problems: the elementwise Gaussian of tests/test_torch_nuts.py
# and the dense (eta, rho) posterior of a 6 x 6 grid
COV = np.array([[1.0, 0.6], [0.6, 2.0]])
PREC = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])
BOX = ((-3.0, 4.0), (-2.0, 0.0))


def gauss_t(x):
    d0, d1 = x[0] - MEAN[0], x[1] - MEAN[1]
    return -0.5 * (PREC[0, 0] * d0 * d0 + 2.0 * PREC[0, 1] * d0 * d1
                   + PREC[1, 1] * d1 * d1)


def problem(name):
    """"grid": tests/test_parallel.py:137-157's (a 16 x 16 grid, rho 0.1;
    its optimum is the eta -> inf boundary); "random": 256 uniform points,
    rho 0.05, an interior optimum (eta ~ 2.3)."""
    if name == "grid":
        pts = tdata.generate_points(16, dimension=2)
        rho = 0.1
    else:
        pts = np.random.RandomState(3).rand(256, 2)
        rho = 0.05
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2), rho)


def sampler_inputs():
    init = np.random.RandomState(4).standard_normal((8, 2))
    side = tdata.generate_points(6, dimension=2)
    return init, (side, tdata.generate_data(side, 0.2),
                  tdata.generate_basis_functions(side, 2))


def run_samplers(mesh):
    """The samplers of the bit-for-bit tests (``mesh`` None or a mesh)."""
    init, (pts, z, X) = sampler_inputs()
    theta0 = torch.as_tensor(init, dtype=F64)
    out = {}
    res = thmc.hmc_sample(gauss_t, theta0, 3, num_samples=8, num_warmup=8,
                          num_leapfrog=4, mesh=mesh)
    out["hmc_gauss"] = res
    res = tnuts.nuts_sample(gauss_t, theta0, 5, num_samples=6, num_warmup=6,
                            max_depth=5, mesh=mesh)
    out["nuts_gauss"] = res
    res = thmc.sample_posterior(pts, z, X, num_chains=4, num_samples=3,
                                num_warmup=3, num_leapfrog=3,
                                support_log10=BOX, mesh=mesh, device="cpu")
    out["hmc_kernel_posterior"] = res
    return {k: {f: (np.asarray(v.numpy()) if torch.is_tensor(v) else v)
                for f, v in r._asdict().items()} for k, r in out.items()}


def _fact(mesh, inputs, comm):
    f = tsharded.build_sharded_factorization(mesh, nu=0.5,
                                             lanczos_steps=STEPS, comm=comm,
                                             dtype=F64)
    return f(*inputs)


def _fit(mesh, name, draws, comm="ring"):
    pts, z, X, rho = problem(name)
    eng = tsharded.ShardedKrylovProfileLikelihood(
        mesh, pts, X, z, rho, nu=0.5, lanczos_steps=STEPS,
        num_probes=PROBES, comm=comm, dtype=F64, probes=draws[0],
        v_defl=draws[1])
    return eng.fit()


def _world4(ref):
    """Every sharded computation of the file, on one rank of four."""
    out = {}
    # the products, mesh (1, 4): four ring steps
    m14 = tmesh.make_mesh(4, probe=1, device="cpu")
    pts, V = ref["product"]
    pts_t, V_t = torch.as_tensor(pts), torch.as_tensor(V)
    scale = torch.tensor([0.2, 0.2], dtype=F64)
    for comm, fn in (("ring", tsharded.ring_matern_matmat),
                     ("allgather", tsharded.allgather_matern_matmat)):
        local = fn(m14, tmesh.row_sharded(m14, pts_t), pts_t, scale,
                   tmesh.row_sharded(m14, V_t), 1.5)
        out[f"product_{comm}"] = m14.all_gather(local, "block").numpy()
    # the factorization, the step and the fit at mesh (2, 2)
    m22 = tmesh.make_mesh(4, probe=2, device="cpu")
    out["fact_random"] = _fact(m22, ref["fact_inputs_random"], "ring")
    for name in ("grid", "random"):
        out[f"fit_{name}"] = _fit(m22, name, ref[f"draws_{name}"])
    out["fact_random_allgather"] = _fact(m22, ref["fact_inputs_random"],
                                         "allgather")
    step = tsharded.build_sharded_profile_step(m22, nu=0.5,
                                               lanczos_steps=STEPS, dtype=F64)
    out["step"] = step(*ref["step_inputs"])
    # the fit on meshes of 1, 2 and 4 ranks, and with n = 250 over 4 blocks
    for nd, probe in ((1, 1), (2, 1), (4, 1)):
        mesh = tmesh.make_mesh(nd, probe=probe, device="cpu")
        if mesh is not None:
            out[f"fit_world{nd}"] = _fit(mesh, "random", ref["draws_random"])
    pts, z, X = ref["padded_problem"]
    eng = tsharded.ShardedKrylovProfileLikelihood(
        m14, pts, X, z, 0.1, lanczos_steps=STEPS, num_probes=PROBES,
        dtype=F64, probes=ref["padded_draws"][0],
        v_defl=ref["padded_draws"][1])
    out["padded"] = (eng.fit(), eng._eng.alphas, eng._eng.U, eng._eng.G)
    # the samplers on 2 ranks (chains over probe), then the driver twin on
    # all four
    m2 = tmesh.make_mesh(2, probe=2, device="cpu")
    if m2 is not None:
        out["samplers"] = run_samplers(m2)
    out["driver"] = tsp.main(num_points=5, num_chains=8, num_samples=3,
                             num_warmup=3, verbose=False,
                             device="cpu")["samples"]
    return out


# -- the parent's side: the reference, the inputs and one launch ------------

@pytest.fixture(scope="module")
def reference():
    """The reference's runs and the inputs handed to the ranks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gppe_tpu.parallel import mesh as jmesh
    from gppe_tpu.parallel import sharded as jsharded

    mesh22 = jmesh.make_mesh(4, probe=2)
    ref, captured = {}, {}
    build = jsharded.build_sharded_factorization

    def capturing(*args, **kwargs):
        fact = build(*args, **kwargs)

        def run(*inputs):
            out = fact(*inputs)
            captured["inputs"] = [np.array(a, dtype=np.float64)
                                  for a in inputs]
            captured["outputs"] = [np.asarray(o, dtype=np.float64)
                                   for o in out]
            return out
        return run

    jsharded.build_sharded_factorization = capturing
    try:
        for name in ("grid", "random"):
            pts, z, X, rho = problem(name)
            eng = jsharded.ShardedKrylovProfileLikelihood(
                mesh22, pts, X, z, rho, nu=0.5, lanczos_steps=STEPS,
                num_probes=PROBES)
            ref[f"jax_fit_{name}"] = eng.fit()
            ref[f"jax_fact_{name}"] = captured["outputs"]
            ref[f"fact_inputs_{name}"] = tuple(captured["inputs"])
            ref[f"draws_{name}"] = tuple(captured["inputs"][:-3:-1])
    finally:
        jsharded.build_sharded_factorization = build

    pts, z, X, rho = problem("random")
    probes = np.random.default_rng(0).choice([-1.0, 1.0], size=(256, 16))
    ref["step_inputs"] = (pts, np.full(2, rho), X, z, probes,
                          np.asarray(ETAS))
    step = jsharded.build_sharded_profile_step(mesh22, nu=0.5,
                                               lanczos_steps=STEPS)
    ref["jax_step"] = [np.asarray(o) for o in step(
        *(jnp.asarray(a) for a in ref["step_inputs"]))]

    rng = np.random.default_rng(3)
    prod_pts, V = rng.random((128, 2)), rng.standard_normal((128, 5))
    ref["product"] = (prod_pts, V)
    mesh14 = jmesh.make_mesh(4, probe=1)
    ref["jax_ring"] = np.asarray(jax.shard_map(
        lambda pl, pf, s, vl: jsharded.ring_matern_matmat(
            pl, pf, s, vl, 1.5, "block", 4),
        mesh=mesh14, in_specs=(P("block"), P(), P(), P("block")),
        out_specs=P("block"), check_vma=False)(
            jnp.asarray(prod_pts), jnp.asarray(prod_pts),
            jnp.asarray([0.2, 0.2]), jnp.asarray(V)))

    rng = np.random.default_rng(5)
    pts = rng.random((250, 2))                        # 250 % 4 != 0
    ref["padded_problem"] = (pts, tdata.generate_data(pts, 0.2),
                             tdata.generate_basis_functions(pts, 2))
    ref["padded_draws"] = (rng.choice([-1.0, 1.0], size=(250, PROBES)),
                           rng.standard_normal((250, 1)))
    return ref


@pytest.fixture(scope="module")
def ranks(reference):
    inputs = {k: v for k, v in reference.items() if not k.startswith("jax")}
    return tmesh.spawn(_world4, 4, "gloo", inputs)


def single_device_fit(pts, z, X, rho, draws):
    op = MaternOperator(pts, rho, nu=0.5, device="cpu", dtype=F64)
    return KrylovProfileLikelihood(op, X, z, lanczos_steps=STEPS,
                                   num_probes=PROBES, device="cpu",
                                   dtype=F64, probes=draws[0],
                                   v_defl=draws[1])


def close(got, want, rtol, label=""):
    got, want = np.asarray(got, float), np.asarray(want, float)
    atol = 1e-10 * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=label)


def fit_close(got, want, rtol=1e-6):
    assert got["success"] and want["success"]
    for key in ("eta", "sigma", "sigma0"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol)


# -- the mesh, without processes ---------------------------------------------

@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_mesh_shape_rule_is_the_reference(nd):
    from gppe_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(nd)
    assert tmesh.mesh_shape(nd) == (jm.shape["probe"], jm.shape["block"])
    assert tmesh.mesh_shape(nd, probe=nd) == (nd, 1)


def test_mesh_shape_refusals():
    with pytest.raises(ValueError, match="probe=3 does not divide 8"):
        tmesh.mesh_shape(8, probe=3)
    with pytest.raises(ValueError, match="at least one rank"):
        tmesh.mesh_shape(0)


def test_make_mesh_and_init_need_a_group_or_a_backend():
    with pytest.raises(ValueError, match="initialised process group"):
        tmesh.make_mesh()
    assert tmesh.multihost_init() is None              # one process: no-op
    assert tmesh.multihost_init(num_processes=1) is None
    with pytest.raises(ValueError, match="backend"):
        tmesh.multihost_init("localhost:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="backend"):
        tmesh.spawn(gauss_t, 1, "mpi")


def test_backend_rule():
    assert tmesh.backend_for(4, "cpu") == "gloo"
    # this host has no card: ranks on "cuda" would share none, so gloo
    assert tmesh.backend_for(1, "cuda") == ("nccl" if
                                            torch.cuda.device_count() >= 1
                                            else "gloo")
    assert scaling_efficiency.grade(2, "cpu") == "correctness"


def test_row_and_probe_shares():
    a = np.arange(24.0).reshape(6, 4)
    mesh = tmesh.Mesh((2, 3), rank=4, groups={}, device="cpu",
                      backend="gloo")
    assert mesh.coords == {"probe": 1, "block": 1}
    np.testing.assert_array_equal(tmesh.row_sharded(mesh, a), a[2:4])
    np.testing.assert_array_equal(tmesh.probe_sharded(mesh, a), a[:, 2:])
    assert tmesh.replicated(mesh, a) is a
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.row_sharded(mesh, a[:5])


def test_far_pads_checked():
    pts = np.random.RandomState(0).rand(10, 2)
    padded = tsharded._far_pads(pts, 12, 0.1)
    assert padded.shape == (12, 2) and np.all(padded[10:, 0] >= 2e6)
    with pytest.raises(ValueError, match="far pads"):
        tsharded._far_pads(pts, 12, 1e3)


def test_comm_schedule_refused():
    with pytest.raises(ValueError, match="unknown comm schedule"):
        tsharded.build_sharded_profile_step(None, comm="tree")


# -- one launch of four ranks -------------------------------------------------

@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_products_match_reference_ring_and_plain(reference, ranks, comm):
    pts, V = reference["product"]
    plain = cuda_kernels.matern_matmat_plain(
        torch.as_tensor(pts), torch.tensor([0.2, 0.2], dtype=F64),
        torch.as_tensor(V), 1.5).numpy()
    for r in ranks:
        np.testing.assert_allclose(r[f"product_{comm}"], plain, rtol=1e-10)
        np.testing.assert_allclose(r[f"product_{comm}"],
                                   reference["jax_ring"], rtol=1e-10)


def test_factorization_matches_reference(reference, ranks):
    """On the random problem. On the grid problem the reference's own
    factorizations at meshes (2, 2) and (1, 1) part from Lanczos step 12
    on by up to 7 in alpha (float64 rounding grown by the recurrences on
    the grid's repeated eigenvalues; ROADMAP C1), so only the fit, whose
    optimum there is the exact OLS boundary, is compared there."""
    want = reference["jax_fact_random"]
    for r in ranks:
        got = r["fact_random"]
        for key, g, w in zip(FACT_NAMES, got, want):
            assert np.shape(g) == np.shape(w), key
            close(g, w, 1e-8, key)


def test_factorization_ring_equals_allgather(ranks):
    for r in ranks:
        for key, a, b in zip(FACT_NAMES, r["fact_random"],
                             r["fact_random_allgather"]):
            close(a, b, 1e-10, key)


def test_profile_step_matches_reference(reference, ranks):
    for r in ranks:
        for got, want in zip(r["step"], reference["jax_step"]):
            np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("name", ["grid", "random"])
def test_fit_matches_reference_and_single_device(reference, ranks, name):
    pts, z, X, rho = problem(name)
    single = single_device_fit(pts, z, X, rho,
                               reference[f"draws_{name}"]).fit()
    for r in ranks:
        fit_close(r[f"fit_{name}"], reference[f"jax_fit_{name}"])
        fit_close(r[f"fit_{name}"], single)
    if name == "random":
        assert 1.0 < single["eta"] < 5.0              # an interior optimum


def test_world_sizes_agree(ranks):
    base = ranks[0]["fit_world1"]
    for nd in (2, 4):
        got = [r[f"fit_world{nd}"] for r in ranks if f"fit_world{nd}" in r]
        assert len(got) == nd
        for fit in got:
            fit_close(fit, base, rtol=1e-8)
    fit_close(ranks[0]["fit_random"], base, rtol=1e-8)
    assert "fit_world1" not in ranks[1]


def test_padding_invariance(reference, ranks):
    """n = 250 over 4 blocks (two far pads): the factorization is the
    unpadded single-device one."""
    pts, z, X = reference["padded_problem"]
    single = single_device_fit(pts, z, X, 0.1, reference["padded_draws"])
    fit, alphas, U, G = ranks[0]["padded"]
    close(alphas, single.alphas, 1e-8)
    close(U, single.U, 1e-8)
    close(G, single.G, 1e-8)
    fit_close(fit, single.fit())


@pytest.fixture(scope="module")
def unsharded():
    return run_samplers(None)


@pytest.mark.parametrize("which", ["hmc_gauss", "nuts_gauss",
                                   "hmc_kernel_posterior"])
def test_sampler_mesh_equals_none_bit_for_bit(ranks, unsharded, which):
    got = [r["samplers"][which] for r in ranks if "samplers" in r]
    assert len(got) == 2
    want = unsharded[which]
    for res in got:
        assert res.keys() == want.keys()
        for field, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(res[field], value, field)
            else:
                assert res[field] == value, field


def test_driver_shards_its_chains(ranks):
    """sample_posterior.main under four ranks: a mesh of probe extent 4,
    two chains a rank, every rank the same whole result. Against the
    single process within rtol 1e-5, not bit for bit: the dense target
    runs its vmapped float64 products at a batch of 2 chains there and 8
    here, MKL's batched products sum in an order that follows the batch
    (3e-12 apart), and 6 HMC steps of 16 leapfrog steps grow that to
    1.6e-7. The samplers' contract is bit for bit where a chain's
    evaluation does not depend on the batch
    (test_sampler_mesh_equals_none_bit_for_bit)."""
    want = tsp.main(num_points=5, num_chains=8, num_samples=3, num_warmup=3,
                    verbose=False, device="cpu")["samples"]
    for r in ranks:
        np.testing.assert_array_equal(r["driver"], ranks[0]["driver"])
    np.testing.assert_allclose(ranks[0]["driver"], want, rtol=1e-5)


def test_scaling_twin(tmp_path, monkeypatch):
    """main at 1 and 2 ranks, n = 256: graded 'correctness' on the CPU, the
    two meshes' step outputs equal, no file written."""
    monkeypatch.chdir(tmp_path)
    out = scaling_efficiency.main(n=256, device_counts=(1, 2),
                                  verbose=False, device="cpu")
    assert out["grade"] == "correctness" and out["backend"] == "gloo"
    for key in ("der1", "traceinv", "logdet"):
        np.testing.assert_allclose(out[2][key], out[1][key], rtol=1e-9)
    assert out[1]["efficiency"] == 1.0 and out[2]["seconds"] > 0
    assert not list(tmp_path.iterdir())
