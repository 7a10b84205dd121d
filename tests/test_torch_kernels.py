"""gppe_tpu_torch kernels layer vs the JAX reference, on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
port runs on ``device="cpu"`` in float64 (its kernel wrappers take their
plain PyTorch versions there), JAX runs on the CPU under x64
(tests/conftest.py). The CUDA kernel itself is checked against the plain
version on the card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gppe_tpu.ops import kernels as jk  # noqa: E402
from gppe_tpu.ops import operators as jops  # noqa: E402
from gppe_tpu.ops import pallas_kernels as jpk  # noqa: E402
from gppe_tpu.utils import data as jdata  # noqa: E402
from gppe_tpu_torch.ops import _build, cuda_kernels  # noqa: E402
from gppe_tpu_torch.ops import kernels as tk  # noqa: E402
from gppe_tpu_torch.ops import operators as tops  # noqa: E402
from gppe_tpu_torch.ops import taper as ttaper  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
NUS = [0.5, 1.5, 2.5, 150.0]


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("case", ["grid", "random", "data", "basis",
                                  "basis_trig"])
def test_data_generators_bit_for_bit(case):
    pts = jdata.generate_points(50, dimension=2, grid=False, seed=3)
    if case == "grid":
        want = jdata.generate_points(9, dimension=3)
        got = tdata.generate_points(9, dimension=3)
    elif case == "random":
        want = jdata.generate_points(100, dimension=2, grid=False, seed=5)
        got = tdata.generate_points(100, dimension=2, grid=False, seed=5)
    elif case == "data":
        want = jdata.generate_data(pts, 0.2)
        got = tdata.generate_data(pts, 0.2)
    elif case == "basis":
        want = jdata.generate_basis_functions(pts, 2)
        got = tdata.generate_basis_functions(pts, 2)
    else:
        want = jdata.generate_basis_functions(pts, 3, trigonometric=True)
        got = tdata.generate_basis_functions(pts, 3, trigonometric=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nu", NUS)
def test_matern_branches(nu):
    rng = np.random.RandomState(11)
    x = np.concatenate([np.zeros(5), rng.rand(200) * 6.0])
    want = np.asarray(jk.matern(jnp.asarray(x), nu))
    got = tk.matern(_t(x), nu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.all(got[:5] == 1.0)


@pytest.mark.parametrize("d", [1, 2, 3, 10])
def test_pairwise_scaled_distance(d):
    """d <= 8 takes the difference form, d = 10 the Gram form; row and
    column sets differ so no distance is near zero, plus one shared point
    for the exact-zero branch in the difference form."""
    rng = np.random.RandomState(d)
    a = rng.rand(40, d)
    b = rng.rand(30, d)
    if d <= 8:
        b[0] = a[0]
    scale = 0.05 + rng.rand(d)
    want = np.asarray(jk.pairwise_scaled_distance(a, b, scale))
    got = tk.pairwise_scaled_distance(_t(a), _t(b), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("d", [1, 3])
def test_scaled_distance(d):
    rng = np.random.RandomState(20 + d)
    p1, p2 = rng.rand(50, d), rng.rand(50, d)
    scale = 0.05 + rng.rand(d)
    want = np.asarray(jk.scaled_distance(p1, p2, scale))
    got = tk.scaled_distance(_t(p1), _t(p2), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("scale,d", [(0.1, 2), (2, 3),
                                     (np.array([0.1, 0.3]), 2),
                                     (np.float32(0.25), 1)])
def test_broadcast_scale(scale, d):
    want = np.asarray(jk.broadcast_scale(scale, d))
    got = tk.broadcast_scale(scale, d).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _problem(n=300, d=2, r=5, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, d)
    cols = rng.rand(n // 2 + 7, d)
    V = rng.standard_normal((n, r))
    Vc = rng.standard_normal((cols.shape[0], r))
    scale = np.array([0.1, 0.17])[:d]
    return pts, cols, V, Vc, scale


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("nu", [0.5, 2.5])
def test_plain_matmat_vs_blocked(r, nu):
    """Square K (ragged n = 300 over 128-row blocks, anisotropic scale)
    against the reference's row-blocked XLA form, in float64."""
    pts, _, V, _, scale = _problem(r=r)
    want = np.asarray(jops._matern_matmat_blocked(
        jnp.asarray(pts), jnp.asarray(scale), jnp.asarray(V), nu, 128))
    got = cuda_kernels.matern_matmat(_t(pts), _t(scale), _t(V), nu,
                                     block_rows=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("r", [1, 5])
def test_plain_matmat_rectangular(r):
    """The rectangular ``points_cols`` form against the reference's dense
    kernels.matern(pairwise_scaled_distance) @ V, in float64."""
    pts, cols, _, Vc, scale = _problem(r=r)
    K = jk.matern(jk.pairwise_scaled_distance(pts, cols, scale), 1.5)
    want = np.asarray(K @ jnp.asarray(Vc))
    got = cuda_kernels.matern_matmat(_t(pts), scale, _t(Vc), 1.5,
                                     points_cols=_t(cols),
                                     block_rows=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("rect", [False, True])
def test_plain_f32_vs_pallas_interpret(rect):
    """The plain version in float32 against the Pallas kernel run in
    interpret mode (as tests/test_kernels.py runs it on the CPU)."""
    pts, cols, V, Vc, scale = _problem(n=300, r=5, seed=4)
    pts, cols = pts.astype(np.float32), cols.astype(np.float32)
    Vr = (Vc if rect else V).astype(np.float32)
    want = np.asarray(jpk.matern_matmat(
        pts, scale, Vr, 0.5, tile_m=128, tile_n=128,
        points_cols=cols if rect else None, interpret=True), np.float64)
    got = cuda_kernels.matern_matmat(
        _t(pts, torch.float32), scale, _t(Vr, torch.float32), 0.5,
        points_cols=_t(cols, torch.float32) if rect else None).numpy()
    frob = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert frob < 2e-5, frob


@pytest.mark.parametrize("nu", NUS)
def test_operator_matmat_and_trace(nu):
    """MaternOperator on the CPU vs the reference operator: matmat,
    matvec, trace_pow(0, 1, 2) and dense, float64."""
    pts, _, V, _, scale = _problem(n=300, r=3, seed=2)
    jop = jops.MaternOperator(pts, scale, nu=nu, block_rows=128)
    top = tops.MaternOperator(pts, scale, nu=nu, block_rows=128,
                              device="cpu", dtype=F64)
    assert top.shape == jop.shape
    np.testing.assert_allclose(top.matmat(V).numpy(),
                               np.asarray(jop.matmat(V)), rtol=1e-10)
    np.testing.assert_allclose(top.matvec(V[:, 0]).numpy(),
                               np.asarray(jop.matvec(V[:, 0])), rtol=1e-10)
    for p in (0, 1):
        assert float(top.trace_pow(p)) == float(jop.trace_pow(p))
    np.testing.assert_allclose(float(top.trace_pow(2)),
                               float(jop.trace_pow(2)), rtol=1e-10)
    np.testing.assert_allclose(top.dense().numpy(), np.asarray(jop.dense()),
                               rtol=1e-12, atol=1e-300)


def test_plain_frobenius_only():
    """V=None with frobenius=True is the trace(K^2) pass, and agrees with
    the reference's _matern_frobenius2_blocked on ragged blocks."""
    pts, _, _, _, scale = _problem(n=300, seed=6)
    want = float(jops._matern_frobenius2_blocked(
        jnp.asarray(pts), jnp.asarray(scale), 0.5, 128))
    out, fro = cuda_kernels.matern_matmat(_t(pts), scale, None, 0.5,
                                          frobenius=True, block_rows=128)
    assert out is None
    np.testing.assert_allclose(float(fro), want, rtol=1e-10)


def test_cpu_path_launches_no_kernel():
    cuda_kernels.reset_launch_counts()
    pts, _, V, _, scale = _problem(n=64)
    op = tops.MaternOperator(pts, scale, device="cpu", dtype=F64)
    op.matmat(V)
    op.trace_pow(2)
    tops.MaternOperator(pts, scale, device="cpu", dtype=F64,
                        dot_mode="bf16x3").matmat(V)
    cuda_kernels.matern_matmat(_t(pts), scale, _t(V), 0.5, dot_mode="bf16",
                               dist_mode="gram")
    cuda_kernels.matern_matmat_multirho(_t(pts), [0.1, 0.2],
                                        _t(np.stack([V, V])), 0.5)
    top = ttaper.TaperedMaternOperator(pts, 0.1, density=0.1, tile=16,
                                       device="cpu", dtype=F64)
    top.matmat(V)
    top.trace_pow(2)
    gop = tops.MaternOperator(pts, scale, nu=1.3, device="cpu", dtype=F64)
    gop.matmat(V)
    gop.trace_pow(2)
    cuda_kernels.matern_general(_t(np.linspace(0.0, 3.0, 7)), 3.7)
    gtop = ttaper.TaperedMaternOperator(pts, 0.1, nu=1.3, density=0.1,
                                        tile=16, device="cpu", dtype=F64)
    gtop.matmat(V)
    gtop.trace_pow(2)
    assert cuda_kernels.launch_counts == {
        "matern_matmat": 0, "matern_matmat_mma": 0,
        "matern_matmat_multirho": 0, "matern_matmat_multirho_mma": 0,
        "matern_matmat_blocksparse": 0, "matern_matmat_blocksparse_mma": 0,
        "matern_general_elementwise": 0, "matern_general_product": 0,
        "matern_general_trace": 0, "matern_blocksparse_general_product": 0,
        "matern_blocksparse_general_trace": 0}


@pytest.mark.parametrize("kind", ["general_nu", "bf16", "bf16x3", "gram",
                                  "meta_device", "v_none"])
def test_unported_or_invalid_requests_raise(kind):
    pts, _, V, _, scale = _problem(n=32)
    P, Vt = _t(pts), _t(V)
    if kind == "general_nu":
        # ported for the dense and the tapered kernels (their plain
        # versions here); a general nu has no Gram form, and a
        # non-positive one is refused
        got = cuda_kernels.matern_matmat(P, scale, Vt, 0.7)
        want = cuda_kernels.matern_matmat_plain(
            P, tk.broadcast_scale(scale, 2, dtype=F64), Vt, 0.7)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="difference form"):
            cuda_kernels.matern_matmat(P, scale, Vt, 0.7, dist_mode="gram")
        got = cuda_kernels.matern_matmat_blocksparse(
            P, Vt, 3.0, 0.1, [0], [0], 32)
        assert torch.equal(got, cuda_kernels.matern_matmat_blocksparse_plain(
            P, Vt, 3.0, 0.1, [0], [0], 32))
        assert ttaper.TaperedMaternOperator(
            pts, scale, nu=3.0, density=0.1, tile=16, device="cpu").nu == 3.0
        with pytest.raises(ValueError, match="positive"):
            cuda_kernels.matern_matmat_blocksparse(
                P, Vt, -3.0, 0.1, [0], [0], 32)
    elif kind in ("bf16", "bf16x3"):
        # ported: the mode runs, through the wrapper and the operator, and
        # rounds (it differs from the exact product, by less than bf16's
        # 2^-8); a name that is no mode raises with the reference's wording
        want = cuda_kernels.matern_matmat(P, scale, Vt, 0.5)
        got = cuda_kernels.matern_matmat(P, scale, Vt, 0.5, dot_mode=kind)
        op = tops.MaternOperator(pts, scale, device="cpu", dtype=F64,
                                 dot_mode=kind)
        assert torch.equal(op.matmat(Vt), got)
        err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        assert 0 < err < 2 ** -8
        with pytest.raises(ValueError, match="dot_mode must be one of"):
            cuda_kernels.matern_matmat(P, scale, Vt, 0.5, dot_mode=kind + "x")
        with pytest.raises(ValueError, match="dot_mode must be one of"):
            tops.MaternOperator(pts, scale, device="cpu", dot_mode="fp8")
    elif kind == "gram":
        # ported: the Gram form runs and agrees with the difference form to
        # float64 cancellation; an unknown form raises
        want = cuda_kernels.matern_matmat(P, scale, Vt, 0.5)
        got = cuda_kernels.matern_matmat(P, scale, Vt, 0.5, dist_mode="gram")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        with pytest.raises(ValueError, match="dist_mode must be 'diff' or"):
            cuda_kernels.matern_matmat(P, scale, Vt, 0.5, dist_mode="dot")
    elif kind == "meta_device":
        # neither cpu nor cuda: no plain-version fallback, a clean error
        with pytest.raises(ValueError, match="cpu or cuda"):
            cuda_kernels.matern_matmat(P.to("meta"), scale, Vt.to("meta"),
                                       0.5)
    else:
        with pytest.raises(ValueError, match="frobenius"):
            cuda_kernels.matern_matmat(P, scale, None, 0.5)


def test_build_command_flags():
    compiles, link = _build.nvcc_commands("nvcc", "/tmp/x.so")
    # one compile per source, each for sm_90a and without fast math
    assert len(compiles) == len(_build.SOURCES) == 8
    objects = []
    for cmd in compiles:
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined and "-c" in cmd
        assert "use_fast_math" not in joined
        sources = [p for p in cmd if p.endswith(".cu")]
        assert len(sources) == 1 and os.path.isfile(sources[0])
        objects.append(cmd[cmd.index("-o") + 1])
    assert link[:4] == ["nvcc", "-shared", "-o", "/tmp/x.so"]
    assert link[4:] == objects and len(set(objects)) == 8
    flagged = _build.nvcc_commands("nvcc", "/tmp/x.so", ("-Xptxas", "-v"))
    assert all("-Xptxas" in cmd for cmd in flagged[0])
    # the library name is keyed by sources, headers and flags
    assert _build.library_path().name.startswith("libgppe_tpu_torch_")
    for name in _build.SOURCES + _build.HEADERS:
        src = open(os.path.join(REPO, "gppe_tpu_torch", "csrc", name)).read()
        assert "use_fast_math" not in src.replace(
            "WITHOUT --use_fast_math", "").replace("no --use_fast_math", "")


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gppe_tpu'] = None; "
            "import gppe_tpu_torch, gppe_tpu_torch.ops.cuda_kernels, "
            "gppe_tpu_torch.ops.operators, gppe_tpu_torch.ops.stochastic, "
            "gppe_tpu_torch.ops.taper, gppe_tpu_torch.models.grid_krylov, "
            "gppe_tpu_torch.models.large_scale; print('ok')")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_import_leaves_torch_settings_alone():
    code = ("import torch; before = (torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32, "
            "torch.get_float32_matmul_precision()); "
            "import gppe_tpu_torch.models.large_scale, "
            "gppe_tpu_torch.ops.operators; "
            "after = (torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32, "
            "torch.get_float32_matmul_precision()); "
            "print(before == after)")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"


def test_setup_pins_ieee_float32():
    from gppe_tpu_torch.utils import config
    config.setup()
    assert config.precision_state() == {
        "cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
        "float32_matmul_precision": "highest"}
