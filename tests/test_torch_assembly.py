"""gppe_tpu_torch.ops.assembly vs gppe_tpu.ops.assembly, on the CPU in
float64 (the JAX package under x64, tests/conftest.py).

n = 300 random points in the unit square from a seeded RandomState; both
assemblies see the same numpy points. Tolerance: rtol 1e-12 and atol
1e-14 (the same float64 formula, summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gppe_tpu  # noqa: E402
from gppe_tpu.ops import assembly as jasm  # noqa: E402
from gppe_tpu_torch.ops import assembly as tasm  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts six test workers on the host's cores: torch's
    own pool of one thread per core in each worker made these small
    problems ~15x slower there. One thread for this module, restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def points():
    return np.random.RandomState(0).rand(300, 2)


@pytest.mark.parametrize("scale", [0.1, np.array([0.08, 0.2])],
                         ids=["isotropic", "anisotropic"])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_generate_correlation_matches(points, nu, scale):
    want = np.asarray(gppe_tpu.generate_correlation(points, scale, nu=nu))
    got = tasm.generate_correlation(points, scale, nu=nu, **CPU)
    assert got.dtype == F64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(torch.diagonal(got).numpy(), 1.0)


@pytest.mark.parametrize("block_size", [64, 128, 299])
def test_blocked_equals_unblocked(points, block_size):
    """The row blocks hold the same numbers as one block, and as the
    reference's blocked form."""
    full = tasm.dense_correlation(points, 0.1, 1.5, **CPU)
    got = tasm.dense_correlation_blocked(points, 0.1, 1.5,
                                         block_size=block_size, **CPU)
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    want = np.asarray(jasm.dense_correlation_blocked(points, 0.1, 1.5,
                                                     block_size=block_size))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_float32_assembly_is_the_default_dtype(points):
    got = tasm.generate_correlation(points, 0.1, nu=0.5, device="cpu")
    assert got.dtype == torch.float32
    want = tasm.generate_correlation(points, 0.1, nu=0.5, **CPU)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("args", [
    dict(points=np.linspace(0, 1, 10), correlation_scale=0.1),
    dict(correlation_scale=-0.1),
    dict(correlation_scale=np.array([0.1, 0.0])),
    dict(correlation_scale=0.1, nu=0.0),
    dict(correlation_scale=0.1, nu="half"),
], ids=["1d-points", "negative-scale", "zero-scale", "zero-nu", "text-nu"])
def test_same_value_errors(points, args):
    args = {"points": points, **args}
    with pytest.raises(ValueError):
        gppe_tpu.generate_correlation(**args)
    with pytest.raises(ValueError):
        tasm.generate_correlation(**args, **CPU)


@pytest.mark.parametrize("args, item", [
    (dict(sparse=True), "A9"), (dict(plot=True), "A15"),
    (dict(nu=0.7, sparse=True), "A9")], ids=["sparse", "plot", "general-nu"])
def test_unported_inputs_name_their_roadmap_item(points, args, item):
    with pytest.raises(NotImplementedError, match=item):
        tasm.generate_correlation(points, 0.1, **{"nu": 0.5, **args}, **CPU)
