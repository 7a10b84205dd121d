"""gppe_tpu_torch.ops.special (the Bessel K_nu) vs gppe_tpu.ops.special and
scipy, on the CPU.

The nu and x sets are tests/test_special.py's. Against the JAX package
under x64 (tests/conftest.py): rtol 1e-11, the same algorithm summed in
the same order (measured: 1.1e-13). Against scipy.special.kv: the
reference's own 5e-10. The nu-derivative, by autograd and by
``torch.func.jvp`` (forward mode, which the posterior over nu needs), at
the half-integer orders where an s-only convergence freeze once cut the
derivative chain: within 1e-5 of scipy's central differences, the
reference's bound.
"""

import numpy as np
import pytest
import scipy.special

torch = pytest.importorskip("torch")

from gppe_tpu.ops import special as jspecial  # noqa: E402
from gppe_tpu_torch.ops import special  # noqa: E402
from gppe_tpu_torch.utils.config import warm_cpu_threads  # noqa: E402

warm_cpu_threads()

F64 = torch.float64
NUS = [0.0, 0.1, 0.25, 0.5, 0.9, 1.0, 1.3, 2.5, 3.2, 7.8, 25.0, 60.5, 99.0]
X = np.logspace(-5, 2.5, 200)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the tier-1 run puts six test
    workers on the host's cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fn", ["kv", "log_kv", "kve"])
@pytest.mark.parametrize("nu", NUS)
def test_matches_reference(nu, fn):
    want = np.asarray(getattr(jspecial, fn)(nu, X))
    got = getattr(special, fn)(nu, torch.as_tensor(X)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-11)


@pytest.mark.parametrize("nu", NUS)
def test_kv_matches_scipy(nu):
    got = special.kv(nu, torch.as_tensor(X)).numpy()
    want = scipy.special.kv(nu, X)
    mask = np.isfinite(want) & (want > 1e-280) & (want < 1e280)
    assert mask.sum() > 40
    np.testing.assert_allclose(got[mask], want[mask], rtol=5e-10)
    kve = special.kve(nu, torch.as_tensor(X)).numpy()
    want_e = scipy.special.kve(nu, X)
    mask = np.isfinite(want_e) & (want_e > 1e-280) & (want_e < 1e280)
    np.testing.assert_allclose(kve[mask], want_e[mask], rtol=5e-10)


def test_tensor_nu_and_edges():
    """A tensor nu broadcasts against x (the reference's traced nu); a
    Python nu and a 0-d tensor nu give the same values; x <= 0 is inf;
    gamma matches scipy."""
    nus = np.array([0.3, 1.7, 4.2])
    x = np.array([0.5, 1.0, 10.0])
    got = special.kv(torch.as_tensor(nus), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, scipy.special.kv(nus, x), rtol=1e-9)
    np.testing.assert_allclose(
        got, np.asarray(jspecial.kv(nus, x)), rtol=1e-11)
    xs = torch.as_tensor(X)
    np.testing.assert_allclose(
        special.log_kv(torch.tensor(7.8, dtype=F64), xs).numpy(),
        special.log_kv(7.8, xs).numpy(), rtol=1e-13)
    assert torch.isinf(special.kv(0.5, torch.tensor(0.0, dtype=F64)))
    assert torch.isinf(special.log_kv(2.2, torch.tensor(-1.0, dtype=F64)))
    g = np.array([0.5, 1.0, 2.5, 7.3])
    np.testing.assert_allclose(special.gamma(torch.as_tensor(g)).numpy(),
                               scipy.special.gamma(g), rtol=1e-12)


@pytest.mark.parametrize("mode", ["autograd", "jvp"])
@pytest.mark.parametrize("nu", [0.5, 1.5, 3.5, 7.5])
def test_kv_nu_gradient_matches_fd(nu, mode):
    """d K_nu(z) / d nu at z in [2, 6] against central differences of
    scipy, rel 1e-5 (tests/test_special.py:43-58)."""
    for z in (2.1, 3.0, 5.0):
        zt = torch.tensor(z, dtype=F64)
        nut = torch.tensor(nu, dtype=F64)
        if mode == "autograd":
            nut.requires_grad_(True)
            got = torch.autograd.grad(special.kv(nut, zt), nut)[0].item()
        else:
            _, tangent = torch.func.jvp(lambda n: special.kv(n, zt), (nut,),
                                        (torch.ones_like(nut),))
            got = tangent.item()
        h = 1e-6 * max(nu, 1.0)
        fd = (scipy.special.kv(nu + h, z) - scipy.special.kv(nu - h, z)) / (
            2 * h)
        assert got == pytest.approx(fd, rel=1e-5), (nu, z, got, fd)


def test_gradient_in_x_matches_fd():
    """d K_nu(x) / dx by jvp, across both branches and the recurrence,
    against central differences of scipy."""
    x = torch.tensor([0.05, 0.7, 1.9, 2.1, 8.0], dtype=F64)
    for nu in (0.3, 3.7):
        _, tangent = torch.func.jvp(lambda t: special.kv(nu, t), (x,),
                                    (torch.ones_like(x),))
        xn = x.numpy()
        h = 1e-6 * xn
        fd = (scipy.special.kv(nu, xn + h) - scipy.special.kv(nu, xn - h)) / (
            2 * h)
        np.testing.assert_allclose(tangent.numpy(), fd, rtol=1e-6)


@pytest.mark.parametrize("nu, z", [(25.0, 0.01), (25.0, 0.5), (10.0, 1e-3),
                                   (3.5, 120.0)])
def test_log_kv_extreme_range_f32(nu, z):
    """float32 log_kv stays finite where K_nu itself overflows or
    underflows float32, within the reference's rel 2e-5
    (tests/test_special.py:61-74)."""
    got = float(special.log_kv(torch.tensor(nu, dtype=torch.float32),
                               torch.tensor(z, dtype=torch.float32)))
    k = scipy.special.kv(nu, z)
    want = (float(np.log(k)) if np.isfinite(k) and k > 0 else float(
        scipy.special.gammaln(nu) - np.log(2.0) + nu * np.log(2.0 / z)))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=2e-5)
