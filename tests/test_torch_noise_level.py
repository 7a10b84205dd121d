"""The noise-level sweep twin (drivers.compare_various_noise_level)
against the reference's ``drivers/compare_various_noise_level.sweep``, on
the CPU in float64 (the JAX package under x64, tests/conftest.py).

The reference's own test size (tests/test_drivers.py:26-38): a 10 x 10
grid, 12 noise levels in logspace(-2, 1), each of the four basis
families. Both packages assemble K from the same points and draw the same
seeded noise. Each level's eta, sigma, sigma0 and gcv_sigma0 agree at
rtol 1e-5 (the vectorised Chandrupatla stops at 1e-6 in log10 eta in
both); a lane without a bracket takes the same boundary in both (eta = 0
or inf, sigma or sigma0 = 0), compared exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from drivers import compare_various_noise_level as jdrv  # noqa: E402
from gppe_tpu_torch.drivers import (  # noqa: E402
    compare_various_noise_level as tdrv)
from gppe_tpu_torch.utils import data as data_utils  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

RTOL = 1e-5
KEYS = ("eta", "sigma", "sigma0", "gcv_sigma0")
FAMILIES = [name for name, _ in tdrv.FAMILIES]


@pytest.fixture(scope="module")
def sweeps():
    pts = data_utils.generate_points(10, dimension=2)
    levels = np.logspace(-2, 1, 12)
    out = {}
    for name, kwargs in tdrv.FAMILIES:
        X = data_utils.generate_basis_functions(pts, **kwargs)
        out[name] = (tdrv.sweep(pts, X, levels, device="cpu"),
                     jdrv.sweep(pts, X, levels))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_sweep_matches_reference(sweeps, family):
    got, want = sweeps[family]
    np.testing.assert_array_equal(got["noise_levels"], want["noise_levels"])
    for key in KEYS:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == np.float64 and g.shape == (12,), key
        # the unbracketed lanes' boundaries, exactly
        boundary = ~np.isfinite(w) | (w == 0)
        np.testing.assert_array_equal(g[boundary], w[boundary], err_msg=key)
        np.testing.assert_allclose(g[~boundary], w[~boundary], rtol=RTOL,
                                   err_msg=key)


def test_sweep_boundary_rule(sweeps):
    """eta = inf lanes: sigma 0 and sigma0 the OLS noise; eta = 0 lanes:
    sigma0 0; bracketed lanes: sigma0 = sqrt(eta) sigma."""
    seen = set()
    for got, _ in sweeps.values():
        eta, sigma, sigma0 = got["eta"], got["sigma"], got["sigma0"]
        inf, zero = np.isinf(eta), eta == 0
        assert np.all(sigma[inf] == 0) and np.all(sigma0[inf] > 0)
        assert np.all(sigma0[zero] == 0) and np.all(sigma[zero] > 0)
        mid = ~inf & ~zero
        np.testing.assert_allclose(sigma0[mid],
                                   np.sqrt(eta[mid]) * sigma[mid],
                                   rtol=1e-14)
        seen |= {"inf"} if inf.any() else set()
        seen |= {"zero"} if zero.any() else set()
        seen |= {"root"} if mid.any() else set()
    assert seen == {"inf", "zero", "root"}


def test_main_tracks_the_noise(tmp_path, monkeypatch):
    """The reference's test claim at high noise, and no file unless
    ``results_path`` (then the same dict back with ``use_saved``)."""
    monkeypatch.chdir(tmp_path)
    res = tdrv.main(num_points=10, num_levels=12, verbose=False,
                    device="cpu")
    assert os.listdir(tmp_path) == []
    assert set(res) == set(FAMILIES)
    for fam in ("poly0", "poly2trig"):
        r = res[fam]
        ratio = r["sigma0"][-4:] / r["noise_levels"][-4:]
        assert 0.7 < np.nanmean(ratio) < 1.3
        gratio = r["gcv_sigma0"][-4:] / r["noise_levels"][-4:]
        assert 0.6 < np.nanmean(gratio) < 1.4
    path = str(tmp_path / "noise.pickle")
    saved = tdrv.main(num_points=6, num_levels=3, results_path=path,
                      verbose=False, device="cpu")
    again = tdrv.main(num_points=6, num_levels=3, results_path=path,
                      use_saved=True, verbose=False, device="cpu")
    for fam in FAMILIES:
        for key in KEYS:
            np.testing.assert_array_equal(again[fam][key], saved[fam][key])
