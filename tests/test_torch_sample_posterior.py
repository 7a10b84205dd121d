"""The sample_posterior driver twin (gppe_tpu_torch.drivers
.sample_posterior) at a tiny size on the CPU: ``main`` and
``main_rho_nu_large`` run end to end and return the reference driver's
result keys (``drivers/sample_posterior.py``), write files only when given
a path, and the entry points that are not ported yet name ROADMAP A12b.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu_torch.drivers import sample_posterior as twin  # noqa: E402
from gppe_tpu_torch.utils import checkpoint  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

# the result keys of the reference's main (:60-73) and main_rho_nu_large
# (:454-474)
MAIN_KEYS = {"samples", "accept_rate", "step_size",
             "posterior_mean_log10_eta", "posterior_mean_log10_rho",
             "posterior_std", "samples_per_second", "wall_seconds"}
RHO_NU_KEYS = {"samples", "accept_rate", "diagnostics", "probe_validation",
               "samples_per_second", "wall_seconds", "config"}


def test_main(tmp_path, monkeypatch):
    """main at n = 36 (a 6 x 6 grid), 3 chains: finite samples inside the
    prior box; with a path, the results and the chains' state, which
    resumes; without one, no file."""
    monkeypatch.chdir(tmp_path)
    out = twin.main(num_points=6, num_chains=3, num_samples=4, num_warmup=4,
                    verbose=False, device="cpu")
    assert set(out) == MAIN_KEYS
    assert list(tmp_path.iterdir()) == []
    s = out["samples"]
    assert s.shape == (4, 3, 2) and np.isfinite(s).all()
    assert np.all((s[..., 0] > -3) & (s[..., 0] < 4))
    assert np.all((s[..., 1] > np.log10(0.02)) & (s[..., 1] < np.log10(0.6)))
    path = str(tmp_path / "out" / "posterior.pickle")
    again = twin.main(num_points=6, num_chains=3, num_samples=4,
                      num_warmup=4, verbose=False, results_path=path,
                      device="cpu")
    np.testing.assert_array_equal(again["samples"], s)
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == MAIN_KEYS
    state = checkpoint.load_hmc_state(path + ".state")
    assert state["theta"].shape == (3, 2)
    assert isinstance(state["generator_state"], bytes)


def test_main_rho_nu_large(tmp_path):
    """main_rho_nu_large at side 12 (n = 144; 3 x 3 nodes, k = 8, 8
    probes), 4 chains: the probe cross-validation against fresh FFT
    engines, samples inside the box, the diagnostics of all three
    coordinates, the results file at the given path."""
    path = str(tmp_path / "rho_nu.pickle")
    out = twin.main_rho_nu_large(
        side=12, num_chains=4, num_samples=6, num_warmup=6, num_rho_nodes=3,
        num_nu_nodes=3, lanczos_steps=8, num_probes=8,
        log10_rho_bounds=(-1.2, -0.6), probe_points=((1.5, -0.9, 2.0),),
        results_path=path, verbose=False, device="cpu")
    assert set(out) == RHO_NU_KEYS
    s = out["samples"]
    assert s.shape == (6, 4, 3) and np.isfinite(s).all()
    assert np.all((s[..., 0] > 0.5) & (s[..., 0] < 4.0))
    assert np.all((s[..., 1] > -1.2) & (s[..., 1] < -0.6))
    assert np.all((s[..., 2] > 1.0) & (s[..., 2] < 25.0))
    assert set(out["diagnostics"]) >= {"log10_eta", "log10_rho", "nu"}
    (probe,) = out["probe_validation"]
    assert np.isfinite(probe["diff"])
    assert out["config"]["n"] == 144
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == RHO_NU_KEYS


def test_unported_entry_points_name_their_roadmap_item():
    for call in (lambda: twin.main(sampler="nuts", device="cpu"),
                 twin.main_nu, twin.main_profile_rho_nu):
        with pytest.raises(NotImplementedError, match="A12b"):
            call()
    with pytest.raises(ValueError, match="sampler"):
        twin.main(sampler="mala", device="cpu")
