"""The sample_posterior driver twin (gppe_tpu_torch.drivers
.sample_posterior) at a tiny size on the CPU: ``main`` (HMC and NUTS),
``main_nu``, ``main_profile_rho_nu`` and ``main_rho_nu_large`` run end to
end and return the reference driver's result keys
(``drivers/sample_posterior.py``) and write files only when given a path;
``golden_marginals``, ``_marginal_validation`` and the MAP refinement
against the reference driver's on the same inputs.
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


def test_unknown_sampler_refused():
    with pytest.raises(ValueError, match="sampler"):
        twin.main(sampler="mala", device="cpu")


def test_main_nuts(tmp_path, monkeypatch):
    """main(sampler="nuts") at n = 36, 2 chains, 4 + 4 steps: the
    reference's keys with NUTS's divergences and mean tree depth (:71-73),
    finite samples inside the prior box; the results and the chains' state
    only when given a path."""
    monkeypatch.chdir(tmp_path)
    kw = dict(num_points=6, num_chains=2, num_samples=4, num_warmup=4,
              sampler="nuts", verbose=False, device="cpu")
    out = twin.main(**kw)
    assert set(out) == MAIN_KEYS | {"divergences", "mean_tree_depth"}
    assert list(tmp_path.iterdir()) == []
    s = out["samples"]
    assert s.shape == (4, 2, 2) and np.isfinite(s).all()
    assert np.all((s[..., 0] > -3) & (s[..., 0] < 4))
    assert np.all((s[..., 1] > np.log10(0.02)) & (s[..., 1] < np.log10(0.6)))
    assert out["divergences"].shape == out["mean_tree_depth"].shape == (2,)
    assert np.all(out["mean_tree_depth"] >= 1)
    path = str(tmp_path / "nuts.pickle")
    again = twin.main(results_path=path, **kw)
    np.testing.assert_array_equal(again["samples"], s)
    assert checkpoint.load_hmc_state(path + ".state")["theta"].shape == (2, 2)


# the result keys of the reference's main_nu (:160-174) and
# main_profile_rho_nu (:317-338)
NU_KEYS = {"joint_samples", "joint_accept", "joint_mean", "joint_std",
           "profile_samples", "profile_accept", "profile_rho_median",
           "profile_nu_median", "map_refined", "golden_map", "wall_seconds",
           "config"}
PROFILE_KEYS = {"samples", "accept_rate", "diagnostics",
                "marginal_validation", "rho_median", "nu_median",
                "map_refined", "golden_map", "wall_seconds", "config"}


def inside(a, lo, hi):
    return bool(np.isfinite(a).all() and np.all(a > lo) and np.all(a < hi))


def test_main_nu(tmp_path, monkeypatch):
    """main_nu at n = 36, 2 chains, 2 + 2 joint steps (1 + 1 profiled),
    1 leapfrog step (4 profiled): the reference's keys, the joint samples
    in (log10 eta, log10 rho, nu) in their box, the profiled ones in theirs,
    a refined MAP on the refinement's grids; a file only with a path."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "nu.pickle")
    out = twin.main_nu(num_points=6, num_chains=2, num_samples=2,
                       num_warmup=2, num_leapfrog=1, chunk_steps=None,
                       results_path=path, verbose=False, device="cpu")
    assert set(out) == NU_KEYS
    j = out["joint_samples"]
    assert j.shape == (2, 2, 3)
    for k, (lo, hi) in enumerate(((-3.0, 4.0), (-1.3, -0.3), (1.0, 25.0))):
        assert inside(j[..., k], lo, hi)
    p = out["profile_samples"]
    assert p.shape == (1, 2, 2)
    assert inside(p[..., 0], -1.3, -0.3) and inside(p[..., 1], 1.0, 25.0)
    m = out["map_refined"]
    assert m["rho"] >= 0.1 and 1.0 <= m["nu"] <= 25.0
    assert np.isfinite(m["log_post"])
    assert out["config"] == {"n": 36, "noise": 0.2}
    assert [f.name for f in tmp_path.iterdir()] == ["nu.pickle"]


def synthetic_golden(path, seed=0):
    """A golden with-prior pickle of the reference's layout: a 61 x 60
    (rho, nu) log-posterior grid over [0.1, 0.3] x [1, 25], peaked near
    (0.18, 3) and flat along nu."""
    import pickle
    rho = np.linspace(0.1, 0.3, 61)
    nu = np.linspace(1.0, 25.0, 60)
    rng = np.random.RandomState(seed)
    lp = (-((rho[:, None] - 0.18) / 0.03) ** 2 - 0.02 * (nu[None] - 3.0)
          + 0.1 * rng.standard_normal((61, 60)))
    with open(path, "wb") as f:
        pickle.dump({"DecorrelationScale": rho, "nu": nu, "Lp": lp}, f)


def test_main_profile_rho_nu(tmp_path, monkeypatch):
    """main_profile_rho_nu at n = 36, 2 chains. Without a golden path (2 +
    2 steps of 2 leapfrog steps): the committed pickle's box (rho in [0.1,
    0.3], nu in [1, 25]), no validation, no file. With a synthetic golden
    pickle (1 + 1 steps of 1): its grid's box and the quantile and TV
    validation, the results at the given path."""
    monkeypatch.chdir(tmp_path)
    kw = dict(num_points=6, num_chains=2, chunk_steps=None, verbose=False,
              device="cpu")
    out = twin.main_profile_rho_nu(num_samples=2, num_warmup=2,
                                   num_leapfrog=2, **kw)
    assert set(out) == PROFILE_KEYS
    assert list(tmp_path.iterdir()) == []
    assert out["marginal_validation"] is None
    assert out["config"]["rho_box"] == (0.1, 0.3)
    assert out["config"]["nu_box"] == (1.0, 25.0)
    s = out["samples"]
    assert s.shape == (2, 2, 2)
    assert inside(s[..., 0], -1.0, np.log10(0.3))
    assert inside(s[..., 1], 1.0, 25.0)
    assert 0.1 <= out["map_refined"]["rho"] <= 0.3 + 0.02
    gold = str(tmp_path / "golden.pickle")
    synthetic_golden(gold)
    path = str(tmp_path / "out" / "profile.pickle")
    out = twin.main_profile_rho_nu(num_samples=1, num_warmup=1,
                                   num_leapfrog=1, golden_path=gold,
                                   results_path=path, **kw)
    assert out["config"]["nu_box"] == (1.0, 25.0)
    v = out["marginal_validation"]
    assert set(v) == {"quantiles", "tv_rho", "tv_nu"}
    assert 0.0 <= v["tv_rho"] <= 1.0 and 0.0 <= v["tv_nu"] <= 1.0
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == PROFILE_KEYS


def test_golden_marginals_match_reference(tmp_path):
    """golden_marginals and _marginal_validation against the reference
    driver's (drivers.sample_posterior, numpy) on a synthetic golden pickle
    and random samples: grids, pmfs, quantiles, quantile gaps and TV
    distances at rtol 1e-12."""
    from drivers import sample_posterior as jdrv
    gold = str(tmp_path / "golden.pickle")
    synthetic_golden(gold, seed=3)
    want, got = jdrv.golden_marginals(gold), twin.golden_marginals(gold)
    for k in ("rho_grid", "nu_grid", "p_rho", "p_nu"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    qs = (0.1, 0.5, 0.9)
    np.testing.assert_allclose(
        got["quantile"](got["nu_grid"], got["p_nu"], qs),
        want["quantile"](want["nu_grid"], want["p_nu"], qs), rtol=1e-12)
    rng = np.random.RandomState(4)
    rho_s, nu_s = rng.uniform(0.1, 0.3, 500), rng.uniform(1.0, 25.0, 500)
    v_want = jdrv._marginal_validation(rho_s, nu_s, want)
    v_got = twin._marginal_validation(rho_s, nu_s, got)
    for name in ("rho", "nu"):
        for k in ("golden", "sampled", "max_abs_diff"):
            np.testing.assert_allclose(v_got["quantiles"][name][k],
                                       v_want["quantiles"][name][k],
                                       rtol=1e-12)
        np.testing.assert_allclose(v_got[f"tv_{name}"], v_want[f"tv_{name}"],
                                   rtol=1e-12)


def test_map_refinement_matches_reference():
    """The refinement, seeded at the same rho median, at n = 36: the
    reference's two grids (:300-315) on gppe_tpu's build_objective, one
    point a call (jitted), against the port's _map_refinement on its own
    build_objective, one batched call a grid: the same refined (rho, nu),
    log_post at rtol 1e-8, in main_profile_rho_nu's box ([0.1, 0.3],
    the coarse grid clipped at 0.3)."""
    import jax
    import jax.numpy as jnp

    from drivers import find_optimal_covariance as jfoc
    from gppe_tpu_torch.drivers import find_optimal_covariance as tfoc
    from gppe_tpu_torch.utils import data as tdata
    pts = tdata.generate_points(6, dimension=2)
    z = tdata.generate_data(pts, 0.2)
    X = tdata.generate_basis_functions(pts, 2)
    _, jobj = jfoc.build_objective(pts, z, X, with_prior=True,
                                   spectral_on_host=False)
    jobj = jax.jit(jobj)
    _, tobj = tfoc.build_objective(pts, z, X, with_prior=True, device="cpu")

    def reference(r_seed, rho_lo, rho_hi):
        rhos = np.linspace(max(r_seed - 0.08, rho_lo),
                           min(r_seed + 0.08, rho_hi), 11)
        nus = np.linspace(1.0, 25.0, 13)
        vals = np.array([[-float(jobj(jnp.asarray([r, n]))) for n in nus]
                         for r in rhos])
        i, j = np.unravel_index(np.argmax(vals), vals.shape)
        rhos2 = np.linspace(max(rhos[i] - 0.02, rho_lo), rhos[i] + 0.02, 9)
        nus2 = np.linspace(max(nus[j] - 2.0, 1.0), min(nus[j] + 2.0, 25.0),
                           9)
        vals2 = np.array([[-float(jobj(jnp.asarray([r, n]))) for n in nus2]
                          for r in rhos2])
        i2, j2 = np.unravel_index(np.argmax(vals2), vals2.shape)
        return float(rhos2[i2]), float(nus2[j2]), float(vals2[i2, j2])

    want = reference(0.25, 0.1, 0.3)
    got = twin._map_refinement(tobj, 0.25, 0.1, 0.3)
    assert got[:2] == want[:2]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-8)
