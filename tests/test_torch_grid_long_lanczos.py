"""The FFT-grid paths at the drivers' own Lanczos depth (k = 48, 16
probes) against the JAX reference, on the CPU.

tests/test_torch_grid_fft.py and tests/test_torch_krylov_posterior.py hold
the port to the reference at k = 8, where the bases agree to rounding. At
k = 48 on a small regular grid the smoothest kernels' Krylov spaces run
out (on the 64 x 64 grid at rho 30 spacings, nu = 8, the constant
column's Lanczos coefficients fall six orders of magnitude) and the two
packages' basis tails part (ROADMAP, watch list), so these tests compare
in nats, with the reference's own envelope for a surface against an
exact answer (tests/test_krylov_posterior.py:39-63: 0.1 nat at eta >= 1,
0.35 below):

- ``main_fft_grid`` on a 64 x 64 grid at its rhos measured in grid
  spacings (3-30), nus (0.5, 2, 8), float64 in both packages on the
  reference's random block: eta rtol 5e-3, lp within 0.1 nat, the same
  MAP;
- the (rho, nu) surface at ``main_rho_nu_large``'s box (3 x 3 nodes), in
  float32 and with float64 nodes in both packages: the port's float32
  surface sits no farther from its float64 nodes than 1.5 times the
  reference's own gap plus 0.02 nat, and the two float64 surfaces agree
  within the envelope.

Run as a script, ``python tests/test_torch_grid_long_lanczos.py SIDE``
prints the float32-vs-float64-node gaps of both packages on a SIDE x SIDE
grid; ``python tests/test_torch_grid_long_lanczos.py SIDE c1`` prints
where the two packages' float64 surfaces part (:func:`c1_attribution`).
"""

import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _tests = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(_tests), _tests]

from drivers import find_optimal_covariance as jdrv  # noqa: E402
from gppe_tpu.models import krylov_posterior as jkp  # noqa: E402
from gppe_tpu_torch.drivers import find_optimal_covariance as tdrv  # noqa
from gppe_tpu_torch.models import krylov_posterior as tkp  # noqa: E402
from gppe_tpu_torch.utils import data as tdata  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)
from test_torch_grid_fft import jax_block, jax_random_block  # noqa: E402,F401

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

STEPS, PROBES = 48, 16
LOG10_ETAS = (0.5, 1.0, 2.0, 3.0)


def nats_envelope(log10_eta):
    """tests/test_krylov_posterior.py:39-63: 0.1 nat at eta >= 1, 0.35
    below."""
    return 0.1 if log10_eta >= 1.0 else 0.35


def grid_problem(side):
    pts = tdata.generate_points(side, dimension=2)
    return (pts, tdata.generate_data(pts, 0.2),
            tdata.generate_basis_functions(pts, 2))


def test_main_fft_grid_at_full_depth_matches_reference(tmp_path,
                                                       jax_random_block):
    """main_fft_grid at its depth (k = 48, 16 probes, the priors on) on a
    64 x 64 grid, its rhos geomspace(0.003, 0.03) in grid spacings of the
    1024 x 1024 grid (3.07-30.7) and nus (0.5, 2, 8), float64 in both
    packages on the reference's block: every row's eta rtol 5e-3, sigma0
    rtol 1e-4, lp within 0.1 nat, the same MAP."""
    side = 64
    rhos = np.geomspace(0.003, 0.03, 3) * 1023 / (side - 1)
    cut = dict(side=side, rhos=rhos, nus=[0.5, 2.0, 8.0],
               lanczos_steps=STEPS, num_probes=PROBES)
    want = jdrv.main_fft_grid(results_path=str(tmp_path / "jax.pickle"),
                              verbose=False, **cut)
    got = tdrv.main_fft_grid(verbose=False, device="cpu", **cut)
    assert len(got["rows"]) == len(want["rows"]) == 9
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["rho"], g["nu"]) == (w["rho"], w["nu"])
        assert np.isfinite(w["eta"]) and np.isfinite(g["eta"])
        np.testing.assert_allclose(g["eta"], w["eta"], rtol=5e-3)
        np.testing.assert_allclose(g["sigma0"], w["sigma0"], rtol=1e-4)
        assert abs(g["lp"] - w["lp"]) < 0.1, (g, w)
    assert (got["optimal_rho"], got["optimal_nu"]) == (want["optimal_rho"],
                                                      want["optimal_nu"])


def float32_node_gaps(side):
    """Both packages' (rho, nu) surfaces on a side x side grid at
    main_rho_nu_large's box (log10 rho (-1.2, -0.3), nu (1, 25)), 3 x 3
    nodes, k = 48, 16 probes: float32 nodes and float64 nodes each, the
    reference's on its own block for key 0, the port's on the reference's
    float64 block. Returns, per log10 eta, the values at the 9 nodes:
    (reference f32 - f64, port f32 - f64, port f64 - reference f64)."""
    pts, z, X = grid_problem(side)
    probes, v_defl = jax_block(len(pts), PROBES)
    cfg = dict(log10_rho_bounds=(-1.2, -0.3), nu_bounds=(1.0, 25.0),
               num_rho_nodes=3, num_nu_nodes=3, lanczos_steps=STEPS,
               num_probes=PROBES)
    surfaces = {
        "ref32": jkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, key=0,
                                                 dtype=jnp.float32, **cfg),
        "ref64": jkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, key=0,
                                                 dtype=jnp.float64, **cfg),
        "port32": tkp.KrylovPosteriorSurfaceRhoNu(
            pts, z, X, device="cpu", dtype=torch.float32, probes=probes,
            v_defl=v_defl, **cfg),
        "port64": tkp.KrylovPosteriorSurfaceRhoNu(
            pts, z, X, device="cpu", node_dtype=torch.float64,
            probes=probes, v_defl=v_defl, **cfg)}
    nodes = surfaces["port64"]
    assert np.allclose(nodes.log10_rho_nodes,
                       surfaces["ref64"].log10_rho_nodes)
    out = {}
    for le in LOG10_ETAS:
        rows = []
        for lr in nodes.log10_rho_nodes:
            for t in nodes.log_nu_nodes:
                v = {name: float(s.profile_loglik(le, lr, math.exp(t)))
                     for name, s in surfaces.items()}
                rows.append((v["ref32"] - v["ref64"],
                             v["port32"] - v["port64"],
                             v["port64"] - v["ref64"]))
        out[le] = np.asarray(rows).T
    return out


def test_float32_node_gap_as_reference():
    """On a 64 x 64 grid the port's float32 (rho, nu) surface lies no
    farther from its float64 nodes than 1.5 times the reference's own
    float32-vs-float64 gap plus 0.02 nat (largest over the 9 nodes, at
    each log10 eta in {0.5, 1, 2, 3}); the float64 surfaces of the two
    packages agree within the envelope."""
    for le, (ref, port, f64) in float32_node_gaps(64).items():
        assert np.all(np.isfinite(ref)) and np.all(np.isfinite(port))
        assert np.abs(port).max() <= 1.5 * np.abs(ref).max() + 0.02, (
            le, ref, port)
        assert np.abs(f64).max() < nats_envelope(le), (le, f64)


def _first_parting_step(a, b, rtol=1e-8):
    """The median over columns of the first Lanczos step at which the
    alphas ``a`` and ``b`` (C, k) part by more than ``rtol``."""
    r = np.abs(a - b) / np.abs(b)
    return int(np.median([np.argmax(c > rtol) if (c > rtol).any()
                          else len(c) for c in r]))


def c1_attribution(side):
    """Where the two packages' float64 (rho, nu) surfaces part (3 x 3
    nodes over main_rho_nu_large's box, k = 48, 16 probes, the reference's
    block in both), printed per node: the offset tables' and trace(K^2)'s
    largest gaps; the Lanczos step at which the alphas part beyond 1e-8
    between the packages and between each package and itself on a block
    perturbed by 1e-15 relative; the node lp gap split into its zMz,
    logdet(K + eta I) and logdet(B) parts; the deflation pairs each keeps;
    and the port against itself with every FFT product perturbed by 1e-16
    relative."""
    from gppe_tpu.ops import operators as jops
    from gppe_tpu_torch.ops import operators as tops
    pts, z, X = grid_problem(side)
    n, m = X.shape
    probes, v_defl = jax_block(n, PROBES)
    cfg = dict(log10_rho_bounds=(-1.2, -0.3), nu_bounds=(1.0, 25.0),
               num_rho_nodes=3, num_nu_nodes=3, lanczos_steps=STEPS,
               num_probes=PROBES)
    port = tkp.KrylovPosteriorSurfaceRhoNu(
        pts, z, X, device="cpu", node_dtype=torch.float64, probes=probes,
        v_defl=v_defl, **cfg)
    ref = jkp.KrylovPosteriorSurfaceRhoNu(pts, z, X, key=0,
                                          dtype=jnp.float64, **cfg)
    rho = np.repeat(10.0 ** port.log10_rho_nodes, 3)
    nu = np.tile(np.exp(port.log_nu_nodes), 3)
    ms, hs, to_r, from_r = jops.grid_geometry(pts)
    k_ref = jkp._matern_tables_host(jops.grid_distance_table(ms, hs, 1.0),
                                    rho, nu)
    k_port = tkp._matern_tables(torch.as_tensor(
        tops.grid_distance_table(ms, hs, 1.0)), rho, nu,
        torch.float64).numpy()
    tk2_ref = jops.grid_trace_pow2(k_ref, ms)
    tk2_port = tops.grid_trace_pow2(torch.as_tensor(k_port), ms).numpy()
    AB = np.concatenate([z[:, None], X, v_defl, probes], axis=1)
    ABp = AB * (1.0 + 1e-15 * np.random.RandomState(0).standard_normal(
        AB.shape))

    def alphas_ref(block):
        return np.asarray(jkp._factorize_fft_chunk(
            jops.circulant_rfft(k_ref, ms, jnp.float64), jnp.asarray(to_r),
            jnp.asarray(from_r), jnp.asarray(tk2_ref), jnp.asarray(block),
            STEPS, m + 1, ms)[0])

    def alphas_port(block):
        return tkp._factorize_fft_chunk(
            tops.circulant_rfft(torch.as_tensor(k_port), ms),
            torch.as_tensor(to_r), torch.as_tensor(from_r),
            torch.as_tensor(tk2_port), torch.as_tensor(block), STEPS, m + 1,
            ms)[0].numpy()
    a_ref, a_port = alphas_ref(AB), alphas_port(AB)
    a_ref_p, a_port_p = alphas_ref(ABp), alphas_port(ABp)

    real = tops._grid_matern_matmat_fft
    g = torch.Generator().manual_seed(0)

    def noisy(*args, **kw):
        out = real(*args, **kw)
        return out * (1 + 1e-16 * torch.randn(out.shape, generator=g,
                                              dtype=out.dtype))
    tops._grid_matern_matmat_fft = noisy
    try:
        port_noisy = tkp.KrylovPosteriorSurfaceRhoNu(
            pts, z, X, device="cpu", node_dtype=torch.float64,
            probes=probes, v_defl=v_defl, **cfg)
    finally:
        tops._grid_matern_matmat_fft = real
    pk = PROBES * STEPS
    kept_port = (port._qweights.numpy()[:, pk:] != 0).sum(1)
    kept_ref = (np.asarray(ref._qweights)[:, pk:] != 0).sum(1)
    print(f"side {side}: tables {np.abs(k_ref - k_port).max():.1e} max abs, "
          f"trace(K^2) {np.max(np.abs(tk2_ref - tk2_port) / tk2_ref):.1e} "
          f"max rel")
    for b in range(9):
        print(f"node {b} (rho {rho[b]:.4f}, nu {nu[b]:.3f}): alphas part "
              f"at step {_first_parting_step(a_port[b], a_ref[b])} (port vs "
              f"reference), {_first_parting_step(a_ref_p[b], a_ref[b])} "
              f"(reference vs itself perturbed), "
              f"{_first_parting_step(a_port_p[b], a_port[b])} (port vs "
              f"itself perturbed); deflation pairs kept {kept_port[b]} "
              f"(port), {kept_ref[b]} (reference)")
    for le in LOG10_ETAS:
        eta = 10.0 ** le
        zt, lt, bt = (np.asarray(v) for v in port._node_stats(
            torch.tensor(eta, dtype=torch.float64)))
        zj, lj, bj = (np.asarray(v) for v in ref._node_stats(
            jnp.asarray(eta)))
        noise = max(abs(float(port.profile_loglik(le, lr, math.exp(t)))
                        - float(port_noisy.profile_loglik(le, lr,
                                                          math.exp(t))))
                    for lr in port.log10_rho_nodes for t in port.log_nu_nodes)
        print(f"log10 eta {le}: node lp gap (port - reference) by node, its "
              f"zMz part {np.round(-0.5 * (n - m) * np.log(zt / zj), 3)}, "
              f"logdet(K + eta I) part {np.round(-0.5 * (lt - lj), 3)}, "
              f"logdet(B) part {np.round(-0.5 * (bt - bj), 3)}; port vs "
              f"itself with each product perturbed: {noise:.3f} at most")


if __name__ == "__main__":
    side = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    if sys.argv[2:] == ["c1"]:
        c1_attribution(side)
        sys.exit()
    print(f"side {side}, n = {side * side}: largest |gap| over the 9 nodes "
          "(nats)")
    for le, (ref, port, f64) in float32_node_gaps(side).items():
        print(f"log10 eta {le}: reference f32 - f64 "
              f"{np.abs(ref).max():.3f}, port f32 - f64 "
              f"{np.abs(port).max():.3f}, port f64 - reference f64 "
              f"{np.abs(f64).max():.3g}")
