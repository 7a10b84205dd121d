"""gppe_tpu_torch.utils.timing against gppe_tpu.utils.timing, and the
grid-chunk profile twin (drivers.profile_grid_chunk), on the CPU.

The timing utilities are compared by behaviour: the same accumulation
over the same sequence of calls, the same environment after pinning.
The grid-chunk twin runs at n = 512, B = 3, k = 8 on the CPU, where its
products are the multi-rho kernel's plain version in float64; there its
seconds are CPU seconds of a few milliseconds, so the reorthogonalisation
(~1 ms) and the projections sit within the clock's noise and only the
card's run (chip_smoke.py phase 45, tests/test_torch_cuda.py) holds every
derived cost to be non-negative. Here: the keys, the derived costs as
the stated differences of the variants, no file without ``out_path``,
and the factorization the variants time equal to the grid engine's.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu.utils import timing as jtiming  # noqa: E402
from gppe_tpu_torch.drivers import profile_grid_chunk  # noqa: E402
from gppe_tpu_torch.models import grid_krylov  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.utils import timing  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

SMALL = dict(n=512, num_points=3, k=8, verbose=False, device="cpu")
VARIANTS = ("lanczos_ps_True_reorth_True", "lanczos_ps_True_reorth_False",
            "full_factorize_chunk")


@pytest.mark.parametrize("module", [timing, jtiming],
                         ids=["port", "reference"])
def test_time_counter(module):
    tc = module.TimeCounter()
    assert (tc.elapsed, tc.count) == (0.0, 0)
    with pytest.raises(RuntimeError, match="toc"):
        tc.toc()
    for _ in range(3):
        tc.tic()
        time.sleep(0.01)
        tc.toc()
    assert tc.count == 3 and 0.03 <= tc.elapsed < 1.0
    tc.reset()
    assert (tc.elapsed, tc.count, tc._t0) == (0.0, 0, None)


def test_phase_timer_accumulates_like_reference():
    got, want = {}, {}
    for _ in range(2):
        with timing.phase_timer("a", got, device="cpu"):
            time.sleep(0.01)
        with jtiming.phase_timer("a", want, block=False):
            time.sleep(0.01)
    with timing.phase_timer("b", got, block=False, device="cpu"):
        pass
    assert set(got) == {"a", "b"} and set(want) == {"a"}
    assert 0.02 <= got["a"] < 1.0 and 0.02 <= want["a"] < 1.0
    assert 0.0 <= got["b"] < 0.5
    with timing.phase_timer("c", device="cpu"):     # no results dict
        pass


def test_phase_timer_blocks_only_on_a_card(monkeypatch):
    """A CPU device is never synchronised; a CUDA one before and after."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    with timing.phase_timer("cpu", {}, device="cpu"):
        pass
    assert calls == []
    monkeypatch.setattr(timing, "resolve_device", torch.device)
    with timing.phase_timer("card", {}, device="cuda:0"):
        assert calls == [torch.device("cuda:0")]
    assert calls == [torch.device("cuda:0")] * 2
    with timing.phase_timer("card", {}, block=False, device="cuda:0"):
        pass
    assert len(calls) == 2


def test_device_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    x = torch.randn(64, 64, dtype=torch.float64)
    with timing.device_trace(str(log_dir), device="cpu") as prof:
        (x @ x).sum()
    assert prof.trace_path == str(log_dir / "trace.json")
    with open(prof.trace_path) as f:
        assert "traceEvents" in json.load(f)
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in name for name in names), names


def test_single_processor_and_process_time(monkeypatch):
    variables = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS", "VECLIB_MAXIMUM_THREADS",
                 "NUMEXPR_NUM_THREADS")
    for var in variables:
        monkeypatch.setenv(var, "8")
    timing.restrict_computation_to_single_processor()
    got = {var: os.environ[var] for var in variables}
    for var in variables:
        monkeypatch.setenv(var, "8")
    jtiming.restrict_computation_to_single_processor()
    assert got == {var: os.environ[var] for var in variables} == \
        dict.fromkeys(variables, "1")
    t0 = timing.process_time()
    sum(i * i for i in range(200_000))
    assert timing.process_time() > t0


@pytest.fixture(scope="module")
def chunk_profile(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("no_file"))
    try:
        cuda_kernels.reset_launch_counts()
        out = profile_grid_chunk.main(**SMALL)
        files = os.listdir(".")
    finally:
        os.chdir(cwd)
    return out, files


def test_grid_chunk_profile_keys(chunk_profile):
    out, files = chunk_profile
    assert files == []                           # no out_path, no file
    assert set(out) == {"n", "B", "k", "C", *VARIANTS, "s_per_point_full",
                        "derived", "launches"}
    assert (out["n"], out["B"], out["k"], out["C"]) == (512, 3, 8, 16)
    assert set(out["derived"]) == {"reorth_cost", "projection_and_transfer",
                                   "matvec_plus_recurrence_per_step"}
    assert out["launches"] == {}                 # no kernel on the CPU


def test_grid_chunk_profile_derived(chunk_profile):
    out, _ = chunk_profile
    assert all(np.isfinite(out[v]) and out[v] > 0 for v in VARIANTS)
    d = out["derived"]
    assert all(np.isfinite(v) for v in d.values())
    base = out["lanczos_ps_True_reorth_True"]
    assert d["reorth_cost"] == base - out["lanczos_ps_True_reorth_False"]
    assert d["projection_and_transfer"] == out["full_factorize_chunk"] - base
    assert d["matvec_plus_recurrence_per_step"] == \
        out["lanczos_ps_True_reorth_False"] / 8 > 0
    assert out["s_per_point_full"] == out["full_factorize_chunk"] / 3 > 0


def test_grid_chunk_profile_writes_out_path(tmp_path):
    path = tmp_path / "profile.json"
    out = profile_grid_chunk.main(**{**SMALL, "k": 3}, out_path=str(path))
    with open(path) as f:
        saved = json.load(f)
    assert saved["derived"] == out["derived"] and saved["k"] == 3


def test_grid_chunk_problem_is_the_engines():
    """The profiled chunk is the grid engine's: the twin's problem through
    _factorize_chunk_matrixfree equals the dense chunk's factorization."""
    pts, AB, rhos, s = profile_grid_chunk.problem(256, 3, 4)
    assert AB.shape == (256, 1 + 6 + 1 + 4) and s == 7
    np.testing.assert_array_equal(rhos, np.linspace(0.05, 0.3, 3))
    P = torch.as_tensor(pts, dtype=torch.float64)
    A = torch.as_tensor(AB, dtype=torch.float64)
    R = torch.as_tensor(rhos, dtype=torch.float64)
    free = grid_krylov._factorize_chunk_matrixfree(P, R, 0.5, A, 6, s, 64)
    dense = grid_krylov._factorize_chunk(P, R, np.full(3, 0.5), A, 6, s)
    for a, b in zip(free, dense):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("entry", [
    "profile_grid_chunk", "compare_various_noise_level",
    "plot_log_likelihood_der1", "plot_matern_kernel", "phase_timer",
    "device_trace"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Without device=, each new entry point goes to "cuda": on a host
    without a card it raises instead of running on the CPU, and writes
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works there")
    from gppe_tpu_torch.drivers import (compare_various_noise_level,
                                        plot_log_likelihood_der1,
                                        plot_matern_kernel)
    monkeypatch.chdir(tmp_path)
    call = {
        "profile_grid_chunk": lambda: profile_grid_chunk.main(
            n=64, num_points=2, k=2, verbose=False),
        "compare_various_noise_level": lambda: compare_various_noise_level
        .main(num_points=4, num_levels=2, verbose=False),
        "plot_log_likelihood_der1": lambda: plot_log_likelihood_der1.main(
            num_points=4, verbose=False),
        "plot_matern_kernel": lambda: plot_matern_kernel.main(test=True),
        "phase_timer": lambda: timing.phase_timer("a", {}).__enter__(),
        "device_trace": lambda: timing.device_trace(
            str(tmp_path / "t")).__enter__()}[entry]
    with pytest.raises((RuntimeError, AssertionError)):
        call()
    assert os.listdir(tmp_path) == []
