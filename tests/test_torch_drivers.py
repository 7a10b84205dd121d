"""The port's two measurement entry points, on the CPU at n = 512.

``device="cpu"`` sends every product through the plain PyTorch versions,
so these tests check what the entry points build, call and report, not a
time: the chained-matvec times they return here are CPU times, and the
roofline rows carry no share of the card's peaks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu_torch.drivers import profile_kernel_matrix  # noqa: E402
from gppe_tpu_torch.drivers import roofline_matvec  # noqa: E402
from gppe_tpu_torch.ops import cuda_kernels  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n=512, device="cpu", lanczos_steps=16, num_probes=4,
             chain_warm=1, chain_reps=2, check_n=256)
SHARE_KEYS = ("cuda_core_tflops", "pct_f32_peak", "tensor_core_tflops",
              "pct_bf16_peak", "pct_tf32_peak")


@pytest.fixture(scope="module")
def records():
    return {mode: profile_kernel_matrix.run_one(mode, **SMALL)
            for mode in cuda_kernels.DOT_MODES}


@pytest.mark.parametrize("mode", cuda_kernels.DOT_MODES)
def test_run_one_record(records, mode):
    rec = records[mode]
    assert set(rec) == {
        "mode", "n", "device", "constructor_cold_s", "constructor_warm_s",
        "matvec_ms_chain_r23", "rel_err_vs_plain", "eta_dbg",
        "launches_per_construction"}
    assert rec["mode"] == mode and rec["n"] == 512 and rec["device"] == "cpu"
    assert all(np.isfinite(rec[k]) and rec[k] > 0 for k in (
        "constructor_cold_s", "constructor_warm_s", "matvec_ms_chain_r23"))
    assert np.isfinite(rec["eta_dbg"])
    assert rec["launches_per_construction"] == {}   # no kernel on the CPU
    # the error against the exact plain path is the mode's signature
    low, high = {"highest": (-1.0, 1e-12), "bf16x3": (1e-7, 2e-5),
                 "bf16": (1e-4, 5e-3)}[mode]
    assert low < rec["rel_err_vs_plain"] < high
    json.dumps(rec)


def test_run_one_modes_move_the_statistic_as_they_should(records):
    """der1(1) under 'bf16x3' stays within 1e-3 of 'highest'; 'bf16' moves
    it visibly (the reference's finding, "bf16 moved eta* by 4%")."""
    exact = records["highest"]["eta_dbg"]
    assert abs(records["bf16x3"]["eta_dbg"] - exact) < 1e-3 * abs(exact)
    assert abs(records["bf16"]["eta_dbg"] - exact) > 1e-3 * abs(exact)


def test_run_one_restores_the_default_and_returns_the_engine():
    assert cuda_kernels.DEFAULT_DOT_MODE == "highest"
    rec, eng = profile_kernel_matrix.run_one("bf16", return_engine=True,
                                             **SMALL)
    assert cuda_kernels.DEFAULT_DOT_MODE == "highest"
    res = eng.fit()
    assert res["success"] and np.isfinite(res["sigma0"])
    with pytest.raises(ValueError, match="dot_mode must be one of"):
        profile_kernel_matrix.run_one("fp8", **SMALL)
    assert cuda_kernels.DEFAULT_DOT_MODE == "highest"


def test_profile_main_prints_one_json_line_per_mode(capsys):
    out = profile_kernel_matrix.main(**SMALL)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["mode"] for r in lines] == list(cuda_kernels.DOT_MODES)
    assert [r["mode"] for r in out] == list(cuda_kernels.DOT_MODES)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The sweep run from an empty working directory, without out_path."""
    cwd = tmp_path_factory.mktemp("sweep")
    before = os.getcwd()
    os.chdir(cwd)
    try:
        out = roofline_matvec.main(n=512, device="cpu", warm=1, reps=1,
                                   verbose=False)
    finally:
        os.chdir(before)
    return out, cwd


def test_roofline_rows(sweep):
    out, _ = sweep
    rows = out["rows"]
    assert len(rows) == 12
    assert {(r["r"], r["dist_mode"], r["dot_mode"]) for r in rows} == {
        (r, dist, dot) for r in (23, 151, 279) for dist in ("diff", "gram")
        for dot in ("highest", "bf16x3")}
    assert out["n"] == 512 and out["device"] == "cpu"
    # every denominator is named, and they are this card's
    assert out["peak_denominators_tflops"] == {"pct_f32_peak": 67.0,
                                               "pct_bf16_peak": 989.0,
                                               "pct_tf32_peak": 495.0}
    for row in rows:
        assert row["seconds"] > 0
        # every mode multiplies on the tensor cores ('highest' as 3xTF32)
        assert row["tensor_core_ops"] == 512 * 512 * 6 * row["r"]
        # a CPU time is no share of the card's peak: none is stated
        assert all(row[k] is None or 0 <= row[k] <= 100 for k in SHARE_KEYS)
        assert all(row[k] is None for k in SHARE_KEYS)
    json.dumps(out)


def test_roofline_writes_no_file_unless_asked(sweep, tmp_path):
    _, cwd = sweep
    assert os.listdir(cwd) == []
    path = tmp_path / "sweep.json"
    out = roofline_matvec.main(n=128, out_path=str(path), device="cpu",
                               warm=0, reps=1, verbose=False)
    assert json.loads(path.read_text()) == out
    assert len(out["rows"]) == 12
    assert os.listdir(tmp_path) == ["sweep.json"]


def test_operation_counts_and_peak_shares():
    n, r = 1000, 23
    # 'highest' is three tf32 products on the tensor cores, not 2 r FP32
    # FMAs per pair on the CUDA cores
    assert roofline_matvec.operation_counts(n, r, "diff", "highest") == (
        n * n * (6 + 3), n * n * 6 * r)
    assert roofline_matvec.operation_counts(n, r, "gram", "bf16x3") == (
        n * n * (7 + 3), n * n * 6 * r)
    assert roofline_matvec.operation_counts(n, r, "diff", "bf16") == (
        n * n * (6 + 3), n * n * 2 * r)
    # a 'highest' time the FP32-FMA product could never reach (under its
    # 8 ms bound at n = 100k) is a share of the tf32 peak, not above 100%
    core, tensor = roofline_matvec.operation_counts(100_000, 23, "diff",
                                                    "highest")
    shares = roofline_matvec.peak_shares(core, tensor, 6e-3, "highest")
    assert 0 < shares["pct_f32_peak"] <= 100
    assert 0 < shares["pct_tf32_peak"] <= 100
    assert shares["pct_bf16_peak"] == 0
    core, tensor = roofline_matvec.operation_counts(100_000, 24, "diff",
                                                    "bf16x3")
    shares = roofline_matvec.peak_shares(core, tensor, 22e-3, "bf16x3")
    assert 0 < shares["pct_bf16_peak"] <= 100
    assert shares["pct_tf32_peak"] == 0
    # a time below the card's bound is a timing fault, not a result
    with pytest.raises(RuntimeError, match="above 100%"):
        roofline_matvec.peak_shares(core, tensor, 1e-4, "bf16x3")
    with pytest.raises(RuntimeError, match="above 100%"):
        roofline_matvec.peak_shares(core, tensor, 2e-3, "highest")


def test_entry_points_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gppe_tpu'] = None; "
            "import gppe_tpu_torch.drivers.profile_kernel_matrix, "
            "gppe_tpu_torch.drivers.roofline_matvec, "
            "gppe_tpu_torch.drivers.profile_grid_chunk, "
            "gppe_tpu_torch.drivers.compare_various_noise_level, "
            "gppe_tpu_torch.drivers.plot_log_likelihood_der1, "
            "gppe_tpu_torch.drivers.plot_matern_kernel, "
            "gppe_tpu_torch.utils.plot, gppe_tpu_torch.utils.display, "
            "gppe_tpu_torch.utils.timing; "
            "assert 'matplotlib' not in sys.modules; print('ok')")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
