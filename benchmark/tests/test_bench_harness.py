"""A tiny job of each cell through the harness on the CPU: the window, the
checked job, the reference's readings, and the result line's schema."""

import json
import math

import pytest
import torch

from benchmark import run

from .cells import CELLS, tiny_cell

CPU = torch.device("cpu")


def _schema(result, cell, trace):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    metrics = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in metrics}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    device = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    if trace:
        assert {"busy_s", "window_s"} <= set(device)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run(name, trace):
    cell = tiny_cell(name)
    result, rows = run.measure(cell, 2 ** 31 + 7, 0.5, trace, CPU)
    _schema(result, cell, trace)
    assert result["correct"], rows
    assert [r[0] for r in rows] == list(cell.limits) + ["failed_jobs"]


def test_no_card_no_result(capsys):
    """Without a CUDA device the run prints no result and fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
