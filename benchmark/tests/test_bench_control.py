"""Each control of a cell comes out not correct: the program with its own
lower dot mode (``bf16x3``), or the reference computed in TF32 in the
program's product's place, one precision step below the configured
float32, at a tiny size on the CPU and judged by the cell's own limits. On
the card ``python3 -m benchmark.calibrate --control <name>`` reads them at
the cell's size."""

import pytest
import torch

from benchmark import calibrate
from benchmark.reference import check

from .cells import CONTROLLED, tiny_cell


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name, control", CONTROLLED)
def test_control_is_not_correct(name, control, seed):
    cell = tiny_cell(name)
    ctx = calibrate.control_context(cell, torch.device("cpu"), control)
    values, _ = calibrate.readings(ctx, seed, warm=False)
    correct, rows = check.judge(values, cell.limits)
    assert not correct, rows
