"""On the card, at each cell's own size: one checked job of the program is
correct, and each of the cell's controls is not. Marked ``cuda``; skips
without a CUDA device. Run on the card with
``python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py``."""

import pytest
import torch

from benchmark import calibrate, harness, spec
from benchmark.reference import check

from .cells import CELLS, CONTROLLED

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name, control", [(name, None) for name in CELLS]
                         + CONTROLLED)
def test_cell_at_size(card, name, control):
    cell = spec.load_cell(name)
    ctx = (calibrate.control_context(cell, card, control) if control
           else harness.Context(cell, card))
    values, _ = calibrate.readings(ctx, 2 ** 31 + 99, warm=False)
    correct, rows = check.judge(values, cell.limits)
    assert correct == (control is None), rows
