"""The check catches the faults a cell can have: the harness runs a tiny
job with the timed path broken underneath it, and ``correct`` comes out
false. (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

from benchmark import calibrate, run
from gppe_tpu_torch.models.large_scale import KrylovProfileLikelihood
from gppe_tpu_torch.ops import cuda_kernels, stochastic

from .cells import CELLS, tiny_cell

# each product of the program, and where its operand is among the
# arguments after the points
PRODUCTS = {"matern_matmat": 1, "matern_matmat_blocksparse": 0,
            "matern_matmat_multirho": 1}


def _operand(name, args, kwargs):
    V = args[PRODUCTS[name]]
    if kwargs.get("frobenius") or kwargs.get("return_frobenius"):
        return None
    return V


def _unchanged(name, product):
    """A step that returns its state unchanged: the product hands back its
    operand."""
    def broken(points, *args, **kwargs):
        out = product(points, *args, **kwargs)
        V = _operand(name, args, kwargs)
        return out if V is None else V.clone()
    return broken


def _half_batch(name, product):
    """Half of the batch left out, the mean taken over the rest: the
    product of the first half of the columns, and their mean for the
    others."""
    def broken(points, *args, **kwargs):
        out = product(points, *args, **kwargs)
        if _operand(name, args, kwargs) is None:
            return out
        half = out.shape[-1] // 2
        out = out.clone()
        out[..., half:] = out[..., :half].mean(dim=-1, keepdim=True)
        return out
    return broken


def _altered_fit(fit):
    """An answer altered where it is produced: eta 5% high."""
    def broken(self, *args, **kwargs):
        res = dict(fit(self, *args, **kwargs))
        res["eta"] *= 1.05
        res["sigma0"] = res["eta"] ** 0.5 * res["sigma"]
        return res
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer",
                                   "start"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    if fault == "start":
        monkeypatch.setattr(stochastic, "lanczos",
                            calibrate.another_start(stochastic.lanczos))
    elif fault == "answer":
        monkeypatch.setattr(KrylovProfileLikelihood, "fit",
                            _altered_fit(KrylovProfileLikelihood.fit))
    else:
        wrap = _unchanged if fault == "unchanged" else _half_batch
        for product in PRODUCTS:
            monkeypatch.setattr(cuda_kernels, product,
                                wrap(product, getattr(cuda_kernels, product)))
    result, rows = run.measure(tiny_cell(name), 11, 0.1, False,
                               torch.device("cpu"))
    assert not result["correct"], rows
    if fault == "start":
        assert result["checks"]["start_err"]["value"] > \
            result["checks"]["start_err"]["limit"], rows
