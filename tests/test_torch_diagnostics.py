"""The ported MCMC diagnostics (models.diagnostics) vs the JAX package's
numpy ones, on the same arrays: split R-hat, ESS and the summary at rtol
1e-12 against ``gppe_tpu.models.diagnostics``, numpy arrays and torch
tensors alike; then the reference's own sanity cases
(``tests/test_diagnostics.py``: iid, disjoint and autocorrelated chains).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gppe_tpu.models import diagnostics as jdiag  # noqa: E402
from gppe_tpu_torch.models import diagnostics as tdiag  # noqa: E402
from gppe_tpu_torch.utils.config import (  # noqa: E402
    one_torch_thread, warm_cpu_threads)

warm_cpu_threads()

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

RTOL = 1e-12


def ar1(S, C, phi, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros((S, C))
    e = rng.standard_normal((S, C))
    for t in range(1, S):
        x[t] = phi * x[t - 1] + e[t]
    return x


ARRAYS = {
    "iid": lambda: np.random.RandomState(0).standard_normal((500, 4, 2)),
    "short": lambda: np.random.RandomState(4).standard_normal((5, 3, 2)),
    "too_short": lambda: np.random.RandomState(5).standard_normal((3, 2, 1)),
    "ar1": lambda: np.stack([ar1(400, 4, 0.9, 6), ar1(400, 4, 0.5, 7)], -1),
    "constant_dim": lambda: np.concatenate(
        [np.random.RandomState(8).standard_normal((60, 4, 1)),
         np.ones((60, 4, 1))], axis=-1),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_matches_reference(name, as_tensor):
    """split_rhat, effective_sample_size and summarize against
    gppe_tpu's, rtol 1e-12 (NaN where the reference gives NaN)."""
    s = ARRAYS[name]()
    arg = torch.as_tensor(s) if as_tensor else s
    for fn in ("split_rhat", "effective_sample_size"):
        np.testing.assert_allclose(getattr(tdiag, fn)(arg),
                                   getattr(jdiag, fn)(s), rtol=RTOL)
    names = [f"x{d}" for d in range(s.shape[-1])]
    got, want = tdiag.summarize(arg, names=names), jdiag.summarize(s, names)
    assert got.keys() == want.keys()
    for k in names:
        assert got[k].keys() == want[k].keys()
        np.testing.assert_allclose([got[k][q] for q in want[k]],
                                   [want[k][q] for q in want[k]], rtol=RTOL)
    assert tdiag.summarize(arg)["dim0"].keys() == want[names[0]].keys()


def test_iid_chains():
    s = np.random.RandomState(0).standard_normal((500, 4, 2))
    assert np.all(np.abs(tdiag.split_rhat(s) - 1.0) < 0.05)
    assert np.all(tdiag.effective_sample_size(s) > 0.5 * 500 * 4)


def test_disjoint_chains_flagged():
    s = np.random.RandomState(1).standard_normal((300, 4, 1)) * 0.1
    s[:, 0, 0] += 5.0                       # one chain far away
    assert tdiag.split_rhat(s)[0] > 1.5


def test_autocorrelated_ess_small():
    x = ar1(800, 4, 0.97, 2)                # AR(1), tau ~ 65
    assert tdiag.effective_sample_size(x[:, :, None])[0] < 0.15 * 800 * 4


def test_summarize_shape():
    s = np.random.RandomState(3).standard_normal((200, 4, 3))
    out = tdiag.summarize(torch.as_tensor(s), names=["a", "b", "c"])
    assert set(out) >= {"a", "b", "c", "num_samples", "num_chains"}
    assert abs(out["a"]["mean"]) < 0.2
    assert out["b"]["ess"] > 100
