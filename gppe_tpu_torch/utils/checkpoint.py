"""Result artifacts and resumable chain state.

Counterpart of :mod:`gppe_tpu.utils.checkpoint` (the reference's
discipline, SURVEY.md §5.4: a long driver pickles a results dict and can
resume from it without recomputing; reference
examples/FindOptimalCovarianceParameters.py:714-754), plus the chain
state that :func:`gppe_tpu_torch.models.hmc.resume_hmc` and
:func:`gppe_tpu_torch.models.nuts.resume_nuts` continue from.
Files hold numpy arrays and bytes only: no torch object, no device.
"""

import os
import pickle

import numpy as np


def save_results(results, path, verbose=False):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(results, f)
    if verbose:
        print(f"saved results to {path}")


def load_results(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def results_exist(path):
    return os.path.isfile(path)


def run_or_resume(path, compute_fn, use_saved=True, verbose=False):
    """The reference's UseSavedResults pattern: load the artifact at
    ``path`` when present (and ``use_saved``), else compute and save it.
    ``path`` None computes and saves nothing."""
    if path is None:
        return compute_fn()
    if use_saved and results_exist(path):
        if verbose:
            print(f"resuming from {path}")
        return load_results(path)
    results = compute_fn()
    save_results(results, path, verbose=verbose)
    return results


def save_hmc_state(result, path, verbose=False):
    """Persist the full chain state of an ``HMCResult`` or a
    ``NUTSResult`` (their ``state()`` is the same dict): theta, step size
    and inverse mass as float64 numpy arrays, the generator's state as the
    bytes of ``torch.Generator.get_state()``, and the accept rate, so that
    :func:`gppe_tpu_torch.models.hmc.resume_hmc`,
    :func:`gppe_tpu_torch.models.nuts.resume_nuts` (or a sampler's
    ``resume_state``) continue the chains exactly where this run
    stopped. The generator state belongs to the device type it came from
    (a CUDA generator's 16 bytes, a CPU one's 5056)."""
    state = {k: (v if isinstance(v, bytes) else
                 v.detach().cpu().numpy() if hasattr(v, "detach")
                 else np.asarray(v))
             for k, v in result.state().items()}
    state["accept_rate"] = result.accept_rate.detach().cpu().numpy()
    save_results(state, path, verbose=verbose)


def load_hmc_state(path):
    """Load a state saved by :func:`save_hmc_state`, or by the reference's
    ``gppe_tpu.utils.checkpoint.save_hmc_state`` (of its ``hmc_sample``
    or its ``nuts_sample``), for ``resume_hmc``, ``resume_nuts`` or a
    sampler's ``resume_state``. A reference state carries theta, step size
    and inverse mass across exactly; its JAX PRNG key (two uint32 words)
    has no torch counterpart, so it is replaced by ``"seed"``, the integer
    word0 * 2^32 + word1, from which the resume seeds a new generator:
    the continued chains start from the same state and adaptation, on
    other random draws than the reference's."""
    state = load_results(path)
    if "key" in state and "generator_state" not in state:
        words = np.asarray(state.pop("key")).astype(np.uint64).ravel()
        state["seed"] = (int(words[0]) << 32) | int(words[1])
    return state
