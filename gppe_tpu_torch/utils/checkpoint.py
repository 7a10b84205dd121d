"""Result artifacts, numpy only.

Counterpart of the results half of :mod:`gppe_tpu.utils.checkpoint` (the
reference's discipline, SURVEY.md §5.4: a long driver pickles a results
dict and can resume from it without recomputing; reference
examples/FindOptimalCovarianceParameters.py:714-754). The chain-state
functions of the posterior samplers come with them (ROADMAP A12).
"""

import os
import pickle


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
