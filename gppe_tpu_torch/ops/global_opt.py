"""Global optimization over kernel hyperparameters.

Counterpart of :mod:`gppe_tpu.ops.global_opt`. The reference drives scipy's
``differential_evolution(workers=-1)`` (a process pool) plus a
callback-exception early-stopping shim (reference:
examples/FindOptimalCovarianceParameters.py:207-272, :347-366). Here, as in
``gppe_tpu``:

* each generation's population is ONE batched objective call (the
  replacement for ``workers=-1``): the objective takes a (popsize, D)
  tensor and returns (popsize,) values, so it can evaluate the whole
  population on the card at once;
* convergence is the reference's mask: a generation is done when the
  spread of the population's values falls below ``tol``, or (with
  ``terminate_atol``) when the best value improved by less than it. The
  reference's ``lax.scan`` keeps evolving after that and only records it;
  the port stops there, since each generation costs a batch of
  likelihoods, and reports the same count of generations.

The random numbers come from an explicit ``torch.Generator``.
"""

from typing import NamedTuple

import numpy as np
import torch


class DEResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    num_generations: int
    converged: bool


def differential_evolution(objective, bounds, generator=None, popsize=50,
                           max_generations=200, mutation=0.7,
                           recombination=0.9, tol=1e-6, terminate_atol=0.0):
    """Minimize ``objective`` over the box ``bounds`` (D, 2), best/1/bin.

    ``objective`` maps a (popsize, D) float64 tensor on the bounds' device
    to (popsize,) values; a value that is not finite counts as +inf.
    ``generator``: a ``torch.Generator`` on the CPU, or an int seed for a
    new one (None: seed 0); the draws are made on the CPU and moved to the
    bounds' device, so a seed gives the same run on every device.
    ``terminate_atol``: also stop when the best value improves by less than
    this across a generation (the MinimizeTerminator role, reference
    :207-272). Returns a :class:`DEResult`: the best point and value, the
    generations run and whether a convergence test fired."""
    if generator is None or isinstance(generator, (int, np.integer)):
        generator = torch.Generator().manual_seed(
            0 if generator is None else int(generator))
    bounds = torch.as_tensor(bounds, dtype=torch.float64)
    device = bounds.device
    dim = bounds.shape[0]
    lo, hi = bounds[:, 0], bounds[:, 1]

    def draw(fn, *args, **kw):
        return fn(*args, generator=generator, **kw).to(device)

    def evaluate(pop):
        f = torch.as_tensor(objective(pop), dtype=torch.float64,
                            device=device).reshape(popsize)
        return torch.where(torch.isfinite(f), f,
                           torch.full_like(f, float("inf")))

    pop = lo + (hi - lo) * draw(torch.rand, (popsize, dim),
                                dtype=torch.float64)
    fitness = evaluate(pop)
    best_prev = torch.min(fitness)
    generations, converged = max_generations, False
    for gen in range(max_generations):
        best = pop[torch.argmin(fitness)]
        r1 = draw(torch.randint, 0, popsize, (popsize,))
        r2 = draw(torch.randint, 0, popsize, (popsize,))
        mutant = best[None, :] + mutation * (pop[r1] - pop[r2])
        cross = draw(torch.rand, (popsize, dim),
                     dtype=torch.float64) < recombination
        # at least one crossed dimension per member
        force = torch.nn.functional.one_hot(
            draw(torch.randint, 0, dim, (popsize,)), dim).bool()
        trial = torch.clamp(torch.where(cross | force, mutant, pop), lo, hi)

        f_trial = evaluate(trial)
        better = f_trial < fitness
        pop = torch.where(better[:, None], trial, pop)
        fitness = torch.where(better, f_trial, fitness)

        best_now = torch.min(fitness)
        improved = best_prev - best_now
        spread = torch.max(fitness) - best_now
        best_prev = best_now
        if bool(spread < tol) or (terminate_atol > 0
                                  and bool(improved < terminate_atol)):
            generations, converged = gen + 1, True
            break
    i = torch.argmin(fitness)
    return DEResult(x=pop[i], fun=fitness[i], num_generations=generations,
                    converged=converged)


class MinimizeTerminator:
    """Host-side convergence watchdog for scipy-style optimizers - the
    reference's callback-exception pattern (:207-272) for code paths that
    run a host optimizer loop: raises :class:`Terminated` once the iterate
    moved less than ``atol`` in every coordinate ``patience`` times in a
    row."""

    class Terminated(Exception):
        pass

    def __init__(self, atol=1e-6, patience=2):
        self.atol = atol
        self.patience = patience
        self._last = None
        self._hits = 0
        self.num_calls = 0

    def __call__(self, xk, *args, **kwargs):
        self.num_calls += 1
        xk = np.asarray(xk, dtype=float)
        if self._last is not None:
            if np.all(np.abs(xk - self._last) < self.atol):
                self._hits += 1
                if self._hits >= self.patience:
                    raise MinimizeTerminator.Terminated(
                        f"converged after {self.num_calls} callbacks")
            else:
                self._hits = 0
        self._last = xk
        return False
