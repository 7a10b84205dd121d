"""Timing of a dependent chain of operator products, shared by the
two entry points."""

import time

import torch


def chain(matmat, V, steps):
    """``steps`` products in a dependent chain, each column renormalised in
    between (what a Lanczos step pays: the next product waits for this
    one)."""
    for _ in range(steps):
        W = matmat(V)
        V = W / torch.linalg.norm(W, dim=0)
    return V


def seconds_per_step(matmat, V, warm, reps):
    """Seconds per product of :func:`chain`, after ``warm`` warm-up steps:
    by CUDA events on a CUDA tensor, by the host clock on a CPU tensor."""
    V = chain(matmat, V, warm)
    if V.device.type == "cuda":
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        chain(matmat, V, reps)
        stop.record()
        torch.cuda.synchronize(V.device)
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    chain(matmat, V, reps)
    return (time.perf_counter() - t0) / reps
