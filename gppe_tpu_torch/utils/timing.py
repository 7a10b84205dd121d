"""Timing and profiling utilities.

Counterpart of :mod:`gppe_tpu.utils.timing` (the reference's measurement
tooling, examples/_utilities/processing_time_utilities.py:29-162: the
TimeCounter accumulator, single-processor pinning for honest CPU time,
the process_time shim), with the card's equivalents: :func:`phase_timer`
blocks on the device with ``torch.cuda.synchronize`` before and after the
phase, and :func:`device_trace` records a ``torch.profiler`` trace (CUDA
activity on a card) and writes it as a Chrome trace.
"""

import contextlib
import os
import tempfile
import time

import torch

from .config import resolve_device


class TimeCounter:
    """Accumulates elapsed time across repeated calls, threaded through
    optimizers to isolate, for example, the trace-estimation time
    (reference :29-115)."""

    def __init__(self):
        self.elapsed = 0.0
        self.count = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self):
        if self._t0 is None:
            raise RuntimeError("toc() without tic()")
        self.elapsed += time.perf_counter() - self._t0
        self.count += 1
        self._t0 = None

    def reset(self):
        self.__init__()


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name, results=None, block=True, verbose=False, *,
                device="cuda"):
    """Wall-clock a phase. With ``block``, the clock starts and stops on
    an idle ``device``: ``torch.cuda.synchronize(device)`` before and
    after (a CPU device has nothing to wait for). The seconds are added
    to ``results[name]``, so repeated phases accumulate."""
    device = resolve_device(device)
    if block:
        _synchronize(device)
    t0 = time.perf_counter()
    yield
    if block:
        _synchronize(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    if verbose:
        print(f"[{name}] {dt:.3f} s")


def restrict_computation_to_single_processor():
    """Pin host BLAS / OpenMP pools to one thread for fair CPU comparisons
    (reference :122-144); work on the card is unaffected. Takes effect in
    libraries that read these variables when they start."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS", "VECLIB_MAXIMUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = "1"


def process_time():
    """CPU process time (reference :151-162)."""
    return time.process_time()


@contextlib.contextmanager
def device_trace(log_dir=None, *, device="cuda"):
    """Record the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity when ``device`` is a card) and write it to
    ``log_dir/trace.json``, a Chrome trace (chrome://tracing, Perfetto).
    Yields the profiler: after the block its ``key_averages()`` names
    every kernel that ran. ``log_dir`` None makes a fresh directory under
    the temporary directory; the path is the profiler's ``trace_path``."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="gppe_trace_")
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, "trace.json")
    with prof:
        yield prof
        _synchronize(device)
    prof.export_chrome_trace(prof.trace_path)
