"""The measured loop: one client running estimation jobs back to back.

Each job hands the program one data set and gets back the estimate. The
clock runs only while a job runs: the next job's inputs are made between
jobs, with the clock stopped, so the window holds the program's work and
nothing of the benchmark's. The window closes with the job in flight once
``seconds`` of jobs have run, so it holds only whole estimates.

The benchmark's own spans time each layer a job calls into (host clock,
ended by a synchronise): ``operator_build``, ``engine_build``,
``engine_fit``. In a traced run each span is also a ``record_function``
range named ``bench.<span>``, each product call ``bench.product`` and each
job ``bench.job``.

One job of the window, drawn from the seed among its first
``CHECK_FROM_FIRST``, is checked after the window: its products' inputs and
outputs are kept (copies, on the device) as the program computes them, in
room allocated before the window from the shapes a warm-up job used, so
that keeping them allocates nothing in the window. The window runs on until
that job has run, where its seconds end sooner.
"""

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import data, spec

# warm-up jobs in set-up, on the cell's own shapes and a seed of their own
WARM_JOBS = 1
# the checked job is drawn from the window's first jobs
CHECK_FROM_FIRST = 3


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class JobRecord:
    index: int
    seconds: float
    spans: dict
    ok: bool            # the job reached an estimate
    calls: dict         # (batch, width) -> product calls of that shape


class Capture:
    """Copies of one job's product calls, operand and result, in order:
    into room made beforehand for the ``shapes`` a warm-up job's calls had,
    or, with no shapes, into new tensors."""

    def __init__(self, shapes=None, device=None):
        self.pairs = []
        self._room = None if shapes is None else [
            tuple(torch.empty(shape, dtype=dtype, device=device)
                  for shape, dtype in call) for call in shapes]

    def keep(self, V, out):
        if self._room is None:
            self.pairs.append((V.detach().clone(), out.detach().clone()))
            return
        if len(self.pairs) == len(self._room):
            raise RuntimeError("the checked job made more product calls "
                               "than the warm-up job")
        a, b = self._room[len(self.pairs)]
        a.copy_(V)
        b.copy_(out)
        self.pairs.append((a, b))


@dataclass
class Checked:
    """What the checked job leaves for the reference: its inputs, each
    product call's (input, output) in order, the program's engines and its
    estimate."""
    job: data.Job
    products: list = field(default_factory=list)    # (operand, result)
    engines: list = field(default_factory=list)
    estimate: dict = None
    rhos: list = None
    nus: list = None

    def take(self, out):
        """The entry's output of the checked job."""
        self.engines, self.estimate = out["engines"], out["estimate"]
        self.rhos, self.nus = out["rhos"], out["nus"]


class Context:
    """What an entry needs: the cell, the device, the parameters of its
    kernel, spans and the product boundary."""

    def __init__(self, cell, device, trace=False):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.device = device
        self.trace = bool(trace)
        self.rho = float(self.config["rho"])
        self.nu = float(self.traffic.get("nu", self.config["nu"]))
        self.dot_mode = self.traffic["dot_mode"]
        # the reference module whose TF32 product takes the program's
        # product's place: the TF32 control (``calibrate.py``), never in a
        # run
        self.control = None
        self.capture = None         # a Capture while the checked job runs
        self._spans = None
        self._calls = None
        self._shapes = None         # each product call's shapes, in order
        self.setup_marks = {}       # set-up step -> host time at its end

    @contextlib.contextmanager
    def span(self, name):
        """Host seconds of one layer's call, ended by a synchronise."""
        rf = (torch.profiler.record_function(f"bench.{name}") if self.trace
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
            synchronize(self.device)
        self._spans[name] = time.perf_counter() - t0

    def product(self, fn, *args, **kwargs):
        """One call of the operator's product: its range in a traced run,
        and a copy of its operand and result in the checked job."""
        with (torch.profiler.record_function("bench.product") if self.trace
              else contextlib.nullcontext()):
            out = fn(*args, **kwargs)
        V = args[-1]
        shape = (1 if V.ndim == 2 else V.shape[0], V.shape[-1])
        self._calls[shape] = self._calls.get(shape, 0) + 1
        self._shapes.append(((tuple(V.shape), V.dtype),
                             (tuple(out.shape), out.dtype)))
        if self.capture is not None:
            self.capture.keep(V, out)
        return out

    def start_job(self):
        self._spans, self._calls, self._shapes = {}, {}, []


class ProductBoundary:
    """A matrix-free operator seen through :meth:`Context.product`: the
    engine gets this in the operator's place."""

    def __init__(self, ctx, operator):
        self._ctx = ctx
        self._op = operator
        self.shape = operator.shape
        self.device = operator.device
        self.dtype = operator.dtype

    def matmat(self, V):
        return self._ctx.product(self._op.matmat, V)

    def trace_pow(self, exponent):
        return self._op.trace_pow(exponent)


def checked_job_index(seed):
    """The window's job that is checked, drawn from the seed."""
    return int(np.random.default_rng([int(seed) & ((1 << 64) - 1), 99])
               .integers(CHECK_FROM_FIRST))


def job_ok(estimate):
    """The program reached an estimate (eta may sit on a boundary, 0 or
    inf, where the profile likelihood has its optimum there)."""
    sigma0 = estimate.get("sigma0")
    return bool(estimate.get("success", False)) and sigma0 is not None \
        and bool(np.isfinite(sigma0))


def run_window(ctx, seed, seconds, profiler=None):
    """Warm up, then run jobs until ``seconds`` of them (and the checked
    one) have run. Returns
    (set-up end time, job records, the checked job)."""
    marks = ctx.setup_marks
    marks["start"] = time.perf_counter()
    entry = spec.part("entries", ctx.traffic["entry"])
    maker = data.JobMaker(ctx.config, ctx.traffic["num_probes"], seed,
                          ctx.device)
    marks["program loaded"] = time.perf_counter()
    for w in range(WARM_JOBS):
        ctx.start_job()
        entry.run(ctx, maker.make(data.WARM_JOB_BASE + w))
        synchronize(ctx.device)
    marks["warm jobs"] = time.perf_counter()
    capture = Capture(ctx._shapes, ctx.device)
    check_index = checked_job_index(seed)
    checked = None
    records = []
    job = maker.make(0)
    synchronize(ctx.device)
    setup_end = marks["room and first inputs"] = time.perf_counter()
    if profiler is not None:
        profiler.start()
    total = 0.0
    while True:
        ctx.start_job()
        if job.index == check_index:
            checked = Checked(job, capture.pairs)
            ctx.capture = capture
        rf = (torch.profiler.record_function("bench.job") if ctx.trace
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            out = entry.run(ctx, job)
            synchronize(ctx.device)
        dt = time.perf_counter() - t0
        ctx.capture = None
        if job.index == check_index:
            checked.take(out)
        total += dt
        records.append(JobRecord(job.index, dt, dict(ctx._spans),
                                 job_ok(out["estimate"]), dict(ctx._calls)))
        del out
        if total >= seconds and job.index >= check_index:
            break
        job = maker.make(job.index + 1)
    if profiler is not None:
        synchronize(ctx.device)
        profiler.stop()
    return setup_end, records, checked


def run_checked_job(ctx, seed, warm=True):
    """One job of ``seed`` (the one its window would check), its products
    kept: what the reference judges, without a window around it."""
    entry = spec.part("entries", ctx.traffic["entry"])
    maker = data.JobMaker(ctx.config, ctx.traffic["num_probes"], seed,
                          ctx.device)
    if warm:
        ctx.start_job()
        entry.run(ctx, maker.make(data.WARM_JOB_BASE))
    capture = Capture()
    checked = Checked(maker.make(checked_job_index(seed)),
                      capture.pairs)
    ctx.start_job()
    ctx.capture = capture
    try:
        out = entry.run(ctx, checked.job)
        synchronize(ctx.device)
    finally:
        ctx.capture = None
    checked.take(out)
    return checked
