"""What a traced run's ``torch.profiler`` trace says, reduced once for the
per-layer readers.

The device's busy time is the union of the intervals in which any
operation ran on it, taken only inside the jobs (the arithmetic of
``chip_profile.py``'s ``profile_setup``, copied). The idle time inside the
jobs is attributed to the benchmark span the host was in at the time. The
product's device time is the length of the device-side shadows of the
``bench.product`` ranges: the profiler files the hand kernels, launched
through ``ctypes``, under no CPU operation, so the ranges' own device totals
miss them.
"""

import re
from dataclasses import dataclass, field

import numpy as np

SPANS = ("operator_build", "engine_build", "engine_fit")


@dataclass
class TraceSummary:
    window_s: float                 # the jobs' length in the trace
    busy_s: float                   # device busy inside the jobs
    product_device_s: float         # device length of bench.product
    device_ops: list = field(default_factory=list)   # [[name, s]], top 10
    idle_by_span: list = field(default_factory=list)  # [[span, s]]
    device_events: int = 0


def kernel_name(name):
    """A device operation's name without its template arguments, argument
    list and return type: ``internal::gemvx::kernel`` for cuBLAS's gemv
    (whose full name starts ``std::enable_if<...>::type``)."""
    name = name.replace("(anonymous namespace)::", "")
    prev = None
    while prev != name:
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    if not name.startswith("Mem"):
        name = re.sub(r"\([^()]*\)$", "", name)
    name = re.sub(r"^(void|std::enable_if::type)\s+", "", name)
    return name.strip()[:80]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _clip(intervals, windows):
    """The parts of sorted disjoint ``intervals`` inside sorted disjoint
    ``windows``."""
    out, i = [], 0
    for wa, wb in windows:
        while i < len(intervals) and intervals[i][1] <= wa:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < wb:
            a, b = max(intervals[j][0], wa), min(intervals[j][1], wb)
            if b > a:
                out.append([a, b])
            j += 1
    return out


def _gaps(busy, windows):
    """The idle intervals: each window minus the busy intervals in it
    (``busy`` sorted, disjoint and inside the windows)."""
    gaps, i = [], 0
    for wa, wb in windows:
        t = wa
        while i < len(busy) and busy[i][0] < wb:
            a, b = busy[i]
            if a > t:
                gaps.append([t, a])
            t = max(t, b)
            i += 1
        if t < wb:
            gaps.append([t, wb])
    return np.asarray(gaps, dtype=float).reshape(-1, 2)


def _overlap(gaps, a, b):
    return float(np.clip(np.minimum(gaps[:, 1], b)
                         - np.maximum(gaps[:, 0], a), 0.0, None).sum())


def summarize(prof):
    """The summary of a profiler that traced one window (times in us)."""
    from torch.autograd import DeviceType

    kernels, jobs, spans = [], [], {name: [] for name in SPANS}
    product_us = 0.0
    by_name = {}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("bench."):
                # a range's device-side shadow: from its first operation's
                # start on the device to its last one's end
                if e.name == "bench.product":
                    product_us += end - start
                continue
            kernels.append((start, end))
            key = kernel_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + (end - start)
        elif e.name == "bench.job":
            jobs.append((start, end))
        elif e.name.startswith("bench.") and e.name[6:] in spans:
            spans[e.name[6:]].append((start, end))
    jobs = _union(jobs)
    busy = _clip(_union(kernels), jobs)
    gaps = _gaps(busy, jobs)
    idle = {}
    for name, ranges in spans.items():
        seconds = sum(_overlap(gaps, a, b) for a, b in ranges) / 1e6
        if ranges:
            idle[name] = seconds
    idle_total = float(np.sum(gaps[:, 1] - gaps[:, 0])) / 1e6
    idle["between_spans"] = max(0.0, idle_total - sum(idle.values()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=sum(b - a for a, b in jobs) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        product_device_s=product_us / 1e6,
        device_ops=[[name, us / 1e6] for name, us in top],
        idle_by_span=sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:10],
        device_events=len(kernels))


def device_idle_share(summary):
    if summary.window_s <= 0:
        return None
    return 1.0 - summary.busy_s / summary.window_s


def mean_span(records, name):
    values = [r.spans[name] for r in records if name in r.spans]
    if not values or len(values) != len(records):
        return None
    return float(np.mean(values))
