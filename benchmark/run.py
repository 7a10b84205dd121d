"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. It loads the program, warms up on the cell's own shapes (set-up,
``setup_s``: from the start of this process to the first timed job), runs
jobs until ``--seconds`` of them have run (``estimate_s``: their seconds
over the estimates completed), checks one of them against the float64
reference, and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error. Exits non-zero with no result line where
there is no such device, where the program or the benchmark's files are
missing, and where a JAX module was loaded.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gppe_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not see,
    compared whole (``gppe_tpu_torch`` is not ``gppe_tpu``)."""
    loaded = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


@dataclass
class TracedRun:
    cell: object
    ctx: object
    records: list
    summary: object


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed, seconds, trace, device):
    """Set-up, the window and the check; the result as a dict, the checks'
    rows last."""
    import torch

    from . import harness, spec
    from . import trace as tracing
    from .reference import check

    ctx = harness.Context(cell, device, trace=trace)
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
    setup_end, records, checked = harness.run_window(ctx, seed, seconds,
                                                     profiler)
    t, steps = _STARTED, []
    for step, end in ctx.setup_marks.items():
        steps.append(f"{step} {end - t:.3f} s")
        t = end
    print("set-up: " + ", ".join(steps), file=sys.stderr)
    on_card = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    window_s = sum(r.seconds for r in records)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": len(records),
              "failed": sum(not r.ok for r in records)}
    if trace:
        t0 = time.perf_counter()
        summary = tracing.summarize(profiler)
        del profiler
        print(f"trace: {summary.device_events} device events read in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        run = TracedRun(cell, ctx, records, summary)
        metrics = {}
        for m in cell.per_layer:
            value = spec.part("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_by_span}
    else:
        values = {"estimate_s": window_s / len(records),
                  "setup_s": setup_end - _STARTED}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    try:
        if checked is None or not checked.products:
            raise RuntimeError("the checked job made no product call in "
                               "the window")
        values = check.readings(cell, checked, device)
    except Exception:                # no number: the check has failed
        traceback.print_exc()
        values = {}
    correct, rows = check.judge(values, cell.limits)
    # every job of the window reached an estimate: an exact count
    rows.append(("failed_jobs", float(result["failed"]), 0.0))
    result["correct"] = bool(correct) and result["failed"] == 0
    result["checks"] = {name: {"value": value if math.isfinite(value)
                               else None, "limit": limit}
                        for name, value, limit in rows}
    # last, once the window and the check have run: what the program, the
    # reference or a library they loaded brought in
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that must not load were loaded: {found}")
    return result, rows


def main(argv=None):
    args = _parse(argv)
    try:
        from . import spec
        cell = spec.load_cell(args.workload)
        import torch
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); this "
                  f"machine has {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        result, rows = measure(cell, args.seed, args.seconds,
                               bool(args.trace), device)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
