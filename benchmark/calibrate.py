"""The readings that a cell's limits are set from: the program on many
seeds, its controls and a planted fault on a few, each one checked job at
the cell's own size, all in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3
        [--control bf16x3|tf32 | --fault start] [--out FILE]

prints one JSON line a seed: its readings and the program's estimate.
``--control`` runs a control, one precision step below the configured
float32 (``controls/<workload>.json`` names each cell's): ``bf16x3``, the
program with its own lower dot mode switched on; ``tf32``, the reference
computed in TF32 in the product's place (``reference/<operator>.py``: its
``ControlOperator`` in the operator's place, ``control_multirho`` in the
multi-rho product's). ``--fault start`` starts each Lanczos column from
another column of the job's block, the fault ``start_err`` is there for.
The benchmark's runs never run a control or a fault.
"""

import argparse
import json
import sys
import time

import torch

from . import harness, spec
from .reference import check

CONTROLS = ("bf16x3", "tf32")


def control_context(cell, device, control):
    """A context whose jobs run ``control`` (one of ``CONTROLS``)."""
    if control not in CONTROLS:
        raise ValueError(f"control must be one of {CONTROLS}; got {control}")
    ctx = harness.Context(cell, device)
    if control == "tf32":
        ctx.control = spec.part("reference", cell.config["operator"])
    else:
        ctx.dot_mode = control
    return ctx


def another_start(lanczos):
    """The Lanczos pass ``lanczos`` started from the block's columns rolled
    by one: each column from another's start."""
    def broken(matvec, V0, *args, **kwargs):
        return lanczos(matvec, V0.roll(1, dims=1), *args, **kwargs)
    return broken


def readings(ctx, seed, warm):
    checked = harness.run_checked_job(ctx, seed, warm=warm)
    values = check.readings(ctx.cell, checked, ctx.device)
    return values, checked.estimate


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    group = p.add_mutually_exclusive_group()
    group.add_argument("--control", choices=CONTROLS)
    group.add_argument("--fault", choices=("start",))
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    ctx = (control_context(cell, device, args.control) if args.control
           else harness.Context(cell, device))
    if args.fault:
        from gppe_tpu_torch.ops import stochastic
        stochastic.lanczos = another_start(stochastic.lanczos)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        try:
            values, estimate = readings(ctx, seed, warm=(i == 0))
            error = None
        except Exception as e:               # a control that crashes
            values, estimate, error = {}, {}, repr(e)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control, "fault": args.fault,
            "readings": values,
            "estimate": {k: estimate.get(k) for k in ("eta", "sigma",
                                                       "sigma0", "rho")},
            "error": error, "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(device)}, default=float)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
