"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json`` (the file the
configuration's entry in ``BENCHMARK.json`` names), its traffic
``traffic/<traffic>.json``, its limits ``limits/<workload>.json`` and its
controls ``controls/<workload>.json`` (``calibrate.py``, never a run). The
traffic names the entry it drives (``entries/<entry>.py``), the
configuration the operator (``operators/<operator>.py``), whose plain
reference is ``reference/<operator>.py`` and whose least-work count is
``work/<operator>.py``; each per-layer metric is read by
``metrics/<metric>.py``.
"""

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=ROOT):
    return _read_json(Path(root) / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    controls: list      # the first is the cell's control; each fails it
    end_to_end: list    # this cell's end-to-end metric entries
    per_layer: list     # this cell's per-layer metric entries


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, root=ROOT, benchmark=None):
    """The cell named ``name`` with everything its entry names."""
    bench = benchmark if benchmark is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    workload = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(Path(root) / configs[workload["config"]]["file"])
    traffic = _read_json(BENCH_DIR / "traffic" / f"{workload['traffic']}.json")
    limits = _read_json(BENCH_DIR / "limits" / f"{name}.json")
    controls = _read_json(BENCH_DIR / "controls" / f"{name}.json")["controls"]
    return Cell(name, workload, config, traffic, limits, controls,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def part(kind, name):
    """The module ``benchmark.<kind>.<name>``: an entry, operator,
    reference, work count or metric reader."""
    return importlib.import_module(f"benchmark.{kind}.{name}")
