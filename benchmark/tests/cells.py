"""Each cell of ``BENCHMARK.json`` cut to a size the CPU holds in a second
or two (the program's plain versions run there)."""

import copy

from benchmark import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
# each cell with each of its controls
CONTROLLED = [(name, control) for name in CELLS
              for control in spec.load_cell(name).controls]


def tiny_cell(name):
    """The cell ``name`` at a size the CPU runs in about a second: 400
    random points, or a 24 x 24 grid at density 0.05 and rho 0.05; 16
    Lanczos steps, 4 probes."""
    cell = spec.load_cell(name)
    config = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    if config["points"]["kind"] == "uniform":
        config["points"]["n"] = 400
    else:
        config["points"]["side"] = 24
        config["density"] = 0.05
        config["rho"] = 0.05
    traffic["lanczos_steps"] = 16
    traffic["num_probes"] = 4
    cell.config, cell.traffic = config, traffic
    return cell
