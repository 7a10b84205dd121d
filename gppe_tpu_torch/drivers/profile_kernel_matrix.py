"""The n = 100k profile MLE under each tile-dot mode of the fused matvec.

Counterpart of the reference's ``drivers/profile_pallas_matrix.py``: the
data behind ``cuda_kernels.DEFAULT_DOT_MODE``. For each mode of
``cuda_kernels.DOT_MODES`` it builds the flagship problem (100,000 uniform
random 2-D points from ``RandomState(7)``, noise 0.2, degree-2 basis,
rho = 0.1, nu = 0.5, 64 Lanczos steps, 16 probes), makes the mode the
module default by assignment, as the reference's script does, and reports

* the seconds of the full ``KrylovProfileLikelihood`` constructor, first
  and second time (the first carries the kernels' build when nothing is
  built yet, and the CUDA context's warm-up);
* the milliseconds of one matvec at r = 23 (the merged Lanczos block
  width of that engine) inside a dependent chain of 30, each column
  renormalised in between, by CUDA events;
* the kernel path's Frobenius-relative error against the plain exact
  ('highest') path at n = 4096, r = 4;
* ``der1(1.0)`` of the engine, and the kernel launches of one construction.

    python -m gppe_tpu_torch.drivers.profile_kernel_matrix

prints one JSON line per mode. It runs on the card unless ``device="cpu"``
is passed (the wrappers then take their plain versions; small n only).

Left out, being matters of the TPU tool chain: the tile axis (512 / 1024;
the CUDA kernels' tiles are fixed by their register budget), one
subprocess per configuration and the persistent compile cache (nothing is
compiled per configuration here: one library holds every mode).
"""

import json
import time

import numpy as np
import torch

from ..models.large_scale import KrylovProfileLikelihood
from ..ops import cuda_kernels
from ..ops.operators import MaternOperator
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup
from . import _timing

RHO, NU, NOISE = 0.1, 0.5, 0.2
CHAIN_WIDTH = 23      # the merged Lanczos block width of that engine


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one(mode, n=100_000, device="cuda", lanczos_steps=64, num_probes=16,
            chain_warm=4, chain_reps=30, check_n=4096,
            return_engine=False):
    """One mode's record (see the module docstring), as a dict with the
    keys ``mode``, ``constructor_cold_s``, ``constructor_warm_s``,
    ``matvec_ms_chain_r23``, ``rel_err_vs_plain``, ``eta_dbg``, and
    ``launches_per_construction``, ``n``, ``device``. With
    ``return_engine`` the pair (record, second engine)."""
    setup()
    mode = cuda_kernels.resolve_dot_mode(mode)
    device = resolve_device(device)
    rng = np.random.RandomState(7)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, NOISE)
    X = data_utils.generate_basis_functions(pts, 2)

    previous = cuda_kernels.DEFAULT_DOT_MODE
    cuda_kernels.DEFAULT_DOT_MODE = mode
    try:
        op = MaternOperator(pts, RHO, nu=NU, device=device)
        seconds, engines = [], []
        for _ in range(2):
            before = dict(cuda_kernels.launch_counts)
            t0 = time.perf_counter()
            engines.append(KrylovProfileLikelihood(
                op, X, z, lanczos_steps=lanczos_steps, num_probes=num_probes,
                device=device))
            _sync(device)
            seconds.append(time.perf_counter() - t0)
        launches = {k: v - before[k]
                    for k, v in cuda_kernels.launch_counts.items()
                    if v != before[k]}
        eng = engines[1]

        V = torch.as_tensor(rng.standard_normal((n, CHAIN_WIDTH)),
                            dtype=torch.float32, device=device)
        per_mv = _timing.seconds_per_step(op.matmat, V, chain_warm,
                                          chain_reps)

        # the kernel path against the plain exact path at small n
        m = min(check_n, n)
        small = MaternOperator(pts[:m], RHO, nu=NU, device=device)
        v = torch.as_tensor(rng.standard_normal((m, 4)),
                            dtype=torch.float32, device=device)
        want = cuda_kernels.matern_matmat_plain(
            small.points, small.scale, v, NU, dot_mode="highest")
        rel = float(torch.linalg.norm(small.matmat(v) - want)
                    / torch.linalg.norm(want))
    finally:
        cuda_kernels.DEFAULT_DOT_MODE = previous

    record = {
        "mode": mode, "n": n, "device": str(device),
        "constructor_cold_s": seconds[0],
        "constructor_warm_s": seconds[1],
        "matvec_ms_chain_r23": per_mv * 1e3,
        "rel_err_vs_plain": rel,
        "eta_dbg": float(eng.der1(1.0)),
        "launches_per_construction": launches,
    }
    return (record, eng) if return_engine else record


def main(n=100_000, device="cuda", **kw):
    """Run the three modes in this process; print one JSON line each and
    return the records."""
    records = []
    for mode in cuda_kernels.DOT_MODES:
        records.append(run_one(mode, n=n, device=device, **kw))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
