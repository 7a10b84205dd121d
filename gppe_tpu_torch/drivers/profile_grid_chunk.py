"""Phase-split profile of the grid-batched Krylov chunk's setup.

Counterpart of the reference's ``drivers/profile_grid_chunk.py``: where
the time of one matrix-free chunk of the grid engine goes, at n = 100,000
random points, B = 8 rhos (linspace(0.05, 0.3, 8)), nu = 1/2, k = 40
Lanczos steps over the column block [z, X, v_defl, probes] (C = 16
columns a rho). Each phase is a variant of the whole program, timed once
after a warm run of a two-step chunk, by a clock that starts and stops
on an idle device
(:func:`gppe_tpu_torch.utils.timing.phase_timer`), and differences of
variants isolate its parts:

  lanczos_ps_True_reorth_{True,False}: ``ops.stochastic.lanczos`` over
      the (n, B * C) block, each product one launch of the multi-rho
      kernel (``cuda_kernels.matern_matmat_multirho``: B2,
      ``csrc/matern_multirho_mma.cu`` on the card), with and without the
      full reorthogonalisation; the difference is ``reorth_cost``;
  full_factorize_chunk: ``models.grid_krylov._factorize_chunk_matrixfree``
      (adds the float64 projections U, G, P, the trace(K^2) launch and
      the pull of its results to the host); its excess over the base
      Lanczos is ``projection_and_transfer``.

The reference also toggles ``precise_sums`` (its float64-emulated
coefficient sums on the TPU) and reports ``precise_sums_cost``. The
port's Lanczos always sums its coefficients in float64, natively on the
card (the precision rule of ``gppe_tpu_torch.utils.config``), so it has no
such switch: those variants and that key are absent, and every variant
here is a ``ps_True`` one. ``matvec_plus_recurrence_per_step`` is the
Lanczos without reorthogonalisation over k.

    python -m gppe_tpu_torch.drivers.profile_grid_chunk [--n N]

runs on the card (``device="cpu"`` for a rehearsal, float64 there, float32
on the card), prints the derived costs, and writes a JSON file only when
given ``out_path``. ``launches`` holds the kernels' launch counts over the
whole run (``cuda_kernels.launch_counts``).
"""

import argparse
import json

import numpy as np
import torch

from ..models.grid_krylov import _factorize_chunk_matrixfree
from ..ops import cuda_kernels, stochastic
from ..utils import data as data_utils
from ..utils.config import resolve_device, setup
from ..utils.timing import phase_timer


def problem(n, num_points, num_probes):
    """The reference's chunk: (pts, AB, rhos, s) from RandomState(7), noise
    0.2, a degree-2 basis, [z, X] then v_defl then the probes."""
    rng = np.random.RandomState(7)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    A = np.concatenate([z[:, None], X], axis=1)
    probes = np.asarray(rng.choice([-1.0, 1.0], size=(n, num_probes)),
                        np.float32)
    v_defl = np.asarray(rng.standard_normal((n, 1)), np.float32)
    AB = np.concatenate([A, v_defl, probes], axis=1)
    return pts, AB, np.linspace(0.05, 0.3, num_points), A.shape[1]


def main(n=100_000, num_points=8, k=40, num_probes=8, out_path=None,
         verbose=True, *, device="cuda"):
    """Returns {"n", "B", "k", "C", the variants' seconds,
    "full_factorize_chunk", "s_per_point_full", "derived": {...},
    "launches": {...}}."""
    setup()
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    pts, AB, rhos, s = problem(n, num_points, num_probes)
    pts_d = torch.as_tensor(pts, dtype=dtype, device=device).contiguous()
    rhos_d = torch.as_tensor(rhos, dtype=dtype, device=device)
    AB_d = torch.as_tensor(AB, dtype=dtype, device=device)
    B, C = num_points, AB.shape[1]
    out = {"n": n, "B": B, "k": k, "C": int(C)}
    cuda_kernels.reset_launch_counts()

    def timed(label, fn):
        with phase_timer(label, out, device=device):
            fn()
        if verbose:
            print(f"{label}: {out[label]:.4f} s")

    def mv_flat(Q):                                # (n, B*C)
        Qb = Q.reshape(n, B, C).permute(1, 0, 2).contiguous()
        Wb = cuda_kernels.matern_matmat_multirho(pts_d, rhos_d, Qb, 0.5)
        return Wb.permute(1, 0, 2).reshape(n, B * C)

    def full(steps=k):
        r = _factorize_chunk_matrixfree(pts_d, rhos_d, 0.5, AB_d, steps, s,
                                        512)
        return [x.cpu() for x in r]                # the host pull

    flat0 = AB_d[:, None, :].expand(n, B, C).reshape(n, B * C)
    # the warm run: a two-step chunk loads the kernels and the allocator's
    # blocks that every variant uses (the variants differ in step count
    # only, so none needs a warm run of its own)
    full(2)
    for reo in (True, False):
        timed(f"lanczos_ps_True_reorth_{reo}",
              lambda reo=reo: stochastic.lanczos(mv_flat, flat0, k,
                                                 reorthogonalize=reo))
    timed("full_factorize_chunk", full)
    base = out["lanczos_ps_True_reorth_True"]
    out["s_per_point_full"] = out["full_factorize_chunk"] / B
    out["derived"] = {
        "reorth_cost": base - out["lanczos_ps_True_reorth_False"],
        "matvec_plus_recurrence_per_step":
            out["lanczos_ps_True_reorth_False"] / k,
        "projection_and_transfer": out["full_factorize_chunk"] - base,
    }
    out["launches"] = {name: c for name, c in
                       cuda_kernels.launch_counts.items() if c}
    if verbose:
        print(json.dumps(out["derived"]))
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        if verbose:
            print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--points", type=int, default=8)
    p.add_argument("--k", type=int, default=40)
    p.add_argument("--out-path", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(n=a.n, num_points=a.points, k=a.k, out_path=a.out_path,
         device=a.device)
