"""Roofline sweep of the fused Matern matvec on one NVIDIA H100.

Counterpart of the reference's ``drivers/roofline_matvec.py``:
``cuda_kernels.matern_matmat`` at n = 100,000 2-D points (rho = 0.1,
nu = 0.5) over r in {23, 151, 279} x dist_mode in {diff, gram} x dot_mode
in {highest, bf16x3}: 12 rows. The sweep asks which unit limits the kernel:
more columns add product work per distance (if computing K is the floor,
seconds per column fall); 'highest' (3xTF32) and 'bf16x3' put the product
on the tensor cores with tf32 and bf16 operands; 'gram' changes the
per-pair distance arithmetic.

Each row carries the seconds of one matvec inside a dependent chain (each
column renormalised between products, by CUDA events) and the operations
the algorithm needs, split by the unit that runs them:

* ``cuda_core_ops``: per pair 3 d for the distance (the Gram form's
  2 d + 3), one sqrt, one exp and the sign flip; as a share of the
  67 TFLOP/s FP32 peak of the H100's CUDA cores (``pct_f32_peak``);
* ``tensor_core_ops``: the three products of the split operands, 6 r per
  pair; under 'bf16x3' as a share of the 989 TFLOP/s dense bf16 peak of
  its tensor cores (``pct_bf16_peak``), under 'highest' of the 495 TFLOP/s
  dense tf32 peak (``pct_tf32_peak``).

K is counted once per matvec, although a V wider than 32 columns is
multiplied in 32-column chunks that each recompute it. The shares are
``None`` on a run that is not on a CUDA device: a CPU time says nothing
about the card.

    python -m gppe_tpu_torch.drivers.roofline_matvec

prints one JSON line per row. ``main`` writes a file only when
``out_path`` is given. The reference's r_pad column is left out: nothing
here pads r to a lane width.
"""

import json

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils.config import resolve_device, setup
from . import _timing

RHO, NU, D = 0.1, 0.5, 2
WIDTHS = (23, 151, 279)
H100_F32_PEAK_TFLOPS = 67.0        # CUDA cores, outside the tensor cores
H100_BF16_PEAK_TFLOPS = 989.0      # tensor cores, dense
H100_TF32_PEAK_TFLOPS = 495.0      # tensor cores, dense
SHARE_KEYS = ("cuda_core_tflops", "pct_f32_peak", "tensor_core_tflops",
              "pct_bf16_peak", "pct_tf32_peak")


def operation_counts(n, r, dist_mode, dot_mode, d=D):
    """(CUDA-core operations, tensor-core operations) of one n x n matvec
    at width r: every mode multiplies on the tensor cores, three products
    but under 'bf16'."""
    per_pair = (2 * d + 3 if dist_mode == "gram" else 3 * d) + 3
    products = 1 if dot_mode == "bf16" else 3
    return n * n * per_pair, n * n * 2 * r * products


def peak_shares(cuda_core_ops, tensor_core_ops, seconds, dot_mode):
    """The achieved rates (TFLOP/s) and their percentages of the H100's
    FP32 peak and of the dense tensor-core peak of the mode's operands
    (tf32 under 'highest', bf16 otherwise; the other share is 0). No share
    can pass 100: a time that short is a timing fault, and raises."""
    core = cuda_core_ops / seconds / 1e12
    tensor = tensor_core_ops / seconds / 1e12
    tf32 = dot_mode == "highest"
    shares = {"cuda_core_tflops": core,
              "pct_f32_peak": 100.0 * core / H100_F32_PEAK_TFLOPS,
              "tensor_core_tflops": tensor,
              "pct_bf16_peak": 0.0 if tf32 else
              100.0 * tensor / H100_BF16_PEAK_TFLOPS,
              "pct_tf32_peak": 100.0 * tensor / H100_TF32_PEAK_TFLOPS
              if tf32 else 0.0}
    if max(shares[k] for k in ("pct_f32_peak", "pct_bf16_peak",
                               "pct_tf32_peak")) > 100.0:
        raise RuntimeError(f"a share of peak above 100%: {shares} in "
                           f"{seconds} s; the chain was not timed to its end")
    return shares


def main(n=100_000, out_path=None, device="cuda", warm=3, reps=None,
         verbose=True):
    """Run the 12 rows; return (and, with ``out_path``, write as JSON) the
    dict {"n", "device", "peak_denominators_tflops", "rows"}. ``reps``:
    timed products per row (default 20 at r = 23, 10 above)."""
    setup()
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rng = np.random.RandomState(3)
    pts = torch.as_tensor(rng.rand(n, D).astype(np.float32), device=device)

    rows = []
    for r in WIDTHS:
        V = torch.as_tensor(rng.standard_normal((n, r)), dtype=torch.float32,
                            device=device)
        for dist_mode in cuda_kernels.DIST_MODES:
            for dot_mode in ("highest", "bf16x3"):
                def matmat(W, dist_mode=dist_mode, dot_mode=dot_mode):
                    return cuda_kernels.matern_matmat(
                        pts, RHO, W, NU, dot_mode=dot_mode,
                        dist_mode=dist_mode)

                before = dict(cuda_kernels.launch_counts)
                secs = _timing.seconds_per_step(
                    matmat, V, warm, reps or (20 if r < 128 else 10))
                core, tensor = operation_counts(n, r, dist_mode, dot_mode)
                row = {"r": r, "dist_mode": dist_mode, "dot_mode": dot_mode,
                       "seconds": secs, "cuda_core_ops": core,
                       "tensor_core_ops": tensor,
                       "launches": {
                           k: v - before[k]
                           for k, v in cuda_kernels.launch_counts.items()
                           if v != before[k]}}
                row.update(peak_shares(core, tensor, secs, dot_mode)
                           if on_card else dict.fromkeys(SHARE_KEYS))
                rows.append(row)
                if verbose:
                    print(json.dumps(row), flush=True)

    out = {"n": n, "device": (torch.cuda.get_device_name(device) if on_card
                              else "cpu"),
           "peak_denominators_tflops": {
               "pct_f32_peak": H100_F32_PEAK_TFLOPS,
               "pct_bf16_peak": H100_BF16_PEAK_TFLOPS,
               "pct_tf32_peak": H100_TF32_PEAK_TFLOPS},
           "rows": rows}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        if verbose:
            print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    main()
