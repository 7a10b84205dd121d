"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its full
700 W power limit; the yardstick of every roofline share.

TF32 tensor cores 495 TFLOP/s; FP32 outside the tensor cores 67 TFLOP/s;
HBM 3.35 TB/s. The special-function units (MUFU: sqrt, exp2, ...) issue 16
operations a clock on each of the 132 SMs at 1980 MHz, 4.18e12 a second; a
MUFU operation moved to the FP32 pipes costs at least 13 FP32 operations (a
polynomial exp2), so the best split of MUFU work between the two runs
4.18e12 + 67e12 / 13 a second.
"""

TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
MUFU_OPS = 4.18e12
EMULATED_MUFU_FP32_OPS = 13
MUFU_BEST_SPLIT = MUFU_OPS + FP32_FLOPS / EMULATED_MUFU_FP32_OPS
