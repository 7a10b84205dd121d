"""TF32, the precision step below the configured float32: what the
controls compute in."""

import torch


def tf32(x):
    """``x`` as float32 rounded to TF32 (10 mantissa bits), to nearest: the
    operand a TF32 tensor-core product takes."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
