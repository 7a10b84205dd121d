"""Precision policy.

A float32 product in TF32 keeps about three decimal digits: that is the
bf16-class error that moved eta* by 4% in the reference
(gppe_tpu/ops/pallas_kernels.py, dot-mode table). The Lanczos
reorthogonalisation products run on cuBLAS, so they are exposed to it
too. :func:`setup` pins every float32 product to full IEEE float32; each
entry point of the package calls it (importing the package changes no
global state).

Dtypes on the card: the fused Matern kernel and the Lanczos vectors are
float32, the Lanczos alpha/beta sums and the basis projections float64
(the H100 has native f64), and the per-eta likelihood math float64 numpy
on the host. The CPU tests run everything in float64.
"""

import torch


def setup():
    """Disable TF32 in cuBLAS and cuDNN and set the float32 matmul
    precision to "highest". Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def warm_cpu_threads():
    """Run one vectorised sqrt on every intra-op CPU thread and discard it.

    On some hosts the first vectorised sqrt a thread runs after the process
    starts comes back approximate (about 1e-4 relative) for that thread's
    chunk; every later call is exact. The package's CPU path exists for
    tests and rehearsals, which compare at 1e-5 and tighter: they call this
    once, when they are imported, so that no comparison meets that call."""
    torch.sqrt(torch.rand(1 << 20))


def one_torch_thread():
    """One torch thread until resumed, then the earlier count again: the
    body of the test modules' autouse fixture,
    ``pytest.fixture(autouse=True, scope="module")(one_torch_thread)``.
    The test suite runs six workers on the host's cores, and torch's own
    pool of one thread per core in each of them made small problems about
    15 times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def precision_state():
    """The settings :func:`setup` controls, for logging."""
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def resolve_device(device):
    """``torch.device(device)``, with a bare "cuda" pinned to the current
    CUDA device so that "cuda" and "cuda:0" name the same place. Never
    substitutes another device type."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
