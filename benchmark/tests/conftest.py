"""The benchmark's own tests: on the CPU at tiny sizes, where the program
runs its plain versions.

Run from the root of the repository:
``python -m pytest benchmark/tests -q -p no:cacheprovider``.
"""

import pytest
import torch

# the first vectorised sqrt of a CPU thread can come back approximate
# (gppe_tpu_torch.utils.config.warm_cpu_threads); the comparisons here
# are tighter than that
torch.sqrt(torch.rand(1 << 20))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
