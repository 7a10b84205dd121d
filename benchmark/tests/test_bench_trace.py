"""The trace arithmetic: device busy time as the union of intervals inside
the jobs, idle time by the span the host was in, and kernel names."""

import numpy as np
import pytest

from benchmark import trace


def test_busy_and_idle_inside_the_jobs():
    jobs = trace._union([(0, 10), (20, 30)])
    kernels = [(1, 3), (2, 4), (9, 12), (15, 16), (21, 22)]
    busy = trace._clip(trace._union(kernels), jobs)
    assert busy == [[1, 4], [9, 10], [21, 22]]
    gaps = trace._gaps(busy, jobs)
    np.testing.assert_array_equal(gaps, [[0, 1], [4, 9], [20, 21], [22, 30]])
    assert trace._overlap(gaps, 3, 25) == pytest.approx(5 + 1 + 3)


@pytest.mark.parametrize("raw, short", [
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, "
     "float, cublasGemvParamsEx<int, float> >(cublasGemvParamsEx<int, "
     "float>)", "internal::gemvx::kernel"),
    ("void (anonymous namespace)::matern_matmat_mma_kernel<0, 0, 2, 2, 1>"
     "(float const*, float const*)", "matern_matmat_mma_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
])
def test_kernel_name(raw, short):
    assert trace.kernel_name(raw) == short
