"""Build and load the package's CUDA kernels.

The sources under ``gppe_tpu_torch/csrc`` are compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface and
loaded with :mod:`ctypes`; nothing includes PyTorch's headers, so a build
takes seconds. Each source is compiled to an object by an ``nvcc`` of its
own, all started together, and one more ``nvcc`` links them. The library is
built at first use into ``build/`` at the root of the checkout, under a
name keyed by a hash of the sources, the headers and the flags, so an
edited source is rebuilt and a stale library is never loaded.

No ``--use_fast_math``: it swaps in approximate ``sqrtf``/``expf``, and the
exact kernels' parity bounds rest on the IEEE versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("matern_matmat.cu", "matern_matmat_mma.cu", "matern_multirho.cu",
           "matern_multirho_mma.cu", "matern_blocksparse.cu",
           "matern_blocksparse_mma.cu", "matern_general.cu",
           "matern_blocksparse_general.cu")
HEADERS = ("matern_common.cuh", "matern_mma.cuh", "matern_trace.cuh",
           "matern_bessel.cuh", "matern_general_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib = None


def find_nvcc():
    """nvcc from ``$CUDA_HOME/bin``, else from ``PATH``, else from the CUDA
    root PyTorch itself detects; raise if there is none."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to a CUDA toolkit (>= 12, for "
        "sm_90a) or put nvcc on PATH to build gppe_tpu_torch's kernels")


def nvcc_commands(nvcc, output, extra_flags=()):
    """The nvcc command lines that build the library at ``output``: one
    compile per source (independent of each other), then the link. The
    objects go beside ``output``. ``extra_flags`` are added to the compiles
    (``("-Xptxas", "-v")`` reports registers and spills)."""
    objects = [f"{output}.{Path(s).stem}.o" for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", obj,
                 str(CSRC_DIR / s)] for s, obj in zip(SOURCES, objects)]
    link = [nvcc, "-shared", "-o", str(output), *objects]
    return compiles, link


def library_path():
    """``build/libgppe_tpu_torch_<hash>.so``, keyed by sources and flags."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgppe_tpu_torch_{h.hexdigest()[:16]}.so"


def _build(path):
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name and rename: a concurrent build or a reader
    # never sees a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    compiles, link = nvcc_commands(nvcc, tmp)
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        outputs = [proc.communicate()[0] for proc in procs]  # waits for all
        for cmd, proc, output in zip(compiles, procs, outputs):
            _check_nvcc(cmd, proc.returncode, output)
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout)
        os.replace(tmp, path)
    finally:
        for leftover in (tmp, *(cmd[-2] for cmd in compiles)):
            if os.path.exists(leftover):
                os.unlink(leftover)


def _check_nvcc(cmd, returncode, output):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {returncode}:\n"
                           f"{' '.join(cmd)}\n{output}")


def load(path=None):
    """The loaded kernel library, built first if needed. ``path`` loads an
    already built library of the same C interface instead, uncached (a
    copy of the package with one change; ``chip_profile.py variants``)."""
    global _lib
    if path is None:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _build(path)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gppe_matern_matmat.restype = i32
    lib.gppe_matern_matmat.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                       i32, i32, i32, i32, i32, i32, i32,
                                       ptr]
    lib.gppe_matern_matmat_mma.restype = i32
    lib.gppe_matern_matmat_mma.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                           i32, i32, i32, i32, i32, i32, ptr]
    lib.gppe_matern_matmat_mma_scratch_bytes.restype = ctypes.c_int64
    lib.gppe_matern_matmat_mma_scratch_bytes.argtypes = [i32, i32, i32, i32,
                                                         i32]
    lib.gppe_matern_multirho.restype = i32
    lib.gppe_matern_multirho.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                         i32, i32, ptr]
    lib.gppe_matern_multirho_mma.restype = i32
    lib.gppe_matern_multirho_mma.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                             i32, i32, i32, i32, i32, i32, ptr]
    lib.gppe_matern_multirho_mma_scratch_bytes.restype = ctypes.c_int64
    lib.gppe_matern_multirho_mma_scratch_bytes.argtypes = [i32, i32, i32,
                                                           i32, i32]
    lib.gppe_matern_blocksparse.restype = i32
    lib.gppe_matern_blocksparse.argtypes = [ptr, ptr, ptr,
                                            i32, i32, i32, i32, i32,
                                            ctypes.c_float, i32, i32, i32,
                                            ptr]
    lib.gppe_matern_blocksparse_mma.restype = i32
    lib.gppe_matern_blocksparse_mma.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                                i32, i32, i32, i32, i32,
                                                ctypes.c_float, i32, i32, ptr]
    lib.gppe_matern_general_consts_bytes.restype = i32
    lib.gppe_matern_general_consts_bytes.argtypes = []
    lib.gppe_matern_general_elementwise.restype = i32
    lib.gppe_matern_general_elementwise.argtypes = [ptr, ptr, ctypes.c_int64,
                                                    ptr, ptr]
    lib.gppe_matern_general_product.restype = i32
    lib.gppe_matern_general_product.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        ctypes.c_int64, ctypes.c_int64, i32, i32, ctypes.c_int64, i32,
        ctypes.c_int64, ptr]
    lib.gppe_matern_general_trace.restype = i32
    lib.gppe_matern_general_trace.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                              i32, i32, i32, i32, i32, i32,
                                              i32, ptr]
    lib.gppe_matern_blocksparse_general_product.restype = i32
    lib.gppe_matern_blocksparse_general_product.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ctypes.c_float, ptr, ptr]
    lib.gppe_matern_blocksparse_general_trace.restype = i32
    lib.gppe_matern_blocksparse_general_trace.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float,
        ctypes.c_float, i32, i32, ptr, ptr]
    lib.gppe_cuda_error_string.restype = ctypes.c_char_p
    lib.gppe_cuda_error_string.argtypes = [i32]
    if path == library_path():
        _lib = lib
    return lib
