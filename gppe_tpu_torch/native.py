"""ctypes bindings for the host-native tapered CSR builder (C++/OpenMP).

Counterpart of :mod:`gppe_tpu.native`, over this package's copy of its
source, ``csrc/taper_assembly.cpp``: the cell-binned tapered CSR
construction at O(n k), a parallel count, an exclusive scan and a parallel
fill, for the closed forms of nu (1/2, 3/2, 5/2 and the Gaussian limit from
nu = 100) and points of at most 8 dimensions. It runs on the host: its
output is a host CSR.

The library is built by a C++ compiler with the reference's flags at its
first use, never when this module is imported: into ``build/`` at the
root of the checkout, under a name keyed by a hash of the source and the
flags, written to a private name and renamed into place, so that first
uses in several processes at once never load a half-written file. The
compilers are tried in turn, each once with those flags (:func:`compilers`:
``$CXX``, then ``g++`` on ``PATH``, then ``/usr/bin/g++``, since a compiler
first on ``PATH`` may lack the OpenMP runtime). :func:`available` and a
call at a nu without a closed form build nothing. A build that fails with
every compiler raises with their output; nothing falls back to another
builder or to other flags.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from .ops._build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "taper_assembly.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall")
_CLOSED_FORM_NUS = (0.5, 1.5, 2.5)
_GAUSSIAN_NU_CUTOFF = 100.0
_MAX_D = 8

_lib = None


def compilers():
    """The C++ compilers to try, in order, each once: ``$CXX``, then ``g++``
    on ``PATH``, then ``/usr/bin/g++``."""
    names = [os.environ.get("CXX"), "g++", "/usr/bin/g++"]
    found, seen = [], set()
    for name in filter(None, names):
        path = shutil.which(name)
        if path and os.path.realpath(path) not in seen:
            seen.add(os.path.realpath(path))
            found.append(path)
    return found


def library_path():
    """``build/libgppe_tpu_torch_native_<hash>.so``, keyed by the source
    and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgppe_tpu_torch_native_{h.hexdigest()[:16]}.so"


def available():
    """True when the library is built or a first use can build it (a C++
    compiler is found). Builds nothing."""
    return _lib is not None or library_path().is_file() or bool(compilers())


def _build(path):
    cxxs = compilers()
    if not cxxs:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH to "
                           "build gppe_tpu_torch's tapered CSR builder")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    failures = []
    try:
        for cxx in cxxs:
            cmd = [cxx, *CXX_FLAGS, "-shared", "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode == 0:
                os.replace(tmp, path)
                return
            failures.append(f"{' '.join(cmd)} (exit code "
                            f"{proc.returncode}):\n{proc.stdout}")
        raise RuntimeError("building the tapered CSR builder failed:\n"
                           + "\n".join(failures))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.is_file():
        _build(path)
    lib = ctypes.CDLL(str(path))
    dptr, i64ptr = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(
        ctypes.c_int64)
    lib.gppe_taper_count.restype = ctypes.c_int64
    lib.gppe_taper_count.argtypes = [dptr, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_double, i64ptr]
    lib.gppe_taper_fill.restype = ctypes.c_int32
    lib.gppe_taper_fill.argtypes = [dptr, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double, i64ptr,
                                    i64ptr, dptr]
    lib.gppe_num_threads.restype = ctypes.c_int32
    lib.gppe_num_threads.argtypes = []
    _lib = lib
    return lib


def num_threads():
    """The OpenMP threads the builder runs on (builds the library)."""
    return int(load().gppe_num_threads())


def serves(nu, dimension):
    """True where the native builder applies: a closed-form nu and at most
    8 dimensions. Elsewhere the caller takes the blocked rule, as the
    reference does (that is its semantics, not a fallback for a
    failure)."""
    nu = float(nu)
    return ((nu in _CLOSED_FORM_NUS or nu >= _GAUSSIAN_NU_CUTOFF)
            and dimension <= _MAX_D)


def taper_csr(points_scaled, radius, nu):
    """Tapered Matern CSR ``(data, indices, indptr)`` (float64, int64,
    int64) of ``points_scaled`` (n, d), already divided by the correlation
    scale: every pair within the scaled ``radius`` (distance <= radius), its
    value k(distance; nu), columns sorted within each row. Returns None
    where :func:`serves` is false; builds the library at its first use and
    raises if that fails."""
    pts = np.ascontiguousarray(points_scaled, dtype=np.float64)
    if pts.ndim != 2:
        raise ValueError("points_scaled must be (n, d)")
    n, d = pts.shape
    if not serves(nu, d):
        return None
    lib = load()
    indptr = np.zeros(n + 1, dtype=np.int64)
    dptr, i64ptr = (ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_int64))
    p_pts = pts.ctypes.data_as(dptr)
    p_indptr = indptr.ctypes.data_as(i64ptr)
    nnz = lib.gppe_taper_count(p_pts, n, d, float(radius), p_indptr)
    if nnz < 0:
        raise RuntimeError(f"gppe_taper_count failed ({nnz})")
    indices = np.empty(nnz, dtype=np.int64)
    values = np.empty(nnz, dtype=np.float64)
    rc = lib.gppe_taper_fill(
        p_pts, n, d, float(radius), float(nu), p_indptr,
        indices.ctypes.data_as(i64ptr), values.ctypes.data_as(dptr))
    if rc != 0:
        raise RuntimeError(f"gppe_taper_fill failed ({rc})")
    return values, indices, indptr
