"""ctypes binding for the native Matrix Market parser (port of
``sparsematrixmultiplicationmpi_tpu/io/native.py``).

The parser is the repository's host C++ ``native/mmio.cpp``
(multithreaded, behind a C interface). ``build_native`` compiles a
``native/*.cpp`` source with ``g++`` at first use into ``build/native/``
at the root of the checkout, the file name carrying a hash of the source
and the flags, written to a temporary name and renamed into place, so
processes that build at once never load a half-written library and an
edited source is rebuilt. Without a compiler or a source nothing is
built, ``available()`` is False and ``io/mtx.py`` reads with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ..formats.matrix import CSR
from .mtx import _parse_header, expand_and_build_csr

__all__ = ["available", "build_native", "load_native",
           "read_matrix_market_native", "native_dir"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_SRC_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs: dict = {}


def native_dir() -> str:
    """The repository's ``native/`` directory of host C++ sources."""
    return NATIVE_SRC_DIR


def build_native(name: str) -> Optional[str]:
    """Path of the shared library built from ``native/<name>.cpp``, built
    now unless a build of this source is there; None when the source or
    ``g++`` is missing or the build fails."""
    src = os.path.join(NATIVE_SRC_DIR, f"{name}.cpp")
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(src):
        return None
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return lib


class _MMResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("declared_nnz", ctypes.c_int64),
        ("symmetric", ctypes.c_int32),
        ("pattern", ctypes.c_int32),
        ("ok", ctypes.c_int32),
        ("row_idx", ctypes.POINTER(ctypes.c_int32)),
        ("col_idx", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char * 256),
    ]


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """The library of ``native/<name>.cpp``, built and loaded once a
    process; None when it cannot be built or loaded."""
    with _lock:
        if name not in _libs:
            path = build_native(name)
            try:
                _libs[name] = None if path is None else ctypes.CDLL(path)
            except OSError:
                _libs[name] = None
        return _libs[name]


def _load() -> Optional[ctypes.CDLL]:
    lib = load_native("mmio")
    if lib is not None:
        lib.mm_read.restype = ctypes.POINTER(_MMResult)
        lib.mm_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.mm_free.restype = None
        lib.mm_free.argtypes = [ctypes.POINTER(_MMResult)]
    return lib


def available() -> bool:
    """Whether the native parser is built (building it now if it can)."""
    return _load() is not None


def read_matrix_market_native(path: str, dtype=None,
                              n_threads: int = 0) -> CSR:
    """Parse ``.mtx`` with the native library (``n_threads = 0``: one a
    core); the CSR build is ``io/mtx.py``'s numpy. Raises what the numpy
    reader raises: ``FileNotFoundError``, ``ValueError``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser not available")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Unable to open file: {path}")
    # The header's semantics (complex refused, skew-symmetric sign) are
    # the numpy reader's, so both readers behave alike.
    _, _, skew, _, _, _, _ = _parse_header(path)

    res = lib.mm_read(path.encode(), n_threads)
    try:
        r = res.contents
        if not r.ok:
            msg = r.error.decode(errors="replace")
            if "Unable to open" in msg:
                raise FileNotFoundError(msg)
            raise ValueError(msg)
        nnz = int(r.nnz)
        rows = np.ctypeslib.as_array(r.row_idx, shape=(nnz,)).astype(
            np.int64, copy=True)
        cols = np.ctypeslib.as_array(r.col_idx, shape=(nnz,)).astype(
            np.int64, copy=True)
        values = np.ctypeslib.as_array(r.values, shape=(nnz,)).copy()
        m, n = int(r.rows), int(r.cols)
        symmetric = bool(r.symmetric)
        pattern = bool(r.pattern)
    finally:
        lib.mm_free(res)

    if pattern:
        values = np.ones(nnz, dtype=np.float64)
    return expand_and_build_csr(rows, cols, values, m, n, symmetric, dtype,
                                mirror_sign=-1.0 if skew else 1.0)
