"""Build and load the port's hand-written CUDA kernels.

``csrc/windowed_kernels.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. The library goes to ``build/kernels/`` at the root of the
checkout, its file name carrying a hash of the source, so an edited
source is rebuilt and an unchanged one is loaded as it is. A missing
``nvcc`` or a failed build raises with the compiler's output; nothing
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

__all__ = ["KernelBuildError", "load_library", "build_info", "find_nvcc",
           "check_launch"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "windowed_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the last build of this process did: seconds, the library path
#: and ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory and
#: spills of each kernel). Empty until ``load_library`` has run.
build_info: dict = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the kernel source."""


def find_nvcc() -> Optional[str]:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    return None


def _build(nvcc: str) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"libwindowed_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        build_info.update(seconds=0.0, path=lib_path, ptxas="(cached)")
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed (exit {proc.returncode}) on {SOURCE}:\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib_path)
    build_info.update(seconds=seconds, path=lib_path,
                      ptxas=(proc.stderr + proc.stdout).strip())
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises
    ``KernelBuildError`` when ``nvcc`` is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                " the CUDA kernels of this package are built from "
                f"{SOURCE} and have no fallback")
        lib = ctypes.CDLL(_build(nvcc))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tmulti_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                      i32, i32, i32, ptr]
        lib.tmulti_launch.restype = i32
        lib.chunk_slabs_launch.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
        lib.chunk_slabs_launch.restype = i32
        lib.error_string.argtypes = [i32]
        lib.error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load_library().error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
