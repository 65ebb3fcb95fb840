"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled at first use for ``sm_90a``, one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library goes to ``build/kernels/`` at the root of
the checkout, its file name carrying a hash of all sources and the
flags, so an edited source is rebuilt and an unchanged set is loaded as
it is. A missing ``nvcc`` or a failed build raises with the compiler's
output; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import glob
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
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def _sources() -> list:
    """The kernel sources, ``csrc/*.cu``, in a fixed order."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _build(nvcc: str) -> str:
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    lib_path = os.path.join(BUILD_DIR,
                            f"libkernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        build_info.update(seconds=0.0, path=lib_path, ptxas="(cached)")
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    reports = [p.communicate()[0] for p in procs]
    try:
        for src, p, report in zip(srcs, procs, reports):
            if p.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed (exit {p.returncode}) on {src}:\n{report}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed (exit {link.returncode}):\n"
                f"{link.stderr}{link.stdout}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    build_info.update(seconds=seconds, path=lib_path,
                      ptxas="\n".join(r.strip() for r in reports))
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
                f"{CSRC_DIR}/*.cu and have no fallback")
        lib = ctypes.CDLL(_build(nvcc))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tmulti_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr,
                                      ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib.tmulti_launch.restype = i32
        lib.chunk_slabs_launch.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
        lib.chunk_slabs_launch.restype = i32
        lib.band_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                    i32, ptr]
        lib.band_launch.restype = i32
        lib.tmulti_phased_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr,
                                             ptr, ptr, i32, ptr, ptr, i32,
                                             i32, i32, i32, i32, ptr]
        lib.tmulti_phased_launch.restype = i32
        lib.natural_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                       i32, i32, i32, ptr]
        lib.natural_launch.restype = i32
        lib.natural_compact_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                               i32, ptr, ptr, i32, i32, i32,
                                               i32, i32, ptr]
        lib.natural_compact_launch.restype = i32
        lib.ell_gather_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                          ptr]
        lib.ell_gather_launch.restype = i32
        lib.ell_gather_bucketed_launch.argtypes = [ptr, i32, ptr, ptr, i32,
                                                   ptr]
        lib.ell_gather_bucketed_launch.restype = i32
        lib.error_string.argtypes = [i32]
        lib.error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load_library().error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
