"""ctypes binding for the native f32 -> bf16 hi|lo splitter (port of
``sparsematrixmultiplicationmpi_tpu/formats/native_split.py``).

The repository's host C++ ``native/tilesplit.cpp`` does the same
round-to-nearest-even conversion as torch's f32 -> bf16 cast, on every
core; it is built and loaded by ``io/native.py::load_native``. The
windowed build (``formats/windowed.py::_split_planes``) keeps torch's
cast, which every machine has, with each NaN half rewritten to
ml_dtypes' bits; this binding is the JAX package's function, kept for
parity.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..io.native import load_native

__all__ = ["available", "split_bf16_hilo_native"]


def _load() -> Optional[ctypes.CDLL]:
    lib = load_native("tilesplit")
    if lib is not None:
        lib.split_bf16_hilo.restype = None
        lib.split_bf16_hilo.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
    return lib


def available() -> bool:
    return _load() is not None


def split_bf16_hilo_native(tiles: np.ndarray,
                           n_threads: int = 0) -> Optional[np.ndarray]:
    """``(..., C) f32 -> (..., 2C)`` lane-packed ``hi|lo`` split as
    ``uint16`` bf16 bits, or None when the native library is not there.
    Bit for bit ``_split_planes`` (``hi = bf16(x)``, ``lo = bf16(x -
    hi)``) on every element but a NaN with a payload: the native split
    keeps a NaN's sign and payload, ``_split_planes`` writes ``0x7fc0``
    with the sign, as ml_dtypes does."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(tiles, dtype=np.float32)
    cols = src.shape[-1]
    rows = src.size // max(cols, 1)
    out = np.empty(src.shape[:-1] + (2 * cols,), dtype=np.uint16)
    if src.size:
        lib.split_bf16_hilo(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            rows, cols, n_threads)
    return out
