"""Result comparison — the framework's correctness oracle contract.

Parity with the reference comparator ``Source Code/utils.cpp:38-63``:
elementwise **absolute** tolerance (``fabs(a-b) > tolerance``), dimension
mismatch => unequal, default tolerance 1e-6 (call sites
``main.cpp:184,227,270,386``). Because TPUs compute in f32/bf16 where the
reference used f64, a relative-tolerance mode is added (documented
divergence; SURVEY.md §7 "hard parts" (b)).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["are_matrices_equal", "max_abs_error", "default_tolerance"]

#: Reference tolerance (utils.cpp call sites use 1e-6).
DEFAULT_ABS_TOL = 1e-6


def default_tolerance(dtype) -> float:
    """Dtype-aware absolute tolerance: the reference's 1e-6 for f64;
    looser for the TPU-native low-precision dtypes. Takes a numpy or a
    torch dtype; ``torch.bfloat16`` (and the ``uint16`` bits that carry
    it on the host) is the bf16 tier."""
    if isinstance(dtype, torch.dtype):
        dtype = {torch.float64: np.float64,
                 torch.float32: np.float32}.get(dtype, np.float16)
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return DEFAULT_ABS_TOL
    if dtype == np.float32:
        # Relative, vs the f64 host oracle. A ~22-term f32 dot with operand
        # magnitudes ~100 carries ~1e-3 relative rounding noise (observed
        # 1.3e-3 on the cop20k-stats matrix); 5e-3 gives margin without
        # masking real defects.
        return 5e-3
    return 1e-1  # bf16 and below


def are_matrices_equal(a, b, tolerance: float = DEFAULT_ABS_TOL,
                       relative: bool = False,
                       condition_scale=None,
                       condition_tolerance: float | None = None) -> bool:
    """Reference-parity comparator (``utils.cpp:38-63``; the reference's
    absolute 1e-6 on f64 is the ``relative=False`` mode).

    ``relative=True`` scales the tolerance by ``max(|a|, |b|)`` elementwise
    (needed for f32/bf16 TPU results against an f64 oracle).

    ``condition_scale`` (optional, elementwise, same shape) additionally
    admits the standard forward-error bound for reordered floating-point
    accumulation: ``|sum a_i v_i - approx| <= gamma * sum |a_i v_i|``. A
    catastrophically cancelling row (e.g. a 2386-nnz powerlaw hub row
    summing +-5e3-magnitude terms to -1.19) is REQUIRED to lose relative
    accuracy in any low-precision block-reordered sum; judging it against
    ``|result|`` alone would flag numerically optimal kernels as wrong
    (first hit: the round-4 TPU sweep, powerlaw_100k k=12). Rows without
    cancellation have ``sum|terms| ~ |result|``, so strictness there is
    unchanged. Pass ``spmm_host_f64(|A|, |v|)`` for SpMM checks.

    ``condition_tolerance`` is the ``gamma`` applied to the condition
    term — TIGHTER than the plain relative ``tolerance`` (default
    ``tolerance / 10``), because the rigorous bound on the condition
    scale is per-term rounding (~n_terms * eps of the compute dtype —
    measured ~1.5e-4 worst-case for the split3 f32 path on 2.4k-term
    hub rows), not the end-to-end dtype tier. Admitting the full 5e-3
    f32 tier against ``sum|a_ij v_jk|`` could stamp correct=True on a
    defect localized to high-cancellation rows.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    diff = np.abs(a - b)
    if relative:
        scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
        ok = diff <= tolerance * scale
        if condition_scale is not None:
            cs = np.asarray(condition_scale, dtype=np.float64)
            if cs.shape != a.shape:
                return False
            if condition_tolerance is None:
                condition_tolerance = tolerance / 10.0
            ok |= diff <= condition_tolerance * cs
        return bool(np.all(ok))
    return bool(np.all(diff <= tolerance))


def max_abs_error(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b))) if a.size else 0.0
