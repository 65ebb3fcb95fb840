from .compare import are_matrices_equal, default_tolerance, max_abs_error
from .timing import (
    AmortizedTiming, PhaseTimer, Timing, measure_amortized, time_fn,
    time_fn_amortized,
)

__all__ = [
    "are_matrices_equal", "default_tolerance", "max_abs_error",
    "AmortizedTiming", "PhaseTimer", "Timing", "measure_amortized",
    "time_fn", "time_fn_amortized",
]
