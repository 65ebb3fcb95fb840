from .compare import are_matrices_equal, default_tolerance, max_abs_error
from .timing import AmortizedTiming, measure_amortized, time_fn

__all__ = [
    "are_matrices_equal", "default_tolerance", "max_abs_error",
    "AmortizedTiming", "measure_amortized", "time_fn",
]
