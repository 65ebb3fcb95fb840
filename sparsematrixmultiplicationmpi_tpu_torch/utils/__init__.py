from .compare import are_matrices_equal, default_tolerance, max_abs_error
from .profiling import annotate, comm_comp_split, trace
from .timing import (
    AmortizedTiming, PhaseTimer, Timing, measure_amortized, time_fn,
    time_fn_amortized,
)

__all__ = [
    "are_matrices_equal", "default_tolerance", "max_abs_error",
    "annotate", "comm_comp_split", "trace",
    "PhaseTimer", "Timing", "time_fn", "time_fn_amortized",
    "AmortizedTiming", "measure_amortized",
]
