from .auto import auto_format, gather_class_estimates, spmm_any
from .banded import spmm_banded
from .ell import spmm_bucketed, spmm_ell
from .oracle import spmm_coo, spmm_host_f64
from .windowed import spmm_windowed, windowed_t_chain

__all__ = [
    "auto_format", "gather_class_estimates", "spmm_any", "spmm_banded",
    "spmm_bucketed", "spmm_ell", "spmm_coo", "spmm_host_f64",
    "spmm_windowed", "windowed_t_chain",
]
