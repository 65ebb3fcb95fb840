from .auto import auto_format, gather_class_estimates, spmm, spmm_any
from .autodiff import make_spmm, make_symmetric_spmm, transpose_csr
from .banded import spmm_banded
from .ell import spmm_bucketed, spmm_ell
from .library import spmm_library, to_torch_sparse
from .oracle import spmm_coo, spmm_dense, spmm_host_f64, spmm_sequential
from .sddmm import sddmm, sddmm_coo
from .windowed import spmm_windowed, windowed_t_chain

__all__ = [
    "auto_format", "spmm", "spmm_any",
    "make_spmm", "make_symmetric_spmm", "transpose_csr",
    "spmm_banded", "spmm_bucketed", "spmm_ell",
    "spmm_library", "to_torch_sparse",
    "spmm_coo", "spmm_dense", "spmm_host_f64", "spmm_sequential",
    "sddmm", "sddmm_coo",
    "gather_class_estimates", "spmm_windowed", "windowed_t_chain",
]
