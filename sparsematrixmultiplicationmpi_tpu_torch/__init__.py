"""PyTorch + CUDA port of the sparse matrix x fat-vector multiplication
framework (``sparsematrixmultiplicationmpi_tpu``).

Host-side builders are numpy and bit-identical to the JAX package; device
code is PyTorch, with every Pallas kernel of the JAX package written by
hand for Hopper (``csrc/*.cu``, built with ``nvcc`` at first use). A CPU
tensor takes each kernel's plain PyTorch version, a CUDA tensor the
kernel. The package never imports JAX.
"""

from .formats.banded import BandedBlocks
from .formats.matrix import COO, CSR, ELL, BucketedELL
from .formats.serialize import load_format, save_format
from .formats.windowed import WindowedPairs
from .io.generate import generate_fat_vector
from .io.mtx import read_matrix_market, write_matrix_market
from .ops.auto import auto_format, spmm_any
from .ops.autodiff import make_spmm, make_symmetric_spmm
from .ops.banded import spmm_banded
from .ops.ell import spmm_bucketed, spmm_ell
from .ops.library import spmm_library, to_torch_sparse
from .ops.oracle import spmm_coo, spmm_dense, spmm_host_f64, spmm_sequential
from .utils.compare import are_matrices_equal, max_abs_error
from .utils.timing import PhaseTimer, time_fn, time_fn_amortized

__version__ = "0.1.0"

__all__ = [
    "CSR", "COO", "ELL", "BucketedELL", "BandedBlocks",
    "load_format", "save_format",
    "read_matrix_market", "write_matrix_market", "generate_fat_vector",
    "auto_format", "spmm_any", "make_spmm", "make_symmetric_spmm",
    "spmm_host_f64", "spmm_sequential", "spmm_coo", "spmm_dense",
    "spmm_ell", "spmm_bucketed", "spmm_banded",
    "to_torch_sparse", "spmm_library",
    "are_matrices_equal", "max_abs_error", "PhaseTimer", "time_fn",
    "time_fn_amortized", "WindowedPairs",
]
