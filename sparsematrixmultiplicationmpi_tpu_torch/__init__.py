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
from .formats.windowed import WindowedPairs
from .io.generate import generate_fat_vector
from .io.mtx import read_matrix_market, write_matrix_market
from .ops.auto import auto_format, spmm_any
from .ops.oracle import spmm_coo, spmm_host_f64
from .utils.compare import are_matrices_equal, max_abs_error

__version__ = "0.1.0"

__all__ = [
    "CSR", "COO", "ELL", "BucketedELL", "BandedBlocks", "WindowedPairs",
    "generate_fat_vector", "read_matrix_market", "write_matrix_market",
    "auto_format", "spmm_any", "spmm_coo", "spmm_host_f64",
    "are_matrices_equal", "max_abs_error",
]
