from . import generate
from .generate import generate_fat_vector
from .mtx import (
    read_matrix_market, read_matrix_market_numpy, write_matrix_market,
)

__all__ = [
    "generate", "generate_fat_vector",
    "read_matrix_market", "read_matrix_market_numpy", "write_matrix_market",
]
