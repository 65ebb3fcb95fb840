from .mesh import (
    AXIS, Mesh, as_mesh, initialize_distributed, make_mesh, make_mesh_2d,
)
from .strategies import (
    STRATEGIES, Auto, ColumnWise, Library, NonZeroElement, RowWise,
    Sequential, Strategy, get_strategy,
)
from .banded_strategy import BandedRowWise
from .grid2d import Grid2D
from .windowed_strategy import WindowedRowWise
from .launch import run_ranks

__all__ = [
    "AXIS", "Mesh", "as_mesh", "initialize_distributed", "make_mesh",
    "make_mesh_2d", "run_ranks",
    "STRATEGIES", "Auto", "BandedRowWise", "WindowedRowWise", "ColumnWise",
    "Grid2D", "Library", "NonZeroElement", "RowWise", "Sequential",
    "Strategy", "get_strategy",
]
