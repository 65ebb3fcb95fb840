"""2-D (rows x k) sharded SpMM (port of
``sparsematrixmultiplicationmpi_tpu/parallel/grid2d.py``): the
reference's row-wise and column-wise decompositions composed on a 2-D
mesh (``make_mesh_2d``). Rank ``(i, j)`` owns the ``(m / p_r) x (k /
p_c)`` output tile of row block ``i`` and k-slice ``j``; the matrix is
replicated only along the columns axis, and each gather rides its own
axis group.
"""

from __future__ import annotations

from ..formats.matrix import CSR
from ..utils import collectives as coll
from .mesh import as_mesh
from .strategies import (
    STRATEGIES, HybridRowOperand, Strategy, _hybrid_local, _hybrid_partition,
    _pad_axis,
)

__all__ = ["Grid2D"]


class Grid2D(Strategy):
    """Rows x k 2-D sharding over a 2-axis mesh."""

    name = "grid2d"

    def __init__(self, width_align: int = 8):
        self.width_align = width_align

    @staticmethod
    def _check(mesh):
        if len(mesh.shape) != 2:
            raise ValueError(
                f"grid2d needs a 2-D mesh, got axes {mesh.axis_names}")
        return mesh

    def prepare(self, csr: CSR, mesh) -> HybridRowOperand:
        """Rank ``(i, j)``'s share: row block ``i`` of the hybrid row
        operand over ``p_r`` row shards (the tail nnz-sharded over the
        rows axis), the same for every ``j``."""
        mesh = self._check(as_mesh(mesh))
        shards = _hybrid_partition(csr, mesh.shape[0], self.width_align)
        return shards[mesh.coords[0]].to(mesh)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        mesh = operand.mesh
        k = v.shape[1]
        p_c, j = mesh.shape[1], mesh.coords[1]
        v = _pad_axis(v.to(mesh.device), 1, p_c)
        k_loc = v.shape[1] // p_c
        out = _hybrid_local(operand, v[:, j * k_loc:(j + 1) * k_loc],
                            mesh_axis="rows")
        if gather_result:
            return self.gather(operand, out, k)
        return out

    def gather(self, operand, out, k):
        mesh = operand.mesh
        out = coll.all_gather(out, mesh, axis=1, mesh_axis="cols")
        out = coll.all_gather(out, mesh, mesh_axis="rows")
        return out[: operand.shape[0], :k]


STRATEGIES["grid2d"] = Grid2D
