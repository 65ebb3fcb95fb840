"""The reference's parallel decompositions as strategies over a process
group (port of ``sparsematrixmultiplicationmpi_tpu/parallel/
strategies.py``).

=================  ==========================================  ====================
Strategy           Reference realization                       Here
=================  ==========================================  ====================
Sequential         ``SparseMatrixFatVectorMultiply.cpp:11-31``  one-device oracle
Row-wise           block rows + ``MPI_Gatherv``                 ELL row block per
                   (``...RowWise.cpp:26-50,85-87``)             rank, fat vector
                                                                replicated, optional
                                                                ``all_gather``
Column-wise        block k-columns + ``MPI_Gatherv``            fat-vector k-slice
                   (``...ColumnWise.cpp:25-48,82-84``)          per rank, matrix
                                                                replicated
Non-zero element   flat nnz ranges + ``MPI_Reduce(SUM)``        COO nnz range per
                   (``...NonZeroElement.cpp:24-39,88``)         rank; ``psum`` or
                                                                ``psum_scatter``
Library            PETSc ``MatMatMult`` (``main.cpp:345-348``)  ``torch.sparse.mm``
=================  ==========================================  ====================

A strategy places a matrix on a mesh (``prepare(csr, mesh)``: the rank's
share of it, on the rank's device) and multiplies (``spmm(operand, v,
mesh=None, *, gather_result=True)``). Every rank passes the whole fat
vector ``v`` (the reference broadcasts it from rank 0); with
``gather_result`` every rank gets the whole result, otherwise its own
shard (row block, or k-slice for ``ColumnWise``), which ``gather``
assembles. A distributed operand carries its mesh. A ``torch.device``
(or ``"cpu"`` / ``"cuda"``) where a mesh is expected is the one-device
mesh with no process group, so ``prepare(csr, device)`` works for every
strategy. Remainders are padded to a multiple of the rank count, as the
JAX package does (static shapes, one policy). The collectives go
through ``utils/collectives.py``, which counts them.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Literal, Optional, Tuple

import numpy as np
import torch

from ..formats.matrix import CSR, ELL, split_csr_by_width, to_tensor
from ..ops.ell import take_rows
from ..ops.oracle import spmm_coo
from ..utils import collectives as coll
from .mesh import Mesh, as_mesh

__all__ = [
    "Strategy", "Sequential", "Auto", "RowWise", "ColumnWise",
    "NonZeroElement", "Library", "HybridRowOperand", "STRATEGIES",
    "get_strategy",
]


def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """``x`` zero-padded along ``axis`` to a multiple of ``multiple``."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _placed(host, mesh: Mesh, fields):
    """A host operand's ``fields`` as tensors on the mesh's device, with
    the mesh recorded."""
    return dataclasses.replace(
        host, mesh=mesh,
        **{f: to_tensor(getattr(host, f), mesh.device) for f in fields})


class Strategy(abc.ABC):
    """A parallel SpMM execution strategy over a mesh of ranks::

        operand = strategy.prepare(csr, mesh)   # this rank's share
        out = strategy.spmm(operand, v)         # every rank, whole v
    """

    name: str = "abstract"

    @abc.abstractmethod
    def prepare(self, csr: CSR, mesh):
        """Place this rank's share of the matrix on its device (the
        ``MPI_Bcast`` / scatter analog)."""

    @abc.abstractmethod
    def spmm(self, operand, v: torch.Tensor, mesh=None, *,
             gather_result: bool = True) -> torch.Tensor:
        """SpMM with the whole ``(n, k)`` fat vector ``v``; ``mesh`` is
        the operand's own and may be left out."""

    def gather(self, operand, out: torch.Tensor, k: int) -> torch.Tensor:
        """The whole result from this rank's ``gather_result=False``
        output (``k`` the fat vector's width); identity where that output
        is already whole."""
        return out

    def chain_parts(self, operand, mesh=None, *,
                    gather_result: bool = True):
        """(encode, body, decode) for iterated use, each taking ``(x,
        operand)``: ``encode`` once, chain ``body``, ``decode`` once.
        Default: identity boundaries around ``spmm``; with
        ``gather_result=False`` the body leaves its result sharded and
        ``decode`` gathers it. Strategies whose operand carries a one-time
        transform (the RCM permutation of a windowed operand) override,
        so an iterative consumer pays the boundary transforms once."""
        width = {}

        def enc(v, op):
            width["k"] = v.shape[1]
            return v

        def body(vv, op):
            return self.spmm(op, vv, gather_result=gather_result)

        def dec(out, op):
            if gather_result:
                return out
            return self.gather(op, out, width["k"])

        return enc, body, dec


class Sequential(Strategy):
    """One-device COO oracle (the reference's sequential kernel,
    ``SparseMatrixFatVectorMultiply.cpp:11-31``), the baseline every
    other strategy is validated against."""

    name = "sequential"

    def prepare(self, csr: CSR, mesh):
        return csr.to_coo().to(as_mesh(mesh).device)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        return spmm_coo(operand, v.to(operand.values.device))


def _ell_width_cap(csr: CSR, width_align: int) -> int:
    """Padded-plane width cap: p99 of row lengths (or 2x mean), aligned,
    so one dense row cannot inflate the ELL planes to ``m x
    max_row_nnz``; overflow entries go to a COO tail."""
    lengths = csr.row_lengths()
    if not len(lengths) or csr.nnz == 0:
        return width_align
    p99 = float(np.percentile(lengths, 99))
    mean2 = 2.0 * csr.nnz / max(csr.shape[0], 1)
    cap = int(max(width_align, p99, mean2))
    return -(-cap // width_align) * width_align


@dataclasses.dataclass(frozen=True)
class HybridRowOperand:
    """One rank's ELL row block (``m_padded / p`` rows) plus its range of
    the nnz-sharded COO tail (HYB split; empty when no row overflows the
    width cap). ``mesh`` is None on a host partition."""

    cols: object            # (m_padded / p, W) int32
    vals: object            # (m_padded / p, W)
    tail_values: object     # (t / p,)
    tail_rows: object       # (t / p,) int32, global rows
    tail_cols: object       # (t / p,) int32
    shape: Tuple[int, int]
    m_padded: int
    mesh: Optional[Mesh] = None

    _ARRAYS = ("cols", "vals", "tail_values", "tail_rows", "tail_cols")

    def to(self, mesh) -> "HybridRowOperand":
        return _placed(self, as_mesh(mesh), self._ARRAYS)


def _hybrid_partition(csr: CSR, p: int, width_align: int,
                      max_width: Optional[int] = None):
    """The row-sharded hybrid operand of every rank, on the host."""
    cap = max_width or _ell_width_cap(csr, width_align)
    head, tail = split_csr_by_width(csr, cap)
    ell = ELL.from_csr(head, row_align=8 * p, width_align=width_align)
    if tail is None:
        tv = np.zeros((0,), np.asarray(ell.vals).dtype)
        tr = tc = np.zeros((0,), np.int32)
    else:
        tail = tail.pad_to(-(-tail.nnz // p) * p)
        tv, tr, tc = tail.values, tail.row_indices, tail.col_indices
    m_loc, t_loc = ell.m_padded // p, len(tv) // p
    return [HybridRowOperand(
        cols=ell.cols[r * m_loc:(r + 1) * m_loc],
        vals=ell.vals[r * m_loc:(r + 1) * m_loc],
        tail_values=tv[r * t_loc:(r + 1) * t_loc],
        tail_rows=tr[r * t_loc:(r + 1) * t_loc],
        tail_cols=tc[r * t_loc:(r + 1) * t_loc],
        shape=csr.shape, m_padded=ell.m_padded) for r in range(p)]


def _hybrid_local(op: HybridRowOperand, v: torch.Tensor,
                  mesh_axis: Optional[str] = None) -> torch.Tensor:
    """The rank's rows of ``A v``: its ELL block, plus the tail's partial
    over the full height reduce-scattered onto the row shards."""
    k = v.shape[1]
    gathered = take_rows(v, op.cols).reshape(*op.cols.shape, k)
    out = (op.vals[:, :, None].to(v.dtype) * gathered).sum(dim=1)
    if op.tail_values.shape[0]:
        prods = op.tail_values[:, None].to(v.dtype) * take_rows(
            v, op.tail_cols)
        partial = v.new_zeros((op.m_padded, k)).index_add_(
            0, op.tail_rows, prods)
        out = out + coll.psum_scatter(partial, op.mesh, mesh_axis=mesh_axis)
    return out


class RowWise(Strategy):
    """Output rows sharded over the mesh (reference
    ``...RowWise.cpp:26-50``): each rank owns an ELL row block, the fat
    vector is replicated, and the result is optionally ``all_gather``-ed
    (the ``MPI_Gatherv`` analog, ``RowWise.cpp:85-87``). Rows beyond the
    ELL width cap spill into an nnz-sharded COO tail combined by
    ``psum_scatter`` onto the row shards."""

    name = "row_wise"

    def __init__(self, width_align: int = 8, max_width: int | None = None):
        self.width_align = width_align
        self.max_width = max_width

    def partition(self, csr: CSR, p: int) -> list:
        """Every rank's ``HybridRowOperand``, on the host."""
        return _hybrid_partition(csr, p, self.width_align, self.max_width)

    def prepare(self, csr: CSR, mesh) -> HybridRowOperand:
        mesh = as_mesh(mesh)
        return self.partition(csr, mesh.size)[mesh.rank].to(mesh)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        out = _hybrid_local(operand, v.to(operand.mesh.device))
        if gather_result:
            return coll.all_gather(out, operand.mesh)[: operand.shape[0]]
        return out

    def gather(self, operand, out, k):
        return coll.all_gather(out, operand.mesh)[: operand.shape[0]]


@dataclasses.dataclass(frozen=True)
class ReplicatedOperand:
    """A whole-matrix operand on every rank (``ColumnWise``)."""

    operand: object
    shape: Tuple[int, int]
    mesh: Mesh


class ColumnWise(Strategy):
    """Fat-vector k-columns sharded (reference ``...ColumnWise.cpp:25-48``,
    which partitions the *output* columns): every rank runs the best
    one-device format (``auto_format``) on the whole matrix for its
    k-slice, through ``spmm_any`` (on the card the format's kernels).
    Degenerates when ``p > k``, as the reference observes."""

    name = "column_wise"

    def __init__(self, **format_kwargs):
        self.format_kwargs = format_kwargs

    def prepare(self, csr: CSR, mesh) -> ReplicatedOperand:
        from ..ops.auto import auto_format

        mesh = as_mesh(mesh)
        return ReplicatedOperand(
            auto_format(csr, device=mesh.device,
                        **self.format_kwargs).to(mesh.device),
            csr.shape, mesh)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        from ..ops.auto import spmm_any

        mesh = operand.mesh
        k = v.shape[1]
        v = _pad_axis(v.to(mesh.device), 1, mesh.size)
        k_loc = v.shape[1] // mesh.size
        out = spmm_any(operand.operand, v[:, mesh.rank * k_loc:(
            mesh.rank + 1) * k_loc].contiguous())
        if gather_result:
            return self.gather(operand, out, k)
        return out

    def gather(self, operand, out, k):
        return coll.all_gather(out, operand.mesh, axis=1)[:, :k]


@dataclasses.dataclass(frozen=True)
class NnzOperand:
    """One rank's range of the (zero-padded) COO nonzeros."""

    values: object
    row_indices: object
    col_indices: object
    shape: Tuple[int, int]
    mesh: Optional[Mesh] = None

    def to(self, mesh) -> "NnzOperand":
        return _placed(self, as_mesh(mesh),
                       ("values", "row_indices", "col_indices"))


class NonZeroElement(Strategy):
    """Flat nnz-range sharding (reference ``...NonZeroElement.cpp:24-39``):
    balanced work whatever the row-length skew. Each rank segment-sums
    its COO range into a full-height partial; the partials are combined
    by ``psum`` (the ``MPI_Reduce(SUM)`` analog, ``NonZeroElement.cpp:
    88``) or, with ``reduce="scatter"`` and the result left sharded, by
    ``psum_scatter`` (1/p of the traffic per link)."""

    name = "nnz"

    def __init__(self, reduce: Literal["psum", "scatter"] = "psum"):
        self.reduce = reduce

    def partition(self, csr: CSR, p: int) -> list:
        coo = csr.to_coo()
        coo = coo.pad_to(-(-max(coo.nnz, 1) // p) * p)
        n = coo.nnz // p
        return [NnzOperand(coo.values[r * n:(r + 1) * n],
                           coo.row_indices[r * n:(r + 1) * n],
                           coo.col_indices[r * n:(r + 1) * n], csr.shape)
                for r in range(p)]

    def prepare(self, csr: CSR, mesh) -> NnzOperand:
        mesh = as_mesh(mesh)
        return self.partition(csr, mesh.size)[mesh.rank].to(mesh)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        mesh = operand.mesh
        v = v.to(mesh.device)
        m = operand.shape[0]
        m_padded = -(-m // mesh.size) * mesh.size
        prods = operand.values[:, None].to(v.dtype) * take_rows(
            v, operand.col_indices)
        partial = v.new_zeros((m_padded, v.shape[1])).index_add_(
            0, operand.row_indices, prods)
        if self.reduce == "scatter" and not gather_result:
            return coll.psum_scatter(partial, mesh)
        return coll.psum(partial, mesh)[:m]

    def gather(self, operand, out, k):
        if self.reduce == "scatter":
            return coll.all_gather(out, operand.mesh)[: operand.shape[0]]
        return out


class Library(Strategy):
    """Vendor-library yardstick: ``torch.sparse.mm`` on a CSR tensor
    (cuSPARSE on the card), the PETSc ``MatMatMult`` analog
    (``main.cpp:345-348``) and the JAX package's BCOO. Each rank holds
    the whole matrix and computes the whole product, so the result is
    whole however ``gather_result`` is set; no collective."""

    name = "library"

    def prepare(self, csr: CSR, mesh):
        from ..ops.library import to_torch_sparse

        return to_torch_sparse(csr, device=as_mesh(mesh).device)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        from ..ops.library import spmm_library

        return spmm_library(operand, v.to(operand.device))


def _row_strategy_of(operand) -> Optional[Strategy]:
    """The distributed strategy that multiplies a mesh-routed operand."""
    from .banded_strategy import BandedRowOperand, BandedRowWise
    from .windowed_strategy import WindowedRowOperand, WindowedRowWise

    if isinstance(operand, BandedRowOperand):
        return BandedRowWise()
    if isinstance(operand, WindowedRowOperand):
        return WindowedRowWise()
    if isinstance(operand, HybridRowOperand):
        return RowWise()
    return None


class Auto(Strategy):
    """Structure- and mesh-adaptive path.

    One device: ``auto_format`` picks the format (windowed tiles where
    clustering supports them, else the cheaper gather format; pass
    ``k_nominal=<width>``), and the transposed-state windowed chain runs
    where it applies. A mesh of several ranks: the halo-exchange band
    strategy, the row-sharded windowed strategy or the hybrid row-wise
    strategy, picked by the single-chip cost model (``_mesh_route``).
    Both price with the mesh device's cost table
    (``formats/cost.py::cost_table_for``), or with ``cost_table=`` when
    given. ``spmm`` and ``chain_parts`` dispatch on the prepared
    operand's type."""

    name = "auto"

    def __init__(self, **format_kwargs):
        self.format_kwargs = format_kwargs

    def prepare(self, csr: CSR, mesh):
        from ..ops.auto import auto_format

        mesh = as_mesh(mesh)
        if mesh.size > 1:
            return self._mesh_route(csr, mesh.device).prepare(csr, mesh)
        return auto_format(csr, device=mesh.device,
                           **self.format_kwargs).to(mesh.device)

    def _mesh_route(self, csr: CSR, device=None) -> Strategy:
        """The row-sharded strategy the single-chip cost model picks, with
        the table of ``device`` (the reference's without one: the JAX
        package's ``Auto._mesh_route``, same estimates, same pick): every
        candidate shards output rows, so its compute estimate divides
        ~uniformly by the rank count and the argmin does not depend on
        it; the band and windowed strategies also move only O(halo) bytes
        where the hybrid row strategy's ``psum_scatter`` moves O(m*k)."""
        from ..formats.banded import BandedBlocks
        from ..formats.cost import cost_table_for
        from ..formats.windowed import _search_tilings
        from ..ops.auto import gather_class_estimates

        table = cost_table_for(device, self.format_kwargs.get("cost_table"))
        k_nominal = self.format_kwargs.get("k_nominal", 32)
        gests = gather_class_estimates(csr, k_nominal=k_nominal,
                                       cost_table=table)
        best_gather = min(e for e, _ in gests.values())
        m, n = csr.shape
        banded_est = float("inf")
        if m == n:  # the halo-exchange band strategy assumes square
            bb = BandedBlocks.from_csr(csr, k_nominal=k_nominal,
                                       cost_table=table)
            if bb is not None:
                banded_est = bb.est_seconds
        windowed_est = float("inf")
        coo = csr.to_coo()
        found = _search_tilings(
            csr, np.asarray(coo.row_indices).astype(np.int64),
            np.asarray(coo.col_indices).astype(np.int64),
            k_nominal=k_nominal, gather_baseline_s=best_gather,
            cost_table=table)
        if found is not None:
            windowed_est = found[0]
        if banded_est <= min(windowed_est, best_gather):
            from .banded_strategy import BandedRowWise

            return BandedRowWise(cost_table=table)
        if windowed_est < best_gather:
            from .windowed_strategy import WindowedRowWise

            return WindowedRowWise(cost_table=table)
        return RowWise()

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        strategy = _row_strategy_of(operand)
        if strategy is not None:
            return strategy.spmm(operand, v, gather_result=gather_result)
        from ..ops.auto import spmm_any

        return spmm_any(operand, v)

    def gather(self, operand, out, k):
        strategy = _row_strategy_of(operand)
        return out if strategy is None else strategy.gather(operand, out, k)

    def chain_parts(self, operand, mesh=None, *, gather_result=True):
        from ..formats.windowed import WindowedPairs

        strategy = _row_strategy_of(operand)
        if strategy is not None:
            return strategy.chain_parts(operand,
                                        gather_result=gather_result)
        if not isinstance(operand, WindowedPairs):
            return super().chain_parts(operand)
        from ..ops.windowed import windowed_t_chain

        # Transposed-state chain where it applies (spill-free square U>2
        # formats, k % 8 == 0): the state is the 3-D slab array, so body
        # and dec dispatch on its rank. Each width's chain is built once,
        # off the timed body.
        chains = {}

        def chain(k):
            if k not in chains:
                chains[k] = windowed_t_chain(operand, k)
            return chains[k]

        def enc(v, op):
            if v.shape[1] % 8 == 0:
                ch = chain(v.shape[1])
                if ch is not None:
                    return ch[0](v, op)
            return op.encode(v)

        def _chain_or_raise(k):
            ch = chain(k)
            if ch is None:
                raise RuntimeError(
                    "windowed_t_chain gate failed for a 3-D chain state: the "
                    "operand no longer supports the transposed chain (check "
                    "supports_transposed_chain / k alignment / block_rows % "
                    "128 on this device)")
            return ch

        def body(x, op):
            if x.dim() == 3:
                return _chain_or_raise(x.shape[1])[1](x, op)
            return op.iterate(x)

        def dec(x, op):
            if x.dim() == 3:
                return _chain_or_raise(x.shape[1])[2](x, op)
            return op.decode(x)

        return enc, body, dec


STRATEGIES = {
    "sequential": Sequential,
    "auto": Auto,
    "row": RowWise,
    "row_wise": RowWise,
    "column": ColumnWise,
    "column_wise": ColumnWise,
    "nnz": NonZeroElement,
    "non_zero_element": NonZeroElement,
    "library": Library,
}


def get_strategy(name: str, **kwargs) -> Strategy:
    try:
        return STRATEGIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}"
        ) from None
