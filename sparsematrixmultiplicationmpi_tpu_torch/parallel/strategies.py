"""SpMM execution strategies (port of
``sparsematrixmultiplicationmpi_tpu/parallel/strategies.py``, one-device
part).

A strategy places a matrix on a device (``prepare``) and multiplies
(``spmm``); ``chain_parts`` gives the ``(encode, body, decode)`` triple an
iterative consumer — and the amortized benchmark — chains, so one-time
transforms stay outside the repeated body. ``prepare`` takes an explicit
``torch.device`` where the JAX package takes a mesh. The multi-device
strategies (RowWise, ColumnWise, NonZeroElement, Library, the
halo-exchange ones) and ``Auto``'s mesh routing are not ported yet.
"""

from __future__ import annotations

import abc

import torch

from ..formats.matrix import CSR
from ..ops.oracle import spmm_coo

__all__ = ["Strategy", "Sequential", "Auto", "STRATEGIES", "get_strategy"]


class Strategy(abc.ABC):
    """An SpMM execution strategy on one device::

        operand = strategy.prepare(csr, device)
        out = strategy.spmm(operand, v)
    """

    name: str = "abstract"

    @abc.abstractmethod
    def prepare(self, csr: CSR, device):
        """Build the operand and move it to ``device``."""

    @abc.abstractmethod
    def spmm(self, operand, v: torch.Tensor) -> torch.Tensor:
        """SpMM of the prepared operand with an ``(n, k)`` fat vector."""

    def chain_parts(self, operand):
        """(encode, body, decode) for iterated use, each taking
        ``(x, operand)``; identity boundaries around ``spmm`` by
        default."""
        def enc(v, op):
            return v

        def body(vv, op):
            return self.spmm(op, vv)

        def dec(out, op):
            return out

        return enc, body, dec


class Sequential(Strategy):
    """Single-device COO oracle (the reference's sequential kernel,
    ``SparseMatrixFatVectorMultiply.cpp:11-31``)."""

    name = "sequential"

    def prepare(self, csr: CSR, device):
        return csr.to_coo().to(device)

    def spmm(self, operand, v: torch.Tensor) -> torch.Tensor:
        return spmm_coo(operand, v)


class Auto(Strategy):
    """Structure-adaptive path (the one ``chip_smoke.py`` drives):
    ``auto_format`` picks the format, the transposed-state windowed chain
    runs where it applies. ``format_kwargs`` go to ``auto_format`` (e.g.
    ``k_nominal``)."""

    name = "auto"

    def __init__(self, **format_kwargs):
        self.format_kwargs = format_kwargs

    def prepare(self, csr: CSR, device):
        from ..ops.auto import auto_format

        return auto_format(csr, **self.format_kwargs).to(device)

    def spmm(self, operand, v: torch.Tensor) -> torch.Tensor:
        from ..ops.auto import spmm_any

        return spmm_any(operand, v)

    def chain_parts(self, operand):
        from ..formats.windowed import WindowedPairs

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


STRATEGIES = {"sequential": Sequential, "auto": Auto}


def get_strategy(name: str, **kwargs) -> Strategy:
    try:
        return STRATEGIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}"
        ) from None
