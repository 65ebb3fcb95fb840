"""The operator a configuration names, worked out from the seed in float64.

A configuration file (``benchmark/configs/<name>.json``) names its
stand-in ``generator``, a ``scale`` and an ``operator`` normalisation:

* ``sym_normalized_abs``: ``D^-1/2 |A| D^-1/2`` with ``D`` the row sums
  of ``|A|``, the propagation operator of SGC/GCN; its spectral radius is
  1, so a chain that feeds its output back neither overflows nor
  underflows.
* ``column_stochastic_abs``: ``|A|`` with each column divided by its sum
  (an empty column stays empty), the PageRank operator.

A name in neither ``generate.py::GENERATORS`` nor ``NORMALISATIONS`` is
a file of its own, loaded by its path: ``generators/<generator>.py``,
whose ``generate(seed, dtype, scale) -> Csr`` has the signature of the
generators in ``GENERATORS``, and ``normalisations/<operator>.py``, whose
``normalise(a: Csr) -> Csr`` returns float64 values on ``a``'s pattern.
So a configuration brings its stand-in and its operator as new files.

The stand-in is one matrix, as the published one is: its generator runs
at the configuration's fixed ``pattern_seed``. A run's seed renumbers its
nodes (``relabel``: ``permutation``, a random order, for a stand-in that
is in random order already; ``cyclic_shift``, ``i -> (i + s) mod n``, for
one whose numbering carries locality), so every seed gets the same
matrix, and the same work, in another order. The count of PageRank
iterations, for one, depends on the graph: over fresh graphs of the
amazon0302 stand-in it ran from 24 to 58.
"""

from __future__ import annotations

import importlib.util
import os
import re

import numpy as np
import scipy.sparse as sp

from .generate import GENERATORS, Csr

__all__ = ["NORMALISATIONS", "GENERATOR_DIR", "NORMALISATION_DIR",
           "find_generator", "find_normalisation", "operator", "as_scipy"]

_HERE = os.path.dirname(os.path.abspath(__file__))
#: Where a generator or a normalisation that the dicts lack is looked for.
GENERATOR_DIR = os.path.join(_HERE, "generators")
NORMALISATION_DIR = os.path.join(_HERE, "normalisations")
#: A name found as a file: a plain identifier, so no separator and no dot,
#: that starts with a letter (a file whose name starts with ``_`` is a
#: helper of another, and ``__init__`` is the package's).
_FILE_NAME = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


def _sym_normalized_abs(a: Csr) -> Csr:
    vals = np.abs(a.values.astype(np.float64))
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.row_ptr))
    deg = np.bincount(rows, weights=vals, minlength=a.shape[0])
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.where(deg > 0, deg, 1.0)), 0.0)
    return a._replace(values=vals * inv[rows] * inv[a.col_indices])


def _column_stochastic_abs(a: Csr) -> Csr:
    vals = np.abs(a.values.astype(np.float64))
    colsum = np.bincount(a.col_indices, weights=vals, minlength=a.shape[1])
    inv = np.where(colsum > 0, 1.0 / np.where(colsum > 0, colsum, 1.0), 0.0)
    return a._replace(values=vals * inv[a.col_indices])


NORMALISATIONS = {"sym_normalized_abs": _sym_normalized_abs,
                  "column_stochastic_abs": _column_stochastic_abs}


def _by_name(kind: str, name, table: dict, table_name: str,
             directory: str, attr: str):
    """``table[name]``, or else ``attr`` of ``<directory>/<name>.py``,
    loaded by its path as ``core/cells.py::load_reader`` loads a reader."""
    if name in table:
        return table[name]
    known = ", ".join(sorted(table))
    if not isinstance(name, str) or not _FILE_NAME.match(name):
        raise ValueError(
            f"{kind} {name!r} is not in {table_name} ({known}) and is not a "
            f"plain identifier that starts with a letter, so no file "
            f"<name>.py under {directory} is looked for")
    path = os.path.join(directory, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown {kind} {name!r}: not in {table_name} "
                         f"({known}), and no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.reference.{os.path.basename(directory)}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def find_generator(name: str):
    """The stand-in generator a configuration names: ``generate(seed,
    dtype, scale) -> Csr``."""
    return _by_name("generator", name, GENERATORS,
                    "reference/generate.py::GENERATORS", GENERATOR_DIR,
                    "generate")


def find_normalisation(name: str):
    """The operator normalisation a configuration names: ``normalise(a)
    -> Csr``, float64 values on ``a``'s pattern."""
    return _by_name("operator", name, NORMALISATIONS,
                    "reference/operators.py::NORMALISATIONS",
                    NORMALISATION_DIR, "normalise")


def relabel(a: Csr, how: str, seed: int) -> Csr:
    """``a`` with node ``i`` renumbered ``p[i]`` (rows and columns alike),
    ``p`` drawn from ``seed``."""
    n = a.shape[0]
    rng = np.random.default_rng([seed, 3])
    if how == "permutation":
        p = rng.permutation(n)
    elif how == "cyclic_shift":
        p = (np.arange(n) + rng.integers(n)) % n
    else:
        raise ValueError(f"unknown relabel {how!r}")
    rows = p[np.repeat(np.arange(n), np.diff(a.row_ptr))]
    cols = p[a.col_indices]
    order = np.argsort(rows * np.int64(n) + cols, kind="stable")
    row_ptr = np.cumsum(np.bincount(rows + 1, minlength=n + 1)[: n + 1])
    return Csr(a.values[order], cols[order].astype(np.int32),
               row_ptr.astype(np.int32), a.shape)


def operator(config: dict, seed: int) -> Csr:
    """The configuration's operator for a run's ``seed``, float64 values."""
    gen = find_generator(config["generator"])
    raw = gen(seed=config["pattern_seed"], dtype=np.float64,
              scale=config.get("scale", 1.0))
    op = find_normalisation(config["operator"])(raw)
    if (op.values.dtype != np.float64 or op.shape != raw.shape
            or op.nnz != raw.nnz
            or not np.array_equal(op.row_ptr, raw.row_ptr)
            or not np.array_equal(op.col_indices, raw.col_indices)):
        raise ValueError(f"operator {config['operator']!r} must give float64 "
                         f"values on the generator's pattern")
    return relabel(op, config["relabel"], seed)


def as_scipy(a: Csr) -> sp.csr_matrix:
    return sp.csr_matrix((a.values, a.col_indices, a.row_ptr), shape=a.shape)
