"""Format persistence: save and load prepared sparse formats (port of
``sparsematrixmultiplicationmpi_tpu/formats/serialize.py``).

A container, an expensive ``BandedBlocks`` or ``BucketedELL`` layout
included, goes to one ``.npz`` in the JAX package's own layout, so a
file written by either package loads in the other: its arrays are
``leaf_<i>`` in the order of JAX's ``tree_flatten`` (data fields in
declaration order, a tuple of containers element by element, a ``None``
child contributing no leaf), and ``__meta__`` is the JSON of ``class``,
``treedef`` (each container's class, static fields and children) and
``n_leaves``. The port's containers carry no field metadata, so the
static fields of each class are listed here, as the JAX package marks
them (``formats/matrix.py:59-81``, ``formats/banded.py:59-65``).

bfloat16 leaves, which the port holds as ``uint16`` bits, are stored as
two-byte void (``|V2``), what ``np.savez`` writes for the JAX package's
ml_dtypes bfloat16 arrays; a ``|V2`` leaf loads as ``uint16`` bits.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .banded import BandedBlocks
from .matrix import BucketedELL, COO, CSR, ELL

__all__ = ["save_format", "load_format"]

_CLASSES = {c.__name__: c for c in (CSR, COO, ELL, BucketedELL, BandedBlocks)}
#: Each class's static (non-array) fields, in declaration order.
_STATIC = {"CSR": ("shape",), "COO": ("shape",), "ELL": ("shape",),
           "BucketedELL": ("shape",),
           "BandedBlocks": ("shape", "block_rows", "est_seconds")}


def _plain(v):
    """A static value as JSON holds it: tuples as lists, numpy scalars as
    Python numbers."""
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def _treedef_spec(obj):
    """Class, static fields and container children of ``obj``."""
    name = type(obj).__name__
    spec = {"class": name,
            "static": {f: _plain(getattr(obj, f)) for f in _STATIC[name]},
            "children": {}}
    for f in dataclasses.fields(obj):
        if f.name in _STATIC[name]:
            continue
        v = getattr(obj, f.name)
        if type(v).__name__ in _CLASSES:
            spec["children"][f.name] = _treedef_spec(v)
        elif isinstance(v, tuple):
            spec["children"][f.name] = [
                _treedef_spec(x) if type(x).__name__ in _CLASSES else None
                for x in v]
        elif v is None:
            spec["children"][f.name] = {"class": "NoneType"}
    return spec


def _leaves(obj):
    """The arrays of ``obj`` in JAX's ``tree_flatten`` order."""
    for f in dataclasses.fields(obj):
        if f.name in _STATIC[type(obj).__name__]:
            continue
        v = getattr(obj, f.name)
        if v is None:
            continue
        if type(v).__name__ in _CLASSES:
            yield from _leaves(v)
        elif isinstance(v, tuple):
            for x in v:
                if type(x).__name__ in _CLASSES:
                    yield from _leaves(x)
                else:
                    yield x
        else:
            yield v


def _to_stored(x) -> np.ndarray:
    """A leaf as the file stores it: host numpy, bfloat16 as ``|V2``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16).numpy().view(np.uint16)
             if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view("V2") if x.dtype == np.uint16 else x


def save_format(path: str, obj) -> None:
    """Write a container (host or device arrays) to ``path`` (``.npz``)."""
    if type(obj).__name__ not in _CLASSES:
        raise TypeError(f"unsupported container: {type(obj)}")
    leaves = list(_leaves(obj))
    arrays = {f"leaf_{i}": _to_stored(x) for i, x in enumerate(leaves)}
    meta = {"class": type(obj).__name__, "treedef": _treedef_spec(obj),
            "n_leaves": len(leaves)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _rebuild(spec, leaf_iter):
    cls = _CLASSES[spec["class"]]
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in _STATIC[cls.__name__]:
            v = spec["static"][f.name]
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            continue
        child = spec["children"].get(f.name)
        if child is None:
            kwargs[f.name] = next(leaf_iter)
        elif isinstance(child, list):
            kwargs[f.name] = tuple(
                _rebuild(c, leaf_iter) if c else next(leaf_iter)
                for c in child)
        elif child.get("class") == "NoneType":
            kwargs[f.name] = None
        else:
            kwargs[f.name] = _rebuild(child, leaf_iter)
    return cls(**kwargs)


def load_format(path: str):
    """The container ``save_format`` (of either package) wrote to
    ``path``, with host (numpy) arrays."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    leaves = [x.view(np.uint16) if x.dtype == np.dtype("V2") else x
              for x in leaves]
    return _rebuild(meta["treedef"], iter(leaves))
