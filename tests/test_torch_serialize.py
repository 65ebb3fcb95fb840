"""The port's format persistence (``formats/serialize.py``) on the CPU: a
round trip of every container in float64, float32 and bfloat16, and files
carried across packages: a ``.npz`` the JAX package's ``save_format``
wrote loads in the port bit for bit, and one the port wrote loads in the
JAX package bit for bit (``BandedBlocks`` with and without spill,
``BucketedELL``), the two files holding the same leaves and the same
``__meta__``. Exact comparisons throughout: nothing is computed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
from sparsematrixmultiplicationmpi_tpu.formats.banded import (
    BandedBlocks as JBanded,
)
from sparsematrixmultiplicationmpi_tpu.formats.matrix import (
    CSR as JCSR, BucketedELL as JBucketed,
)
from sparsematrixmultiplicationmpi_tpu.formats.serialize import (
    load_format as jax_load, save_format as jax_save,
)
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu_torch import load_format, save_format
from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
    BandedBlocks,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    CSR, ELL, BucketedELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.serialize import (
    _leaves,
)

DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(x) -> np.ndarray:
    """An array's raw bits, whatever its dtype (bf16 of either package,
    or a ``|V2`` leaf, as ``uint16``)."""
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind in "Vf" or \
            x.dtype == np.uint16:
        return x.view(np.uint16)
    return x


def _assert_same_leaves(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _bits(x), _bits(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _spill_csr(mod):
    """A band plus random off-band entries (the JAX package's
    ``test_save_load_banded_with_spill`` matrix), from ``mod``'s
    generators and CSR."""
    b = mod.banded_csr(100, 5, 4, seed=147)
    r = mod.random_csr(100, 100, 150, seed=148)
    dense = np.asarray(b.to_dense()) + np.asarray(r.to_dense())
    return dense


BUILDS = {
    "csr": lambda csr: csr,
    "coo": lambda csr: csr.to_coo(),
    "ell": lambda csr: ELL.from_csr(csr),
    "bucketed": lambda csr: BucketedELL.from_csr(csr),
    "banded": lambda csr: BandedBlocks.from_csr(csr, block_rows=8),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_round_trip(tmp_path, build, dtype):
    csr = TG.banded_csr(96, 5, 4, seed=160).astype(DTYPES[dtype][0])
    obj = BUILDS[build](csr)
    path = str(tmp_path / "fmt.npz")
    save_format(path, obj)
    back = load_format(path)
    assert type(back) is type(obj)
    _assert_same_leaves(list(_leaves(back)), list(_leaves(obj)))
    assert back.shape == obj.shape
    if build == "banded":
        assert (back.block_rows, back.est_seconds, back.spill) == \
            (obj.block_rows, obj.est_seconds, obj.spill)


def test_round_trip_banded_with_spill_and_device_tensors(tmp_path):
    """A spill child round-trips; a container of (CPU) tensors saves the
    same file as its host arrays."""
    bb = BandedBlocks.from_csr(CSR.from_dense(_spill_csr(TG)), block_rows=8)
    assert bb.spill is not None
    host, dev = str(tmp_path / "host.npz"), str(tmp_path / "dev.npz")
    save_format(host, bb.astype(torch.bfloat16))
    save_format(dev, bb.astype(torch.bfloat16).to("cpu"))
    a, b = load_format(host), load_format(dev)
    _assert_same_leaves(list(_leaves(a)), list(_leaves(b)))
    assert a.spill is not None and a.block_rows == bb.block_rows
    assert a.est_seconds == bb.est_seconds


def test_unsupported_container_raises(tmp_path):
    with pytest.raises(TypeError):
        save_format(str(tmp_path / "x.npz"), np.zeros(3))


def _pair(kind, dtype):
    """The same container built by the JAX package and by the port."""
    tdt, jdt = DTYPES[dtype]
    if kind == "banded_spill":
        dense = _spill_csr(TG)
        j = JBanded.from_csr(JCSR.from_dense(dense).astype(jdt),
                             block_rows=8)
        t = BandedBlocks.from_csr(CSR.from_dense(dense).astype(tdt),
                                  block_rows=8)
        assert j.spill is not None and t.spill is not None
    elif kind == "banded":
        j = JBanded.from_csr(JG.banded_csr(64, 4, 3, seed=149).astype(jdt),
                             block_rows=8)
        t = BandedBlocks.from_csr(
            TG.banded_csr(64, 4, 3, seed=149).astype(tdt), block_rows=8)
        assert j.spill is None and t.spill is None
    else:
        j = JBucketed.from_csr(JG.powerlaw_csr(80, 80, 900,
                                               seed=146).astype(jdt))
        t = BucketedELL.from_csr(TG.powerlaw_csr(80, 80, 900,
                                                 seed=146).astype(tdt))
    return j, t


CROSS = [(kind, dtype) for kind in ("banded_spill", "banded", "bucketed")
         for dtype in ("float64", "float32", "bfloat16")]


@pytest.mark.parametrize("kind,dtype", CROSS)
def test_jax_written_file_loads_in_port(tmp_path, kind, dtype):
    j, _ = _pair(kind, dtype)
    path = str(tmp_path / "jax.npz")
    jax_save(path, j)
    back = load_format(path)
    assert type(back).__name__ == type(j).__name__
    assert back.shape == tuple(j.shape)
    if kind != "bucketed":
        assert back.block_rows == j.block_rows
        assert back.est_seconds == j.est_seconds
        assert (back.spill is None) == (j.spill is None)
    _assert_same_leaves(list(_leaves(back)), jax.tree_util.tree_leaves(j))
    if dtype == "bfloat16":
        assert all(x.dtype == np.uint16 for x in _leaves(back)
                   if x.dtype.kind != "i")


@pytest.mark.parametrize("kind,dtype", CROSS)
def test_port_written_file_loads_in_jax(tmp_path, kind, dtype):
    j, t = _pair(kind, dtype)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_format(ours, t)
    jax_save(theirs, j)
    back = jax_load(ours)
    assert type(back) is type(j)
    assert tuple(back.shape) == tuple(j.shape)
    _assert_same_leaves(jax.tree_util.tree_leaves(back), list(_leaves(t)))
    # The two files hold the same leaves (dtype, shape, bits) and meta.
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(_bits(a[name]), _bits(b[name]))
